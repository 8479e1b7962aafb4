"""Hand-written CUDA kernels of the port and their dispatch.

Twin of ``lightcurver_tpu/ops``. The JAX package chooses among backends
with module-level switches (``set_backend``, ``set_irfft_backend``) and
bf16 matmul precision names. Here no switch is global. A wrapper
dispatches on the device of the tensor it is given: a CPU tensor goes to
the plain PyTorch twin, a CUDA tensor to the kernel (or an error). The
render backend is an explicit argument, as ``Loss(irfft_backend=...)`` is
in JAX: ``irfft_backend="fft"`` (cuFFT, the default) or ``"matmul"``, the
port's name for JAX's ``"mxu"``: the matmul DFT of :mod:`.dft` and the
fused render K2 of :mod:`.fused_render`. The bf16 precision names are TPU
modes and have no counterpart.

Kernels: K1, the starlet (``starlet_op``, ``starlet_cuda``,
``csrc/starlet.cu``); K2, the fused render (``fused_render``,
``fused_render_cuda``, ``csrc/fused_render.cu``); both built at first use
by ``cuda_build``, and each direction one unit of its work formula in a
cost count (``cost``).

Precision policy: photometric math is float32 with TF32 off. The JAX
package measured a 0.15 % flux systematic from a reduced-precision matmul
default; TF32 keeps about three decimal digits, so both of PyTorch's TF32
switches are turned off by :func:`enforce_fp32`, which every entry point
calls.
"""

import torch

IRFFT_BACKENDS = ("fft", "matmul")


def check_irfft_backend(name):
    """Raise unless ``name`` is one of :data:`IRFFT_BACKENDS`."""
    if name not in IRFFT_BACKENDS:
        raise ValueError(f"irfft_backend={name!r}: one of {IRFFT_BACKENDS} "
                         "expected")


def enforce_fp32():
    """Turn TF32 off for CUDA matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
