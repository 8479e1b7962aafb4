"""Hand-written CUDA kernels of the port and their dispatch.

Twin of ``lightcurver_tpu/ops``. The JAX package chooses among backends
with module-level switches (``set_backend``, ``set_irfft_backend``) and
bf16 matmul precision names; none of that carries over. Here a wrapper
dispatches on the device of the tensor it is given: a CPU tensor goes to
the plain PyTorch twin, a CUDA tensor to the kernel (or an error).

Precision policy: photometric math is float32 with TF32 off. The JAX
package measured a 0.15 % flux systematic from a reduced-precision matmul
default; TF32 keeps about three decimal digits, so both of PyTorch's TF32
switches are turned off by :func:`enforce_fp32`, which every entry point
calls.
"""

import torch


def enforce_fp32():
    """Turn TF32 off for CUDA matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
