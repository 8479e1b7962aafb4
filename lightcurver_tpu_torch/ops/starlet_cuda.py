"""Build, bind and launch the CUDA starlet kernels (``csrc/starlet.cu``).

Replaces the Pallas TPU kernel ``lightcurver_tpu/ops/starlet_pallas.py``
(``_starlet_kernel``) and, for the adjoint, the jnp linear transpose in
``lightcurver_tpu/ops/starlet_op.py`` (``_bwd``).

The kernels are compiled by ``nvcc`` at first use through
``ops/cuda_build.py`` and loaded with ctypes. Nothing is compiled or
loaded when this module is imported.

Each wrapper takes a tensor of images. A CPU tensor goes to the plain twin
in ``core/starlet.py``; a CUDA tensor launches the kernel or raises. The
counts in :data:`launches` grow by one per kernel launch and nowhere else,
and by what a CUDA graph's capture recorded for each further replay of it
(``core/optimize.py::StepLoop``: a replay does not pass the wrapper).

The design and what bounds it: one image is spread over a thread-block
cluster of C CTAs, each owning a band of R = ceil(m / C) rows; halo rows
of the column pass come from the owning CTA through distributed shared
memory, with one cluster barrier a level (the source note of
``csrc/starlet.cu`` has the details). At the stage-2 shape (m 128, batch 1)
the work is a chain of 2J dependent passes, so the time is set by the
latency of that chain, not by the 0.18 us the bytes take. A CTA holds
:func:`cta_bytes` of shared memory, so m is bounded by the card's opt-in
limit at C = 16: m <= 544 on an H100 (232,448 bytes). A launch the card
refuses raises; there is no retry with another C and no fall-back to the
twin. :func:`cluster_size` is the rule that picks C.

Numbers: kernel times in PERF.md were taken on an NVIDIA H100 and carry
the card's name and power limit; no TPU figure applies here.
"""

import ctypes
import math
import threading

import torch

from . import cuda_build
from ..core import starlet as plain

SOURCE = cuda_build.CSRC / "starlet.cu"
CLUSTER_SIZES = (1, 2, 4, 8, 16)   # 8 is the portable maximum; 16 opts in
MIN_BAND_ROWS = 4


class LaunchCounts:
    """Kernel launches since the last :meth:`reset`."""

    def __init__(self):
        self.forward = 0
        self.adjoint = 0

    def reset(self):
        self.forward = 0
        self.adjoint = 0


launches = LaunchCounts()

_lib = None
_limits = {}
_lock = threading.Lock()


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(cuda_build.build(SOURCE)))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            for name in ("starlet_forward", "starlet_adjoint"):
                fn = getattr(lib, name)
                fn.argtypes = [ptr, ptr, i32, i32, i32, i32, ptr]
                fn.restype = i32
            for name, args in (("starlet_smem_optin", [i32]),
                               ("starlet_cta_bytes", [i32, i32])):
                getattr(lib, name).argtypes = args
                getattr(lib, name).restype = i32
            lib.starlet_error_string.argtypes = [i32]
            lib.starlet_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def cta_bytes(m, cluster):
    """Shared memory of one CTA at side ``m`` with ``cluster`` CTAs an
    image: its band of the running plane and two bands of the row-smoothed
    one (3 R m floats, R = ceil(m / C)) and the row table (3 m ints)."""
    rows = -(-m // cluster)
    return 4 * (3 * rows * m + 3 * m)


def cluster_size(m, batch, n_sms, smem_limit):
    """C, the CTAs a cluster spreads one image over, or None where no C
    fits the card.

    The rule: the larger of
    - the smallest C in :data:`CLUSTER_SIZES` whose CTA fits
      ``smem_limit`` bytes of shared memory (:func:`cta_bytes`), and
    - the largest C that keeps bands of at least :data:`MIN_BAND_ROWS`
      rows and all ``batch`` clusters in one wave, batch C <= ``n_sms``
      (1 where none does).

    So a single image (every stage-2 iteration) takes 16 CTAs from m 49
    on, and the 500 images of the noise weights take one CTA each (C = 1
    launches no cluster), where more CTAs would only queue for the same
    SMs.
    """
    fits = [c for c in CLUSTER_SIZES if cta_bytes(m, c) <= smem_limit]
    if not fits:
        return None
    spread = [c for c in CLUSTER_SIZES
              if -(-m // c) >= MIN_BAND_ROWS and batch * c <= n_sms]
    return max(min(fits), max(spread, default=1))


def _device_limits(device):
    """(opt-in shared memory of a block in bytes, SMs) of a CUDA device."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _limits:
        _limits[index] = (_load().starlet_smem_optin(index),
                          torch.cuda.get_device_properties(index)
                          .multi_processor_count)
    return _limits[index]


def cluster_for(device, m, batch):
    """The C that the wrappers launch for ``batch`` images of side ``m``
    on the CUDA ``device`` (:func:`cluster_size`), or None."""
    optin, n_sms = _device_limits(device)
    return cluster_size(m, batch, n_sms, optin)


def work(m, batch, n_scales):
    """(bytes, FLOPs) of one call, forward or adjoint, on ``batch`` images
    of side ``m``: one plane in and n_scales + 1 out (or back), each read
    or written once; per level two 5-tap passes and a difference, 21
    FLOPs a pixel. The count of ``utilities/benchmarking.compiled_cost``
    and the bounds of ``chip_smoke.py``."""
    return (4 * batch * m * m * (n_scales + 2),
            21 * n_scales * batch * m * m)


def _check_cuda_input(x, what):
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: float32 expected, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: contiguous tensor expected")
    if x.dim() < 2 or x.shape[-1] != x.shape[-2]:
        raise ValueError(f"{what}: (..., m, m) expected, got "
                         f"{tuple(x.shape)}")


def _check_geometry(device, m, n_scales, batch):
    """The C to launch (:func:`cluster_for`); raises where no CTA of an
    image fits the card's shared memory."""
    if n_scales < 0 or (n_scales > 0 and 2**n_scales > m):
        raise ValueError(f"n_scales={n_scales} needs 2**n_scales <= m={m}")
    cluster = cluster_for(device, m, batch)
    if cluster is None:
        c = max(CLUSTER_SIZES)
        raise ValueError(f"m={m}: a band of {-(-m // c)} rows (C = {c}) "
                         f"needs {cta_bytes(m, c)} bytes of shared memory, "
                         f"the card allows {_device_limits(device)[0]}")
    return cluster


def _launch(lib, fn, src, out, batch, m, n_scales, cluster):
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = fn(src.data_ptr(), out.data_ptr(), batch, m, n_scales, cluster,
                stream)
    if rc != 0:
        raise RuntimeError(
            f"starlet kernel launch failed (C = {cluster}): "
            f"{lib.starlet_error_string(rc).decode()} ({rc})")


def starlet_forward(img, n_scales=None):
    """Starlet decomposition ``(..., m, m) -> (..., J + 1, m, m)``."""
    m = img.shape[-1]
    if n_scales is None:
        n_scales = plain.n_starlet_scales(m)
    if img.device.type == "cpu":
        return plain.starlet_transform(img, n_scales)
    if img.device.type != "cuda":
        raise ValueError(f"starlet_forward: no kernel for {img.device}")
    _check_cuda_input(img, "starlet_forward")
    batch = math.prod(img.shape[:-2])
    cluster = _check_geometry(img.device, m, n_scales, batch)
    out = torch.empty(*img.shape[:-2], n_scales + 1, m, m,
                      device=img.device, dtype=img.dtype)
    if batch:
        lib = _load()
        _launch(lib, lib.starlet_forward, img, out, batch, m, n_scales,
                cluster)
        launches.forward += 1
    return out


def starlet_adjoint(g):
    """Transpose of :func:`starlet_forward`: ``(..., J + 1, m, m) -> (..., m, m)``."""
    if g.device.type == "cpu":
        return plain.starlet_adjoint(g)
    if g.device.type != "cuda":
        raise ValueError(f"starlet_adjoint: no kernel for {g.device}")
    _check_cuda_input(g, "starlet_adjoint")
    if g.dim() < 3:
        raise ValueError("starlet_adjoint: (..., J + 1, m, m) expected")
    m, n_scales = g.shape[-1], g.shape[-3] - 1
    batch = math.prod(g.shape[:-3])
    cluster = _check_geometry(g.device, m, n_scales, batch)
    out = torch.empty(*g.shape[:-3], m, m, device=g.device, dtype=g.dtype)
    if batch:
        lib = _load()
        _launch(lib, lib.starlet_adjoint, g, out, batch, m, n_scales,
                cluster)
        launches.adjoint += 1
    return out
