"""Build, bind and launch the CUDA starlet kernels (``csrc/starlet.cu``).

Replaces the Pallas TPU kernel ``lightcurver_tpu/ops/starlet_pallas.py``
(``_starlet_kernel``) and, for the adjoint, the jnp linear transpose in
``lightcurver_tpu/ops/starlet_op.py`` (``_bwd``).

The kernels are compiled by ``nvcc`` for ``sm_90a`` at first use into
``build/lightcurver_tpu_torch/`` at the root of the checkout (git-ignored),
under a name keyed by the source and the flags, and loaded with ctypes.
Nothing is compiled or loaded when this module is imported.

Each wrapper takes a tensor of images. A CPU tensor goes to the plain twin
in ``core/starlet.py``; a CUDA tensor launches the kernel or raises. The
counts in :data:`launches` grow by one per kernel launch and nowhere else.

Numbers: kernel times in PERF.md were taken on an NVIDIA H100 and carry
the card's name and power limit; no TPU figure applies here.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ..core import starlet as plain

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "starlet.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" \
    / "lightcurver_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
_smem_optin = {}
_lock = threading.Lock()


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build csrc/starlet.cu")
    return found


def library_path():
    """Where the shared library for the current source and flags lives."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libstarlet_{digest}.so"


def build():
    """Compile the kernels unless already built; returns the library path.

    The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills per kernel) is kept beside the library as ``.log``.
    """
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            for name in ("starlet_forward", "starlet_adjoint"):
                fn = getattr(lib, name)
                fn.argtypes = [ptr, ptr, i32, i32, i32, ptr]
                fn.restype = i32
            lib.starlet_smem_optin.argtypes = [i32]
            lib.starlet_smem_optin.restype = i32
            lib.starlet_error_string.argtypes = [i32]
            lib.starlet_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check_cuda_input(x, what):
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: float32 expected, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: contiguous tensor expected")
    if x.dim() < 2 or x.shape[-1] != x.shape[-2]:
        raise ValueError(f"{what}: (..., m, m) expected, got "
                         f"{tuple(x.shape)}")


def _check_geometry(lib, device, m, n_scales):
    if n_scales < 0 or (n_scales > 0 and 2**n_scales > m):
        raise ValueError(f"n_scales={n_scales} needs 2**n_scales <= m={m}")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _smem_optin:
        _smem_optin[index] = lib.starlet_smem_optin(index)
    need = 2 * m * m * 4
    if need > _smem_optin[index]:
        raise ValueError(f"m={m}: two planes need {need} bytes of shared "
                         f"memory, the card allows {_smem_optin[index]}")


def _launch(lib, fn, src, out, batch, m, n_scales):
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = fn(src.data_ptr(), out.data_ptr(), batch, m, n_scales, stream)
    if rc != 0:
        raise RuntimeError(
            f"starlet kernel launch failed: "
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
    lib = _load()
    _check_geometry(lib, img.device, m, n_scales)
    out = torch.empty(*img.shape[:-2], n_scales + 1, m, m,
                      device=img.device, dtype=img.dtype)
    batch = img.numel() // (m * m)
    if batch:
        _launch(lib, lib.starlet_forward, img, out, batch, m, n_scales)
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
    lib = _load()
    _check_geometry(lib, g.device, m, n_scales)
    out = torch.empty(*g.shape[:-3], m, m, device=g.device, dtype=g.dtype)
    batch = out.numel() // (m * m)
    if batch:
        _launch(lib, lib.starlet_adjoint, g, out, batch, m, n_scales)
        launches.adjoint += 1
    return out
