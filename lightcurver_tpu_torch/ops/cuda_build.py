"""Build a CUDA source of ``csrc/`` into a shared library, at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into
``build/lightcurver_tpu_torch/`` at the root of the checkout (git-ignored),
under a name keyed by the source's own bytes and the flags, so editing one
source rebuilds that library alone. The kernels are then bound with ctypes
by their wrappers (``ops/starlet_cuda.py``, ``ops/fused_render_cuda.py``).
Nothing is compiled when this module is imported.
"""

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" \
    / "lightcurver_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc():
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, else ``/usr/local/cuda/bin``,
    else the ``PATH``."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the kernels of csrc/")
    return found


def library_path(source):
    """Where the shared library for ``source`` and the flags lives."""
    source = Path(source)
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build(source):
    """Compile ``source`` unless already built; returns the library path.

    The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills per kernel) is kept beside the library as ``.log``.
    """
    so = library_path(source)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {Path(source).name} "
                           f"({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so
