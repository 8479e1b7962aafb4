"""Host C++ for the front of the pipeline, loaded with ctypes: a copy of
``lightcurver_tpu/native``.

``lightcurver_native.cpp`` (a byte-for-byte copy of the JAX package's)
holds the mesh background estimator, the flood-fill source extractor and
the L.A.Cosmic detector behind a plain C interface. It is compiled by
``g++`` at its first use in a process, into ``build/lightcurver_tpu_torch/``
at the root of the checkout (git-ignored, beside the CUDA libraries of
``ops/cuda_build.py``); nothing is written into the package. The library's
name is keyed by the host's instruction set (it is built with
``-march=native``) and by the source's bytes and flags. A stamp beside it
records that this exact binary ran on this host; without one a call in a
subprocess must succeed before the library is trusted, else it is
rebuilt. Each process compiles to a temporary file of its own and moves it
into place with ``os.replace``, so concurrent first uses never load a
half-written library.

Every caller falls back to its numpy/scipy twin when :func:`load` returns
None: when ``LIGHTCURVER_DISABLE_NATIVE`` is set, or when the library
cannot be built or loaded (no compiler). The twins stay the tests' oracle:
background to 1e-5, the same catalogue, the cosmics to the bit.
"""

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import sys
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "lightcurver_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" \
    / "lightcurver_tpu_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_tried = False


def _cpu_lines(keys):
    """The first line of /proc/cpuinfo starting with each of ``keys``."""
    found = {}
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                for key in keys:
                    if line.startswith(key) and key not in found:
                        found[key] = line.strip()
                if len(found) == len(keys):
                    break
    except OSError:
        pass
    return found


def _isa_tag():
    """The machine and a short hash of the CPU flags: a library built with
    ``-march=native`` on one host is never loaded on a host whose
    instruction set differs."""
    line = next(iter(_cpu_lines(("flags", "Features")).values()), "")
    flags = " ".join(sorted(line.split(":", 1)[-1].split())) if line else ""
    digest = hashlib.sha1(flags.encode()).hexdigest()[:10]
    return f"{platform.machine()}-{digest}"


def library_path():
    """Where this host's library for the current source lives."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"liblightcurver_native-{_isa_tag()}-{digest}.so"


def _host_key():
    """The full identity of this host's CPU (the tag above cuts its hash
    short for a file name; a stamp must not pass between hosts whose cut
    tags collide)."""
    ident = {"machine": platform.machine(),
             **_cpu_lines(("flags", "Features", "model name"))}
    joined = "|".join(f"{k}={v}" for k, v in sorted(ident.items()))
    return hashlib.sha256(joined.encode()).hexdigest()


def _stamp_path(lib_path):
    return lib_path.with_suffix(".ok")


def _stamp_value(lib_path):
    return f"{hashlib.sha256(lib_path.read_bytes()).hexdigest()} " \
        f"{_host_key()}\n"


def _write_stamp(lib_path):
    """Record that this exact library ran on this host (atomic; a failed
    write only costs the next process a self-test)."""
    tmp = _stamp_path(lib_path).with_suffix(f".ok.tmp{os.getpid()}")
    try:
        tmp.write_text(_stamp_value(lib_path))
        os.replace(tmp, _stamp_path(lib_path))
    except OSError:
        tmp.unlink(missing_ok=True)


def _stamp_valid(lib_path):
    try:
        return _stamp_path(lib_path).read_text() == _stamp_value(lib_path)
    except OSError:
        return False


def _compile(lib_path):
    """g++ into a per-process temporary file, then an atomic replace; with
    ``-march=native`` first (the cosmics' branchless rank scans vectorize
    only with the host's SIMD set), again without it for a compiler that
    refuses the flag."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".so.tmp{os.getpid()}")
    try:
        for extra in (["-march=native"], []):
            cmd = ["g++", *GXX_FLAGS, *extra, "-o", str(tmp), str(SOURCE)]
            result = subprocess.run(cmd, capture_output=True, timeout=120)
            if result.returncode == 0:
                break
        else:
            result.check_returncode()
        os.replace(tmp, lib_path)
    finally:
        tmp.unlink(missing_ok=True)


def _selftest(lib_path):
    """True if the library survives one real call in a subprocess: a
    binary with instructions this host lacks would kill this process
    (SIGILL) at its first call; there it only fails the test, and the
    library is rebuilt."""
    code = (
        "import ctypes, numpy as np\n"
        f"lib = ctypes.CDLL({str(lib_path)!r})\n"
        "d = np.zeros((8, 8)); m = np.zeros((8, 8), np.uint8)\n"
        "c = np.zeros((8, 8))\n"
        "lib.lc_detect_cosmics("
        "d.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), None, 8, 8,"
        "ctypes.c_double(4.5), ctypes.c_double(0.3),"
        "ctypes.c_double(5.0), 2,"
        "m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),"
        "c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))\n"
    )
    try:
        r = subprocess.run([sys.executable, "-c", code],
                           capture_output=True, timeout=60)
        return r.returncode == 0
    except (subprocess.TimeoutExpired, OSError):
        return False


def _bind(lib):
    lib.lc_background_mesh.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    lib.lc_background_mesh.restype = None
    lib.lc_extract_sources.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_void_p]
    lib.lc_extract_sources.restype = ctypes.c_int
    lib.lc_detect_cosmics.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double)]
    lib.lc_detect_cosmics.restype = None
    return lib


def load():
    """The ctypes library, built at the first call if needed; None when
    ``LIGHTCURVER_DISABLE_NATIVE`` is set or it cannot be built or loaded.
    The answer is kept for the process."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("LIGHTCURVER_DISABLE_NATIVE"):
        return None
    try:
        lib_path = library_path()
        cached = lib_path.exists()
        # the self-test costs a subprocess; the stamp makes it once per
        # build and host, not once per process
        if cached and not _stamp_valid(lib_path):
            if _selftest(lib_path):
                _write_stamp(lib_path)
            else:
                cached = False
        if not cached:
            _compile(lib_path)
            # built on this host just now: trusted
            _write_stamp(lib_path)
        _lib = _bind(ctypes.CDLL(str(lib_path)))
    except Exception as e:  # noqa: BLE001 -- no compiler, a failed build
        logging.getLogger("lightcurver.native").info(
            f"native backend unavailable ({e}); using the numpy twins")
        _lib = None
    return _lib


def _fptr(array):
    return array.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _dptr(array):
    return array.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def background_mesh(image, gy, gx, mask=None):
    """``(back, rms)`` grids (gy, gx) of the mesh estimator, float64, or
    None without the library. The twin of
    ``processes/background_estimation._mesh_stats``'s box loop: the same
    box edges, clipping and mode formula; an empty box is NaN."""
    lib = load()
    if lib is None:
        return None
    image = np.ascontiguousarray(image, dtype=np.float32)
    ny, nx = image.shape
    back = np.empty((gy, gx), dtype=np.float32)
    rms = np.empty((gy, gx), dtype=np.float32)
    mask_ptr = None
    if mask is not None:
        mask = np.ascontiguousarray(mask, dtype=np.uint8)
        mask_ptr = mask.ctypes.data_as(ctypes.c_void_p)
    lib.lc_background_mesh(_fptr(image), mask_ptr, ny, nx, gy, gx,
                           _fptr(back), _fptr(rms))
    return back.astype(float), rms.astype(float)


def extract_sources(image, variance, threshold, min_area,
                    max_sources=100000):
    """Sources above ``threshold`` sigma of at least ``min_area`` pixels
    (8-connected), as an (n, 8) float32 array with columns x, y, flux, a,
    b, npix, peak, positive_flux; None without the library. The twin of
    ``processes/star_extraction._segment`` and ``_moments``."""
    lib = load()
    if lib is None:
        return None
    image = np.ascontiguousarray(image, dtype=np.float32)
    variance = np.ascontiguousarray(
        np.broadcast_to(variance, image.shape), dtype=np.float32)
    ny, nx = image.shape
    out = np.empty((max_sources, 8), dtype=np.float32)
    n = lib.lc_extract_sources(_fptr(image), _fptr(variance), ny, nx,
                               float(threshold), int(min_area), _fptr(out),
                               max_sources, None)
    return out[:n].copy()


def detect_cosmics(data, invar=None, sigclip=4.5, sigfrac=0.3, objlim=5.0,
                   niter=2):
    """``(mask, cleaned)`` of L.A.Cosmic, or None without the library: the
    bit-exact twin of ``processes/cosmics.detect_cosmics_numpy`` (``invar``
    is the per-pixel noise variance, despite its name)."""
    lib = load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.float64)
    ny, nx = data.shape
    var_ptr = None
    if invar is not None:
        invar = np.ascontiguousarray(np.broadcast_to(invar, data.shape),
                                     dtype=np.float64)
        var_ptr = _dptr(invar)
    mask = np.empty(data.shape, dtype=np.uint8)
    cleaned = np.empty(data.shape, dtype=np.float64)
    lib.lc_detect_cosmics(_dptr(data), var_ptr, ny, nx, float(sigclip),
                          float(sigfrac), float(objlim), int(niter),
                          mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          _dptr(cleaned))
    return mask.astype(bool), cleaned
