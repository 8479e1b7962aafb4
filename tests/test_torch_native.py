"""The port's host C++ (``lightcurver_tpu_torch/native``): its library
against the JAX package's ``lightcurver_tpu.native`` (the same source and
flags on the same host: bit-equal), against the port's own numpy twins at
the JAX package's bars (``tests/test_processes.py``: the background to
1e-5, the same catalogue, the cosmics to the bit, the pathological frames
and the cosmics fuzz), the three callers' dispatch,
``LIGHTCURVER_DISABLE_NATIVE``, where the library is built, and
concurrent first uses. Every test that needs the library skips where
``g++`` is absent, as the JAX package's tests do.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import lightcurver_tpu.native as jax_native
import lightcurver_tpu_torch.native as native
from lightcurver_tpu_torch.processes import background_estimation as bg
from lightcurver_tpu_torch.processes import cosmics
from lightcurver_tpu_torch.processes import star_extraction as se

REPO = Path(__file__).resolve().parents[1]
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ on this host: the library "
                               "cannot be built, the numpy twins run")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """As in the calibration chain's file: one intra-op thread beside the
    suite's other workers."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def fresh(monkeypatch):
    """``fresh(disabled)``: the load cache reset, the C++ on or off."""
    def reset(disabled):
        if disabled:
            monkeypatch.setenv("LIGHTCURVER_DISABLE_NATIVE", "1")
        else:
            monkeypatch.delenv("LIGHTCURVER_DISABLE_NATIVE", raising=False)
        for module in (native, jax_native):
            monkeypatch.setattr(module, "_lib", None)
            monkeypatch.setattr(module, "_tried", False)
    return reset


@pytest.fixture
def lib(fresh):
    fresh(False)
    loaded = native.load()
    assert loaded is not None, "g++ is present but the library did not load"
    return loaded


def _gaussian(img, x, y, flux, sigma=1.8):
    yy, xx = np.mgrid[0:img.shape[0], 0:img.shape[1]]
    img += flux / (2 * np.pi * sigma**2) * np.exp(
        -0.5 * ((xx - x) ** 2 + (yy - y) ** 2) / sigma**2)


def _frame(seed=2, n=150):
    rng = np.random.default_rng(seed)
    image = rng.normal(0, 1, (n, n)).astype(np.float32)
    for x, y, f in ((30.0, 40.0, 2000.0), (100.0, 110.0, 3000.0),
                    (70.0, 20.0, 1500.0)):
        _gaussian(image, x, y, f)
    return image


def _cosmics_image(rng, n):
    image = rng.normal(100.0, 5.0, (n, n))
    for _ in range(3):
        cy, cx = rng.uniform(2, n - 2, 2)
        _gaussian(image, cy, cx, float(rng.uniform(300, 3000)))
    for _ in range(int(rng.integers(0, 6))):
        y, x = rng.integers(1, n - 1, 2)
        image[y, x] += rng.uniform(300, 6000)
    return image


def test_source_is_the_jax_packages():
    assert native.SOURCE.read_bytes() \
        == (Path(jax_native.__file__).parent
            / "lightcurver_native.cpp").read_bytes()


@needs_gxx
def test_built_under_build_not_in_the_package(lib):
    path = native.library_path()
    assert path.exists() and path.with_suffix(".ok").exists()
    assert path.parent == REPO / "build" / "lightcurver_tpu_torch"
    assert not list(Path(native.__file__).parent.glob("*.so"))
    assert not list(Path(native.__file__).parent.glob("*.ok"))


@needs_gxx
def test_bit_equal_to_the_jax_library(lib):
    """The same source and flags on the same host give the same bits."""
    assert jax_native.load() is not None
    image = _frame()
    image[0:3, 0:3] = np.nan
    mask = np.zeros(image.shape, dtype=np.uint8)
    mask[100:120, :] = 1
    for args in ((image, 4, 5), (image, 4, 5, mask)):
        ours, theirs = native.background_mesh(*args), \
            jax_native.background_mesh(*args)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    var = np.abs(image) + 1.0
    np.testing.assert_array_equal(
        native.extract_sources(image, var, 3.0, 8),
        jax_native.extract_sources(image, var, 3.0, 8))
    rng = np.random.default_rng(11)
    img = _cosmics_image(rng, 64)
    for invar in (np.abs(img) + 25.0, None):
        for a, b in zip(native.detect_cosmics(img, invar=invar),
                        jax_native.detect_cosmics(img, invar=invar)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("disabled", [False, True],
                         ids=["native", "numpy"])
def test_positions_and_order(fresh, disabled):
    if not disabled and shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    fresh(disabled)
    assert (native.load() is None) == disabled
    image = _frame()
    sources = se.extract_stars(image, np.ones_like(image),
                               detection_threshold=3, min_area=8)
    assert len(sources) == 3
    assert sources["flux"].is_monotonic_decreasing
    found = {(round(r.x), round(r.y)) for r in sources.itertuples()}
    assert found == {(30, 40), (100, 110), (70, 20)}
    assert (sources["FWHM"] > 2).all()
    assert (sources["ellipticity"] < 0.3).all()


@needs_gxx
@pytest.mark.parametrize("case", ["all_nan", "constant", "border_spike",
                                  "huge", "tiny_image"])
def test_pathological_frames_native_matches_numpy(fresh, case):
    """Degenerate frames neither crash nor split the two extractors."""
    rng = np.random.default_rng(5)
    if case == "all_nan":
        image = np.full((64, 64), np.nan, np.float32)
    elif case == "constant":
        image = np.full((64, 64), 7.0, np.float32)
    elif case == "border_spike":
        image = rng.normal(0, 1, (64, 64)).astype(np.float32)
        image[0, :4] = 5000.0
    elif case == "huge":
        image = (1e30 * rng.normal(0, 1, (64, 64))).astype(np.float32)
    else:
        image = rng.normal(0, 1, (4, 4)).astype(np.float32)
    var = np.ones_like(image)

    def run(disabled):
        fresh(disabled)
        return se.extract_stars(image.copy(), var.copy(),
                                detection_threshold=3, min_area=8)

    s_native = run(False)
    assert native._lib is not None
    s_numpy = run(True)
    if case == "huge":
        # 1e30 pixels overflow the float32 variance: both survive with
        # finite coordinates, their overflow artefacts differ
        for s in (s_native, s_numpy):
            if len(s):
                assert np.isfinite(np.asarray(s["x"], float)).all()
        return
    assert len(s_native) == len(s_numpy)
    if len(s_native):
        np.testing.assert_allclose(
            np.sort(np.asarray(s_native["x"], float)),
            np.sort(np.asarray(s_numpy["x"], float)), atol=0.5)


@needs_gxx
def test_catalogue_native_matches_numpy(fresh):
    """On a crowded frame the two extractors give the same rows: the
    same sources in the same order, float32 against float64 moments."""
    rng = np.random.default_rng(8)
    image = rng.normal(0, 1, (200, 200)).astype(np.float32)
    for _ in range(25):
        x, y = rng.uniform(8, 192, 2)
        _gaussian(image, x, y, float(rng.uniform(300, 3000)))
    var = np.ones_like(image)
    fresh(False)
    ours = se.extract_stars(image, var, detection_threshold=3, min_area=8)
    fresh(True)
    twin = se.extract_stars(image, var, detection_threshold=3, min_area=8)
    assert len(ours) == len(twin) > 15
    for col in ("x", "y", "flux", "a", "b", "peak"):
        np.testing.assert_allclose(ours[col], twin[col], rtol=1e-4,
                                   atol=1e-3, err_msg=col)
    np.testing.assert_array_equal(ours["npix"], twin["npix"])


@needs_gxx
def test_background_native_matches_numpy(fresh):
    rng = np.random.default_rng(0)
    img = (10 + rng.normal(0, 0.5, (200, 180))).astype(np.float32)
    _gaussian(img, 45, 55, 5000.0)
    img[0:3, 0:3] = np.nan
    mask = np.zeros_like(img, dtype=bool)
    mask[100:120, :] = True
    fresh(False)
    b_native = bg.Background(img, box_size=32, mask=mask)
    assert native._lib is not None
    fresh(True)
    b_numpy = bg.Background(img, box_size=32, mask=mask)
    np.testing.assert_allclose(b_native.back(), b_numpy.back(), atol=1e-5)
    np.testing.assert_allclose(b_native.rms(), b_numpy.rms(), atol=1e-5)


@needs_gxx
def test_cosmics_fuzz_bit_equal(lib):
    """The C++ L.A.Cosmic is the numpy twin's bit-exact copy: the mask and
    the cleaned image agree to the bit, with and without a variance."""
    rng = np.random.default_rng(11)
    for _ in range(6):
        image = _cosmics_image(rng, int(rng.integers(8, 90)))
        var = np.abs(image) + 25.0
        for a, b in zip(cosmics.detect_cosmics_numpy(image, invar=var),
                        native.detect_cosmics(image, invar=var)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(cosmics.detect_cosmics_numpy(image),
                    native.detect_cosmics(image)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("disabled", [False, True],
                         ids=["native", "numpy"])
def test_cosmic_masked_star_kept(fresh, disabled):
    if not disabled and shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    fresh(disabled)
    rng = np.random.default_rng(3)
    image = rng.normal(0, 1, (64, 64)).astype(float)
    _gaussian(image, 20, 20, 3000.0)
    image[45, 45] = 300.0
    image[46, 45] = 200.0
    mask, cleaned = cosmics.detect_cosmics(image, invar=np.ones_like(image),
                                           sigclip=5.0, objlim=4.0)
    assert mask[45, 45] and mask[46, 45]
    assert not mask[20, 20]
    assert abs(cleaned[45, 45]) < 10


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("disabled", [False, True],
                         ids=["native", "numpy"])
def test_callers_dispatch(fresh, monkeypatch, disabled):
    """The three callers reach the C++ when it loads, and the numpy twins
    (only) with LIGHTCURVER_DISABLE_NATIVE."""
    if not disabled and shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    fresh(disabled)
    calls = []
    _spy(monkeypatch, bg, "_mesh_stats_numpy", calls)
    _spy(monkeypatch, se, "_segment", calls)
    _spy(monkeypatch, cosmics, "detect_cosmics_numpy", calls)
    for name in ("background_mesh", "extract_sources", "detect_cosmics"):
        _spy(monkeypatch, native, name, calls)
    image = _frame(n=96)
    bg.subtract_background(image, n_boxes=3)
    se.extract_stars(image, np.ones_like(image), detection_threshold=3,
                     min_area=8)
    cosmics.detect_cosmics(image.astype(float))
    twins = ["_mesh_stats_numpy", "_segment", "detect_cosmics_numpy"]
    assert [c for c in calls if c in native.__dict__] == [
        "background_mesh", "extract_sources", "detect_cosmics"]
    assert [c for c in calls if c in twins] == (twins if disabled else [])


@needs_gxx
def test_concurrent_first_use(tmp_path):
    """Three processes build into one empty directory at once (the test
    workers' first use): each loads a whole library and runs it, and one
    library is left, with its stamp and no temporary file."""
    code = (
        "import sys, numpy as np\n"
        "from pathlib import Path\n"
        "import lightcurver_tpu_torch.native as n\n"
        "n.BUILD_DIR = Path(sys.argv[1])\n"
        "img = np.random.default_rng(0).normal(100, 5, (32, 32))\n"
        "img[10, 10] += 5000\n"
        "mask, _ = n.detect_cosmics(img)\n"
        "assert mask[10, 10], 'the library did not run'\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    env.pop("LIGHTCURVER_DISABLE_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env=env, stderr=subprocess.PIPE)
             for _ in range(3)]
    for proc in procs:
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err.decode()
    assert len(list(tmp_path.glob("*.so"))) == 1
    assert len(list(tmp_path.glob("*.ok"))) == 1
    assert not list(tmp_path.glob("*tmp*"))
