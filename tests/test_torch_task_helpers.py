"""Port parity for the host helpers of the calibration chain's tasks.

The copies the port keeps of the JAX package's host functions (neighbour
masking and its segmentation, the chi2 gates, the star selection, the
coordinate rescaling, the clipped statistics, the normalization's
weighted std and scatter, the Gaia colour transforms and the Pan-STARRS
selection through its CSV fixture) are held to their JAX twins on the same
inputs and the same database; the PSF and star tasks' bucket padding is
held to JAX's by capturing the arrays each hands its fit; the bucket
pipeline keeps the control flow ``tests/test_processes.py`` pins for
JAX's. No fit runs here.
"""

import numpy as np
import pandas as pd
import pytest
import yaml

from lightcurver_tpu.processes import normalization_calculation as jnorm
from lightcurver_tpu.processes import psf_modelling as jpsf
from lightcurver_tpu.processes import star_extraction as jextract
from lightcurver_tpu.processes import star_photometry as jstar
from lightcurver_tpu.structure import database as jdb
from lightcurver_tpu.utilities import (
    absolute_magnitudes_from_gaia as jgaia,
    absolute_magnitudes_from_panstarrs as jps, chi2_selector as jchi2,
    image_coordinates as jcoords, stats as jstats)

from lightcurver_tpu_torch.processes import normalization_calculation as tnorm
from lightcurver_tpu_torch.processes import psf_modelling as tpsf
from lightcurver_tpu_torch.processes import star_extraction as textract
from lightcurver_tpu_torch.processes import star_photometry as tstar
from lightcurver_tpu_torch.structure import database as tdb
from lightcurver_tpu_torch.utilities import (
    absolute_magnitudes_from_gaia as tgaia,
    absolute_magnitudes_from_panstarrs as tps, chi2_selector as tchi2,
    image_coordinates as tcoords, stats as tstats)

FP = 999  # the footprint hash of the test database
STARS = [("a", "g1", 5.0), ("b", "g2", 3.0), ("c", "g3", 8.0),
         ("d", "g4", 1.0)]


def _write_config(tmp_path, **overrides):
    config = {
        "workdir": str(tmp_path),
        "raw_dirs": [str(tmp_path / "raw")],
        "ROI": {"testroi": {"coordinates": [42.2031, 19.22528]}},
        "photometric_band": "r_sdss",
        "stars_to_use_psf": None, "stars_to_use_norm": None,
        "stars_to_exclude_psf": None, "stars_to_exclude_norm": None,
        **overrides,
    }
    (tmp_path / "config.yaml").write_text(yaml.dump(config))


@pytest.fixture()
def db(tmp_path, monkeypatch):
    """Config and database with four stars in one frame, their PSF rows
    and fluxes."""
    _write_config(tmp_path)
    monkeypatch.setenv("LIGHTCURVER_CONFIG", str(tmp_path / "config.yaml"))
    jdb.initialize_database()
    q = jdb.execute_sqlite_query
    q("INSERT INTO frames (id, mjd) VALUES (1, 60000.0)", is_select=False)
    rng = np.random.default_rng(5)
    for name, gid, dist in STARS:
        gmag = 17.0 + rng.uniform()
        q("INSERT INTO stars (combined_footprint_hash, name, ra, dec, "
          "gaia_id, distance_to_roi_arcsec, gmag, bmag, rmag) VALUES "
          "(?, ?, 42.0, 19.0, ?, ?, ?, ?, ?)",
          params=(FP, name, gid, dist, gmag, gmag + 0.6, gmag - 0.4),
          is_select=False)
        q("INSERT INTO stars_in_frames (frame_id, star_gaia_id, "
          "combined_footprint_hash) VALUES (1, ?, ?)", params=(gid, FP),
          is_select=False)
    for i, chi2 in enumerate(np.r_[rng.normal(1.0, 0.05, 30), 9.0, 0.1]):
        q("INSERT INTO PSFs (combined_footprint_hash, frame_id, chi2, "
          "psf_ref, subsampling_factor) VALUES (?, ?, ?, ?, 2)",
          params=(FP, 100 + i, float(chi2), f"psf_{i}"), is_select=False)
        q("INSERT INTO star_flux_in_frame (frame_id, star_gaia_id, "
          "combined_footprint_hash, flux, flux_uncertainty, chi2) VALUES "
          "(?, 'g1', ?, 100.0, 1.0, ?)", params=(100 + i, FP,
                                                   float(chi2) * 1.1),
          is_select=False)
    return tmp_path


def _set_config(path, **values):
    cfg = yaml.safe_load((path / "config.yaml").read_text())
    cfg.update(values)
    (path / "config.yaml").write_text(yaml.dump(cfg))


def _stamp(seed, n=32, neighbours=2):
    """A star stamp with neighbours and its noise map."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    img = 50.0 * np.exp(-((xx - 15.6) ** 2 + (yy - 15.2) ** 2) / 6.0)
    for _ in range(neighbours):
        x, y = rng.uniform(2, n - 2, 2)
        img += rng.uniform(5, 30) * np.exp(-((xx - x) ** 2
                                             + (yy - y) ** 2) / 4.0)
    noise = np.full((n, n), 1.0, np.float32)
    img = (img + rng.normal(0, 1.0, (n, n))).astype(np.float32)
    img[0, 0] = np.nan
    return img, noise


@pytest.mark.parametrize("threshold,min_area", [(3.0, 15), (2.0, 5),
                                                (5.0, 1)])
def test_segment_matches_jax(threshold, min_area):
    img, noise = _stamp(1, neighbours=4)
    img = np.nan_to_num(img)
    got_labels, got_seg = textract._segment(img, noise**2, threshold,
                                            min_area)
    want_labels, want_seg = jextract._segment(img, noise**2, threshold,
                                              min_area)
    assert got_labels == want_labels
    assert len(got_labels) > 0
    np.testing.assert_array_equal(got_seg, want_seg)


@pytest.mark.parametrize("seed,neighbours", [(2, 0), (3, 2), (4, 5)])
def test_mask_surrounding_stars_matches_jax(seed, neighbours):
    img, noise = _stamp(seed, neighbours=neighbours)
    got = tpsf.mask_surrounding_stars(img, noise)
    np.testing.assert_array_equal(got, jpsf.mask_surrounding_stars(img,
                                                                   noise))
    assert got[16, 16]  # the central star stays


def test_rescale_image_coordinates_matches_jax():
    xy = np.random.default_rng(0).uniform(-5, 200, (7, 2))
    for coords in (xy, xy[0]):
        got = tcoords.rescale_image_coordinates(coords, (160, 120))
        want = jcoords.rescale_image_coordinates(coords, (160, 120))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sigma", [2.0, 3.0, 5.0])
def test_sigma_clipped_stats_matches_jax(sigma):
    rng = np.random.default_rng(int(sigma))
    data = np.r_[rng.normal(1.0, 0.1, 200), [5.0, -3.0, np.nan, np.inf]]
    assert tstats.sigma_clipped_stats(data, sigma=sigma) \
        == jstats.sigma_clipped_stats(data, sigma=sigma)
    assert np.isnan(tstats.sigma_clipped_stats([np.nan])).all()


def test_weighted_std_and_scatter_match_jax():
    rng = np.random.default_rng(1)
    values = np.r_[rng.normal(1.0, 0.02, 9), np.nan]
    weights = rng.uniform(0.5, 2.0, 10)
    assert tnorm.weighted_std(values, weights) \
        == jnorm.weighted_std(values, weights)
    assert np.isnan(tnorm.weighted_std([np.nan], [1.0]))
    flux = pd.DataFrame(rng.normal(1.0, 0.02, (4, 6)))
    d_flux = pd.DataFrame(rng.uniform(0.01, 0.03, (4, 6)))
    factors = rng.uniform(0.9, 1.1, 4)
    assert tnorm.cost_function_scatter_in_frame(factors, flux, d_flux) \
        == jnorm.cost_function_scatter_in_frame(factors, flux, d_flux)


@pytest.mark.parametrize("strategy", [
    None, {"threshold": [0.5, 1.5]}, {"sigma_clip": 3.0},
    {"sigma_clip": 2.0}])
@pytest.mark.parametrize("which", ["psf", "fluxes"])
def test_chi2_bounds_match_jax(db, strategy, which):
    _set_config(db, psf_fit_exclude_strategy=strategy,
                fluxes_fit_exclude_strategy=strategy)
    got = tchi2.get_chi2_bounds(which)
    assert got == jchi2.get_chi2_bounds(which)
    if strategy is not None and "sigma_clip" in strategy:
        assert got[0] > 0.1 and got[1] < 9.0  # the outliers clipped


def test_chi2_bounds_refusals(db):
    with pytest.raises(ValueError):
        tchi2.get_chi2_bounds("stars")
    _set_config(db, psf_fit_exclude_strategy={"median": 3})
    with pytest.raises(RuntimeError):
        tchi2.get_chi2_bounds("psf")


@pytest.mark.parametrize("use,exclude", [
    (None, None), (2, None), (["a", "c"], None), (None, "b"),
    (3, "a,d"), (["a", "b", "c"], ["c"])])
def test_star_selection_matches_jax(db, use, exclude):
    got = tdb.select_stars(FP, use, exclude)
    pd.testing.assert_frame_equal(got, jdb.select_stars(FP, use, exclude))
    got = tdb.select_stars_for_a_frame(1, FP, use, exclude)
    pd.testing.assert_frame_equal(
        got, jdb.select_stars_for_a_frame(1, FP, use, exclude))
    assert len(got) > 0


def test_star_selection_refusals(db):
    with pytest.raises(ValueError, match="empty list"):
        tdb.select_stars(FP, [])
    with pytest.raises(RuntimeError):
        tdb.select_stars(FP, 2.5)


def test_frames_for_star_gate_matches_jax(db):
    """The gate judges the PSF the current config derives ('psf_abcd'): a
    stale passing row does not admit the frame, the current one does."""
    q = jdb.execute_sqlite_query
    insert = ("INSERT INTO PSFs (combined_footprint_hash, frame_id, chi2, "
              "psf_ref, subsampling_factor) VALUES (?, 1, ?, ?, 2)")
    q(insert, params=(FP, 1.0, "psf_a"), is_select=False)
    q(insert, params=(FP, 8.0, "psf_abcd"), is_select=False)
    for chi2, n in ((8.0, 0), (1.2, 1)):
        q("UPDATE PSFs SET chi2 = ? WHERE psf_ref = 'psf_abcd'",
          params=(chi2,), is_select=False)
        got = tstar.get_frames_for_star(FP, "g1", 0.0, 2.0)
        pd.testing.assert_frame_equal(
            got, jstar.get_frames_for_star(FP, "g1", 0.0, 2.0))
        assert len(got) == n
    for only_fluxless in (False, True):
        pd.testing.assert_frame_equal(
            tstar.get_frames_for_star(FP, "g2", 0.0, 2.0, only_fluxless),
            jstar.get_frames_for_star(FP, "g2", 0.0, 2.0, only_fluxless))


def _catalog_rows():
    return jdb.execute_sqlite_query(
        "SELECT * FROM catalog_star_photometry ORDER BY star_gaia_id",
        use_pandas=True)


def _clear_catalog():
    jdb.execute_sqlite_query("DELETE FROM catalog_star_photometry",
                             is_select=False)


@pytest.mark.parametrize("band", sorted(jgaia.GAIA_COLOR_COEFFICIENTS))
def test_gaia_magnitudes_match_jax(db, band):
    _set_config(db, photometric_band=band)
    for _, gid, _ in STARS:
        jgaia.save_gaia_catalog_photometry_to_database(gid)
    want = _catalog_rows()
    _clear_catalog()
    for _, gid, _ in STARS:
        tgaia.save_gaia_catalog_photometry_to_database(gid)
    got = _catalog_rows()
    assert len(got) == len(STARS)
    pd.testing.assert_frame_equal(got, want)


def test_gaia_magnitudes_skip_missing_colours(db):
    jdb.execute_sqlite_query("UPDATE stars SET bmag = NULL WHERE "
                             "gaia_id = 'g2'", is_select=False)
    for _, gid, _ in STARS:
        tgaia.save_gaia_catalog_photometry_to_database(gid)
    assert sorted(_catalog_rows()["star_gaia_id"]) == ["g1", "g3", "g4"]


PS1_ROW = {"objID": 12345, "nDetections": 30,
           "gMeanPSFMag": 17.5, "gMeanPSFMagErr": 0.01,
           "rMeanPSFMag": 17.0, "rMeanPSFMagErr": 0.02,
           "iMeanPSFMag": 16.8, "iMeanPSFMagErr": 0.02,
           "zMeanPSFMag": -999.0, "zMeanPSFMagErr": -999.0}


@pytest.mark.parametrize("band,rows,stored", [
    ("r", [PS1_ROW], True), ("g", [PS1_ROW], True), ("c", [PS1_ROW], True),
    ("o", [PS1_ROW], True), ("z", [PS1_ROW], False),
    # a barely detected duplicate is dropped; two real ones reject both
    ("i", [PS1_ROW, {**PS1_ROW, "objID": 1, "nDetections": 2}], True),
    ("i", [PS1_ROW, {**PS1_ROW, "objID": 1}], False)])
def test_panstarrs_through_fixture_matches_jax(db, monkeypatch, band, rows,
                                               stored):
    _set_config(db, photometric_band=f"{band}_panstarrs")
    csv = db / "ps1.csv"
    pd.DataFrame(rows).to_csv(csv, index=False)
    monkeypatch.setenv("LIGHTCURVER_PANSTARRS_FIXTURE", str(csv))
    got = tps.photometric_selection_heuristic(
        tps.search_panstarrs_around_coordinates("g1"))
    assert got == jps.photometric_selection_heuristic(
        jps.search_panstarrs_around_coordinates("g1"))
    jps.save_panstarrs_catalog_photometry_to_database("g1")
    want = _catalog_rows()
    _clear_catalog()
    tps.save_panstarrs_catalog_photometry_to_database("g1")
    tps.save_panstarrs_catalog_photometry_to_database("g1")  # idempotent
    pd.testing.assert_frame_equal(_catalog_rows(), want)
    assert len(want) == int(stored)


def _pipeline_events(run, buckets, fail_prepare_at=None,
                     fail_dispatch_at=None):
    events, stored = [], []

    def prepare(bucket):
        if bucket == fail_prepare_at:
            raise OSError(f"corrupt HDF5 in {bucket}")
        events.append(("prepare", bucket))
        return bucket

    def dispatch(chunk):
        if chunk == fail_dispatch_at:
            raise RuntimeError(f"dispatch failed for {chunk}")
        events.append(("dispatch", chunk))
        return f"out-{chunk}"

    def store(chunk, out, t0):
        assert out == f"out-{chunk}"
        events.append(("store", chunk))
        stored.append(chunk)

    error = None
    try:
        run(buckets, prepare, dispatch, store)
    except (OSError, RuntimeError) as e:
        error = type(e)
    return events, stored, error


@pytest.mark.parametrize("buckets,fails,stored,error", [
    # all buckets stored in order
    (["a", "b", "c"], {}, ["a", "b", "c"], None),
    # empty chunks skipped; no bucket at all
    (["a", "", "c"], {}, ["a", "c"], None),
    ([], {}, [], None),
    # a finished bucket survives its successor's failed prepare
    (["a", "b", "c"], {"fail_prepare_at": "b"}, ["a"], OSError),
    # ... and its successor's failed dispatch
    (["a", "b"], {"fail_dispatch_at": "b"}, ["a"], RuntimeError)])
def test_run_pipelined_buckets_matches_jax(buckets, fails, stored, error):
    got = _pipeline_events(tpsf.run_pipelined_buckets, buckets, **fails)
    want = _pipeline_events(jpsf.run_pipelined_buckets, buckets, **fails)
    assert got[1:] == (stored, error)
    # the order of prepares against the rest depends on the worker thread
    core = [[e for e in run[0] if e[0] != "prepare"] for run in (got, want)]
    assert core[0] == core[1]
    if "b" in stored:
        # pipelined: bucket b is dispatched before bucket a is stored
        assert got[0].index(("dispatch", "b")) \
            < got[0].index(("store", "a"))


def test_negative_star_fit_batch_size_is_refused(db):
    """The JAX task fits nothing and reports success; the port refuses."""
    _set_config(db, star_fit_batch_size=-4)
    with pytest.raises(ValueError, match="star_fit_batch_size"):
        tstar.do_star_photometry(device="cpu")


def _capture(monkeypatch, module, name):
    calls = []
    monkeypatch.setattr(module, name,
                        lambda *args, **kwargs: calls.append((args, kwargs)))
    return calls


def test_psf_dispatch_pads_as_jax(monkeypatch):
    """A bucket with ragged star counts reaches the fit padded as JAX pads
    it: dummy stars of data 0, noise 1, fully masked, at (0, 0)."""
    from lightcurver_tpu.core.psf import batched as jbatched
    from lightcurver_tpu_torch.core.psf import batched as tbatched

    rng = np.random.default_rng(2)
    jobs = [{"data": rng.normal(size=(k, 8, 8)).astype(np.float32),
             "noisemap": rng.uniform(1, 2, (k, 8, 8)).astype(np.float32),
             "masks": rng.uniform(size=(k, 8, 8)) > 0.1,
             "stamp_coords": rng.uniform(-0.5, 0.5, (k, 2)),
             "frame": {"seeing_pixels": seeing}}
            for k, seeing in ((3, 2.7), (1, np.nan), (2, -1.0))]
    config = {"subsampling_factor": 2, "psf_n_iter_analytic": 5,
              "psf_n_iter_pixels": 7, "field_distortion": False,
              "psf_dft_pad": 16}
    jcalls = _capture(monkeypatch, jbatched, "build_psf_batched")
    tcalls = _capture(monkeypatch, tbatched, "build_psf_batched")
    jpsf._dispatch_fit_jobs(config, jobs)
    tpsf._dispatch_fit_jobs(config, jobs, device="cpu",
                            irfft_backend="matmul")
    (jargs, jkw), = jcalls
    (targs, tkw), = tcalls
    assert targs == ()
    want = dict(zip(("images", "noisemaps", "subsampling_factor"), jargs),
                **jkw)
    assert tkw.pop("device") == "cpu"
    assert tkw.pop("irfft_backend") == "matmul"
    assert set(tkw) == set(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert tkw[key].dtype == value.dtype, key
            np.testing.assert_array_equal(tkw[key], value, err_msg=key)
        else:
            assert tkw[key] == value, key
    assert tkw["images"].shape == (3, 3, 8, 8)
    np.testing.assert_array_equal(tkw["guess_fwhm_pixels"],
                                  np.float32([2.7, 3.0, 3.0]))


def test_star_dispatch_pads_as_jax(monkeypatch):
    """A bucket with ragged epoch counts reaches the fit padded as JAX pads
    it: dummy epochs of data 0, noise 1e7 and the star's first PSF."""
    from lightcurver_tpu.core.deconv import batched as jbatched
    from lightcurver_tpu_torch.core.deconv import batched as tbatched

    rng = np.random.default_rng(3)
    jobs = [{"data": rng.normal(size=(k, 8, 8)).astype(np.float32),
             "noisemap": rng.uniform(1, 2, (k, 8, 8)).astype(np.float32),
             "psf": rng.uniform(size=(k, 16, 16)).astype(np.float32),
             "star": {"gaia_id": f"g{k}"}} for k in (4, 2, 3)]
    config = {"subsampling_factor": 2, "star_deconv_n_iter": 9,
              "star_photometry_uniform_background_per_epoch": False,
              "star_photometry_starlet_global_background": True,
              "deconv_checkpoint_every": 0}
    jcalls = _capture(monkeypatch, jbatched, "fit_stars_batched")
    tcalls = _capture(monkeypatch, tbatched, "fit_stars_batched")
    jstar._dispatch_star_jobs(config, jobs, fetch="device")
    tstar._dispatch_star_jobs(config, jobs, fetch="device", device="cpu",
                              irfft_backend="matmul")
    (jargs, jkw), = jcalls
    (targs, tkw), = tcalls
    assert len(targs) == len(jargs) == 4
    for got, want in zip(targs, jargs):
        np.testing.assert_array_equal(got, want)
    assert targs[0].shape == (3, 4, 8, 8)
    np.testing.assert_array_equal(targs[2][1, 2:], jobs[1]["psf"][[0, 0]])
    assert tkw.pop("device") == "cpu"
    assert tkw.pop("irfft_backend") == "matmul"
    assert tkw == jkw
