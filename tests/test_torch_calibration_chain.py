"""Port parity for the calibration chain: the PSF-modelling, star-photometry,
normalization, zeropoint and ROI-file tasks.

One module-scoped fixture takes ``tests/test_e2e_pipeline.py``'s synthetic
scene (3 frames of 160 px, 8 stars, 2 ROI sources, the Gaia fixture, that
file's small budgets) through the JAX pipeline up to ``stamp_extraction``,
then through JAX's five tasks, and copies the workdir (database, regions
HDF5, config pointed at the copy) before the first and after each one.
Each port task then runs on a copy of the snapshot before it, on the CPU,
and is held to JAX's snapshot after it:

- PSFs: the rows' chi2 within 1 %, the Moffat FWHM within 8 %, the narrow
  and full PSFs within 6e-2 of their peaks (``tests/test_torch_psf.py``'s
  fit bars: the pixel phase is chaotic in float32), the same names,
  subsampling and distortion;
- star fluxes within 1 mmag, their errors within 1e-3 and chi2 within 1 %
  (``tests/test_torch_star_photometry.py``'s bars), the checkpoint gone;
- normalization coefficients, their errors and the zeropoints within 1e-6
  (the same scipy SLSQP and pandas arithmetic on equal inputs);
- every dataset of the prepared HDF5 within 1e-6, under the same keys.

The port's whole chain, from the stamped snapshot through its own ROI
task, keeps the e2e test's invariants, and a rerun refits nothing.
"""

import json
import os
import shutil
from contextlib import contextmanager

import numpy as np
import pandas as pd
import pytest
import yaml

from test_e2e_pipeline import (N_FRAMES, PS_FLUXES, PS_OFFSETS, ROI_DEC,
                               ROI_RA, STAR_FLUXES_E_S, STAR_OFFSETS,
                               workdir)  # noqa: F401  (the scene fixture)

from lightcurver_tpu_torch.processes import (
    absolute_zeropoint_calculation as tzp, normalization_calculation as tnorm,
    psf_modelling as tpsf, roi_file_preparation as troifile,
    roi_modelling as troi, star_photometry as tstar)

DMAG, DERR, DCHI2 = 1e-3, 1e-3, 0.01
PSF_PEAK_TOL, FWHM_RTOL = 6e-2, 8e-2
EXACT = 1e-6

# the chain's tasks in pipeline order, and the port's, on the CPU
TASKS = ["psf_modeling", "star_photometry",
         "calculate_normalization_coefficient",
         "calculate_absolute_zeropoints", "prepare_calibrated_cutouts"]
PORT_TASKS = {
    "psf_modeling": lambda: tpsf.model_all_psfs(device="cpu"),
    "star_photometry": lambda: tstar.do_star_photometry(device="cpu"),
    "calculate_normalization_coefficient": tnorm.calculate_coefficient,
    "calculate_absolute_zeropoints": tzp.calculate_zeropoints,
    "prepare_calibrated_cutouts":
        lambda: troifile.prepare_roi_file(device="cpu"),
}


def _jax_tasks():
    from lightcurver_tpu.processes.absolute_zeropoint_calculation import \
        calculate_zeropoints
    from lightcurver_tpu.processes.normalization_calculation import \
        calculate_coefficient
    from lightcurver_tpu.processes.psf_modelling import model_all_psfs
    from lightcurver_tpu.processes.roi_file_preparation import \
        prepare_roi_file
    from lightcurver_tpu.processes.star_photometry import do_star_photometry

    return dict(zip(TASKS, (model_all_psfs, do_star_photometry,
                            calculate_coefficient, calculate_zeropoints,
                            prepare_roi_file)))


@contextmanager
def _config(path):
    old = os.environ.get("LIGHTCURVER_CONFIG")
    os.environ["LIGHTCURVER_CONFIG"] = str(path / "config.yaml")
    try:
        yield
    finally:
        if old is not None:
            os.environ["LIGHTCURVER_CONFIG"] = old
        else:
            os.environ.pop("LIGHTCURVER_CONFIG", None)


def _copy(src, dst):
    """A copy of a workdir whose config names the copy."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("snap_*",
                                                            "port_*"))
    cfg = yaml.safe_load((dst / "config.yaml").read_text())
    cfg["workdir"] = str(dst)
    (dst / "config.yaml").write_text(yaml.dump(cfg))
    return dst


def _table(path, table, order):
    import sqlite3

    with sqlite3.connect(path / "database.sqlite3") as conn:
        df = pd.read_sql_query(f"SELECT * FROM {table} ORDER BY {order}",
                               conn)
    return df


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's fits here are small: one intra-op thread runs them as
    fast as eight alone, and far faster beside the suite's other workers,
    which would otherwise all spin threads on the same cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def snapshots(workdir):  # noqa: F811
    """{'stamp_extraction': dir, task: dir after JAX's task}."""
    from lightcurver_tpu.pipeline.workflow_manager import WorkflowManager

    with _config(workdir):
        WorkflowManager().run(stop_step="stamp_extraction")
    snaps = {"stamp_extraction": _copy(workdir,
                                       workdir / "snap_stamp_extraction")}
    for name, task in _jax_tasks().items():
        with _config(workdir):
            task()
        snaps[name] = _copy(workdir, workdir / f"snap_{name}")
    return snaps


def _port_task_on_snapshot(snapshots, name):
    """(port's workdir after its task, JAX's snapshot after it)."""
    before = snapshots[TASKS[TASKS.index(name) - 1]
                       if TASKS.index(name) else "stamp_extraction"]
    mine = _copy(before, before.parent / f"port_{name}")
    with _config(mine):
        PORT_TASKS[name]()
    return mine, snapshots[name]


def test_psf_task_matches_jax(snapshots):
    import h5py

    mine, ref = _port_task_on_snapshot(snapshots, "psf_modeling")
    got = _table(mine, "PSFs", "frame_id, psf_ref")
    want = _table(ref, "PSFs", "frame_id, psf_ref")
    assert len(want) == N_FRAMES
    for key in ("frame_id", "psf_ref", "combined_footprint_hash",
                "subsampling_factor"):
        assert got[key].tolist() == want[key].tolist(), key
    np.testing.assert_allclose(got["chi2"], want["chi2"], rtol=DCHI2)
    np.testing.assert_allclose(got["fwhm_moffat_arcseconds"],
                               want["fwhm_moffat_arcseconds"],
                               rtol=FWHM_RTOL)
    frames = _table(ref, "frames", "id").set_index("id")
    with h5py.File(mine / "regions.h5", "r") as fg, \
            h5py.File(ref / "regions.h5", "r") as fw:
        for frame_id, psf_ref in zip(want["frame_id"], want["psf_ref"]):
            key = f"{frames.loc[frame_id, 'image_relpath']}/{psf_ref}"
            g, w = fg[key], fw[key]
            assert set(g) == set(w)
            assert set(g["distortion"]) == set(w["distortion"])
            for name in w["distortion"]:
                np.testing.assert_allclose(g["distortion"][name][...],
                                           w["distortion"][name][...],
                                           atol=1e-6)
            np.testing.assert_array_equal(g["subsampling_factor"][...],
                                          w["subsampling_factor"][...])
            for name in ("narrow_psf", "full_psf"):
                want_psf = w[name][...]
                assert g[name].shape == want_psf.shape
                np.testing.assert_allclose(
                    g[name][...] / want_psf.max(), want_psf / want_psf.max(),
                    atol=PSF_PEAK_TOL)


def test_star_task_matches_jax(snapshots):
    mine, ref = _port_task_on_snapshot(snapshots, "star_photometry")
    order = "star_gaia_id, frame_id"
    got = _table(mine, "star_flux_in_frame", order)
    want = _table(ref, "star_flux_in_frame", order)
    assert len(want) == N_FRAMES * len(STAR_OFFSETS)
    for key in ("combined_footprint_hash", "frame_id", "star_gaia_id"):
        assert got[key].tolist() == want[key].tolist(), key
    dmag = np.abs(2.5 * np.log10(got["flux"] / want["flux"]))
    assert dmag.max() <= DMAG, f"max |dmag| {dmag.max():.2e}"
    np.testing.assert_allclose(got["flux_uncertainty"],
                               want["flux_uncertainty"], rtol=DERR)
    np.testing.assert_allclose(got["chi2"], want["chi2"], rtol=DCHI2)
    # the scene checkpoints every 100 iterations; the task deletes its file
    assert not list((mine / "checkpoints").glob("*.ckpt"))


def test_normalization_task_matches_jax(snapshots):
    mine, ref = _port_task_on_snapshot(
        snapshots, "calculate_normalization_coefficient")
    order = "combined_footprint_hash, frame_id"
    got = _table(mine, "normalization_coefficients", order)
    want = _table(ref, "normalization_coefficients", order)
    assert len(want) == N_FRAMES
    assert got["frame_id"].tolist() == want["frame_id"].tolist()
    for key in ("coefficient", "coefficient_uncertainty"):
        np.testing.assert_allclose(got[key], want[key], rtol=EXACT)


def test_zeropoint_task_matches_jax(snapshots):
    mine, ref = _port_task_on_snapshot(snapshots,
                                       "calculate_absolute_zeropoints")
    got = _table(mine, "absolute_zeropoints", "frame_id")
    want = _table(ref, "absolute_zeropoints", "frame_id")
    assert len(want) == N_FRAMES
    for key in ("frame_id", "combined_footprint_hash", "source_catalog"):
        assert got[key].tolist() == want[key].tolist(), key
    for key in ("zeropoint", "zeropoint_uncertainty"):
        np.testing.assert_allclose(got[key], want[key], rtol=EXACT)
    order = "star_gaia_id, catalog"
    got = _table(mine, "catalog_star_photometry", order)
    want = _table(ref, "catalog_star_photometry", order)
    assert len(want) == len(STAR_OFFSETS)
    assert got.drop(columns="mag").equals(want.drop(columns="mag"))
    np.testing.assert_allclose(got["mag"], want["mag"], rtol=EXACT)


def _datasets(path):
    import h5py

    (file,) = (path / "prepared_roi_cutouts").glob("cutouts_*.h5")
    with h5py.File(file, "r") as f:
        return file.name, {k: f[k][()] for k in f}


def test_roi_file_task_matches_jax(snapshots):
    mine, ref = _port_task_on_snapshot(snapshots,
                                       "prepare_calibrated_cutouts")
    name_got, got = _datasets(mine)
    name_want, want = _datasets(ref)
    assert name_got == name_want
    assert set(got) == set(want)
    for key, value in want.items():
        if value.dtype.kind in "SOU":
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key].shape == value.shape, key
            np.testing.assert_allclose(got[key], value, rtol=EXACT,
                                       err_msg=key)


@pytest.fixture(scope="module")
def port_chain(snapshots):
    """The port's chain, psf_modeling -> model_calibrated_cutouts, on a
    copy of the stamped workdir."""
    mine = _copy(snapshots["stamp_extraction"],
                 snapshots["stamp_extraction"].parent / "port_chain")
    with _config(mine):
        for name in TASKS:
            PORT_TASKS[name]()
        troi.do_modelling_of_roi(device="cpu")
    return mine


def test_port_chain_psfs_and_star_fluxes(port_chain):
    psfs = _table(port_chain, "PSFs", "frame_id")
    assert len(psfs) == N_FRAMES
    assert (psfs["chi2"] < 2.0).all()
    fluxes = _table(port_chain, "star_flux_in_frame", "frame_id")
    stars = _table(port_chain, "stars", "gaia_id")
    assert len(stars) == len(STAR_OFFSETS)
    assert len(fluxes) == N_FRAMES * len(stars)
    assert (fluxes["chi2"] < 2.0).all()
    injected = {str(1000 + i): f for i, f in enumerate(STAR_FLUXES_E_S)}
    for gaia_id, group in fluxes.groupby("star_gaia_id"):
        assert group["flux"].median() == pytest.approx(
            injected[str(gaia_id)], rel=0.1)


def test_port_chain_normalization_and_zeropoints(port_chain):
    coeffs = _table(port_chain, "normalization_coefficients", "frame_id")
    assert len(coeffs) == N_FRAMES
    np.testing.assert_allclose(coeffs["coefficient"], 1.0, atol=0.05)
    assert len(_table(port_chain, "absolute_zeropoints", "frame_id")) \
        == N_FRAMES


def test_port_chain_roi_products(port_chain):
    out_dir = port_chain / "prepared_roi_cutouts"
    (csv,) = out_dir.glob("*_photometry_per_epoch.csv")
    photometry = pd.read_csv(csv)
    assert len(photometry) == N_FRAMES
    assert (photometry["reduced_chi2"] < 2.0).all()
    for ps, fluxes in PS_FLUXES.items():
        np.testing.assert_allclose(np.asarray(photometry[f"{ps}_flux"]),
                                   fluxes, rtol=0.15)
    (astrometry_file,) = out_dir.glob("*_astrometry.json")
    astrometry = json.loads(astrometry_file.read_text())
    for ps, (dx, dy) in PS_OFFSETS.items():
        ra_true = ROI_RA + dx / 3600.0 / np.cos(np.radians(ROI_DEC))
        dec_true = ROI_DEC + dy / 3600.0
        ra_fit, dec_fit = astrometry[ps]
        assert abs(dec_fit - dec_true) * 3600 < 0.3
        assert abs(ra_fit - ra_true) * 3600 < 0.3
    assert list(out_dir.glob("*_high_res_model.fits"))
    assert list(out_dir.glob("*_stack.fits"))
    assert not list((port_chain / "checkpoints").glob("*.ckpt"))


def test_port_chain_rerun_is_incremental(port_chain, monkeypatch):
    """A second run of the chain's tasks finds every PSF and flux in place
    and fits nothing."""
    from lightcurver_tpu_torch.core.deconv import batched as dbatched
    from lightcurver_tpu_torch.core.psf import batched as pbatched

    def refuse(*args, **kwargs):
        raise AssertionError("the rerun fitted again")

    monkeypatch.setattr(pbatched, "build_psf_batched", refuse)
    monkeypatch.setattr(dbatched, "fit_stars_batched", refuse)
    tables = ("PSFs", "star_flux_in_frame", "normalization_coefficients")
    before = {t: _table(port_chain, t, "frame_id") for t in tables}
    with _config(port_chain):
        for name in TASKS:
            PORT_TASKS[name]()
    for table in tables:
        pd.testing.assert_frame_equal(_table(port_chain, table, "frame_id"),
                                      before[table])
