"""The port's whole pipeline against JAX's, from raw frames to the light
curves, through each package's own ``WorkflowManager``.

One module-scoped fixture takes ``tests/test_e2e_pipeline.py``'s synthetic
scene (3 frames of 160 px, 8 stars, 2 blended ROI sources, the Gaia
fixture, that file's small budgets) through JAX's ``WorkflowManager()``
and the port's ``WorkflowManager(device="cpu")``, each on its own copy of
the empty workdir. JAX's front runs on the numpy twins of its host C++,
as in ``tests/test_torch_front_tasks.py``, so the front compares to the
bit.

On the port's run, the e2e file's eight invariants, one test each and
named as there (the rerun, the adapt-WCS fault and the field-distortion
redo each on a copy of the finished workdir). Against JAX's run: the same
task order, the same rows by key in every table, the front tables equal
(floats to a relative 1e-12, the same numpy code on the same inputs), the
same product files under the workdir (timestamps in names masked, logs
left out), and the star and ROI fluxes within the e2e bars of JAX's
(10 % and 15 %, the ROI astrometry within 0.3"). ``chip_smoke.py``'s
writer of the same scene gives the fixture's frames to the bit.
"""

import json
import os
import re
import shutil
import sqlite3
import sys
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import yaml

from test_e2e_pipeline import (FRAME_DITHER_PX, FRAME_FWHM_PX, N_FRAMES,
                               PS_FLUXES, PS_OFFSETS, ROI_DEC, ROI_RA,
                               STAR_FLUXES_E_S, STAR_OFFSETS, _make_wcs,
                               workdir)  # noqa: F401  (the scene fixture)

from lightcurver_tpu_torch.io.fits import read_fits
from lightcurver_tpu_torch.io.wcs import TanWCS
from lightcurver_tpu_torch.pipeline.workflow_manager import WorkflowManager

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-12
STAR_RTOL, ROI_RTOL, ASTROMETRY_ARCSEC = 0.1, 0.15, 0.3
FRONT_TABLES = ["frames", "footprints", "combined_footprint", "stars",
                "stars_in_frames"]
TIMESTAMP = re.compile(r"\d{4}-\d{2}-\d{2}T\d{2}-\d{2}-\d{2}")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """As in the calibration chain's file: one intra-op thread beside the
    suite's other workers."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _jax_on_numpy_twins():
    """Both packages' background, extraction and cosmics on their numpy
    twins: the C++ libraries off, and both load caches reset for this
    module only."""
    import lightcurver_tpu.native as nat
    import lightcurver_tpu_torch.native as port_nat

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIGHTCURVER_DISABLE_NATIVE", "1")
        for module in (nat, port_nat):
            mp.setattr(module, "_lib", None)
            mp.setattr(module, "_tried", False)
        yield


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


def _copy(src, dst, **config):
    """A copy of a workdir whose config names the copy (and ``config``'s
    overrides); the raw frames stay where the config points."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("jax_*",
                                                            "port_*"))
    cfg = yaml.safe_load((dst / "config.yaml").read_text())
    cfg.update(workdir=str(dst), **config)
    (dst / "config.yaml").write_text(yaml.dump(cfg))
    return dst


def _table(path, table, order="rowid"):
    with sqlite3.connect(path / "database.sqlite3") as conn:
        return pd.read_sql_query(f"SELECT * FROM {table} ORDER BY {order}",
                                 conn)


def _table_keys(path):
    """{table: (its primary-key columns, the set of their values)}."""
    out = {}
    with sqlite3.connect(path / "database.sqlite3") as conn:
        names = [r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type = 'table'")]
        for name in names:
            info = conn.execute(f"PRAGMA table_info({name})").fetchall()
            keys = [col[1] for col in sorted(info, key=lambda c: c[5])
                    if col[5] > 0]
            rows = conn.execute(
                f"SELECT {', '.join(keys)} FROM {name}").fetchall()
            out[name] = (keys, set(rows))
    return out


@pytest.fixture(scope="module")
def runs(workdir):  # noqa: F811
    """JAX's and the port's whole pipeline, each on a copy of the empty
    workdir: {"jax": dir, "port": dir, "orders": (jax's, the port's)}."""
    from lightcurver_tpu.pipeline.workflow_manager import \
        WorkflowManager as JaxWorkflowManager

    jax_dir = _copy(workdir, workdir / "jax_run")
    port_dir = _copy(workdir, workdir / "port_run")
    with _config(jax_dir):
        jax_manager = JaxWorkflowManager()
        jax_manager.run()
    with _config(port_dir):
        port_manager = WorkflowManager(device="cpu")
        port_manager.run()
    return {"jax": jax_dir, "port": port_dir,
            "orders": (jax_manager.topological_sort(),
                       port_manager.topological_sort())}


# ---------------------------------------------------------------------------
# the e2e file's eight invariants, on the port's run
# ---------------------------------------------------------------------------

def test_frames_imported_and_solved(runs):
    frames = _table(runs["port"], "frames")
    assert len(frames) == N_FRAMES
    assert (frames["plate_solved"] == 1).all()
    assert (frames["roi_in_footprint"] == 1).all()
    assert (frames["eliminated"] == 0).all()
    np.testing.assert_allclose(np.sort(frames["seeing_pixels"]),
                               np.sort(FRAME_FWHM_PX), atol=0.8)


def test_psfs_built_with_good_chi2(runs):
    psfs = _table(runs["port"], "PSFs")
    assert len(psfs) == N_FRAMES
    assert (psfs["chi2"] < 2.0).all()


def test_star_fluxes_measured(runs):
    fluxes = _table(runs["port"], "star_flux_in_frame")
    stars = _table(runs["port"], "stars")
    assert len(stars) == len(STAR_OFFSETS)
    assert len(fluxes) == N_FRAMES * len(stars)
    assert (fluxes["chi2"] < 2.0).all()
    injected = {str(1000 + i): f for i, f in enumerate(STAR_FLUXES_E_S)}
    for gaia_id, group in fluxes.groupby("star_gaia_id"):
        assert group["flux"].median() == pytest.approx(
            injected[str(gaia_id)], rel=STAR_RTOL)


def test_normalization_and_zeropoints(runs):
    coeffs = _table(runs["port"], "normalization_coefficients")
    assert len(coeffs) == N_FRAMES
    np.testing.assert_allclose(coeffs["coefficient"], 1.0, atol=0.05)
    assert len(_table(runs["port"], "absolute_zeropoints")) == N_FRAMES


def _roi_products(path):
    """(per-epoch photometry, astrometry) of a finished workdir."""
    out_dir = path / "prepared_roi_cutouts"
    (csv,) = out_dir.glob("*_photometry_per_epoch.csv")
    (astrometry,) = out_dir.glob("*_astrometry.json")
    return pd.read_csv(csv), json.loads(astrometry.read_text())


def test_roi_products_and_fluxes(runs):
    port = runs["port"]
    photometry, astrometry = _roi_products(port)
    assert len(photometry) == N_FRAMES
    assert (photometry["reduced_chi2"] < 2.0).all()
    for ps, fluxes in PS_FLUXES.items():
        np.testing.assert_allclose(np.asarray(photometry[f"{ps}_flux"]),
                                   fluxes, rtol=ROI_RTOL)
    for ps, (dx, dy) in PS_OFFSETS.items():
        ra_true = ROI_RA + dx / 3600.0 / np.cos(np.radians(ROI_DEC))
        dec_true = ROI_DEC + dy / 3600.0
        ra_fit, dec_fit = astrometry[ps]
        assert abs(dec_fit - dec_true) * 3600 < ASTROMETRY_ARCSEC
        assert abs(ra_fit - ra_true) * 3600 < ASTROMETRY_ARCSEC
    out_dir = port / "prepared_roi_cutouts"
    assert list(out_dir.glob("*_high_res_model.fits"))
    assert list(out_dir.glob("*_stack.fits"))
    assert not list((port / "checkpoints").glob("*.ckpt"))


def test_rerun_is_incremental(runs, monkeypatch):
    """A rerun to the normalization finds every PSF and flux in place,
    fits nothing and adds no row."""
    from lightcurver_tpu_torch.core.deconv import batched as dbatched
    from lightcurver_tpu_torch.core.psf import batched as pbatched

    def refuse(*args, **kwargs):
        raise AssertionError("the rerun fitted again")

    monkeypatch.setattr(pbatched, "build_psf_batched", refuse)
    monkeypatch.setattr(dbatched, "fit_stars_batched", refuse)
    mine = _copy(runs["port"], runs["port"].parent / "port_rerun")
    with _config(mine):
        WorkflowManager(device="cpu").run(
            stop_step="calculate_normalization_coefficient")
    assert len(_table(mine, "frames")) == N_FRAMES
    assert len(_table(mine, "PSFs")) == N_FRAMES
    assert len(_table(mine, "star_flux_in_frame")) == \
        N_FRAMES * len(STAR_OFFSETS)


def test_adapt_wcs_recovers_injected_fault(runs):
    """Frame 2 flipped to unsolved is re-solved by the port's adapt-WCS
    solver from frame 1, the ROI within 0.3 px of the true WCS."""
    from lightcurver_tpu_torch.processes.\
        alternate_plate_solving_adapt_existing_wcs import \
        alternate_plate_solve_adapt_ref

    mine = _copy(runs["port"], runs["port"].parent / "port_adapt",
                 plate_solve_frames="all_not_plate_solved",
                 reference_frame_for_wcs=1)
    with sqlite3.connect(mine / "database.sqlite3") as conn:
        conn.execute("UPDATE frames SET plate_solved = 0, "
                     "attempted_plate_solve = 0 WHERE id = 2")
    with _config(mine):
        alternate_plate_solve_adapt_ref()
    frame = _table(mine, "frames").set_index("id").loc[2]
    assert int(frame["plate_solved"]) == 1
    _, header = read_fits(mine / frame["image_relpath"], header_only=True)
    x, y = TanWCS.from_header(header).world_to_pixel(ROI_RA, ROI_DEC)
    xt, yt = _make_wcs(FRAME_DITHER_PX[1]).world_to_pixel(ROI_RA, ROI_DEC)
    assert abs(float(x) - float(xt)) < 0.3
    assert abs(float(y) - float(yt)) < 0.3


def test_field_distortion_redo(runs):
    """The PSF task again through the port's manager, with the field
    distortion and redo_psf on."""
    mine = _copy(runs["port"], runs["port"].parent / "port_distortion",
                 field_distortion=True, redo_psf=True,
                 psf_n_iter_analytic=20, psf_n_iter_pixels=60)
    with _config(mine):
        WorkflowManager(device="cpu").run(start_step="psf_modeling",
                                          stop_step="psf_modeling")
    psfs = _table(mine, "PSFs")
    assert len(psfs) == N_FRAMES
    assert (psfs["chi2"] < 3.0).all()


# ---------------------------------------------------------------------------
# the port's run against JAX's
# ---------------------------------------------------------------------------

def test_same_task_order(runs):
    jax_order, port_order = runs["orders"]
    assert port_order == jax_order
    assert len(port_order) == 12


def test_same_rows_by_key_in_every_table(runs):
    got, want = _table_keys(runs["port"]), _table_keys(runs["jax"])
    assert got.keys() == want.keys()
    for name, (keys, rows) in want.items():
        assert got[name][0] == keys, name
        assert got[name][1] == rows, name
        assert rows, f"{name} is empty"


@pytest.mark.parametrize("table", FRONT_TABLES)
def test_front_table_equals_jax(runs, table):
    got = _table(runs["port"], table)
    want = _table(runs["jax"], table)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) > 0
    for col in want.columns:
        assert got[col].dtype == want[col].dtype, col
        if want[col].dtype.kind == "f":
            np.testing.assert_allclose(got[col], want[col], rtol=RTOL,
                                       atol=0.0, err_msg=col)
        else:
            assert got[col].tolist() == want[col].tolist(), col


def _product_files(path):
    """Relative paths of every file under a workdir but its logs, the
    timestamps in names masked."""
    return sorted(TIMESTAMP.sub("<time>", str(p.relative_to(path)))
                  for p in path.rglob("*")
                  if p.is_file() and p.relative_to(path).parts[0] != "logs")


def test_same_product_files(runs):
    got, want = _product_files(runs["port"]), _product_files(runs["jax"])
    assert got == want
    # the diagnostics the tasks write by default are among them
    for pattern in ("plots/footprints.jpg",
                    "plots/footprints_with_gaia_stars.jpg",
                    "plots/PSFs/", "plots/star_modelling/",
                    "plots/normalization/", "plots/pixel_modelling/",
                    "_photometry_per_night.html"):
        assert any(pattern in f for f in got), pattern


def test_star_fluxes_within_the_e2e_bar_of_jax(runs):
    order = "star_gaia_id, frame_id"
    got = _table(runs["port"], "star_flux_in_frame", order)
    want = _table(runs["jax"], "star_flux_in_frame", order)
    assert got["star_gaia_id"].tolist() == want["star_gaia_id"].tolist()
    assert got["frame_id"].tolist() == want["frame_id"].tolist()
    np.testing.assert_allclose(got["flux"], want["flux"], rtol=STAR_RTOL)
    dmag = np.abs(2.5 * np.log10(got["flux"] / want["flux"]))
    print(f"star fluxes, port vs JAX: max |dmag| {dmag.max() * 1e3:.4f} "
          f"mmag over {len(dmag)}")


def test_roi_fluxes_within_the_e2e_bar_of_jax(runs):
    got, got_astrometry = _roi_products(runs["port"])
    want, want_astrometry = _roi_products(runs["jax"])
    assert got["frame_id"].tolist() == want["frame_id"].tolist()
    dmag = []
    for ps in PS_FLUXES:
        np.testing.assert_allclose(got[f"{ps}_flux"], want[f"{ps}_flux"],
                                   rtol=ROI_RTOL)
        dmag.append(np.abs(2.5 * np.log10(got[f"{ps}_flux"]
                                          / want[f"{ps}_flux"])).max())
        for g, w in zip(got_astrometry[ps], want_astrometry[ps]):
            assert abs(g - w) * 3600 < ASTROMETRY_ARCSEC
    print(f"ROI fluxes, port vs JAX: max |dmag| {max(dmag) * 1e3:.4f} mmag")


def test_chip_smoke_scene_writer_gives_the_fixture(workdir,  # noqa: F811
                                                   tmp_path):
    """``chip_smoke.write_e2e_scene`` (the port's modules only) writes the
    fixture's raw frames to the bit, its Gaia CSV and its config."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))

    config, fixture = chip_smoke.write_e2e_scene(np, tmp_path)
    raw = sorted((workdir / "raw").glob("*.fits"))
    assert [p.name for p in sorted((tmp_path / "raw").glob("*"))] \
        == [p.name for p in raw] and len(raw) == N_FRAMES
    for path in raw:
        data, header = read_fits(tmp_path / "raw" / path.name)
        want_data, want_header = read_fits(path)
        assert data.dtype == want_data.dtype
        np.testing.assert_array_equal(data, want_data)
        assert header.cards() == want_header.cards()
    assert fixture.read_bytes() == (workdir / "gaia_fixture.csv").read_bytes()
    assert (tmp_path / "header_parser" / "parse_header.py").read_text() == \
        (workdir / "header_parser" / "parse_header.py").read_text()
    got = yaml.safe_load(config.read_text())
    want = yaml.safe_load((workdir / "config.yaml").read_text())
    for key in ("workdir", "raw_dirs"):
        got.pop(key)
        want.pop(key)
    assert got == want
