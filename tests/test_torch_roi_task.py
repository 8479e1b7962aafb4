"""Port parity for the ROI pipeline task, ``do_modelling_of_roi``.

One small prepared-ROI workdir (the layout ``roi_file_preparation`` writes,
as ``tests/test_stress_roi_task.py`` builds it, at 8 epochs of 16 px,
s = 2, two sources, 100 + 60 iterations) goes through the JAX task and the
port's task, each once, in a module-scoped fixture, and once more through
the port's task with stage-2 checkpointing on. Bars: the same output
files (footprint hash included), per-epoch and per-night magnitudes
within 1 mmag, reduced chi2 within 1 %, the same CSV columns and index,
astrometry within 1e-6 deg, FITS headers with the same cards, and FITS
data within 1e-3 of the peak of the image each product belongs to (the
1 mmag bar in image form). The host functions the port copies are held
against their JAX twins too.

Stage 1 runs to convergence (its products are the same at 100 and 300
iterations), so both tasks start stage 2 from the same minimum rather
than from two line searches' paths through the descent. The images are
not held to their own peaks: the scene has no background, so the fitted
background, and the data less the point sources, are fit noise whose
peak is no scale (AdaBelief's first steps move a pixel by the learning
rate whatever its gradient's size, so float32 rounding flips the pixels
whose gradient is near zero; measured here at 1-5 % of the background's
own peak, and 2-5e-4 of the model's at 30 stage-1 iterations).
"""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import yaml

from lightcurver_tpu.io import fits as jfits
from lightcurver_tpu.io import wcs as jwcs
from lightcurver_tpu.utilities import footprint as jfootprint
from lightcurver_tpu.utilities import lightcurves_postprocessing as jlc
from lightcurver_tpu.utilities.synthetic import make_roi_scene

from lightcurver_tpu_torch.core import optimize as topt
from lightcurver_tpu_torch.io import fits as tfits
from lightcurver_tpu_torch.io import wcs as twcs
from lightcurver_tpu_torch.processes import roi_modelling as troi
from lightcurver_tpu_torch.structure.database import initialize_database
from lightcurver_tpu_torch.utilities import footprint as tfootprint
from lightcurver_tpu_torch.utilities import lightcurves_postprocessing as tlc

REPO = Path(__file__).resolve().parents[1]
N_EPOCHS, N_PIX, SUB = 8, 16, 2
ROI_RA, ROI_DEC = 42.2031, 19.22528
PIXEL_SCALE = 0.2 / 3600.0  # deg/px
ROI_NAME = "testroi"
ITERS = dict(roi_deconv_translations_iters=100, roi_deconv_all_iters=60)
CHECKPOINT_EVERY = 25
DMAG, DCHI2, DDEG, DFITS = 1e-3, 0.01, 1e-6, 1e-3
# the image whose peak scales each FITS product's bar
PEAK_OF = {"stack": "stack", "stack_no_ps": "stack",
           "stack_no_background": "stack_no_background",
           "high_res_model": "high_res_model",
           "background": "high_res_model"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """As in the calibration chain's file: one intra-op thread beside the
    suite's other workers, which would otherwise all spin threads on the
    same cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ref_wcs():
    crpix = (N_PIX + 1) / 2.0  # 1-based: the stamp centre
    return jwcs.TanWCS(ROI_RA, ROI_DEC, crpix, crpix,
                       [[-PIXEL_SCALE, 0.0], [0.0, PIXEL_SCALE]])


def _write_prepared(path, scene):
    """The prepared-cutouts file, as roi_file_preparation writes it."""
    import h5py

    wcs = _ref_wcs()
    # two epochs a night, so the nightly grouping has work to do
    mjds = 60000.0 + np.repeat(np.arange(N_EPOCHS // 2), 2) \
        + np.tile([0.01, 0.03], N_EPOCHS // 2)
    with h5py.File(path, "w") as f:
        f["frame_id"] = np.arange(N_EPOCHS)
        f["data"] = scene["data"]
        f["noisemap"] = np.sqrt(scene["sigma_2"])
        f["psf"] = scene["psf"]
        f["seeing"] = scene["fwhm"] * PIXEL_SCALE * 3600.0
        f["sky_level_electron_per_second"] = np.full(N_EPOCHS, 10.0)
        f["mjd"] = mjds
        f["global_zeropoint"] = np.full(N_EPOCHS, 27.0)
        f["global_zeropoint_scatter"] = np.full(N_EPOCHS, 0.01)
        f["relative_normalization_error"] = np.full(N_EPOCHS, 0.005)
        f["wcs"] = np.array([json.dumps(wcs.to_header_cards()).encode()]
                            * N_EPOCHS)
        f["pixel_scale"] = np.full(N_EPOCHS, PIXEL_SCALE * 3600.0)
        f["subsampling_factor"] = np.full(N_EPOCHS, SUB)
        f["angle_to_north"] = np.linspace(0.0, 0.5, N_EPOCHS)


def _workdir(root, name, scene, **overrides):
    """A workdir with the prepared file, a database and a config."""
    tmp = root / name
    tmp.mkdir()
    prepared = tmp / f"cutouts_test_{ROI_NAME}.h5"
    _write_prepared(prepared, scene)
    wcs = _ref_wcs()
    ps_world = {}
    for label, x0, y0 in zip("AB", scene["xs"], scene["ys"]):
        ra, dec = wcs.pixel_to_world(float(x0) + (N_PIX - 1) / 2.0,
                                     float(y0) + (N_PIX - 1) / 2.0)
        ps_world[label] = [float(ra), float(dec)]
    with open(REPO / "lightcurver_tpu/pipeline/example_config_file/"
              "config.yaml") as f:
        config = yaml.safe_load(f)
    config.update({
        "workdir": str(tmp), "raw_dirs": [str(tmp)], "do_ROI_model": True,
        "roi_name": ROI_NAME, "prepared_roi_cutouts_path": str(prepared),
        "point_sources": ps_world, "star_selection_strategy": "ROI_disk",
        "ROI_disk_radius_arcseconds": 30, "subsampling_factor": SUB,
        "fix_point_source_astrometry": 0.5, "deconv_checkpoint_every": 0,
        "constraints_on_frame_columns_for_roi": {},
        "constraints_on_normalization_coeff": {}, **ITERS, **overrides})
    config["ROI"] = {ROI_NAME: {"coordinates": [ROI_RA, ROI_DEC]}}
    config_path = tmp / "config.yaml"
    config_path.write_text(yaml.dump(config))
    initialize_database(tmp / "database.sqlite3")
    return tmp, config_path


def _run_task(task, config_path):
    old = os.environ.get("LIGHTCURVER_CONFIG")
    os.environ["LIGHTCURVER_CONFIG"] = str(config_path)
    try:
        task()
    finally:
        if old is not None:
            os.environ["LIGHTCURVER_CONFIG"] = old
        else:
            os.environ.pop("LIGHTCURVER_CONFIG", None)


def _products(tmp):
    """Output file name -> path, beside the prepared file."""
    inputs = {f"cutouts_test_{ROI_NAME}.h5", "config.yaml"}
    return {p.name: p for p in tmp.iterdir()
            if p.is_file() and p.name not in inputs
            and not p.name.startswith("database.sqlite3")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from lightcurver_tpu.processes.roi_modelling import \
        do_modelling_of_roi as jax_task

    root = tmp_path_factory.mktemp("roi_task_port")
    scene = make_roi_scene(n_epochs=N_EPOCHS, n_pix=N_PIX, s=SUB,
                           n_sources=2, noise_sigma=0.3, seed=11)
    dirs = {}
    for name, extra in (("jax", {}), ("torch", {}),
                        ("torch_ckpt",
                         {"deconv_checkpoint_every": CHECKPOINT_EVERY})):
        dirs[name] = _workdir(root, name, scene, **extra)
    _run_task(jax_task, dirs["jax"][1])
    _run_task(lambda: troi.do_modelling_of_roi(device="cpu"),
              dirs["torch"][1])

    # the checkpointed run: count the writes of the real writer
    writes = []
    save = topt.save_checkpoint

    def counting_save(path, *args, **kwargs):
        writes.append(Path(path))
        return save(path, *args, **kwargs)

    topt.save_checkpoint = counting_save
    try:
        _run_task(lambda: troi.do_modelling_of_roi(device="cpu"),
                  dirs["torch_ckpt"][1])
    finally:
        topt.save_checkpoint = save
    yield {name: tmp for name, (tmp, _) in dirs.items()}, writes
    shutil.rmtree(root, ignore_errors=True)


def _csv(tmp, kind):
    (path,) = [p for n, p in _products(tmp).items()
               if n.endswith(f"_photometry_{kind}.csv")]
    return pd.read_csv(path, index_col=0)


def test_task_writes_the_same_files(runs):
    dirs, _ = runs
    jax_files = set(_products(dirs["jax"]))
    port_files = set(_products(dirs["torch"]))
    assert port_files == jax_files
    assert len(port_files) == 9
    assert any(n.endswith("_photometry_per_night.html") for n in port_files)
    footprint_hash = tfootprint.get_combined_footprint_hash(
        {"star_selection_strategy": "ROI_disk",
         "ROI_disk_radius_arcseconds": 30}, [])
    assert all(n.startswith(f"{footprint_hash}_{ROI_NAME}_")
               for n in port_files)


@pytest.mark.parametrize("kind", ["per_epoch", "per_night"])
def test_task_light_curves_match_jax(runs, kind):
    dirs, _ = runs
    jax_df, port_df = _csv(dirs["jax"], kind), _csv(dirs["torch"], kind)
    assert list(port_df.columns) == list(jax_df.columns)
    np.testing.assert_array_equal(port_df.index, jax_df.index)
    for ps in "AB":
        dmag = np.abs(port_df[f"{ps}_mag"] - jax_df[f"{ps}_mag"])
        assert np.isfinite(port_df[f"{ps}_mag"]).all()
        assert dmag.max() <= DMAG, (ps, dmag.max())
    if kind == "per_epoch":
        dchi2 = np.abs(port_df["reduced_chi2"] / jax_df["reduced_chi2"] - 1)
        assert dchi2.max() <= DCHI2, dchi2.max()


def test_task_astrometry_matches_jax(runs):
    dirs, _ = runs

    def load(tmp):
        (path,) = [p for n, p in _products(tmp).items()
                   if n.endswith("_astrometry.json")]
        return json.loads(path.read_text())

    jax_astro, port_astro = load(dirs["jax"]), load(dirs["torch"])
    assert sorted(port_astro) == sorted(jax_astro) == ["A", "B"]
    for ps, (ra, dec) in jax_astro.items():
        np.testing.assert_allclose(port_astro[ps], [ra, dec], rtol=0,
                                   atol=DDEG)


@pytest.mark.parametrize("product", sorted(PEAK_OF))
def test_task_fits_products_match_jax(runs, product):
    dirs, _ = runs

    def load(tmp, name):
        (path,) = [p for n, p in _products(tmp).items()
                   if n.endswith(f"_{ROI_NAME}_{name}.fits")]
        return jfits.read_fits(path)

    jax_img, jax_head = load(dirs["jax"], product)
    port_img, port_head = load(dirs["torch"], product)
    assert port_head.keys() == jax_head.keys()
    for key in jax_head.keys():
        if isinstance(jax_head[key], float):
            assert port_head[key] == pytest.approx(jax_head[key],
                                                   rel=1e-12), key
        else:
            assert port_head[key] == jax_head[key], key
    assert port_img.shape == jax_img.shape
    assert np.isfinite(port_img).all()
    peak = np.abs(load(dirs["jax"], PEAK_OF[product])[0]).max()
    err = np.abs(port_img - jax_img).max()
    assert err <= DFITS * peak, (err, peak)


def test_task_checkpointed_run_is_unchanged(runs):
    """With ``deconv_checkpoint_every`` set, stage 2 writes a checkpoint
    per segment, the result is the same, and no checkpoint file is left."""
    dirs, writes = runs
    assert len(writes) == -(-ITERS["roi_deconv_all_iters"]
                            // CHECKPOINT_EVERY)
    assert all(w.parent == dirs["torch_ckpt"] / "checkpoints"
               for w in writes)
    assert not any(w.exists() for w in writes)
    assert not list((dirs["torch_ckpt"] / "checkpoints").iterdir())
    for kind in ("per_epoch", "per_night"):
        pd.testing.assert_frame_equal(_csv(dirs["torch_ckpt"], kind),
                                      _csv(dirs["torch"], kind),
                                      check_exact=True)


def test_copied_host_functions_match_jax(tmp_path):
    """The host functions the port copies give what their JAX twins
    give: footprint hash, nightly grouping, magnitudes, the TAN WCS both
    ways and its fine-grid version, and a FITS round trip."""
    ids = [5, 3, 11, 7]
    assert tfootprint.get_frames_hash(ids) == jfootprint.get_frames_hash(ids)
    for cfg in ({"star_selection_strategy": "ROI_disk",
                 "ROI_disk_radius_arcseconds": 12.5},
                {"star_selection_strategy": "stars_per_frame"}):
        assert (tfootprint.get_combined_footprint_hash(cfg, ids)
                == jfootprint.get_combined_footprint_hash(cfg, ids))

    rng = np.random.default_rng(4)
    n = 12
    df = pd.DataFrame({
        "frame_id": np.arange(n), "mjd": 60000 + np.repeat(np.arange(4), 3)
        + rng.uniform(0, 0.1, n), "zeropoint": 27.0,
        "reduced_chi2": rng.uniform(0.9, 1.1, n),
        "QSO_A_flux": rng.normal(100.0, 3.0, n),
        "QSO_A_d_flux": rng.uniform(1.0, 2.0, n),
        "B_flux": rng.normal(-5.0, 30.0, n), "B_d_flux": 2.0,
    }).set_index("frame_id")
    df.loc[4, "B_flux"] = np.nan
    for got, want in ((tlc.group_observations(df),
                       jlc.group_observations(df)),
                      (tlc.convert_flux_to_magnitude(df),
                       jlc.convert_flux_to_magnitude(df))):
        pd.testing.assert_frame_equal(got, want)

    header = {"CTYPE1": "RA---TAN-SIP", "CTYPE2": "DEC--TAN-SIP",
              "CRVAL1": ROI_RA, "CRVAL2": ROI_DEC, "CRPIX1": 40.5,
              "CRPIX2": 30.5, "CD1_1": -PIXEL_SCALE, "CD1_2": 1e-7,
              "CD2_1": 2e-7, "CD2_2": PIXEL_SCALE, "A_ORDER": 2,
              "A_2_0": 1e-5, "B_ORDER": 2, "B_0_2": -2e-5}
    x = rng.uniform(0, 80, 20)
    y = rng.uniform(0, 60, 20)
    for s in (1, 2, 3):
        twin, jwin = (twcs.upsampled_wcs(twcs.TanWCS.from_header(header), s),
                      jwcs.upsampled_wcs(jwcs.TanWCS.from_header(header), s))
        assert twin.to_header_cards() == jwin.to_header_cards()
        ra, dec = twin.pixel_to_world(x, y)
        np.testing.assert_array_equal((ra, dec), jwin.pixel_to_world(x, y))
        back = twin.world_to_pixel(ra, dec)
        np.testing.assert_array_equal(back, jwin.world_to_pixel(ra, dec))
        np.testing.assert_allclose(back, (x, y), atol=1e-6)

    image = rng.normal(size=(9, 7)).astype(np.float32)
    head = tfits.Header()
    head.update(twcs.TanWCS.from_header(header).to_header_cards())
    head["ZPT"] = 27.5
    head["COMMENT"] = "a comment card"
    tfits.write_fits(tmp_path / "port.fits", image, head)
    jhead = jfits.Header()
    jhead.update(head.items())
    jfits.write_fits(tmp_path / "jax.fits", image, jhead)
    assert ((tmp_path / "port.fits").read_bytes()
            == (tmp_path / "jax.fits").read_bytes())
    got, got_head = tfits.read_fits(tmp_path / "jax.fits")
    np.testing.assert_array_equal(got, image)
    assert got_head.items() == jfits.read_fits(tmp_path / "port.fits")[1] \
        .items()
