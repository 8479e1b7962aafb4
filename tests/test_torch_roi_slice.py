"""Port parity for the whole slice, and the port's guards.

``fit_roi`` is held against the JAX composition of the ROI task body
(lightcurver_tpu/processes/roi_modelling.py, do_modelling_of_roi from the
data scaling to the GLS flux polish, plus the flux errors and per-frame
chi2 of get_fluxes_dataframe_from_model), on one scene with the JAX
starlet weights W handed to both, on each render backend: "fft", and
the port's "matmul" against JAX's "mxu". Bars: fluxes within 1 mmag,
reduced chi2 within 1 %, source positions within 0.01 px (the two L-BFGS
line searches take different paths to the same minimum).
"""

import subprocess
import sys
from copy import deepcopy
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import yaml

from lightcurver_tpu.core.deconv.loss import Loss
from lightcurver_tpu.core.deconv.model import setup_model
from lightcurver_tpu.core.fisher import (get_flux_uncertainties,
                                         linear_flux_solve)
from lightcurver_tpu.core.noise import propagate_noise
from lightcurver_tpu.core.optimize import Optimizer
from lightcurver_tpu.core.params import Params
from lightcurver_tpu import ops as jops
from lightcurver_tpu.processes.roi_modelling import \
    circular_aperture_photometry

from lightcurver_tpu_torch.processes import roi_modelling as troi
from lightcurver_tpu_torch.utilities.synthetic import make_roi_scene

REPO = Path(__file__).resolve().parents[1]


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


def _jax_fit_roi(data, noisemap, psf, xs, ys, s, seeings, pixel_scale,
                 angles, config, W, irfft_backend):
    """The JAX task body on arrays, single device, no checkpointing."""
    data, noisemap = data.copy(), noisemap.copy()
    scale = float(np.nanmax(data))
    data /= scale
    noisemap /= scale
    n_epochs, ny, nx = data.shape
    stack = np.nanmedian(data, axis=0)
    radius = 0.66 * float(np.mean(seeings)) / pixel_scale
    fluxes0 = circular_aperture_photometry(stack, list(zip(xs, ys)), radius)
    cx0, cy0 = xs - (nx - 1) / 2.0, ys - (ny - 1) / 2.0
    model, kw_init, kw_up, kw_down, _ = setup_model(
        data, noisemap**2, psf, cx0, cy0, s,
        np.tile(np.array(fluxes0, dtype=np.float32), n_epochs))
    kw_init["kwargs_analytic"]["alpha"] = np.asarray(angles - angles[0],
                                                     dtype=np.float32)
    reg = config["roi_model_regularization"]

    def run_fit(kw_start, kw_fixed, method, n_iter, loss_kwargs, lr,
                schedule):
        params = Params(kw_start, kw_fixed, kw_up, kw_down)
        loss = Loss(data, model, params, noisemap**2,
                    irfft_backend=irfft_backend, **loss_kwargs)
        optim = Optimizer(loss, params, method=method)
        optim.minimize(max_iterations=n_iter, init_learning_rate=lr,
                       schedule_learning_rate=schedule)
        return params.best_fit_values(as_kwargs=True)

    fixed1 = deepcopy(kw_init)
    for k in ("dx", "dy", "a"):
        del fixed1["kwargs_analytic"][k]
    kw1 = run_fit(kw_init, fixed1, "l-bfgs-b",
                  config["roi_deconv_translations_iters"],
                  dict(prior=None,
                       regularization_strength_flux_uniformity=reg[
                           "regularization_scatter_fluxes_pre_optim"]),
                  1e-3, True)
    fixed2 = deepcopy(kw1)
    del fixed2["kwargs_background"]["h"]
    del fixed2["kwargs_background"]["mean"]
    for k in ("a", "c_x", "c_y", "dx", "dy"):
        del fixed2["kwargs_analytic"][k]
    kw2 = run_fit(kw1, fixed2, "adabelief", config["roi_deconv_all_iters"],
                  dict(regularization_terms="l1_starlet",
                       regularization_strength_scales=reg[
                           "regularization_strength_scales"],
                       regularization_strength_hf=reg[
                           "regularization_strength_hf"],
                       regularization_strength_positivity=reg[
                           "regularization_strength_positivity"],
                       regularization_strength_pts_source=reg[
                           "regularization_strength_pts_source"],
                       regularization_strength_flux_uniformity=reg[
                           "regularization_scatter_fluxes_main_optim"],
                       W=W, prior=None),
                  1e-4, False)
    final = linear_flux_solve(kw2, jnp.asarray(data),
                              jnp.asarray(noisemap**2), model)
    M = len(xs)
    fluxes = np.asarray(final["kwargs_analytic"]["a"]).reshape(-1, M)
    errors = np.asarray(get_flux_uncertainties(
        final, None, None, data, noisemap, model)).reshape(-1, M)
    res = data - np.asarray(model.model(final))
    chi2 = np.nansum(res**2 / noisemap**2, axis=(1, 2)) / nx**2
    return dict(fluxes=fluxes * scale, flux_errors=errors * scale,
                reduced_chi2=chi2, kwargs=final, model=model,
                noisemap=noisemap)


@pytest.mark.parametrize("backend,jax_backend", [("fft", "fft"),
                                                 ("matmul", "mxu")])
def test_fit_roi_matches_jax_composition(backend, jax_backend, monkeypatch):
    N, n, s, M = 6, 16, 2, 2
    sc = make_roi_scene(n_epochs=N, n_pix=n, s=s, n_sources=M, seed=5,
                        noise_sigma=0.3)
    noisemap = np.sqrt(sc["sigma_2"])
    xs = sc["xs"].astype(np.float64) + (n - 1) / 2 + 0.15
    ys = sc["ys"].astype(np.float64) + (n - 1) / 2 - 0.1
    seeings = np.full(N, 0.9)
    angles = np.linspace(0.0, 2.0, N)
    config = dict(troi.ROI_CONFIG, roi_deconv_translations_iters=30,
                  roi_deconv_all_iters=40)

    # the JAX starlet weights on the JAX backend, handed to both sides
    monkeypatch.setattr(jops, "_IRFFT_BACKEND", jax_backend)
    from lightcurver_tpu.core.deconv.model import setup_model as jsetup
    jm = jsetup(sc["data"], sc["sigma_2"], sc["psf"], sc["xs"], sc["ys"],
                s)[0]
    scale = float(np.nanmax(sc["data"]))
    W = np.asarray(propagate_noise(jm, noisemap / scale, None,
                                   num_samples=500, seed=1)[0])

    ref = _jax_fit_roi(sc["data"], noisemap, sc["psf"], xs, ys, s, seeings,
                       0.3, angles, config, W, jax_backend)
    out = troi.fit_roi(sc["data"], noisemap, sc["psf"], xs, ys, s, seeings,
                       0.3, angles, config, device="cpu", noise_weights=W,
                       irfft_backend=backend)

    assert out["fluxes"].shape == (N, M)
    dmag = 2.5 * np.log10(out["fluxes"] / ref["fluxes"])
    assert np.abs(dmag).max() < 1e-3, dmag
    np.testing.assert_allclose(out["flux_errors"], ref["flux_errors"],
                               rtol=1e-3)
    np.testing.assert_allclose(out["reduced_chi2"], ref["reduced_chi2"],
                               rtol=0.01)
    for k in ("c_x", "c_y"):
        np.testing.assert_allclose(
            out["kwargs"]["kwargs_analytic"][k],
            np.asarray(ref["kwargs"]["kwargs_analytic"][k]), rtol=0,
            atol=0.01)
    assert out["loss_history_stage1"].shape == (30,)
    assert out["loss_history_stage2"].shape == (40,)
    assert np.all(np.isfinite(out["residuals"]))
    # the fit recovers the truth at this SNR
    assert np.abs(out["fluxes"] / sc["a_true"] - 1).max() < 0.1


@pytest.mark.parametrize("fix", [True, 0.05])
def test_fit_roi_astrometry_options_and_starting_background(fix):
    """Fixed astrometry keeps the config positions; a Gaussian prior keeps
    them near; a starting background is where stage 2 starts from."""
    N, n, s, M = 4, 12, 2, 2
    sc = make_roi_scene(n_epochs=N, n_pix=n, s=s, n_sources=M, seed=2)
    xs = sc["xs"].astype(np.float64) + (n - 1) / 2 + 0.3
    ys = sc["ys"].astype(np.float64) + (n - 1) / 2
    bck = np.full((n * s) ** 2, 0.01, np.float32)
    config = dict(troi.ROI_CONFIG, fix_point_source_astrometry=fix,
                  starting_background=bck, roi_deconv_translations_iters=5,
                  roi_deconv_all_iters=5)
    out = troi.fit_roi(sc["data"], np.sqrt(sc["sigma_2"]), sc["psf"], xs,
                       ys, s, np.full(N, 0.9), 0.3, np.zeros(N), config,
                       device="cpu")
    c_x = out["kwargs"]["kwargs_analytic"]["c_x"]
    shift = np.abs(c_x - (xs - (n - 1) / 2)).max()
    if fix is True:
        assert shift < 1e-6   # float32 of the config positions
    else:
        assert 0.0 < shift < 5 * 1e-4 * 5   # 5 AdaBelief steps of lr 1e-4
    h = out["kwargs"]["kwargs_background"]["h"]
    scale = out["scale"]
    assert np.abs(h - 0.01 / scale).max() < 5 * 1.2e-4
    assert np.all(np.isfinite(out["fluxes"]))


def test_fit_roi_refuses_an_unknown_backend():
    """JAX's name "mxu" is "matmul" here; anything else raises."""
    sc = make_roi_scene(n_epochs=2, n_pix=8, s=2, n_sources=1, seed=1)
    with pytest.raises(ValueError, match="irfft_backend='mxu'"):
        troi.fit_roi(sc["data"], np.sqrt(sc["sigma_2"]), sc["psf"],
                     sc["xs"] + 3.5, sc["ys"] + 3.5, 2, np.full(2, 0.9), 0.3,
                     np.zeros(2), troi.ROI_CONFIG, device="cpu",
                     irfft_backend="mxu")


def test_roi_config_is_the_shipped_one():
    with open(REPO / "lightcurver_tpu" / "pipeline" / "example_config_file"
              / "config.yaml") as f:
        shipped = yaml.safe_load(f)
    for key, value in troi.ROI_CONFIG.items():
        assert shipped[key] == value, key


def _run(code_or_args, cwd):
    return subprocess.run([sys.executable, *code_or_args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every port module imports in a fresh process as on the card's
    machine, which has no jax, h5py, pandas or PyYAML (blocked here, with
    requests, which only the nova.astrometry.net client imports, and
    matplotlib, which only the plotting functions import when they plot),
    and none brings in jax or the JAX package."""
    code = (
        "import sys\n"
        "for name in ('h5py', 'pandas', 'yaml', 'requests', "
        "'matplotlib'):\n"
        "    sys.modules[name] = None\n"
        "import pkgutil, importlib, lightcurver_tpu_torch as p\n"
        "for mod in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(mod.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax'\n"
        "             or k.startswith(('jax.', 'lightcurver_tpu.'))\n"
        "             or k == 'lightcurver_tpu')\n"
        "print('n_modules', len([k for k in sys.modules\n"
        "      if k.startswith('lightcurver_tpu_torch')]))\n"
        "assert not bad, bad\n")
    proc = _run(["-c", code], REPO)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 85


def test_chip_smoke_fails_without_a_card(tmp_path):
    proc = _run([str(REPO / "chip_smoke.py")], REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    # alone, without the package beside it, it fails as well
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    proc = _run([str(lone)], tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
