"""Joint multi-epoch forward modelling of the ROI, on arrays.

:func:`fit_roi` is the numerical body of the JAX pipeline task
``lightcurver_tpu/processes/roi_modelling.py::do_modelling_of_roi``
(lines 206-464 there, plus the flux errors and per-frame reduced chi2 of
``get_fluxes_dataframe_from_model``): scale the data, take aperture fluxes
as the initial guess, fit translations and fluxes with L-BFGS (stage 1),
compute the starlet noise weights W, fit everything with AdaBelief under
the starlet-l1 regularization (stage 2), and polish the fluxes with the
exact GLS solve.

The task around it (HDF5 reads, the WCS, the SQLite frame query, the CSV,
FITS and HTML outputs, checkpointing) is not ported yet: a later change
wraps this body as ``do_modelling_of_roi``. So ``xs``/``ys`` arrive in
stamp pixel coordinates, as the task holds them after ``world_to_pixel``.

Numbers: fit times quoted for this function in PERF.md were taken on an
NVIDIA H100 and carry the card's name and power limit; no TPU figure
applies here.
"""

import logging

import numpy as np
import torch

from ..core.deconv.loss import Loss, Prior
from ..core.deconv.model import setup_model
from ..core.fisher import get_flux_uncertainties, linear_flux_solve
from ..core.noise import propagate_noise
from ..core.optimize import Optimizer, warn_if_unconverged
from ..core.params import Params, kwargs_to_numpy
from ..ops import enforce_fp32

# The ROI section of the shipped config
# (lightcurver_tpu/pipeline/example_config_file/config.yaml).
ROI_CONFIG = {
    "fix_point_source_astrometry": False,
    "starting_background": None,
    "further_optimize_background": True,
    "roi_model_regularization": {
        "regularization_strength_scales": 1.0,
        "regularization_strength_hf": 1.0,
        "regularization_strength_positivity": 100.0,
        "regularization_strength_pts_source": 0.01,
        "regularization_scatter_fluxes_pre_optim": 1.0,
        "regularization_scatter_fluxes_main_optim": 0.0,
    },
    "roi_deconv_translations_iters": 300,
    "roi_deconv_all_iters": 2000,
}

NOISE_SAMPLES = 500
NOISE_SEED = 1


def circular_aperture_photometry(image, positions, radius):
    """Sum of the pixels whose centres lie within ``radius`` of each (x, y)."""
    yy, xx = np.mgrid[0:image.shape[0], 0:image.shape[1]]
    out = []
    for x, y in positions:
        sel = (xx - x) ** 2 + (yy - y) ** 2 <= radius**2
        out.append(float(np.nansum(image[sel])))
    return out


def _copy_tree(tree):
    return {k: _copy_tree(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def fit_roi(data, noisemap, psf, xs, ys, subsampling_factor, seeings,
            pixel_scale, angles_to_north, config, *, device="cuda",
            noise_weights=None, irfft_backend="fft"):
    """Jointly model all ROI epochs; returns fluxes, errors and diagnostics.

    Args:
        data, noisemap: (N, n, n) stamps and their noise sigmas.
        psf: (N, mp, mp) narrow PSFs on the fine grid.
        xs, ys: (M,) source positions in stamp pixel coordinates.
        subsampling_factor: s.
        seeings: (N,) seeing per frame in arcsec (NaN or <= 0: unknown).
        pixel_scale: arcsec per pixel (scalar, or per frame: NaN-median).
        angles_to_north: (N,) frame rotations in degrees.
        config: dict with the keys of :data:`ROI_CONFIG`;
            ``starting_background``, when not None, is an array of the
            fine-grid size in the data's units.
        device: torch device of the fit: the card unless the caller asks
            for ``"cpu"``; there is no fallback.
        noise_weights: optional (J + 1, m, m) starlet weights W on the
            scaled data; computed from the noise when None.
        irfft_backend: the render of both fit stages and of the noise
            weights. "fft" (the default, JAX's default too) renders through
            cuFFT; "matmul" is the port's name for JAX's "mxu", the backend
            the JAX package selects on its accelerator: the all-real
            matmul-DFT render, whose kernel K2 runs every loss evaluation
            on the card. The GLS polish, the errors and the final chi2
            render through cuFFT either way, as the JAX task does.

    Returns:
        dict with
        ``fluxes``, ``flux_errors``: (N, M) in the data's units (errors
        are the Fisher photon term; the task adds the normalization
        error), ``reduced_chi2``: (N,), ``residuals``: (N, n, n) in the
        data's units, ``kwargs``: the best-fit parameters on the scaled
        data (numpy), ``scale``, ``W`` and the loss histories
        ``loss_history_stage1`` / ``loss_history_stage2``.
    """
    enforce_fp32()
    logger = logging.getLogger("lightcurver.roi_modelling")
    data = np.array(data, dtype=np.float32)
    noisemap = np.array(noisemap, dtype=np.float32)
    scale = float(np.nanmax(data))
    if not np.isfinite(scale) or scale <= 0:
        # an all-NaN or non-positive stack: dividing would NaN or
        # sign-flip everything
        scale = 1.0
    data /= scale
    noisemap /= scale
    s = int(subsampling_factor)
    n_epochs, im_size_y, im_size_x = data.shape
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)

    # flux initial guess: aperture sums on the median stack; NaN or
    # non-positive seeings (unknown) are left out of the mean
    pixel_scale = float(np.nanmedian(pixel_scale))
    stack = np.nanmedian(data, axis=0)
    good_seeing = np.asarray(seeings, dtype=float)
    good_seeing = good_seeing[np.isfinite(good_seeing) & (good_seeing > 0)]
    mean_seeing = float(good_seeing.mean()) if good_seeing.size \
        else 3.0 * pixel_scale
    radius = 0.66 * mean_seeing / pixel_scale
    aperture_fluxes = circular_aperture_photometry(
        stack, list(zip(xs, ys)), radius)

    offset_x = (im_size_x - 1) / 2.0
    offset_y = (im_size_y - 1) / 2.0
    initial_c_x = xs - offset_x
    initial_c_y = ys - offset_y
    initial_a = np.tile(np.array(aperture_fluxes, dtype=np.float32),
                        n_epochs)
    model, kwargs_init, kwargs_up, kwargs_down, _ = setup_model(
        data, noisemap**2, psf, initial_c_x, initial_c_y, s, initial_a,
        device=device)

    def t(x):
        return torch.tensor(np.asarray(x, dtype=np.float32), device=device)

    angles = np.asarray(angles_to_north, dtype=np.float64)
    kwargs_init["kwargs_analytic"]["alpha"] = t(angles - angles[0])

    fix_astrometry = config["fix_point_source_astrometry"]
    prior = None
    if isinstance(fix_astrometry, float):
        sig = np.full(len(initial_c_x), fix_astrometry)
        prior = Prior(prior_analytic=[["c_x", initial_c_x, sig],
                                      ["c_y", initial_c_y, sig]])
    if config.get("starting_background") is not None:
        kwargs_init["kwargs_background"]["h"] = t(
            np.asarray(config["starting_background"]).ravel() / scale)
    reg = config.get("roi_model_regularization") or {}

    data_t, noise_t = t(data), t(noisemap)
    var_t = noise_t**2

    def run_fit(kwargs_start, kwargs_fixed, method, n_iter, loss_kwargs,
                lr, schedule):
        params = Params(kwargs_start, kwargs_fixed, kwargs_up, kwargs_down)
        loss = Loss(data_t, model, params, var_t,
                    irfft_backend=irfft_backend, **loss_kwargs)
        optim = Optimizer(loss, params, method=method)
        optim.minimize(n_iter, init_learning_rate=lr,
                       schedule_learning_rate=schedule)
        return params.best_fit_values(as_kwargs=True), optim

    # ---- stage 1: only dx, dy and fluxes free -------------------------
    kwargs_fixed_1 = _copy_tree(kwargs_init)
    for key in ("dx", "dy", "a"):
        del kwargs_fixed_1["kwargs_analytic"][key]
    kwargs_partial1, optim1 = run_fit(
        kwargs_init, kwargs_fixed_1, "l-bfgs-b",
        config["roi_deconv_translations_iters"],
        dict(prior=prior,
             regularization_strength_flux_uniformity=reg.get(
                 "regularization_scatter_fluxes_pre_optim", 10.0)),
        lr=1e-3, schedule=True)

    # ---- stage 2: everything relevant free -----------------------------
    kwargs_fixed_2 = _copy_tree(kwargs_partial1)
    if config["further_optimize_background"]:
        del kwargs_fixed_2["kwargs_background"]["h"]
    del kwargs_fixed_2["kwargs_background"]["mean"]
    for key in ("a", "c_x", "c_y", "dx", "dy"):
        del kwargs_fixed_2["kwargs_analytic"][key]
    if isinstance(fix_astrometry, bool) and fix_astrometry:
        kwargs_fixed_2["kwargs_analytic"]["c_x"] = t(initial_c_x)
        kwargs_fixed_2["kwargs_analytic"]["c_y"] = t(initial_c_y)

    W = t(noise_weights) if noise_weights is not None else propagate_noise(
        model, noise_t, num_samples=NOISE_SAMPLES, seed=NOISE_SEED,
        irfft_backend=irfft_backend)
    kwargs_final, optim2 = run_fit(
        kwargs_partial1, kwargs_fixed_2, "adabelief",
        config["roi_deconv_all_iters"],
        dict(regularization_terms="l1_starlet",
             regularization_strength_scales=reg.get(
                 "regularization_strength_scales", 1.0),
             regularization_strength_hf=reg.get(
                 "regularization_strength_hf", 1.0),
             regularization_strength_positivity=reg.get(
                 "regularization_strength_positivity", 100.0),
             regularization_strength_pts_source=reg.get(
                 "regularization_strength_pts_source", 0.01),
             regularization_strength_flux_uniformity=reg.get(
                 "regularization_scatter_fluxes_main_optim", 10.0),
             W=W, prior=prior),
        lr=1e-4, schedule=False)

    # ---- exact GLS flux polish, errors, per-frame chi2 -----------------
    with torch.no_grad():
        kwargs_final = linear_flux_solve(kwargs_final, data_t, var_t, model)
        n_sources = model.n_sources
        fluxes = kwargs_final["kwargs_analytic"]["a"].reshape(
            n_epochs, n_sources) * scale
        errors = get_flux_uncertainties(kwargs_final, noise_t, model) \
            .reshape(n_epochs, n_sources) * scale
        residuals = data_t - model.model(kwargs_final)
        chi2 = torch.nansum(residuals**2 / noise_t**2, dim=(1, 2)) \
            / model.image_size**2
    warn_if_unconverged(optim2.loss_history, logger, "ROI stage-2 joint fit",
                        "roi_deconv_all_iters")
    return {
        "fluxes": fluxes.cpu().numpy(),
        "flux_errors": errors.cpu().numpy(),
        "reduced_chi2": chi2.cpu().numpy(),
        "residuals": (residuals * scale).cpu().numpy(),
        "kwargs": kwargs_to_numpy(kwargs_final),
        "scale": scale,
        "W": W.cpu().numpy(),
        "loss_history_stage1": optim1.loss_history,
        "loss_history_stage2": optim2.loss_history,
    }
