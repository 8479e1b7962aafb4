"""Joint multi-epoch forward modelling of the ROI: the pipeline task and
its array body.

:func:`do_modelling_of_roi` is the port of the JAX pipeline task
``lightcurver_tpu/processes/roi_modelling.py::do_modelling_of_roi``: it
reads the prepared-ROI HDF5 and the config, fits, and writes the same
products under the same names (per-epoch and per-night photometry CSVs,
the astrometry JSON, the diagnostic FITS stacks, the high-resolution
model and the background). :func:`fit_roi` is its numerical body, on
arrays (lines 206-464 there, plus the flux errors and per-frame reduced
chi2 of ``get_fluxes_dataframe_from_model``): scale the data, take
aperture fluxes as the initial guess, fit translations and fluxes with
L-BFGS (stage 1), compute the starlet noise weights W, fit everything
with AdaBelief under the starlet-l1 regularization (stage 2, optionally
checkpointed mid-fit and resumable), and polish the fluxes with the exact
GLS solve. ``xs``/``ys`` arrive in stamp pixel coordinates, as the task
holds them after ``world_to_pixel``.

The task also writes the per-night HTML light curve beside the CSVs and
the diagnostic JPEG under ``plots/pixel_modelling/``, as JAX's does.
Under several ranks (``torchrun``; ``parallel/``) :func:`fit_roi` shards
its two fit stages over an epoch mesh, as the JAX task does over its
devices (:func:`_maybe_epoch_mesh`). h5py, pandas and matplotlib are
imported by the task and the plotting package, so the module imports on a
machine without them.

Numbers: fit times quoted for this module in PERF.md were taken on an
NVIDIA H100 and carry the card's name and power limit; no TPU figure
applies here.
"""

import json
import logging
from copy import deepcopy
from datetime import datetime
from pathlib import Path

import numpy as np
import torch
from scipy.ndimage import rotate, shift

from ..core.deconv.loss import Loss, Prior
from ..core.deconv.model import DeconvModel, setup_model
from ..core.fisher import get_flux_uncertainties, linear_flux_solve
from ..core.noise import propagate_noise
from ..core.optimize import (Optimizer, arrays_digest,
                             relative_loss_differential,
                             warn_if_unconverged)
from ..core.params import Params, kwargs_from_numpy, kwargs_to_numpy
from ..io.fits import Header, read_fits, write_fits
from ..io.wcs import TanWCS, upsampled_wcs
from ..ops import enforce_fp32
from ..parallel.batch import CheckpointShare
from ..parallel.deconv import (epoch_range, pad_epoch_kwargs,
                               pad_epoch_stacks, strip_epoch_kwargs)
from ..parallel.distributed import is_writer
from ..parallel.mesh import (EPOCH_AXIS, axis_size, epoch_mesh,
                             resolve_mesh, world_size)
from ..structure.database import get_pandas
from ..structure.user_config import get_user_config
from ..utilities.checkpoints import run_discarding_stale_checkpoint
from ..utilities.footprint import get_combined_footprint_hash
from ..utilities.lightcurves_postprocessing import (
    convert_flux_to_magnitude, group_observations)
from ..utilities.tracing import span

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


def _maybe_epoch_mesh():
    """An epoch mesh over every rank whenever there is more than one.

    Any epoch count shards: non-divisible counts are padded with exactly
    masked dummy epochs (``parallel/deconv.pad_epoch_stacks``), never
    dropped to a single device.
    """
    return epoch_mesh() if world_size() > 1 else None


def fit_roi(data, noisemap, psf, xs, ys, subsampling_factor, seeings,
            pixel_scale, angles_to_north, config, *, device="cuda",
            noise_weights=None, irfft_backend="fft", checkpoint_path=None,
            checkpoint_every=500, checkpoint_inputs_digest=None,
            mesh="auto"):
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
        checkpoint_path, checkpoint_every, checkpoint_inputs_digest: with
            a path, stage 2 runs in ``checkpoint_every``-iteration
            segments and writes its carry there after each; a call that
            finds the file resumes stage 2 from it, a file that does not
            match this fit (budget, carry, or the digest, see
            :func:`roi_checkpoint_digest`) is discarded and stage 2 starts
            again, and the file is deleted when the fit succeeds.
        mesh: "auto" (the default) shards the two fit stages over an
            epoch mesh of every rank when ``torch.distributed`` has more
            than one (:func:`_maybe_epoch_mesh`), else fits unsharded;
            None forces the unsharded fit; or a mesh with an ``epoch``
            axis (``parallel.mesh.epoch_mesh``). On a mesh every rank
            holds every parameter, computes the chi2 of its epochs
            (padded to a multiple of the ranks with masked dummy epochs)
            and the loss and gradient are all-reduced; above one rank
            the render is "matmul". W is computed on rank 0 and
            broadcast; the GLS polish, errors and chi2 run on the full
            tree on every rank, which all return the same result. Under
            a mesh with ``checkpoint_path``, rank 0 writes and every rank
            reads the one file. On the card each stage replays its
            optimizer step as a CUDA graph (``core/optimize.py``),
            unsharded or under a mesh over NCCL, whose all-reduce the
            graph holds; under gloo, which all-reduces through the host,
            the steps run eagerly (``parallel.distributed.capturable``).

    Returns:
        dict with
        ``fluxes``, ``flux_errors``: (N, M) in the data's units (errors
        are the Fisher photon term; the task adds the normalization
        error), ``reduced_chi2``: (N,), ``residuals``: (N, n, n) in the
        data's units, ``kwargs``: the best-fit parameters on the scaled
        data (numpy), ``model``: the ``DeconvModel`` (on ``device``) that
        renders them, ``scale``, ``W`` and the loss histories
        ``loss_history_stage1`` / ``loss_history_stage2``.
    """
    with span("roi.fit", epochs=len(data)):
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
        n_sources = model.n_sources

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

        mesh = resolve_mesh(mesh, _maybe_epoch_mesh)
        n_pad, group, share = 0, None, None
        sharded = {}
        model_fit, data_fit, var_fit = model, data_t, var_t
        if mesh is not None:
            if tuple(mesh.mesh_dim_names or ()) != (EPOCH_AXIS,):
                raise ValueError(f"fit_roi shards epochs over a 1-D "
                                 f"'{EPOCH_AXIS}' mesh, not "
                                 f"{mesh.mesh_dim_names}")
            n_shards = axis_size(mesh, EPOCH_AXIS)
            group, share = mesh.get_group(EPOCH_AXIS), CheckpointShare(mesh)
            if mesh.size() > 1:
                irfft_backend = "matmul"
            data_p, var_p, psf_p, epoch_w = pad_epoch_stacks(
                data, noisemap**2, np.asarray(psf, dtype=np.float32), n_shards)
            n_pad = data_p.shape[0] - n_epochs
            if n_pad:
                model_fit = DeconvModel(t(psf_p), s, im_size_x,
                                        n_epochs + n_pad, n_sources)
                data_fit, var_fit = t(data_p), t(var_p)
            sharded = dict(epoch_weights=epoch_w, group=group,
                           epochs=epoch_range(mesh, n_epochs + n_pad))
            logger.info(f"Epoch-sharding the joint fit over {n_shards} "
                        f"devices ({n_pad} zero-weight padding epochs).")

        def padded(tree, fn, *counts):
            if not n_pad:
                return tree
            return kwargs_from_numpy(fn(kwargs_to_numpy(tree), *counts,
                                        n_sources), device)

        def run_fit(kwargs_start, kwargs_fixed, method, n_iter, loss_kwargs,
                    lr, schedule, checkpoint=None):
            params = Params(
                padded(kwargs_start, pad_epoch_kwargs, n_epochs, n_pad),
                padded(kwargs_fixed, pad_epoch_kwargs, n_epochs, n_pad),
                kwargs_up, kwargs_down)
            loss = Loss(data_fit, model_fit, params, var_fit,
                        irfft_backend=irfft_backend, **sharded, **loss_kwargs)
            optim = Optimizer(loss, params, method=method)
            optim.minimize(n_iter, init_learning_rate=lr,
                           schedule_learning_rate=schedule,
                           checkpoint_path=checkpoint,
                           checkpoint_every=checkpoint_every,
                           checkpoint_inputs_digest=checkpoint_inputs_digest,
                           checkpoint_share=share)
            return padded(params.best_fit_values(as_kwargs=True),
                          strip_epoch_kwargs, n_epochs, n_pad), optim

        # ---- stage 1: only dx, dy and fluxes free -------------------------
        kwargs_fixed_1 = _copy_tree(kwargs_init)
        for key in ("dx", "dy", "a"):
            del kwargs_fixed_1["kwargs_analytic"][key]
        with span("roi.stage1"):
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

        with span("roi.noise_weights"):
            W = t(noise_weights) if noise_weights is not None \
                else propagate_noise(
                    model, noise_t, None, num_samples=NOISE_SAMPLES,
                    seed=NOISE_SEED, irfft_backend=irfft_backend,
                    group=group)[0]

        def run_stage2():
            return run_fit(
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
                lr=1e-4, schedule=False, checkpoint=checkpoint_path)

        # a refused resume (changed inputs or budget under the same name)
        # discards the file; on success it is deleted, so a stale file never
        # replays a finished fit
        with span("roi.stage2"):
            kwargs_final, optim2 = run_discarding_stale_checkpoint(
                run_stage2, checkpoint_path, logger)
        if checkpoint_path is not None:
            Path(checkpoint_path).unlink(missing_ok=True)

        # ---- exact GLS flux polish, errors, per-frame chi2 -------------
        with span("roi.polish"), torch.no_grad():
            kwargs_final = linear_flux_solve(kwargs_final, data_t, var_t,
                                             model)
            fluxes = kwargs_final["kwargs_analytic"]["a"].reshape(
                n_epochs, n_sources) * scale
            errors = get_flux_uncertainties(
                kwargs_final, None, None, None, noise_t, model).reshape(
                    n_epochs, n_sources) * np.float32(scale)
            residuals = data_t - model.model(kwargs_final)
            chi2 = torch.nansum(residuals**2 / noise_t**2, dim=(1, 2)) \
                / model.image_size**2
            results = {
                "fluxes": fluxes.cpu().numpy(),
                "flux_errors": errors,
                "reduced_chi2": chi2.cpu().numpy(),
                "residuals": (residuals * scale).cpu().numpy(),
                "kwargs": kwargs_to_numpy(kwargs_final),
                "model": model,
                "scale": scale,
                "W": W.cpu().numpy(),
                "loss_history_stage1": optim1.loss_history,
                "loss_history_stage2": optim2.loss_history,
            }
        warn_if_unconverged(optim2.loss_history, logger,
                            "ROI stage-2 joint fit", "roi_deconv_all_iters")
        return results


def stage2_checkpoint_digest(user_config, reg, fix_astrometry, data,
                             noisemap, psf, initial_c_x, initial_c_y,
                             starting_h=None, alpha=None):
    """Identity of everything the resumable stage-2 objective depends on.

    Beyond the input arrays, the digest folds in the loss configuration:
    the regularization scalars, the astrometry handling (fixed, free or a
    Gaussian prior's sigma) with the positions it pins, whether the
    background is free, the starting background and the fixed per-epoch
    rotations. A resumed AdaBelief carry is only a valid continuation of
    the objective it was optimizing: resuming under another
    ``regularization_strength_scales`` or ``starting_background`` would
    blend two fits. (The optimizer checks the budget and the carry's
    structure itself.)
    """
    loss_config = json.dumps(
        {"reg": reg,
         "fix_astrometry": fix_astrometry,
         "further_optimize_background":
             bool(user_config["further_optimize_background"])},
        sort_keys=True, default=float)
    return arrays_digest(
        np.frombuffer(loss_config.encode("utf-8"), dtype=np.uint8),
        data, noisemap, psf,
        np.asarray(initial_c_x, dtype=np.float64),
        np.asarray(initial_c_y, dtype=np.float64),
        np.zeros(0) if starting_h is None
        else np.asarray(starting_h, dtype=np.float64),
        np.zeros(0) if alpha is None
        else np.asarray(alpha, dtype=np.float64))


def roi_checkpoint_digest(data, noisemap, psf, xs, ys, angles_to_north,
                          config):
    """:func:`stage2_checkpoint_digest` of a :func:`fit_roi` call with
    these arguments: the inputs as ``fit_roi`` takes them (unscaled data,
    stamp-pixel positions, absolute angles), which determine the scaled
    ones the JAX task digests."""
    data = np.asarray(data, dtype=np.float32)
    n_y, n_x = data.shape[-2:]
    angles = np.asarray(angles_to_north, dtype=np.float64)
    return stage2_checkpoint_digest(
        config, config.get("roi_model_regularization") or {},
        config["fix_point_source_astrometry"], data,
        np.asarray(noisemap, dtype=np.float32),
        np.asarray(psf, dtype=np.float32),
        np.asarray(xs, dtype=np.float64) - (n_x - 1) / 2.0,
        np.asarray(ys, dtype=np.float64) - (n_y - 1) / 2.0,
        starting_h=config.get("starting_background"),
        alpha=angles - angles[0])


def align_data_interpolation(array, kwargs):
    """De-rotate and de-translate epochs by the fitted dx, dy and alpha.

    Interpolation-based: diagnostic use only (the model itself never
    interpolates).
    """
    ka = kwargs["kwargs_analytic"]
    dx, dy = np.asarray(ka["dx"]), np.asarray(ka["dy"])
    alpha = np.asarray(ka["alpha"])
    return np.array([
        rotate(shift(a, (-ddy, -ddx)), alph, reshape=False)
        for a, ddx, ddy, alph in zip(array, dx, dy, alpha)])


def stack_epochs_sigma_clipped(data, noisemap, n_sigma=3):
    """Weighted average stack with per-pixel median sigma clipping:
    weights 1/noisemap; pixels beyond n_sigma sample-stds from the
    per-pixel median are excluded."""
    data = np.asarray(data, dtype=float)
    weights = 1.0 / np.asarray(noisemap, dtype=float)
    median = np.nanmedian(data, axis=0)
    std = np.nanstd(data, axis=0)
    keep = np.abs(data - median) <= n_sigma * std
    w = np.where(keep, weights, 0.0)
    denominator = w.sum(axis=0)
    denominator[denominator == 0] = np.nan
    return (w * np.nan_to_num(data)).sum(axis=0) / denominator


def _render(model, kwargs):
    """The model's data stamps for numpy ``kwargs``, as numpy."""
    with torch.no_grad():
        return model.model(kwargs_from_numpy(kwargs, model.device)) \
            .cpu().numpy()


def stack_data_diagnostic(data, noisemap, kwargs, model):
    """Stacks of the data, data-minus-point-sources, data-minus-background
    (``kwargs``: numpy, on the scaled data; ``model``: the fit's
    ``DeconvModel``)."""
    kwargs_only_ps = deepcopy(kwargs)
    kwargs_only_ps["kwargs_background"]["h"] = \
        0.0 * kwargs_only_ps["kwargs_background"]["h"]
    kwargs_no_ps = deepcopy(kwargs)
    kwargs_no_ps["kwargs_analytic"]["a"] = \
        0.0 * kwargs_no_ps["kwargs_analytic"]["a"]

    data_no_ps = data - _render(model, kwargs_only_ps)
    data_no_background = data - _render(model, kwargs_no_ps)
    return {
        "stack": stack_epochs_sigma_clipped(
            align_data_interpolation(data, kwargs), noisemap),
        "stack_no_ps": stack_epochs_sigma_clipped(
            align_data_interpolation(data_no_ps, kwargs_only_ps), noisemap),
        "stack_no_background": stack_epochs_sigma_clipped(
            align_data_interpolation(data_no_background, kwargs_no_ps),
            noisemap),
    }


def get_fluxes_dataframe_from_model(fit, point_sources_names,
                                    normalization_errors, frame_ids, mjds,
                                    seeings, zeropoint,
                                    sky_level_electron_per_second):
    """Light curves, uncertainties and chi2 per frame from a
    :func:`fit_roi` result.

    Returns (per-epoch mags DataFrame, per-night mags DataFrame). Flux
    uncertainties compound the Fisher photon term with the per-frame
    normalization error.
    """
    import pandas as pd

    curves, d_curves = {}, {}
    for i, ps in enumerate(point_sources_names):
        curve = fit["fluxes"][:, i]
        norm = normalization_errors * curve
        curves[ps] = curve
        d_curves[ps] = np.sqrt(fit["flux_errors"][:, i]**2 + norm**2)

    rows = []
    for epoch in range(len(frame_ids)):
        row = {
            "frame_id": frame_ids[epoch],
            "mjd": mjds[epoch],
            "zeropoint": float(np.atleast_1d(zeropoint)[0]),
            "reduced_chi2": fit["reduced_chi2"][epoch],
            "seeing": seeings[epoch],
            "sky_level_electron_per_second":
                sky_level_electron_per_second[epoch],
        }
        for ps in point_sources_names:
            row[f"{ps}_flux"] = curves[ps][epoch]
            row[f"{ps}_d_flux"] = d_curves[ps][epoch]
        rows.append(row)
    df_per_epoch = pd.DataFrame(rows).set_index("frame_id")
    df_per_night = group_observations(df_per_epoch)
    return (convert_flux_to_magnitude(df_per_epoch),
            convert_flux_to_magnitude(df_per_night))


def do_modelling_of_roi(*, device="cuda", irfft_backend="fft"):
    """Pipeline task: the joint ROI model. Optional (do_ROI_model).

    Reads the configuration (``LIGHTCURVER_CONFIG``) and the prepared-ROI
    HDF5, fits with :func:`fit_roi` on ``device`` (the card unless the
    caller asks for ``"cpu"``; no fallback) and ``irfft_backend``, and
    writes the JAX task's products, named by the footprint hash, beside
    the HDF5. ``deconv_checkpoint_every > 0`` checkpoints stage 2 under
    ``checkpoints_dir``. Under several ranks every rank reads the HDF5 and
    fits (its share of the epochs), and rank 0 alone writes the products
    (:func:`fit_then_write`) and the checkpoints.
    """
    import h5py

    logger = logging.getLogger("lightcurver.roi_modelling")
    user_config = get_user_config()
    if not user_config["do_ROI_model"]:
        return

    frames_ini = get_pandas(
        columns=["id"],
        conditions=["plate_solved = 1", "eliminated = 0",
                    "roi_in_footprint = 1"])
    footprint_hash = get_combined_footprint_hash(
        user_config, frames_ini["id"].to_list())
    roi = user_config["roi_name"]
    roi_cutouts_file = user_config["prepared_roi_cutouts_path"]
    if roi_cutouts_file is None:
        roi_cutouts_file = (user_config["workdir"] / "prepared_roi_cutouts"
                            / f"cutouts_{footprint_hash}_{roi}.h5")

    with h5py.File(roi_cutouts_file, "r") as f:
        data = np.array(f["data"])
        noisemap = np.array(f["noisemap"])
        psf = np.array(f["psf"])
        seeings = np.array(f["seeing"])
        mjds = np.array(f["mjd"])
        zeropoint = np.array(f["global_zeropoint"])
        norm_errs = np.array(f["relative_normalization_error"])
        frame_ids = np.array(f["frame_id"])
        subsampling_factor = np.array(f["subsampling_factor"])
        pixel_scales = np.array(f["pixel_scale"])
        angles_to_north = np.array(f["angle_to_north"])
        wcs_strings = np.array(f["wcs"])
        sky_levels = np.array(f["sky_level_electron_per_second"])

    unique_sub = np.unique(subsampling_factor)
    if unique_sub.size != 1:
        message = ("The PSF models seem to have different subsampling "
                   "factors! Incompatible with joint modelling.")
        logger.error(message)
        raise RuntimeError(message)
    subsampling_factor = int(unique_sub[0])
    n_epochs, im_size_y, im_size_x = data.shape

    ps_coords = user_config["point_sources"]
    ordered_ps = sorted(ps_coords.keys())
    logger.info(f"Jointly modelling {n_epochs} ROI cutouts with "
                f"{len(ordered_ps)} point sources.")

    # reference frame: frame 0
    wcs_raw = wcs_strings[0]
    if isinstance(wcs_raw, bytes):
        wcs_raw = wcs_raw.decode("utf-8")
    wcs_ref = TanWCS.from_header(json.loads(wcs_raw))
    xs, ys = [], []
    for ps in ordered_ps:
        x, y = wcs_ref.world_to_pixel(*ps_coords[ps])
        xs.append(float(x))
        ys.append(float(y))
    xs, ys = np.array(xs), np.array(ys)

    fix_astrometry = user_config["fix_point_source_astrometry"]
    if isinstance(fix_astrometry, bool) and fix_astrometry:
        logger.info("Fully fixing the astrometry to config values.")
    elif isinstance(fix_astrometry, float):
        logger.info(f"Gaussian astrometric prior, sigma = "
                    f"{fix_astrometry:.02f} px.")

    # optional starting background, in the data's units
    starting_background = None
    if user_config["starting_background"] is not None:
        bck_path = Path(user_config["starting_background"])
        if not bck_path.is_absolute():
            bck_path = user_config["workdir"] / bck_path
        if bck_path.name.lower().endswith((".fits", ".fit",
                                           ".fits.gz", ".fits.fz")):
            bck, _ = read_fits(bck_path)
        else:
            bck = np.load(bck_path)
        starting_background = np.asarray(bck, dtype=np.float32).ravel()
    config = {**user_config, "starting_background": starting_background}

    if not (user_config.get("roi_model_regularization", {}) or {}):
        logger.warning("No background regularization params in config: "
                       "using defaults.")

    # mid-fit checkpointing of stage 2, keyed by the footprint hash and
    # opt-in via deconv_checkpoint_every; fit_roi deletes the file on
    # success
    checkpoint_every = int(user_config["deconv_checkpoint_every"] or 0)
    checkpoint_path = checkpoint_digest = None
    if checkpoint_every > 0:
        if is_writer():
            user_config["checkpoints_dir"].mkdir(exist_ok=True, parents=True)
        checkpoint_path = (user_config["checkpoints_dir"]
                           / f"roi_{footprint_hash}_{roi}_stage2.ckpt")
        checkpoint_digest = roi_checkpoint_digest(
            data, noisemap, psf, xs, ys, angles_to_north, config)

    def write_products(fit):
        scale, model, kwargs = fit["scale"], fit["model"], fit["kwargs"]

        out_dir = roi_cutouts_file.parent
        ka = kwargs["kwargs_analytic"]
        x_pixels = ka["c_x"] + float(ka["dx"][0]) + (im_size_x - 1) / 2.0
        y_pixels = ka["c_y"] + float(ka["dy"][0]) + (im_size_y - 1) / 2.0
        ra_post, dec_post = wcs_ref.pixel_to_world(x_pixels, y_pixels)
        astrometry = {ps: [float(r), float(d)]
                      for ps, r, d in zip(ordered_ps, np.atleast_1d(ra_post),
                                          np.atleast_1d(dec_post))}
        with open(out_dir / f"{footprint_hash}_{roi}_astrometry.json",
                  "w") as ff:
            json.dump(astrometry, ff)

        per_epoch, per_night = get_fluxes_dataframe_from_model(
            fit, ordered_ps, norm_errs, frame_ids, mjds, seeings, zeropoint,
            sky_levels)
        per_epoch.to_csv(
            out_dir / f"{footprint_hash}_{roi}_photometry_per_epoch.csv")
        per_night.to_csv(
            out_dir / f"{footprint_hash}_{roi}_photometry_per_night.csv")
        try:
            from ..plotting.html_visualisation import generate_lightcurve_html

            generate_lightcurve_html(
                per_night,
                out_dir / f"{footprint_hash}_{roi}_photometry_per_night.html")
        except Exception as e:
            logger.warning(f"HTML light-curve export failed: {e}")

        # diagnostic stacks, on the scaled data as the fit saw it
        data_scaled = np.asarray(data, dtype=np.float32) / scale
        noise_scaled = np.asarray(noisemap, dtype=np.float32) / scale
        stacks = stack_data_diagnostic(data_scaled, noise_scaled, kwargs,
                                       model)
        ref_header = Header()
        ref_header.update(wcs_ref.to_header_cards())
        for stack_type, stacked in stacks.items():
            write_fits(out_dir / f"{footprint_hash}_{roi}_{stack_type}.fits",
                       scale * stacked, ref_header)

        with torch.no_grad():
            high_res, background_only = model.getDeconvolved(
                kwargs_from_numpy(kwargs, model.device), 0)
        # exact fine-grid alignment, the (s-1)/2 pool-centre offset included
        wcs_highres = upsampled_wcs(wcs_ref, subsampling_factor)
        header_highres = Header()
        header_highres.update(wcs_highres.to_header_cards())
        zpt = float(np.atleast_1d(zeropoint)[0])
        if np.isfinite(zpt):
            header_highres["ZPT"] = zpt
        else:
            # FITS has no NaN card value
            header_highres["COMMENT"] = "ZPT unavailable (no zeropoint)"
        write_fits(out_dir / f"{footprint_hash}_{roi}_high_res_model.fits",
                   scale * high_res.cpu().numpy(), header_highres)
        write_fits(out_dir / f"{footprint_hash}_{roi}_background.fits",
                   scale * background_only.cpu().numpy(), header_highres)

        try:
            from ..plotting.joint_modelling_plotting import \
                plot_joint_modelling_diagnostic

            plot_dir = (user_config["plots_dir"] / "pixel_modelling"
                        / str(footprint_hash))
            plot_dir.mkdir(exist_ok=True, parents=True)
            time_now = datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
            plot_file = (plot_dir
                         / f"{time_now}_joint_modelling_roi_{roi}.jpg")
            plot_joint_modelling_diagnostic(
                datas=data_scaled, noisemaps=noise_scaled,
                residuals=fit["residuals"] / scale,
                chi2_per_frame=np.array(per_epoch["reduced_chi2"]),
                loss_curve=fit["loss_history_stage2"], save_path=plot_file,
                starlet_background=background_only.cpu().numpy())
        except Exception as e:
            logger.warning(f"ROI modelling plot failed: {e}")

        rld = relative_loss_differential(fit["loss_history_stage2"])
        logger.info("Finished modelling the ROI. Global reduced chi2: "
                    f"{float(np.mean(per_epoch['reduced_chi2'])):.02f} "
                    f"(loss plateau metric {rld:.4f}).")

    fit_then_write(
        lambda: fit_roi(data, noisemap, psf, xs, ys, subsampling_factor,
                        seeings, pixel_scales, angles_to_north, config,
                        device=device, irfft_backend=irfft_backend,
                        checkpoint_path=checkpoint_path,
                        checkpoint_every=checkpoint_every or 500,
                        checkpoint_inputs_digest=checkpoint_digest),
        write_products)


def fit_then_write(fit, write):
    """The ROI task's rank rule: every rank runs ``fit()`` (under several
    ranks, :func:`fit_roi` over its share of the epochs) and rank 0 alone,
    or a world of one, passes the result to ``write`` (the products).
    Returns the fit."""
    result = fit()
    if is_writer():
        write(result)
    return result
