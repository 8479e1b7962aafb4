"""Joint multi-epoch PSF photometry of the reference stars: the port of the
JAX pipeline task ``lightcurver_tpu/processes/star_photometry.py::
do_star_photometry``.

Each star's epochs (the frames whose current PSF passed the chi2 gate)
are modelled jointly: one point source at the stamp centre, a free flux
per epoch, optionally a constant per epoch and a starlet-regularised
pixel background per star. The stars are fitted in buckets of
``star_fit_batch_size`` through ``core/deconv/batched.py::
fit_stars_batched``, and the fluxes go to the ``star_flux_in_frame``
table as the JAX task writes them.

Each star's diagnostic plot goes to ``plots/star_modelling/<footprint
hash>/<time>_joint_modelling_star_<name>.jpg``, as JAX's task writes it.

:func:`do_one_star_forward_modelling` is the reference's single-star
fit (JAX's ``do_one_star_forward_modelling``), which no task calls: one
star's epochs through ``setup_model``, ``Params``, ``Loss``,
``propagate_noise`` and ``Optimizer``, then the GLS flux polish and the
Fisher errors.
A negative ``star_fit_batch_size`` raises a ``ValueError`` here (the JAX
task fits nothing and reports success). h5py and pandas are imported by
the functions that use them, and matplotlib by the plotting package.
"""

import logging
from datetime import datetime
from time import time

import numpy as np
import torch

from ..core.deconv.loss import Loss
from ..core.deconv.model import setup_model
from ..core.fisher import get_flux_uncertainties, linear_flux_solve
from ..core.noise import propagate_noise
from ..core.optimize import Optimizer, warn_if_unconverged
from ..core.params import Params, kwargs_to_numpy
from ..core.psf.distortion import apply_distortion
from ..ops import enforce_fp32
from ..structure.database import (execute_sqlite_query, executemany_sqlite,
                                  get_pandas, select_stars,
                                  select_stars_for_a_frame)
from ..structure.user_config import get_user_config
from ..utilities.checkpoints import run_discarding_stale_checkpoint
from ..utilities.chi2_selector import get_chi2_bounds
from ..utilities.footprint import get_combined_footprint_hash
from ..utilities.image_coordinates import rescale_image_coordinates


SINGLE_STAR_NOISE_SAMPLES = 200


def do_one_star_forward_modelling(data, noisemap, psf, subsampling_factor,
                                  n_iter=2000,
                                  uniform_background_per_epoch=False,
                                  starlet_global_background=True, *,
                                  device="cuda", irfft_backend="fft"):
    """Joint forward modelling of the N epochs of one star.

    One point source starting at the stamp centre, free per-epoch fluxes
    and positions, optionally a constant per epoch and a starlet-penalised
    pixel background (weights from ``SINGLE_STAR_NOISE_SAMPLES`` noise
    draws); ``n_iter`` AdaBelief iterations from the start, then the exact
    GLS flux solve and the diagonal Fisher errors. ``data``, ``noisemap``
    (N, n, n), ``psf`` (N, mp, mp). Runs on ``device`` (the card unless
    the caller asks for "cpu"), rendering with ``irfft_backend`` ("fft" or
    "matmul"; with the background free, "matmul" runs K2 each way per loss
    evaluation, and the background's l1 runs K1 each way).

    Returns a dict: ``scale``, ``kwargs_final``, ``fluxes``,
    ``fluxes_uncertainties`` (data units, flat), ``chi2``,
    ``chi2_per_frame``, ``loss_curve``, ``residuals``,
    ``deconvolved_image`` and ``starlet_background``, as numpy.
    """
    enforce_fp32()
    data = np.array(data, dtype=np.float32)
    noisemap = np.array(noisemap, dtype=np.float32)
    scale = float(np.nanmax(data))
    if not np.isfinite(scale) or scale <= 0:
        scale = 1.0
    data /= scale
    noisemap /= scale
    # flux init (it expects the NaNs): the stamp sum minus the mean of the
    # four edges' NaN-medians per pixel
    borders = np.nanmean([
        np.nanmedian(data[:, :1, :], axis=(1, 2)),
        np.nanmedian(data[:, :, :1], axis=(1, 2)),
        np.nanmedian(data[:, -1:, :], axis=(1, 2)),
        np.nanmedian(data[:, :, -1:], axis=(1, 2)),
    ], axis=0)
    borders = np.nan_to_num(borders, nan=0.0)
    a_est = np.nansum(data, axis=(1, 2)) - data[0].size * borders
    # a NaN pixel reaching the loss would NaN every gradient: zero data,
    # inflated noise
    isnan = np.isnan(data) | np.isnan(noisemap)
    data[isnan] = 0.0
    noisemap[isnan] = 1e7
    sigma_2 = noisemap**2

    model, kwargs_init, kwargs_up, kwargs_down, _ = setup_model(
        data, sigma_2, psf, np.array([0.0]), np.array([0.0]),
        subsampling_factor, a_est, device=device)
    n_epochs, m = len(data), model.m
    # positions stay free (per-epoch miscentring is absorbed); rotation,
    # the background grid and the pedestal are fixed unless asked for
    kwargs_fixed = {
        "kwargs_analytic": {
            "alpha": kwargs_init["kwargs_analytic"]["alpha"]},
        "kwargs_background": {
            "h": torch.zeros(m * m, dtype=torch.float32, device=model.device),
            "mean": torch.zeros(n_epochs, dtype=torch.float32,
                                device=model.device)},
        "kwargs_sersic": {},
    }
    if uniform_background_per_epoch:
        del kwargs_fixed["kwargs_background"]["mean"]
    if starlet_global_background:
        del kwargs_fixed["kwargs_background"]["h"]
    parameters = Params(kwargs_init, kwargs_fixed, kwargs_up, kwargs_down)

    W = None
    if starlet_global_background:
        W = propagate_noise(
            model, noisemap, kwargs_init, wavelet_type_list=["starlet"],
            method="SLIT", num_samples=SINGLE_STAR_NOISE_SAMPLES, seed=1,
            likelihood_type="chi2", upsampling_factor=subsampling_factor,
            irfft_backend=irfft_backend)[0]
    loss = Loss(data, model, parameters, sigma_2,
                regularization_terms="l1_starlet",
                regularization_strength_scales=3.0,
                regularization_strength_hf=3.0,
                regularization_strength_flux_uniformity=0.0, W=W,
                irfft_backend=irfft_backend)
    optim = Optimizer(loss, parameters, method="adabelief")
    optim.minimize(max_iterations=n_iter, init_learning_rate=1e-3,
                   schedule_learning_rate=True, restart_from_init=True)

    # the finalize renders as the batched fit's: the pooled matmul DFT on
    # "matmul", cuFFT otherwise
    render = {"dft_mats": loss.consts["dft_mats"]} \
        if loss.consts is not None else None
    with torch.no_grad():
        kwargs_final = linear_flux_solve(
            parameters.best_fit_values(as_kwargs=True), loss.data,
            loss.sigma_2, model, render)
        residuals = loss.data - model.model(kwargs_final, None, render)
        chi2_per_frame = torch.nansum(residuals**2 / loss.sigma_2,
                                      dim=(1, 2)) / model.image_size**2
        high_res, background_only = model.getDeconvolved(kwargs_final, 0)
    flux_uncertainties = scale * get_flux_uncertainties(
        kwargs=kwargs_final, kwargs_up=kwargs_up, kwargs_down=kwargs_down,
        data=data, noisemap=noisemap, model=model)
    chi2_per_frame = chi2_per_frame.cpu().numpy()
    return {
        "scale": scale,
        "kwargs_final": kwargs_to_numpy(kwargs_final),
        "fluxes": scale * kwargs_final["kwargs_analytic"]["a"].cpu().numpy(),
        "fluxes_uncertainties": flux_uncertainties,
        "chi2": float(np.nanmean(chi2_per_frame)),
        "chi2_per_frame": chi2_per_frame,
        "loss_curve": optim.loss_history,
        "residuals": scale * residuals.cpu().numpy(),
        "deconvolved_image": scale * high_res.cpu().numpy(),
        "starlet_background": scale * background_only.cpu().numpy(),
    }


def _derived_psf_ref(frame_id, user_config, combined_footprint_hash,
                     cache=None):
    """The PSF model name the current config selects for a frame (as the
    PSF task names it: 'psf_' + the sorted star names)."""
    if cache is not None and frame_id in cache:
        return cache[frame_id]
    stars_psf = select_stars_for_a_frame(
        frame_id=frame_id,
        stars_to_use=user_config["stars_to_use_psf"],
        stars_to_exclude=user_config["stars_to_exclude_psf"],
        combined_footprint_hash=combined_footprint_hash)
    ref = "psf_" + "".join(sorted(stars_psf["name"]))
    if cache is not None:
        cache[frame_id] = ref
    return ref


def get_frames_for_star(combined_footprint_hash, gaia_id, psf_fit_chi2_min,
                        psf_fit_chi2_max, only_fluxless_frames=False,
                        psf_ref_cache=None, user_config=None):
    """Frames holding the star whose current PSF passed the chi2 gate;
    optionally only those still missing its flux (the incremental rerun).

    ``user_config``: the caller's config (loaded here when None)."""
    query = """
    SELECT f.*, ps.chi2, ps.psf_ref
    FROM frames f
    JOIN stars_in_frames sif
        ON f.id = sif.frame_id AND sif.combined_footprint_hash = ?
    """
    if only_fluxless_frames:
        query += ("LEFT JOIN star_flux_in_frame sff ON f.id = sff.frame_id "
                  "AND sif.star_gaia_id = sff.star_gaia_id "
                  "AND sif.combined_footprint_hash = "
                  "sff.combined_footprint_hash\n")
    query += """
    JOIN PSFs ps ON f.id = ps.frame_id
        AND sif.combined_footprint_hash = ps.combined_footprint_hash
    WHERE sif.star_gaia_id = ?
    """
    if only_fluxless_frames:
        query += "AND sff.frame_id IS NULL\n"
    # the gate judges the joined PSF row of the same footprint hash
    query += """
    AND ps.chi2 BETWEEN ? AND ?"""
    params = (combined_footprint_hash, gaia_id, psf_fit_chi2_min,
              psf_fit_chi2_max)
    frames = execute_sqlite_query(query, params, use_pandas=True)
    if len(frames):
        # a frame may hold several PSF models (older star sets): keep the
        # row of the PSF the fit will use, so a stale passing row cannot
        # admit a frame whose current PSF failed the gate
        if user_config is None:
            user_config = get_user_config()
        current_ref = frames["id"].map(lambda fid: _derived_psf_ref(
            fid, user_config, combined_footprint_hash, psf_ref_cache))
        frames = frames[frames["psf_ref"] == current_ref]
        frames = frames.drop_duplicates(subset=["id"], ignore_index=True)
    return frames


def update_star_fluxes(flux_data):
    """Upsert measured fluxes (idempotent reruns)."""
    executemany_sqlite(
        """INSERT INTO star_flux_in_frame (combined_footprint_hash,
           frame_id, star_gaia_id, flux, flux_uncertainty, chi2,
           relative_loss_differential) VALUES (?, ?, ?, ?, ?, ?, ?)
           ON CONFLICT(combined_footprint_hash, frame_id, star_gaia_id)
           DO UPDATE SET flux=excluded.flux,
           flux_uncertainty=excluded.flux_uncertainty,
           chi2=excluded.chi2,
           relative_loss_differential=excluded.relative_loss_differential""",
        flux_data)


def _load_star_epochs(user_config, h5f, frames, star, footprint_hash,
                      psf_ref_cache=None, device="cuda"):
    """Per-frame stamps and their narrow PSFs (at the star's field position
    when ``field_distortion`` is on, warped on ``device``)."""
    data, noisemap, mask, psf = [], [], [], []
    for _, frame in frames.iterrows():
        rel = frame["image_relpath"]
        gaia_id = str(star["gaia_id"])
        data.append(h5f[f"{rel}/data/{gaia_id}"][...])
        noisemap.append(h5f[f"{rel}/noisemap/{gaia_id}"][...])
        mask.append(h5f[f"{rel}/cosmicsmask/{gaia_id}"][...])
        psf_ref = _derived_psf_ref(frame["id"], user_config,
                                   footprint_hash, psf_ref_cache)
        narrow_psf = h5f[f"{rel}/{psf_ref}/narrow_psf"][...]
        if user_config["field_distortion"]:
            dist_group = h5f[f"{rel}/{psf_ref}/distortion"]
            kwargs_distortion = {k: dist_group[k][...] for k in dist_group}
            position = h5f[
                f"{rel}/image_pixel_coordinates/{gaia_id}"][...]
            frame_shape = h5f[f"{rel}/frame_shape"][...]
            position = rescale_image_coordinates(position, frame_shape)
            narrow_psf = apply_distortion(narrow_psf, kwargs_distortion,
                                          position, device=device)
        psf.append(narrow_psf)
    return (np.array(data), np.array(noisemap),
            np.array(mask).astype(bool), np.array(psf))


def _star_batch_size(user_config):
    """``star_fit_batch_size``, where 0 (or null) means one bucket of every
    star; a negative size is refused, since it would make no bucket."""
    size = int(user_config.get("star_fit_batch_size", 32) or 0)
    if size < 0:
        raise ValueError(f"star_fit_batch_size must be >= 0 (0 or null: "
                         f"one bucket of every star), got {size}")
    return size


def do_star_photometry(*, device="cuda", irfft_backend="fft"):
    """Pipeline task: joint PSF photometry of every reference star.

    Buckets of stars are fitted by ``fit_stars_batched`` on ``device``,
    the card unless the caller asks for ``"cpu"`` (no fallback),
    rendering with ``irfft_backend`` ("fft" or "matmul", the port's name
    for JAX's "mxu"). Several buckets without checkpointing are pipelined
    (:func:`.psf_modelling.run_pipelined_buckets`).
    """
    import h5py

    logger = logging.getLogger("lightcurver.star_photometry")
    user_config = get_user_config()
    batch_size = _star_batch_size(user_config)
    frames_ini = get_pandas(
        columns=["id"],
        conditions=["plate_solved = 1", "eliminated = 0",
                    "roi_in_footprint = 1"])
    footprint_hash = get_combined_footprint_hash(
        user_config, frames_ini["id"].to_list())
    stars = select_stars(
        stars_to_use=user_config["stars_to_use_norm"],
        combined_footprint_hash=footprint_hash,
        stars_to_exclude=user_config["stars_to_exclude_norm"])
    logger.info(f"PSF photometry for {len(stars)} stars.")
    only_fluxless = not user_config["redo_star_photometry"]
    time_now = datetime.now().strftime("%Y-%m-%dT%H-%M-%S")

    # the stars' jobs (host IO), from one read-only open
    jobs = []
    chi2_min, chi2_max = get_chi2_bounds(psf_or_fluxes="psf")
    psf_ref_cache = {}  # frame_id -> the config's psf_ref, for this run
    with h5py.File(user_config["regions_path"], "r") as h5f:
        for _, star in stars.iterrows():
            frames = get_frames_for_star(
                gaia_id=star["gaia_id"], psf_fit_chi2_min=chi2_min,
                psf_fit_chi2_max=chi2_max,
                only_fluxless_frames=only_fluxless,
                combined_footprint_hash=footprint_hash,
                psf_ref_cache=psf_ref_cache, user_config=user_config)
            if len(frames) == 0:
                logger.info(f"Star {star['name']}: up to date.")
                continue
            data, noisemap, cosmics, psf = _load_star_epochs(
                user_config, h5f, frames, star, footprint_hash,
                psf_ref_cache=psf_ref_cache, device=device)
            # a pixel with a NaN in either is dead: zero data, large noise
            isnan = np.isnan(data) | np.isnan(noisemap)
            data[isnan] = 0.0
            noisemap[isnan] = 1e7
            noisemap[cosmics] *= 1000.0  # cosmics True = bad pixel
            jobs.append({"star": star, "frames": frames, "data": data,
                         "noisemap": noisemap, "psf": psf})
    if not jobs:
        return

    t0 = time()
    batch_size = batch_size or len(jobs)
    buckets = [jobs[lo:lo + batch_size]
               for lo in range(0, len(jobs), batch_size)]
    checkpointing = int(user_config["deconv_checkpoint_every"] or 0) > 0

    def store_bucket(bucket, out, t0b):
        results = _collect_star_results(out, bucket)
        logger.info(f"Collected {len(bucket)} star fits "
                    f"{time() - t0b:.1f}s after dispatch.")
        for job, result in zip(bucket, results):
            _store_star_result(user_config, job, result, footprint_hash,
                               time_now, logger)

    fit = dict(device=device, irfft_backend=irfft_backend)
    if checkpointing or len(buckets) == 1:
        # checkpoint segments synchronise anyway, and the core refuses
        # fetch="device" with a checkpoint path
        for bucket in buckets:
            t0b = time()
            out = _dispatch_star_jobs(user_config, bucket, fetch="numpy",
                                      **fit)
            store_bucket(bucket, out, t0b)
    else:
        from .psf_modelling import run_pipelined_buckets

        run_pipelined_buckets(
            buckets, lambda bucket: bucket,
            lambda bucket: _dispatch_star_jobs(user_config, bucket,
                                               fetch="device", **fit),
            store_bucket)
    logger.info(f"Fitted {len(jobs)} stars jointly in "
                f"{time() - t0:.1f}s ({len(buckets)} bucket(s)).")


def _pad_star_jobs(jobs):
    """One bucket's stacked fit inputs (data, noise, psf): the epochs padded
    to the bucket's largest count with dummies (data 0, noise 1e7, the
    star's first PSF, which a dummy epoch needs to be valid)."""
    n_max = max(len(j["data"]) for j in jobs)
    n_pix = jobs[0]["data"].shape[-1]
    mp = jobs[0]["psf"].shape[-1]
    S = len(jobs)
    data = np.zeros((S, n_max, n_pix, n_pix), np.float32)
    noise = np.full((S, n_max, n_pix, n_pix), 1e7, np.float32)
    psf = np.zeros((S, n_max, mp, mp), np.float32)
    for i, job in enumerate(jobs):
        k = len(job["data"])
        data[i, :k] = job["data"]
        noise[i, :k] = job["noisemap"]
        psf[i, :k] = job["psf"]
        psf[i, k:] = job["psf"][0]
    return data, noise, psf


def _dispatch_star_jobs(user_config, jobs, fetch="numpy", *, device="cuda",
                        irfft_backend="fft"):
    """Pad one bucket of stars to a common epoch count and fit it.

    ``fetch="device"`` returns the fit's tensors unsynchronised, so the
    caller can queue the next bucket before fetching this one;
    ``fetch="numpy"`` waits, and is what mid-fit checkpointing
    (``deconv_checkpoint_every``) uses. A checkpoint is deleted after the
    fit succeeds.
    """
    from ..core.deconv.batched import fit_stars_batched

    data, noise, psf = _pad_star_jobs(jobs)

    # opt-in mid-fit checkpoints, named by the bucket's stars and shape;
    # the core digests the arrays' content and refuses another's file
    checkpoint_every = int(user_config["deconv_checkpoint_every"] or 0)
    checkpoint_path = None
    if checkpoint_every > 0:
        import hashlib

        user_config["checkpoints_dir"].mkdir(exist_ok=True, parents=True)
        job_key = hashlib.sha256(
            (",".join(str(j["star"]["gaia_id"]) for j in jobs)
             + f":{data.shape}").encode()).hexdigest()[:16]
        checkpoint_path = (user_config["checkpoints_dir"]
                           / f"star_photometry_{job_key}.ckpt")

    def run_batched_fit():
        return fit_stars_batched(
            data, noise, psf, user_config["subsampling_factor"],
            n_iter=user_config["star_deconv_n_iter"],
            uniform_background_per_epoch=user_config[
                "star_photometry_uniform_background_per_epoch"],
            starlet_global_background=user_config[
                "star_photometry_starlet_global_background"],
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every or 500,
            fetch=fetch if checkpoint_path is None else "numpy",
            device=device, irfft_backend=irfft_backend)

    # the task derives its inputs anew on every run: a checkpoint that no
    # longer matches them is discarded, not a reason to stop
    out = run_discarding_stale_checkpoint(
        run_batched_fit, checkpoint_path,
        logging.getLogger("lightcurver.star_photometry"))
    if checkpoint_path is not None:
        checkpoint_path.unlink(missing_ok=True)
    return out


def _collect_star_results(out, jobs):
    """Fetch a dispatched bucket to the host as per-star result dicts."""
    out = kwargs_to_numpy(out)
    results = []
    for i, job in enumerate(jobs):
        k = len(job["data"])
        results.append({
            "fluxes": out["fluxes"][i, :k],
            "fluxes_uncertainties": out["fluxes_uncertainties"][i, :k],
            "chi2_per_frame": out["chi2_per_frame"][i, :k],
            "chi2": float(np.nanmean(out["chi2_per_frame"][i, :k])),
            "loss_curve": out["loss_history"][i],
            "residuals": out["residuals"][i, :k],
            "starlet_background": out["starlet_background"][i],
        })
    return results


def _fit_star_jobs_batched(user_config, jobs, *, device="cuda",
                           irfft_backend="fft"):
    """One bucket, synchronously: dispatch and collect."""
    return _collect_star_results(
        _dispatch_star_jobs(user_config, jobs, fetch="numpy", device=device,
                            irfft_backend=irfft_backend), jobs)


def _store_star_result(user_config, job, result, footprint_hash,
                       time_now, logger):
    """Plots and the DB upsert for one fitted star."""
    star, frames = job["star"], job["frames"]
    data, noisemap = job["data"], job["noisemap"]

    try:
        from ..plotting.joint_modelling_plotting import \
            plot_joint_modelling_diagnostic

        plot_dir = (user_config["plots_dir"] / "star_modelling"
                    / str(footprint_hash))
        plot_dir.mkdir(exist_ok=True, parents=True)
        kwargs_plot = {
            "datas": data, "noisemaps": noisemap,
            "residuals": result["residuals"],
            "chi2_per_frame": result["chi2_per_frame"],
            "loss_curve": result["loss_curve"],
            "save_path": plot_dir / (f"{time_now}_joint_modelling_"
                                     f"star_{star['name']}.jpg"),
        }
        if user_config["star_photometry_starlet_global_background"]:
            kwargs_plot["starlet_background"] = \
                result["starlet_background"]
        plot_joint_modelling_diagnostic(**kwargs_plot)
    except Exception as e:
        logger.warning(f"Star modelling plot failed: {e}")

    rld = warn_if_unconverged(result["loss_curve"], logger,
                              f"Star {star['name']} joint fit",
                              "star_deconv_n_iter")
    flux_data = [
        (footprint_hash, int(frame["id"]), star["gaia_id"],
         float(result["fluxes"][j]),
         float(result["fluxes_uncertainties"][j]),
         float(result["chi2_per_frame"][j]), rld)
        for j, (_, frame) in enumerate(frames.iterrows())]
    update_star_fluxes(flux_data)
    logger.info(f"Star {star['name']}: {len(frames)} frames, chi2 "
                f"{result['chi2']:.02f}.")
