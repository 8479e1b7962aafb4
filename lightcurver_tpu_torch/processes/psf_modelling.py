"""Per-frame narrow-PSF modelling: the port of the JAX pipeline task
``lightcurver_tpu/processes/psf_modelling.py::model_all_psfs``.

For each frame: select its reference stars, load their stamps from the
regions HDF5, mask the neighbouring objects, repair NaNs, drop the stars
more than 40 % masked, fit the narrow PSF (``core/psf/batched.py``, the
frames of a bucket at once), and write the narrow and full PSF and the
distortion to the HDF5 and chi2, the loss plateau metric and the Moffat
FWHM to the ``PSFs`` table, under the same names as the JAX task.

The buckets are pipelined over one worker thread
(:func:`run_pipelined_buckets`): ``build_psf_batched(fetch="device")``
returns unsynchronised tensors, so bucket i + 1's host preparation runs
while the card fits bucket i. On one CUDA stream the copy of bucket
i - 1's results to the host is queued behind bucket i's kernels.

Under several ranks (the pipeline under ``torchrun``) rank 0 decides the
frames that still need a PSF and prepares each bucket; the prepared bucket
is broadcast to every rank on the main thread, every rank fits it with
``mesh="auto"`` (the frames sharded over the ranks), and rank 0 alone
stores the results (:func:`run_pipelined_buckets`).

With ``psf_do_plots`` (the default) each frame's diagnostic plot is
written to ``plots/PSFs/<footprint hash>/<id>_<frame>.jpg``, as JAX's
task writes it. h5py, pandas and matplotlib are imported by the functions
that use them, so the module imports without them.
"""

import logging
import threading
from pathlib import Path
from time import time

import numpy as np

from ..core.optimize import warn_if_unconverged
from ..core.params import kwargs_to_numpy
from ..parallel.distributed import broadcast_work, is_writer, rank_buckets
from ..structure.database import (execute_sqlite_query, get_pandas,
                                  select_stars_for_a_frame)
from ..structure.user_config import get_user_config
from ..utilities.footprint import get_combined_footprint_hash
from ..utilities.image_coordinates import rescale_image_coordinates
from ..utilities.tracing import span
from .star_extraction import _segment


def check_psf_exists(frame_id, psf_ref, combined_footprint_hash):
    """Is this (frame, star set, footprint) PSF already in the DB?"""
    rows = execute_sqlite_query(
        "SELECT 1 FROM PSFs WHERE frame_id = ? AND psf_ref = ? "
        "AND combined_footprint_hash = ?",
        params=(frame_id, psf_ref, combined_footprint_hash))
    return len(rows) > 0


def mask_surrounding_stars(data, noisemap):
    """True = good pixel; masks every detected object but the central one."""
    data = np.nan_to_num(np.asarray(data, dtype=np.float32))
    var = np.nan_to_num(np.asarray(noisemap, dtype=np.float32),
                        nan=1e8) ** 2
    labels, seg = _segment(data, var, threshold=3.0, min_area=15)
    mask = np.ones_like(data, dtype=bool)
    if not labels:
        return mask
    cy = (data.shape[0] - 1) / 2.0
    cx = (data.shape[1] - 1) / 2.0
    dists = []
    for lab in labels:
        ys, xs = np.nonzero(seg == lab)
        w = data[ys, xs].clip(min=0) + 1e-9
        dists.append(np.hypot((xs * w).sum() / w.sum() - cx,
                              (ys * w).sum() / w.sum() - cy))
    central = labels[int(np.argmin(dists))]
    for lab in labels:
        if lab != central:
            mask[seg == lab] = False
    return mask


# serialises the regions-HDF5 opens of the worker thread (read-only loads
# of the next bucket) and the main thread (r+ stores of the current
# bucket): HDF5's file locking refuses an r+ open while a read handle is
# live in the same process
_REGIONS_IO_LOCK = threading.Lock()


def _load_star_stack(regions_file, relpath, gaia_ids):
    import h5py

    with _REGIONS_IO_LOCK, h5py.File(regions_file, "r") as f:
        base = f[relpath]
        datas = np.array([base["data"][g][...] for g in gaia_ids])
        noisemaps = np.array([base["noisemap"][g][...] for g in gaia_ids])
        cosmics = np.array([base["cosmicsmask"][g][...]
                            for g in gaia_ids]).astype(bool)
        frame_shape = base["frame_shape"][...]
        positions = np.array([base["image_pixel_coordinates"][g][...]
                              for g in gaia_ids])
    rescaled = rescale_image_coordinates(positions, frame_shape)
    return datas, noisemaps, ~cosmics, rescaled  # True = good pixel


def _prepare_frame_job(user_config, regions_file, frame,
                       combined_footprint_hash, logger):
    """Load and mask one frame's star stack; None when nothing to fit."""
    stars = select_stars_for_a_frame(
        frame_id=frame["id"],
        combined_footprint_hash=combined_footprint_hash,
        stars_to_use=user_config["stars_to_use_psf"],
        stars_to_exclude=user_config["stars_to_exclude_psf"])
    if len(stars) == 0:
        logger.warning(f"Frame {frame['id']}: no reference stars, "
                       "skipping.")
        return None
    psf_ref = "psf_" + "".join(sorted(stars["name"]))
    if check_psf_exists(frame["id"], psf_ref, combined_footprint_hash) \
            and not user_config["redo_psf"]:
        logger.info(f"Frame {frame['id']}: PSF {psf_ref} exists, "
                    "skipping.")
        return None

    gaia_ids = [str(g) for g in stars["gaia_id"]]
    datas, noisemaps, good_masks, stamp_coords = _load_star_stack(
        regions_file, frame["image_relpath"], gaia_ids)
    auto = np.array([mask_surrounding_stars(d, n)
                     for d, n in zip(datas, noisemaps)])
    masks = good_masks & auto
    isnan = np.isnan(datas) | np.isnan(noisemaps)
    datas[isnan] = 0.0
    noisemaps[isnan] = 1.0
    masks[isnan] = False

    # drop the stars with more than 40 % of their pixels masked
    n_before = len(datas)
    frac_masked = (~masks).sum(axis=(1, 2)) / masks[0].size
    keep = frac_masked <= 0.4
    datas, noisemaps, masks = datas[keep], noisemaps[keep], masks[keep]
    stamp_coords = stamp_coords[keep]
    names = list(np.asarray(stars["name"])[keep])
    if len(datas) == 0:
        logger.warning(f"Frame {frame['id']}: all {n_before} stars too "
                       "masked, skipping.")
        return None
    return {
        "frame": frame, "psf_ref": psf_ref, "data": datas,
        "noisemap": noisemaps, "masks": masks,
        "stamp_coords": stamp_coords, "names": names,
        "n_before": n_before,
    }


def _pad_fit_jobs(jobs):
    """One bucket's stacked fit inputs: the star counts padded to the
    bucket's largest with fully masked dummy stars (no chi2 weight)."""
    n_max = max(len(job["data"]) for job in jobs)
    shape = (len(jobs), n_max) + jobs[0]["data"].shape[1:]
    data = np.zeros(shape, dtype=np.float32)
    noise = np.ones(shape, dtype=np.float32)
    masks = np.zeros(shape, dtype=bool)
    coords = np.zeros((len(jobs), n_max, 2), dtype=np.float32)
    fwhm0 = np.zeros(len(jobs), dtype=np.float32)
    for i, job in enumerate(jobs):
        k = len(job["data"])
        data[i, :k] = job["data"]
        noise[i, :k] = job["noisemap"]
        masks[i, :k] = job["masks"]
        coords[i, :k] = job["stamp_coords"]
        seeing = job["frame"]["seeing_pixels"]
        # > 0: the seeing estimate is -1.0 for a frame without sources
        fwhm0[i] = seeing if (seeing and np.isfinite(seeing)
                              and seeing > 0) else 3.0
    return {"images": data, "noisemaps": noise, "masks": masks,
            "stamp_coordinates": coords, "guess_fwhm_pixels": fwhm0}


def _dispatch_fit_jobs(user_config, jobs, fetch="device", *, device="cuda",
                       irfft_backend="fft"):
    """Start one bucket's batched fit; returns its output unsynchronised.

    With ``fetch="device"`` the result is the fit's tensors on
    ``device``, whose kernels may still be queued: the caller collects
    them later (:func:`_collect_fit_results`), after queueing the next
    bucket's work. The ``psf.dispatch`` span's ``plan`` says whether the
    fit found its shape's plan (``"hit"``) or built it (``"miss"``).
    """
    from ..core.psf.batched import build_psf_batched, plan_counts

    with span("psf.dispatch", frames=len(jobs)) as attrs:
        hits = plan_counts()["hits"]
        out = build_psf_batched(
            subsampling_factor=user_config["subsampling_factor"],
            n_iter_analytic=user_config["psf_n_iter_analytic"],
            n_iter_adabelief=user_config["psf_n_iter_pixels"],
            field_distortion=user_config["field_distortion"], fetch=fetch,
            dft_pad=user_config.get("psf_dft_pad"), device=device,
            irfft_backend=irfft_backend, **_pad_fit_jobs(jobs))
        attrs["plan"] = "hit" if plan_counts()["hits"] > hits else "miss"
        return out


def _collect_fit_results(out, jobs):
    """Fetch a dispatched bucket to the host as per-job result dicts."""
    out = kwargs_to_numpy(out)
    results = []
    for i, job in enumerate(jobs):
        k = len(job["data"])
        results.append({
            "narrow_psf": out["narrow_psf"][i],
            "full_psf": out["full_psf"][i],
            "chi2": float(out["chi2"][i]),
            "chi2_per_star": out["chi2_per_star"][i, :k],
            "residuals": out["residuals"][i, :k],
            "kwargs_psf": {
                "kwargs_moffat": {
                    key: out["kwargs_moffat"][key][i]
                    for key in out["kwargs_moffat"]},
                "kwargs_distortion": {
                    key: out["kwargs_distortion"][key][i]
                    for key in out["kwargs_distortion"]},
            },
            "adabelief_extra_fields": {
                "loss_history": out["loss_history_pixels"][i]},
        })
    return results


def model_all_psfs(*, device="cuda", irfft_backend="fft"):
    """Pipeline task: build a PSF model for every eligible frame.

    The frames are fitted in buckets of ``psf_fit_batch_size`` (one
    ``build_psf_batched`` call each) on ``device``, the card unless the
    caller asks for ``"cpu"`` (no fallback), rendering with
    ``irfft_backend`` ("fft" or "matmul", the port's name for JAX's
    "mxu", at ``psf_dft_pad``).
    """
    logger = logging.getLogger("lightcurver.psf_modelling")
    user_config = get_user_config()
    regions_file = user_config["regions_path"]
    batch_size = int(user_config.get("psf_fit_batch_size", 16) or 16)

    buckets, combined_footprint_hash = [], None
    if is_writer():
        frames = get_pandas(
            columns=["id", "image_relpath", "exptime", "mjd",
                     "seeing_pixels", "pixel_scale"],
            conditions=["plate_solved = 1", "eliminated = 0",
                        "roi_in_footprint = 1"])
        combined_footprint_hash = get_combined_footprint_hash(
            user_config, frames["id"].to_list())
        logger.info(f"Building PSFs for up to {len(frames)} frames.")
        frame_rows = [frame for _, frame in frames.iterrows()]
        buckets = [frame_rows[lo:lo + batch_size]
                   for lo in range(0, len(frame_rows), batch_size)]

    def prepare_chunk(rows):
        """Host IO and masking for one bucket of frames."""
        chunk = []
        for frame in rows:
            job = _prepare_frame_job(user_config, regions_file, frame,
                                     combined_footprint_hash, logger)
            if job is not None:
                chunk.append(job)
        return chunk

    def store_bucket(chunk, out, t0):
        results = _collect_fit_results(out, chunk)
        # since this bucket's dispatch: the window also holds the next
        # bucket's overlapped preparation, so it is pipelined wall time
        logger.info(f"Collected {len(chunk)} PSF fits {time() - t0:.1f}s "
                    "after dispatch (pipelined).")
        for job, result in zip(chunk, results):
            _store_psf_result(user_config, regions_file, job, result,
                              combined_footprint_hash, logger)

    run_pipelined_buckets(
        buckets, prepare_chunk,
        lambda chunk: _dispatch_fit_jobs(user_config, chunk, device=device,
                                         irfft_backend=irfft_backend),
        store_bucket)


def run_pipelined_buckets(buckets, prepare, dispatch, store):
    """Three-deep software pipeline over buckets of work.

    While the device works on bucket i (``dispatch`` returns without
    waiting for it), bucket i + 1's ``prepare`` runs on a worker thread
    and bucket i - 1's results are fetched and stored (``store``).

    Under several ranks this is the pipeline's rank rule
    (``parallel.distributed.rank_buckets``): ``buckets`` are rank 0's (the
    other ranks' are ignored), rank 0 alone prepares and stores, and each
    prepared bucket is broadcast on the main thread before its dispatch
    (``broadcast_work``), so the worker thread issues no collective and
    every rank dispatches the same buckets in one order. In a world of
    one nothing is exchanged.

    A finished bucket is never lost to its successor's failure: when
    bucket i + 1's prepare or dispatch raises, bucket i's results are
    stored before the exception propagates, so a rerun resumes after them.
    """
    from concurrent.futures import ThreadPoolExecutor

    buckets, prepare, store = rank_buckets(buckets, prepare, store)
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(prepare, buckets[0]) if buckets else None
        in_flight = None  # (chunk, dispatched output, t0)
        for i in range(len(buckets)):
            try:
                with span("pipeline.wait_prepare", bucket=i):
                    chunk = pending.result()
                pending = pool.submit(prepare, buckets[i + 1]) \
                    if i + 1 < len(buckets) else None
                chunk = broadcast_work(chunk)
                if not chunk:
                    continue
                dispatched = (chunk, dispatch(chunk), time())
            except BaseException:
                if in_flight is not None:
                    store(*in_flight)
                    in_flight = None
                raise
            if in_flight is not None:
                store(*in_flight)
            in_flight = dispatched
        if in_flight is not None:
            store(*in_flight)


def _store_psf_result(user_config, regions_file, job, result,
                      combined_footprint_hash, logger):
    """Bookkeeping for one fitted frame: plot, HDF5, DB row."""
    import h5py

    frame = job["frame"]
    psf_ref = job["psf_ref"]
    datas, noisemaps, masks = job["data"], job["noisemap"], job["masks"]
    names = job["names"]
    n_before = job["n_before"]

    kwargs_moffat = result["kwargs_psf"]["kwargs_moffat"]
    # NaN is truthy: a frame whose WCS gave no scale stores FWHM in pixels
    pixel_scale = frame["pixel_scale"]
    if pixel_scale is None or not np.isfinite(pixel_scale):
        pixel_scale = 1.0
    fwhm_arcsec = float(0.5 * (kwargs_moffat["fwhm_x"]
                               + kwargs_moffat["fwhm_y"]) * pixel_scale)
    loss_history = result["adabelief_extra_fields"]["loss_history"]

    # diagnostic plot (psf_do_plots: 0 skips it)
    if user_config.get("psf_do_plots", 1):
        try:
            from ..plotting.psf_plotting import plot_psf_diagnostic

            plots_dir = (user_config["plots_dir"] / "PSFs"
                         / str(combined_footprint_hash))
            plots_dir.mkdir(exist_ok=True, parents=True)
            frame_name = Path(frame["image_relpath"]).stem
            seeing = frame["seeing_pixels"]
            # NaN, and the estimator's -1.0 no-sources sentinel, print as 0
            if seeing is None or not np.isfinite(seeing) or seeing <= 0:
                seeing = 0.0
            seeing = seeing * pixel_scale
            text = (f"{frame_name}\nseeing estimation: {seeing:.02f}\n"
                    f"seeing moffat: {fwhm_arcsec:.02f}")
            plot_psf_diagnostic(
                datas=datas, noisemaps=noisemaps,
                residuals=result["residuals"],
                full_psf=result["full_psf"], loss_curve=loss_history,
                masks=masks, names=names, diagnostic_text=text,
                save_path=plots_dir / f"{frame['id']}_{frame_name}.jpg")
        except Exception as e:
            logger.warning(f"PSF diagnostic plot failed: {e}")

    with _REGIONS_IO_LOCK, h5py.File(regions_file, "r+") as f:
        frame_group = f[frame["image_relpath"]]
        if psf_ref in frame_group:
            del frame_group[psf_ref]
        psf_group = frame_group.create_group(psf_ref)
        psf_group["narrow_psf"] = np.asarray(result["narrow_psf"])
        psf_group["full_psf"] = np.asarray(result["full_psf"])
        psf_group["subsampling_factor"] = np.array(
            [user_config["subsampling_factor"]])
        distortion_group = psf_group.create_group("distortion")
        for key, value in result["kwargs_psf"][
                "kwargs_distortion"].items():
            distortion_group[key] = value

    rld = warn_if_unconverged(loss_history, logger,
                              f"Frame {frame['id']} PSF pixel fit",
                              "psf_n_iter_pixels")
    execute_sqlite_query(
        """REPLACE INTO PSFs (frame_id, chi2,
           relative_loss_differential, psf_ref,
           combined_footprint_hash, subsampling_factor,
           fwhm_moffat_arcseconds) VALUES (?, ?, ?, ?, ?, ?, ?)""",
        params=(frame["id"], float(result["chi2"]),
                rld, psf_ref,
                combined_footprint_hash,
                user_config["subsampling_factor"], fwhm_arcsec),
        is_select=False)
    logger.info(
        f"Frame {frame['id']}: PSF {psf_ref} built "
        f"({n_before}->{len(datas)} stars, chi2 "
        f"{result['chi2']:.02f}).")
