"""The deconvolution-ready ROI cutout file: the port of the JAX pipeline
task ``lightcurver_tpu/processes/roi_file_preparation.py::
prepare_roi_file``.

It selects the frames that have everything (each frame's best-chi2 PSF of
this footprint, a normalization coefficient, the user's constraints),
loads the ROI stamps, divides data and noise by the coefficient, warps the
PSF to the ROI's field position when ``field_distortion`` is on, computes
the global zeropoint of the normalised data, and writes one HDF5 with the
JAX task's dataset names: the file the port's ``roi_modelling`` task
reads. h5py is imported by the task, so the module imports without it.
"""

import logging

import numpy as np

from ..core.psf.distortion import apply_distortion
from ..structure.database import execute_sqlite_query, get_pandas
from ..structure.user_config import get_user_config
from ..utilities.chi2_selector import get_chi2_bounds
from ..utilities.footprint import get_combined_footprint_hash
from ..utilities.image_coordinates import rescale_image_coordinates


def get_frames_for_roi(combined_footprint_hash, psf_fit_chi2_min,
                       psf_fit_chi2_max, constraints_on_frame_columns_dict,
                       constraints_on_normalization_coeff_dict):
    """Frames with their best PSF (lowest chi2) and coefficient, filtered
    by the user's constraints, in mjd order."""
    # the best-PSF window partitions within this footprint hash, so a PSF
    # row of a stale hash cannot take a frame's first rank
    query = """
    SELECT f.*, ps.*, nc.*
    FROM frames f
    JOIN (
        SELECT *,
        ROW_NUMBER() OVER (PARTITION BY frame_id ORDER BY chi2 ASC) as rn
        FROM PSFs
        WHERE combined_footprint_hash = ?
    ) ps ON f.id = ps.frame_id AND ps.rn = 1
    JOIN normalization_coefficients nc ON f.id = nc.frame_id
        AND nc.combined_footprint_hash = ps.combined_footprint_hash
    WHERE nc.combined_footprint_hash = ?
    AND ps.chi2 BETWEEN ? AND ?
    """
    params = [combined_footprint_hash, combined_footprint_hash,
              psf_fit_chi2_min, psf_fit_chi2_max]
    for column, (lo, hi) in constraints_on_frame_columns_dict.items():
        query += f" AND f.{column} BETWEEN ? AND ?"
        params.extend([lo, hi])
    for column, (lo, hi) in constraints_on_normalization_coeff_dict.items():
        query += f" AND nc.{column} BETWEEN ? AND ?"
        params.extend([lo, hi])
    query += " ORDER BY f.mjd"
    return execute_sqlite_query(query, tuple(params), use_pandas=True)


def fetch_and_adjust_zeropoints(combined_footprint_hash):
    """Global zeropoint of the normalised data and its scatter.

    zp_adjusted = zp - 2.5 log10(coefficient); warns when normalising did
    not reduce the zeropoints' scatter.
    """
    data = execute_sqlite_query(
        """SELECT az.frame_id, az.zeropoint, az.zeropoint_uncertainty,
                  nc.coefficient
           FROM absolute_zeropoints az
           JOIN normalization_coefficients nc ON az.frame_id = nc.frame_id
                AND az.combined_footprint_hash = nc.combined_footprint_hash
           WHERE az.combined_footprint_hash = ?""",
        (combined_footprint_hash,), use_pandas=True)
    if data.empty:
        return None, None
    adjusted = data["zeropoint"] - 2.5 * np.log10(data["coefficient"])
    if adjusted.std() > data["zeropoint"].std():
        logging.getLogger("lightcurver.roi_file_preparation").warning(
            "Zeropoint scatter before normalizing is lower than after? "
            "Not normal, investigate.")
    return float(adjusted.median()), float(adjusted.std())


def prepare_roi_file(*, device="cuda"):
    """Pipeline task: write the deconvolution-ready HDF5 file.

    ``device`` is where the PSFs are warped when ``field_distortion`` is
    on: the card unless the caller asks for ``"cpu"``.
    """
    import h5py

    logger = logging.getLogger("lightcurver.roi_file_preparation")
    user_config = get_user_config()
    frames_ini = get_pandas(
        columns=["id"],
        conditions=["plate_solved = 1", "eliminated = 0",
                    "roi_in_footprint = 1"])
    footprint_hash = get_combined_footprint_hash(
        user_config, frames_ini["id"].to_list())
    chi2_min, chi2_max = get_chi2_bounds(psf_or_fluxes="psf")
    frames = get_frames_for_roi(
        combined_footprint_hash=footprint_hash,
        psf_fit_chi2_min=chi2_min, psf_fit_chi2_max=chi2_max,
        constraints_on_frame_columns_dict=user_config[
            "constraints_on_frame_columns_for_roi"],
        constraints_on_normalization_coeff_dict=user_config[
            "constraints_on_normalization_coeff"])
    logger.info(f"Preparing calibrated ROI cutouts from {len(frames)} "
                "frames.")

    columns = {name: [] for name in (
        "data", "noisemap", "mask", "psf", "frame_id", "subsampling",
        "seeing", "pixel_scale", "wcs", "mjd", "exptime", "sky_level",
        "norm_uncertainty", "angle_to_north")}
    with h5py.File(user_config["regions_path"], "r") as h5f:
        for _, frame in frames.iterrows():
            rel = frame["image_relpath"]
            coeff = frame["coefficient"]
            columns["data"].append(h5f[f"{rel}/data/ROI"][...] / coeff)
            columns["noisemap"].append(
                h5f[f"{rel}/noisemap/ROI"][...] / coeff)
            columns["mask"].append(h5f[f"{rel}/cosmicsmask/ROI"][...])
            psf_ref = frame["psf_ref"]
            narrow_psf = h5f[f"{rel}/{psf_ref}/narrow_psf"][...]
            if user_config["field_distortion"]:
                group = h5f[f"{rel}/{psf_ref}/distortion"]
                kwargs_distortion = {k: group[k][...] for k in group}
                position = h5f[f"{rel}/image_pixel_coordinates/ROI"][...]
                frame_shape = h5f[f"{rel}/frame_shape"][...]
                position = rescale_image_coordinates(position, frame_shape)
                narrow_psf = apply_distortion(
                    narrow_psf, kwargs_distortion, position, device=device)
            columns["psf"].append(narrow_psf)
            columns["subsampling"].append(
                h5f[f"{rel}/{psf_ref}/subsampling_factor"][...])
            columns["seeing"].append(frame["seeing_arcseconds"])
            columns["pixel_scale"].append(frame["pixel_scale"])
            columns["wcs"].append(h5f[f"{rel}/wcs/ROI"][()])
            columns["exptime"].append(frame["exptime"])
            columns["sky_level"].append(
                frame["sky_level_electron_per_second"])
            columns["mjd"].append(frame["mjd"])
            columns["frame_id"].append(frame["id"])
            columns["norm_uncertainty"].append(
                frame["coefficient_uncertainty"])
            columns["angle_to_north"].append(frame["angle_to_north"])

    data = np.array(columns["data"])
    noisemap = np.array(columns["noisemap"])
    # a pixel with a NaN in either is dead: zero data, large noise
    isnan = np.isnan(data) | np.isnan(noisemap)
    data[isnan] = 0.0
    noisemap[isnan] = 1e7
    good = ~np.array(columns["mask"]).astype(bool)
    noisemap[~good] *= 1000.0

    global_zp, global_zp_scatter = fetch_and_adjust_zeropoints(
        footprint_hash)

    save_path = user_config["prepared_roi_cutouts_path"]
    if save_path is None:
        save_path = (user_config["workdir"] / "prepared_roi_cutouts"
                     / f"cutouts_{footprint_hash}_"
                       f"{user_config['roi_name']}.h5")
    save_path.parent.mkdir(exist_ok=True, parents=True)
    with h5py.File(save_path, "w") as f:
        f["frame_id"] = np.array(columns["frame_id"])
        f["data"] = data
        f["noisemap"] = noisemap
        f["psf"] = np.array(columns["psf"])
        f["seeing"] = np.array(columns["seeing"])
        f["sky_level_electron_per_second"] = np.array(columns["sky_level"])
        f["mjd"] = np.array(columns["mjd"])
        f["global_zeropoint"] = np.array(
            float(global_zp) if global_zp is not None else np.nan)
        f["global_zeropoint_scatter"] = np.array(
            float(global_zp_scatter)
            if global_zp_scatter is not None else np.nan)
        f["relative_normalization_error"] = np.array(
            columns["norm_uncertainty"])
        f["wcs"] = np.array(columns["wcs"])
        f["pixel_scale"] = np.array(columns["pixel_scale"])
        f["subsampling_factor"] = np.array(columns["subsampling"])
        f["angle_to_north"] = np.array(columns["angle_to_north"])
    logger.info(f"Wrote calibrated cutouts at {save_path}.")
