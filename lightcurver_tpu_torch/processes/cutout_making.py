"""Cutouts of the stars and the ROI into the regions HDF5 store: a copy of
``lightcurver_tpu/processes/cutout_making.py``.

The HDF5 layout is the JAX package's:

    {frame_relpath}/frame_shape
    {frame_relpath}/data/{gaia_id|ROI}
    {frame_relpath}/noisemap/{gaia_id|ROI}
    {frame_relpath}/wcs/{gaia_id|ROI}           (JSON of WCS cards here)
    {frame_relpath}/cosmicsmask/{gaia_id|ROI}
    {frame_relpath}/image_pixel_coordinates/{gaia_id|ROI}

Star positions are Gaia's, moved by their proper motions to the frame's
epoch. A frame is skipped when every group holds every wanted key.
``extract_stamp`` and ``mask_cutout`` need numpy and scipy only; h5py is
imported by the task.
"""

import json
import logging

import numpy as np

from ..structure.user_config import get_user_config
from ..structure.database import (get_pandas,
                                  query_all_stars_for_frame_and_footprint)
from ..utilities.footprint import get_combined_footprint_hash
from ..utilities.coordinates import apply_proper_motion
from ..io.fits import read_fits
from ..io.wcs import TanWCS
from .cosmics import detect_cosmics, mask_bad_rows_and_columns

_GROUPS = ("data", "noisemap", "wcs", "image_pixel_coordinates",
           "cosmicsmask")


def extract_stamp(data, header, exptime, sky_coord, cutout_size,
                  background_rms_electron_per_second):
    """Cut a square stamp around a sky position.

    Partial stamps (near edges) are NaN-padded.  Data stays in e-/s; the
    noisemap is sqrt(bkg_rms_e^2 + |data_e|)/exptime.

    Returns:
        (cutout, noisemap, wcs_json_string, (x, y) center in image).
    """
    wcs = TanWCS.from_header(header)
    ra, dec = sky_coord if isinstance(sky_coord, tuple) else (
        sky_coord.ra, sky_coord.dec)
    x, y = wcs.world_to_pixel(ra, dec)
    x, y = float(x), float(y)
    size = int(cutout_size)
    ix = int(round(x - (size - 1) / 2.0))
    iy = int(round(y - (size - 1) / 2.0))

    ny, nx = data.shape
    cutout = np.full((size, size), np.nan, dtype=np.float32)
    ylo, yhi = max(iy, 0), min(iy + size, ny)
    xlo, xhi = max(ix, 0), min(ix + size, nx)
    if yhi > ylo and xhi > xlo:
        cutout[ylo - iy:yhi - iy, xlo - ix:xhi - ix] = \
            data[ylo:yhi, xlo:xhi]

    data_e = exptime * cutout
    noise_e = np.sqrt((exptime * background_rms_electron_per_second) ** 2
                      + np.abs(data_e))
    noise_e = np.maximum(noise_e, 1e-7).astype(np.float32)

    # SIP coefficients carry over EXACTLY: u = FITSx - CRPIX1 is
    # invariant under the cutout's simultaneous pixel/CRPIX shift
    cut_wcs = TanWCS(wcs.crval1, wcs.crval2,
                     wcs.crpix1 - ix, wcs.crpix2 - iy, wcs.cd,
                     sip_a=wcs.sip_a, sip_b=wcs.sip_b,
                     sip_ap=wcs.sip_ap, sip_bp=wcs.sip_bp)
    wcs_str = json.dumps(cut_wcs.to_header_cards())
    return (cutout.astype(np.float32), noise_e / exptime, wcs_str,
            np.array([x, y]))


def mask_cutout(cutout_data, noisemap, do_mask_bad_columns, do_mask_cosmics,
                cosmics_masking_params):
    """Combined bad-row/column + cosmic mask (True = BAD pixel)."""
    mask = np.zeros_like(cutout_data, dtype=bool)
    finite = np.nan_to_num(cutout_data)
    if do_mask_bad_columns:
        mask |= mask_bad_rows_and_columns(finite)
    if do_mask_cosmics:
        cosmic_mask, _ = detect_cosmics(finite, invar=noisemap**2,
                                        **(cosmics_masking_params or {}))
        mask |= cosmic_mask
    return mask


def _ensure_groups(frame_set):
    return {name: (frame_set[name] if name in frame_set
                   else frame_set.create_group(name)) for name in _GROUPS}


def _store(groups, key, cutout, noisemap, wcs_str, center, mask):
    values = {"data": cutout, "noisemap": noisemap, "wcs": wcs_str,
              "image_pixel_coordinates": center, "cosmicsmask": mask}
    for name, val in values.items():
        if key in groups[name]:
            del groups[name][key]
        groups[name][key] = val


def _frame_is_complete(reg_f, relpath, stars):
    """Every wanted key present in EVERY group (not just 'data').

    _store writes 'data' first and 'cosmicsmask' last: judging
    completeness on 'data' alone would make a frame interrupted
    mid-store look complete forever, and downstream loads would then
    KeyError on the missing noisemap/cosmicsmask datasets.
    """
    if relpath not in reg_f:
        return False
    wanted = {str(s) for s in stars["gaia_id"]} | {"ROI"}
    for name in _GROUPS:
        if name not in reg_f[relpath]:
            return False
        # subset, not equality: stale keys from an earlier (larger)
        # star assignment are harmless, and demanding exact equality
        # would re-read the full frame FITS on EVERY run forever
        if not wanted <= set(reg_f[relpath][name].keys()):
            return False
    return True


def extract_all_stamps():
    """Pipeline task: extract all star + ROI stamps of all usable frames."""
    import h5py

    logger = logging.getLogger("lightcurver.cutout_making")
    user_config = get_user_config()
    cosmics_params = user_config.get("cosmics_masking_params", {})

    frames = get_pandas(
        columns=["id", "image_relpath", "exptime", "mjd",
                 "background_rms_electron_per_second"],
        conditions=["plate_solved = 1", "eliminated = 0",
                    "roi_in_footprint = 1"])
    combined_footprint_hash = get_combined_footprint_hash(
        user_config, frames["id"].to_list())
    logger.info(f"Extracting cutouts from up to {len(frames)} frames "
                f"(footprint hash {combined_footprint_hash}).")

    with h5py.File(user_config["regions_path"], "a") as reg_f:
        for _, frame in frames.iterrows():
            stars = query_all_stars_for_frame_and_footprint(
                frame_id=frame["id"],
                combined_footprint_hash=combined_footprint_hash)
            redo = user_config["redo_stamp_extraction"]
            if not redo and _frame_is_complete(reg_f, frame["image_relpath"],
                                               stars):
                logger.info(f"Frame {frame['id']} already extracted.")
                continue

            data, header = read_fits(
                user_config["workdir"] / frame["image_relpath"])
            rms = frame["background_rms_electron_per_second"]
            frame_set = (reg_f[frame["image_relpath"]]
                         if frame["image_relpath"] in reg_f
                         else reg_f.create_group(frame["image_relpath"]))
            if "frame_shape" not in frame_set:
                frame_set["frame_shape"] = data.shape
            groups = _ensure_groups(frame_set)

            if redo or "ROI" not in groups["cosmicsmask"]:
                out = extract_stamp(
                    data, header, frame["exptime"],
                    (user_config["ROI_ra_deg"], user_config["ROI_dec_deg"]),
                    user_config["stamp_size_ROI"], rms)
                mask = mask_cutout(
                    out[0], out[1],
                    user_config["mask_bad_rows_and_columns"],
                    user_config["clean_cosmics"], cosmics_params)
                _store(groups, "ROI", *out, mask)

            if len(stars) == 0:
                logger.warning(
                    f"Frame {frame['id']} has no star available; it will "
                    "not be used downstream.")
            for _, star in stars.iterrows():
                key = str(star["gaia_id"])
                if not redo and key in groups["cosmicsmask"]:
                    continue
                ra, dec = apply_proper_motion(
                    star["ra"], star["dec"], star["pmra"], star["pmdec"],
                    star["ref_epoch"], frame["mjd"])
                out = extract_stamp(data, header, frame["exptime"],
                                    (float(ra), float(dec)),
                                    user_config["stamp_size_stars"], rms)
                mask = mask_cutout(
                    out[0], out[1],
                    user_config["mask_bad_rows_and_columns"],
                    user_config["clean_cosmics"], cosmics_params)
                _store(groups, key, *out, mask)
            logger.info(f"Frame {frame['id']}: cutouts done.")
