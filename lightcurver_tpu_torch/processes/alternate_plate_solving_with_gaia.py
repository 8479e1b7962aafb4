"""Alternate plate solving by matching detections to Gaia star positions:
a copy of ``lightcurver_tpu/processes/alternate_plate_solving_with_gaia.py``.

A guess TAN WCS from the configured pixel scale and the ROI centre
projects the Gaia stars, moved to the frame's epoch, to guess pixels;
the triangle pattern matcher matches them to the frame's detections, and
the fitted similarity transform corrects the WCS. A solved frame's
detections and Gaia positions are plotted under
``plots/gaia_plate_solve_diagnostic/``.
"""

import logging

import numpy as np

from ..structure.database import execute_sqlite_query, get_pandas
from ..structure.user_config import get_user_config
from ..utilities.gaia import find_gaia_stars
from ..utilities.coordinates import apply_proper_motion
from ..utilities.pattern_matching import find_transform
from ..io.fits import read_fits, write_fits
from ..io.wcs import TanWCS, strip_wcs_cards
from .plate_solving import post_plate_solve_steps
from .star_extraction import read_sources


def create_initial_wcs(pixel_scale, image_shape, center_ra, center_dec,
                       rotation_angle_deg):
    """Guess TAN WCS: given scale (arcsec/px), shape, center, rotation."""
    rot = np.deg2rad(rotation_angle_deg)
    scale_deg = pixel_scale / 3600.0
    cd = np.array([
        [-scale_deg * np.cos(rot), scale_deg * np.sin(rot)],
        [scale_deg * np.sin(rot), scale_deg * np.cos(rot)]])
    return TanWCS(center_ra, center_dec,
                  (image_shape[1] - 1) / 2.0, (image_shape[0] - 1) / 2.0,
                  cd)


def refine_wcs(sources_xy, gaia_pixel_positions, wcs):
    """Correct a guess WCS by the detections<->Gaia similarity transform."""
    transform, matches = find_transform(
        np.asarray(sources_xy), np.asarray(gaia_pixel_positions))
    # transform maps detections -> gaia-guess pixels; the corrected WCS
    # evaluates the guess WCS at the transformed pixel
    A = transform.matrix
    t = transform.translation
    inv = np.linalg.inv(A)
    crpix = np.array([wcs.crpix1, wcs.crpix2])
    new_crpix = inv @ (crpix - 1.0) - inv @ t + 1.0
    cd_new = wcs.cd @ A
    return TanWCS(wcs.crval1, wcs.crval2, new_crpix[0], new_crpix[1],
                  cd_new), matches


def alternate_plate_solve_gaia():
    """Pipeline task (strategy 'alternate_gaia_solve')."""
    user_config = get_user_config()
    logger = logging.getLogger("lightcurver.alternate_plate_solve_gaia")
    ra, dec = user_config["ROI_ra_deg"], user_config["ROI_dec_deg"]
    gaia_stars = find_gaia_stars(
        "circle",
        center_radius={
            "center": (ra, dec),
            "radius": user_config["alternate_plate_solve_gaia_radius"]
            / 3600.0},
        gaia_provider=user_config["gaia_provider"])
    gaia_stars = gaia_stars.copy()
    gaia_stars["pmra"] = np.nan_to_num(gaia_stars["pmra"])
    gaia_stars["pmdec"] = np.nan_to_num(gaia_stars["pmdec"])
    pixel_scale = float(np.mean(user_config["plate_scale_interval"]))

    frames = get_pandas(
        columns=["id", "image_relpath", "sources_relpath", "mjd"],
        conditions=["plate_solved = 0", "eliminated = 0"])
    for _, frame in frames.iterrows():
        frame_path = user_config["workdir"] / frame["image_relpath"]
        data, header = read_fits(frame_path)
        sources = read_sources(
            user_config["workdir"] / frame["sources_relpath"])
        ra_e, dec_e = apply_proper_motion(
            gaia_stars["ra"], gaia_stars["dec"], gaia_stars["pmra"],
            gaia_stars["pmdec"], gaia_stars["ref_epoch"], frame["mjd"])
        guess = create_initial_wcs(pixel_scale, data.shape, ra, dec, 0.0)
        gx, gy = guess.world_to_pixel(ra_e, dec_e)
        try:
            wcs_new, _ = refine_wcs(
                sources[["x", "y"]].to_numpy(),
                np.column_stack([gx, gy]), guess)
            success = True
        except Exception as e:
            logger.warning(f"Could not solve frame {frame['id']}: {e}.")
            success = False
        if success:
            strip_wcs_cards(header)
            header.update(wcs_new.to_header_cards())
            write_fits(frame_path, data, header)
            try:
                from ..plotting.sources_plotting import \
                    plot_coordinates_and_sources_on_image

                plot_dir = (user_config["plots_dir"]
                            / "gaia_plate_solve_diagnostic")
                plot_dir.mkdir(parents=True, exist_ok=True)
                plot_coordinates_and_sources_on_image(
                    data, sources=sources, gaia_coords=(ra_e, dec_e),
                    wcs=wcs_new,
                    save_path=plot_dir / f"{frame_path.stem}.jpg")
            except Exception as e:
                logger.warning(f"Gaia solve plot failed: {e}")
            post_plate_solve_steps(frame_path=frame_path,
                                   user_config=user_config,
                                   frame_id=frame["id"])
        execute_sqlite_query(
            "UPDATE frames SET plate_solved = ?, attempted_plate_solve = 1 "
            "WHERE id = ?",
            params=(1 if success else 0, frame["id"]), is_select=False)
