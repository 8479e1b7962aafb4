"""Alternate plate solving by mapping one solved frame's WCS onto the
others: a copy of
``lightcurver_tpu/processes/alternate_plate_solving_adapt_existing_wcs.py``.

For each unsolved frame, the triangle pattern matcher
(``utilities/pattern_matching.py``) finds the similarity transform between
the reference frame's detections and the frame's; the reference WCS's
CRPIX and CD matrix are pushed through it.
"""

import logging

import numpy as np

from ..structure.user_config import get_user_config
from ..structure.database import execute_sqlite_query
from ..io.fits import read_fits, write_fits
from ..io.wcs import TanWCS, strip_wcs_cards
from ..utilities.pattern_matching import find_transform
from .plate_solving import (select_frames_needing_plate_solving,
                            post_plate_solve_steps)
from .star_extraction import read_sources


def adapt_wcs(reference_wcs, reference_sources, target_sources):
    """New TanWCS for the target given matched source patterns.

    The transform maps reference pixels onto target pixels; CRPIX moves
    with it and CD is composed with the scaled rotation.
    """
    transform, matches = find_transform(
        np.asarray(reference_sources), np.asarray(target_sources))
    A = transform.matrix
    t = transform.translation
    crpix = np.array([reference_wcs.crpix1, reference_wcs.crpix2])
    # CRPIX is 1-based; the transform acts on 0-based pixels
    new_crpix = A @ (crpix - 1.0) + t + 1.0
    # pixel->world must compose with the inverse pixel map:
    # cd_new = cd_ref @ A^-1
    cd_new = reference_wcs.cd @ np.linalg.inv(A)
    # the SIP polynomials describe the DETECTOR's optical distortion, so
    # frames from the same instrument share them; re-anchoring at the
    # dither-shifted CRPIX is exact up to the (second-order) variation
    # of the distortion over the dither — far better than dropping the
    # pixel-scale distortion entirely at the field edges
    return TanWCS(reference_wcs.crval1, reference_wcs.crval2,
                  new_crpix[0], new_crpix[1], cd_new,
                  sip_a=reference_wcs.sip_a, sip_b=reference_wcs.sip_b,
                  sip_ap=reference_wcs.sip_ap,
                  sip_bp=reference_wcs.sip_bp), matches


def alternate_plate_solve_adapt_ref():
    """Pipeline task (strategy 'adapt_wcs_from_reference')."""
    user_config = get_user_config()
    workdir = user_config["workdir"]
    logger = logging.getLogger(
        "lightcurver.alternate_plate_solving_adapt_existing_wcs")

    ref_id_cfg = user_config["reference_frame_for_wcs"]
    if ref_id_cfg is not None:
        rows = execute_sqlite_query(
            "SELECT image_relpath, sources_relpath, id FROM frames "
            "WHERE id = ?", params=(ref_id_cfg,))
    else:
        rows = execute_sqlite_query(
            "SELECT image_relpath, sources_relpath, id FROM frames "
            "WHERE plate_solved = 1 LIMIT 1")
    if not rows:
        raise RuntimeError(
            "No reference frame with a WCS available to adapt from: "
            + (f"reference_frame_for_wcs={ref_id_cfg} does not match any "
               "imported frame." if ref_id_cfg is not None else
               "no frame is plate-solved yet. Solve one frame first or "
               "set reference_frame_for_wcs."))
    frame_relpath, sources_relpath, ref_id = rows[0]

    _, header = read_fits(workdir / frame_relpath, header_only=True)
    reference_wcs = TanWCS.from_header(header)
    ref_sources = read_sources(workdir / sources_relpath)
    reference_xy = ref_sources[["x", "y"]].to_numpy()
    logger.info(f"Aligning WCS of frame {frame_relpath} "
                f"({len(reference_xy)} sources) onto unsolved frames.")

    frames = select_frames_needing_plate_solving(user_config, logger)
    for _, frame in frames.iterrows():
        if frame["id"] == ref_id:
            continue
        target_xy = read_sources(
            workdir / frame["sources_relpath"])[["x", "y"]].to_numpy()
        try:
            wcs_new, _ = adapt_wcs(reference_wcs, reference_xy, target_xy)
            success = True
        except Exception as e:
            logger.warning(f"Frame {frame['id']}: could not adapt WCS: {e}")
            success = False

        if success:
            path = workdir / frame["image_relpath"]
            data, target_header = read_fits(path)
            strip_wcs_cards(target_header)
            target_header.update(wcs_new.to_header_cards())
            write_fits(path, data, target_header)
            post_plate_solve_steps(frame_path=path,
                                   user_config=user_config,
                                   frame_id=frame["id"])
        execute_sqlite_query(
            "UPDATE frames SET plate_solved = ?, attempted_plate_solve = 1 "
            "WHERE id = ?",
            params=(1 if success else 0, frame["id"]), is_select=False)
