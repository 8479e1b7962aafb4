"""Frame importation: read a raw FITS, calibrate, characterize, register:
a copy of ``lightcurver_tpu/processes/frame_importation.py``.

Per frame: read and trim; ADU -> e-/s with the user header parser's gain
and exptime; the background model; the calibrated float32 frame written
to $workdir/frames; the sources extracted (a CSV beside the frame); seeing
and ellipticity; the ephemeris columns; the frames row inserted. The
writes rely on WAL and a busy timeout (``structure/database.py``).
"""

import logging
from pathlib import Path

import numpy as np

from ..io.fits import read_fits, read_fits_header_many, write_fits
from ..io.wcs import strip_wcs_cards
from ..structure.user_header_parser import load_custom_header_parser
from ..structure.database import execute_sqlite_query
from .background_estimation import subtract_background
from .star_extraction import extract_stars, write_sources
from .frame_characterization import ephemeris, estimate_seeing


def process_new_frame(fits_file, user_config):
    """Import one raw frame into the workdir + database."""
    logger = logging.getLogger("lightcurver.importation")
    fits_file = Path(fits_file)
    copied_image_relpath = Path("frames") / f"{fits_file.stem}.fits"

    trim_v = user_config.get("trim_vertical", 0) or 0
    trim_h = user_config.get("trim_horizontal", 0) or 0
    # memmap with an eager fallback: the trim slice below then reads only
    # the pages of a mosaic that it needs
    try:
        data, _ = read_fits(fits_file,
                            hdu_index=user_config["hdu_data_index"],
                            memmap=True)
    except Exception:
        logger.warning(f"memmap read failed for {fits_file}; "
                       "falling back to an eager read.")
        data, _ = read_fits(fits_file,
                            hdu_index=user_config["hdu_data_index"])
    header = read_fits_header_many(fits_file,
                                   user_config["hdu_header_indexes"])
    ny, nx = data.shape
    data = np.asarray(data[trim_v:ny - trim_v or None,
                           trim_h:nx - trim_h or None], dtype=np.float64)
    if trim_h or trim_v:
        # cropping moves the WCS reference pixel; check each axis card
        # independently (merged multi-HDU headers can carry only one)
        if "CRPIX1" in header:
            header["CRPIX1"] = float(header["CRPIX1"]) - trim_h
        if "CRPIX2" in header:
            header["CRPIX2"] = float(header["CRPIX2"]) - trim_v
    header["BUNIT"] = "ELPERSEC"

    parsed = load_custom_header_parser()(header)
    mjd, gain, exptime = parsed["mjd"], parsed["gain"], parsed["exptime"]
    data *= gain / exptime  # -> e-/s

    data_sub, bkg = subtract_background(
        data,
        mask_sources_first=user_config["mask_sources_before_background"],
        n_boxes=user_config["background_estimation_n_boxes"])
    if not user_config["do_background_subtraction"]:
        data_sub = data  # bkg still provides the noise statistics
    sky_level = float(bkg.globalback)
    background_rms = float(bkg.globalrms)

    if not user_config["already_plate_solved"]:
        # the plate-solve step will write fresh WCS cards
        strip_wcs_cards(header)
    write_fits(user_config["workdir"] / copied_image_relpath,
               np.asarray(data_sub, dtype=np.float32), header)

    do_plot = user_config.get("source_extraction_do_plots", False)
    plot_path = (user_config["plots_dir"] / "source_extraction"
                 / f"{fits_file.stem}.jpg") if do_plot else None
    variance = background_rms**2 + np.abs(data_sub) / exptime  # (e-/s)^2
    sources = extract_stars(
        data_sub, variance,
        detection_threshold=user_config.get("source_extraction_threshold", 3),
        min_area=user_config.get("source_extraction_min_area", 10),
        debug_plot_path=plot_path)
    sources_relpath = copied_image_relpath.parent / \
        f"{copied_image_relpath.stem}_sources.csv"
    write_sources(sources, user_config["workdir"] / sources_relpath)

    seeing_pixels = estimate_seeing(sources)
    ellipticity = float(np.nanmedian(sources["ellipticity"])) if len(
        sources) else -1.0
    logger.info(f"{fits_file}: {len(sources)} sources, "
                f"seeing {seeing_pixels:.2f} px, "
                f"ellipticity {ellipticity:.2f}.")

    telescope = user_config.get("telescope")
    eph = None
    if telescope:
        eph = ephemeris(mjd=mjd,
                        ra_object=user_config["ROI_ra_deg"],
                        dec_object=user_config["ROI_dec_deg"],
                        telescope_longitude=telescope["longitude"],
                        telescope_latitude=telescope["latitude"],
                        telescope_elevation=telescope["elevation"])
        if eph["weird_astro_conditions"]:
            logger.warning(f"Ephemeris: weird for {fits_file}: "
                           f"{eph['comments']}")
    else:
        logger.warning("No telescope info in config; skipping ephemeris.")

    return add_frame_to_database(
        original_image_path=fits_file,
        copied_image_relpath=copied_image_relpath,
        sources_relpath=sources_relpath, mjd=mjd, gain=gain,
        sky_level_electron_per_second=sky_level,
        background_rms_electron_per_second=background_rms,
        exptime=exptime, seeing_pixels=seeing_pixels,
        ellipticity=ellipticity, user_config=user_config,
        telescope_information=telescope, ephemeris_dictionary=eph)


def add_frame_to_database(original_image_path, copied_image_relpath,
                          sources_relpath, mjd, gain,
                          sky_level_electron_per_second,
                          background_rms_electron_per_second, exptime,
                          seeing_pixels, ellipticity, user_config,
                          telescope_information=None,
                          ephemeris_dictionary=None):
    """INSERT the frames row; returns the inserted column->value dict."""
    row = {
        "original_image_path": str(original_image_path),
        "image_relpath": str(copied_image_relpath),
        "sources_relpath": str(sources_relpath),
        "seeing_pixels": seeing_pixels,
        "mjd": mjd,
        "gain": gain,
        "sky_level_electron_per_second": sky_level_electron_per_second,
        "background_rms_electron_per_second":
            background_rms_electron_per_second,
        "exptime": exptime,
        "ellipticity": ellipticity,
    }
    if telescope_information:
        for key, value in telescope_information.items():
            row[f"telescope_{key}"] = value
    if ephemeris_dictionary:
        row["airmass"] = float(
            ephemeris_dictionary["target_info"]["airmass"])
        row["degrees_to_moon"] = \
            ephemeris_dictionary["moon_info"]["distance_deg"]
        row["moon_phase"] = \
            ephemeris_dictionary["moon_info"]["illumination"]
        row["sun_altitude"] = \
            ephemeris_dictionary["sun_info"]["altitude_deg"]
        row["azimuth"] = ephemeris_dictionary["target_info"]["azimuth_deg"]
        row["altitude"] = \
            ephemeris_dictionary["target_info"]["altitude_deg"]

    columns = ", ".join(row)
    marks = ", ".join("?" * len(row))
    execute_sqlite_query(
        f"INSERT INTO frames ({columns}) VALUES ({marks})",
        params=tuple(row.values()), is_select=False)
    return row
