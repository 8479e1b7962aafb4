"""Reference-star selection, the Gaia query, naming, the DB insert and the
frame assignment: a copy of ``lightcurver_tpu/processes/star_querying.py``.

Three selection strategies (common_footprint_stars, stars_per_frame,
ROI_disk), the config's quality cuts, the minimum-count check, names by
ascending distance to the ROI, the stars_in_frames rows, and the
diagnostic plot of the footprints with the stars. pandas is imported when
the task runs, matplotlib when the plot is made.
"""

import json
import logging

import numpy as np

from ..utilities.footprint import (load_combined_footprint_from_db,
                                   get_combined_footprint_hash)
from ..structure.user_config import get_user_config
from ..structure.database import (get_pandas, execute_sqlite_query,
                                  executemany_sqlite)
from ..utilities.gaia import find_gaia_stars
from ..utilities.star_naming import generate_star_names
from ..utilities.coordinates import angular_separation_deg
from .frame_star_assignment import populate_stars_in_frames


def query_gaia_stars():
    """Pipeline task: fetch + register the reference stars."""
    logger = logging.getLogger("lightcurver.querying_ref_stars_from_gaia")
    user_config = get_user_config()
    # hash over the SAME frame set every downstream task uses
    # (cutouts/PSFs/photometry all hash plate_solved + not eliminated +
    # roi_in_footprint; the reference hashes 'eliminated != 1' here —
    # reference processes/star_querying.py:28 — which desynchronizes
    # the star registry from downstream whenever a frame failed plate
    # solving within the tolerated success fraction)
    frames_info = get_pandas(columns=["id", "pixel_scale"],
                             conditions=["frames.plate_solved = 1",
                                         "frames.eliminated != 1",
                                         "frames.roi_in_footprint = 1"])
    frames_hash = get_combined_footprint_hash(
        user_config, frames_info["id"].to_list())

    count = execute_sqlite_query(
        "SELECT COUNT(*) FROM stars WHERE combined_footprint_hash = ?",
        params=(frames_hash,))[0][0]
    if count > 0 and not user_config["gaia_query_redo"]:
        logger.info(f"Gaia stars already fetched for footprint "
                    f"{frames_hash}; re-running frame assignment only.")
        populate_stars_in_frames()
        return
    if count > 0 and user_config["gaia_query_redo"]:
        execute_sqlite_query(
            "DELETE FROM stars WHERE combined_footprint_hash = ?",
            params=(frames_hash,), is_select=False)
        logger.info("Deleted previously queried stars (redo).")

    strategy = user_config["star_selection_strategy"]
    if strategy == "common_footprint_stars":
        _, common = load_combined_footprint_from_db(frames_hash,
                                                    missing_ok=False)
        if not common:
            # stored as [] when the frames share no area (footprint.py)
            raise RuntimeError(
                "The frames share NO common footprint — cannot select "
                "stars with strategy 'common_footprint_stars'. Check "
                "the pointings (eliminate outliers) or switch to the "
                "'stars_per_frame' / 'ROI_disk' strategy.")
        region_type, region = "polygon", common["coordinates"][0]
    elif strategy == "stars_per_frame":
        largest, _ = load_combined_footprint_from_db(frames_hash,
                                                     missing_ok=False)
        region_type, region = "polygon", largest["coordinates"][0]
    elif strategy == "ROI_disk":
        region_type = "circle"
        region = {"center": (user_config["ROI_ra_deg"],
                             user_config["ROI_dec_deg"]),
                  "radius": user_config["ROI_disk_radius_arcseconds"]
                  / 3600.0}
    else:
        raise RuntimeError("Not an agreed upon strategy for star "
                           f"selection: {strategy}")

    stars = find_gaia_stars(
        region_type, region,
        gaia_provider=user_config["gaia_provider"],
        astrometric_excess_noise_max=user_config[
            "star_max_astrometric_excess_noise"],
        gmag_range=(user_config["star_min_gmag"],
                    user_config["star_max_gmag"]),
        min_phot_g_mean_flux_over_error=user_config[
            "min_phot_g_mean_flux_over_error"])

    enough = len(stars) >= user_config["min_number_stars"]
    message = (f"Too few stars compared to the config criterion! "
               f"Only {len(stars)} stars available.")
    if not enough:
        logger.error(message + " Force stopping.")
        # a hard error, not an assert: under python -O the run would
        # continue and register an inadequate star set
        raise RuntimeError(message)

    stars = stars.copy()
    stars["distance_to_roi"] = 3600.0 * angular_separation_deg(
        stars["ra"], stars["dec"],
        user_config["ROI_ra_deg"], user_config["ROI_dec_deg"])
    # never use the ROI itself as a reference
    stars = stars[stars["distance_to_roi"] > user_config["ROI_size"]]
    stars = stars.sort_values("distance_to_roi").reset_index(drop=True)
    stars["name"] = generate_star_names(len(stars))

    insert = ("INSERT INTO stars (combined_footprint_hash, name, ra, dec, "
              "gmag, rmag, bmag, pmra, pmdec, ref_epoch, gaia_id, "
              "distance_to_roi_arcsec) VALUES "
              "(?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)")
    executemany_sqlite(insert, [(
        frames_hash, star["name"], float(star["ra"]),
        float(star["dec"]), float(star["phot_g_mean_mag"]),
        float(star["phot_rp_mean_mag"]),
        float(star["phot_bp_mean_mag"]),
        float(np.nan_to_num(star["pmra"])),
        float(np.nan_to_num(star["pmdec"])),
        float(star["ref_epoch"]), str(int(star["source_id"])),
        float(star["distance_to_roi"]))
        for _, star in stars.iterrows()])

    logger.info("Calculating which star is in which frame.")
    populate_stars_in_frames()

    import pandas as pd

    # diagnostic plot: frame footprints + star positions
    rows = execute_sqlite_query(
        """SELECT frames.id, footprints.polygon FROM footprints
           JOIN frames ON footprints.frame_id = frames.id
           WHERE frames.eliminated != 1""")
    polygons = [np.array(json.loads(r[1])) for r in rows]
    roi_row = pd.DataFrame([{"name": "roi",
                             "ra": user_config["ROI_ra_deg"],
                             "dec": user_config["ROI_dec_deg"]}])
    plot_stars = pd.concat([stars, roi_row], ignore_index=True)
    save_path = user_config["plots_dir"] / "footprints_with_gaia_stars.jpg"
    try:
        from ..plotting.sources_plotting import plot_footprints_with_stars

        plot_footprints_with_stars(footprint_arrays=polygons,
                                   stars=plot_stars, save_path=save_path)
        logger.info(f"Footprint/star plot saved at {save_path}.")
    except Exception as e:  # plots must never kill the pipeline
        logger.warning(f"Could not produce footprint plot: {e}")
