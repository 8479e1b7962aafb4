"""Absolute zeropoints per frame from catalogue star magnitudes: the port
of the JAX pipeline task ``lightcurver_tpu/processes/
absolute_zeropoint_calculation.py::calculate_zeropoints``.

zp = median(catalog_mag - instrumental_mag) over a frame's stars, its
uncertainty their std. The catalogue magnitudes come from the Gaia colour
transforms or from Pan-STARRS, chosen by the configured band.
"""

import numpy as np

from ..structure.database import (execute_sqlite_query, executemany_sqlite,
                                  get_pandas)
from ..structure.user_config import get_user_config
from ..utilities.absolute_magnitudes_from_gaia import \
    save_gaia_catalog_photometry_to_database
from ..utilities.absolute_magnitudes_from_panstarrs import \
    save_panstarrs_catalog_photometry_to_database
from ..utilities.footprint import get_combined_footprint_hash

magnitude_calculation_functions = {
    "gaia": save_gaia_catalog_photometry_to_database,
    "panstarrs": save_panstarrs_catalog_photometry_to_database,
}


def get_gaia_ids_with_flux_in_frame(combined_footprint_hash):
    """Stars that have at least one measured flux in this footprint."""
    rows = execute_sqlite_query(
        """SELECT DISTINCT star_gaia_id FROM star_flux_in_frame
           WHERE combined_footprint_hash = ?""",
        (combined_footprint_hash,))
    return [row[0] for row in rows]


def calculate_zeropoints():
    """Pipeline task: per-frame absolute zeropoints."""
    user_config = get_user_config()
    frames_ini = get_pandas(
        columns=["id"],
        conditions=["plate_solved = 1", "eliminated = 0",
                    "roi_in_footprint = 1"])
    footprint_hash = get_combined_footprint_hash(
        user_config, frames_ini["id"].to_list())

    source_catalog = user_config["reference_absolute_photometric_survey"]
    absolute_mag_func = magnitude_calculation_functions[source_catalog]
    for gaia_id in get_gaia_ids_with_flux_in_frame(footprint_hash):
        absolute_mag_func(gaia_id)

    flux_data = execute_sqlite_query(
        """SELECT sff.frame_id, sff.flux, s.gaia_id,
                  csp.mag as catalog_mag
           FROM star_flux_in_frame sff
           JOIN stars s ON sff.star_gaia_id = s.gaia_id
                AND s.combined_footprint_hash = sff.combined_footprint_hash
           JOIN frames f ON f.id = sff.frame_id
           JOIN catalog_star_photometry csp
                ON csp.star_gaia_id = s.gaia_id
           WHERE sff.combined_footprint_hash = ? AND csp.catalog = ?""",
        params=(footprint_hash, source_catalog), use_pandas=True)
    if flux_data.empty:
        return

    flux_data["instrumental_mag"] = -2.5 * np.log10(flux_data["flux"])
    flux_data["mag_difference"] = (flux_data["catalog_mag"]
                                   - flux_data["instrumental_mag"])
    zp = flux_data.groupby("frame_id")["mag_difference"].agg(
        ["median", "std"]).reset_index()

    executemany_sqlite(
        """INSERT INTO absolute_zeropoints (frame_id,
           combined_footprint_hash, zeropoint, zeropoint_uncertainty,
           source_catalog) VALUES (?, ?, ?, ?, ?)
           ON CONFLICT(frame_id, combined_footprint_hash) DO UPDATE SET
           zeropoint = excluded.zeropoint,
           zeropoint_uncertainty = excluded.zeropoint_uncertainty""",
        [(int(row["frame_id"]), footprint_hash, float(row["median"]),
          float(row["std"]) if np.isfinite(row["std"]) else 0.1,
          source_catalog) for _, row in zp.iterrows()])
