"""Pan-STARRS magnitudes for the absolute calibration (MAST cone search): a
copy of ``lightcurver_tpu/utilities/absolute_magnitudes_from_panstarrs.py``.

The public MAST PS1 catalogue HTTP API is queried with the standard
library; the results go through the detection-cluster heuristic and the
grizy and composite-band logic.

Offline: set ``LIGHTCURVER_PANSTARRS_FIXTURE`` to a CSV with the PS1
mean-object columns, and no query is made. pandas is imported by the
functions that use it.
"""

import json
import logging
import os
import urllib.parse
import urllib.request

import numpy as np

from ..structure.database import execute_sqlite_query
from ..structure.user_config import get_user_config

PS1_API_URL = "https://catalogs.mast.stsci.edu/api/v0.1/panstarrs/dr1/mean"


def save_panstarrs_catalog_photometry_to_database(gaia_id):
    """Fetch and store the configured Pan-STARRS band magnitude of a star."""
    logger = logging.getLogger(
        "lightcurver.save_panstarrs_catalog_photometry_to_database")
    already = execute_sqlite_query(
        """SELECT COUNT(*) FROM catalog_star_photometry
           WHERE star_gaia_id = ? AND catalog = 'panstarrs'""",
        (gaia_id,))[0][0]
    if already > 0:
        return

    results = search_panstarrs_around_coordinates(gaia_id)
    mag_dict = photometric_selection_heuristic(results)
    if mag_dict is None:
        logger.warning(
            f"No relevant Pan-STARRS photometry found for star {gaia_id}.")
        return
    execute_sqlite_query(
        """INSERT OR REPLACE INTO catalog_star_photometry
           (catalog, band, mag, mag_err, original_catalog_id, star_gaia_id)
           VALUES (?, ?, ?, ?, ?, ?)""",
        ("panstarrs", mag_dict["band"], mag_dict["mag"],
         mag_dict["mag_err"], str(mag_dict["catalog_ID"]), gaia_id),
        is_select=False)


def search_panstarrs_around_coordinates(gaia_id, radius_arcsec=1.5):
    """PS1 DR1 mean-object cone search around the star's position."""
    import pandas as pd

    logger = logging.getLogger(
        "lightcurver.search_panstarrs_around_coordinates")
    fixture = os.environ.get("LIGHTCURVER_PANSTARRS_FIXTURE")
    if fixture:
        return pd.read_csv(fixture)

    ra, dec = execute_sqlite_query(
        "SELECT ra, dec FROM stars WHERE gaia_id = ?", (gaia_id,))[0]
    params = urllib.parse.urlencode({
        "ra": ra, "dec": dec, "radius": radius_arcsec / 3600.0,
        "format": "json",
    })
    try:
        with urllib.request.urlopen(f"{PS1_API_URL}?{params}",
                                    timeout=60) as response:
            payload = json.loads(response.read())
        return pd.DataFrame(payload.get("data", []))
    except Exception as e:  # a failed query counts as no result
        logger.warning(f"PanSTARRS query failed for ra={ra}, dec={dec}: "
                       f"{e}. Returning empty result.")
        return pd.DataFrame()


def photometric_selection_heuristic(mast_results):
    """Pick the single clean PS1 detection and the configured band.

    Returns {'band', 'mag', 'mag_err', 'catalog_ID'} or None. The
    composite c and o bands combine g/r and r/i (Tonry et al. 2018, Eq. 2).
    """
    import pandas as pd

    results = pd.DataFrame(mast_results)
    if len(results) > 1 and "nDetections" in results.columns:
        # PS1 sometimes leaves duplicate, barely detected clusters
        max_det = results["nDetections"].max()
        results = results[results["nDetections"] > 0.2 * max_det]
    if len(results) != 1:
        return None
    row = results.iloc[0]

    config = get_user_config()
    band = config["photometric_band"]
    if "panstarrs" not in band:
        raise RuntimeError(
            "Running a Pan-STARRS function but the config band is not a "
            "Pan-STARRS band?")
    band = band.replace("_panstarrs", "")

    def mag_of(b):
        value = row.get(f"{b}MeanPSFMag")
        err = row.get(f"{b}MeanPSFMagErr")
        # PS1's -999 sentinels, and a missing or invalid error, reject the
        # band
        ok = (value is not None and np.isfinite(value) and value > -100
              and err is not None and np.isfinite(err) and err > 0)
        return (float(value), float(err)) if ok else None

    if band in ("g", "r", "i", "z", "y"):
        got = mag_of(band)
        if got is None:
            return None
        mag, mag_err = got
    elif band == "c":
        g, r = mag_of("g"), mag_of("r")
        if g is None or r is None:
            return None
        mag = 0.49 * g[0] + 0.51 * r[0]
        mag_err = 0.49 * g[1] + 0.51 * r[1]
    elif band == "o":
        r, i = mag_of("r"), mag_of("i")
        if r is None or i is None:
            return None
        mag = 0.55 * r[0] + 0.45 * i[0]
        mag_err = 0.55 * r[1] + 0.45 * i[1]
    else:
        raise RuntimeError(f"Unknown Pan-STARRS band: {band}")
    return {"band": band, "mag": mag, "mag_err": mag_err,
            "catalog_ID": row.get("objID", "")}
