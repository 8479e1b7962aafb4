"""Gaia colour transforms for the absolute calibration: a copy of
``lightcurver_tpu/utilities/absolute_magnitudes_from_gaia.py``.

The (BP-RP) polynomial relations of the Gaia EDR3 documentation (tables
5.6 and 5.7 of the CU5 photometric-system chapter):
band_mag = G - sum_i c_i (BP-RP)^i, with a nominal scatter of 0.03 mag.
"""

import math

from ..structure.database import execute_sqlite_query
from ..structure.user_config import get_user_config

GAIA_COLOR_COEFFICIENTS = {
    "r_sdss": [-0.09837, 0.08592, 0.1907, -0.1701, 0.02263],
    "i_sdss": [-0.293, 0.6404, -0.09609, -0.002104],
    "g_sdss": [0.2199, -0.6365, -0.1548, 0.0064],
    "V": [-0.02704, 0.01424, -0.2156, 0.01426],
    "R": [-0.02275, 0.3961, -0.1243, -0.01396, 0.003775],
    "Ic": [0.01753, 0.76, -0.0991],
    "V_T": [-0.01077, -0.0682, -0.2387, 0.02342],
    "B_T": [-0.004288, -0.8547, 0.1244, -0.9085, 0.4843, -0.06814],
}

NOMINAL_MAG_ERROR = 0.03  # scatter of the colour relations


def save_gaia_catalog_photometry_to_database(gaia_id):
    """Compute and store the configured band's magnitude for one star."""
    user_config = get_user_config()
    band = user_config["photometric_band"]
    if band not in GAIA_COLOR_COEFFICIENTS:
        raise ValueError(
            f"Unsupported band. Choose among "
            f"{list(GAIA_COLOR_COEFFICIENTS.keys())}.")

    mags = execute_sqlite_query(
        """SELECT gaia_id, gmag, bmag, rmag FROM stars
           WHERE gaia_id = ? LIMIT 1""",
        (gaia_id,), use_pandas=True)
    if mags.empty:
        return
    raw = [mags["gmag"][0], mags["bmag"][0], mags["rmag"][0]]
    # a star without BP/RP photometry (NULL, or NaN) cannot be
    # colour-transformed: store nothing rather than a NaN row
    if any(v is None or not math.isfinite(float(v)) for v in raw):
        return
    g, bmag, rmag = (float(v) for v in raw)
    bp_rp = bmag - rmag
    coef = GAIA_COLOR_COEFFICIENTS[band]
    band_mag = g - sum(c * bp_rp**i for i, c in enumerate(coef))

    execute_sqlite_query(
        """INSERT OR REPLACE INTO catalog_star_photometry
           (catalog, band, mag, mag_err, original_catalog_id, star_gaia_id)
           VALUES (?, ?, ?, ?, ?, ?)""",
        ("gaia", band, band_mag, NOMINAL_MAG_ERROR, gaia_id, gaia_id),
        is_select=False)
