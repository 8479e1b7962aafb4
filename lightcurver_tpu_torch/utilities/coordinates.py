"""Celestial-coordinate helpers: a copy of
``lightcurver_tpu/utilities/coordinates.py``.

Angular separation, proper-motion propagation to an epoch, and a small
ra/dec container. All angles in degrees unless noted.
"""

import math

import numpy as np

DEG = math.pi / 180.0
ARCSEC_PER_DEG = 3600.0


class SkyCoord:
    """ra/dec (degrees) container with astropy-like .separation()."""

    __slots__ = ("ra", "dec")

    def __init__(self, ra, dec):
        self.ra = float(ra)
        self.dec = float(dec)

    def separation_arcsec(self, other):
        return angular_separation_deg(
            self.ra, self.dec, other.ra, other.dec) * ARCSEC_PER_DEG

    def __repr__(self):
        return f"SkyCoord(ra={self.ra}, dec={self.dec})"


def angular_separation_deg(ra1, dec1, ra2, dec2):
    """Great-circle separation in degrees (Vincenty, numerically stable).

    Accepts scalars or numpy arrays (broadcasting).
    """
    l1, b1 = np.asarray(ra1) * DEG, np.asarray(dec1) * DEG
    l2, b2 = np.asarray(ra2) * DEG, np.asarray(dec2) * DEG
    dl = l2 - l1
    num = np.hypot(np.cos(b2) * np.sin(dl),
                   np.cos(b1) * np.sin(b2)
                   - np.sin(b1) * np.cos(b2) * np.cos(dl))
    den = np.sin(b1) * np.sin(b2) + np.cos(b1) * np.cos(b2) * np.cos(dl)
    return np.arctan2(num, den) / DEG


def apply_proper_motion(ra, dec, pmra_masyr, pmdec_masyr, ref_epoch_jyear,
                        target_mjd):
    """Propagate catalog positions to a frame's epoch.

    Args:
        ra, dec: catalog position, degrees.
        pmra_masyr: proper motion in RA *including* the cos(dec) factor
            (Gaia convention), mas/yr.
        pmdec_masyr: proper motion in Dec, mas/yr.
        ref_epoch_jyear: catalog reference epoch (e.g. 2016.0 for Gaia DR3).
        target_mjd: observation epoch, MJD.

    Returns:
        (ra, dec) at the target epoch, degrees.

    Mirrors the correction the reference applies with astropy at
    processes/cutout_making.py:229-237.
    """
    ra = np.asarray(ra, dtype=float)
    dec = np.asarray(dec, dtype=float)
    pmra = np.nan_to_num(np.asarray(pmra_masyr, dtype=float))
    pmdec = np.nan_to_num(np.asarray(pmdec_masyr, dtype=float))
    # MJD -> Julian year: J2000.0 = MJD 51544.5
    target_jyear = 2000.0 + (np.asarray(target_mjd, dtype=float)
                             - 51544.5) / 365.25
    dt = target_jyear - np.asarray(ref_epoch_jyear, dtype=float)
    mas2deg = 1.0 / (1000.0 * ARCSEC_PER_DEG)
    dec_new = dec + pmdec * dt * mas2deg
    cosd = np.cos(np.asarray(dec) * DEG)
    cosd = np.where(np.abs(cosd) < 1e-9, 1e-9, cosd)
    ra_new = ra + pmra * dt * mas2deg / cosd
    return ra_new, dec_new


def mjd_to_jyear(mjd):
    return 2000.0 + (float(mjd) - 51544.5) / 365.25
