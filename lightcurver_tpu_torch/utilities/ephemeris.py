"""Low-precision solar and lunar ephemeris and alt-az transforms: a copy of
``lightcurver_tpu/utilities/ephemeris.py``.

The Astronomical Almanac / Meeus low-precision series: the Sun to ~0.01
deg, the Moon to ~0.3 deg, enough for the frames' data-quality columns
(airmass, moon distance and phase, sun altitude). All angles degrees,
times MJD (UTC; TT-UTC is negligible at this precision).
"""

import math


DEG = math.pi / 180.0


def _rev(angle_deg):
    return angle_deg % 360.0


def julian_centuries(mjd):
    """Julian centuries since J2000.0."""
    return (mjd - 51544.5) / 36525.0


def gmst_deg(mjd):
    """Greenwich mean sidereal time, degrees."""
    d = mjd - 51544.5
    return _rev(280.46061837 + 360.98564736629 * d)


def obliquity_deg(mjd):
    return 23.4392911 - 0.0130042 * julian_centuries(mjd)


def ecliptic_to_equatorial(lon_deg, lat_deg, mjd):
    """Ecliptic (lambda, beta) -> equatorial (ra, dec), degrees."""
    eps = obliquity_deg(mjd) * DEG
    lam, bet = lon_deg * DEG, lat_deg * DEG
    sin_dec = (math.sin(bet) * math.cos(eps)
               + math.cos(bet) * math.sin(eps) * math.sin(lam))
    dec = math.asin(max(-1.0, min(1.0, sin_dec)))
    ra = math.atan2(
        math.sin(lam) * math.cos(eps) - math.tan(bet) * math.sin(eps),
        math.cos(lam))
    return _rev(ra / DEG), dec / DEG


def sun_position(mjd):
    """Apparent geocentric (ra, dec, ecliptic longitude) of the Sun, deg."""
    n = mjd - 51544.5
    L = _rev(280.460 + 0.9856474 * n)
    g = _rev(357.528 + 0.9856003 * n) * DEG
    lam = L + 1.915 * math.sin(g) + 0.020 * math.sin(2 * g)
    ra, dec = ecliptic_to_equatorial(lam, 0.0, mjd)
    return ra, dec, _rev(lam)


def moon_position(mjd, lat_deg=None, lon_deg_east=None):
    """Approximate (ra, dec, lambda, beta) of the Moon, degrees.

    Truncated ELP series (Astronomical Almanac low-precision formula).
    With an observer position the returned ra/dec are TOPOCENTRIC —
    lunar horizontal parallax reaches ~57 arcmin, so the geocentric
    direction (which pyephem, the reference's engine, corrects for) can
    be ~1 deg off near the horizon.  lambda/beta stay geocentric (they
    feed the illumination phase, which is a geocentric quantity).
    """
    T = julian_centuries(mjd)
    lam = (218.32 + 481267.881 * T
           + 6.29 * math.sin((135.0 + 477198.87 * T) * DEG)
           - 1.27 * math.sin((259.3 - 413335.36 * T) * DEG)
           + 0.66 * math.sin((235.7 + 890534.22 * T) * DEG)
           + 0.21 * math.sin((269.9 + 954397.74 * T) * DEG)
           - 0.19 * math.sin((357.5 + 35999.05 * T) * DEG)
           - 0.11 * math.sin((186.5 + 966404.03 * T) * DEG))
    bet = (5.13 * math.sin((93.3 + 483202.02 * T) * DEG)
           + 0.28 * math.sin((228.2 + 960400.89 * T) * DEG)
           - 0.28 * math.sin((318.3 + 6003.15 * T) * DEG)
           - 0.17 * math.sin((217.6 - 407332.21 * T) * DEG))
    lam, bet = _rev(lam), bet
    ra, dec = ecliptic_to_equatorial(lam, bet, mjd)
    if lat_deg is not None and lon_deg_east is not None:
        # horizontal parallax series (same Almanac formula family)
        par = (0.9508
               + 0.0518 * math.cos((134.9 + 477198.85 * T) * DEG)
               + 0.0095 * math.cos((259.2 - 413335.38 * T) * DEG)
               + 0.0078 * math.cos((235.7 + 890534.23 * T) * DEG)
               + 0.0028 * math.cos((269.9 + 954397.70 * T) * DEG))
        r = 1.0 / math.sin(par * DEG)          # Earth radii
        lst = (gmst_deg(mjd) + lon_deg_east) * DEG
        lat = lat_deg * DEG
        obs = (math.cos(lat) * math.cos(lst),
               math.cos(lat) * math.sin(lst),
               math.sin(lat))
        ra_r, dec_r = ra * DEG, dec * DEG
        vec = (r * math.cos(dec_r) * math.cos(ra_r) - obs[0],
               r * math.cos(dec_r) * math.sin(ra_r) - obs[1],
               r * math.sin(dec_r) - obs[2])
        norm = math.sqrt(sum(v * v for v in vec))
        dec = math.asin(vec[2] / norm) / DEG
        ra = _rev(math.atan2(vec[1], vec[0]) / DEG)
    return ra, dec, lam, bet


def moon_illumination_percent(mjd):
    """Illuminated fraction of the Moon's disk, percent (pyephem's .phase)."""
    _, _, lam_m, bet_m = moon_position(mjd)
    _, _, lam_s = sun_position(mjd)
    # elongation psi between sun and moon
    cos_psi = (math.cos(bet_m * DEG)
               * math.cos((lam_m - lam_s) * DEG))
    return 100.0 * 0.5 * (1.0 - cos_psi)


def radec_to_altaz(ra_deg, dec_deg, mjd, lat_deg, lon_deg_east):
    """Equatorial -> horizontal coordinates.

    Returns (altitude, azimuth) in degrees; azimuth from North, eastward.
    """
    lst = gmst_deg(mjd) + lon_deg_east
    H = (lst - ra_deg) * DEG
    lat = lat_deg * DEG
    dec = dec_deg * DEG
    sin_alt = (math.sin(lat) * math.sin(dec)
               + math.cos(lat) * math.cos(dec) * math.cos(H))
    alt = math.asin(max(-1.0, min(1.0, sin_alt)))
    az = math.atan2(
        -math.cos(dec) * math.sin(H),
        math.sin(dec) * math.cos(lat)
        - math.cos(dec) * math.cos(H) * math.sin(lat))
    return alt / DEG, _rev(az / DEG)


def angular_separation(ra1, dec1, ra2, dec2):
    """Great-circle separation in degrees."""
    from .coordinates import angular_separation_deg

    return float(angular_separation_deg(ra1, dec1, ra2, dec2))
