"""Frame quality characterization, airmass, ephemeris columns and seeing:
a copy of ``lightcurver_tpu/processes/frame_characterization.py``, on the
port's ephemeris (``utilities/ephemeris.py``).
"""

import numpy as np

from ..utilities import ephemeris as eph


def calculate_airmass(altitude_degrees):
    """Rozenberg's empirical airmass relation.

    X = 1 / (sin h + 0.025 exp(-11 sin h)); valid to the horizon (X=40).
    Returns -1.0 below the horizon and -2.0 above 90 deg (the reference's
    sentinel convention, frame_characterization.py:8-42).
    """
    alt = np.radians(np.asarray(altitude_degrees, dtype=float))
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        return np.where(
            alt < 0, -1.0,
            np.where(alt > np.pi / 2, -2.0,
                     1.0 / (np.sin(alt)
                            + 0.025 * np.exp(-11.0 * np.sin(alt)))))


def ephemeris(mjd, ra_object, dec_object, telescope_longitude,
              telescope_latitude, telescope_elevation):
    """Observing-conditions bundle for one frame.

    Returns a dict with 'weird_astro_conditions', 'comments',
    'target_info' {altitude_deg, azimuth_deg, airmass, moon_dist},
    'moon_info' {distance_deg, illumination, altitude_deg},
    'sun_info' {altitude_deg} — the reference's contract
    (frame_characterization.py:45-132).  Elevation is accepted for
    signature parity (horizontal-coordinate effect is negligible at this
    precision).
    """
    del telescope_elevation
    results = {
        "weird_astro_conditions": False,
        "comments": "",
        "target_info": {},
        "moon_info": {},
        "sun_info": {},
    }

    target_alt, target_az = eph.radec_to_altaz(
        ra_object, dec_object, mjd, telescope_latitude, telescope_longitude)
    airmass = float(calculate_airmass(target_alt))
    if airmass < 1.0 or airmass > 5.0:
        results["weird_astro_conditions"] = True
        results["comments"] += (f"Target altitude: {target_alt:.2f} degrees "
                                f"(airmass {airmass:.2f}).")

    # topocentric: lunar parallax reaches ~1 deg near the horizon
    moon_ra, moon_dec, _, _ = eph.moon_position(
        mjd, telescope_latitude, telescope_longitude)
    moon_alt, _ = eph.radec_to_altaz(moon_ra, moon_dec, mjd,
                                     telescope_latitude,
                                     telescope_longitude)
    moon_dist = eph.angular_separation(moon_ra, moon_dec, ra_object,
                                       dec_object)
    moon_illum = eph.moon_illumination_percent(mjd)

    sun_ra, sun_dec, _ = eph.sun_position(mjd)
    sun_alt, _ = eph.radec_to_altaz(sun_ra, sun_dec, mjd,
                                    telescope_latitude, telescope_longitude)
    if sun_alt > 0.0:
        results["weird_astro_conditions"] = True
        results["comments"] += f" Sun altitude: {sun_alt:.2f} degrees."

    results["target_info"] = {"altitude_deg": target_alt,
                              "azimuth_deg": target_az,
                              "airmass": airmass,
                              "moon_dist": moon_dist}
    results["moon_info"] = {"distance_deg": moon_dist,
                            "illumination": moon_illum,
                            "altitude_deg": moon_alt}
    results["sun_info"] = {"altitude_deg": sun_alt}
    return results


def estimate_seeing(sources_table):
    """Histogram-peak seeing estimate (pixels) from extracted sources.

    COSMOULINE-heritage algorithm, as kept by the reference
    (frame_characterization.py:135-202): build a coarse FWHM histogram in
    [1.5, min(3*median, 30)], refine a +/-2 px histogram around its peak,
    then take the median of FWHMs within +/-1 px of the refined peak.
    Falls back to the plain median for <= 10 detections; -1.0 when empty.
    """
    fwhms = np.asarray(sources_table["FWHM"], dtype=float)
    if fwhms.size == 0:
        return -1.0
    if fwhms.size <= 10:
        return float(np.median(fwhms))

    lo = 1.5
    med = max(float(np.median(fwhms)), lo)
    hi = min(3.0 * med, 30.0)
    hist, edges = np.histogram(fwhms, bins=10, range=(lo, hi))
    peak_bin = int(np.argmax(hist))
    if peak_bin in (0, len(hist) - 1):
        return float(np.median(fwhms))

    center = 0.5 * (edges[peak_bin] + edges[peak_bin + 1])
    hist, edges = np.histogram(fwhms, bins=10,
                               range=(center - 2.0, center + 2.0))
    peak_bin = int(np.argmax(hist))
    center = 0.5 * (edges[peak_bin] + edges[peak_bin + 1])
    near_peak = fwhms[(fwhms > center - 1.0) & (fwhms < center + 1.0)]
    return float(np.median(near_peak)) if near_peak.size else float(center)
