"""Celestial coordinates: a copy of the ``SkyCoord`` container of
``lightcurver_tpu/utilities/coordinates.py`` (the part the user config
needs). Angles in degrees."""


class SkyCoord:
    """ra/dec (degrees) container."""

    __slots__ = ("ra", "dec")

    def __init__(self, ra, dec):
        self.ra = float(ra)
        self.dec = float(dec)

    def __repr__(self):
        return f"SkyCoord(ra={self.ra}, dec={self.dec})"
