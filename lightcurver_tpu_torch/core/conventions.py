"""Grid and coordinate conventions (twin of ``lightcurver_tpu/core/conventions.py``).

- A data stamp is ``(n, n)``; the fine (model) grid is ``(m, m)`` with
  ``m = n * s`` for the integer subsampling factor ``s``.
- Coordinates are in DATA pixels with the origin at the image centre:
  data pixel (row i, col j) sits at ``x = j - (n - 1) / 2``,
  ``y = i - (n - 1) / 2``; fine pixel (I, J) at
  ``x = (J - (m - 1) / 2) / s``, ``y = (I - (m - 1) / 2) / s``.
- The target-resolution kernel ``r`` is a unit-integral isotropic
  Gaussian of FWHM ``TARGET_FWHM_FINE_PIX`` fine pixels.
"""

import math

# FWHM of the target-resolution Gaussian r, in FINE pixels.
TARGET_FWHM_FINE_PIX = 2.0

# FWHM = 2*sqrt(2*ln 2) * sigma
_FWHM_OVER_SIGMA = 2.0 * math.sqrt(2.0 * math.log(2.0))


def fwhm_to_sigma(fwhm):
    """Convert a Gaussian FWHM to its standard deviation (same units)."""
    return fwhm / _FWHM_OVER_SIGMA


def sigma_to_fwhm(sigma):
    """Convert a Gaussian standard deviation to its FWHM (same units)."""
    return sigma * _FWHM_OVER_SIGMA
