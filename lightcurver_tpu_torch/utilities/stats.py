"""Statistics helpers: a copy of ``sigmaclip`` of
``lightcurver_tpu/utilities/stats.py``."""

import numpy as np


def sigmaclip(data, low=4.0, high=4.0):
    """scipy.stats.sigmaclip-compatible: iterative clip about the MEAN.

    Returns (clipped_array, lower_bound, upper_bound).
    """
    arr = np.asarray(data, dtype=float).ravel()
    prev = -1
    lo = hi = np.nan
    # an empty input would warn on the empty mean below
    while arr.size != prev and arr.size > 0:
        prev = arr.size
        mean, std = arr.mean(), arr.std()
        lo, hi = mean - low * std, mean + high * std
        arr = arr[(arr >= lo) & (arr <= hi)]
    return arr, lo, hi
