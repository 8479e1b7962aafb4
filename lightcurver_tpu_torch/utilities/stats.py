"""Statistics helpers: a copy of ``sigma_clipped_stats`` and ``sigmaclip``
of ``lightcurver_tpu/utilities/stats.py``."""

import numpy as np


def sigma_clipped_stats(data, sigma=3.0, maxiters=5):
    """(mean, median, std) of iteratively sigma-clipped data.

    Clips about the median with the sample std, as astropy's
    ``sigma_clipped_stats`` does by default.
    """
    arr = np.asarray(data, dtype=float)
    arr = arr[np.isfinite(arr)]
    if arr.size == 0:
        return np.nan, np.nan, np.nan
    mask = np.ones(arr.shape, dtype=bool)
    for _ in range(maxiters):
        selected = arr[mask]
        med = np.median(selected)
        std = np.std(selected)
        # clipped points never come back, and convergence is an unchanged
        # mask, not an unchanged count
        new_mask = mask & (np.abs(arr - med) <= sigma * std)
        if new_mask.sum() == 0:
            break
        if np.array_equal(new_mask, mask):
            break
        mask = new_mask
    selected = arr[mask]
    return float(np.mean(selected)), float(np.median(selected)), \
        float(np.std(selected))


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
