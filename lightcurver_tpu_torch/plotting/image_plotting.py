"""Basic image display helpers: a copy of
``lightcurver_tpu/plotting/image_plotting.py``."""

import numpy as np

from . import pyplot


def zscale_limits(image, contrast=0.25, n_samples=1000):
    """ZScale-like limits: robust linear fit of the sorted sample."""
    arr = np.asarray(image, dtype=float).ravel()
    arr = arr[np.isfinite(arr)]
    if arr.size == 0:
        return 0.0, 1.0
    sample = np.sort(arr[np.linspace(0, arr.size - 1, min(
        n_samples, arr.size)).astype(int)])
    n = sample.size
    x = np.arange(n)
    # iterative straight-line fit with clipping
    keep = np.ones(n, dtype=bool)
    slope, intercept = 0.0, float(np.median(sample))
    for _ in range(5):
        if keep.sum() < 5:
            break
        slope, intercept = np.polyfit(x[keep], sample[keep], 1)
        resid = sample - (slope * x + intercept)
        sigma = resid[keep].std()
        keep = np.abs(resid) <= 2.5 * sigma
    mid = n / 2.0
    med = float(np.median(sample))
    vmin = med + (slope / max(contrast, 1e-3)) * (0 - mid)
    vmax = med + (slope / max(contrast, 1e-3)) * (n - 1 - mid)
    return vmin, vmax


def asinh_stretch(image, a=0.1):
    arr = np.asarray(image, dtype=float)
    lo, hi = np.nanmin(arr), np.nanmax(arr)
    if hi <= lo:
        return np.zeros_like(arr)
    norm = (arr - lo) / (hi - lo)
    return np.arcsinh(norm / a) / np.arcsinh(1.0 / a)


def plot_image(image, save_path=None, ax=None, colorbar=False,
               stretch="zscale", title=None):
    """Display one image with zscale or asinh stretch."""
    plt = pyplot()
    created = ax is None
    if created:
        fig, ax = plt.subplots(figsize=(6, 6))
    if stretch == "zscale":
        vmin, vmax = zscale_limits(image)
        im = ax.imshow(image, origin="lower", vmin=vmin, vmax=vmax,
                       cmap="viridis")
    else:
        im = ax.imshow(asinh_stretch(image), origin="lower",
                       cmap="viridis")
    if title:
        ax.set_title(title)
    if colorbar:
        plt.colorbar(im, ax=ax, fraction=0.046)
    if created and save_path is not None:
        plt.tight_layout()
        plt.savefig(save_path, dpi=130)
        plt.close()
    return ax
