"""Mesh-based sky background estimation: a copy of
``lightcurver_tpu/processes/background_estimation.py``.

The image is divided into boxes; each box gets a sigma-clipped mode-like
estimate (2.5 median - 1.5 mean, SExtractor's formula); the box grid is
median filtered 3 x 3, and the full-resolution background is a bilinear
interpolation of the grid. The box statistics run in the host C++ of
``native/`` when it loads, else in the numpy loop of :func:`_mesh_stats`;
the tests hold the two to 1e-5.
"""

import numpy as np
from scipy.ndimage import median_filter, zoom


class Background:
    """Smooth background model with sep.Background-compatible surface."""

    def __init__(self, image, box_size, filter_size=3, mask=None):
        self.shape = image.shape
        self._back, self._rms_grid = _mesh_stats(image, box_size, mask)
        if filter_size > 1:
            self._back = median_filter(self._back, size=filter_size,
                                       mode="nearest")
            self._rms_grid = median_filter(self._rms_grid, size=filter_size,
                                           mode="nearest")
        self.globalback = float(np.median(self._back))
        self.globalrms = float(np.median(self._rms_grid))

    def back(self):
        """Full-resolution background image."""
        return _grid_to_image(self._back, self.shape)

    def rms(self):
        """Full-resolution background-noise image."""
        return _grid_to_image(self._rms_grid, self.shape)

    # allow `image - bkg` like sep.Background
    def __rsub__(self, image):
        return image - self.back()


def _sigma_clip_box(values, sigma=3.0, iters=3):
    values = values[np.isfinite(values)]
    if values.size == 0:
        return np.nan, np.nan
    for _ in range(iters):
        med = np.median(values)
        std = values.std()
        keep = np.abs(values - med) <= sigma * std
        if keep.all() or not keep.any():
            break
        values = values[keep]
    med, mean, std = np.median(values), values.mean(), values.std()
    # SExtractor background mode estimate; fall back to median in
    # strongly non-Gaussian (source-filled) boxes
    mode = 2.5 * med - 1.5 * mean
    if std == 0 or abs(med - mean) / std > 0.3:
        mode = med
    return mode, std


def _mesh_stats(image, box_size, mask=None):
    ny, nx = image.shape
    gy = max(ny // box_size, 1)
    gx = max(nx // box_size, 1)
    # the C++ mesh estimator when it loads (the same box edges, clipping
    # and mode formula; an empty box is NaN in both)
    from ..native import background_mesh

    native = background_mesh(
        image, gy, gx,
        mask=None if mask is None else np.asarray(mask, dtype=np.uint8))
    if native is not None:
        back, rms = native
    else:
        back, rms = _mesh_stats_numpy(image, gy, gx, mask)
    # fill empty (fully masked) boxes with the global median
    bad = ~np.isfinite(back)
    if bad.any():
        back[bad] = np.nanmedian(back)
        rms[bad] = np.nanmedian(rms)
    return back, rms


def _mesh_stats_numpy(image, gy, gx, mask=None):
    """The box statistics in numpy: the C++ estimator's twin and oracle."""
    ny, nx = image.shape
    back = np.empty((gy, gx))
    rms = np.empty((gy, gx))
    for iy in range(gy):
        y0 = iy * ny // gy
        y1 = (iy + 1) * ny // gy
        for ix in range(gx):
            x0 = ix * nx // gx
            x1 = (ix + 1) * nx // gx
            box = image[y0:y1, x0:x1]
            if mask is not None:
                box = box[~mask[y0:y1, x0:x1]]
            back[iy, ix], rms[iy, ix] = _sigma_clip_box(np.ravel(box))
    return back, rms


def _grid_to_image(grid, shape):
    ny, nx = shape
    gy, gx = grid.shape
    if (gy, gx) == (1, 1):
        return np.full(shape, grid[0, 0])
    out = zoom(grid, (ny / gy, nx / gx), order=1, mode="nearest",
               grid_mode=True)
    return out[:ny, :nx]


def subtract_background(image, mask_sources_first=False, n_boxes=10):
    """Estimate and subtract a smooth background.

    Optionally two-pass: segment the sources of the first-pass
    subtraction, mask them, and estimate again.

    Returns:
        (image_subtracted, Background)
    """
    image = np.asarray(image, dtype=np.float32)
    box_size = min(image.shape) // n_boxes
    bkg = Background(image, box_size)
    image_sub = image - bkg.back()
    if not mask_sources_first:
        return image_sub, bkg

    from .star_extraction import _segment

    seg = _segment(image_sub, np.full(image.shape, bkg.globalrms**2),
                   threshold=2.0, min_area=10)[1]
    bkg = Background(image, box_size, mask=(seg > 0))
    return image - bkg.back(), bkg
