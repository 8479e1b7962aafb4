"""Pixel-coordinate rescaling for the PSF field-distortion model: a copy of
``lightcurver_tpu/utilities/image_coordinates.py``.

The origin moves to the image centre and the coordinates are divided by
the image's dimensions, so the frame spans about [-1/2, 1/2] on each axis:
the coordinates of the distortion polynomials (``core/psf/distortion.py``).
"""

import numpy as np


def rescale_image_coordinates(xy_coordinates_array, image_shape):
    """(N, 2) pixel (x, y), origin bottom-left -> centred and rescaled.

    Args:
        xy_coordinates_array: (N, 2) array of (x, y) pixel pairs, or one
            (2,) pair.
        image_shape: the image's ``.shape`` (ny, nx).

    Returns:
        the same shape: origin at the image centre, divided by (nx, ny).
    """
    dims = np.array(image_shape, dtype=float)[::-1]  # (nx, ny)
    center = (dims - 1.0) / 2.0
    return (np.asarray(xy_coordinates_array, dtype=float) - center) / dims
