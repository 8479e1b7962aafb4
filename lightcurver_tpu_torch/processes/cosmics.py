"""Cosmic-ray detection by Laplacian signal-to-noise (the L.A.Cosmic
family): a copy of ``lightcurver_tpu/processes/cosmics.py``.

van Dokkum (2001)'s method: cosmics are found by the significance of the
sub-pixel-scale Laplacian against the noise, with a fine-structure
contrast test that protects sharp PSF cores. :func:`detect_cosmics` runs
the host C++ twin of ``native/`` when it loads, else
:func:`detect_cosmics_numpy`, the fallback and the tests' oracle: the two
agree to the bit.
"""

import numpy as np
from scipy import ndimage

_LAPLACE = 0.25 * np.array([[0.0, -1.0, 0.0],
                            [-1.0, 4.0, -1.0],
                            [0.0, -1.0, 0.0]])


def _supersampled_laplacian(image):
    """Positive part of the Laplacian computed on a 2x-supersampled grid."""
    up = np.repeat(np.repeat(image, 2, axis=0), 2, axis=1)
    lap = ndimage.convolve(up, _LAPLACE, mode="mirror")
    lap = np.maximum(lap, 0.0)
    # block-average back to the original grid
    ny, nx = image.shape
    return lap.reshape(ny, 2, nx, 2).mean(axis=(1, 3))


def detect_cosmics(data, invar=None, sigclip=4.5, sigfrac=0.3, objlim=5.0,
                   niter=2, **_ignored):
    """Mask cosmic rays: the C++ kernel of ``native/`` when it loads, else
    :func:`detect_cosmics_numpy` (the same arguments and returns)."""
    from .. import native

    result = native.detect_cosmics(data, invar=invar, sigclip=sigclip,
                                   sigfrac=sigfrac, objlim=objlim,
                                   niter=niter)
    if result is not None:
        return result
    return detect_cosmics_numpy(data, invar=invar, sigclip=sigclip,
                                sigfrac=sigfrac, objlim=objlim,
                                niter=niter)


def detect_cosmics_numpy(data, invar=None, sigclip=4.5, sigfrac=0.3,
                         objlim=5.0, niter=2, **_ignored):
    """Mask cosmic rays.

    Args:
        data: 2d image (any flux units).
        invar: inverse... NOTE: matches the reference call
            ``detect_cosmics(cutout, invar=noisemap**2)`` — despite the
            name this is the per-pixel noise VARIANCE.
        sigclip: Laplacian-SNR threshold.
        sigfrac: neighbour-growth threshold fraction.
        objlim: minimum Laplacian / fine-structure contrast.
        niter: detection iterations (detected pixels are median-replaced
            between iterations so neighbours of strong hits get caught).

    Returns:
        (mask, cleaned): bool mask (True = cosmic) and the median-cleaned
        image — same tuple contract as astroscrappy.
    """
    img = np.asarray(data, dtype=float).copy()
    if invar is None:
        invar = np.abs(img) + 1.0
    noise = np.sqrt(np.maximum(np.asarray(invar, dtype=float), 1e-12))

    total_mask = np.zeros(img.shape, dtype=bool)
    for _ in range(max(int(niter), 1)):
        lap = _supersampled_laplacian(img)
        snr = lap / (2.0 * noise)
        # remove smooth large-scale structure from the SNR map
        snr = snr - ndimage.median_filter(snr, size=5, mode="mirror")

        # fine-structure image: med3 - med7(med3)
        med3 = ndimage.median_filter(img, size=3, mode="mirror")
        fine = med3 - ndimage.median_filter(med3, size=7, mode="mirror")
        fine = np.maximum(fine, 0.01)

        candidates = (snr > sigclip) & (lap / fine > objlim)
        # grow: neighbours of candidates at the reduced threshold
        grown = ndimage.binary_dilation(candidates, np.ones((3, 3)))
        new_mask = grown & (snr > sigclip * sigfrac)
        new_mask &= ~total_mask
        if not new_mask.any():
            break
        total_mask |= new_mask
        # replace detected pixels for the next pass
        img[total_mask] = med3[total_mask]

    cleaned = np.asarray(data, dtype=float).copy()
    cleaned[total_mask] = ndimage.median_filter(
        cleaned, size=5, mode="mirror")[total_mask]
    return total_mask, cleaned


def mask_bad_rows_and_columns(cutout_data, sigma=6.0):
    """Full bad rows/columns (detector defects), ccdproc.ccdmask spirit.

    A row/column is bad when its median deviates from the global
    background by more than ``sigma`` robust-sigmas AND the deviation
    spans the full extent (both ends).
    """
    img = np.asarray(cutout_data, dtype=float)
    med = np.median(img)
    mad = np.median(np.abs(img - med)) * 1.4826 + 1e-12

    col_dev = np.abs(np.median(img, axis=0) - med) / mad
    row_dev = np.abs(np.median(img, axis=1) - med) / mad
    end_cols = (np.abs(img[0, :] - med) / mad > sigma) \
        & (np.abs(img[-1, :] - med) / mad > sigma)
    end_rows = (np.abs(img[:, 0] - med) / mad > sigma) \
        & (np.abs(img[:, -1] - med) / mad > sigma)

    mask = np.zeros(img.shape, dtype=bool)
    mask[:, (col_dev > sigma) & end_cols] = True
    mask[(row_dev > sigma) & end_rows, :] = True
    return mask
