"""Narrow-PSF forward model: analytic Moffat + free pixel grid.

Twin of ``lightcurver_tpu/core/psf/model.py``. The PSF of a frame is
fitted jointly on N star stamps:

    model_i = a_i * down( conv(t_i, r(. - (x0_i, y0_i))) )

with ``t = normalize(Moffat(fwhm_x, fwhm_y, beta) + g)`` the narrow PSF on
the fine grid, ``g`` a free pixel grid (the "background" channel of the
parameter names) and ``r`` the target Gaussian carrying each star's
sub-pixel shift as a phase ramp. With field distortion, ``t_i`` is ``t``
warped at the star's field position (``distortion.py``). The full PSF,
``conv(t, r)``, is what a centred star looks like on the fine grid.

Parameters (a nested dict of tensors):
    kwargs_moffat:     fwhm_x, fwhm_y, beta            (B)
    kwargs_gaussian:   a, x0, y0                       (B + (N,))
    kwargs_background: background                      (B + (m*m,))
    kwargs_distortion: dilation_x, dilation_y, shear   (B + (5,))

``B`` is the batch shape: ``()`` for one frame (``build_psf``), ``(F,)``
for the frame-batched fit, where every frame is an independent problem
and every operation below keeps the frames apart.

Renders: cuFFT at ``L = 2m`` when ``dft_mats`` is None; else the matmul
DFT of ``ops/dft.py`` at the matrices' length (``L = m + 2 dft_pad`` at a
reduced padding), whose pooled inverse lands on the data grid. Without
distortion the matmul render is the rank-1 form
(``ops.dft.irfft2_pool_shift_matmul``): each star is one shifted copy of
the shared spectrum, so no per-star spectrum is formed. As in JAX, these
are plain matmuls and FFTs: the PSF fit has no hand kernel in its render.
"""

from ..grids import downsample
from ..profiles import moffat_fine_grid
from .. import convolution as conv
from ...ops import dft
from .distortion import distortion_fields_at, warp_psf


def mats_length(dft_mats):
    """FFT length of a dft_mats dict (None: the cuFFT render's 2m)."""
    return None if dft_mats is None else dft_mats["Ay"].shape[-1]


def _forward_fft(t, dft_mats):
    if dft_mats is not None:
        return dft.rfft2_pad_matmul(t, dft_mats)
    return conv.psf_fft(t)


class PSFModel:
    """Static configuration of a joint N-star narrow-PSF fit."""

    def __init__(self, n_stars, image_size, subsampling_factor,
                 field_distortion=False):
        self.n_stars = int(n_stars)
        self.image_size = int(image_size)
        self.s = int(subsampling_factor)
        self.m = self.image_size * self.s
        self.field_distortion = bool(field_distortion)

    def _r_hat(self, device, L=None):
        return conv.r_kernel_fft(self.m, self.s, device=device, L=L)

    def narrow_psf(self, kwargs):
        """The normalized narrow PSF t on the fine grid, B + (m, m)."""
        km = kwargs["kwargs_moffat"]
        g = kwargs["kwargs_background"]["background"]
        g = g.reshape(*g.shape[:-1], self.m, self.m)
        t = moffat_fine_grid(self.m, self.s, km["fwhm_x"][..., None, None],
                             km["fwhm_y"][..., None, None],
                             km["beta"][..., None, None],
                             device=g.device) + g
        return t / t.sum(dim=(-2, -1), keepdim=True)

    def full_psf(self, kwargs, dft_mats=None):
        """conv(t, r): the PSF as seen by a perfectly centred star."""
        t = self.narrow_psf(kwargs)
        L = mats_length(dft_mats)
        t_hat = _forward_fft(t, dft_mats) * self._r_hat(t.device, L=L)
        if dft_mats is not None:
            return dft.irfft2_crop_matmul(t_hat, dft_mats)
        return conv.render_from_fft(t_hat, self.m)

    def _per_star_psfs(self, kwargs, stamp_coordinates):
        """B + (N, m, m) narrow PSFs, each warped at its star's position."""
        t = self.narrow_psf(kwargs)
        dx, dy, sh = distortion_fields_at(kwargs["kwargs_distortion"],
                                          stamp_coordinates)
        return warp_psf(t[..., None, :, :], dx, dy, sh)

    def model(self, kwargs, stamp_coordinates=None, dft_mats=None):
        """Modelled star stamps, B + (N, n, n).

        ``stamp_coordinates``: B + (N, 2) rescaled field positions, used
        with field distortion. ``dft_mats``: ``ops.dft.make_dft_mats(L, m,
        pool=s)`` for the matmul render, None for cuFFT.
        """
        kg = kwargs["kwargs_gaussian"]
        L = mats_length(dft_mats)
        if self.field_distortion and stamp_coordinates is not None:
            t_hat = _forward_fft(
                self._per_star_psfs(kwargs, stamp_coordinates), dft_mats)
        else:
            t = self.narrow_psf(kwargs)
            if dft_mats is not None:
                t_re, t_im = dft.rfft2_pad_matmul_parts(t, dft_mats)
                ry, rx = conv.r_kernel_fft_1d(self.m, self.s,
                                              device=t.device, L=L)
                ramps = conv.point_source_ramps(
                    self.m, self.s, kg["a"], kg["x0"], kg["y0"], ry=ry,
                    rx=rx, L=L)
                return dft.irfft2_pool_shift_matmul(
                    t_re[..., None, :, :], t_im[..., None, :, :], *ramps,
                    dft_mats)
            # one shared PSF: one forward FFT instead of N identical ones
            t_hat = conv.psf_fft(t)[..., None, :, :]
        spec = conv.point_source_spectrum(
            self.m, self.s, kg["a"][..., None], kg["x0"][..., None],
            kg["y0"][..., None], L=L)
        total_hat = spec * t_hat * self._r_hat(spec.device, L=L)
        if dft_mats is not None:
            # crop and sum-pool folded into the inverse matmuls
            return dft.irfft2_pool_matmul(total_hat, dft_mats)
        return downsample(conv.render_from_fft(total_hat, self.m), self.s)
