"""Zero-padded FFT convolution with Fourier-analytic source placement.

Twin of the FFT branch of ``lightcurver_tpu/core/convolution.py``:

- exact LINEAR convolution of (m, m) fine-grid images with (m, m) PSFs
  through zero-padding to ``L = 2m`` (``torch.fft.rfft2/irfft2`` with
  ``s=(L, L)``),
- sub-pixel placement of point sources by separable phase ramps on the
  PSF transform (images are never interpolated),
- the target Gaussian ``r`` as its analytic transform.

Alignment: folding ``exp(+2 pi i k.c / L)`` with ``c = (m - 1) / 2`` into
a PSF transform re-centres it at index 0, so convolving a gridded image
is peak-aligned and the output is the corner crop ``[0:m, 0:m]``.

The matmul DFT (``lightcurver_tpu/ops/dft.py``) and the all-real and
rank-1 variants built on it are what JAX selects on the TPU only; they
are not ported here.
"""

import math

import torch

from .conventions import fwhm_to_sigma, TARGET_FWHM_FINE_PIX


def pad_len(m):
    """FFT length for an (m, m) fine grid (exact linear convolution)."""
    return 2 * m


def freq_grids(m, device=None, dtype=torch.float32):
    """``(fy, fx)`` of shapes (L, 1) and (1, L // 2 + 1), cycles / fine px."""
    L = pad_len(m)
    fy = torch.fft.fftfreq(L, device=device, dtype=dtype).reshape(L, 1)
    fx = torch.fft.rfftfreq(L, device=device, dtype=dtype).reshape(
        1, L // 2 + 1)
    return fy, fx


def r_kernel_fft(m, s, device=None, dtype=torch.float32):
    """Analytic rfft2 of the unit-integral target Gaussian at the origin."""
    del s
    sigma_f = fwhm_to_sigma(TARGET_FWHM_FINE_PIX)
    fy, fx = freq_grids(m, device=device, dtype=dtype)
    return torch.exp(-2.0 * math.pi**2 * sigma_f**2 * (fy**2 + fx**2))


def grid_center_phase(m, device=None, dtype=torch.float32):
    """The constant phase ``exp(+2 pi i (fy + fx) c)``, ``c = (m - 1) / 2``."""
    c = (m - 1) / 2.0
    fy, fx = freq_grids(m, device=device, dtype=dtype)
    ang = 2.0 * math.pi * (fy + fx) * c
    return torch.complex(torch.cos(ang), torch.sin(ang))


def psf_fft(t):
    """rfft2 of zero-padded PSF arrays ``(..., m, m)`` (complex64)."""
    L = pad_len(t.shape[-1])
    return torch.fft.rfft2(t, s=(L, L))


def render_from_fft(total_hat, m):
    """Inverse transform of an assembled spectrum + corner crop to (m, m)."""
    L = pad_len(m)
    return torch.fft.irfft2(total_hat, s=(L, L))[..., :m, :m]


def _ramp_angles(m, s, px, py, device, dtype):
    L = pad_len(m)
    fy = torch.fft.fftfreq(L, device=device, dtype=dtype)
    fx = torch.fft.rfftfreq(L, device=device, dtype=dtype)
    ay = -2.0 * math.pi * fy * (s * py)[..., None]
    ax = -2.0 * math.pi * fx * (s * px)[..., None]
    return ay, ax


def point_source_spectrum(m, s, a, px, py):
    """Spectrum of ``sum_j a_j r(. - p_j)`` relative to a PSF transform.

    Args:
        a, px, py: (..., M) tensors; positions in data pixels, centre
            origin.

    Returns:
        complex64 (..., L, L // 2 + 1).

    The phase is separable, ``exp(-2 pi i fy sy) (x) exp(-2 pi i fx sx)``,
    so the source sum is two contractions over the stacked axis 2M:
    ``re = [a cy, -a sy] @ [cx, sx]`` and ``im = [a sy, a cy] @ [cx, sx]``;
    a single source is a plain outer product (the same two branches as
    the JAX twin, so both round alike).
    """
    ay, ax = _ramp_angles(m, s, px, py, a.device, a.dtype)
    amps = a[..., None]
    if a.shape[-1] == 1:
        u_re = (amps * torch.cos(ay))[..., 0, :, None]
        u_im = (amps * torch.sin(ay))[..., 0, :, None]
        vx_c = torch.cos(ax)[..., 0, None, :]
        vx_s = torch.sin(ax)[..., 0, None, :]
        re = u_re * vx_c - u_im * vx_s
        im = u_re * vx_s + u_im * vx_c
        return torch.complex(re, im)
    cy, sy = torch.cos(ay), torch.sin(ay)                 # (..., M, L)
    cx, sx = torch.cos(ax), torch.sin(ax)                 # (..., M, Lh)
    u_re = torch.cat([amps * cy, -amps * sy], dim=-2)
    u_im = torch.cat([amps * sy, amps * cy], dim=-2)
    v = torch.cat([cx, sx], dim=-2)
    re = torch.einsum("...jy,...jx->...yx", u_re, v)
    im = torch.einsum("...jy,...jx->...yx", u_im, v)
    return torch.complex(re, im)
