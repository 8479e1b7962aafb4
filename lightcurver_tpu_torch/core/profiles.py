"""Analytic profiles on the fine grid (twin of ``lightcurver_tpu/core/profiles.py``)."""

import math

import torch

from .conventions import fwhm_to_sigma, TARGET_FWHM_FINE_PIX
from .grids import pixel_grid_coords


def gaussian_r_kernel(m, s, x0=0.0, y0=0.0, device=None,
                      dtype=torch.float32):
    """The unit-integral target Gaussian ``r`` centred at (x0, y0) data px.

    ``x0``/``y0`` may be Python floats or 0-d tensors (then the result is
    differentiable in them).
    """
    sigma_data = fwhm_to_sigma(TARGET_FWHM_FINE_PIX) / s
    x, y = pixel_grid_coords(m, s, device=device, dtype=dtype)
    r2 = (x - x0) ** 2 + (y - y0) ** 2
    norm = 1.0 / (2.0 * math.pi * sigma_data**2 * s**2)
    return norm * torch.exp(-0.5 * r2 / sigma_data**2)


def moffat_fine_grid(m, s, fwhm_x, fwhm_y, beta, x0=0.0, y0=0.0, phi=0.0,
                     device=None, dtype=torch.float32):
    """Unit-integral elliptical Moffat ``(1 + u)^(-beta)`` on the fine grid.

    FWHMs in DATA pixels, ``phi`` the position angle in radians.
    ``fwhm_x``, ``fwhm_y`` and ``beta`` may be tensors (the PSF fit's free
    parameters): the result is differentiable in them, and tensors shaped
    ``(..., 1, 1)`` give a ``(..., m, m)`` stack of profiles.
    """
    x, y = pixel_grid_coords(m, s, device=device, dtype=dtype)
    xr = x - x0
    yr = y - y0
    cphi = math.cos(phi)
    sphi = math.sin(phi)
    xp = cphi * xr + sphi * yr
    yp = -sphi * xr + cphi * yr
    root = torch.sqrt(torch.as_tensor(2.0 ** (1.0 / beta) - 1.0,
                                      dtype=dtype, device=x.device))
    alpha_x = fwhm_x / (2.0 * root)
    alpha_y = fwhm_y / (2.0 * root)
    u = (xp / alpha_x) ** 2 + (yp / alpha_y) ** 2
    norm = (beta - 1.0) / (math.pi * alpha_x * alpha_y * s**2)
    return norm * (1.0 + u) ** (-beta)
