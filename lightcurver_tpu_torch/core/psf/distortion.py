"""Spatially-varying PSF: low-order polynomial field distortion.

Twin of ``lightcurver_tpu/core/psf/distortion.py``. Three scalar fields,
dilation_x, dilation_y and shear, are polynomials in the rescaled field
coordinates ``(u, v)`` with basis ``[u, v, u^2, uv, v^2]`` (no constant
term: the PSF at the field centre is the reference PSF). Applying the
distortion warps the narrow PSF by the affine map
``A = [[1 + dil_x, shear], [shear, 1 + dil_y]]`` about its centre.

The resampling is the bilinear gather of
``jax.scipy.ndimage.map_coordinates(order=1, mode="constant", cval=0)``,
written out: four taps ``(floor, floor + 1)`` per axis, weighted by the
distance to the other tap; a tap outside the grid contributes 0. It is
differentiable in the three fields through the weights (the floor is
piecewise constant), which the PSF fit needs when it fits them.

Every function takes leading batch dimensions (frames, stars) and
broadcasts them.
"""

import numpy as np
import torch

DISTORTION_BASIS_SIZE = 5  # [u, v, u^2, u*v, v^2]


def zero_distortion_kwargs(batch=(), device=None):
    """Zero polynomial coefficients, each of shape ``batch + (5,)``."""
    z = torch.zeros(*batch, DISTORTION_BASIS_SIZE, dtype=torch.float32,
                    device=device)
    return {"dilation_x": z, "dilation_y": z.clone(), "shear": z.clone()}


def distortion_fields_at(kwargs_distortion, uv):
    """(dil_x, dil_y, shear) at field coordinates ``uv`` (..., N, 2).

    The coefficients are (..., 5) and broadcast over the star axis N.
    """
    u, v = uv[..., 0], uv[..., 1]
    basis = torch.stack([u, v, u * u, u * v, v * v], dim=-1)   # (..., N, 5)

    def field(coeffs):
        return (coeffs[..., None, :] * basis).sum(dim=-1)

    return (field(kwargs_distortion["dilation_x"]),
            field(kwargs_distortion["dilation_y"]),
            field(kwargs_distortion["shear"]))


def _bilinear(psf, src_y, src_x):
    """``map_coordinates(psf, [src_y, src_x], order=1, mode="constant")``.

    ``psf`` (..., m, m) broadcasts against the coordinate stacks
    (..., m, m); the four taps are summed in JAX's order (y outer).
    """
    m_y, m_x = psf.shape[-2:]
    shape = torch.broadcast_shapes(psf.shape, src_y.shape)
    flat = psf.expand(shape).reshape(*shape[:-2], m_y * m_x)
    taps = []
    for coord, size in ((src_y, m_y), (src_x, m_x)):
        lower = torch.floor(coord)
        upper_w = coord - lower
        lower = lower.to(torch.int64)
        taps.append(((lower, 1.0 - upper_w), (lower + 1, upper_w)))
    out = None
    for iy, wy in taps[0]:
        for ix, wx in taps[1]:
            valid = (iy >= 0) & (iy < m_y) & (ix >= 0) & (ix < m_x)
            index = (iy.clamp(0, m_y - 1) * m_x + ix.clamp(0, m_x - 1)) \
                .expand(shape).reshape(flat.shape)
            value = torch.gather(flat, -1, index).reshape(shape)
            term = wy * wx * torch.where(valid, value,
                                         torch.zeros((), dtype=psf.dtype,
                                                     device=psf.device))
            out = term if out is None else out + term
    return out


def warp_psf(psf, dil_x, dil_y, shear):
    """Affine-warp PSFs (..., m, m) about their centre (flux preserved).

    The fields are tensors of the batch shape (or broadcastable to it);
    ``psf`` broadcasts against them, so one shared PSF and (N,) fields
    give (N, m, m).
    """
    m = psf.shape[-1]
    c = (m - 1) / 2.0
    dil_x, dil_y, shear = (f[..., None, None] for f in (dil_x, dil_y, shear))
    # inverse of A = [[1+dx, sh], [sh, 1+dy]]
    det = (1.0 + dil_x) * (1.0 + dil_y) - shear * shear
    inv00 = (1.0 + dil_y) / det
    inv01 = -shear / det
    inv10 = -shear / det
    inv11 = (1.0 + dil_x) / det
    rows = torch.arange(m, dtype=psf.dtype, device=psf.device) - c
    yy, xx = torch.meshgrid(rows, rows, indexing="ij")
    # sample source coords = A^-1 (x - c) + c ; x along columns
    src_x = inv00 * xx + inv01 * yy + c
    src_y = inv10 * xx + inv11 * yy + c
    return _bilinear(psf, src_y, src_x) / det  # Jacobian: preserve flux


def apply_distortion(narrow_psf, kwargs_distortion, star_xy_coordinates, *,
                     device="cuda"):
    """The spatially-varying narrow PSF at field position(s).

    Args:
        narrow_psf: (m, m) reference narrow PSF (field centre).
        kwargs_distortion: dict of (5,) polynomial coefficient arrays.
        star_xy_coordinates: (2,) or (N, 2) rescaled [-1, 1] coordinates.
        device: torch device of the computation.

    Returns:
        (m, m) or (N, m, m) numpy array of warped PSFs.
    """
    psf = torch.as_tensor(np.asarray(narrow_psf, dtype=np.float32),
                          device=device)
    uv = torch.as_tensor(np.asarray(star_xy_coordinates, dtype=np.float32),
                         device=device)
    single = uv.dim() == 1
    uv = uv.reshape(-1, 2)
    coeffs = {k: torch.as_tensor(np.asarray(v, dtype=np.float32),
                                 device=device)
              for k, v in kwargs_distortion.items()}
    with torch.no_grad():
        out = warp_psf(psf, *distortion_fields_at(coeffs, uv))
    out = out.cpu().numpy()
    return out[0] if single else out
