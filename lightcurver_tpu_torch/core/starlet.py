"""Starlet (isotropic undecimated a-trous) transform: the plain twin.

Twin of ``lightcurver_tpu/core/starlet.py``: first-generation starlet with
the B3-spline kernel [1, 4, 6, 4, 1] / 16 and mirror boundaries, J detail
planes finest-first plus the coarse residual. This module is the CPU path
of ``ops.starlet_op`` and the oracle the CUDA kernels
(``csrc/starlet.cu``) are held to.

Mirror boundary: ``jnp.pad(mode="symmetric")`` repeats the edge pixel,
which no ``F.pad`` mode does (``reflect`` excludes the edge and needs
pad < size, while here the pad 2 * 2^j reaches m). So each tap gathers
through a reflected index, ``i < 0 -> -1 - i``, ``i >= m -> 2m - 1 - i``.
One reflection is enough because ``2^J <= m``.

The adjoint: the mirror-boundary B3 smoothing S_j is a symmetric matrix,
so the transpose of the cascade is the same stencil run in reverse
(:func:`starlet_adjoint`).
"""

import math

import torch

_W = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def n_starlet_scales(size):
    """Default number of detail scales for an image of side ``size``."""
    return int(math.log2(size))


def _mirror_index(m, offset, device):
    i = torch.arange(m, dtype=torch.int64, device=device) + offset
    i = torch.where(i < 0, -1 - i, i)
    return torch.where(i >= m, 2 * m - 1 - i, i)


def _smooth_axis(x, dilation, dim):
    """1-D a-trous B3 smoothing along ``dim`` (mirror boundary)."""
    m = x.shape[dim]
    out = None
    for k, w in enumerate(_W):
        idx = _mirror_index(m, (k - 2) * dilation, x.device)
        term = w * torch.index_select(x, dim, idx)
        out = term if out is None else out + term
    return out


def smooth_once(img, dilation):
    """Separable a-trous smoothing: along x (last axis), then along y."""
    return _smooth_axis(_smooth_axis(img, dilation, -1), dilation, -2)


def starlet_transform(img, n_scales=None):
    """Starlet decomposition ``(..., m, m) -> (..., n_scales + 1, m, m)``."""
    if n_scales is None:
        n_scales = n_starlet_scales(img.shape[-1])
    coeffs = []
    current = img
    for j in range(n_scales):
        smoothed = smooth_once(current, 2**j)
        coeffs.append(current - smoothed)
        current = smoothed
    coeffs.append(current)
    return torch.stack(coeffs, dim=-3)


def starlet_adjoint(g):
    """Exact transpose of :func:`starlet_transform`.

    ``(..., J + 1, m, m) -> (..., m, m)``. With detail_j = c_j - c_{j+1}
    and c_{j+1} = S_j c_j, the cotangent of c_J is g_J - g_{J-1}, and for
    j = J-1 .. 0: b <- g_j - g_{j-1} + S_j b (g_{-1} = 0), using S_j^T = S_j.
    """
    n_scales = g.shape[-3] - 1
    if n_scales == 0:
        return g[..., 0, :, :]
    b = g[..., n_scales, :, :] - g[..., n_scales - 1, :, :]
    for j in range(n_scales - 1, -1, -1):
        b = smooth_once(b, 2**j) + g[..., j, :, :]
        if j > 0:
            b = b - g[..., j - 1, :, :]
    return b


def starlet_reconstruct(coeffs):
    """Exact inverse of :func:`starlet_transform` (sum over scales)."""
    return coeffs.sum(dim=-3)
