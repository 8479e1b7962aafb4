"""Flux-conserving resampling between the fine grid and the data grid.

Twin of ``lightcurver_tpu/core/grids.py``: information moves between the
grids only through exact s x s sum-pooling and its transpose.
"""

import torch


def downsample(fine, s):
    """Sum-pool ``(..., m, m)`` by ``s`` into ``(..., m // s, m // s)``."""
    if s == 1:
        return fine
    *lead, my, mx = fine.shape
    return fine.reshape(*lead, my // s, s, mx // s, s).sum(dim=(-3, -1))


def upsample_transpose(coarse, s):
    """Transpose of :func:`downsample`: repeat each pixel into an s x s block."""
    if s == 1:
        return coarse
    out = torch.repeat_interleave(coarse, s, dim=-2)
    return torch.repeat_interleave(out, s, dim=-1)


def pixel_grid_coords(m, s, device=None, dtype=torch.float32):
    """Centre-origin ``(x, y)`` coordinates of an (m, m) grid, in data pixels."""
    c = (m - 1) / 2.0
    idx = (torch.arange(m, device=device, dtype=dtype) - c) / s
    y, x = torch.meshgrid(idx, idx, indexing="ij")
    return x, y
