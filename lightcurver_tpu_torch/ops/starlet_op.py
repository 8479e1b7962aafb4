"""Differentiable starlet transform (twin of ``lightcurver_tpu/ops/starlet_op.py``).

The transform is linear, so its backward is its exact adjoint: on a CUDA
tensor both directions are the hand-written kernels of
``csrc/starlet.cu``; on a CPU tensor both are the plain twins of
``core/starlet.py``. The device of the input decides; there is no
backend switch and no fallback.
"""

import torch

from . import starlet_cuda
from ..core.starlet import n_starlet_scales


class _Starlet(torch.autograd.Function):

    @staticmethod
    def forward(ctx, img, n_scales):
        return starlet_cuda.starlet_forward(img.contiguous(), n_scales)

    @staticmethod
    def backward(ctx, g):
        return starlet_cuda.starlet_adjoint(g.contiguous()), None


def starlet_transform(img, n_scales=None):
    """Starlet decomposition ``(..., m, m) -> (..., n_scales + 1, m, m)``."""
    if n_scales is None:
        n_scales = n_starlet_scales(img.shape[-1])
    return _Starlet.apply(img, int(n_scales))
