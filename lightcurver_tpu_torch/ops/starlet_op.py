"""Differentiable starlet transform (twin of ``lightcurver_tpu/ops/starlet_op.py``).

The transform is linear, so its backward is its exact adjoint: on a CUDA
tensor both directions are the hand-written kernels of
``csrc/starlet.cu``; on a CPU tensor both are the plain twins of
``core/starlet.py``. The device of the input decides; there is no
backend switch and no fallback. In a cost count each direction is one
unit of ``starlet_cuda.work`` (``ops/cost.py``).
"""

import math

import torch

from . import cost, starlet_cuda
from ..core.starlet import n_starlet_scales


class _Starlet(torch.autograd.Function):

    @staticmethod
    def forward(ctx, img, n_scales):
        return cost.charged(lambda: _work(img.shape, n_scales),
                            starlet_cuda.starlet_forward, img.contiguous(),
                            n_scales)

    @staticmethod
    def backward(ctx, g):
        n_scales = g.shape[-3] - 1
        return cost.charged(lambda: _work(g.shape[:-3] + g.shape[-2:],
                                          n_scales),
                            starlet_cuda.starlet_adjoint,
                            g.contiguous()), None


def _work(image_shape, n_scales):
    """(bytes, FLOPs) of one K1 call on images of ``image_shape``."""
    return starlet_cuda.work(image_shape[-1], math.prod(image_shape[:-2]),
                             n_scales)


def starlet_transform(img, n_scales=None):
    """Starlet decomposition ``(..., m, m) -> (..., n_scales + 1, m, m)``."""
    if n_scales is None:
        n_scales = n_starlet_scales(img.shape[-1])
    return _Starlet.apply(img, int(n_scales))
