"""The CUDA starlet kernels' wrappers, against their plain twins.

This file imports neither ``jax`` nor ``lightcurver_tpu``, so it also runs
on a machine with a CUDA card and no jax (skipping the suite's conftest,
which imports jax):

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Tests that need the card carry the ``gpu`` marker and skip without one.
Tolerance on the card: max|diff| <= 1e-5 max|input| (float32, the kernel
sums each stencil in another order than the twin).
"""

import pytest
import torch

from lightcurver_tpu_torch.core import starlet as twin
from lightcurver_tpu_torch.ops import starlet_cuda, starlet_op

TOL = 1e-5


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def test_cpu_tensors_leave_launch_counters_at_zero():
    starlet_cuda.launches.reset()
    x = torch.randn(16, 16, generator=torch.Generator().manual_seed(0))
    x.requires_grad_(True)
    starlet_op.starlet_transform(x).sum().backward()
    starlet_cuda.starlet_forward(x.detach())
    starlet_cuda.starlet_adjoint(torch.zeros(5, 16, 16))
    assert (starlet_cuda.launches.forward,
            starlet_cuda.launches.adjoint) == (0, 0)


def test_wrappers_refuse_other_devices():
    with pytest.raises(ValueError, match="no kernel"):
        starlet_cuda.starlet_forward(torch.zeros(16, 16, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        starlet_cuda.starlet_adjoint(torch.zeros(5, 16, 16, device="meta"))


@pytest.mark.gpu
@pytest.mark.parametrize("m,batch", [(64, 1), (64, 500), (128, 1),
                                     (128, 500)])
def test_cuda_kernels_match_plain(cuda, m, batch):
    gen = torch.Generator().manual_seed(m + batch)
    x = torch.randn(batch, m, m, generator=gen).to(cuda)
    g = torch.randn(batch, twin.n_starlet_scales(m) + 1, m, m,
                    generator=gen).to(cuda)
    starlet_cuda.launches.reset()
    out = starlet_cuda.starlet_forward(x)
    adj = starlet_cuda.starlet_adjoint(g)
    torch.cuda.synchronize()
    assert (starlet_cuda.launches.forward,
            starlet_cuda.launches.adjoint) == (1, 1)
    tol_f = TOL * x.abs().max().item()
    tol_a = TOL * g.abs().max().item()
    assert (out - twin.starlet_transform(x)).abs().max().item() <= tol_f
    assert (adj - twin.starlet_adjoint(g)).abs().max().item() <= tol_a


@pytest.mark.gpu
@pytest.mark.parametrize("m", [24, 64])
def test_cuda_op_gradient_matches_cpu(cuda, m):
    """grad of sum W |T(x)| through the op: kernels on the card, twins on
    the CPU; m = 24 is not a power of two."""
    gen = torch.Generator().manual_seed(m)
    x = torch.randn(m, m, generator=gen)
    W = torch.rand(twin.n_starlet_scales(m) + 1, m, m, generator=gen)
    grads = []
    for device in ("cpu", cuda):
        xd = x.to(device).detach().requires_grad_(True)
        (W.to(device) * starlet_op.starlet_transform(xd).abs()).sum() \
            .backward()
        grads.append(xd.grad.cpu())
    ref = grads[0]
    assert (grads[1] - ref).abs().max().item() <= TOL * ref.abs().max().item()


@pytest.mark.gpu
def test_cuda_wrappers_reject_bad_input(cuda):
    with pytest.raises(TypeError):
        starlet_cuda.starlet_forward(torch.zeros(64, 64, device=cuda,
                                                 dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        starlet_cuda.starlet_forward(torch.zeros(64, 64, device=cuda).t()
                                     [:, :32])
    with pytest.raises(ValueError, match="shared memory"):
        starlet_cuda.starlet_forward(torch.zeros(256, 256, device=cuda))
