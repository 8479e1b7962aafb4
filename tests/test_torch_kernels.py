"""The CUDA kernels' wrappers (starlet K1, fused render K2), against
their plain twins.

This file imports neither ``jax`` nor ``lightcurver_tpu``, so it also runs
on a machine with a CUDA card and no jax (skipping the suite's conftest,
which imports jax):

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Tests that need the card carry the ``gpu`` marker and skip without one.
Tolerances on the card: K1 max|diff| <= 1e-5 max|input| (float32, the
kernel sums each stencil in another order than the twin); K2
max|diff| <= 1e-4 max|plain| (the JAX package's bar for its kernel:
float32 sums over L = 256 terms taken in another order than cuBLAS).
"""

import pytest
import torch

from lightcurver_tpu_torch.core import starlet as twin
from lightcurver_tpu_torch.core.deconv.model import setup_model
from lightcurver_tpu_torch.ops import (fused_render, fused_render_cuda,
                                       starlet_cuda, starlet_op)
from lightcurver_tpu_torch.utilities.synthetic import make_roi_scene

TOL = 1e-5
K2_TOL = 1e-4


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


def _k2_case(device, n_epochs, n_pix, seed):
    """K2 operands as the ROI fit gives them (4 sources, s = 2), with a
    random background, and a random output cotangent."""
    sc = make_roi_scene(n_epochs=n_epochs, n_pix=n_pix, s=2, n_sources=4,
                        seed=seed)
    model, kw, *_ = setup_model(sc["data"], sc["sigma_2"], sc["psf"],
                                sc["xs"], sc["ys"], 2, device=device)
    gen = torch.Generator().manual_seed(seed)
    h = (0.01 * torch.randn(model.m**2, generator=gen)).to(device)
    a = kw["kwargs_analytic"]["a"].reshape(n_epochs, 4)
    px, py = model.source_positions(kw)
    ops = model.fused_render_operands(a, px, py, h, model.matmul_consts())
    g = torch.randn(n_epochs, n_pix, n_pix, generator=gen).to(device)
    return ops, g


def test_k2_on_cpu_tensors_leaves_launch_counters_at_zero():
    fused_render_cuda.launches.reset()
    ops, g = _k2_case("cpu", 3, 8, seed=1)
    u_re, u_im, v, *rest = ops
    free = [x.clone().requires_grad_(True) for x in (u_re, u_im, v)]
    for include_h in (True, False):
        out = fused_render.fused_render(*free, *rest, include_h=include_h)
        (out * g).sum().backward()
    assert all(x.grad is not None for x in free)
    c = fused_render_cuda.launches
    assert (c.forward, c.backward, c.forward_h, c.backward_h) == (0, 0, 0, 0)


def test_k2_wrappers_refuse_other_devices():
    ops, g = _k2_case("cpu", 2, 8, seed=2)
    with pytest.raises(ValueError, match="no kernel"):
        fused_render_cuda.forward(*ops)
    with pytest.raises(ValueError, match="no kernel"):
        fused_render_cuda.backward(g, *ops[:8], *ops[10:])


@pytest.mark.gpu
@pytest.mark.parametrize("n_pix", [64, 32])
@pytest.mark.parametrize("include_h", [True, False])
def test_k2_kernels_match_plain(cuda, n_pix, include_h):
    """ROI-100 (n 64) and the production stamp (n 32), 100 epochs."""
    ops, g = _k2_case(cuda, 100, n_pix, seed=n_pix)
    if not include_h:
        ops = (*ops[:8], None, None, *ops[10:])
    bwd_ops = (*ops[:8], *ops[10:])    # all but h_re, h_im
    fused_render_cuda.launches.reset()
    out = fused_render_cuda.forward(*ops, include_h=include_h)
    grads = fused_render_cuda.backward(g, *bwd_ops, include_h=include_h)
    torch.cuda.synchronize()
    c = fused_render_cuda.launches
    assert (c.forward, c.backward) == (1, 1)
    assert (c.forward_h, c.backward_h) == (int(include_h),) * 2
    ref = fused_render.render_plain(*ops, include_h=include_h)
    assert (out - ref).abs().max().item() <= K2_TOL * ref.abs().max().item()
    refs = fused_render.render_backward_plain(g, *bwd_ops,
                                              include_h=include_h)
    for got, want in zip(grads, refs):
        if want is None:
            assert got is None
            continue
        assert (got - want).abs().max().item() \
            <= K2_TOL * want.abs().max().item()
    # deterministic: no atomics, the same bits on a second launch
    again = fused_render_cuda.backward(g, *bwd_ops, include_h=include_h)
    for got, second in zip(grads, again):
        if got is not None:
            assert torch.equal(got, second)


@pytest.mark.gpu
def test_k2_gradient_through_the_model_matches_cpu(cuda):
    """d/d(a, px, py, h) of a weighted sum of the render: kernels on the
    card, plain twins on the CPU."""
    sc = make_roi_scene(n_epochs=6, n_pix=16, s=2, n_sources=4, seed=5)
    g = torch.randn(6, 16, 16, generator=torch.Generator().manual_seed(5))
    grads = []
    for device in ("cpu", cuda):
        model, kw, *_ = setup_model(sc["data"], sc["sigma_2"], sc["psf"],
                                    sc["xs"], sc["ys"], 2, device=device)
        leaves = {k: kw["kwargs_analytic"][k].clone().requires_grad_(True)
                  for k in ("a", "c_x", "c_y", "dx", "dy")}
        kw = {**kw, "kwargs_analytic": {**kw["kwargs_analytic"], **leaves}}
        kw["kwargs_background"]["h"] = torch.full(
            (model.m**2,), 0.01, device=device).requires_grad_(True)
        out = model.model(kw, consts=model.matmul_consts())
        (out * g.to(device)).sum().backward()
        grads.append([x.grad.cpu() for x in (*leaves.values(),
                                             kw["kwargs_background"]["h"])])
    for got, want in zip(grads[1], grads[0]):
        assert (got - want).abs().max().item() \
            <= K2_TOL * want.abs().max().item()


@pytest.mark.gpu
def test_k2_wrappers_reject_bad_input(cuda):
    ops, g = _k2_case(cuda, 4, 16, seed=3)
    with pytest.raises(TypeError):
        fused_render_cuda.forward(ops[0].double(), *ops[1:])
    with pytest.raises(ValueError, match="contiguous"):
        fused_render_cuda.forward(
            ops[0], ops[1], ops[2], ops[3].transpose(1, 2).contiguous()
            .transpose(1, 2), *ops[4:])
    with pytest.raises(ValueError, match="shape"):
        fused_render_cuda.forward(*ops[:10], ops[10][:, :-1], *ops[11:])
    with pytest.raises(ValueError, match="shape"):
        fused_render_cuda.backward(g[:, :-1], *ops[:8], *ops[10:])
    with pytest.raises(ValueError, match="cpu"):
        fused_render_cuda.forward(*ops[:5], ops[5].cpu(), *ops[6:])
