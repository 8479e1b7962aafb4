"""The CUDA kernels' wrappers (starlet K1, fused render K2), against
their plain twins.

This file imports neither ``jax`` nor ``lightcurver_tpu``, so it also runs
on a machine with a CUDA card and no jax (skipping the suite's conftest,
which imports jax):

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Tests that need the card carry the ``gpu`` marker and skip without one.
Tolerances on the card: K1 max|diff| <= 1e-5 max|input| (float32, the
kernel sums each stencil in another order than the twin); K2 forward
max|diff| <= 1e-5 max|plain| (its products are 3xTF32 on the tensor
cores: float32 accuracy, where plain TF32 products miss by ~1e-4, see
the CPU rehearsal of the split below); K2 backward max|diff| <= 1e-4
max|plain| (the JAX package's bar for its kernel: float32 sums over
L = 256 terms taken in another order than cuBLAS).
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
K2_FWD_TOL = 1e-5


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
    assert (out - ref).abs().max().item() \
        <= K2_FWD_TOL * ref.abs().max().item()
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


def _tf32(x):
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_matmul(a, b, terms):
    """a @ b from float32 operands split into TF32 hi + lo, the products
    hi hi (+ hi lo + lo hi with ``terms`` 3) summed in float64, so that
    only the split's rounding remains; rounded to float32 like the
    kernel's accumulators."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    out = ah.double() @ bh.double()
    if terms == 3:
        out = out + ah.double() @ bl.double() + al.double() @ bh.double()
    return out.float()


def _render_split(ops, terms):
    """K2 forward as the kernel computes it: X in float32 on the CUDA
    cores, both products through :func:`_split_matmul`."""
    (u_re, u_im, v, t_re, t_im, r_hat, pc, ps, h_re, h_im,
     ayp, byp, cxp, sxp) = ops
    spec_re = torch.einsum("eck,ecj->ekj", u_re, v)
    spec_im = torch.einsum("eck,ecj->ekj", u_im, v)
    p_re, p_im = t_re * r_hat, t_im * r_hat
    g_re, g_im = t_re * pc - t_im * ps, t_re * ps + t_im * pc
    x_re = spec_re * p_re - spec_im * p_im + h_re * g_re - h_im * g_im
    x_im = spec_re * p_im + spec_im * p_re + h_re * g_im + h_im * g_re
    # stage 1 as one real product: [A; B] = [[Ayp, -Byp], [Byp, Ayp]] X
    lhs = torch.cat([torch.cat([ayp, -byp], 1), torch.cat([byp, ayp], 1)])
    ab = _split_matmul(lhs, torch.cat([x_re, x_im], 1), terms)
    n = ayp.shape[0]
    # stage 2: out = [A, -B] [Cxp; Sxp]
    return _split_matmul(torch.cat([ab[:, :n], -ab[:, n:]], 2),
                         torch.cat([cxp, sxp]), terms)


@pytest.mark.parametrize("terms,agrees", [(3, True), (1, False)])
def test_k2_split_products_hold_the_forward_bar(terms, agrees):
    """The forward's 3xTF32 split keeps float32 accuracy (within 1e-6 of
    a float64 render) at ROI-100 widths (n 64, L 256), while plain TF32
    products miss the card's bar of 1e-5: the bar sees that fault."""
    ops, _ = _k2_case("cpu", 3, 64, seed=4)
    assert ops[10].shape == (64, 256)
    ref = fused_render.render_plain(*(x.double() for x in ops))
    err = (_render_split(ops, terms).double() - ref).abs().max().item()
    scale = ref.abs().max().item()
    if agrees:
        assert err <= 1e-6 * scale
    else:
        assert err > K2_FWD_TOL * scale


@pytest.mark.gpu
@pytest.mark.parametrize("n_epochs,n_pix", [(7, 12), (3, 80), (2, 112)])
@pytest.mark.parametrize("include_h", [True, False])
def test_k2_forward_matches_plain_at_ragged_shapes(cuda, n_epochs, n_pix,
                                                   include_h):
    """n 12 (L 48: Lh 25 is not a multiple of 8, the last k chunk is
    short, 32 rows a block, mostly padding), n 80 (L 320: 64 rows a
    block, the second ragged, two output passes) and n 112 (L 448: too
    wide for 64-row tiles, so four blocks of 32 rows, and chunks of 8
    rows of k to fit shared memory)."""
    ops, _ = _k2_case(cuda, n_epochs, n_pix, seed=n_pix)
    if not include_h:
        ops = (*ops[:8], None, None, *ops[10:])
    out = fused_render_cuda.forward(*ops, include_h=include_h)
    ref = fused_render.render_plain(*ops, include_h=include_h)
    assert (out - ref).abs().max().item() \
        <= K2_FWD_TOL * ref.abs().max().item()


@pytest.mark.gpu
def test_k2_forward_is_one_launch_without_scratch(cuda):
    """The forward writes final rows in one launch: the call allocates
    less than its output and the tile design's partial sums
    (N, ceil(Lh / 32), n, n) would take (the caching allocator may hand the
    output a larger cached block), and two launches give the same bits."""
    ops, _ = _k2_case(cuda, 100, 64, seed=6)
    fused_render_cuda.forward(*ops)            # build and load first
    torch.cuda.synchronize()
    fused_render_cuda.launches.reset()
    before = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    out = fused_render_cuda.forward(*ops)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated(cuda) - before
    again = fused_render_cuda.forward(*ops)
    assert fused_render_cuda.launches.forward == 2
    n_epochs, n, _ = out.shape
    lh = ops[2].shape[-1]
    partial = n_epochs * -(-lh // 32) * n * n * out.element_size()
    assert grown < out.numel() * out.element_size() + partial
    assert torch.equal(out, again)
