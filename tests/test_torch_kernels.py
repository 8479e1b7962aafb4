"""The CUDA kernels' wrappers (starlet K1, fused render K2), against
their plain twins.

This file imports neither ``jax`` nor ``lightcurver_tpu``, so it also runs
on a machine with a CUDA card and no jax (skipping the suite's conftest,
which imports jax):

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Tests that need the card carry the ``gpu`` marker and skip without one.
Tolerances on the card: K1 max|diff| <= 1e-5 max|input| (float32, the
kernel sums each stencil in another order than the twin); K2 forward and
backward max|diff| <= 1e-5 max|plain| per output (their products are
3xTF32 on the tensor cores: float32 accuracy, where plain TF32 products
miss by ~3e-4, see the CPU rehearsals of the split below); gradients
through the whole model, card against CPU, 1e-4 (the JAX package's bar
for its fused-render kernel).
"""

import pytest
import torch

from lightcurver_tpu_torch.core import convolution, starlet as twin
from lightcurver_tpu_torch.core.deconv.model import setup_model
from lightcurver_tpu_torch.ops import (fused_render, fused_render_cuda,
                                       starlet_cuda, starlet_op)
from lightcurver_tpu_torch.utilities.synthetic import (
    make_roi_scene, psf_pixel_phase_point, star_k2_operands,
    star_loss_point)

TOL = 1e-5
K2_TOL = 1e-4
K2_FWD_TOL = 1e-5
K2_BWD_TOL = 1e-5
H100_SMEM = 232448   # bytes of shared memory an H100 block may opt in to


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


@pytest.mark.parametrize("m,batch,expected", [
    (128, 1, 16), (64, 1, 16), (62, 1, 16), (256, 3, 16), (128, 9, 8),
    (24, 1, 4), (128, 500, 1), (64, 500, 1), (512, 500, 16), (544, 1, 16),
    (545, 1, None), (128, 16, 8), (48, 3, 8), (128, 17, 4)])
def test_cluster_size_rule(m, batch, expected):
    """C on an H100 (132 SMs, 232,448 bytes of shared memory a block):
    16 CTAs for one image, one CTA each for 500, more where a band would
    not fit, none past m 544, bands of at least 4 rows; the PSF fit's
    batch of 16 frames of m 128 takes C 8 (128 CTAs in one wave)."""
    assert starlet_cuda.cluster_size(m, batch, 132, 232448) == expected
    if expected is not None:
        assert starlet_cuda.cta_bytes(m, expected) <= 232448


@pytest.mark.gpu
@pytest.mark.parametrize("m,batch", [(64, 1), (64, 500), (128, 1),
                                     (128, 500), (62, 1), (62, 3), (256, 1),
                                     (256, 3), (128, 16), (48, 3)])
def test_cuda_kernels_match_plain(cuda, m, batch):
    """The ROI fit's shapes, odd and wide stamps, and the PSF fit's: a
    batch of frames (16 of m 128 at full width, 3 of m 48 in the CPU
    tests) spread over clusters of 1 < C < 16."""
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
@pytest.mark.parametrize("cluster", starlet_cuda.CLUSTER_SIZES)
def test_cuda_kernels_match_plain_at_every_cluster_size(cuda, cluster):
    """Two images of m 128 (J 7, so the taps of the last levels reach
    across every band) through the library at each C, which the rule
    picks only at some batches; the library's CTA bytes equal those the
    wrapper refuses by."""
    gen = torch.Generator().manual_seed(cluster)
    x = torch.randn(2, 128, 128, generator=gen).to(cuda)
    g = torch.randn(2, 8, 128, 128, generator=gen).to(cuda)
    out, adj = torch.empty_like(g), torch.empty_like(x)
    lib = starlet_cuda._load()
    stream = torch.cuda.current_stream().cuda_stream
    for fn, src, dst in ((lib.starlet_forward, x, out),
                         (lib.starlet_adjoint, g, adj)):
        assert fn(src.data_ptr(), dst.data_ptr(), 2, 128, 7, cluster,
                  stream) == 0
    torch.cuda.synchronize()
    assert (out - twin.starlet_transform(x)).abs().max().item() \
        <= TOL * x.abs().max().item()
    assert (adj - twin.starlet_adjoint(g)).abs().max().item() \
        <= TOL * g.abs().max().item()
    for m in (24, 62, 128, 256, 544):
        assert lib.starlet_cta_bytes(m, cluster) \
            == starlet_cuda.cta_bytes(m, cluster)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [24, 64, 256])
def test_cuda_op_gradient_matches_cpu(cuda, m):
    """grad of sum W |T(x)| through the op: kernels on the card, twins on
    the CPU; m = 24 is not a power of two, m = 256 did not fit one block's
    shared memory."""
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
        starlet_cuda.starlet_forward(torch.zeros(545, 545, device=cuda))
    with pytest.raises(ValueError, match="shared memory"):
        starlet_cuda.starlet_adjoint(torch.zeros(10, 545, 545, device=cuda))


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
@pytest.mark.parametrize("n_pix", [64, 32, 31])
@pytest.mark.parametrize("include_h", [True, False])
def test_k2_kernels_match_plain(cuda, n_pix, include_h):
    """ROI-100 (n 64), the production stamp (n 32) and an odd stamp (n 31:
    L 124, padded to 128 on the k axis), 100 epochs."""
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
            <= K2_BWD_TOL * want.abs().max().item()
    # deterministic: no atomics, the same bits on a second launch
    again = fused_render_cuda.backward(g, *bwd_ops, include_h=include_h)
    for got, second in zip(grads, again):
        if got is not None:
            assert torch.equal(got, second)


@pytest.mark.gpu
@pytest.mark.parametrize("n_pix", [16, 15])
def test_k2_gradient_through_the_model_matches_cpu(cuda, n_pix):
    """d/d(a, px, py, h) of a weighted sum of the render: kernels on the
    card, plain twins on the CPU; n 15 is an odd stamp (L 60)."""
    sc = make_roi_scene(n_epochs=6, n_pix=n_pix, s=2, n_sources=4, seed=5)
    g = torch.randn(6, n_pix, n_pix,
                    generator=torch.Generator().manual_seed(5))
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


@pytest.mark.parametrize("n_pix", [31, 32])
def test_k2_k_padding_leaves_render_and_gradient_unchanged(n_pix):
    """The plain twins on the operands that the card's wrappers give the
    kernels (k padded with zeros to a multiple of 8: L 124 -> 128 at n 31;
    nothing at n 32), sliced back, equal them on the unpadded operands."""
    ops, g = _k2_case("cpu", 3, n_pix, seed=7)
    padded = fused_render_cuda.pad_k(ops)
    L = ops[0].shape[-1]
    assert padded[0].shape[-1] == -(-L // 8) * 8
    assert padded[3].shape[-2] == padded[10].shape[-1] == padded[0].shape[-1]
    ref = fused_render.render_plain(*ops)
    assert (fused_render.render_plain(*padded) - ref).abs().max().item() \
        <= 1e-6 * ref.abs().max().item()
    refs = fused_render.render_backward_plain(g, *ops[:8], *ops[10:])
    got = fused_render.render_backward_plain(g, *padded[:8], *padded[10:])
    for i, (x, want) in enumerate(zip(got, refs)):
        x = x[..., :L] if i < 2 else x[:L] if i > 2 else x
        assert x.shape == want.shape
        assert (x - want).abs().max().item() \
            <= 1e-6 * want.abs().max().item()


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


def _backward_split(g, ops, terms):
    """K2 backward as the kernel computes it: [dA | dB] = G [Cxp^T |
    -Sxp^T] and [dXr; dXi] = [[Ayp^T, Byp^T], [-Byp^T, Ayp^T]] [dA; dB]
    through :func:`_split_matmul`, the rest in float32 on the CUDA
    cores."""
    u_re, u_im, v, t_re, t_im, r_hat, pc, ps, ayp, byp, cxp, sxp = ops
    Lh, L = cxp.shape[0], ayp.shape[1]
    dab = _split_matmul(g, torch.cat([cxp, -sxp]).T, terms)
    lhs = torch.cat([torch.cat([ayp.T, byp.T], 1),
                     torch.cat([-byp.T, ayp.T], 1)])
    dx = _split_matmul(lhs, torch.cat([dab[..., :Lh], dab[..., Lh:]], 1),
                       terms)
    dx_re, dx_im = dx[:, :L], dx[:, L:]
    p_re, p_im = t_re * r_hat, t_im * r_hat
    ds_re = dx_re * p_re + dx_im * p_im
    ds_im = dx_im * p_re - dx_re * p_im
    g_re, g_im = t_re * pc - t_im * ps, t_re * ps + t_im * pc
    return (torch.einsum("ekj,ecj->eck", ds_re, v),
            torch.einsum("ekj,ecj->eck", ds_im, v),
            torch.einsum("ekj,eck->ecj", ds_re, u_re)
            + torch.einsum("ekj,eck->ecj", ds_im, u_im),
            (dx_re * g_re + dx_im * g_im).sum(0),
            (dx_im * g_re - dx_re * g_im).sum(0))


@pytest.mark.parametrize("terms,agrees", [(3, True), (1, False)])
def test_k2_split_products_hold_the_backward_bar(terms, agrees):
    """The backward's 3xTF32 products keep every one of its five outputs
    within 1e-6 of a float64 backward at ROI-100 widths (n 64, L 256),
    while plain TF32 products miss the card's bar of 1e-5 in each."""
    ops, g = _k2_case("cpu", 3, 64, seed=4)
    bwd_ops = (*ops[:8], *ops[10:])
    assert bwd_ops[8].shape == (64, 256)
    refs = fused_render.render_backward_plain(
        g.double(), *(x.double() for x in bwd_ops))
    for got, want in zip(_backward_split(g, bwd_ops, terms), refs):
        err = (got.double() - want).abs().max().item()
        scale = want.abs().max().item()
        if agrees:
            assert err <= 1e-6 * scale
        else:
            assert err > K2_BWD_TOL * scale


@pytest.mark.parametrize("n_pix,expected", [
    (64, 1), (32, 1), (31, 1), (12, 1), (80, 2), (112, 3)])
def test_k2_backward_slab_rule(n_pix, expected):
    """The slabs of the half axis on an H100, 4 sources at s 2: one for
    ROI-100 (n 64), the production stamp (n 32) and smaller stamps, more
    where the padded half axis passes the register tiles (n 80) or shared
    memory (n 112). The slabs cover Lh padded to a multiple of 8 in runs
    of 8 columns, equal within 8, and the widest fits the budget."""
    C, L = 8, 4 * n_pix
    Lh = L // 2 + 1
    n_slabs = fused_render_cuda.backward_slabs(C, Lh, n_pix, H100_SMEM)
    assert n_slabs == expected
    units = -(-Lh // 8)
    widths = [8 * (units // n_slabs + (i < units % n_slabs))
              for i in range(n_slabs)]
    assert sum(widths) == 8 * units
    assert max(widths) - min(widths) <= 8
    width = fused_render_cuda.slab_width(Lh, n_slabs)
    assert width == max(widths) <= fused_render_cuda.MAX_SLAB
    assert fused_render_cuda.backward_smem_bytes(C, n_pix, width) \
        <= H100_SMEM
    if n_slabs > 1:   # the rule takes the fewest slabs that fit
        fewer = fused_render_cuda.slab_width(Lh, n_slabs - 1)
        assert fewer > fused_render_cuda.MAX_SLAB or \
            fused_render_cuda.backward_smem_bytes(C, n_pix, fewer) \
            > H100_SMEM
    Lp = -(-L // 8) * 8   # the k axis as the wrapper pads it
    plan = fused_render_cuda.backward_plan(100, C, Lp, Lh, n_pix, True,
                                           H100_SMEM)
    assert plan.launches == 2 + (n_slabs > 1)
    du_part = 4 * 2 * 100 * n_slabs * C * Lp if n_slabs > 1 else 0
    assert plan.scratch_bytes == 4 * 2 * 100 * Lp * Lh + du_part


def _tile_kernel_bytes(C, L, n):
    """Shared memory of a block of the tile backward of 80883cd (one epoch
    and 32 columns of the half axis): u_re, u_im (C, L), v (C, 32), dA, dB
    (n, 32), then the larger of G with the Cxp, Sxp tiles and dspec
    (rows of 33 floats)."""
    return 4 * (2 * C * L + 32 * C + 64 * n
                + max(66 * n + n * n, 66 * L))


@pytest.mark.parametrize("C", [2, 4, 8, 16, 32])
def test_k2_backward_takes_every_shape_the_tile_kernel_took(C):
    """Every (2M, L, n) that the tile kernel's shared memory allowed on an
    H100 (L a multiple of 8 after padding, n <= L, Lh from an even or an
    odd stamp) has slabs that fit: the redesign refuses no shape that ran
    before."""
    taken = 0
    for L in range(8, 1200, 8):
        for n in range(1, min(L, 250) + 1):
            if _tile_kernel_bytes(C, L, n) > H100_SMEM:
                continue
            for Lh in {L // 2 + 1, L // 2 - 1}:
                assert fused_render_cuda.backward_slabs(
                    C, Lh, n, H100_SMEM) is not None, (C, L, n, Lh)
            taken += 1
    assert taken > 1000


@pytest.mark.gpu
@pytest.mark.parametrize("n_epochs,n_pix", [(7, 12), (3, 80), (2, 112)])
@pytest.mark.parametrize("include_h", [True, False])
def test_k2_backward_matches_plain_at_ragged_shapes(cuda, n_epochs, n_pix,
                                                    include_h):
    """n 12 (L 48: Lh 25 padded to 32 columns, the last k chunk 16 rows),
    n 80 (L 320: two slabs, the half axis wider than the register tiles)
    and n 112 (L 448: three slabs, for shared memory); the library's
    shared memory per block equals the wrapper's rule."""
    ops, g = _k2_case(cuda, n_epochs, n_pix, seed=n_pix)
    bwd_ops = (*ops[:8], *ops[10:])
    C, L = ops[0].shape[1:]
    Lh = ops[2].shape[-1]
    optin = fused_render_cuda.smem_optin(cuda)
    n_slabs = fused_render_cuda.backward_slabs(C, Lh, n_pix, optin)
    assert fused_render_cuda._load().k2_smem_bytes(
        1, C, L, Lh, n_pix, n_slabs) == fused_render_cuda.backward_smem_bytes(
            C, n_pix, fused_render_cuda.slab_width(Lh, n_slabs))
    grads = fused_render_cuda.backward(g, *bwd_ops, include_h=include_h)
    refs = fused_render.render_backward_plain(g, *bwd_ops,
                                              include_h=include_h)
    for got, want in zip(grads, refs):
        if want is None:
            assert got is None
            continue
        assert (got - want).abs().max().item() \
            <= K2_BWD_TOL * want.abs().max().item()


@pytest.mark.gpu
def test_k2_backward_writes_du_without_partials(cuda):
    """At ROI-100 the backward is one slab: it allocates its outputs and
    dh_part, and no du_part (whose smallest form, two slabs, would take
    more than the margin allowed), launches the slab kernel and one
    sum_middle, and two launches give the same bits."""
    ops, g = _k2_case(cuda, 100, 64, seed=6)
    bwd_ops = (*ops[:8], *ops[10:])
    N, C, L = ops[0].shape
    Lh = ops[2].shape[-1]
    plan = fused_render_cuda.backward_plan(
        N, C, L, Lh, 64, True, fused_render_cuda.smem_optin(cuda))
    assert (plan.n_slabs, plan.launches) == (1, 2)
    assert plan.scratch_bytes == 4 * 2 * N * L * Lh     # dh_part alone
    fused_render_cuda.backward(g, *bwd_ops)           # build and load first
    torch.cuda.synchronize()
    fused_render_cuda.launches.reset()
    before = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    grads = fused_render_cuda.backward(g, *bwd_ops)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated(cuda) - before
    outputs = 4 * (2 * N * C * L + N * C * Lh + 2 * L * Lh)
    two_slab_du_part = 4 * 2 * N * 2 * C * L
    assert grown < outputs + plan.scratch_bytes + two_slab_du_part
    again = fused_render_cuda.backward(g, *bwd_ops)
    assert fused_render_cuda.launches.backward == 2
    for got, second in zip(grads, again):
        assert torch.equal(got, second)


def _psf_loss_case(device, n_frames, n_stars, n_pix, backend):
    """The batched PSF pixel-phase loss (F,) and its gradients at the point
    of ``psf_pixel_phase_point``, on ``device``."""
    loss, free, consts = psf_pixel_phase_point(n_frames, n_stars, n_pix,
                                               backend, device)
    leaves = [v.requires_grad_(True) for d in free.values()
              for v in d.values()]
    value = loss(free, consts)
    value.sum().backward()
    return value.detach().cpu(), [x.grad.cpu() for x in leaves]


def test_psf_loss_on_cpu_tensors_leaves_launch_counters_at_zero():
    starlet_cuda.launches.reset()
    value, grads = _psf_loss_case("cpu", 2, 3, 12, "fft")
    assert value.shape == (2,) and all(torch.isfinite(g).all()
                                       for g in grads)
    assert (starlet_cuda.launches.forward,
            starlet_cuda.launches.adjoint) == (0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("n_frames,n_stars,n_pix", [(3, 4, 24), (16, 8, 64)])
@pytest.mark.parametrize("backend", ["fft", "matmul"])
def test_psf_loss_gradient_on_the_card_matches_cpu(cuda, n_frames, n_stars,
                                                   n_pix, backend):
    """The batched PSF pixel-phase loss and its gradient: one K1 launch
    each way for all frames on the card, the plain twins on the CPU; the
    test sizes and the full width (16 frames of 8 stars, 64 px, m 128,
    C 8); the matmul render at dft_pad 16."""
    want, want_grads = _psf_loss_case("cpu", n_frames, n_stars, n_pix,
                                      backend)
    starlet_cuda.launches.reset()
    got, got_grads = _psf_loss_case(cuda, n_frames, n_stars, n_pix, backend)
    assert (starlet_cuda.launches.forward,
            starlet_cuda.launches.adjoint) == (1, 1)
    assert (got - want).abs().max().item() <= TOL * want.abs().max().item()
    for g, w in zip(got_grads, want_grads):
        assert (g - w).abs().max().item() <= K2_TOL * w.abs().max().item()


def _non_hermitian_spectrum(device, L, seed):
    """A random (3, L, L // 2 + 1) spectrum, not Hermitian in its DC and
    Nyquist columns (as a shifted source's spectrum is not)."""
    gen = torch.Generator().manual_seed(seed)
    shape = (3, L, L // 2 + 1)
    return torch.complex(torch.randn(shape, generator=gen),
                         torch.randn(shape, generator=gen)).to(device)


@pytest.mark.parametrize("L", [256, 61])
def test_hermitian_irfft2_is_the_cpu_irfft2(L):
    """On the CPU, projecting the DC and Nyquist columns changes pocketfft's
    C2R by rounding only, and its gradient not at all."""
    X = _non_hermitian_spectrum("cpu", L, L)
    g = torch.randn(3, L, L, generator=torch.Generator().manual_seed(1))
    outs, grads = [], []
    for fn in (lambda x: torch.fft.irfft2(x, s=(L, L)),
               lambda x: convolution.hermitian_irfft2(x, L)):
        x = X.clone().requires_grad_(True)
        out = fn(x)
        (out * g).sum().backward()
        outs.append(out.detach())
        grads.append(x.grad)
    assert (outs[1] - outs[0]).abs().max() <= 1e-6 * outs[0].abs().max()
    assert (grads[1] - grads[0]).abs().max() <= 1e-6 * grads[0].abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("L", [256, 160])
def test_hermitian_irfft2_on_the_card_matches_cpu(cuda, L):
    """cuFFT and pocketfft agree once the input is Hermitian where a C2R
    transform needs it."""
    X = _non_hermitian_spectrum("cpu", L, L)
    want = convolution.hermitian_irfft2(X, L)
    got = convolution.hermitian_irfft2(X.to(cuda), L).cpu()
    assert (got - want).abs().max() <= TOL * want.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("n_stars,n_epochs,n_pix", [
    (1, 6, 16), (3, 6, 16), (32, 100, 24)])
def test_k2_grouped_h_matches_plain(cuda, n_stars, n_epochs, n_pix):
    """K2 with a per-star background, G = S groups of N epochs: at the
    test sizes and the full star shape (32 stars x 100 epochs, 24 px:
    3200 render epochs, L 96), forward and backward against the plain
    twins, dh (G, L, Lh)."""
    ops, g = star_k2_operands(n_stars, n_epochs, n_pix, cuda,
                              seed=n_stars)
    assert ops[8].shape[0] == n_stars
    bwd_ops = (*ops[:8], *ops[10:])
    fused_render_cuda.launches.reset()
    out = fused_render_cuda.forward(*ops)
    grads = fused_render_cuda.backward(g, *bwd_ops, n_groups=n_stars)
    torch.cuda.synchronize()
    c = fused_render_cuda.launches
    assert (c.forward_h, c.backward_h) == (1, 1)
    ref = fused_render.render_plain(*ops)
    assert (out - ref).abs().max().item() \
        <= K2_FWD_TOL * ref.abs().max().item()
    refs = fused_render.render_backward_plain(g, *bwd_ops,
                                              n_groups=n_stars)
    assert grads[3].shape == ops[8].shape
    for got, want in zip(grads, refs):
        assert (got - want).abs().max().item() \
            <= K2_BWD_TOL * want.abs().max().item()


@pytest.mark.gpu
def test_k2_one_group_is_the_shared_plane_to_the_bit(cuda):
    """h (1, L, Lh) renders and differentiates to the same bits as the
    shared (L, Lh) plane (ROI-100's operands)."""
    ops, g = _k2_case(cuda, 100, 64, seed=9)
    grouped = (*ops[:8], ops[8][None], ops[9][None], *ops[10:])
    bwd_ops = (*ops[:8], *ops[10:])
    assert torch.equal(fused_render_cuda.forward(*grouped),
                       fused_render_cuda.forward(*ops))
    shared = fused_render_cuda.backward(g, *bwd_ops)
    one = fused_render_cuda.backward(g, *bwd_ops, n_groups=1)
    for got, want in zip(one[:3], shared[:3]):
        assert torch.equal(got, want)
    for got, want in zip(one[3:], shared[3:]):
        assert got.shape == (1,) + want.shape
        assert torch.equal(got[0], want)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["fft", "matmul"])
def test_star_loss_gradient_on_the_card_matches_cpu(cuda, backend):
    """The star photometry's per-star loss with a free background and its
    gradient, card against CPU: on the card K1 runs once each way and,
    on the matmul render, K2 once each way with a per-star h."""
    results = []
    for device in ("cpu", cuda):
        starlet_cuda.launches.reset()
        fused_render_cuda.launches.reset()
        loss, free = star_loss_point(3, 6, 16, backend, True, device)
        leaves = [v.requires_grad_(True) for d in free.values()
                  for v in d.values()]
        value = loss(free)
        value.sum().backward()
        results.append((value.detach().cpu(),
                        [x.grad.cpu() for x in leaves]))
    assert (starlet_cuda.launches.forward,
            starlet_cuda.launches.adjoint) == (1, 1)
    k2 = fused_render_cuda.launches
    assert (k2.forward_h, k2.backward_h) == ((1, 1) if backend == "matmul"
                                             else (0, 0))
    (want, want_grads), (got, got_grads) = results
    assert (got - want).abs().max().item() <= TOL * want.abs().max().item()
    for g, w in zip(got_grads, want_grads):
        assert (g - w).abs().max().item() <= K2_TOL * w.abs().max().item()
