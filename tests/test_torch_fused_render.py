"""Port parity for K2, the fused render, and the matmul-DFT ("matmul",
JAX's "mxu") path around it: model, loss and noise weights.

- The plain K2 forward twin against the Pallas kernel in interpret mode,
  rtol/atol 1e-4 (the JAX package's own bar for that kernel).
- The plain explicit backward against torch autograd of the plain
  forward, in float64 to 1e-10; the autograd Function by gradcheck.
- The all-real render, the loss value and gradient, and the matmul
  branch of the MC noise core against the JAX package on "mxu", at
  max|diff| <= 1e-5 max|ref| (float32; the port folds r_hat and h_hat
  into the spectrum in another order than JAX).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from lightcurver_tpu.core import convolution as jconv
from lightcurver_tpu.core import grids as jgrids
from lightcurver_tpu.core.deconv import loss as jloss
from lightcurver_tpu.core.deconv import model as jmodel
from lightcurver_tpu.core import params as jparams
from lightcurver_tpu.core.starlet import starlet_transform as jstarlet
from lightcurver_tpu.ops import dft as jdft
from lightcurver_tpu.ops.experimental.fused_render import \
    _fused_render_fwd_impl

from lightcurver_tpu_torch.core.deconv import loss as tloss
from lightcurver_tpu_torch.core.deconv import model as tmodel
from lightcurver_tpu_torch.core import noise as tnoise
from lightcurver_tpu_torch.core import params as tparams
from lightcurver_tpu_torch.ops import dft as tdft
from lightcurver_tpu_torch.ops import fused_render as tfr
from lightcurver_tpu_torch.utilities import synthetic as tsyn

from test_torch_deconv import _problem as deconv_problem

N, n, s = 4, 16, 2
m = n * s


def close(out, ref, rel=1e-5):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("include_h", [True, False])
def test_plain_forward_matches_the_pallas_kernel(include_h):
    """At the shape of tests/test_ops_pallas.py (N 8, n 16, s 2, M 3)."""
    rng = np.random.default_rng(7)
    Nk, Mk = 8, 3
    L = 2 * m
    t = jnp.asarray(rng.normal(0, 1, (Nk, m, m)).astype(np.float32))
    t_hat = jnp.fft.rfft2(t, s=(L, L))
    a, px, py = (jnp.asarray(rng.uniform(lo, hi, (Nk, Mk))
                             .astype(np.float32))
                 for lo, hi in ((0.5, 2), (-2, 2), (-2, 2)))
    h_hat = jnp.fft.rfft2(jnp.asarray(
        rng.normal(0, 0.1, (m, m)).astype(np.float32)), s=(L, L))
    cp = jconv.grid_center_phase(m)
    mats = jdft.make_dft_mats(L, m, pool=s)
    u_re, u_im, v = jconv.point_source_ramp_stacks(m, s, a, px, py)
    operands = [np.array(x) for x in (
        u_re, u_im, v, jnp.real(t_hat), jnp.imag(t_hat),
        jconv.r_kernel_fft(m, s), jnp.real(cp), jnp.imag(cp),
        jnp.real(h_hat), jnp.imag(h_hat), mats["Ayp"], mats["Byp"],
        mats["Cxp"], mats["Sxp"])]
    ref = np.asarray(_fused_render_fwd_impl(
        *map(jnp.asarray, operands), include_h=include_h, interpret=True))
    out = tfr.render_plain(*map(torch.from_numpy, operands),
                           include_h=include_h)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def _random_operands(rng, dtype, Nk=3, C=4, L=16, nk=4):
    Lh = L // 2 + 1
    shapes = dict(u_re=(Nk, C, L), u_im=(Nk, C, L), v=(Nk, C, Lh),
                  t_re=(Nk, L, Lh), t_im=(Nk, L, Lh), r_hat=(L, Lh),
                  pc=(L, Lh), ps=(L, Lh), h_re=(L, Lh), h_im=(L, Lh),
                  ayp=(nk, L), byp=(nk, L), cxp=(Lh, nk), sxp=(Lh, nk))
    ops = {k: torch.from_numpy(rng.normal(size=v)).to(dtype)
           for k, v in shapes.items()}
    return ops, torch.from_numpy(rng.normal(size=(Nk, nk, nk))).to(dtype)


@pytest.mark.parametrize("include_h", [True, False])
def test_plain_backward_matches_autograd(include_h):
    ops, g = _random_operands(np.random.default_rng(11), torch.float64)
    free = ("u_re", "u_im", "v") + (("h_re", "h_im") if include_h else ())
    for k in free:
        ops[k].requires_grad_(True)
    tfr.render_plain(**ops, include_h=include_h).backward(g)
    consts = {k: v for k, v in ops.items() if k not in ("h_re", "h_im")}
    grads = tfr.render_backward_plain(
        g, **{k: v.detach() for k, v in consts.items()},
        include_h=include_h)
    for k, got in zip(("u_re", "u_im", "v", "h_re", "h_im"), grads):
        if k in free:
            np.testing.assert_allclose(got.numpy(), ops[k].grad.numpy(),
                                       rtol=0, atol=1e-10)
        else:
            assert got is None


@pytest.mark.parametrize("include_h", [True, False])
def test_function_gradcheck_and_constants(include_h):
    ops, _ = _random_operands(np.random.default_rng(12), torch.float64,
                              Nk=2, C=2, L=8, nk=2)
    free = ("u_re", "u_im", "v") + (("h_re", "h_im") if include_h else ())
    for k in free:
        ops[k].requires_grad_(True)
    if not include_h:
        ops["h_re"] = ops["h_im"] = None

    def fn(*xs):
        return tfr.fused_render(**{**ops, **dict(zip(free, xs))},
                                include_h=include_h)

    assert torch.autograd.gradcheck(fn, tuple(ops[k] for k in free))
    ops["t_re"] = ops["t_re"].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="t_re are constants"):
        tfr.fused_render(**ops, include_h=include_h)


def _problem(n_src, seed):
    """Scene and random kwargs (numpy): N 4, n 16, s 2, n_src sources."""
    rng = np.random.default_rng(seed)
    psf = np.stack([tsyn.moffat_np(m, s, f, f, 2.8)
                    for f in rng.uniform(2.2, 3.5, N)])
    xs = rng.uniform(-3, 3, n_src).astype(np.float32)
    ys = rng.uniform(-3, 3, n_src).astype(np.float32)
    a_true = rng.uniform(40, 120, (N, n_src)).astype(np.float32)
    data = tsyn.render_epochs_np(psf, a_true, xs, ys, s) \
        + rng.normal(0, 0.3, (N, n, n)).astype(np.float32)
    kw = {
        "kwargs_analytic": {
            "a": (a_true * rng.uniform(0.9, 1.1, (N, n_src))).ravel()
            .astype(np.float32),
            "c_x": xs + 0.1, "c_y": ys - 0.1,
            "dx": rng.uniform(-0.2, 0.2, N).astype(np.float32),
            "dy": rng.uniform(-0.2, 0.2, N).astype(np.float32),
            "alpha": rng.uniform(-10, 10, N).astype(np.float32),
        },
        "kwargs_background": {
            "h": rng.normal(0, 0.02, m * m).astype(np.float32),
            "mean": rng.normal(0, 0.05, N).astype(np.float32),
        },
        "kwargs_sersic": {},
    }
    return dict(psf=psf, xs=xs, ys=ys, data=data, kw=kw,
                sigma_2=np.full((N, n, n), 0.09, np.float32))


def _losses(p, fix_h, **terms):
    """JAX Loss on "mxu" and the port's on "matmul", same terms."""
    jm, _, jup, jdown, _ = jmodel.setup_model(p["data"], p["sigma_2"],
                                              p["psf"], p["xs"], p["ys"], s)
    tm, _, tup, tdown, _ = tmodel.setup_model(p["data"], p["sigma_2"],
                                              p["psf"], p["xs"], p["ys"], s,
                                              device="cpu")
    fixed = {"kwargs_analytic": {"alpha": p["kw"]["kwargs_analytic"]
                                 ["alpha"]},
             "kwargs_background": {"h": p["kw"]["kwargs_background"]["h"]}
             if fix_h else {}}
    jp = jparams.Params(jax.tree_util.tree_map(jnp.asarray, p["kw"]),
                        jax.tree_util.tree_map(jnp.asarray, fixed), jup,
                        jdown)
    tp = tparams.Params(tparams.kwargs_from_numpy(p["kw"], "cpu"),
                        tparams.kwargs_from_numpy(fixed, "cpu"), tup, tdown)
    jl = jloss.Loss(p["data"], jm, jp, p["sigma_2"], irfft_backend="mxu",
                    **terms)
    tl = tloss.Loss(p["data"], tm, tp, p["sigma_2"],
                    irfft_backend="matmul", **terms)
    return jm, jl, jp, tm, tl, tp


@pytest.mark.parametrize("n_src,fix_h", [(3, False), (3, True), (1, True),
                                         (1, False)])
def test_all_real_render_matches_jax(n_src, fix_h):
    """(1, True) is the rank-1 branch; the others render through K2."""
    p = _problem(n_src, seed=20 + n_src)
    jm, jl, _, tm, tl, _ = _losses(p, fix_h)
    assert ("fixed_h_render" in jl.consts) == fix_h
    assert set(tl.consts["dft_mats"]) == set(jl.consts["dft_mats"])
    if fix_h:
        close(tl.fixed_h_render, jl.consts["fixed_h_render"])
    kwt = tparams.kwargs_from_numpy(p["kw"], "cpu")
    kwj = jax.tree_util.tree_map(jnp.asarray, p["kw"])
    close(tm.model(kwt, tl.fixed_h_render, tl.consts),
          jm.model(kwj, jl.consts))
    # the cuFFT render of the same model agrees as well
    close(tm.model(kwt), jm.model(kwj, jl.consts))


@pytest.mark.parametrize("h_random", [False, True])
@pytest.mark.parametrize("fix_h", [True, False])
def test_matmul_loss_value_and_gradient(h_random, fix_h):
    """On the problem of test_torch_deconv's loss test, whose cuFFT twin
    holds the same bars. (On other random problems both renders of the
    port differ from JAX by up to ~3e-5 of max|grad a|: 1-ulp
    differences of torch's and XLA's float32 sin/cos in the ramps, summed
    with cancellation by the DFT.)"""
    p = deconv_problem(seed=4, h_random=h_random)
    W = np.random.default_rng(31).uniform(
        0.5, 2.0, (int(np.log2(m)) + 1, m, m)).astype(np.float32)
    terms = dict(regularization_terms="l1_starlet",
                 regularization_strength_scales=1.3,
                 regularization_strength_hf=0.7,
                 regularization_strength_positivity=100.0,
                 regularization_strength_pts_source=0.01,
                 regularization_strength_flux_uniformity=0.5, W=W)
    _, jl, jp, _, tl, tp = _losses(p, fix_h, **terms)
    value_j, grad_j = jax.jit(jax.value_and_grad(jl.loss_fn))(jp.free0,
                                                              jl.consts)
    free = {k: {kk: v.clone().requires_grad_(True) for kk, v in d.items()}
            for k, d in tp.free0.items()}
    value_t = tl.loss_fn(free)
    value_t.backward()
    np.testing.assert_allclose(value_t.item(), float(value_j), rtol=1e-5)
    for k, d in free.items():
        for leaf, v in d.items():
            close(v.grad, grad_j[k][leaf])
    kw = tparams.kwargs_from_numpy(p["kw"], "cpu")
    np.testing.assert_allclose(
        tl(kw).item(),
        float(jl(jax.tree_util.tree_map(jnp.asarray, p["kw"]))), rtol=1e-5)


def test_mc_noise_core_matmul_on_shared_draws():
    """The "mxu" branch of the JAX MC core (core/noise.py:53-61), written
    out here on the same draws, against the port's matmul branch."""
    p = _problem(2, seed=40)
    jm = jmodel.setup_model(p["data"], p["sigma_2"], p["psf"], p["xs"],
                            p["ys"], s)[0]
    tm = tmodel.setup_model(p["data"], p["sigma_2"], p["psf"], p["xs"],
                            p["ys"], s, device="cpu")[0]
    rng = np.random.default_rng(41)
    draws = rng.standard_normal((48, n, n)).astype(np.float32)
    sigma = (0.3 * rng.uniform(0.5, 1.5, (n, n))).astype(np.float32)
    sigma[0, 0] = np.nan
    mean_ps_hat = jm.consts()["ps_hat"].mean(axis=0)
    L = 2 * m
    mats = jdft.make_dft_mats(L, m)

    def one(draw):
        fine = jgrids.upsample_transpose(jnp.where(
            jnp.isfinite(sigma), sigma, 0.0) * draw, s)
        back = jdft.irfft2_crop_matmul(
            jdft.rfft2_pad_matmul(fine, mats) * jnp.conj(mean_ps_hat), mats)
        return jstarlet(back)

    ref = jnp.maximum(jnp.std(jax.vmap(one)(jnp.asarray(draws)), axis=0),
                      1e-12)
    out = tnoise.mc_starlet_noise(torch.from_numpy(sigma),
                                  tm.ps_hat.mean(dim=0), m, s,
                                  torch.from_numpy(draws),
                                  tdft.make_dft_mats(L, m))
    close(out, ref)
    # and the matmul DFT gives the cuFFT weights of the same draws
    close(out, tnoise.mc_starlet_noise(torch.from_numpy(sigma),
                                       tm.ps_hat.mean(dim=0), m, s,
                                       torch.from_numpy(draws)))
