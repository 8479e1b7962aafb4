"""Port parity: geometry, convolution, model, loss, noise, Fisher.

Every input is made with numpy from a seed and both sides are built from
the same host arrays (the torch side through ``kwargs_from_numpy``). JAX
runs on the CPU. Tolerances: rtol 1e-5 on scalars, atol 1e-5 * max|ref|
on arrays (float32 on both sides, sums taken in different orders).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from lightcurver_tpu.core import convolution as jconv
from lightcurver_tpu.core import grids as jgrids
from lightcurver_tpu.core import profiles as jprof
from lightcurver_tpu.core.deconv import model as jmodel
from lightcurver_tpu.core.deconv import loss as jloss
from lightcurver_tpu.core import params as jparams
from lightcurver_tpu.core import fisher as jfisher
from lightcurver_tpu.core import noise as jnoise
from lightcurver_tpu.core.starlet import starlet_transform as jstarlet
from lightcurver_tpu.utilities import synthetic as jsyn

from lightcurver_tpu_torch.core import convolution as tconv
from lightcurver_tpu_torch.core import grids as tgrids
from lightcurver_tpu_torch.core import profiles as tprof
from lightcurver_tpu_torch.core.deconv import model as tmodel
from lightcurver_tpu_torch.core.deconv import loss as tloss
from lightcurver_tpu_torch.core import params as tparams
from lightcurver_tpu_torch.core import fisher as tfisher
from lightcurver_tpu_torch.core import noise as tnoise
from lightcurver_tpu_torch.utilities import synthetic as tsyn

N, n, s, M = 4, 16, 2, 2
m = n * s


def close(out, ref, rel=1e-5):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _problem(seed=0, h_random=False):
    """Scene, kwargs (numpy) and bounds for N=4, n=16, s=2, M=2."""
    rng = np.random.default_rng(seed)
    psf = np.stack([tsyn.moffat_np(m, s, f, f, 2.8)
                    for f in rng.uniform(2.2, 3.5, N)])
    xs = rng.uniform(-3, 3, M).astype(np.float32)
    ys = rng.uniform(-3, 3, M).astype(np.float32)
    a_true = rng.uniform(40, 120, (N, M)).astype(np.float32)
    data = tsyn.render_epochs_np(psf, a_true, xs, ys, s) \
        + rng.normal(0, 0.3, (N, n, n)).astype(np.float32)
    sigma_2 = np.full((N, n, n), 0.09, np.float32)
    kw = {
        "kwargs_analytic": {
            "a": (a_true * rng.uniform(0.9, 1.1, (N, M))).ravel()
            .astype(np.float32),
            "c_x": xs + 0.1, "c_y": ys - 0.1,
            "dx": rng.uniform(-0.2, 0.2, N).astype(np.float32),
            "dy": rng.uniform(-0.2, 0.2, N).astype(np.float32),
            "alpha": rng.uniform(-10, 10, N).astype(np.float32),
        },
        "kwargs_background": {
            "h": (rng.normal(0, 0.02, m * m) if h_random
                  else np.zeros(m * m)).astype(np.float32),
            "mean": rng.normal(0, 0.05, N).astype(np.float32),
        },
        "kwargs_sersic": {},
    }
    return dict(psf=psf, xs=xs, ys=ys, data=data, sigma_2=sigma_2, kw=kw,
                a_true=a_true)


def _jax_kw(kw):
    return jax.tree_util.tree_map(jnp.asarray, kw)


def _models(p):
    jm = jmodel.setup_model(p["data"], p["sigma_2"], p["psf"], p["xs"],
                            p["ys"], s)
    tm = tmodel.setup_model(p["data"], p["sigma_2"], p["psf"], p["xs"],
                            p["ys"], s, device="cpu")
    return jm, tm


def test_grid_and_profile_primitives():
    rng = np.random.default_rng(1)
    fine = rng.normal(size=(3, m, m)).astype(np.float32)
    coarse = rng.normal(size=(3, n, n)).astype(np.float32)
    close(tgrids.downsample(torch.from_numpy(fine), s),
          jgrids.downsample(jnp.asarray(fine), s))
    close(tgrids.upsample_transpose(torch.from_numpy(coarse), s),
          jgrids.upsample_transpose(jnp.asarray(coarse), s))
    for a, b in zip(tgrids.pixel_grid_coords(m, s),
                    jgrids.pixel_grid_coords(m, s)):
        close(a, b)
    close(tprof.gaussian_r_kernel(m, s, 0.3, -1.2),
          jprof.gaussian_r_kernel(m, s, 0.3, -1.2))
    close(tprof.moffat_fine_grid(m, s, 3.0, 2.5, 2.8, 0.2, -0.4, 0.3),
          jprof.moffat_fine_grid(m, s, 3.0, 2.5, 2.8, 0.2, -0.4, 0.3))


@pytest.mark.parametrize("n_src", [1, 3])
def test_convolution_primitives(n_src):
    rng = np.random.default_rng(2)
    close(tconv.r_kernel_fft(m, s), jconv.r_kernel_fft(m, s))
    close(torch.view_as_real(tconv.grid_center_phase(m)),
          np.stack([np.real(jconv.grid_center_phase(m)),
                    np.imag(jconv.grid_center_phase(m))], -1))
    t = rng.normal(size=(2, m, m)).astype(np.float32)
    ref = np.asarray(jconv.psf_fft(jnp.asarray(t)))
    close(torch.view_as_real(tconv.psf_fft(torch.from_numpy(t))),
          np.stack([ref.real, ref.imag], -1))
    a, px, py = (rng.uniform(-3, 3, (N, n_src)).astype(np.float32)
                 for _ in range(3))
    ref = np.asarray(jconv.point_source_spectrum(m, s, a, px, py))
    out = tconv.point_source_spectrum(m, s, *map(torch.from_numpy,
                                                 (a, px, py)))
    close(torch.view_as_real(out), np.stack([ref.real, ref.imag], -1))
    spec = (rng.normal(size=(2, 2 * m, m + 1))
            + 1j * rng.normal(size=(2, 2 * m, m + 1))).astype(np.complex64)
    close(tconv.render_from_fft(torch.from_numpy(spec), m),
          jconv.render_from_fft(jnp.asarray(spec), m))


def test_kwargs_carry_over_and_params():
    p = _problem()
    kw = tparams.kwargs_from_numpy(p["kw"], "cpu")
    assert kw["kwargs_analytic"]["a"].dtype == torch.float32
    back = tparams.kwargs_to_numpy(kw)
    for k in ("a", "c_x", "alpha"):
        np.testing.assert_array_equal(back["kwargs_analytic"][k],
                                      p["kw"]["kwargs_analytic"][k])
    assert back["kwargs_sersic"] == {}

    (_, _, jup, jdown, _), (_, _, tup, tdown, _) = _models(p)
    fixed = {"kwargs_analytic": {"alpha": p["kw"]["kwargs_analytic"]
                                 ["alpha"]},
             "kwargs_background": {"h": p["kw"]["kwargs_background"]["h"]}}
    jp = jparams.Params(_jax_kw(p["kw"]), _jax_kw(fixed), jup, jdown)
    tp = tparams.Params(kw, tparams.kwargs_from_numpy(fixed, "cpu"), tup,
                        tdown)
    for tree_t, tree_j in ((tp.free0, jp.free0), (tp.fixed, jp.fixed),
                           (tp.lower, jp.lower), (tp.upper, jp.upper)):
        jt = jax.tree_util.tree_map(np.asarray, tree_j)
        assert set(tree_t) == set(jt)
        for k in tree_t:
            assert set(tree_t[k]) == set(jt[k])
            for leaf in tree_t[k]:
                np.testing.assert_array_equal(tree_t[k][leaf].numpy(),
                                              jt[k][leaf])
    merged = tp.merge(tp.free0)
    assert set(merged["kwargs_analytic"]) == set(p["kw"]["kwargs_analytic"])
    # the caller's kwargs are never aliased by the Params
    assert tp.free0["kwargs_analytic"]["a"].data_ptr() \
        != kw["kwargs_analytic"]["a"].data_ptr()


@pytest.mark.parametrize("h_random", [False, True])
def test_model_render_and_basis(h_random):
    p = _problem(seed=3, h_random=h_random)
    (jm, *_), (tm, *_) = _models(p)
    kwj, kwt = _jax_kw(p["kw"]), tparams.kwargs_from_numpy(p["kw"], "cpu")
    close(tm.model(kwt), jm.model(kwj))
    fixed_t = tm._h_render(kwt["kwargs_background"]["h"])
    fixed_j = jm._h_render(kwj["kwargs_background"]["h"], jm.consts())
    close(fixed_t, fixed_j)
    close(tm.model(kwt, fixed_h_render=fixed_t),
          jm.model(kwj, {**jm.consts(), "fixed_h_render": fixed_j}))
    close(tm.background_only(kwt), jm.background_only(kwj))
    close(tm.point_source_basis(kwt), jm.point_source_basis(kwj))
    for a, b in zip(tm.getDeconvolved(kwt, 1), jm.getDeconvolved(kwj, 1)):
        close(a, b)
    for a, b in zip(tm.source_positions(kwt), jm.source_positions(kwj)):
        close(a, b)


def _losses(p, fixed_keys, epoch_weights=None):
    """JAX and torch Loss with all five terms and an astrometric prior."""
    (jm, _, jup, jdown, _), (tm, _, tup, tdown, _) = _models(p)
    rng = np.random.default_rng(9)
    W = rng.uniform(0.5, 2.0, (int(np.log2(m)) + 1, m, m)).astype(
        np.float32)
    fixed = {"kwargs_analytic": {"alpha": p["kw"]["kwargs_analytic"]
                                 ["alpha"]},
             "kwargs_background": {k: p["kw"]["kwargs_background"][k]
                                   for k in fixed_keys}}
    prior_spec = [["c_x", p["xs"], np.full(M, 0.5)],
                  ["c_y", p["ys"], np.full(M, 0.7)]]
    terms = dict(regularization_terms="l1_starlet",
                 regularization_strength_scales=1.3,
                 regularization_strength_hf=0.7,
                 regularization_strength_positivity=100.0,
                 regularization_strength_pts_source=0.01,
                 regularization_strength_flux_uniformity=0.5)
    jp = jparams.Params(_jax_kw(p["kw"]), _jax_kw(fixed), jup, jdown)
    jl = jloss.Loss(p["data"], jm, jp, p["sigma_2"], W=W,
                    prior=jloss.Prior(prior_spec),
                    epoch_weights=epoch_weights, **terms)
    tp = tparams.Params(tparams.kwargs_from_numpy(p["kw"], "cpu"),
                        tparams.kwargs_from_numpy(fixed, "cpu"), tup, tdown)
    tl = tloss.Loss(p["data"], tm, tp, p["sigma_2"], W=W,
                    prior=tloss.Prior(prior_spec),
                    epoch_weights=epoch_weights, **terms)
    return jl, jp, tl, tp


@pytest.mark.parametrize("h_random", [False, True])
@pytest.mark.parametrize("fixed_keys,epoch_w", [
    ((), None), (("h",), None), ((), np.array([1, 0, 1, 1], np.float32))])
def test_loss_value_and_gradient(h_random, fixed_keys, epoch_w):
    """All terms, free and fixed h, h = 0 and random; with an epoch
    masked out through the epoch weights."""
    p = _problem(seed=4, h_random=h_random)
    jl, jp, tl, tp = _losses(p, fixed_keys, epoch_w)
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
    # the eager full-kwargs evaluation
    kw = tparams.kwargs_from_numpy(p["kw"], "cpu")
    np.testing.assert_allclose(tl(kw).item(), float(jl(_jax_kw(p["kw"]))),
                               rtol=1e-5)


def test_mc_noise_core_on_shared_draws():
    p = _problem(seed=5)
    (jm, *_), (tm, *_) = _models(p)
    rng = np.random.default_rng(6)
    draws = rng.standard_normal((64, n, n)).astype(np.float32)
    sigma = np.sqrt(p["sigma_2"][0]) * rng.uniform(0.5, 1.5, (n, n)) \
        .astype(np.float32)
    sigma[0, 0] = np.nan
    mean_ps_hat = jm.consts()["ps_hat"].mean(axis=0)
    L = 2 * m

    def one(draw):
        fine = jgrids.upsample_transpose(jnp.where(
            jnp.isfinite(sigma), sigma, 0.0) * draw, s)
        back = jnp.fft.irfft2(jnp.fft.rfft2(fine, s=(L, L))
                              * jnp.conj(mean_ps_hat), s=(L, L))[:m, :m]
        return jstarlet(back)

    ref = jnp.maximum(jnp.std(jax.vmap(one)(jnp.asarray(draws)), axis=0),
                      1e-12)
    out = tnoise.mc_starlet_noise(torch.from_numpy(sigma),
                                  tm.ps_hat.mean(dim=0), m, s,
                                  torch.from_numpy(draws))
    close(out, ref)


def test_epoch_nanmedian_matches_jnp_for_an_even_count():
    """An even count of finite epochs takes the mean of the two middle
    values, as jnp.nanmedian; torch.nanmedian would take the lower."""
    rng = np.random.default_rng(10)
    stack = rng.uniform(0.1, 1.0, (5, n, n)).astype(np.float32)
    stack[4, :, : n // 2] = np.nan     # four finite epochs on the left half
    stack[:, 0, 0] = np.nan            # no finite epoch at all
    ref = np.asarray(jnp.nanmedian(jnp.asarray(stack), axis=0))
    out = tnoise.epoch_nanmedian(torch.from_numpy(stack)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, equal_nan=True)
    lower = torch.nanmedian(torch.from_numpy(stack), dim=0).values.numpy()
    assert np.nanmax(np.abs(lower - ref)) > 1e-3


def test_noise_weights_statistics():
    """W from each package's own generator agrees per detail scale
    within 5 % at 256 samples (the loss never reads the coarse plane)."""
    p = _problem(seed=7)
    (jm, *_), (tm, *_) = _models(p)
    noisemap = np.sqrt(p["sigma_2"])
    noisemap[1, 2, 3] = np.nan
    w_j = np.asarray(jnoise.propagate_noise(jm, noisemap, None,
                                            num_samples=256, seed=3)[0])
    w_t = tnoise.propagate_noise(tm, noisemap, None, num_samples=256,
                                 seed=3)[0].numpy()
    assert w_t.shape == w_j.shape
    per_scale_t = w_t[:-1].mean(axis=(1, 2))
    per_scale_j = w_j[:-1].mean(axis=(1, 2))
    np.testing.assert_allclose(per_scale_t, per_scale_j, rtol=0.05)


def test_flux_solve_and_fisher_errors():
    p = _problem(seed=8, h_random=True)
    (jm, *_), (tm, *_) = _models(p)
    kwj, kwt = _jax_kw(p["kw"]), tparams.kwargs_from_numpy(p["kw"], "cpu")
    data = p["data"].copy()
    data[0, 1, 1] = np.nan
    ref = jfisher.linear_flux_solve(kwj, jnp.asarray(data),
                                    jnp.asarray(p["sigma_2"]), jm)
    out = tfisher.linear_flux_solve(kwt, torch.from_numpy(data),
                                    torch.from_numpy(p["sigma_2"]), tm)
    np.testing.assert_allclose(out["kwargs_analytic"]["a"].numpy(),
                               np.asarray(ref["kwargs_analytic"]["a"]),
                               rtol=1e-5)
    noise = np.sqrt(p["sigma_2"])
    err_j = jfisher.get_flux_uncertainties(kwj, None, None, None, noise, jm)
    err_t = tfisher.get_flux_uncertainties(kwt, None, None, None,
                                           torch.from_numpy(noise), tm)
    np.testing.assert_allclose(err_t, err_j, rtol=1e-5)


def test_synthetic_scene_is_the_same():
    a = jsyn.make_roi_scene(n_epochs=3, n_pix=12, s=2, n_sources=3, seed=4)
    b = tsyn.make_roi_scene(n_epochs=3, n_pix=12, s=2, n_sources=3, seed=4)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))
