"""Port parity for the star-batched joint photometry (``fit_stars_batched``).

Held against the JAX package on the CPU: K2's per-star background (plain
twin), the pooled render branches and the GLS flux solve on "mxu", the
Monte-Carlo noise weights over a star axis, the per-star loss and its
gradient, and the whole fit against JAX's ``fit_stars_batched(mesh=None)``
on both renders (the port's "matmul" against JAX's "mxu") and both flag
settings, on one bucket of 3 stars whose real epochs (6, 5, 4) are padded
to 6 as the star-photometry task pads them. JAX's render is chosen by its
module switch (``ops._IRFFT_BACKEND``, monkeypatched) and ``mesh=None``
keeps it on one device.

Tolerances: deterministic pieces 1e-5 of the reference (float32 on both
sides, sums in other orders); fits at equal budgets 1 mmag in flux, rtol
1e-3 in the flux errors and 1 % in chi2 (BASELINE.json's photometric
bars).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightcurver_tpu import ops as jops
from lightcurver_tpu.core import noise as jnoise
from lightcurver_tpu.core.deconv import batched as jbatched
from lightcurver_tpu.core.deconv import model as jmodel
from lightcurver_tpu.core import fisher as jfisher
from lightcurver_tpu.core.starlet import n_starlet_scales
from lightcurver_tpu.ops.dft import make_dft_mats as jmake_dft_mats
from lightcurver_tpu.utilities.synthetic import make_star_stamps

from lightcurver_tpu_torch.core.deconv import batched as tbatched
from lightcurver_tpu_torch.core.deconv import model as tmodel
from lightcurver_tpu_torch.core import fisher as tfisher
from lightcurver_tpu_torch.core import noise as tnoise
from lightcurver_tpu_torch.core.params import kwargs_from_numpy
from lightcurver_tpu_torch.ops import dft as tdft, fused_render
from lightcurver_tpu_torch.processes import roi_modelling as troi
from lightcurver_tpu_torch.utilities import synthetic as tsyn

TOL = 1e-5
S_STARS, N_EPOCHS, N_PIX, S = 3, 6, 16, 2
N_REAL = (6, 5, 4)
M_FINE = N_PIX * S
N_ITER = 40
RENDERS = [("fft", "fft"), ("matmul", "mxu")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """As in the calibration chain's file: one intra-op thread beside the
    suite's other workers, which would otherwise all spin threads on the
    same cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(out, ref, rel=TOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


@pytest.fixture(scope="module")
def scene():
    return tsyn.star_photometry_scene(S_STARS, N_EPOCHS, N_PIX, S,
                                      n_real=N_REAL)


def _jax_keys(seed=0):
    return np.asarray(jax.random.split(jax.random.PRNGKey(seed), S_STARS))


def _jax_prepare(sc, uniform, starlet, jax_backend):
    """JAX's per-star set-up under vmap: (free0, consts with the shared
    DFT matrices merged, scale)."""
    free, _, _, consts, scale = jbatched._prepare_stars(
        jnp.asarray(sc["data"]), jnp.asarray(sc["sigma"]),
        jnp.asarray(sc["psf"]), _jax_keys(), N_EPOCHS, N_PIX, S, uniform,
        starlet, jax_backend, dft_precision=jops.get_dft_precision())
    shared = jbatched._shared_consts(N_PIX, S, jax_backend)
    return free, consts, shared, scale


def test_star_photometry_scene_is_the_bench_bucket(scene):
    """The stamps of bench.py::run_star_photometry_bench, padded as
    processes/star_photometry.py::_dispatch_star_jobs pads a bucket."""
    for i, k in enumerate(N_REAL):
        st = make_star_stamps(n_stars=N_EPOCHS, n_pix=N_PIX, s=S,
                              seed=30 + i, fwhm_x=2.6, fwhm_y=2.6)
        np.testing.assert_array_equal(scene["data"][i, :k], st["data"][:k])
        np.testing.assert_array_equal(scene["sigma"][i, :k],
                                      st["sigma"][:k])
        assert (scene["data"][i, k:] == 0).all()
        assert (scene["sigma"][i, k:] == 1e7).all()
        assert (scene["psf"][i] == st["psf_true"]).all()
        np.testing.assert_array_equal(scene["a_true"][i, :k],
                                      st["a_true"][:k])


@pytest.mark.parametrize("n_stars", [1, 3])
def test_k2_grouped_h_plain_twin_is_a_loop_of_single_calls(n_stars):
    """K2's plain twin with h (G, L, Lh): the render and the gradients of
    (u_re, u_im, v, h_re, h_im) through the autograd Function equal a
    loop of calls on each group's epochs with its (L, Lh) plane (1e-6 of
    max: the same sums, batched otherwise), and G = 1 equals the shared
    (L, Lh) plane to the bit."""
    n_epochs = 4
    ops, g = tsyn.star_k2_operands(n_stars, n_epochs, 12, "cpu",
                                   seed=4 + n_stars)
    free = [x.clone().requires_grad_(True) for x in (*ops[:3], *ops[8:10])]

    def run(u_re, u_im, v, h_re, h_im, consts, g):
        out = fused_render.fused_render(
            u_re, u_im, v, *consts[:5], h_re, h_im, *consts[5:])
        (out * g).sum().backward()
        return out

    consts = (*ops[3:8], *ops[10:])
    out = run(*free, consts, g)
    for k in range(n_stars):
        ep = slice(k * n_epochs, (k + 1) * n_epochs)
        one = [x[ep].clone().requires_grad_(True) for x in ops[:3]] \
            + [x[k].clone().requires_grad_(True) for x in ops[8:10]]
        ref = run(*one, (ops[3][ep], ops[4][ep], *ops[5:8], *ops[10:]),
                  g[ep])
        close(out[ep].detach(), ref.detach(), 1e-6)
        for got, want in zip(free[:3], one[:3]):
            close(got.grad[ep], want.grad, 1e-6)
        for got, want in zip(free[3:], one[3:]):
            close(got.grad[k], want.grad, 1e-6)
    if n_stars == 1:
        shared = [x.clone().requires_grad_(True)
                  for x in (*ops[:3], ops[8][0], ops[9][0])]
        ref = run(*shared, consts, g)
        assert torch.equal(out, ref)
        for got, want in zip(free, shared):
            assert torch.equal(got.grad.reshape(want.grad.shape), want.grad)


def _roi_point(seed=3):
    """A 2-source problem (4 epochs, 16 px) with a random background, as
    numpy kwargs; for the pooled branches of the model and the solve."""
    rng = np.random.default_rng(seed)
    N, M = 4, 2
    psf = np.stack([tsyn.moffat_np(M_FINE, S, f, f, 2.8)
                    for f in rng.uniform(2.2, 3.5, N)])
    xs = rng.uniform(-3, 3, M).astype(np.float32)
    ys = rng.uniform(-3, 3, M).astype(np.float32)
    a_true = rng.uniform(40, 120, (N, M)).astype(np.float32)
    data = tsyn.render_epochs_np(psf, a_true, xs, ys, S) \
        + rng.normal(0, 0.3, (N, N_PIX, N_PIX)).astype(np.float32)
    kw = {"kwargs_analytic": {
        "a": a_true.ravel(), "c_x": xs + 0.1, "c_y": ys - 0.1,
        "dx": rng.uniform(-0.2, 0.2, N).astype(np.float32),
        "dy": rng.uniform(-0.2, 0.2, N).astype(np.float32),
        "alpha": rng.uniform(-10, 10, N).astype(np.float32)},
        "kwargs_background": {
            "h": rng.normal(0, 0.02, M_FINE**2).astype(np.float32),
            "mean": rng.normal(0, 0.05, N).astype(np.float32)}}
    return psf.astype(np.float32), data, kw


@pytest.mark.parametrize("branch", ["all_real", "pooled"])
def test_pooled_background_basis_and_flux_solve_match_jax(branch):
    """``background_only``, ``point_source_basis`` and ``linear_flux_solve``
    on the matmul render against JAX's on "mxu": with the raw spectra
    (the all-real branch of background_only) and with the DFT matrices
    alone (the star finalize's pooled branches)."""
    psf, data, kw = _roi_point()
    N = data.shape[0]
    sigma_2 = np.full_like(data, 0.09)
    jm = jmodel.DeconvModel(psf, S, N_PIX, N, 2)
    mats = jmake_dft_mats(2 * M_FINE, M_FINE, pool=S)
    jconsts = {**jm.spectra(), "dft_mats": mats}
    tm = tmodel.DeconvModel(torch.as_tensor(psf), S, N_PIX, N, 2)
    tconsts = tm.matmul_consts()
    if branch == "all_real":
        jconsts.update(jm.spectra_real())
    else:
        tconsts = {"dft_mats": tconsts["dft_mats"]}
    jkw = jax.tree_util.tree_map(jnp.asarray, kw)
    tkw = kwargs_from_numpy(kw, "cpu")
    close(tm.background_only(tkw, None, tconsts),
          jm.background_only(jkw, jconsts))
    close(tm.point_source_basis(tkw, tconsts),
          jm.point_source_basis(jkw, jconsts))
    ref = jfisher.linear_flux_solve(jkw, jnp.asarray(data),
                                    jnp.asarray(sigma_2), jm, jconsts)
    out = tfisher.linear_flux_solve(tkw, torch.as_tensor(data),
                                    torch.as_tensor(sigma_2), tm, tconsts)
    close(out["kwargs_analytic"]["a"], ref["kwargs_analytic"]["a"])
    basis = jm.point_source_basis(jkw, jconsts)
    close(tfisher._diag_fisher(tm.point_source_basis(tkw, tconsts),
                               torch.as_tensor(sigma_2)),
          jfisher._diag_fisher(basis, jnp.asarray(sigma_2)))


@pytest.mark.parametrize("backend,jax_backend", RENDERS)
def test_mc_weights_over_stars_match_jax(backend, jax_backend):
    """The Monte-Carlo weights of 2 stars in one call against JAX's
    ``_mc_starlet_noise`` star by star, on JAX's own normal draws (64
    samples a star) handed to the port."""
    rng = np.random.default_rng(11)
    K, n_sc = 64, n_starlet_scales(M_FINE)
    sigma = rng.uniform(0.5, 1.5, (2, N_PIX, N_PIX)).astype(np.float32)
    sigma[1, 0, 0] = np.nan
    psf = np.stack([tsyn.moffat_np(M_FINE, S, f, f, 2.8) for f in (2.4,
                                                                   3.1)])
    jmats = jmake_dft_mats(2 * M_FINE, M_FINE, pool=S) \
        if jax_backend == "mxu" else None
    tmats = tdft.make_dft_mats(2 * M_FINE, M_FINE, pool=S) \
        if backend == "matmul" else None
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    refs, draws, spectra = [], [], []
    for i in range(2):
        ps_hat = jmodel.DeconvModel(psf[i:i + 1], S, N_PIX, 1, 1) \
            .spectra(dft_mats=jmats)["ps_hat"][0]
        refs.append(jnoise._mc_starlet_noise(
            jnp.asarray(sigma[i]), ps_hat, M_FINE, S, K, n_sc, keys[i],
            jmats, dft_precision=jops.get_dft_precision()))
        draws.append(np.stack([jax.random.normal(k, (N_PIX, N_PIX))
                               for k in jax.random.split(keys[i], K)]))
        spectra.append(np.asarray(ps_hat))
    out = tnoise.mc_starlet_noise(
        torch.as_tensor(sigma), torch.as_tensor(np.stack(spectra)), M_FINE,
        S, torch.as_tensor(np.stack(draws)), tmats)
    assert out.shape == (2, n_sc + 1, M_FINE, M_FINE)
    for i in range(2):
        close(out[i], refs[i])


def _point(free, rng):
    """A non-trivial point near the set-up's start, as numpy leaves."""
    free = jax.tree_util.tree_map(np.array, free)
    ka, kb = free["kwargs_analytic"], free["kwargs_background"]
    ka["a"] = ka["a"] * (1 + 0.02 * rng.normal(size=ka["a"].shape))
    for key, width in (("c_x", 0.3), ("c_y", 0.3), ("dx", 0.2),
                       ("dy", 0.2)):
        ka[key] = rng.uniform(-width, width, ka[key].shape)
    if "h" in kb:
        kb["h"] = 1e-3 * rng.normal(size=kb["h"].shape)
    if "mean" in kb:
        kb["mean"] = 1e-3 * rng.normal(size=kb["mean"].shape)
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), free)


@pytest.mark.parametrize("backend,jax_backend", RENDERS)
@pytest.mark.parametrize("uniform,starlet", [(True, False), (False, True)])
def test_star_loss_and_gradient_match_jax(scene, backend, jax_backend,
                                          uniform, starlet):
    """The port's set-up (scale, flux guess from the border medians,
    epoch mask) and its per-star loss (S,) with its gradient, against
    JAX's ``_prepare_one_star`` and ``_star_loss_fn`` under ``jax.vmap``
    at a point off the start (JAX's W handed over), 1e-5 relative: a free
    per-epoch mean with h fixed (the shipped flags' render), and a free
    background under the starlet l1 (the fit test below covers the
    shipped flags whole)."""
    jfree, jconsts, shared, jscale = _jax_prepare(scene, uniform, starlet,
                                                  jax_backend)
    W = np.asarray(jconsts["W"]) if starlet else None
    model, tfree, lower, upper, tconsts, tscale = tbatched._prepare_stars(
        torch.as_tensor(scene["data"]), torch.as_tensor(scene["sigma"]),
        torch.as_tensor(scene["psf"]), S, uniform, starlet, backend, 0, W)
    close(tscale, jscale)
    close(tfree["kwargs_analytic"]["a"], jfree["kwargs_analytic"]["a"])
    close(tconsts["epoch_w"], jconsts["epoch_w"])
    close(tconsts["sigma_2"].reshape(jconsts["sigma_2"].shape),
          jconsts["sigma_2"])
    assert set(tfree["kwargs_background"]) \
        == set(jfree["kwargs_background"])
    assert lower["kwargs_analytic"]["c_x"].item() == -5.0

    point = _point(jfree, np.random.default_rng(2))
    loss_fn = jbatched._star_loss_fn(N_EPOCHS, N_PIX, S, starlet,
                                     jops.get_dft_precision())
    ref, ref_grad = jax.vmap(jax.value_and_grad(
        lambda f, c: loss_fn(f, {**c, **shared})))(
            jax.tree_util.tree_map(jnp.asarray, point), jconsts)
    tpoint = kwargs_from_numpy(
        {k: v for k, v in point.items() if k != "kwargs_sersic"}, "cpu")
    leaves = [v.requires_grad_(True) for d in tpoint.values()
              for v in d.values()]
    value = tbatched._star_losses(model, tconsts, S_STARS)(tpoint)
    value.sum().backward()
    np.testing.assert_allclose(value.detach().numpy(), ref, rtol=TOL)
    names = [(g, k) for g, d in tpoint.items() for k in d]
    for (group, key), leaf in zip(names, leaves):
        close(leaf.grad, ref_grad[group][key])


def _fit_both(scene, backend, jax_backend, starlet, monkeypatch):
    monkeypatch.setattr(jops, "_IRFFT_BACKEND", jax_backend)
    W = None
    if starlet:
        W = np.asarray(_jax_prepare(scene, False, True,
                                    jax_backend)[1]["W"])
    ref = jbatched.fit_stars_batched(
        scene["data"], scene["sigma"], scene["psf"], S, n_iter=N_ITER,
        starlet_global_background=starlet, mesh=None)
    out = tbatched.fit_stars_batched(
        scene["data"], scene["sigma"], scene["psf"], S, n_iter=N_ITER,
        starlet_global_background=starlet, device="cpu",
        irfft_backend=backend, noise_weights=W)
    return out, ref


@pytest.mark.parametrize("backend,jax_backend", RENDERS)
@pytest.mark.parametrize("starlet", [False, True])
def test_fit_stars_batched_matches_jax(scene, backend, jax_backend, starlet,
                                       monkeypatch):
    """The whole fit at equal budgets (40 AdaBelief iterations), 3 stars
    with 6, 5 and 4 real epochs padded to 6, against JAX's
    ``fit_stars_batched(mesh=None)``; with a free background JAX's W is
    handed over. Fluxes within 1 mmag and errors rtol 1e-3 on the real
    epochs, chi2 within 1 %, JAX's keys and shapes."""
    out, ref = _fit_both(scene, backend, jax_backend, starlet, monkeypatch)
    assert set(out) == set(ref)
    for key, value in ref.items():
        assert out[key].shape == value.shape, key
    real = np.isfinite(scene["a_true"])
    dmag = 2.5 * np.log10(out["fluxes"][real] / ref["fluxes"][real])
    assert np.abs(dmag).max() <= 1e-3
    np.testing.assert_allclose(out["fluxes_uncertainties"][real],
                               ref["fluxes_uncertainties"][real], rtol=1e-3)
    np.testing.assert_allclose(out["chi2"], ref["chi2"], rtol=0.01)
    np.testing.assert_allclose(out["chi2_per_frame"][real],
                               ref["chi2_per_frame"][real], rtol=0.01)
    np.testing.assert_allclose(out["loss_history"][:, 0],
                               ref["loss_history"][:, 0], rtol=TOL)
    close(out["residuals"][real], ref["residuals"][real], 1e-2)
    if starlet:
        assert np.abs(out["starlet_background"]).max() > 0
    assert tbatched.EPOCH_AXIS_RESULT_KEYS == jbatched.EPOCH_AXIS_RESULT_KEYS


def test_sanitisation_of_nan_data_and_psf(scene):
    """A NaN datum is the fit with that pixel at data 0 and noise 1e7, to
    the bit; a NaN PSF pixel is a zero; the results stay finite."""
    data, sigma, psf = (scene[k].copy() for k in ("data", "sigma", "psf"))
    data[0, 1, 5, 5] = np.nan
    sigma[1, 2, 3, 4] = np.inf
    psf[2, 0, 10, 10] = np.nan
    kw = dict(n_iter=5, device="cpu")
    out = tbatched.fit_stars_batched(data, sigma, psf, S, **kw)
    for k in ("fluxes", "fluxes_uncertainties", "chi2", "residuals"):
        real = np.isfinite(scene["a_true"]) if out[k].ndim > 1 else True
        assert np.isfinite(out[k][real]).all(), k
    data[0, 1, 5, 5] = data[1, 2, 3, 4] = 0.0
    sigma[0, 1, 5, 5] = sigma[1, 2, 3, 4] = 1e7
    psf[2, 0, 10, 10] = 0.0
    clean = tbatched.fit_stars_batched(data, sigma, psf, S, **kw)
    for key, value in clean.items():
        np.testing.assert_array_equal(out[key], value, err_msg=key)


def test_entry_point_defaults_and_deferred_options(scene):
    """The fit runs on the card unless asked (no CPU fallback: here it
    raises), ``fetch="device"`` returns tensors and refuses a checkpoint
    path, and the option that is not ported raises and names its
    ROADMAP.md item."""
    args = (scene["data"], scene["sigma"], scene["psf"], S)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tbatched.fit_stars_batched(*args, n_iter=1)
    out = tbatched.fit_stars_batched(*args, n_iter=2, device="cpu",
                                     fetch="device")
    assert isinstance(out["chi2"], torch.Tensor)
    assert out["loss_history"].shape == (S_STARS, 2)
    with pytest.raises(ValueError, match="fetch='device'"):
        tbatched.fit_stars_batched(*args, device="cpu", fetch="device",
                                   checkpoint_path="star.ckpt")
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        tbatched.fit_stars_batched(*args, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="irfft_backend"):
        tbatched.fit_stars_batched(*args, device="cpu", irfft_backend="mxu")
    with pytest.raises(ValueError, match="noise_weights"):
        tbatched.fit_stars_batched(*args, n_iter=1, device="cpu",
                                   starlet_global_background=True,
                                   noise_weights=np.ones((1, 2, 3)))


def test_fit_roi_runs_on_the_card_by_default():
    """``fit_roi`` called without ``device`` goes to the card: on a machine
    without CUDA that is torch's missing-CUDA error, not a TypeError for
    a missing argument."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default would run")
    sc = tsyn.make_roi_scene(n_epochs=2, n_pix=8, s=2, n_sources=1, seed=1)
    with pytest.raises((RuntimeError, AssertionError)) as err:
        troi.fit_roi(sc["data"], np.sqrt(sc["sigma_2"]), sc["psf"],
                     sc["xs"] + 3.5, sc["ys"] + 3.5, 2, sc["fwhm"], 1.0,
                     [0.0, 0.0], troi.ROI_CONFIG)
    assert "CUDA" in str(err.value)
