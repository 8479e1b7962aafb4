"""Port parity: the narrow-PSF fit (build_psf, build_psf_batched).

Each test runs the JAX function (JAX on the CPU) and its counterpart in
``lightcurver_tpu_torch`` on the same numpy inputs, on the CPU, at the
sizes of ``tests/test_batched_psf.py`` (3 frames of 4 stars, 24 px,
s = 2, so m = 48). Bars:

- deterministic pieces (renders, losses, gradients, noise weights): 1e-5
  relative, or 1e-5 of max|JAX|;
- the batched optimizers: AdaBelief histories 1e-5 relative (the same
  algorithm), L-BFGS per-frame final losses 1e-3 relative (the line
  search is optax's, in another order of operations);
- fitted results at equal budgets: see the fit tests.

The JAX package selects its matmul render ("mxu") by a module switch;
the tests set it and put it back.
"""

import contextlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from lightcurver_tpu import ops as jops
from lightcurver_tpu.core import optimize as jopt
from lightcurver_tpu.core.psf import batched as jbatched
from lightcurver_tpu.core.psf import build as jbuild
from lightcurver_tpu.core.psf import distortion as jdist
from lightcurver_tpu.core.psf.model import PSFModel as JPSFModel
from lightcurver_tpu.ops import dft as jdft
from lightcurver_tpu.utilities import synthetic as jsynth

from lightcurver_tpu_torch.core import optimize as topt
from lightcurver_tpu_torch.core.params import kwargs_from_numpy
from lightcurver_tpu_torch.core.psf import batched as tbatched
from lightcurver_tpu_torch.core.psf import build as tbuild
from lightcurver_tpu_torch.core.psf import distortion as tdist
from lightcurver_tpu_torch.core.psf.model import PSFModel as TPSFModel
from lightcurver_tpu_torch.ops import dft as tdft
from lightcurver_tpu_torch.utilities import synthetic as tsynth

N_STARS, N_PIX, S = 4, 24, 2
M = N_PIX * S
TOL = 1e-5

# (port render, dft_pad); JAX's name for "matmul" is "mxu"
RENDERS = [("fft", None), ("matmul", None), ("matmul", 16)]


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


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"max|diff| {err:.3e} > {tol:.0e} x {scale:.3e}"


@contextlib.contextmanager
def _jax_render(backend):
    prev = jops.get_irfft_backend()
    jops.set_irfft_backend("mxu" if backend == "matmul" else "fft")
    try:
        yield
    finally:
        jops.set_irfft_backend(prev)


def _mats(backend, dft_pad):
    """(JAX dft_mats, port dft_mats) of a render, or (None, None)."""
    if backend == "fft":
        return None, None
    L = jbuild.psf_fft_length(M, S, dft_pad)
    return (jdft.make_dft_mats(L, M, pool=S),
            tdft.make_dft_mats(L, M, pool=S, device="cpu"))


def _point(seed, batch=()):
    """A PSF parameter point (numpy), away from every bound and kink."""
    rng = np.random.default_rng(seed)

    def u(lo, hi, shape=()):
        return rng.uniform(lo, hi, batch + shape).astype(np.float32)

    return {
        "kwargs_moffat": {"fwhm_x": u(2.4, 3.0), "fwhm_y": u(2.2, 2.8),
                          "beta": u(2.3, 3.0)},
        "kwargs_gaussian": {"a": u(0.5, 2.0, (N_STARS,)),
                            "x0": u(-0.6, 0.6, (N_STARS,)),
                            "y0": u(-0.6, 0.6, (N_STARS,))},
        "kwargs_background": {"background": (1e-4 * rng.normal(
            0, 1, batch + (M * M,))).astype(np.float32)},
        "kwargs_distortion": {k: u(-0.05, 0.05, (5,))
                              for k in ("dilation_x", "dilation_y",
                                        "shear")},
    }


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def frames():
    return [jsynth.make_star_stamps(n_stars=N_STARS, n_pix=N_PIX, s=S,
                                    seed=i, fwhm_x=2.5 + 0.3 * i,
                                    fwhm_y=2.5 + 0.3 * i)
            for i in range(3)]


def test_make_star_stamps_is_the_same_bits():
    for seed in (0, 5):
        want = jsynth.make_star_stamps(n_stars=3, n_pix=20, s=2, seed=seed,
                                       fwhm_x=2.7, fwhm_y=2.4)
        got = tsynth.make_star_stamps(n_stars=3, n_pix=20, s=2, seed=seed,
                                      fwhm_x=2.7, fwhm_y=2.4)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("m,s,pad", [(64, 2, None), (64, 2, 8), (48, 2, 16),
                                     (128, 2, 16), (64, 2, 100),
                                     (64, 2, 4), (48, 3, 11)])
def test_psf_fft_length_and_bounds_match(m, s, pad):
    try:
        want = jbuild.psf_fft_length(m, s, pad)
    except ValueError as err:
        with pytest.raises(ValueError, match="safe minimum"):
            tbuild.psf_fft_length(m, s, pad)
        assert "safe minimum" in str(err)
    else:
        assert tbuild.psf_fft_length(m, s, pad) == want
    assert tbuild.psf_bound_values(m // s) == jbuild.psf_bound_values(m // s)


@pytest.mark.parametrize("backend,dft_pad", RENDERS)
@pytest.mark.parametrize("field_distortion", [False, True])
def test_model_renders_match_jax(backend, dft_pad, field_distortion):
    """narrow_psf, full_psf and the stamps, on each render branch: cuFFT,
    the rank-1 matmul (no distortion) and the per-star pooled matmul
    (distortion), at L = 2m and at the reduced L of dft_pad 16."""
    point = _point(1)
    coords = np.random.default_rng(2).uniform(
        -1, 1, (N_STARS, 2)).astype(np.float32)
    jm = JPSFModel(N_STARS, N_PIX, S, field_distortion=field_distortion)
    tm = TPSFModel(N_STARS, N_PIX, S, field_distortion=field_distortion)
    jmats, tmats = _mats(backend, dft_pad)
    jkw, tkw = _jax_tree(point), kwargs_from_numpy(point, "cpu")
    _close(tm.narrow_psf(tkw), jm.narrow_psf(jkw))
    _close(tm.full_psf(tkw, dft_mats=tmats),
           jm.full_psf(jkw, dft_mats=jmats))
    got = tm.model(tkw, torch.as_tensor(coords), tmats)
    assert got.shape == (N_STARS, N_PIX, N_PIX)
    _close(got, jm.model(jkw, jnp.asarray(coords), jmats))


def test_model_takes_a_batch_of_frames():
    """Frame-batched parameters (F, ...) render as F separate frames."""
    point = _point(3, batch=(3,))
    coords = np.random.default_rng(4).uniform(
        -1, 1, (3, N_STARS, 2)).astype(np.float32)
    for field_distortion in (False, True):
        tm = TPSFModel(N_STARS, N_PIX, S, field_distortion=field_distortion)
        for backend, dft_pad in RENDERS:
            _, tmats = _mats(backend, dft_pad)
            out = tm.model(kwargs_from_numpy(point, "cpu"),
                           torch.as_tensor(coords), tmats)
            for f in range(3):
                one = jax.tree_util.tree_map(lambda x: x[f], point)
                ref = tm.model(kwargs_from_numpy(one, "cpu"),
                               torch.as_tensor(coords[f]), tmats)
                _close(out[f], ref)


@pytest.mark.parametrize("fields", [
    (0.0, 0.0, 0.0),            # exact-integer sample points
    (0.05, -0.03, 0.02),
    (0.4, 0.3, -0.45),          # samples far outside the grid at the edges
    (-0.45, -0.4, 0.3)])
def test_warp_psf_matches_jax(fields):
    rng = np.random.default_rng(7)
    psf = rng.uniform(0.1, 1.0, (M, M)).astype(np.float32)   # bright edges
    want = jdist.warp_psf(jnp.asarray(psf), *map(jnp.float32, fields))
    got = tdist.warp_psf(torch.as_tensor(psf),
                         *(torch.tensor(f) for f in fields))
    _close(got, want)
    if fields == (0.0, 0.0, 0.0):
        np.testing.assert_array_equal(got.numpy(), psf)


def test_warp_psf_is_differentiable_in_the_fields():
    psf = jnp.asarray(jsynth.moffat_np(M, S, 2.6, 2.4, 2.7))
    fields = np.array([0.07, -0.04, 0.03], np.float32)
    w = np.random.default_rng(8).normal(0, 1, (M, M)).astype(np.float32)
    want = jax.grad(lambda f: jnp.sum(jnp.asarray(w) * jdist.warp_psf(
        psf, f[0], f[1], f[2])))(jnp.asarray(fields))
    f = torch.tensor(fields, requires_grad=True)
    (torch.as_tensor(w) * tdist.warp_psf(torch.as_tensor(np.array(psf)),
                                         f[0], f[1], f[2])).sum().backward()
    _close(f.grad, want)


def test_apply_distortion_matches_jax():
    psf = jsynth.moffat_np(M, S, 2.6, 2.4, 2.7)
    coeffs = {k: v for k, v in _point(9)["kwargs_distortion"].items()}
    for xy in (np.array([0.3, -0.8], np.float32),
               np.random.default_rng(9).uniform(-1, 1, (5, 2)).astype(
                   np.float32)):
        want = jdist.apply_distortion(psf, _jax_tree(coeffs), xy)
        got = tdist.apply_distortion(psf, coeffs, xy, device="cpu")
        _close(got, want)


def test_masked_chi2_per_star_matches_jax():
    rng = np.random.default_rng(10)
    shape = (2, N_STARS, N_PIX, N_PIX)
    data, model = rng.normal(0, 1, (2,) + shape).astype(np.float32)
    sigma_2 = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    masks = rng.uniform(0, 1, shape) > 0.2
    masks[0, 1] = False                         # a fully masked star
    want = jbuild._masked_chi2_per_star(*map(jnp.asarray, (data, model,
                                                           sigma_2, masks)))
    got = tbuild._masked_chi2_per_star(*map(torch.as_tensor,
                                            (data, model, sigma_2, masks)))
    _close(got, want)
    assert got[0, 1] == 0.0


def _phase_case(frames, backend, dft_pad, mask_first_star):
    """Consts of one frame for both packages, and a parameter point."""
    st = frames[0]
    data = st["data"] / st["data"].max()
    sigma_2 = (st["sigma"] / st["data"].max()) ** 2
    masks = np.isfinite(data)
    if mask_first_star:
        masks[0] = False
    W = np.random.default_rng(11).uniform(
        0.01, 0.05, (int(np.log2(M)) + 1, M, M)).astype(np.float32)
    coords = np.random.default_rng(12).uniform(
        -1, 1, (N_STARS, 2)).astype(np.float32)
    jmats, tmats = _mats(backend, dft_pad)
    arrays = {"data": data.astype(np.float32),
              "sigma_2": sigma_2.astype(np.float32), "masks": masks,
              "stamp_coordinates": coords, "W": W,
              "lam": np.float32(1.3)}
    jconsts = {k: jnp.asarray(v) for k, v in arrays.items()}
    if jmats is not None:
        jconsts["dft_mats"] = jmats
    tconsts = {k: torch.as_tensor(v) for k, v in arrays.items()}
    tconsts["dft_mats"] = tmats
    return jconsts, tconsts, _point(13)


@pytest.mark.parametrize("backend,dft_pad", RENDERS)
@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("mask_first_star", [False, True])
def test_phase_losses_and_gradients_match_jax(frames, backend, dft_pad,
                                              phase, mask_first_star):
    """Both phase losses and their gradients at one parameter point carried
    across (kwargs_from_numpy); with star 0 fully masked the pin moves to
    star 1. Phase 2 fits the distortion too."""
    field_distortion = phase == 2
    jconsts, tconsts, point = _phase_case(frames, backend, dft_pad,
                                          mask_first_star)
    if phase == 1:
        free_keys = ("kwargs_moffat", "kwargs_gaussian")
    else:
        free_keys = ("kwargs_gaussian", "kwargs_background",
                     "kwargs_distortion")
    free_np = {k: point[k] for k in free_keys}
    fixed_np = {k: v for k, v in point.items() if k not in free_keys}
    _, jl1, jl2 = jbuild._phase_losses(N_STARS, N_PIX, S, field_distortion)
    _, tl1, tl2 = tbuild.phase_losses(N_STARS, N_PIX, S, field_distortion)
    jloss, tloss = (jl1, tl1) if phase == 1 else (jl2, tl2)
    jconsts["fixed"] = _jax_tree(fixed_np)
    tconsts["fixed"] = kwargs_from_numpy(fixed_np, "cpu")
    want, jgrad = jax.value_and_grad(jloss)(_jax_tree(free_np), jconsts)
    tfree = kwargs_from_numpy(free_np, "cpu")
    leaves = [v for d in tfree.values() for v in d.values()]
    for v in leaves:
        v.requires_grad_(True)
    got = tloss(tfree, tconsts)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL)
    for group, d in tfree.items():
        for key, v in d.items():
            _close(v.grad, jgrad[group][key])


def test_starlet_transfer_fns_match_jax():
    for L, n_scales in ((96, 5), (80, 5), (160, 7)):
        _close(tbuild._starlet_transfer_fns(L, n_scales),
               jbuild._starlet_transfer_fns(L, n_scales))


@pytest.mark.parametrize("backend,dft_pad", RENDERS)
def test_closed_form_grid_weights_match_jax(backend, dft_pad):
    rng = np.random.default_rng(14)
    sigma = rng.uniform(0.5, 1.5, (N_PIX, N_PIX)).astype(np.float32)
    sigma[3, 5] = np.nan                     # contributes no noise
    n_sc = int(np.log2(M))
    jmats, tmats = _mats(backend, dft_pad)
    want = jbuild._grid_noise_weights_closed(
        jnp.asarray(sigma), M, S, n_sc, jmats,
        dft_precision=None if jmats is None else "highest")
    got = tbuild._grid_noise_weights_closed(torch.as_tensor(sigma), M, S,
                                            n_sc, tmats)
    _close(got, want)
    # a batch of frames is frame by frame
    both = tbuild._grid_noise_weights_closed(
        torch.as_tensor(np.stack([sigma, 2 * sigma])), M, S, n_sc, tmats)
    _close(both[0], got)
    _close(both[1], 2 * got)


def test_closed_form_matches_the_monte_carlo_oracle():
    """The port's closed form against its own Monte-Carlo estimate, with
    the bars of the JAX package's test of its pair
    (tests/test_noise_and_metrics.py, TestClosedFormGridWeights)."""
    m, s, nsc = 32, 2, 5
    rng = np.random.default_rng(3)
    sigma = torch.as_tensor(rng.uniform(0.5, 1.5, (m // s, m // s)).astype(
        np.float32))
    gen = torch.Generator().manual_seed(5)
    W_mc = tbuild._grid_noise_weights_impl(sigma, m, s, 4096, nsc,
                                           gen).numpy()
    W_cf = tbuild._grid_noise_weights_closed(sigma, m, s, nsc).numpy()
    assert W_cf.shape == W_mc.shape == (nsc + 1, m, m)
    assert (W_cf > 0).all()
    for j in range(3):
        ratio = W_cf[j, 6:-6, 6:-6] / W_mc[j, 6:-6, 6:-6]
        np.testing.assert_allclose(ratio, 1.0, atol=0.06)
    for j in range(3, nsc):
        ratio = W_cf[j, 8:-8, 8:-8] / W_mc[j, 8:-8, 8:-8]
        assert 0.5 < np.median(ratio) < 1.5


def _frame_problem(kind="valley", n_frames=5, seed=15):
    """F bounded problems of 6 parameters, a weighted quadratic plus, for
    "valley", two curved valleys (Rosenbrock terms).

    "valley": the quadratic is centred inside the box, as on the PSF fit's
    Moffat phase, where ``exact_bounds=False`` is safe (JAX's
    ``lbfgsb_scan`` docstring). "box": no valleys, centres outside the box
    [-1, 1], so the projection clips every step and the optimum lies on
    the bounds.
    """
    rng = np.random.default_rng(seed)
    if kind == "valley":
        lo = np.array([-1.0, -0.2, -1.0, -0.2, -0.9, -0.9], np.float32)
        hi = np.array([1.0, 1.0, 1.0, 1.0, 0.9, 0.9], np.float32)
        c = rng.uniform(-0.8, 0.8, (n_frames, 6))
        k = rng.uniform(1.0, 8.0, (n_frames,))
        x0 = rng.uniform(-0.4, 0.4, (n_frames, 6))
    else:
        lo, hi = -np.ones(6, np.float32), np.ones(6, np.float32)
        c = rng.uniform(-2.0, 2.0, (n_frames, 6))
        k = np.zeros(n_frames)
        x0 = np.zeros((n_frames, 6))
    f32 = np.float32
    return {"c": c.astype(f32), "k": k.astype(f32), "x0": x0.astype(f32),
            "w": rng.uniform(0.5, 3.0, (n_frames, 6)).astype(f32),
            "lo": lo, "hi": hi}


def _problem_loss(x, c, w, k):
    """The loss of one frame (jax arrays) or of all frames (tensors)."""
    valley = (x[..., 1] - x[..., 0] ** 2) ** 2 + (x[..., 3] - x[..., 2]
                                                  ** 2) ** 2
    return 1.0 + (w * (x - c) ** 2).sum(-1) + k * valley


def _jax_batched(method, problem, n_iter):
    lo, hi = problem["lo"], problem["hi"]

    def loss(free, consts):
        return _problem_loss(free["x"], consts["c"], consts["w"],
                             consts["k"])

    def one(x, c, w, k):
        consts = {"c": c, "w": w, "k": k}
        args = ({"x": x}, consts, {"x": jnp.asarray(lo)},
                {"x": jnp.asarray(hi)}, n_iter)
        if method == "lbfgs":
            return jopt.lbfgsb_scan(loss, *args, exact_bounds=False)
        return jopt.adabelief_scan(loss, *args, 0.05, True)

    best, _, hist = jax.jit(jax.vmap(one))(
        *(jnp.asarray(problem[k]) for k in ("x0", "c", "w", "k")))
    return np.asarray(best["x"]), np.asarray(hist)


def _torch_batched(method, problem, n_iter):
    c, w, k, x0, lo, hi = (torch.as_tensor(problem[key]) for key in
                           ("c", "w", "k", "x0", "lo", "hi"))

    def loss(free):
        return _problem_loss(free["x"], c, w, k)

    run = topt.run_lbfgsb_batched if method == "lbfgs" \
        else topt.run_adabelief_batched
    kwargs = {} if method == "lbfgs" else dict(init_learning_rate=0.05,
                                               schedule_learning_rate=True)
    best, final, hist = run(loss, {"x": x0}, {"x": lo}, {"x": hi}, n_iter,
                            **kwargs)
    return best["x"].numpy(), final["x"].numpy(), hist.numpy()


def _final_losses(problem, x):
    return np.asarray(_problem_loss(x, problem["c"], problem["w"],
                                    problem["k"]))


@pytest.mark.parametrize("kind", ["valley", "box"])
def test_batched_lbfgs_matches_jax_under_vmap(kind):
    problem = _frame_problem(kind)
    n_iter = 40
    jbest, jhist = _jax_batched("lbfgs", problem, n_iter)
    tbest, tfinal, thist = _torch_batched("lbfgs", problem, n_iter)
    assert thist.shape == jhist.shape == (5, n_iter)
    lo, hi = problem["lo"], problem["hi"]
    assert ((tbest >= lo) & (tbest <= hi)).all()
    if kind == "valley":
        assert ((tfinal >= lo) & (tfinal <= hi)).all()
    else:
        assert ((tbest == lo) | (tbest == hi)).any()
    # the same path as optax's while the rounding keeps them together (on
    # the box, clipped steps amplify it sooner)
    n_same = 8 if kind == "valley" else 5
    np.testing.assert_allclose(thist[:, :n_same], jhist[:, :n_same],
                               rtol=1e-4)
    got, want = _final_losses(problem, tbest), _final_losses(problem, jbest)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    if kind == "valley":
        # the best loss is the lowest entry of each frame's history
        np.testing.assert_allclose(thist.min(axis=1), got, rtol=1e-5)


def test_batched_lbfgs_keeps_a_nan_frame_to_itself():
    problem = _frame_problem()
    ref_best, ref_final, ref_hist = _torch_batched("lbfgs", problem, 25)
    bad = {k: v.copy() for k, v in problem.items()}
    bad["c"][2, 1] = np.nan
    best, final, hist = _torch_batched("lbfgs", bad, 25)
    keep = [0, 1, 3, 4]
    np.testing.assert_array_equal(best[keep], ref_best[keep])
    np.testing.assert_array_equal(final[keep], ref_final[keep])
    np.testing.assert_array_equal(hist[keep], ref_hist[keep])
    assert np.isnan(hist[2]).all()


def test_batched_adabelief_matches_jax_under_vmap():
    problem = _frame_problem()
    n_iter = 60
    jbest, jhist = _jax_batched("adabelief", problem, n_iter)
    tbest, _, thist = _torch_batched("adabelief", problem, n_iter)
    np.testing.assert_allclose(thist, jhist, rtol=TOL)
    _close(tbest, jbest)


# Fitted results at equal budgets. 100 L-BFGS iterations bring both
# packages' Moffat phase to the same chi2 on these frames, and 30
# AdaBelief iterations then move the grid; the reduced chi2 per frame is
# held to BASELINE.json's 1 %. The full PSF is not held to 1 % of its
# peak: the Moffat is degenerate in (fwhm, beta) at equal chi2, the two
# line searches (the same algorithm, rounded otherwise) settle at
# different points of that valley, and the pixel phase's first AdaBelief
# steps are sign steps on every grid pixel, which turn rounding into
# differences of the grid (tools/torch_psf_rounding.py measures how far).
# Longer budgets let the free grid fit the noise and drift further
# apart, so no budget under ~30 s of CPU meets 1 %. The full PSF and the
# fwhm take the bars that the JAX package's own test holds between its
# two paths (tests/test_batched_psf.py: fwhm rtol 8e-2, full PSF 6e-2 of
# peak).
FIT_BUDGET = dict(n_iter_analytic=100, n_iter_adabelief=30)


@pytest.fixture(scope="module")
def stacks(frames):
    return (np.stack([f["data"] for f in frames]),
            np.stack([f["sigma"] for f in frames]))


def _jax_fits(stacks, backend, dft_pad):
    data, sigma = stacks
    with _jax_render(backend):
        single = jbuild.build_psf(data[0], sigma[0], S, dft_pad=dft_pad,
                                  **FIT_BUDGET)
        batched = jbatched.build_psf_batched(data, sigma, S, mesh=None,
                                             dft_pad=dft_pad, **FIT_BUDGET)
    return single, batched


def _port_fits(stacks, backend, dft_pad):
    data, sigma = stacks
    kw = dict(device="cpu", irfft_backend=backend, dft_pad=dft_pad,
              **FIT_BUDGET)
    return (tbuild.build_psf(data[0], sigma[0], S, **kw),
            tbatched.build_psf_batched(data, sigma, S, **kw))


@pytest.mark.parametrize("backend,dft_pad", RENDERS)
def test_fits_match_jax_at_equal_budgets(stacks, backend, dft_pad):
    jsingle, jbatch = _jax_fits(stacks, backend, dft_pad)
    tsingle, tbatch = _port_fits(stacks, backend, dft_pad)
    # build_psf: one frame
    assert set(tsingle) == set(jsingle)
    np.testing.assert_allclose(tsingle["chi2"], jsingle["chi2"], rtol=0.01)
    np.testing.assert_allclose(tsingle["chi2_per_star"],
                               jsingle["chi2_per_star"], rtol=0.03)
    peak = jsingle["full_psf"].max()
    np.testing.assert_allclose(tsingle["full_psf"] / peak,
                               jsingle["full_psf"] / peak, atol=6e-2)
    np.testing.assert_allclose(
        tsingle["kwargs_psf"]["kwargs_moffat"]["fwhm_x"],
        jsingle["kwargs_psf"]["kwargs_moffat"]["fwhm_x"], rtol=8e-2)
    assert tsingle["lbfgs_extra_fields"]["loss_history"].shape == (100,)
    assert tsingle["adabelief_extra_fields"]["loss_history"].shape == (30,)
    assert tsingle["residuals"].shape == (N_STARS, N_PIX, N_PIX)
    # build_psf_batched: three frames
    assert set(tbatch) == set(jbatch)
    for key, value in jbatch.items():
        if not isinstance(value, dict):
            assert tbatch[key].shape == value.shape, key
    np.testing.assert_allclose(tbatch["chi2"], jbatch["chi2"], rtol=0.01)
    np.testing.assert_allclose(tbatch["scale"], jbatch["scale"], rtol=TOL)
    peak = jbatch["full_psf"].max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(tbatch["full_psf"] / peak,
                               jbatch["full_psf"] / peak, atol=6e-2)
    np.testing.assert_allclose(tbatch["kwargs_moffat"]["fwhm_x"],
                               jbatch["kwargs_moffat"]["fwhm_x"], rtol=8e-2)
    # the batched fit of frame 0 is build_psf's fit (same algorithm at
    # the first frame, up to L-BFGS's line search)
    np.testing.assert_allclose(tbatch["chi2"][0], tsingle["chi2"],
                               rtol=0.03)


@pytest.mark.parametrize("n_iter_analytic,n_iter_adabelief,atol", [
    (100, 1, 3e-4), (0, 80, 1e-6)])
def test_padded_dummy_stars_are_ignored(stacks, n_iter_analytic,
                                        n_iter_adabelief, atol):
    """As tests/test_batched_psf.py: a fully masked fifth star on every
    frame changes nothing. Each phase is held on its own. The dummy star
    adds exact zeros, but to sums of 5 terms (and 18 parameters) where
    there were 4 (and 15), which torch associates otherwise: the line
    search turns that rounding into other steps within a few iterations,
    and AdaBelief's normalised steps turn gradient differences near zero
    into whole steps. So the Moffat phase is held converged (100
    iterations) at the JAX test's 3e-4, and the pixel phase from the same
    start (no L-BFGS) to 1e-6."""
    data, sigma = stacks
    pad = (data.shape[0], 1) + data.shape[2:]
    data_p = np.concatenate([data, np.zeros(pad, np.float32)], axis=1)
    sigma_p = np.concatenate([sigma, np.ones(pad, np.float32)], axis=1)
    masks = np.ones_like(data_p, dtype=bool)
    masks[:, -1] = False
    budget = dict(n_iter_analytic=n_iter_analytic,
                  n_iter_adabelief=n_iter_adabelief, device="cpu")
    ref = tbatched.build_psf_batched(data, sigma, S, **budget)
    padded = tbatched.build_psf_batched(data_p, sigma_p, S, masks=masks,
                                        **budget)
    np.testing.assert_allclose(padded["narrow_psf"], ref["narrow_psf"],
                               atol=atol)
    np.testing.assert_allclose(padded["chi2"], ref["chi2"], rtol=1e-3)
    assert (padded["chi2_per_star"][:, -1] == 0.0).all()


def test_user_mask_composes_with_finite_guard(stacks):
    """A user mask marking a NaN pixel good composes with the finite
    guard (as tests/test_batched_psf.py holds the JAX fit)."""
    data, sigma = (x.copy() for x in stacks)
    data[1, 2, 12, 12] = np.nan
    sigma[1, 2, 12, 12] = 1e-6
    masks = np.ones_like(data, dtype=bool)
    out = tbatched.build_psf_batched(data, sigma, S, masks=masks,
                                     n_iter_analytic=20, n_iter_adabelief=60,
                                     device="cpu")
    assert np.isfinite(out["chi2"]).all()
    assert (out["chi2"] < 10.0).all()
    single = tbuild.build_psf(data[1], sigma[1], S, masks=masks[1],
                              n_iter_analytic=20, n_iter_adabelief=60,
                              device="cpu")
    assert np.isfinite(single["chi2"]) and single["chi2"] < 10.0


def test_entry_points_run_on_the_card_unless_asked(stacks):
    """Both entry points default to device="cuda" and, without a card,
    raise rather than fall back to the CPU; fetch="device" returns the
    device's tensors."""
    data, sigma = stacks
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default would run")
    with pytest.raises((RuntimeError, AssertionError)):
        tbuild.build_psf(data[0], sigma[0], S, n_iter_analytic=1,
                         n_iter_adabelief=1)
    with pytest.raises((RuntimeError, AssertionError)):
        tbatched.build_psf_batched(data, sigma, S, n_iter_analytic=1,
                                   n_iter_adabelief=1)
    out = tbatched.build_psf_batched(data, sigma, S, n_iter_analytic=2,
                                     n_iter_adabelief=2, device="cpu",
                                     fetch="device")
    assert isinstance(out["chi2"], torch.Tensor)
    assert out["loss_history_pixels"].shape == (3, 2)
    with pytest.raises(ValueError, match="irfft_backend"):
        tbatched.build_psf_batched(data, sigma, S, device="cpu",
                                   irfft_backend="mxu")
    with pytest.raises(ValueError, match="safe minimum"):
        tbuild.build_psf(data[0], sigma[0], S, device="cpu",
                         irfft_backend="matmul", dft_pad=4)
