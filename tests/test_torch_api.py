"""Port parity for the notebook API: the top-level names, their
signatures, ``FisherCovariance``, the ``Optimizer`` options (the extended
AdaBelief), ``propagate_noise`` in the reference's call form, and the
deterministic helpers of ``core/conventions.py`` and
``core/convolution.py``.

Held against the JAX package on the CPU, in one process, on seeded numpy
inputs: the blob scene of ``tests/test_core_contract.py`` (5 epochs of
16 px at s = 1). Tolerances: deterministic pieces 1e-5 relative; the
optimizer's loss histories 1e-5 relative until the stop (both follow
optax's arithmetic), its snapshots 1e-5 of their largest value,
``stopped_at`` and the snapshot iterations equal. The Monte-Carlo noise
weights draw from each package's own generator, so they are held by
statistics (5 % per detail scale at 2048 samples).
"""

import ast
import inspect
from pathlib import Path

import jax
import numpy as np
import pytest
import scipy.signal
import torch

import lightcurver_tpu as J
import lightcurver_tpu_torch as T
from lightcurver_tpu.core import conventions as jconv_rules
from lightcurver_tpu.core import convolution as jconv
from lightcurver_tpu_torch.core import conventions as tconv_rules
from lightcurver_tpu_torch.core import convolution as tconv
from lightcurver_tpu_torch.core import optimize as topt

TOL = 1e-5
N_EPOCHS, N_PIX = 5, 16

# keyword-only extras the port may add to a JAX signature
PORT_EXTRAS = {"device", "irfft_backend", "dft_pad", "group", "epochs",
               "mesh", "checkpoint_share", "n_groups", "dft_mats",
               "fixed_h_render", "consts"}
# extras kept on purpose, each with its reason (also in ROADMAP.md,
# "Differences kept on purpose")
KEPT_EXTRAS = {
    ("fit_stars_batched", "noise_weights"):
        "the parity tests hand both packages the same starlet weights: "
        "the port's generator is not JAX's PRNG",
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """As in the calibration chain's file: one intra-op thread beside the
    suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_exports():
    """The names ``lightcurver_tpu/__init__.py`` re-exports."""
    tree = ast.parse(Path(J.__file__).read_text())
    return sorted(alias.asname or alias.name for node in tree.body
                  if isinstance(node, ast.ImportFrom)
                  for alias in node.names)


EXPORTS = _jax_exports()


def test_exports_are_the_jax_packages():
    assert len(EXPORTS) == 14
    for name in EXPORTS:
        ours = getattr(T, name)
        # the object of the port's module, never a wrapper or JAX's own
        assert ours.__module__.startswith("lightcurver_tpu_torch."), name
        assert ours.__module__.split(".", 1)[1] \
            == getattr(J, name).__module__.split(".", 1)[1], name


def _positional(sig):
    return [(p.name, p.default) for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def _keyword_only(sig):
    return {p.name for p in sig.parameters.values()
            if p.kind is p.KEYWORD_ONLY}


def _check_signature(label, jax_fn, port_fn):
    js, ts = inspect.signature(jax_fn), inspect.signature(port_fn)
    assert _positional(ts) == _positional(js), label
    extras = _keyword_only(ts) - _keyword_only(js)
    kept = {name for (where, name) in KEPT_EXTRAS if where == label}
    assert extras <= PORT_EXTRAS | kept, (label, extras - PORT_EXTRAS)


@pytest.mark.parametrize("name", EXPORTS + ["Optimizer.minimize",
                                            "FisherCovariance."
                                            "get_kwargs_sigma"])
def test_signature_matches_jax(name):
    """The same positional parameters in the same order with the same
    defaults; the port adds only keyword-only extras from PORT_EXTRAS (or
    KEPT_EXTRAS). An exception class has no signature: both must be
    ValueErrors."""
    owner, _, method = name.partition(".")
    jax_obj, port_obj = getattr(J, owner), getattr(T, owner)
    if method:
        jax_obj, port_obj = getattr(jax_obj, method), getattr(port_obj,
                                                              method)
    if isinstance(jax_obj, type) and issubclass(jax_obj, Exception):
        assert issubclass(port_obj, ValueError) \
            and issubclass(jax_obj, ValueError)
        return
    _check_signature(name, jax_obj, port_obj)


def test_kept_extras_exist():
    """Every kept divergence is still a keyword-only parameter of the
    port (so the list cannot go stale)."""
    for where, name in KEPT_EXTRAS:
        assert name in _keyword_only(inspect.signature(getattr(T, where)))


@pytest.fixture(scope="module")
def blob_stack():
    """tests/test_core_contract.py's blob scene."""
    rng = np.random.default_rng(42)
    x, y = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8))
    gauss = np.exp(-0.1 * (x**2 + y**2)).astype(np.float32)
    data = 0.1 * rng.random((N_EPOCHS, N_PIX, N_PIX)).astype(np.float32) \
        + gauss[None]
    noisemap = 0.1 * np.ones((N_EPOCHS, N_PIX, N_PIX), dtype=np.float32)
    psf = np.repeat(gauss[None], N_EPOCHS, axis=0)
    return data, noisemap, psf


def _problem(pkg, blob, **loss_kw):
    """(model, kwargs_init, Params, Loss, Optimizer) of one package on the
    blob scene, every leaf free but the fixed ones of ``setup_model``."""
    data, noisemap, psf = blob
    a0 = list(np.nansum(data, axis=(1, 2)))
    extra = {} if pkg is J else {"device": "cpu"}
    model, ki, ku, kd, kf = pkg.setup_model(
        data, noisemap**2, psf, np.array([0.0]), np.array([0.0]), 1, a0,
        **extra)
    params = pkg.Params(ki, kf, ku, kd)
    loss = pkg.Loss(data, model, params, noisemap**2, **loss_kw)
    return model, ki, params, loss, pkg.Optimizer(loss, params)


def _both(blob, **minimize_kw):
    return [_problem(pkg, blob)[-1].minimize(**minimize_kw)
            for pkg in (J, T)]


def test_param_history_matches_jax(blob_stack):
    """return_param_history: 100 iterations into 64 slots, so iterations
    63 to 99 overwrite the last slot (JAX's rule, kept); the histories,
    the snapshot iterations and the snapshots agree."""
    (_, _, jx, _), (_, _, tx, _) = _both(
        blob_stack, max_iterations=100, init_learning_rate=1e-2,
        restart_from_init=True, return_param_history=True)
    np.testing.assert_allclose(tx["loss_history"],
                               np.asarray(jx["loss_history"]), rtol=TOL)
    np.testing.assert_array_equal(tx["param_history_iterations"],
                                  np.asarray(jx["param_history_iterations"]))
    assert list(tx["param_history_iterations"][-2:]) == [62, 99]
    assert tx["stopped_at"] == int(jx["stopped_at"]) == 100
    jh = jax.tree_util.tree_map(np.asarray, jx["param_history"])
    assert set(tx["param_history"]) == set(jh)
    for group, leaves in jh.items():
        assert set(tx["param_history"][group]) == set(leaves)
        for key, want in leaves.items():
            got = tx["param_history"][group][key]
            assert got.shape == want.shape == (64,) + want.shape[1:]
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=TOL * max(np.abs(want).max(),
                                                      1.0))


def test_stop_at_loss_increase_matches_jax(blob_stack):
    """lr 0.5 without a schedule: the loss rises soon after
    min_iterations; both stop on the same iteration, agree until there,
    and keep a tail that is constant to the bit."""
    (_, _, jx, _), (_, _, tx, _) = _both(
        blob_stack, max_iterations=200, init_learning_rate=0.5,
        schedule_learning_rate=False, restart_from_init=True,
        stop_at_loss_increase=True, min_iterations=5)
    stop = tx["stopped_at"]
    assert stop == int(jx["stopped_at"])
    assert 5 <= stop < 200
    hist = tx["loss_history"]
    assert hist.shape == (200,)
    np.testing.assert_allclose(hist[:stop + 1],
                               np.asarray(jx["loss_history"])[:stop + 1],
                               rtol=TOL)
    assert hist[stop] > hist[stop - 1]
    assert np.all(hist[stop + 1:] == hist[stop + 1])
    assert "param_history" not in tx


def test_extended_loop_without_a_stop_is_the_plain_loop(blob_stack):
    """With no option set, minimize takes the plain loop; the extended
    loop with the stop off gives the same bits."""
    *_, params, loss, optim = _problem(T, blob_stack)
    _, _, plain, _ = optim.minimize(max_iterations=40,
                                    init_learning_rate=1e-2,
                                    restart_from_init=True)
    assert set(plain) == {"loss_history"}
    best, _, hist = topt.run_adabelief(
        loss.loss_fn, params.free0, params.lower, params.upper, 40,
        init_learning_rate=1e-2)
    np.testing.assert_array_equal(plain["loss_history"], hist)
    ext = topt.run_adabelief_extended(
        loss.loss_fn, params.free0, params.lower, params.upper, 40, 1e-2,
        True, False, 0, 0)
    np.testing.assert_array_equal(ext[2], hist)
    assert ext[3] == 40 and ext[4] is None and ext[5] is None
    for key, leaf in best["kwargs_analytic"].items():
        np.testing.assert_array_equal(ext[0]["kwargs_analytic"][key].numpy(),
                                      leaf.numpy())


@pytest.mark.parametrize("pkg", [J, T], ids=["jax", "port"])
def test_option_errors(blob_stack, pkg, tmp_path):
    """JAX's two ValueErrors, raised by both packages."""
    *_, params, loss, _ = _problem(pkg, blob_stack)
    lbfgs = pkg.Optimizer(loss, params, method="l-bfgs-b")
    with pytest.raises(ValueError, match="adabelief"):
        lbfgs.minimize(max_iterations=10, return_param_history=True)
    with pytest.raises(ValueError, match="adabelief"):
        lbfgs.minimize(max_iterations=10, stop_at_loss_increase=True)
    ada = _problem(pkg, blob_stack)[-1]
    with pytest.raises(ValueError, match="checkpoint"):
        ada.minimize(max_iterations=10, stop_at_loss_increase=True,
                     checkpoint_path=str(tmp_path / "ck.npz"))


@pytest.mark.parametrize("method", ["l-bfgs-b", "lbfgsb", "l-bfgs"])
def test_lbfgs_aliases(blob_stack, method):
    """The three names of L-BFGS give the same fit; other names raise."""
    runs = []
    for name in ("l-bfgs-b", method):
        *_, params, loss, _ = _problem(T, blob_stack)
        optim = T.Optimizer(loss, params, method=name)
        runs.append(optim.minimize(maxiter=5)[2]["loss_history"])
    np.testing.assert_array_equal(runs[0], runs[1])
    assert runs[1].shape == (5,)
    with pytest.raises(ValueError, match="unknown method"):
        T.Optimizer(loss, params, method="lbfgs-b")


def test_fisher_covariance_matches_jax(blob_stack):
    """Flux sigmas to 1e-5 relative, NaN of the same shape everywhere
    else, after 30 iterations of each package's own fit."""
    out = []
    for pkg in (J, T):
        *_, params, _, optim = _problem(pkg, blob_stack)
        optim.minimize(max_iterations=30, init_learning_rate=1e-2,
                       restart_from_init=True)
        out.append(pkg.FisherCovariance(params, optim,
                                        diagonal_only=True)
                   .get_kwargs_sigma())
    want, got = jax.tree_util.tree_map(np.asarray, out[0]), out[1]
    assert set(got) == set(want)
    for group, leaves in want.items():
        assert set(got[group]) == set(leaves), group
        for key, ref in leaves.items():
            mine = np.asarray(got[group][key])
            assert mine.shape == ref.shape, (group, key)
            if (group, key) == ("kwargs_analytic", "a"):
                assert np.all(np.isfinite(mine)) and np.all(mine > 0)
                np.testing.assert_allclose(mine, ref, rtol=TOL)
            else:
                assert np.all(np.isnan(mine)) and np.all(np.isnan(ref))


def test_get_flux_uncertainties_call_form(blob_stack):
    """The reference's keyword call, a flat numpy array in a's layout,
    the same through ``utilities/starred_utilities``."""
    from lightcurver_tpu_torch.utilities.starred_utilities import \
        get_flux_uncertainties as alias

    data, noisemap, _ = blob_stack
    res = []
    for pkg in (J, T):
        model, ki, *_ = _problem(pkg, blob_stack)
        res.append(np.asarray(pkg.get_flux_uncertainties(
            kwargs=ki, kwargs_up=None, kwargs_down=None, data=data,
            noisemap=noisemap, model=model)))
    assert isinstance(res[1], np.ndarray) and res[1].shape == (N_EPOCHS,)
    np.testing.assert_allclose(res[1], res[0], rtol=TOL)
    assert alias is T.get_flux_uncertainties


def test_propagate_noise_call_form(blob_stack):
    """STARRED's call form returns [W]; ``upsampling_factor`` and
    ``n_scales`` are honoured; the detail scales agree with JAX's within
    5 % at 2048 samples (the coarse detail scales hold few independent
    pixels, so fewer samples leave them ~8 % apart)."""
    data, noisemap, _ = blob_stack
    ws = []
    for pkg in (J, T):
        model, ki, *_ = _problem(pkg, blob_stack)
        out = pkg.propagate_noise(model, noisemap, ki,
                                  wavelet_type_list=["starlet"],
                                  method="SLIT", num_samples=2048, seed=1,
                                  likelihood_type="chi2",
                                  upsampling_factor=1)
        assert isinstance(out, list) and len(out) == 1
        ws.append(np.asarray(out[0]))
    assert ws[1].shape == ws[0].shape == (5, N_PIX, N_PIX)
    np.testing.assert_allclose(ws[1][:-1].mean(axis=(1, 2)),
                               ws[0][:-1].mean(axis=(1, 2)), rtol=0.05)
    model, ki, *_ = _problem(T, blob_stack)
    two, = T.propagate_noise(model, noisemap, ki, num_samples=16, seed=1,
                             n_scales=2)
    assert tuple(two.shape) == (3, N_PIX, N_PIX)
    default, = T.propagate_noise(model, noisemap, ki, num_samples=16,
                                 seed=1)
    # the finest scales do not depend on the number of scales
    np.testing.assert_array_equal(two[:2].numpy(), default[:2].numpy())


@pytest.mark.parametrize("sigma", [0.5, 1.7, np.array([1.0, 2.5])])
def test_sigma_to_fwhm(sigma):
    np.testing.assert_allclose(tconv_rules.sigma_to_fwhm(sigma),
                               jconv_rules.sigma_to_fwhm(sigma), rtol=1e-15)
    np.testing.assert_allclose(
        tconv_rules.fwhm_to_sigma(tconv_rules.sigma_to_fwhm(sigma)), sigma,
        rtol=1e-15)


@pytest.mark.parametrize("shape", [(), (3,), (2, 4)])
def test_shift_phase_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    m = 24
    sx = rng.uniform(-3, 3, shape).astype(np.float32)
    sy = rng.uniform(-3, 3, shape).astype(np.float32)
    want = np.asarray(jconv.shift_phase(m, sx, sy))
    got = tconv.shift_phase(m, torch.as_tensor(sx),
                            torch.as_tensor(sy)).numpy()
    assert got.shape == want.shape == shape + (2 * m, m + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_psf_fft_for_grid_and_convolve_grid_match_jax():
    m = 32
    rng = np.random.default_rng(4)
    t = rng.random((m, m)).astype(np.float32)
    img = rng.random((2, m, m)).astype(np.float32)
    want_hat = np.asarray(jconv.psf_fft_for_grid(t))
    got_hat = tconv.psf_fft_for_grid(torch.as_tensor(t)).numpy()
    np.testing.assert_allclose(got_hat, want_hat, rtol=0,
                               atol=TOL * np.abs(want_hat).max())
    want = np.asarray(jconv.convolve_grid(img, want_hat))
    got = tconv.convolve_grid(torch.as_tensor(img),
                              torch.as_tensor(got_hat)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


def test_convolve_grid_delta_even_grid():
    """tests/test_core_kernels.py's oracle: a delta spawns a peak-aligned
    PSF copy, half a pixel off the lattice at even m."""
    m = 32
    rng = np.random.default_rng(4)
    t = np.zeros((m, m), dtype=np.float32)
    t[14:19, 14:19] = rng.random((5, 5)).astype(np.float32)
    img = np.zeros((m, m), dtype=np.float32)
    img[20, 9] = 1.0
    out = tconv.convolve_grid(torch.as_tensor(img),
                              tconv.psf_fft_for_grid(torch.as_tensor(t)))
    c = (m - 1) / 2.0
    full = np.fft.rfft2(t, s=(2 * m, 2 * m))
    fy = np.fft.fftfreq(2 * m).reshape(-1, 1)
    fx = np.fft.rfftfreq(2 * m).reshape(1, -1)
    shift = np.exp(-2j * np.pi * (fy * (20 - c) + fx * (9 - c)))
    oracle = np.fft.irfft2(full * shift, s=(2 * m, 2 * m))[:m, :m]
    np.testing.assert_allclose(out.numpy(), oracle, atol=1e-4)


def test_convolve_grid_matches_scipy_odd_support():
    """The independent check: at odd m the centre is a pixel, so the
    convolution is a crop of scipy's full one."""
    m = 33
    c = (m - 1) // 2
    rng = np.random.default_rng(7)
    t = np.zeros((m, m), dtype=np.float32)
    t[c - 2:c + 3, c - 2:c + 3] = rng.random((5, 5)).astype(np.float32)
    img = rng.random((m, m)).astype(np.float32)
    out = tconv.convolve_grid(torch.as_tensor(img),
                              tconv.psf_fft_for_grid(torch.as_tensor(t)))
    full = scipy.signal.fftconvolve(img, t, mode="full")
    np.testing.assert_allclose(out.numpy(), full[c:c + m, c:c + m],
                               atol=1e-4)
