"""Port parity: AdaBelief (optax semantics) and projected L-BFGS.

AdaBelief follows the same path as optax, its rate and bias corrections
in float32 from the count, so its loss histories are held to rtol 1e-5,
with and without the schedule and with the freeze and the snapshots on.
L-BFGS is JAX's ``lbfgsb_scan`` (optax's L-BFGS, zoom line search, box
projection, the exact-bounds retake): its history is held to JAX's over
the first iterations at rtol 1e-5, until float32 rounding parts them (a
one-ulp change of JAX's own start parts JAX from itself by 1.5e-4 to
2.3e-3 of the loss within 40 iterations on these problems), and its best
loss at rtol 3e-5, on the free problem and where the projection clips.
"""

import logging

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from lightcurver_tpu.core import optimize as jopt
from lightcurver_tpu.core import params as jparams
from lightcurver_tpu.core.deconv import loss as jloss
from lightcurver_tpu.core.deconv import model as jmodel

from lightcurver_tpu_torch.core import optimize as topt
from lightcurver_tpu_torch.core import params as tparams
from lightcurver_tpu_torch.core.deconv import loss as tloss
from lightcurver_tpu_torch.core.deconv import model as tmodel
from lightcurver_tpu_torch.utilities.synthetic import (make_roi_scene,
                                                       moffat_np)

N, n, s, M = 4, 16, 2, 2
m = n * s


def _fits(stage, **bounds):
    """JAX and torch (Loss, Params) of a ROI stage on one small scene."""
    sc = make_roi_scene(n_epochs=N, n_pix=n, s=s, n_sources=M, seed=11)
    psf = np.stack([moffat_np(m, s, 2.8, 2.8, 2.8)] * N)
    a0 = sc["a_true"].mean(axis=0) * 0.8
    jm, jkw, jup, jdown, _ = jmodel.setup_model(
        sc["data"], sc["sigma_2"], psf, sc["xs"] + 0.2, sc["ys"] - 0.1, s,
        a0)
    tm, tkw, tup, tdown, _ = tmodel.setup_model(
        sc["data"], sc["sigma_2"], psf, sc["xs"] + 0.2, sc["ys"] - 0.1, s,
        a0, device="cpu")
    for k, v in bounds.items():
        jup["kwargs_analytic"][k], jdown["kwargs_analytic"][k] = v, -v
        tup["kwargs_analytic"][k] = torch.tensor(v)
        tdown["kwargs_analytic"][k] = torch.tensor(-v)
    if stage == 1:
        free = {"kwargs_analytic": ("dx", "dy", "a")}
        terms = dict(regularization_strength_flux_uniformity=1.0)
    else:
        free = {"kwargs_analytic": ("dx", "dy", "a", "c_x", "c_y"),
                "kwargs_background": ("h", "mean")}
        W = np.random.default_rng(1).uniform(
            0.01, 0.05, (int(np.log2(m)) + 1, m, m)).astype(np.float32)
        terms = dict(regularization_terms="l1_starlet", W=W,
                     regularization_strength_positivity=100.0,
                     regularization_strength_pts_source=0.01)
    fixed_np = {g: {k: np.asarray(v) for k, v in
                    jax.tree_util.tree_map(np.asarray, jkw)[g].items()
                    if k not in free.get(g, ())}
                for g in ("kwargs_analytic", "kwargs_background")}
    jp = jparams.Params(jkw, jax.tree_util.tree_map(jnp.asarray, fixed_np),
                        jup, jdown)
    tp = tparams.Params(tkw, tparams.kwargs_from_numpy(fixed_np, "cpu"),
                        tup, tdown)
    jl = jloss.Loss(sc["data"], jm, jp, sc["sigma_2"], **terms)
    tl = tloss.Loss(sc["data"], tm, tp, sc["sigma_2"], **terms)
    return jl, jp, tl, tp


@pytest.mark.parametrize("schedule", [False, True])
def test_adabelief_history_matches_optax(schedule):
    jl, jp, tl, tp = _fits(stage=2)
    n_iter = 30
    jbest, _, jhist = jopt.run_adabelief(
        jl.loss_fn, jp.free0, jp.lower, jp.upper, n_iter,
        init_learning_rate=1e-3, schedule_learning_rate=schedule,
        consts=jl.consts)
    tbest, _, thist = topt.run_adabelief(
        tl.loss_fn, tp.free0, tp.lower, tp.upper, n_iter,
        init_learning_rate=1e-3, schedule_learning_rate=schedule)
    assert thist.shape == (n_iter,)
    np.testing.assert_allclose(thist, np.asarray(jhist), rtol=1e-5)
    for g, d in tbest.items():
        for k, v in d.items():
            ref = np.asarray(jbest[g][k])
            np.testing.assert_allclose(v.numpy(), ref, rtol=0,
                                       atol=1e-5 * max(1.0,
                                                       np.abs(ref).max()))


# L-BFGS against JAX: the iterations over which the two paths are held
# at LBFGS_HISTORY_RTOL, and the bar of the best loss
LBFGS_SAME_ITERS, LBFGS_HISTORY_RTOL, LBFGS_BEST_RTOL = 8, 1e-5, 3e-5


def _lbfgs_against_jax(n_iter, **bounds):
    """(port's history, JAX's, the best loss of each, the torch problem)
    of ``run_lbfgsb`` on the stage-1 problem."""
    jl, jp, tl, tp = _fits(stage=1, **bounds)
    jbest, _, jhist = jopt.run_lbfgsb(jl.loss_fn, jp.free0, jp.lower,
                                      jp.upper, n_iter, consts=jl.consts)
    tbest, _, thist = topt.run_lbfgsb(tl.loss_fn, tp.free0, tp.lower,
                                      tp.upper, n_iter)
    assert thist.shape == (n_iter,)
    final_j = float(jl.loss_fn(jbest, jl.consts))
    with torch.no_grad():
        final_t = tl.loss_fn(tbest).item()
    return thist, np.asarray(jhist), final_t, final_j, (tl, tp, tbest)


def test_lbfgs_final_loss_matches_jax():
    thist, jhist, final_t, final_j, _ = _lbfgs_against_jax(40)
    assert thist[-1] < 0.5 * thist[0]
    np.testing.assert_allclose(thist[:LBFGS_SAME_ITERS],
                               jhist[:LBFGS_SAME_ITERS],
                               rtol=LBFGS_HISTORY_RTOL)
    np.testing.assert_allclose(final_t, final_j, rtol=LBFGS_BEST_RTOL)


@pytest.mark.parametrize("bounds", [dict(dx=0.05, dy=0.05), dict(dx=0.02)],
                         ids=["dx-dy-0.05", "dx-0.02"])
def test_lbfgs_clipped_steps_match_jax(bounds):
    """A box the steps run into: the history and the best loss against
    JAX's, the best point on the bound, and JAX's exact-bounds retake:
    after a clipped step the next history entry is the loss at the
    projected point, to the bit."""
    thist, jhist, final_t, final_j, (tl, tp, tbest) = _lbfgs_against_jax(
        40, **bounds)
    np.testing.assert_allclose(thist[:LBFGS_SAME_ITERS],
                               jhist[:LBFGS_SAME_ITERS],
                               rtol=LBFGS_HISTORY_RTOL)
    np.testing.assert_allclose(final_t, final_j, rtol=LBFGS_BEST_RTOL)
    dx = tbest["kwargs_analytic"]["dx"]
    assert int((dx.abs() == bounds["dx"]).sum()) > 0
    for k in (3, 9):
        _, final, _ = topt.run_lbfgsb(tl.loss_fn, tp.free0, tp.lower,
                                      tp.upper, k)
        assert int((final["kwargs_analytic"]["dx"].abs()
                    == bounds["dx"]).sum()) > 0
        with torch.no_grad():
            at_projected = tl.loss_fn(final).item()
        assert at_projected == thist[k]


@pytest.mark.parametrize("schedule", [False, True])
def test_adabelief_options_match_optax(schedule):
    """The freeze and the snapshot ring on, against JAX's
    ``adabelief_scan_extended`` (at lr 3e-2 the loss rises at iteration
    13 without the schedule, and never with it): the history at rtol
    1e-5, the stop iteration, the snapshots' iterations, and the
    snapshots at 1e-5 of each leaf's largest value, the background grid
    at 1e-3 (AdaBelief moves each grid pixel by about the rate whatever
    its gradient's size, so the rounding of a near-zero gradient's sign
    shows there first: 2.5e-4 measured)."""
    jl, jp, tl, tp = _fits(stage=2)
    n_iter, lr = 40, 3e-2
    jbest, _, jhist, jstop, jsnap, jits = jopt._run_adabelief_extended(
        loss_fn=jl.loss_fn, free0=jp.free0, consts=jl.consts,
        lower=jp.lower, upper=jp.upper, n_iter=n_iter,
        init_learning_rate=lr, schedule_learning_rate=schedule,
        stop_at_loss_increase=True, min_iterations=5, n_param_snapshots=16)
    tbest, _, thist, tstop, tsnap, tits = topt.run_adabelief_extended(
        tl.loss_fn, tp.free0, tp.lower, tp.upper, n_iter, lr, schedule,
        True, 5, 16)
    assert tstop == int(jstop)
    np.testing.assert_allclose(thist, np.asarray(jhist), rtol=1e-5)
    np.testing.assert_array_equal(tits, np.asarray(jits))
    for g, d in tsnap.items():
        for k, v in d.items():
            ref = np.asarray(jsnap[g][k])
            bar = 1e-3 if k == "h" else 1e-5
            np.testing.assert_allclose(v.numpy(), ref, rtol=0,
                                       atol=bar * max(1.0,
                                                      np.abs(ref).max()))


@pytest.mark.parametrize("method", ["adabelief", "l-bfgs-b"])
def test_optimizer_contract(method):
    """n_iter entries, each the loss before its update; the best params
    are those of the lowest entry; the box holds."""
    _, _, tl, tp = _fits(stage=1, dx=0.05)
    optim = topt.Optimizer(tl, tp, method=method)
    best_kwargs, logL, extra, _ = optim.minimize(
        12, init_learning_rate=1e-2, schedule_learning_rate=True)
    hist = optim.loss_history
    assert hist.shape == (12,) and extra["loss_history"] is hist
    assert logL == float(hist.min())
    dx = best_kwargs["kwargs_analytic"]["dx"]
    assert float(dx.abs().max()) <= 0.05 + 1e-7
    with torch.no_grad():
        assert tl(best_kwargs).item() == pytest.approx(logL, rel=1e-6)
    with pytest.raises(ValueError):
        topt.Optimizer(tl, tp, method="sgd")


def test_plateau_metric_and_warning(caplog):
    rng = np.random.default_rng(0)
    for hist in (np.exp(-np.arange(200) / 20.0), np.linspace(5, 1, 100),
                 rng.normal(size=50), np.ones(1), np.ones(30)):
        assert topt.relative_loss_differential(hist) == pytest.approx(
            jopt.relative_loss_differential(hist))
    logger = logging.getLogger("test_torch_optimize")
    with caplog.at_level(logging.WARNING, logger="test_torch_optimize"):
        rld = topt.warn_if_unconverged(np.linspace(5, 1, 100), logger,
                                       "fit", "iters")
    assert rld > topt.UNCONVERGED_RLD_THRESHOLD
    assert "consider raising 'iters'" in caplog.text
