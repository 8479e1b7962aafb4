"""Mid-fit checkpoints of the port: interrupted == uninterrupted.

A genuine kill is a wrapped ``core.optimize.save_checkpoint`` that raises
an exception class of this file at a chosen write, so the run ends
between two segments with the earlier segments on disk, as a killed
process leaves them. On the CPU a resumed fit is the uninterrupted fit to
the bit; the checkpointed AdaBelief is also held against the JAX
package's ``run_adabelief`` at the bars of ``tests/test_checkpointing.py``.
"""

import logging

import numpy as np
import pytest
import torch

from lightcurver_tpu.core import optimize as jopt
from lightcurver_tpu.core.deconv.loss import Loss as JLoss
from lightcurver_tpu.core.deconv.model import setup_model as jsetup_model
from lightcurver_tpu.core.params import Params as JParams
from lightcurver_tpu.processes.roi_modelling import \
    stage2_checkpoint_digest as jax_stage2_digest
from lightcurver_tpu.utilities.synthetic import make_roi_scene

from lightcurver_tpu_torch.core import optimize as topt
from lightcurver_tpu_torch.core.deconv import batched as tbatched
from lightcurver_tpu_torch.core.deconv.loss import Loss
from lightcurver_tpu_torch.core.deconv.model import setup_model
from lightcurver_tpu_torch.core.params import Params
from lightcurver_tpu_torch.processes import roi_modelling as troi
from lightcurver_tpu_torch.utilities.checkpoints import \
    run_discarding_stale_checkpoint
from lightcurver_tpu_torch.utilities.synthetic import star_photometry_scene

N_ITER, EVERY, LR = 120, 40, 1e-2


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


class Killed(Exception):
    """The simulated kill; only this class is caught."""


@pytest.fixture()
def kill_at(monkeypatch):
    """``kill_at(k)``: the k-th checkpoint write from now on raises
    :class:`Killed` before writing; returns the list of writes made."""
    save = topt.save_checkpoint

    def arm(k):
        writes = []

        def bomb(path, carry, n_iter, done, *args, **kwargs):
            if len(writes) + 1 >= k:
                raise Killed(f"killed at write {k}")
            writes.append(done)
            return save(path, carry, n_iter, done, *args, **kwargs)

        monkeypatch.setattr(topt, "save_checkpoint", bomb)
        return writes
    return arm


@pytest.fixture(scope="module")
def scene():
    return make_roi_scene(n_epochs=4, n_pix=16, s=2, n_sources=2, seed=2)


@pytest.fixture()
def problem(scene):
    model, ki, ku, kd, kf = setup_model(
        scene["data"], scene["sigma_2"], scene["psf"], scene["xs"],
        scene["ys"], scene["s"], device="cpu")
    params = Params(ki, kf, ku, kd)
    loss = Loss(torch.as_tensor(scene["data"]), model, params,
                torch.as_tensor(scene["sigma_2"]))
    return loss, params


def _run(problem, path, n_iter=N_ITER, **kw):
    loss, params = problem
    return topt.run_adabelief_checkpointed(
        loss.loss_fn, params.free0, params.lower, params.upper, n_iter,
        path, init_learning_rate=LR, checkpoint_every=EVERY, **kw)


def _assert_same_fit(got, want):
    for g, w in zip(got[:2], want[:2]):
        for group in w:
            for key in w[group]:
                assert torch.equal(g[group][key], w[group][key]), key
    np.testing.assert_array_equal(got[2], want[2])


def test_killed_fit_resumes_to_the_uninterrupted_bits(problem, scene,
                                                      tmp_path, kill_at):
    loss, params = problem
    want = topt.run_adabelief(loss.loss_fn, params.free0, params.lower,
                              params.upper, N_ITER, init_learning_rate=LR)
    ckpt = tmp_path / "fit.ckpt"
    writes = kill_at(2)
    with pytest.raises(Killed):
        _run(problem, ckpt)
    assert writes == [EVERY]
    with np.load(ckpt, allow_pickle=False) as z:
        assert int(z["done"]) == EVERY
        assert z["history"].shape == (EVERY,)
    kill_at(10**9)
    got = _run(problem, ckpt)
    _assert_same_fit(got, want)
    # the uninterrupted checkpointed run is the same fit too
    _assert_same_fit(_run(problem, tmp_path / "whole.ckpt"), want)

    # and the JAX package's AdaBelief, at tests/test_checkpointing.py's bars
    jmodel, ki, ku, kd, kf = jsetup_model(
        scene["data"], scene["sigma_2"], scene["psf"], scene["xs"],
        scene["ys"], scene["s"])
    jparams = JParams(ki, kf, ku, kd)
    jloss = JLoss(scene["data"], jmodel, jparams, scene["sigma_2"])
    _, jfinal, jhist = jopt.run_adabelief(
        jloss.loss_fn, jparams.free0, jparams.lower, jparams.upper, N_ITER,
        init_learning_rate=LR, consts=jloss.consts)
    np.testing.assert_allclose(got[2], np.asarray(jhist), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(
        got[1]["kwargs_analytic"]["a"].numpy(),
        np.asarray(jfinal["kwargs_analytic"]["a"]), rtol=1e-4)


def _tamper(path, **changes):
    with np.load(path, allow_pickle=False) as z:
        payload = dict(z)
    for key, value in changes.items():
        if value is None:
            del payload[key]
        else:
            payload[key] = value
    with open(path, "wb") as f:
        np.savez(f, **payload)


@pytest.mark.parametrize("case", ["digest", "no_digest", "n_iter",
                                  "leaf_shape", "more_leaves",
                                  "fewer_leaves", "unreadable", "pickle"])
def test_checkpoint_refusals(problem, tmp_path, case):
    """Each mismatch is a CheckpointMismatch, never a resume: other
    inputs (or none recorded where a digest is asked for), another
    budget, another carry, a file that is not an npz, and an npz that
    needs pickle to load."""
    ckpt = tmp_path / "fit.ckpt"
    digest = topt.arrays_digest(np.ones(4))
    _run(problem, ckpt, n_iter=EVERY, inputs_digest=digest)
    with open(ckpt, "rb") as f:
        assert f.read(2) == b"PK"       # a zip of arrays, not a pickle
    kw = dict(n_iter=EVERY, inputs_digest=digest)
    match = {"digest": "different input data",
             "no_digest": "different input data", "n_iter": "n_iter",
             "leaf_shape": "shape", "more_leaves": "more carry leaves",
             "fewer_leaves": "fewer carry leaves",
             "unreadable": "unreadable", "pickle": "unreadable"}[case]
    if case == "digest":
        kw["inputs_digest"] = topt.arrays_digest(np.zeros(4))
    elif case == "no_digest":
        _tamper(ckpt, inputs_digest=None)
    elif case == "n_iter":
        kw["n_iter"] = 2 * EVERY
    elif case == "leaf_shape":
        _tamper(ckpt, leaf_1=np.zeros(3, np.float32))
    elif case == "more_leaves":
        _tamper(ckpt, leaf_5=np.zeros(1, np.float32))
    elif case == "fewer_leaves":
        _tamper(ckpt, leaf_4=None)
    elif case == "unreadable":
        ckpt.write_bytes(b"this is not an npz file at all")
    elif case == "pickle":
        _tamper(ckpt, history=np.array([{"code": "run me"}], dtype=object))
    with pytest.raises(topt.CheckpointMismatch, match=match):
        _run(problem, ckpt, **kw)


def _fit_roi(scene, **kw):
    n = scene["data"].shape[-1]
    xs = scene["xs"].astype(np.float64) + (n - 1) / 2.0
    ys = scene["ys"].astype(np.float64) + (n - 1) / 2.0
    config = {**troi.ROI_CONFIG, "roi_deconv_translations_iters": 20,
              "roi_deconv_all_iters": 60}
    angles = np.linspace(0.0, 1.0, scene["data"].shape[0])
    args = (scene["data"], np.sqrt(scene["sigma_2"]), scene["psf"], xs, ys,
            scene["s"], scene["fwhm"], 1.0, angles, config)
    digest = troi.roi_checkpoint_digest(*args[:5], angles, config)
    return troi.fit_roi(*args, device="cpu", checkpoint_every=20,
                        checkpoint_inputs_digest=digest, **kw)


def test_fit_roi_stage2_killed_and_resumed(scene, tmp_path, kill_at):
    """``fit_roi``'s stage 2, killed at its third checkpoint write and
    called again, resumes at 40 of 60 iterations and ends on the
    uninterrupted fit's bits; the file is gone after success."""
    want = _fit_roi(scene)
    ckpt = tmp_path / "roi_stage2.ckpt"
    writes = kill_at(3)
    with pytest.raises(Killed):
        _fit_roi(scene, checkpoint_path=ckpt)
    assert writes == [20, 40]
    with np.load(ckpt, allow_pickle=False) as z:
        assert int(z["done"]) == 40
    kill_at(10**9)
    got = _fit_roi(scene, checkpoint_path=ckpt)
    assert not ckpt.exists()
    for key in ("fluxes", "flux_errors", "reduced_chi2",
                "loss_history_stage2"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("stale", ["garbage", "other_budget"])
def test_fit_roi_discards_a_stale_checkpoint(scene, tmp_path, stale):
    """A file the fit cannot resume from is discarded, the fit starts
    stage 2 again and ends as without it, and the file is gone."""
    want = _fit_roi(scene)
    ckpt = tmp_path / "roi_stage2.ckpt"
    if stale == "garbage":
        ckpt.write_bytes(b"\x00" * 64)
    else:
        topt.save_checkpoint(ckpt, (torch.zeros(3),), 7, 3, torch.zeros(3))
    got = _fit_roi(scene, checkpoint_path=ckpt)
    assert not ckpt.exists()
    np.testing.assert_array_equal(got["fluxes"], want["fluxes"])


@pytest.fixture(scope="module")
def stars():
    sc = star_photometry_scene(3, 5, 16, 2, n_real=(5, 4, 3))
    return sc["data"], sc["sigma"], sc["psf"]


@pytest.mark.parametrize("starlet", [False, True])
def test_star_fit_checkpointed_equals_unsegmented(stars, tmp_path, kill_at,
                                                  starlet):
    """``fit_stars_batched(checkpoint_path=...)`` is the single-segment fit
    to the bit, and a run killed after its first segment resumes to it."""
    kw = dict(n_iter=100, starlet_global_background=starlet, device="cpu")
    want = tbatched.fit_stars_batched(*stars, 2, **kw)
    whole = tbatched.fit_stars_batched(
        *stars, 2, checkpoint_path=tmp_path / "whole.ckpt",
        checkpoint_every=EVERY, **kw)
    ckpt = tmp_path / "stars.ckpt"
    writes = kill_at(2)
    with pytest.raises(Killed):
        tbatched.fit_stars_batched(*stars, 2, checkpoint_path=ckpt,
                                   checkpoint_every=EVERY, **kw)
    assert writes == [EVERY]
    kill_at(10**9)
    resumed = tbatched.fit_stars_batched(*stars, 2, checkpoint_path=ckpt,
                                         checkpoint_every=EVERY, **kw)
    with np.load(ckpt, allow_pickle=False) as z:
        assert int(z["done"]) == 100
        assert z["history"].shape == (3, 100)
    for got in (whole, resumed):
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_star_fit_checkpoint_refuses_changed_inputs_and_flags(stars,
                                                              tmp_path):
    """The star fit's digest covers the data, the PSFs, the flags, the
    seed and the render; the task-level wrapper discards such a file and
    fits from scratch, and lets other errors through."""
    data, sigma, psf = stars
    ckpt = tmp_path / "stale.ckpt"
    kw = dict(n_iter=40, checkpoint_path=ckpt, checkpoint_every=20,
              device="cpu")
    tbatched.fit_stars_batched(data, sigma, psf, 2, **kw)
    assert ckpt.exists()        # the core leaves it; the tasks delete it
    changes = [((data * np.float32(1.01), sigma, psf, 2), {}),
               ((data, sigma, psf * np.float32(1.01), 2), {}),
               ((data, sigma, psf, 2), {"uniform_background_per_epoch":
                                        True}),
               ((data, sigma, psf, 2), {"seed": 1}),
               ((data, sigma, psf, 2), {"irfft_backend": "matmul"})]
    for args, extra in changes:
        with pytest.raises(topt.CheckpointMismatch,
                           match="different input data"):
            tbatched.fit_stars_batched(*args, **kw, **extra)
    logger = logging.getLogger("test.stale_ckpt")
    args, extra = changes[0]
    out = run_discarding_stale_checkpoint(
        lambda: tbatched.fit_stars_batched(*args, **kw, **extra), ckpt,
        logger)
    want = tbatched.fit_stars_batched(*args, n_iter=40, device="cpu")
    np.testing.assert_array_equal(out["fluxes"], want["fluxes"])

    def boom():
        raise ValueError("unrelated")

    with pytest.raises(ValueError, match="unrelated"):
        run_discarding_stale_checkpoint(boom, ckpt, logger)
    with pytest.raises(topt.CheckpointMismatch):
        run_discarding_stale_checkpoint(
            lambda: tbatched.fit_stars_batched(data, sigma, psf, 2, **kw),
            None, logger)


def test_stage2_digest_covers_loss_configuration():
    """The ROI stage-2 digest changes with every knob of the objective
    (JAX ``tests/test_checkpointing.py::
    test_stage2_digest_covers_loss_configuration``), and is the JAX
    package's digest of the same inputs."""
    digest = troi.stage2_checkpoint_digest
    rng = np.random.default_rng(0)
    data = rng.normal(size=(3, 8, 8))
    noise = np.abs(rng.normal(size=(3, 8, 8))) + 0.1
    psf = np.abs(rng.normal(size=(3, 16, 16)))
    cx, cy = np.array([0.5, -1.0]), np.array([0.2, 1.3])
    cfg = {"further_optimize_background": True}
    reg = {"regularization_strength_scales": 1.0,
           "regularization_strength_hf": 1.0}

    base = digest(cfg, reg, False, data, noise, psf, cx, cy)
    assert base == jax_stage2_digest(cfg, reg, False, data, noise, psf,
                                     cx, cy)
    assert digest(cfg, dict(reversed(list(reg.items()))), False, data,
                  noise, psf, cx, cy) == base
    changed = [
        digest(cfg, {**reg, "regularization_strength_scales": 2.0}, False,
               data, noise, psf, cx, cy),
        digest(cfg, reg, True, data, noise, psf, cx, cy),
        digest(cfg, reg, 0.5, data, noise, psf, cx, cy),
        digest({"further_optimize_background": False}, reg, False, data,
               noise, psf, cx, cy),
        digest(cfg, reg, False, data, noise, psf, cx + 0.1, cy),
        digest(cfg, reg, False, data + 1e-3, noise, psf, cx, cy),
    ]
    assert base not in changed
    h, alpha = np.ones(16), np.zeros(3)
    base_h = digest(cfg, reg, False, data, noise, psf, cx, cy,
                    starting_h=h, alpha=alpha)
    assert base_h != base
    assert base_h == jax_stage2_digest(cfg, reg, False, data, noise, psf,
                                       cx, cy, starting_h=h, alpha=alpha)
    assert digest(cfg, reg, False, data, noise, psf, cx, cy,
                  starting_h=h + 1e-4, alpha=alpha) != base_h
    assert digest(cfg, reg, False, data, noise, psf, cx, cy,
                  starting_h=h, alpha=alpha + 0.1) != base_h
