"""The port's epoch-sharded joint deconvolution (``parallel/deconv.py``
and ``fit_roi``'s epoch mesh) against the JAX package's 2-device fit.

One module-scoped job of two gloo ranks on the CPU
(``tests/torch_ranks.py``) computes every world-2 case of this file and
writes one npz per rank; the JAX reference runs in this process on the
suite's virtual CPU devices (``fit_deconv_sharded`` on ``epoch_mesh(2)``),
the port's unsharded fits too. Scenes: the port's ``make_roi_scene`` at
the shape of ``tests/test_distributed_fit.py`` (8 and 7 epochs, 12 px,
s 2, 2 sources, 60 AdaBelief iterations), made once here and handed to
JAX and, through an npz, to the ranks.

Bars, those of ``tests/test_parallel.py``: loss history rtol 2e-4 (atol
1e-3) and fluxes rtol 1e-3 (atol 1e-3), against JAX's 2-device fit and
against the port's unsharded fit; the two ranks equal to the bit; the
loss with every term at world 2 against the unsharded loss, rtol 1e-6
(each term other than the chi2 counted once); a world of one rank equal
to the unsharded ``fit_roi`` to the bit.
"""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from lightcurver_tpu.parallel import deconv as jdeconv
from lightcurver_tpu.parallel.mesh import epoch_mesh as jax_epoch_mesh

from lightcurver_tpu_torch.core.deconv.loss import Loss
from lightcurver_tpu_torch.core.deconv.model import setup_model
from lightcurver_tpu_torch.core.optimize import run_adabelief
from lightcurver_tpu_torch.core.params import Params
from lightcurver_tpu_torch.parallel import deconv as tdeconv
from lightcurver_tpu_torch.parallel.distributed import \
    initialize_distributed
from lightcurver_tpu_torch.parallel.mesh import epoch_mesh
from lightcurver_tpu_torch.processes import roi_modelling as troi
from lightcurver_tpu_torch.utilities.synthetic import make_roi_scene

from torch_ranks import check_ranks, start_jobs

N_ITER = 60
EPOCHS = (8, 7)
ROI_CONFIG = dict(troi.ROI_CONFIG, roi_deconv_translations_iters=20,
                  roi_deconv_all_iters=40)

# the loss with every term at one point, built the same way by the ranks
# (sharded) and by this process (unsharded)
LOSS_POINT = r'''
def loss_point(z, backend, epochs=None, group=None):
    import numpy as np
    import torch
    from lightcurver_tpu_torch.core.deconv.loss import Loss, Prior
    from lightcurver_tpu_torch.core.deconv.model import setup_model
    from lightcurver_tpu_torch.core.params import Params

    model, kw, up, down, _ = setup_model(
        z["data8"], z["sigma_28"], z["psf8"], z["xs"], z["ys"], 2,
        device="cpu")
    for group_name, leaves in (("kwargs_analytic", ("a", "dx", "dy")),
                               ("kwargs_background", ("h", "mean"))):
        for key in leaves:
            kw[group_name][key] = torch.tensor(z["point_" + key])
    params = Params(kw, {"kwargs_sersic": {}}, up, down)
    n = len(z["xs"])
    loss = Loss(z["data8"], model, params, z["sigma_28"],
                regularization_terms="l1_starlet",
                regularization_strength_positivity=100.0,
                regularization_strength_pts_source=0.01,
                regularization_strength_flux_uniformity=1.0,
                W=z["W"], prior=Prior([["c_x", z["xs"], [0.5] * n]]),
                irfft_backend=backend, epochs=epochs, group=group)
    leaves = [v for d in params.free0.values() for v in d.values()]
    for v in leaves:
        v.requires_grad_(True)
    value = loss.loss_fn(params.free0)
    value.backward()
    grad = np.concatenate([v.grad.numpy().ravel() for v in leaves])
    return loss, params, float(value.detach()), grad
'''

WORKER = LOSS_POINT + r'''
import sys
from pathlib import Path

import numpy as np
import torch.distributed as dist

from lightcurver_tpu_torch.parallel.deconv import (
    epoch_range, fit_deconv_sharded, sharded_deconv_step)
from lightcurver_tpu_torch.parallel.distributed import initialize_distributed
from lightcurver_tpu_torch.parallel.mesh import EPOCH_AXIS, epoch_mesh
from lightcurver_tpu_torch.processes import roi_modelling as troi

initialize_distributed()
rank = dist.get_rank()
z = np.load(sys.argv[1])
out = {}
for n in (8, 7):
    kw, model, hist = fit_deconv_sharded(
        z[f"data{n}"], z[f"sigma_2{n}"], z[f"psf{n}"], z["xs"], z["ys"], 2,
        epoch_mesh(), n_iter=60, init_learning_rate=1e-2, device="cpu")
    out[f"a{n}"] = kw["kwargs_analytic"]["a"]
    out[f"dx{n}"] = kw["kwargs_analytic"]["dx"]
    out[f"hist{n}"] = hist
    out[f"model_epochs{n}"] = model.n_epochs

mesh = epoch_mesh()
for backend in ("fft", "matmul"):
    loss, params, value, grad = loss_point(
        z, backend, epoch_range(mesh, 8), mesh.get_group(EPOCH_AXIS))
    out[f"loss_{backend}"], out[f"grad_{backend}"] = value, grad
    step, opt0 = sharded_deconv_step(loss, params, learning_rate=1e-3)
    _, (mu, _, _), first = step(params.free0, opt0, params.lower,
                                params.upper)
    out[f"step_mu_{backend}"], out[f"step_loss_{backend}"] = mu.numpy(), \
        float(first)

ckpt = Path(sys.argv[2])
fit = troi.fit_roi(*[z[f"roi_{i}"] for i in range(9)], troi.ROI_CONFIG | dict(
    roi_deconv_translations_iters=20, roi_deconv_all_iters=40),
    device="cpu", checkpoint_path=ckpt, checkpoint_every=15)
for key in ("fluxes", "reduced_chi2", "W", "loss_history_stage2"):
    out[f"roi_{key}"] = fit[key]
out["roi_checkpoint_left"] = ckpt.exists()
np.savez(Path(sys.argv[1]).with_name(f"rank{rank}.npz"), **out)
'''


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op torch thread beside the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene(n_epochs):
    return make_roi_scene(n_epochs=n_epochs, n_pix=12, s=2, n_sources=2,
                          noise_sigma=0.5, seed=0, fwhm_range=(2.5, 2.5),
                          flux_range=(50.0, 100.0))


def _roi_args(scene):
    n = scene["data"].shape[-1]
    return (scene["data"], np.sqrt(scene["sigma_2"]), scene["psf"],
            scene["xs"] + (n - 1) / 2.0, scene["ys"] + (n - 1) / 2.0,
            scene["s"], scene["fwhm"], 1.0, np.zeros(len(scene["data"])))


@pytest.fixture(scope="module")
def scenes():
    return {n: _scene(n) for n in EPOCHS}


@pytest.fixture(scope="module")
def inputs(scenes, tmp_path_factory):
    """The npz the ranks read: both scenes, a point off the start for the
    loss with every term, and the arguments of the world-2 ``fit_roi``."""
    rng = np.random.default_rng(4)
    sc = scenes[8]
    m = 24
    z = {"xs": sc["xs"], "ys": sc["ys"]}
    for n in EPOCHS:
        for key in ("data", "sigma_2", "psf"):
            z[f"{key}{n}"] = scenes[n][key]
    z["point_a"] = (sc["a_true"].ravel()
                    * rng.uniform(0.9, 1.1, sc["a_true"].size))
    for key in ("dx", "dy", "mean"):
        z[f"point_{key}"] = rng.normal(0, 0.05, 8)
    z["point_h"] = rng.normal(0, 1e-2, m * m)
    z["W"] = rng.uniform(0.5, 1.5, (5, m, m))
    for i, arg in enumerate(_roi_args(scenes[7])):
        z[f"roi_{i}"] = np.asarray(arg)
    z = {k: np.asarray(v, dtype=np.float32) if np.asarray(v).dtype.kind
         == "f" else np.asarray(v) for k, v in z.items()}
    path = tmp_path_factory.mktemp("parallel") / "inputs.npz"
    np.savez(path, **z)
    return path


@pytest.fixture(scope="module")
def job(inputs):
    """The world-2 job, started before the references are computed."""
    return start_jobs((WORKER, (inputs, inputs.with_name("roi.ckpt"))))


@pytest.fixture(scope="module")
def ranks(job, inputs):
    """Both ranks' results."""
    check_ranks(job.result()[0])
    return [dict(np.load(inputs.with_name(f"rank{r}.npz"))) for r in (0, 1)]


@pytest.fixture(scope="module")
def jax_fits(job, scenes):
    """JAX's 2-device epoch-sharded fit of each scene."""
    out = {}
    for n in EPOCHS:
        sc = scenes[n]
        kw, model, hist = jdeconv.fit_deconv_sharded(
            sc["data"], sc["sigma_2"], sc["psf"], sc["xs"], sc["ys"], 2,
            jax_epoch_mesh(2), n_iter=N_ITER, init_learning_rate=1e-2)
        out[n] = (np.asarray(kw["kwargs_analytic"]["a"]), np.asarray(hist))
    return out


@pytest.fixture(scope="module")
def port_unsharded(job, scenes):
    """The port's unsharded fit of each scene on the render the world-2
    fit is forced to."""
    out = {}
    for n in EPOCHS:
        sc = scenes[n]
        model, ki, ku, kd, kf = setup_model(sc["data"], sc["sigma_2"],
                                            sc["psf"], sc["xs"], sc["ys"], 2,
                                            device="cpu")
        params = Params(ki, kf, ku, kd)
        loss = Loss(sc["data"], model, params, sc["sigma_2"],
                    irfft_backend="matmul")
        best, _, hist = run_adabelief(loss.loss_fn, params.free0,
                                      params.lower, params.upper, N_ITER,
                                      init_learning_rate=1e-2)
        params.set_best(best)
        a = params.best_fit_values()["kwargs_analytic"]["a"].numpy()
        out[n] = (a, hist)
    return out


@pytest.mark.parametrize("n_epochs", EPOCHS)
def test_sharded_fit_matches_jax(jax_fits, ranks, n_epochs):
    a_ref, hist_ref = jax_fits[n_epochs]
    res = ranks[0]
    assert res[f"hist{n_epochs}"].shape == (N_ITER,)
    np.testing.assert_allclose(res[f"hist{n_epochs}"], hist_ref, rtol=2e-4,
                               atol=1e-3)
    np.testing.assert_allclose(res[f"a{n_epochs}"], a_ref, rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("n_epochs", EPOCHS)
def test_sharded_fit_matches_unsharded(port_unsharded, ranks, n_epochs):
    a_ref, hist_ref = port_unsharded[n_epochs]
    res = ranks[0]
    np.testing.assert_allclose(res[f"hist{n_epochs}"], hist_ref, rtol=2e-4,
                               atol=1e-3)
    np.testing.assert_allclose(res[f"a{n_epochs}"], a_ref, rtol=1e-3,
                               atol=1e-3)


def test_ranks_agree_to_the_bit(ranks):
    assert ranks[0].keys() == ranks[1].keys()
    for key in ranks[0]:
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key],
                                      err_msg=key)


def test_seven_epochs_pad_and_strip(ranks):
    """7 epochs pad to 8 on two ranks; the results are the real 7."""
    res = ranks[0]
    assert res["a7"].shape == (14,)
    assert res["dx7"].shape == (7,)
    assert int(res["model_epochs7"]) == 7
    assert np.isfinite(res["a7"]).all()


@pytest.mark.parametrize("backend", ["fft", "matmul"])
def test_loss_counts_each_term_once(ranks, inputs, backend):
    """The loss with the starlet l1, positivity, point-source, flux
    uniformity and prior terms at world 2 equals the unsharded loss
    (rtol 1e-6), and so does its gradient (1e-5 of its largest entry);
    each term other than the chi2 is counted once, not once per rank.
    The sharded step's first moment is 0.1 times that gradient."""
    ns = {}
    exec(LOSS_POINT, ns)
    _, _, value, grad = ns["loss_point"](np.load(inputs), backend)
    res = ranks[0]
    np.testing.assert_allclose(res[f"loss_{backend}"], value, rtol=1e-6)
    scale = np.abs(grad).max()
    np.testing.assert_allclose(res[f"grad_{backend}"], grad, rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(res[f"step_loss_{backend}"], value,
                               rtol=1e-6)
    np.testing.assert_allclose(res[f"step_mu_{backend}"], 0.1 * grad,
                               rtol=0, atol=1e-6 * scale)


def test_fit_roi_shards_over_every_rank(ranks, scenes):
    """``fit_roi(mesh="auto")`` at world 2 (7 epochs padded to 8, stage 2
    checkpointed every 15 iterations through rank 0) against the port's
    unsharded ``fit_roi`` on the same render: fluxes within 1 mmag,
    reduced chi2 within 1 %, the same noise weights (computed on rank 0
    and broadcast), and no checkpoint left."""
    ref = troi.fit_roi(*_roi_args(scenes[7]), ROI_CONFIG, device="cpu",
                       irfft_backend="matmul", mesh=None)
    res = ranks[0]
    dmag = np.abs(2.5 * np.log10(res["roi_fluxes"] / ref["fluxes"]))
    assert dmag.max() < 1e-3, dmag.max()
    np.testing.assert_allclose(res["roi_reduced_chi2"], ref["reduced_chi2"],
                               rtol=1e-2)
    np.testing.assert_array_equal(res["roi_W"], ref["W"])
    assert not res["roi_checkpoint_left"]


def test_pad_helpers_match_jax():
    """The numpy copies of the pad and strip helpers give JAX's arrays."""
    rng = np.random.default_rng(0)
    data = rng.normal(size=(5, 4, 4)).astype(np.float32)
    sigma_2 = rng.uniform(1, 2, (5, 4, 4)).astype(np.float32)
    psf = rng.uniform(0, 1, (5, 8, 8)).astype(np.float32)
    for got, want in zip(tdeconv.pad_epoch_stacks(data, sigma_2, psf, 8),
                         jdeconv.pad_epoch_stacks(data, sigma_2, psf, 8)):
        np.testing.assert_array_equal(got, np.asarray(want))
    n, n_pad, M = 5, 3, 2
    kwargs = {
        "kwargs_analytic": {
            "a": np.arange(n * M, dtype=np.float32),
            "c_x": np.array([1.0, 2.0], np.float32),
            "dx": np.arange(n, dtype=np.float32),
            "alpha": np.ones(n, np.float32)},
        "kwargs_background": {"mean": np.zeros(n, np.float32),
                              "h": np.zeros(16, np.float32)},
    }
    padded = tdeconv.pad_epoch_kwargs(kwargs, n, n_pad, M)
    jpadded = jdeconv.pad_epoch_kwargs(kwargs, n, n_pad, M)
    for grp in kwargs:
        for key in kwargs[grp]:
            np.testing.assert_array_equal(padded[grp][key],
                                          np.asarray(jpadded[grp][key]))
    stripped = tdeconv.strip_epoch_kwargs(padded, n, n_pad, M)
    jstripped = jdeconv.strip_epoch_kwargs(jpadded, n, n_pad, M)
    for grp in kwargs:
        for key in kwargs[grp]:
            np.testing.assert_array_equal(stripped[grp][key],
                                          np.asarray(jstripped[grp][key]))
            np.testing.assert_array_equal(stripped[grp][key],
                                          kwargs[grp][key])


def test_shard_helpers_cut_the_rank_epochs():
    """A rank's share of a kwargs tree and of the epoch-stacked consts."""
    tree = {"kwargs_analytic": {"a": torch.arange(8.0),
                                "c_x": torch.tensor([1.0, 2.0]),
                                "dx": torch.arange(4.0)},
            "kwargs_background": {"h": torch.zeros(9),
                                  "mean": torch.arange(4.0)}}
    part = tdeconv.shard_pytree(tree, (2, 4), 2)
    assert part["kwargs_analytic"]["a"].tolist() == [4.0, 5.0, 6.0, 7.0]
    assert part["kwargs_analytic"]["dx"].tolist() == [2.0, 3.0]
    assert part["kwargs_analytic"]["c_x"] is tree["kwargs_analytic"]["c_x"]
    assert part["kwargs_background"]["h"].shape == (9,)
    consts = tdeconv.shard_consts({"data": torch.arange(4.0),
                                   "W": torch.ones(3)}, (1, 3))
    assert consts["data"].tolist() == [1.0, 2.0]
    assert consts["W"].shape == (3,)


@pytest.mark.parametrize("backend", ["fft", "matmul"])
def test_world_of_one_is_the_unsharded_fit_to_the_bit(scenes, backend):
    """``fit_roi`` on an explicit epoch mesh of one gloo rank equals the
    unsharded ``fit_roi``, bit for bit: the split of the loss keeps the
    unsharded sums in their order."""
    args = _roi_args(scenes[8])
    ref = troi.fit_roi(*args, ROI_CONFIG, device="cpu",
                       irfft_backend=backend, mesh=None)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    initialize_distributed(f"localhost:{port}", 1, 0)
    try:
        out = troi.fit_roi(*args, ROI_CONFIG, device="cpu",
                           irfft_backend=backend, mesh=epoch_mesh())
    finally:
        dist.destroy_process_group()
    for key in ("fluxes", "flux_errors", "reduced_chi2", "W",
                "loss_history_stage1", "loss_history_stage2"):
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)
