"""The port's frame- and star-sharded batched fits (``parallel/batch.py``,
``build_psf_batched(mesh=...)``, ``fit_stars_batched(mesh=...)``) against
the JAX package's fits on a 2-device mesh.

Two gloo ranks on the CPU (``tests/torch_ranks.py``): a first job is
killed for real after rank 0's second checkpoint write of a star fit on
the 1-D ``batch`` mesh; the module's main job resumes that fit from the
file, discards a stale file that rank 1 looks at late, and computes every
other world-2 case of this file, writing one npz
per rank. JAX's references run in this process on the suite's virtual
CPU devices (``batch_mesh(2)``, ``batch_epoch_mesh(1, 2)``), the port's
unsharded fits too. Scenes (the port's ``make_star_stamps``, made here
and handed to both): the stars of ``tests/test_parallel_batch.py`` (5
stars x 6 epochs, 16 px, s 2, 80 iterations) and 3 frames of its PSF
stamps (4 stars, 20 px; 20 + 80 iterations).

Bars, those of ``tests/test_parallel_batch.py``: stars' fluxes rtol 2e-3
(5e-3 with the starlet background), errors 1e-2, chi2 per frame 1e-2,
loss history 2e-2; PSF chi2 2e-2, full PSF 3e-2 of its peak, FWHM 1e-2,
pixel-phase history 3e-2, the first three Moffat iterations 1e-5; the
two ranks equal to the bit.
"""

import numpy as np
import pytest
import torch

import jax

from lightcurver_tpu.core.deconv.batched import \
    fit_stars_batched as jax_fit_stars
from lightcurver_tpu.core.psf.batched import \
    build_psf_batched as jax_build_psf
from lightcurver_tpu.parallel import batch as jbatch

from lightcurver_tpu_torch.core.deconv.batched import fit_stars_batched
from lightcurver_tpu_torch.core.psf.batched import build_psf_batched
from lightcurver_tpu_torch.parallel import batch as tbatch
from lightcurver_tpu_torch.utilities.synthetic import make_star_stamps

from torch_ranks import check_ranks, start_jobs

STAR_N_ITER = 80
CHECKPOINT_EVERY = 30
PSF_BUDGET = dict(n_iter_analytic=20, n_iter_adabelief=80)
KILL_CODE = 17

# the star fits of the main job: the 1-D mesh and the (1, 2) mesh, this
# one with and without the starlet background
STAR_CASES = ("batch", "batch_epoch", "batch_epoch_starlet")

PRELUDE = r'''
import os
import sys
from pathlib import Path

import numpy as np
import torch.distributed as dist

from lightcurver_tpu_torch.core import optimize
from lightcurver_tpu_torch.core.deconv.batched import fit_stars_batched
from lightcurver_tpu_torch.core.psf.batched import build_psf_batched
from lightcurver_tpu_torch.parallel.batch import (
    auto_fit_mesh, batch_epoch_mesh, batch_mesh, pad_batch_arrays)
from lightcurver_tpu_torch.parallel.distributed import initialize_distributed

initialize_distributed()
rank = dist.get_rank()
z = np.load(sys.argv[1])
stars = (z["star_data"], z["star_noise"], z["star_psf"], 2)
ckpt = Path(sys.argv[1]).with_name("stars.ckpt")


def checkpointed_fit():
    return fit_stars_batched(*stars, n_iter=80, mesh=batch_mesh(),
                             device="cpu", checkpoint_path=ckpt,
                             checkpoint_every=30)
'''

# the first job: rank 0 dies right after its second checkpoint write,
# rank 1 then fails in the barrier that follows it
KILL = PRELUDE + r'''
save = optimize.save_checkpoint


def save_then_die(path, carry, n_iter, done, *args, **kwargs):
    save(path, carry, n_iter, done, *args, **kwargs)
    if done == 60:
        os._exit(17)


optimize.save_checkpoint = save_then_die
checkpointed_fit()
'''

MAIN = PRELUDE + r'''
with np.load(ckpt, allow_pickle=False) as written:
    out = {"done_at_kill": int(written["done"])}
resumed = checkpointed_fit()
out.update({"resumed." + k: v for k, v in resumed.items()})

# a stale file (recorded for another budget) planted by rank 0; rank 1
# looks at it a second late, so a rank deciding alone whether to resume
# would find it gone once rank 0 had refused and deleted it
import logging
import time

import torch
from lightcurver_tpu_torch.utilities.checkpoints import \
    run_discarding_stale_checkpoint

stale = ckpt.with_name("stale.ckpt")
if rank == 0:
    optimize.save_checkpoint(stale, (torch.zeros(3),), 40, 30,
                             torch.zeros(30))
dist.barrier()
exists = os.path.exists


def late_exists(path):
    if str(path) == str(stale):
        time.sleep(1.0)
    return exists(path)


if rank == 1:
    os.path.exists = late_exists
refit = run_discarding_stale_checkpoint(
    lambda: fit_stars_batched(*stars, n_iter=80, mesh=batch_mesh(),
                              device="cpu", checkpoint_path=stale,
                              checkpoint_every=30),
    stale, logging.getLogger("stale"))
os.path.exists = exists
out.update({"stale." + k: v for k, v in refit.items()})
with np.load(stale, allow_pickle=False) as written:
    out["stale_n_iter"] = int(written["n_iter"])
for name, mesh, starlet in (
        ("batch", batch_mesh(), False),
        ("batch_epoch", batch_epoch_mesh(1, 2), False),
        ("batch_epoch_starlet", batch_epoch_mesh(1, 2), True)):
    fit = fit_stars_batched(*stars, n_iter=80, mesh=mesh, device="cpu",
                            starlet_global_background=starlet)
    out.update({f"{name}.{k}": v for k, v in fit.items()})
psf = build_psf_batched(z["psf_data"], z["psf_sigma"], 2, n_iter_analytic=20,
                        n_iter_adabelief=80, mesh=batch_mesh(), device="cpu")
out.update({"psf." + k: v for k, v in psf.items()
            if not isinstance(v, dict)})
out["psf.fwhm_x"] = psf["kwargs_moffat"]["fwhm_x"]
(local,), n_pad = pad_batch_arrays(batch_mesh(), np.arange(5.0))
out["pad_local"], out["pad_n"] = local, n_pad
mesh = auto_fit_mesh(5)
out["auto_names"] = np.array(mesh.mesh_dim_names)
out["auto_shape"] = np.array(mesh.shape)
np.savez(Path(sys.argv[1]).with_name(f"rank{rank}.npz"), **out)
'''


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op torch thread beside the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def star_set():
    data, noise, psf = [], [], []
    for sidx in range(5):
        st = make_star_stamps(n_stars=6, n_pix=16, s=2, seed=20 + sidx,
                              fwhm_x=2.6, fwhm_y=2.6)
        data.append(st["data"])
        noise.append(st["sigma"])
        m = st["psf_true"].shape[-1]
        psf.append(np.broadcast_to(st["psf_true"], (6, m, m)))
    return np.stack(data), np.stack(noise), np.stack(psf)


@pytest.fixture(scope="module")
def psf_frames():
    frames = [make_star_stamps(n_stars=4, n_pix=20, s=2, seed=10 + i,
                               fwhm_x=2.4 + 0.2 * i, fwhm_y=2.6)
              for i in range(3)]
    return (np.stack([f["data"] for f in frames]),
            np.stack([f["sigma"] for f in frames]))


@pytest.fixture(scope="module")
def inputs(star_set, psf_frames, tmp_path_factory):
    path = tmp_path_factory.mktemp("parallel_batch") / "inputs.npz"
    np.savez(path, star_data=star_set[0], star_noise=star_set[1],
             star_psf=star_set[2], psf_data=psf_frames[0],
             psf_sigma=psf_frames[1])
    return path


@pytest.fixture(scope="module")
def started(inputs):
    """The killed job, then the main job, started before the references
    are computed."""
    return start_jobs((KILL, (inputs,)), (MAIN, (inputs,)))


@pytest.fixture(scope="module")
def jobs(started, inputs):
    """The killed job's results and the main job's npz per rank."""
    killed, main = started.result()
    check_ranks(main)
    ranks = [dict(np.load(inputs.with_name(f"rank{r}.npz"))) for r in (0, 1)]
    return killed, ranks


@pytest.fixture(scope="module")
def ranks(jobs):
    return jobs[1]


@pytest.fixture(scope="module")
def jax_refs(started, star_set, psf_frames):
    """JAX's fits on 2-device meshes."""
    data, noise, psf = star_set
    return {
        "batch": jax_fit_stars(data, noise, psf, 2, n_iter=STAR_N_ITER,
                               mesh=jbatch.batch_mesh(2)),
        "batch_epoch_starlet": jax_fit_stars(
            data, noise, psf, 2, n_iter=STAR_N_ITER,
            mesh=jbatch.batch_epoch_mesh(1, 2),
            starlet_global_background=True),
        "psf": jax_build_psf(*psf_frames, 2, mesh=jbatch.batch_mesh(2),
                             **PSF_BUDGET),
    }


@pytest.fixture(scope="module")
def port_refs(started, star_set, psf_frames):
    """The port's unsharded fits on the render the sharded ones are
    forced to."""
    kw = dict(n_iter=STAR_N_ITER, mesh=None, device="cpu",
              irfft_backend="matmul")
    shipped = fit_stars_batched(*star_set, 2, **kw)
    return {
        "batch": shipped, "batch_epoch": shipped,
        "batch_epoch_starlet": fit_stars_batched(
            *star_set, 2, starlet_global_background=True, **kw),
        "psf": build_psf_batched(*psf_frames, 2, mesh=None, device="cpu",
                                 irfft_backend="matmul", **PSF_BUDGET),
    }


def _result(res, name):
    return {k[len(name) + 1:]: v for k, v in res.items()
            if k.startswith(name + ".")}


def _check_stars(shd, ref, flux_rtol):
    assert shd["fluxes"].shape == ref["fluxes"].shape
    np.testing.assert_allclose(shd["fluxes"], ref["fluxes"], rtol=flux_rtol)
    np.testing.assert_allclose(shd["fluxes_uncertainties"],
                               ref["fluxes_uncertainties"], rtol=1e-2)
    np.testing.assert_allclose(shd["chi2_per_frame"], ref["chi2_per_frame"],
                               rtol=1e-2)
    np.testing.assert_allclose(shd["loss_history"], ref["loss_history"],
                               rtol=2e-2)
    assert shd["residuals"].shape == ref["residuals"].shape


def _check_psf(shd, ref):
    assert shd["narrow_psf"].shape == ref["narrow_psf"].shape
    np.testing.assert_allclose(shd["chi2"], ref["chi2"], rtol=2e-2)
    peak = ref["full_psf"].max()
    np.testing.assert_allclose(shd["full_psf"] / peak,
                               ref["full_psf"] / peak, atol=3e-2)
    np.testing.assert_allclose(shd["fwhm_x"],
                               ref["kwargs_moffat"]["fwhm_x"], rtol=1e-2)
    np.testing.assert_allclose(shd["loss_history_pixels"],
                               ref["loss_history_pixels"], rtol=3e-2)
    np.testing.assert_allclose(shd["loss_history_analytic"][:, :3],
                               ref["loss_history_analytic"][:, :3],
                               rtol=1e-5)


@pytest.mark.parametrize("name", ["batch", "batch_epoch_starlet"])
def test_star_fit_matches_jax(jax_refs, ranks, name):
    """The 1-D mesh (5 stars padded to 6, 3 a rank) and the (1, 2) mesh
    with the starlet background (each rank 3 of the 6 epochs; its K1
    term on rank 0) against JAX's fits on the same meshes."""
    _check_stars(_result(ranks[0], name), jax_refs[name],
                 5e-3 if "starlet" in name else 2e-3)


@pytest.mark.parametrize("name", STAR_CASES)
def test_star_fit_matches_unsharded(port_refs, ranks, name):
    _check_stars(_result(ranks[0], name), port_refs[name],
                 5e-3 if "starlet" in name else 2e-3)


def test_psf_fit_matches_jax(jax_refs, ranks):
    """3 frames padded to 4 on the 1-D mesh, 2 a rank."""
    _check_psf(_result(ranks[0], "psf"), jax_refs["psf"])


def test_psf_fit_matches_unsharded(port_refs, ranks):
    _check_psf(_result(ranks[0], "psf"), port_refs["psf"])


def test_ranks_agree_to_the_bit(ranks):
    assert ranks[0].keys() == ranks[1].keys()
    for key in ranks[0]:
        if key == "pad_local":
            continue
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key],
                                      err_msg=key)


def test_checkpoint_killed_and_resumed(jobs, ranks):
    """Rank 0 wrote the gathered carry of both ranks' stars; the job died
    after the second write (rank 0 exited, rank 1 failed in the barrier
    that follows it); a new job resumed from the file and gave the
    uninterrupted fit's bits."""
    killed = jobs[0]
    assert killed[0][0] == KILL_CODE, killed[0][1][-2000:]
    assert killed[1][0] != 0, killed[1][1][-2000:]
    assert int(ranks[0]["done_at_kill"]) == 2 * CHECKPOINT_EVERY
    resumed, plain = _result(ranks[0], "resumed"), _result(ranks[0], "batch")
    assert resumed.keys() == plain.keys()
    for key in plain:
        np.testing.assert_array_equal(resumed[key], plain[key], err_msg=key)


def test_stale_checkpoint_discarded_at_world_two(ranks):
    """A file recorded for another budget, which rank 1 looks at late:
    rank 0 alone decides, both ranks refuse it together, rank 0 deletes
    it between barriers, and the refit gives the uninterrupted fit's bits
    and leaves its own finished file."""
    for res in ranks:
        refit, plain = _result(res, "stale"), _result(res, "batch")
        assert refit.keys() == plain.keys()
        for key in plain:
            np.testing.assert_array_equal(refit[key], plain[key],
                                          err_msg=key)
        assert int(res["stale_n_iter"]) == STAR_N_ITER


def test_pad_batch_arrays_keeps_the_rank_share(ranks):
    """5 entries pad to 6 by repeating the last; rank 0 keeps 0-2, rank 1
    3, 4 and the repeat."""
    assert int(ranks[0]["pad_n"]) == 1
    np.testing.assert_array_equal(ranks[0]["pad_local"], [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(ranks[1]["pad_local"], [3.0, 4.0, 4.0])
    assert tbatch.strip_batch({"x": np.arange(6)}, 1)["x"].tolist() \
        == [0, 1, 2, 3, 4]


def test_pad_batch_arrays_rejects_mismatched_axes():
    with pytest.raises(ValueError, match="inconsistent leading batch"):
        tbatch.pad_batch_arrays(None, np.zeros((5, 2)), np.zeros((4,)))


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_fit_mesh_rule_matches_jax(monkeypatch, n_devices):
    """The rule of ``auto_fit_mesh`` against JAX's on 1, 2, 4 and 8
    devices, for 1 to 10 problems."""
    devices = jax.devices()[:n_devices]
    monkeypatch.setattr(jax, "device_count", lambda: n_devices)
    monkeypatch.setattr(jax, "devices", lambda: devices)
    for n_items in range(1, 11):
        mesh = jbatch.auto_fit_mesh(n_items)
        want = None if mesh is None else tuple(
            mesh.shape[name] for name in mesh.axis_names)
        assert tbatch.fit_mesh_shape(n_items, n_devices) == want, n_items


def test_auto_fit_mesh_at_world_two(ranks):
    """5 stars on 2 ranks: a 1-D batch mesh."""
    assert ranks[0]["auto_names"].tolist() == ["batch"]
    assert ranks[0]["auto_shape"].tolist() == [2]
