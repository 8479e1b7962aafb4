"""The optimizer loops of the fits under a mesh (``core/optimize.py`` with
``parallel/``) as capturable steps.

On the card a fit under a mesh replays each of its loops as one CUDA
graph with the NCCL all-reduce of its loss inside, and calls its steps
eagerly under gloo, which all-reduces through the host; one rule decides,
``parallel.distributed.capturable``. What such a capture needs is held
here on the CPU over gloo, through the three fits' entry points on an
explicit mesh (``fit_roi`` on an epoch mesh, both stages;
``build_psf_batched`` on a batch mesh; ``fit_stars_batched`` on a
(batch, epoch) mesh), on a world of one rank in this process and on two
ranks (``tests/torch_ranks.py``) whose epochs hold different data:

- every step of every loop dispatches no host round trip (the guard of
  ``tests/test_torch_captured_loops.py``);
- every rank issues the same number of all-reduces in every step, so the
  ranks' graphs meet collective for collective: ROI stage 1 seven an
  iteration (JAX's ``lbfgsb_scan``: one evaluation at x and six
  line-search trials, each one flat all-reduce), stage 2 and the star fit
  one, the PSF fit none;
- each fit hands its loops the rule's answer for the group its loss
  all-reduces over: eager under gloo, captured under NCCL (its backend
  read as NCCL through a patched ``dist.get_backend``) and with no group.
"""

import hashlib
import json
import socket
from contextlib import contextmanager

import numpy as np
import pytest
import torch
import torch.distributed as dist

from lightcurver_tpu_torch.core import optimize as topt
from lightcurver_tpu_torch.core.deconv.batched import fit_stars_batched
from lightcurver_tpu_torch.core.psf.batched import build_psf_batched
from lightcurver_tpu_torch.parallel.batch import batch_epoch_mesh, batch_mesh
from lightcurver_tpu_torch.parallel.distributed import (capturable,
                                                        initialize_distributed)
from lightcurver_tpu_torch.parallel.mesh import epoch_mesh
from lightcurver_tpu_torch.processes.roi_modelling import ROI_CONFIG, fit_roi
from lightcurver_tpu_torch.utilities.synthetic import (make_roi_scene,
                                                       psf_bench_frames,
                                                       star_photometry_scene)

from test_torch_captured_loops import NoHostRoundTrip
from torch_ranks import check_ranks, run_ranks


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op torch thread beside the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _roi_args():
    sc = make_roi_scene(n_epochs=4, n_pix=12, s=2, n_sources=2,
                        noise_sigma=0.5, seed=0, fwhm_range=(2.5, 2.5),
                        flux_range=(50.0, 100.0))
    n = sc["data"].shape[-1]
    return (sc["data"], sc["sigma_2"] ** 0.5, sc["psf"],
            sc["xs"] + (n - 1) / 2.0, sc["ys"] + (n - 1) / 2.0, sc["s"],
            sc["fwhm"], 1.0, [0.0] * 4,
            {**ROI_CONFIG, "roi_deconv_translations_iters": 3,
             "roi_deconv_all_iters": 4})


# each fit on the mesh of the world it runs in, and the result arrays
# whose bits the ranks compare
MESHES = {"fit_roi": epoch_mesh, "build_psf_batched": batch_mesh,
          "fit_stars_batched": lambda: batch_epoch_mesh(1)}
FITS = {
    "fit_roi": lambda mesh: fit_roi(*_roi_args(), device="cpu",
                                    irfft_backend="matmul", mesh=mesh),
    "build_psf_batched": lambda mesh: build_psf_batched(
        *psf_bench_frames(2, 3, 12), 2, n_iter_analytic=3,
        n_iter_adabelief=4, device="cpu", irfft_backend="matmul",
        dft_pad=8, mesh=mesh),
    "fit_stars_batched": lambda mesh: fit_stars_batched(
        *(star_photometry_scene(2, 4, 8, 2)[k] for k in ("data", "sigma",
                                                         "psf", "s")),
        n_iter=4, starlet_global_background=True, irfft_backend="matmul",
        mesh=mesh, device="cpu"),
}
RESULTS = {"fit_roi": ("fluxes", "loss_history_stage1",
                       "loss_history_stage2"),
           "build_psf_batched": ("narrow_psf", "loss_history_pixels"),
           "fit_stars_batched": ("fluxes", "chi2")}
# the all-reduces of each step of each loop (the steps of the budgets
# above), and whether each loop's loss all-reduces over a group
ALL_REDUCES = {"fit_roi": [[7] * 3, [1] * 4],
               "build_psf_batched": [[0] * 3, [0] * 4],
               "fit_stars_batched": [[1] * 4]}
GROUPED = {"fit_roi": [True, True], "build_psf_batched": [False, False],
           "fit_stars_batched": [True]}


@contextmanager
def counted_steps():
    """Within it every optimizer loop runs one step at a time under
    :class:`NoHostRoundTrip`, and the all-reduces of each step are
    counted. Yields ``[(loop, [all-reduces of each step])]``, in the
    order the loops first step."""
    loops, calls = [], [0]
    all_reduce, call = dist.all_reduce, topt.StepLoop._call

    def counted(*args, **kwargs):
        calls[0] += 1
        return all_reduce(*args, **kwargs)

    def one_step_at_a_time(self, n):
        steps = next((s for loop, s in loops if loop is self), None)
        if steps is None:
            steps = []
            loops.append((self, steps))
        for _ in range(n):
            before = calls[0]
            with NoHostRoundTrip():
                call(self, 1)
            steps.append(calls[0] - before)

    dist.all_reduce, topt.StepLoop._call = counted, one_step_at_a_time
    try:
        yield loops
    finally:
        dist.all_reduce, topt.StepLoop._call = all_reduce, call


def run_mesh_fit(name):
    """One fit of :data:`FITS` on its mesh over this world, counted:
    ``{"all_reduces": [[...] of each loop], "eager": [...], "digest": the
    SHA-256 of its result arrays}``."""
    mesh = MESHES[name]()
    with counted_steps() as loops:
        out = FITS[name](mesh)
    digest = hashlib.sha256()
    for key in RESULTS[name]:
        digest.update(np.ascontiguousarray(out[key]).tobytes())
    return {"all_reduces": [steps for _, steps in loops],
            "eager": [loop.eager for loop, _ in loops],
            "digest": digest.hexdigest()}


@pytest.fixture()
def world_of_one():
    """A world of one gloo rank in this process."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    initialize_distributed(f"localhost:{port}", 1, 0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_capturable_without_a_group():
    """A loop with no collective is captured, in any world."""
    assert capturable() and capturable(None)


def test_capturable_under_nccl(monkeypatch):
    """A group whose backend reads "nccl" is captured."""
    group = object()
    monkeypatch.setattr(dist, "get_backend",
                        lambda g=None: "nccl" if g is group else "gloo")
    assert capturable(group)


def test_not_capturable_under_gloo(world_of_one):
    """A gloo group, the default one and a mesh's, runs eagerly."""
    assert dist.get_backend() == "gloo"
    assert not capturable(dist.group.WORLD)
    assert not capturable(epoch_mesh().get_group("epoch"))


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
@pytest.mark.parametrize("name", list(FITS))
def test_world_of_one_steps_keep_to_the_device(world_of_one, monkeypatch,
                                               name, backend):
    """On a mesh of one rank: every step of each loop dispatches no host
    round trip and issues the all-reduces of its loss, and the loops are
    eager exactly where their group is gloo. With the backend read as
    NCCL no loop is eager (on the CPU the step is called all the same)."""
    if backend == "nccl":
        mesh = MESHES[name]()
        monkeypatch.setitem(MESHES, name, lambda: mesh)
        monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    got = run_mesh_fit(name)
    assert got["all_reduces"] == ALL_REDUCES[name]
    assert got["eager"] == [grouped and backend == "gloo"
                            for grouped in GROUPED[name]]


RANK_JOB = r'''
import json
import sys

sys.path.insert(0, "tests")
import torch.distributed as dist

from lightcurver_tpu_torch.parallel.distributed import initialize_distributed
from test_torch_captured_shards import FITS, run_mesh_fit

initialize_distributed()
out = {name: run_mesh_fit(name) for name in FITS}
print("RESULT " + json.dumps(out), flush=True)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def two_ranks():
    """Each fit of :data:`FITS` on two gloo ranks: every rank's counts."""
    results = run_ranks(RANK_JOB)
    check_ranks(results)
    return [json.loads([line for line in out.splitlines()
                        if line.startswith("RESULT ")][0][len("RESULT "):])
            for _, out in results]


@pytest.mark.parametrize("name", list(FITS))
def test_two_ranks_issue_the_same_all_reduces_in_every_step(two_ranks,
                                                            name):
    """On two ranks, each fitting its own epochs (or frames), every step
    of each loop dispatched no host round trip (the guard would have
    failed the rank) and issued on each rank the all-reduces of
    :data:`ALL_REDUCES`: ROI stage 1 seven an iteration."""
    for rank in two_ranks:
        assert rank[name]["all_reduces"] == ALL_REDUCES[name]
    assert two_ranks[0][name]["all_reduces"] \
        == two_ranks[1][name]["all_reduces"]


@pytest.mark.parametrize("name", list(FITS))
def test_two_ranks_under_gloo_step_eagerly(two_ranks, name):
    """Under gloo a loop whose loss all-reduces is eager on every rank;
    one with no collective is not."""
    for rank in two_ranks:
        assert rank[name]["eager"] == GROUPED[name]


def test_two_ranks_agree_to_the_bit(two_ranks):
    """The ranks' results are the same bits: every rank stepped alike."""
    assert {name: got["digest"] for name, got in two_ranks[0].items()} \
        == {name: got["digest"] for name, got in two_ranks[1].items()}
