"""The port's process-group bootstrap and meshes (``parallel/distributed.py``,
``parallel/mesh.py``), against the JAX package's contract
(``tests/test_distributed.py``).

In this process: ``initialize_distributed``'s parsing of torchrun's
variables against explicit arguments, and its refusals of a partial
topology, with ``torch.distributed.init_process_group`` replaced by a
recorder. One module-scoped job of two gloo ranks (``tests/torch_ranks.py``)
bootstraps from torchrun's variables for real and records, per rank,
what the other tests check: the world, a second call doing nothing, a
cross-rank gather, the meshes ``"auto"`` resolves to, the refusal of
meshes that do not cover the world, and the parameter layout each rank
flattens.
"""

import numpy as np
import pytest
import torch.distributed as dist

from lightcurver_tpu_torch.parallel import distributed as tdist

from torch_ranks import check_ranks, run_ranks

WORKER = r'''
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from lightcurver_tpu_torch.core.deconv.batched import fit_stars_batched
from lightcurver_tpu_torch.core.deconv.model import setup_model
from lightcurver_tpu_torch.core.optimize import flatten
from lightcurver_tpu_torch.core.params import Params
from lightcurver_tpu_torch.core.psf.batched import build_psf_batched
from lightcurver_tpu_torch.parallel.batch import (
    auto_batch_mesh, auto_fit_mesh, batch_epoch_mesh, gather_to_host)
from lightcurver_tpu_torch.parallel.distributed import initialize_distributed
from lightcurver_tpu_torch.parallel.mesh import epoch_mesh
from lightcurver_tpu_torch.processes.roi_modelling import (
    ROI_CONFIG, _maybe_epoch_mesh, fit_roi)
from lightcurver_tpu_torch.utilities.synthetic import make_roi_scene

initialize_distributed()
initialize_distributed()
rank = dist.get_rank()
out = {"world": dist.get_world_size(), "rank": rank,
       "backend": dist.get_backend()}
rows = torch.arange(3.0) + 10 * rank
out["gathered"] = gather_to_host(auto_batch_mesh(),
                                 {"rows": rows[:, None]})["rows"].numpy()
for name, mesh in (("roi", _maybe_epoch_mesh()), ("few", auto_fit_mesh(1)),
                   ("many", auto_fit_mesh(7))):
    out[name + "_names"] = np.array(mesh.mesh_dim_names)
    out[name + "_shape"] = np.array(mesh.shape)
refusals = []
for build in (lambda: epoch_mesh(3), lambda: batch_epoch_mesh(2, 2),
              lambda: epoch_mesh(devices=[0, 0])):
    try:
        build()
    except ValueError as e:
        refusals.append(str(e))
out["refusals"] = np.array(refusals)
sc = make_roi_scene(n_epochs=2, n_pix=8, s=2, n_sources=1, seed=1)
# each fit refuses a mesh of the wrong axes before any collective
wrong = []
stars = (sc["data"][None], np.sqrt(sc["sigma_2"])[None], sc["psf"][None], 2)
for fit in (
        lambda: fit_roi(sc["data"], np.sqrt(sc["sigma_2"]), sc["psf"],
                        sc["xs"] + 3.5, sc["ys"] + 3.5, 2, sc["fwhm"], 1.0,
                        [0.0, 0.0], ROI_CONFIG, device="cpu",
                        mesh=auto_batch_mesh()),
        lambda: build_psf_batched(*stars[:2], 2, device="cpu",
                                  mesh=epoch_mesh()),
        lambda: fit_stars_batched(*stars, device="cpu", mesh=epoch_mesh())):
    try:
        fit()
    except ValueError as e:
        wrong.append(str(e))
out["wrong_axes"] = np.array(wrong)
_, kw, up, down, fixed = setup_model(sc["data"], sc["sigma_2"], sc["psf"],
                                     sc["xs"], sc["ys"], 2, device="cpu")
params = Params(kw, fixed, up, down)
merged = params.merge(params.free0)
out["layout"] = np.array(["/".join(path) for path, _ in
                          flatten({k: v for k, v in merged.items()
                                   if k != "kwargs_sersic"})[1]])
np.savez(Path(sys.argv[1]) / f"rank{rank}.npz", **out)
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    path = tmp_path_factory.mktemp("distributed")
    check_ranks(run_ranks(WORKER, (path,)))
    return [dict(np.load(path / f"rank{r}.npz")) for r in (0, 1)]


@pytest.fixture
def recorder(monkeypatch):
    """``init_process_group`` replaced by a recorder of its arguments."""
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kwargs: calls.append(kwargs))
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    return calls


def test_initialize_distributed_env_parsing(monkeypatch, recorder):
    """Explicit arguments (a falsy process_id=0 included) beat torchrun's
    variables; without arguments the variables are read."""
    monkeypatch.setenv("MASTER_ADDR", "envhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "7")
    monkeypatch.setenv("RANK", "3")
    tdist.initialize_distributed(coordinator_address="localhost:9",
                                 num_processes=2, process_id=0)
    tdist.initialize_distributed()
    want = [("tcp://localhost:9", 2, 0), ("tcp://envhost:1", 7, 3)]
    assert [(c["init_method"], c["world_size"], c["rank"])
            for c in recorder] == want
    # no card here: the ranks talk over gloo
    assert {c["backend"] for c in recorder} == {"gloo"}


def test_initialize_distributed_rejects_partial_explicit_args(recorder):
    """An explicit topology without a coordinator must raise, not be
    dropped."""
    with pytest.raises(ValueError, match="coordinator"):
        tdist.initialize_distributed(num_processes=2, process_id=1)
    with pytest.raises(ValueError, match="coordinator"):
        tdist.initialize_distributed()
    assert recorder == []


def test_initialize_distributed_rejects_partial_env_topology(monkeypatch,
                                                             recorder):
    """``WORLD_SIZE``/``RANK`` without ``MASTER_ADDR``/``MASTER_PORT`` is
    as wrong as explicit arguments without a coordinator."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(ValueError, match="coordinator"):
        tdist.initialize_distributed()
    assert recorder == []


def test_backend_rule():
    """NCCL only with a card for every local rank; gloo here."""
    assert tdist.backend_for(1) == "gloo"


def test_two_ranks_bootstrap_from_torchrun_variables(ranks):
    for rank, res in enumerate(ranks):
        assert int(res["world"]) == 2 and int(res["rank"]) == rank
        assert str(res["backend"]) == "gloo"


def test_gather_to_host_in_rank_order(ranks):
    for res in ranks:
        np.testing.assert_array_equal(res["gathered"][:, 0],
                                      [0, 1, 2, 10, 11, 12])


def test_auto_meshes_at_world_two(ranks):
    """The ROI task's epoch mesh, and the star fit's: 1 star on 2 ranks is
    a (1, 2) mesh, 7 stars a 1-D batch mesh."""
    res = ranks[0]
    assert res["roi_names"].tolist() == ["epoch"]
    assert res["roi_shape"].tolist() == [2]
    assert res["few_names"].tolist() == ["batch", "epoch"]
    assert res["few_shape"].tolist() == [1, 2]
    assert res["many_names"].tolist() == ["batch"]
    assert res["many_shape"].tolist() == [2]


def test_meshes_that_miss_the_world_are_refused(ranks):
    """A mesh is never dropped for fewer ranks: one of 3 ranks or of
    (2, 2) at world 2, or with a repeated rank, is a ValueError."""
    refusals = ranks[0]["refusals"].tolist()
    assert len(refusals) == 3, refusals
    assert "the world has 2" in refusals[0]
    assert "the world has 2" in refusals[1]
    assert "not the world's ranks" in refusals[2]


def test_fits_refuse_a_mesh_of_other_axes(ranks):
    """``fit_roi`` takes an epoch mesh, ``build_psf_batched`` a batch mesh,
    ``fit_stars_batched`` a batch or (batch, epoch) mesh; any other is a
    ValueError, never a fit on one device."""
    wrong = ranks[0]["wrong_axes"].tolist()
    assert len(wrong) == 3, wrong
    assert "fit_roi shards epochs" in wrong[0]
    assert "build_psf_batched shards frames" in wrong[1]
    assert "fit_stars_batched takes" in wrong[2]


def test_ranks_flatten_the_same_parameter_layout(ranks):
    """The merged parameter tree flattens in one order on every rank,
    though each rank hashes strings differently, so the one flat
    all-reduce adds like to like."""
    layout = ranks[0]["layout"].tolist()
    assert layout == ranks[1]["layout"].tolist()
    assert layout == sorted(layout)
