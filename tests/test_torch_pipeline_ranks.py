"""The port's pipeline under two ranks, as ``torchrun --nproc-per-node 2 -m
lightcurver_tpu_torch.scripts.run config.yaml`` starts it, from raw frames
to the ROI products.

The e2e scene of ``tests/test_e2e_pipeline.py`` (3 frames of 160 px, 8
stars, 2 blended ROI sources, that file's budgets and its checkpoints every
100 iterations) goes through the port's CLI three times, each on its own
copy of the empty workdir: as two gloo ranks on the CPU
(``tests/torch_ranks.py``: torchrun's variables), as one rank, and through
JAX's ``WorkflowManager()`` in this process, on every virtual device of
the suite's conftest, while the ranks run. Both port runs render on
"matmul", which the sharded fits force above one rank, as JAX forces
"mxu"; on the same render the world of one is the reference of the
sharding. The three fit tasks run on both ranks and shard their fits
(frames, stars, epochs); every other task runs on rank 0 alone, and rank
0 alone writes.

Against the world of one: the same task order, one session log, every
table's rows equal by key with none written twice, the same product files,
and the PSFs, star fluxes and ROI fluxes within the bars of the sharded
fits (1e-2 of a PSF's peak, 1 mmag, 1 % in chi2). Against JAX's run, the
bars of ``tests/test_torch_e2e_pipeline.py``. And a task that raises on
rank 0, a host task or the PSF task's preparation while rank 1 waits for
the bucket, ends both ranks nonzero within the ranks' timeout.
"""

import re
import sqlite3
from pathlib import Path

import numpy as np
import pytest

from test_e2e_pipeline import workdir  # noqa: F401  (the scene fixture)
from test_torch_e2e_pipeline import (ASTROMETRY_ARCSEC, ROI_RTOL, STAR_RTOL,
                                     _config, _copy, _product_files,
                                     _roi_products, _table, _table_keys)
from torch_ranks import run_ranks, start_jobs

PSF_PEAK_BAR, DMAG_BAR, CHI2_BAR = 1e-2, 1e-3, 0.01
CLI = ("import sys\n"
       "sys.argv = ['run', *sys.argv[1:]]\n"
       "from lightcurver_tpu_torch.scripts.run import run\n"
       "run()\n")
TASK_LINE = re.compile(r"Running task (\w+)\.")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread beside the suite's other workers."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _numpy_twins():
    """Both packages' host C++ off (the ranks inherit the variable), as in
    ``tests/test_torch_e2e_pipeline.py``, so the fronts compare their
    numpy twins."""
    import lightcurver_tpu.native as nat
    import lightcurver_tpu_torch.native as port_nat

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIGHTCURVER_DISABLE_NATIVE", "1")
        for module in (nat, port_nat):
            mp.setattr(module, "_lib", None)
            mp.setattr(module, "_tried", False)
        yield


def _cli_args(path, *extra):
    return (str(path / "config.yaml"), "--device", "cpu",
            "--irfft-backend", "matmul", *extra)


@pytest.fixture(scope="module")
def runs(workdir):  # noqa: F811
    """The port's CLI on two ranks and on one (a thread), and JAX's
    manager here meanwhile: {"two", "one", "jax": workdir}."""
    from lightcurver_tpu.pipeline.workflow_manager import \
        WorkflowManager as JaxWorkflowManager

    dirs = {name: _copy(workdir, workdir / f"port_{name}")
            for name in ("two", "one")}
    jax_dir = _copy(workdir, workdir / "jax_run")
    pending = start_jobs((CLI, _cli_args(dirs["two"])),)
    one = run_ranks(CLI, _cli_args(dirs["one"]), n_ranks=1)
    with _config(jax_dir):
        JaxWorkflowManager().run()
    (two,) = pending.result()
    for label, results in (("two ranks", two), ("one rank", one)):
        for rank, (code, out) in enumerate(results):
            assert code == 0, f"{label}, rank {rank} exited {code}:\n" \
                              f"{out[-4000:]}"
    return {**dirs, "jax": jax_dir, "outputs": two}


def _session_logs(path):
    return sorted((path / "logs").glob("*.log"))


def _tasks_run(path):
    (log,) = _session_logs(path)
    return TASK_LINE.findall(log.read_text())


def test_one_session_log_and_the_same_task_order(runs):
    assert len(_session_logs(runs["two"])) == 1
    assert _tasks_run(runs["two"]) == _tasks_run(runs["one"])
    assert len(_tasks_run(runs["two"])) == 12


def test_rank_one_ran_the_fit_tasks_only(runs):
    """Rank 1's own lines (its stderr) name only the three fit tasks."""
    _, rank1 = runs["outputs"][1]
    assert set(TASK_LINE.findall(rank1)) == {
        "psf_modeling", "star_photometry", "model_calibrated_cutouts"}
    assert "Epoch-sharding the joint fit over 2 devices" in rank1


def test_same_rows_by_key_and_none_twice(runs):
    got, want = _table_keys(runs["two"]), _table_keys(runs["one"])
    assert got.keys() == want.keys()
    for name, (keys, rows) in want.items():
        assert got[name] == (keys, rows), name
        with sqlite3.connect(runs["two"] / "database.sqlite3") as conn:
            (n_rows,) = conn.execute(
                f"SELECT COUNT(*) FROM {name}").fetchone()
        assert n_rows == len(rows), f"{name}: a row written twice"


def test_same_product_files(runs):
    assert _product_files(runs["two"]) == _product_files(runs["one"])


def _psfs(path):
    """{(frame path, psf ref): (full PSF, narrow PSF)} of the regions
    file."""
    import h5py

    out = {}
    with h5py.File(path / "regions.h5", "r") as f:
        def visit(name, obj):
            if name.endswith("/full_psf"):
                group = name[:-len("/full_psf")]
                out[group] = (obj[...], f[group + "/narrow_psf"][...])
        f.visititems(visit)
    return out


def test_psfs_within_the_sharding_bar(runs):
    got, want = _psfs(runs["two"]), _psfs(runs["one"])
    assert got.keys() == want.keys() and len(want) == 3
    for key, pair in want.items():
        for g, w in zip(got[key], pair):
            assert np.abs(g - w).max() <= PSF_PEAK_BAR * np.abs(w).max()
    order = "frame_id"
    got_chi2 = _table(runs["two"], "PSFs", order)["chi2"]
    want_chi2 = _table(runs["one"], "PSFs", order)["chi2"]
    np.testing.assert_allclose(got_chi2, want_chi2, rtol=CHI2_BAR)


def test_star_fluxes_within_the_sharding_bars(runs):
    order = "star_gaia_id, frame_id"
    got = _table(runs["two"], "star_flux_in_frame", order)
    want = _table(runs["one"], "star_flux_in_frame", order)
    dmag = np.abs(2.5 * np.log10(got["flux"] / want["flux"]))
    print(f"star fluxes, two ranks vs one: max |dmag| "
          f"{dmag.max() * 1e3:.4f} mmag")
    assert dmag.max() <= DMAG_BAR
    np.testing.assert_allclose(got["chi2"], want["chi2"], rtol=CHI2_BAR)


def test_roi_fluxes_within_the_sharding_bars(runs):
    got, _ = _roi_products(runs["two"])
    want, _ = _roi_products(runs["one"])
    assert got["frame_id"].tolist() == want["frame_id"].tolist()
    dmag = max(np.abs(2.5 * np.log10(got[f"{ps}_flux"]
                                     / want[f"{ps}_flux"])).max()
               for ps in ("A", "B"))
    print(f"ROI fluxes, two ranks vs one: max |dmag| {dmag * 1e3:.4f} mmag")
    assert dmag <= DMAG_BAR
    np.testing.assert_allclose(got["reduced_chi2"], want["reduced_chi2"],
                               rtol=CHI2_BAR)
    assert not list((runs["two"] / "checkpoints").glob("*.ckpt"))


def test_rows_and_files_as_jax_writes_them(runs):
    got, want = _table_keys(runs["two"]), _table_keys(runs["jax"])
    assert got == want
    assert _product_files(runs["two"]) == _product_files(runs["jax"])


def test_fluxes_within_the_e2e_bars_of_jax(runs):
    order = "star_gaia_id, frame_id"
    got = _table(runs["two"], "star_flux_in_frame", order)
    want = _table(runs["jax"], "star_flux_in_frame", order)
    np.testing.assert_allclose(got["flux"], want["flux"], rtol=STAR_RTOL)
    got, got_astrometry = _roi_products(runs["two"])
    want, want_astrometry = _roi_products(runs["jax"])
    for ps in ("A", "B"):
        np.testing.assert_allclose(got[f"{ps}_flux"], want[f"{ps}_flux"],
                                   rtol=ROI_RTOL)
        for g, w in zip(got_astrometry[ps], want_astrometry[ps]):
            assert abs(g - w) * 3600 < ASTROMETRY_ARCSEC


FAIL_ON_RANK_0 = (
    "import os\n"
    "if os.environ['RANK'] == '0':\n"
    "    from lightcurver_tpu_torch.pipeline import workflow_manager\n"
    "    from lightcurver_tpu_torch.processes import psf_modelling\n"
    "    def boom(*args, **kwargs):\n"
    "        raise RuntimeError('injected failure on rank 0')\n"
    "    setattr({module}, {name!r}, boom)\n")


@pytest.mark.parametrize("module,name,task", [
    # a host task, which rank 1 skips and waits after
    ("workflow_manager", "calculate_coefficient",
     "calculate_normalization_coefficient"),
    # the PSF task's preparation on rank 0, while rank 1 waits for the
    # first bucket
    ("psf_modelling", "_prepare_frame_job", "psf_modeling"),
])
def test_a_task_failing_on_rank_0_ends_both_ranks(runs, module, name, task):
    mine = _copy(runs["one"], runs["one"].parent / f"port_fail_{task}")
    code = FAIL_ON_RANK_0.format(module=module, name=name) + CLI
    results = run_ranks(code, _cli_args(mine, "--start", task, "--stop",
                                        task))
    (code0, out0), (code1, out1) = results
    assert code0 != 0 and "injected failure on rank 0" in out0
    assert code1 != 0 and "PeerTaskFailed" in out1
    assert "injected failure on rank 0" in out1
