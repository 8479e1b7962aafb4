"""A run of an ROI cell over several ranks through the launcher's real path,
for the rank tests: ``ranks.launch`` starts the ranks, and each runs
``run.run_ranked`` as ``benchmark/run.py`` does in a rank, past the look
for a card, on a cell built from ``workload`` (default ``roi100_matmul``)
with the spec's changes:

- ``ranks``: the number of ranks (the cell's ``chips``);
- ``device``: ``"cpu"`` (gloo) or ``"cuda"`` (NCCL, a card a rank);
- ``config``: keys of the cell's configuration to change;
- ``seconds``: each rank's window seconds (only rank 0's should count);
- ``units``: rank 0 closes the window after this many units, whatever
  its clock says;
- ``trace``: a traced run (``--trace 1``);
- ``fault``: a fault of ``benchmark/faults.py``, planted on every rank;
- ``die``: a rank that kills itself in the window's second fit;
- ``linger``: a rank that leaves the process group and never exits.

Each rank writes its process id to stderr (``pid <n>``)."""

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RANK = r'''
import contextlib, json, os, signal, sys, time
import torch
import torch.distributed as dist
from benchmark import faults, ranks, run
from benchmark.drivers import roi_fit

spec = json.loads(sys.argv[1])
rank = int(os.environ["RANK"])
print("pid", os.getpid(), file=sys.stderr, flush=True)
if spec["device"] == "cpu":
    torch.set_num_threads(1)
if rank == 0 and spec.get("units"):
    agree, calls = ranks.World.agree, []
    def counted(self, done):
        calls.append(1)
        return agree(self, len(calls) >= spec["units"])
    ranks.World.agree = counted
if rank == spec.get("die"):
    fit, calls = roi_fit.Driver.fit, []
    def dying(self, *args, **kwargs):
        # the first call is set-up's warm-up fit
        calls.append(1)
        if len(calls) == 3:
            os.kill(os.getpid(), signal.SIGKILL)
        return fit(self, *args, **kwargs)
    roi_fit.Driver.fit = dying
if rank == spec.get("linger"):
    destroy = dist.destroy_process_group
    def lingering(*args):
        destroy(*args)
        time.sleep(3600)
    dist.destroy_process_group = lingering
workload = spec.get("workload", "roi100_matmul")
cell = run.load_json("workloads", workload)
cell.update(chips=spec["ranks"])
config = run.load_json("configs", cell["config"])
config.update(spec.get("config", {}))
traffic = run.load_json("traffic", cell["traffic"])
with faults.FAULTS[spec["fault"]]() if spec.get("fault") \
        else contextlib.nullcontext():
    run.run_ranked(workload, spec.get("seed", 2**31 + 101),
                   spec["seconds"][rank], spec.get("trace", False),
                   device=spec["device"],
                   cell=cell, config=config, traffic=traffic)
'''

LAUNCH = r'''
import json, sys, time
t_start = time.time()
from benchmark import ranks
spec = json.loads(sys.argv[2])
code, out = ranks.launch(spec["ranks"], ["-c", sys.argv[1], sys.argv[2]],
                         t_start=t_start, teardown_s=spec["teardown_s"])
sys.stdout.write(out)
sys.exit(code)
'''


def launch(timeout, **spec):
    """Launch the ranks of ``spec``; (exit code, stdout, stderr,
    seconds)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    if spec["device"] == "cpu":
        env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-c", LAUNCH, RANK, json.dumps(spec)], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=timeout,
        check=False)
    return (proc.returncode, proc.stdout, proc.stderr,
            time.monotonic() - t0)


def pids(stderr):
    """The process ids that the ranks wrote, as the launcher relayed
    them."""
    return [int(m) for m in re.findall(r"^(?:\[rank \d+\] )?pid (\d+)$",
                                       stderr, re.MULTILINE)]


def gone(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def fits(stderr, rank):
    """The number of fits in rank ``rank``'s window, from its relayed
    ``fit seconds:`` line."""
    prefix = f"[rank {rank}] " if rank else ""
    lines = [line for line in stderr.splitlines()
             if line.startswith(prefix + "fit seconds: ")]
    assert len(lines) == 1, stderr[-3000:]
    return len(lines[0].split("fit seconds: ")[1].split())
