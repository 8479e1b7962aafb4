"""Start a small world of torch ranks on this host's CPU, for the port's
parallel tests (``tests/test_torch_parallel*.py``,
``tests/test_torch_distributed.py``).

Each rank runs ``python -c <code> <args>`` from the repository root with
torchrun's variables set (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), no card
and one intra-op torch thread, so the ranks talk over gloo and do not
fight the suite's other workers for the cores; each rank has its own
string-hash seed. The code imports the
port only. Every rank is killed when the job outlives its timeout, so a
hang fails the test instead of using up the suite's clock.
"""

import os
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 180
PRELUDE = "import torch\ntorch.set_num_threads(1)\n"


def free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_ranks(code, args=(), n_ranks=2, timeout=TIMEOUT_S):
    """Run ``code`` on ``n_ranks`` ranks; returns each rank's (return
    code, output). Raises ``subprocess.TimeoutExpired`` (after killing
    every rank) when the job takes longer than ``timeout`` seconds."""
    port = free_port()
    env = dict(os.environ)
    env.update(PYTHONPATH=str(REPO) + os.pathsep + env.get("PYTHONPATH", ""),
               MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(n_ranks), LOCAL_WORLD_SIZE=str(n_ranks),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = []
    for rank in range(n_ranks):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", PRELUDE + code, *map(str, args)],
            # each rank hashes strings with its own seed, as separate
            # processes do, so no rank can lean on another's set order
            env={**env, "RANK": str(rank), "LOCAL_RANK": str(rank),
                 "PYTHONHASHSEED": str(rank + 1)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(REPO)))
    deadline = time.monotonic() + timeout
    outputs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(
                timeout=max(deadline - time.monotonic(), 1))
            outputs.append(out)
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
            proc.communicate()
        raise
    return [(proc.returncode, out) for proc, out in zip(procs, outputs)]


def start_jobs(*jobs):
    """Run the jobs ``(code, args)`` one after another on a thread, so the
    caller computes its references meanwhile; returns the future of their
    :func:`run_ranks` results, in order."""
    pool = ThreadPoolExecutor(1)
    future = pool.submit(lambda: [run_ranks(code, args)
                                  for code, args in jobs])
    pool.shutdown(wait=False)
    return future


def check_ranks(results):
    """Assert every rank exited 0, showing the failing rank's output."""
    for rank, (code, out) in enumerate(results):
        assert code == 0, f"rank {rank} exited {code}:\n{out[-4000:]}"
