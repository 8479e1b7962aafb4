"""A cell of several cards: one rank a card, as ``torchrun`` starts them.

The launcher (:func:`launch`, in the process the benchmark was started as)
starts N copies of a harness script, each with torchrun's variables
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR=localhost``, ``MASTER_PORT`` a free port) and
:data:`LAUNCHER`, which holds the launcher's process id and its start on
the host clock. Each copy is a rank (:func:`launched`): it joins the world
through :class:`World`, which calls the port's own
``parallel.distributed.initialize_distributed()`` as ``lc_run`` under
``torchrun`` does (NCCL with a card a rank, gloo where the cards are too
few, as on the CPU), and adds a gloo group of the harness's own:

- :meth:`World.agree`: rank 0's verdict that the window is over, sent to
  every rank after each unit, so that every rank stops after the same unit
  and no collective of the program is left waiting;
- :meth:`World.gather`: each rank's unit count and peak memory, for rank 0;
- :meth:`World.close`: the teardown. The program's state freed, the card
  synchronised, a barrier (the other ranks wait there while rank 0 judges,
  up to :data:`JUDGE_TIMEOUT`), then every rank leaves the process group
  together.

The launcher relays rank 0's output as its own and exits 0 only when every
rank exited 0. A rank that exits otherwise ends the run at once: the others
are killed and the rank is named. A rank still alive :data:`TEARDOWN_S`
after rank 0 began its teardown (or after any rank exited) is killed and
named, and the run exits non-zero: a hang never passes as a result.
"""

import ctypes
import faulthandler
import gc
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from datetime import timedelta

import torch
import torch.distributed as dist

# set in each rank's environment: {"pid": the launcher's, "t_start": its
# start on the host clock}
LAUNCHER = "BENCHMARK_LAUNCHER"
# what a rank writes to stderr as it begins its teardown; the launcher
# reads it and does not relay it
TEARDOWN = "benchmark.ranks: teardown of rank"
# the limit on a rank's life after rank 0 began its teardown
TEARDOWN_S = 120.0
# how long the other ranks may wait for rank 0's judgement (a 1000-epoch
# reference in float64 included)
JUDGE_TIMEOUT = timedelta(minutes=30)
# what the launcher shows of a failed rank's stderr
TAIL = 4000


def free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def launched():
    """Whether this process is a rank that :func:`launch` started."""
    return LAUNCHER in os.environ


def launcher_start():
    """The launcher's start on the host clock: a rank's set-up counts from
    there."""
    return json.loads(os.environ[LAUNCHER])["t_start"]


def _follow_launcher():
    """Have the kernel kill this rank when its launcher dies (Linux), so
    that no rank outlives a launcher that was killed."""
    PR_SET_PDEATHSIG = 1
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)
    except (OSError, AttributeError):
        return
    if os.getppid() != json.loads(os.environ[LAUNCHER])["pid"]:
        sys.exit("the launcher ended before this rank started")


class _Rank:
    """One rank's process and what it printed."""

    def __init__(self, rank, argv, env):
        self.rank = rank
        self.proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
        self.out, self.err = [], []
        self.teardown_at = None
        self.readers = [threading.Thread(target=self._read, args=args,
                                         daemon=True)
                        for args in ((self.proc.stdout, self.out, False),
                                     (self.proc.stderr, self.err, True))]
        for reader in self.readers:
            reader.start()

    def _read(self, stream, lines, stderr):
        for line in stream:
            if stderr and line.startswith(TEARDOWN):
                self.teardown_at = time.monotonic()
            else:
                lines.append(line)

    def finish(self):
        """Kill the rank if it still runs, and wait for it and for its
        output (a while: a child of the rank may hold its pipes)."""
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        for reader in self.readers:
            reader.join(timeout=10)

    def tail(self):
        return "".join(self.err)[-TAIL:]


def launch(n, argv, *, t_start, teardown_s=TEARDOWN_S):
    """Run ``python <argv>`` as ``n`` ranks and wait for all of them.

    Returns (exit code, rank 0's standard output). On 0, every rank's
    standard error has been relayed, rank 0's last, so its last lines are
    the run's; otherwise the failed or hung ranks are named on standard
    error with the end of theirs, and rank 0's output is not returned."""
    env = dict(os.environ)
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
               **{LAUNCHER: json.dumps({"pid": os.getpid(),
                                        "t_start": t_start})})
    ranks = [_Rank(r, [sys.executable, *argv],
                   {**env, "RANK": str(r), "LOCAL_RANK": str(r)})
             for r in range(n)]
    failed, hung, since = [], [], None
    try:
        while True:
            codes = [r.proc.poll() for r in ranks]
            failed = [(r, c) for r, c in zip(ranks, codes)
                      if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                ended = time.monotonic()
                break
            if since is None and (ranks[0].teardown_at is not None
                                  or 0 in codes):
                since = time.monotonic()
            if since is not None and time.monotonic() - since > teardown_s:
                hung = [r for r, c in zip(ranks, codes) if c is None]
                break
            time.sleep(0.1)
    finally:
        for r in ranks:
            r.finish()
    for r, code in failed:
        print(f"rank {r.rank} exited with code {code}; its stderr ends:\n"
              f"{r.tail()}", file=sys.stderr)
    for r in hung:
        print(f"rank {r.rank} was still running {teardown_s:g} s after "
              f"the teardown began, and was killed; its stderr ends:\n"
              f"{r.tail()}", file=sys.stderr)
    if failed or hung:
        names = ", ".join(f"rank {r.rank}" for r in
                          [r for r, _ in failed] + hung)
        print(f"the run failed: {names}; rank 0's output, not a result: "
              f"{''.join(ranks[0].out)[-TAIL:]}", file=sys.stderr)
        return 1, ""
    if ranks[0].teardown_at is not None:
        print(f"every rank exited {ended - ranks[0].teardown_at:.2f} s after "
              "rank 0 began its teardown", file=sys.stderr)
    for r in ranks[1:] + ranks[:1]:
        prefix = f"[rank {r.rank}] " if r.rank else ""
        sys.stderr.write("".join(prefix + line for line in r.err))
    sys.stderr.flush()
    return 0, "".join(ranks[0].out)


class World:
    """This rank's place among the ranks of a cell, and the harness's gloo
    group."""

    def __init__(self):
        from lightcurver_tpu_torch.parallel.distributed import \
            initialize_distributed

        _follow_launcher()
        initialize_distributed()
        self.rank, self.size = dist.get_rank(), dist.get_world_size()
        self.group = dist.new_group(backend="gloo", timeout=JUDGE_TIMEOUT)

    def agree(self, done):
        """Rank 0's ``done``, on every rank."""
        flag = torch.tensor([int(done)], dtype=torch.int32)
        dist.broadcast(flag, src=0, group=self.group)
        return bool(flag.item())

    def barrier(self):
        dist.barrier(group=self.group)

    def gather(self, obj):
        """Every rank's ``obj``, in rank order, on every rank."""
        objs = [None] * self.size
        dist.all_gather_object(objs, obj, group=self.group)
        return objs

    def close(self):
        """Leave the world: the program's state freed (its graphs hold the
        communicators), the card synchronised, and every rank leaving the
        process group together, once rank 0 has judged and reported."""
        print(f"{TEARDOWN} {self.rank}", file=sys.stderr, flush=True)
        gc.collect()
        if torch.cuda.is_available() and dist.get_backend() == "nccl":
            torch.cuda.synchronize()
        self.barrier()
        # where a rank that hangs from here on waits, for the launcher to
        # show before it kills the rank
        faulthandler.dump_traceback_later(TEARDOWN_S / 2)
        dist.destroy_process_group()
