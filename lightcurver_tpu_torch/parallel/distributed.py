"""Process-group initialization for the sharded fits.

Twin of ``lightcurver_tpu/parallel/distributed.py``. Each rank is one
process: start N of them with ``torchrun --nproc-per-node N ...``, which
sets ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``, and call
:func:`initialize_distributed` once per process before building a mesh
(``parallel/mesh.py``). Without torchrun, pass the coordinator address,
the number of processes and this process's id explicitly.

A rank whose host has a CUDA card for each local rank uses the card
``cuda:LOCAL_RANK`` and NCCL. Otherwise the ranks talk over gloo: on the
CPU, or on CUDA tensors when several ranks share one card (NCCL refuses
two ranks on one device).

The pipeline under ``torchrun`` (``scripts/run.py``) runs each host task
on rank 0 alone and the three fit tasks on every rank. Three helpers carry
that rule: :func:`is_writer` (rank 0 alone writes rows and files),
:func:`broadcast_work` (rank 0's work, sent to every rank) and
:func:`finish_task` (every rank's outcome of a task, gathered so that every
rank raises when one failed). The last two talk over a gloo group of their
own with :data:`CONTROL_TIMEOUT`: a rank waits there while rank 0 runs the
host tasks, which may take far longer than a fit's collective may wait.
:func:`rank_buckets` applies the rule to a fit task's buckets.

:func:`capturable` decides whether a fit's optimizer loop under a mesh is
one replayed CUDA graph (NCCL, or no collective in the loop) or calls its
step eagerly (gloo).
"""

import logging
import os
import pickle
from datetime import timedelta

import torch
import torch.distributed as dist

from ..structure.exceptions import TaskWasNotSuccessful

# a rank that waits longer than this for a peer fails instead of hanging
TIMEOUT = timedelta(minutes=10)
# the wait for rank 0 across a host task (the plate solving of a survey)
CONTROL_TIMEOUT = timedelta(hours=24)

# (the default group it was made for, the control group)
_control = (None, None)


def _local_ranks(num_processes):
    """(local rank, ranks on this host): torchrun's variables, else the
    whole world on this host."""
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    return int(os.environ.get("LOCAL_RANK", 0)), local_world


def backend_for(local_world):
    """NCCL when each of the ``local_world`` ranks of this host has a card
    of its own, else gloo."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None):
    """``torch.distributed.init_process_group`` with environment detection.

    Args:
        coordinator_address: ``host:port`` of rank 0's store; default
            ``MASTER_ADDR:MASTER_PORT``.
        num_processes: the world size; default ``WORLD_SIZE``, else 1.
        process_id: this process's rank; default ``RANK``, else 0.

    An explicit argument beats the environment (a ``process_id`` of 0
    included). Safe to call when already initialized (no-op). On a host
    with a card per local rank, the rank's card is made the current
    device (``cuda:LOCAL_RANK``).

    Raises:
        ValueError: a world size or rank was given, as an argument or as
            ``WORLD_SIZE``/``RANK``, without a coordinator address (or
            ``MASTER_ADDR`` and ``MASTER_PORT``), or none of them was.
    """
    logger = logging.getLogger("lightcurver.distributed")
    if dist.is_initialized():
        logger.info("torch.distributed already initialized.")
        return
    env_address = None
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        env_address = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    has_coordinator = bool(coordinator_address or env_address)
    has_explicit_topology = (
        num_processes is not None or process_id is not None
        or bool(os.environ.get("WORLD_SIZE"))
        or bool(os.environ.get("RANK")))
    if not has_coordinator:
        # dropping an explicit topology, or inventing one, would give a
        # wrong (or hung) initialization with no hint
        raise ValueError(
            "num_processes/process_id (or WORLD_SIZE/RANK) need a "
            "coordinator_address (or MASTER_ADDR and MASTER_PORT); all "
            "three are needed for an explicit bootstrap"
            if has_explicit_topology else
            "initialize_distributed needs a coordinator_address (or "
            "MASTER_ADDR and MASTER_PORT): start under torchrun or pass "
            "the topology")
    address = coordinator_address or env_address
    # `or` would misroute an explicit process_id=0 (falsy) to the env
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", 0))
    local_rank, local_world = _local_ranks(world)
    backend = backend_for(local_world)
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend=backend, init_method=f"tcp://{address}",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    logger.info(f"torch.distributed initialized: rank {rank}/{world}, "
                f"backend {backend}.")


def capturable(group=None):
    """Whether an optimizer loop whose loss all-reduces over ``group``
    (None: a loop with no collective) may replay its step as a CUDA graph
    on the card (``core/optimize.py``): with no group, or over NCCL, whose
    collectives a graph captures with the rest of the step. Gloo
    all-reduces through the host, which a capture refuses, so its loops
    call their step eagerly. The one rule every fit under a mesh follows;
    on the CPU no loop is captured whatever it says."""
    return group is None or dist.get_backend(group) == "nccl"


def _world():
    return dist.get_world_size() if dist.is_initialized() else 1


def is_writer():
    """True on global rank 0, and in a world of one: the rank that runs the
    host tasks and writes the pipeline's rows, datasets and products."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _control_group():
    """The gloo group of :func:`broadcast_work` and :func:`finish_task`,
    made the first time a world of several ranks needs it (every rank
    reaches that call at the same point of the pipeline)."""
    global _control
    world_group, group = _control
    if world_group is not dist.group.WORLD:
        group = dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)
        _control = (dist.group.WORLD, group)
    return group


class PeerTaskFailed(TaskWasNotSuccessful):
    """Another rank failed the current task; raised on every rank that
    learns it, in :func:`broadcast_work` or :func:`finish_task`."""


# set on every rank once the current task's failure went through the
# control group, so that finish_task raises without a second exchange
_failure_exchanged = False


def _exchange(kind, payload):
    """Every rank's ``(kind, payload)``, gathered on every rank.

    Each control message is one all-gather of a small status, so a rank
    that failed and reports its status meets the others wherever they
    wait: one that expects rank 0's work receives the failure instead.
    Raises ``PeerTaskFailed`` on every rank when a message reports a
    failure or the ranks were not at the same step (then no rank exchanges
    again for this task).
    """
    global _failure_exchanged
    messages = [None] * dist.get_world_size()
    dist.all_gather_object(messages, (kind, payload),
                           group=_control_group())
    failed = {rank: text for rank, (k, text) in enumerate(messages)
              if k == "failed"}
    out_of_step = {k for k, _ in messages} - {kind, "failed"}
    if failed or out_of_step:
        _failure_exchanged = True
        if kind == "failed":
            return messages
        reason = "; ".join(f"rank {r}: {t}" for r, t in failed.items()) \
            or f"the ranks were at different steps: {sorted(out_of_step)}"
        raise PeerTaskFailed(f"the task failed elsewhere ({reason})")
    return messages


def broadcast_work(obj):
    """Rank 0's ``obj`` (a work list, a bucket of jobs), on every rank;
    ``obj`` itself in a world of one. The other ranks' ``obj`` is ignored.
    Raises ``PeerTaskFailed`` when a rank reports a failure instead.

    The ranks first exchange a status (rank 0's with the size of its
    pickled ``obj``), then rank 0's bytes are broadcast once, when every
    rank reported that it waits for them. ``obj`` is pickled before the
    exchange, so a failure to pickle it is reported like any other.
    """
    if _world() == 1:
        return obj
    data = pickle.dumps(obj) if dist.get_rank() == 0 else b""
    size = _exchange("work", len(data))[0][1]
    buffer = (torch.frombuffer(bytearray(data), dtype=torch.uint8)
              if dist.get_rank() == 0 else
              torch.empty(size, dtype=torch.uint8))
    dist.broadcast(buffer, src=0, group=_control_group())
    return pickle.loads(buffer.numpy())


def rank_buckets(buckets, prepare, store):
    """The pipeline's rank rule over a fit task's buckets: this rank's
    ``(buckets, prepare, store)``.

    Rank 0 (and a world of one) keeps its own. Every other rank gets as
    many placeholders as rank 0 has buckets (their number is broadcast),
    a ``prepare`` that does nothing, since rank 0's preparation of each
    bucket reaches it through ``broadcast_work``, and a ``store`` that
    does nothing, since rank 0 alone writes. So every rank fits the same
    buckets in the same order, and each fit's collectives meet.
    """
    n_buckets = broadcast_work(len(buckets) if is_writer() else None)
    if is_writer():
        return buckets, prepare, store
    return [None] * n_buckets, (lambda bucket: None), (lambda *args: None)


def finish_task(name, error=None):
    """The status collective every rank enters after each pipeline task.

    ``error``: the exception this rank's part of the task raised, or None.
    Every rank's outcome is gathered (unless a failure of this task was
    already exchanged, in :func:`broadcast_work`); a rank that failed
    raises its own exception again, and every other rank raises
    ``PeerTaskFailed`` with the failed ranks' errors, so that no rank goes
    on to the next task or is left waiting for a peer. In a world of one
    it raises ``error`` when there is one, and does nothing else.
    """
    global _failure_exchanged
    if _world() == 1 or _failure_exchanged:
        _failure_exchanged = False
        if error is not None:
            raise error
        return
    if error is None:
        try:
            _exchange("ok", None)
        finally:
            _failure_exchanged = False
        return
    _exchange("failed", f"{name}: {type(error).__name__}: {error}")
    _failure_exchanged = False
    raise error
