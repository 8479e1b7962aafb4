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
"""

import logging
import os
from datetime import timedelta

import torch
import torch.distributed as dist

# a rank that waits longer than this for a peer fails instead of hanging
TIMEOUT = timedelta(minutes=10)


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
