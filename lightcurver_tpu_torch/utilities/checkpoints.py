"""Task-level recovery from stale mid-fit checkpoints.

Twin of ``lightcurver_tpu/utilities/checkpoints.py``. The optimizers
refuse to resume a checkpoint whose inputs, iteration budget or carry
changed, or that cannot be read (``core/optimize.CheckpointMismatch``).
That is right for a direct caller, but a pipeline task derives its inputs
anew on every run, so a changed input under the same checkpoint name is
legitimate there: the task discards the stale file and fits from scratch.
"""

from pathlib import Path

from ..core.optimize import CheckpointMismatch


def run_discarding_stale_checkpoint(fn, checkpoint_path, logger):
    """Call ``fn()``; on a :class:`CheckpointMismatch`, delete the
    checkpoint and call it once more. Any other error propagates, and so
    does the refusal when there is no checkpoint path. A sharded fit's
    ranks refuse together (the refusal carries their ``share``,
    ``parallel.batch.CheckpointShare``): global rank 0 alone deletes the
    file, between two barriers."""
    try:
        return fn()
    except CheckpointMismatch as e:
        if checkpoint_path is None:
            raise
        logger.warning(
            f"Stale mid-fit checkpoint discarded, restarting fit: {e}")
        share = e.share
        if share is not None:
            share.barrier()
        if share is None or share.is_writer:
            Path(checkpoint_path).unlink(missing_ok=True)
        if share is not None:
            share.barrier()
        return fn()
