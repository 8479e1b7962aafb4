"""Sharded fits on ``torch.distributed``: twin of ``lightcurver_tpu/parallel``.

The mapping from the JAX package:

- **A JAX device is one torch rank owning one GPU.** Ranks start under
  ``torchrun --nproc-per-node N`` or through
  :func:`.distributed.initialize_distributed`. The rank's device is
  ``cuda:LOCAL_RANK`` (NCCL); with ``device="cpu"`` it is the CPU (gloo),
  and ranks that share one card talk over gloo on CUDA tensors.
- **A JAX ``Mesh`` is a ``torch.distributed.device_mesh.DeviceMesh``** with
  JAX's axis names: ``("epoch",)``, ``("batch",)`` or
  ``("batch", "epoch")``. The collectives of an axis run on
  ``mesh.get_group(name)``.
- **``mesh="auto"`` resolves to None** (the unsharded path, unchanged) when
  ``torch.distributed`` is not initialized or the world has one rank;
  otherwise to the mesh JAX's ``auto_*`` helper would pick for that rank
  count.
- **An explicit mesh is never dropped.** If it cannot be built (say
  ``n_devices`` differs from the world size), the call raises a
  ``ValueError``; it never falls back to one device.

The three fits: the ROI fit over epochs (:mod:`.deconv`, wired into
``processes/roi_modelling.fit_roi``), the PSF fit over frames and the
star fit over stars or over (stars, epochs) (:mod:`.batch`, wired into
``core/psf/batched.build_psf_batched`` and
``core/deconv/batched.fit_stars_batched``). Parameters and optimizer
state are replicated along ``epoch``; only the constants are sharded
(:mod:`.deconv` says why).
"""

from .mesh import epoch_mesh
from .deconv import shard_consts, shard_pytree, sharded_deconv_step, \
    fit_deconv_sharded, pad_epoch_stacks

__all__ = [
    "epoch_mesh",
    "shard_consts",
    "shard_pytree",
    "sharded_deconv_step",
    "fit_deconv_sharded",
    "pad_epoch_stacks",
]
