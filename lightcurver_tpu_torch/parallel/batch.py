"""Batch-axis sharding for the embarrassingly-parallel batched fits.

Twin of ``lightcurver_tpu/parallel/batch.py``. The two non-ROI hot tasks,
the batched narrow-PSF fit (frame axis, ``core/psf/batched.py``) and the
batched joint star photometry (star axis, ``core/deconv/batched.py``),
fit independent problems: no term of any fit couples two batch entries.
On a 1-D ``batch`` mesh each rank fits its share of the frames or stars
alone, with no collective until :func:`gather_to_host` all-gathers the
results, so scaling is linear in ranks up to the bucket size.

With fewer stars than ranks, a 2-D (``batch``, ``epoch``) mesh also
shards each star's epochs: inside an epoch group each rank computes the
chi2 of its epochs of its stars, rank 0 of the group adds each star's
starlet term once, and the per-star loss vector and the gradient are
all-reduced over the group (the ROI mechanism of ``parallel/deconv.py``,
per star).

Non-divisible batch counts are padded by REPEATING the last real entry
(a duplicate fit is numerically identical work and keeps every dummy
input as well-conditioned as a real one); padded results are stripped
before returning, so callers see exactly the real batch.
"""

import numpy as np
import torch
import torch.distributed as dist

from .mesh import (EPOCH_AXIS, axis_rank, axis_size, make_mesh, mesh_1d,
                   world_size)

BATCH_AXIS = "batch"


def batch_mesh(n_devices=None, devices=None):
    """1-D mesh over the ``batch`` axis (frames or stars).

    Args:
        n_devices: the number of ranks (default: the world size; any
            other count raises a ``ValueError``).
        devices: explicit global ranks (overrides n_devices).
    """
    return mesh_1d(BATCH_AXIS, n_devices, devices)


def auto_batch_mesh():
    """The production mesh: every rank, or None in a world of one.

    The batched-fit entry points treat None as "no sharding": one
    process runs the plain batched fit, several shard the batch axis,
    with no configuration needed from the pipeline tasks.
    """
    if world_size() <= 1:
        return None
    return batch_mesh()


def batch_epoch_mesh(n_batch, n_epoch=None, devices=None):
    """2-D mesh over (``batch``, ``epoch``): stars x epochs.

    For the monitoring configuration (a handful of stars x hundreds of
    epochs) a pure batch mesh idles ``n_ranks - n_stars`` ranks; the 2-D
    mesh also shards each star's epoch axis. ``n_epoch`` defaults to the
    world size over ``n_batch``; the mesh must cover the world.
    """
    n_batch = int(n_batch)
    if n_epoch is None:
        n_epoch = world_size() // n_batch
    return make_mesh((n_batch, int(n_epoch)), (BATCH_AXIS, EPOCH_AXIS),
                     devices)


def fit_mesh_shape(n_items, n_devices):
    """The production mesh's shape for a batched fit of ``n_items``
    independent problems with an inner epoch axis on ``n_devices`` ranks:

    - one rank: None (the plain batched fit);
    - ``n_items >= n_devices``: ``(n_devices,)``, a 1-D batch mesh
      (collective-free);
    - ``n_items < n_devices``: ``(n_batch, n_devices // n_batch)``, a
      (batch, epoch) mesh whose batch extent is the largest divisor of
      the rank count that ``n_items`` can fill: the spare ranks shard
      the epoch axis instead of idling.
    """
    n_devices, n_items = int(n_devices), int(n_items)
    if n_devices <= 1:
        return None
    if n_items >= n_devices:
        return (n_devices,)
    n_batch = max(d for d in range(1, n_devices + 1)
                  if n_devices % d == 0 and d <= n_items)
    return (n_batch, n_devices // n_batch)


def auto_fit_mesh(n_items):
    """Production mesh for a batched fit of ``n_items`` problems, of the
    shape :func:`fit_mesh_shape` gives for the world; None in a world of
    one."""
    shape = fit_mesh_shape(n_items, world_size())
    if shape is None:
        return None
    if len(shape) == 1:
        return batch_mesh()
    return batch_epoch_mesh(*shape)


def pad_epoch_axis(data, noisemap, psf, n_shards):
    """Pad axis 1 (epochs) to a multiple of ``n_shards``.

    Uses the dummy-epoch convention of fit_stars_batched: data 0, noise
    1e7 (detected and zero-weighted by the loss), PSF a repeat of the last
    real epoch (well-conditioned spectra). Returns ``(data, noisemap,
    psf, n_pad)``.
    """
    n = data.shape[1]
    n_pad = (-n) % int(n_shards)
    if n_pad == 0:
        return data, noisemap, psf, 0
    widths = ((0, 0), (0, n_pad)) + ((0, 0),) * (data.ndim - 2)
    data = np.pad(np.asarray(data), widths)
    noisemap = np.pad(np.asarray(noisemap), widths, constant_values=1e7)
    psf = np.concatenate(
        [np.asarray(psf),
         np.repeat(np.asarray(psf)[:, -1:], n_pad, axis=1)], axis=1)
    return data, noisemap, psf, n_pad


def _repeat_last(a, n_pad):
    a = np.asarray(a)
    if n_pad:
        a = np.concatenate([a, np.repeat(a[-1:], n_pad, axis=0)])
    return a


def _local_rows(a, mesh):
    """This rank's share of the leading axis, along ``batch``."""
    per = a.shape[0] // axis_size(mesh, BATCH_AXIS)
    start = axis_rank(mesh, BATCH_AXIS) * per
    return a[start:start + per]


def shard_star_fit_arrays(mesh, data, noisemap, psf, *extra):
    """Pad the star-fit inputs and take this rank's stars.

    Stars (axis 0) are padded to a multiple of the ``batch`` extent by
    repeating the last star, and this rank keeps its share of them with
    all their epochs (pad those first, :func:`pad_epoch_axis`): on a
    (``batch``, ``epoch``) mesh the fit cuts each star's epochs to the
    rank's own in its loss. ``extra`` arrays with a leading star axis
    (the noise draws) are padded and cut alike.

    Returns ``((data, noisemap, psf, *extra), n_star_pad)``.
    """
    n = int(np.shape(data)[0])
    n_star_pad = (-n) % axis_size(mesh, BATCH_AXIS)
    return tuple(_local_rows(_repeat_last(a, n_star_pad), mesh)
                 for a in (data, noisemap, psf) + extra), n_star_pad


def strip_epoch_axis(out, n_pad):
    """Drop padded epochs from the epoch-axis leaves of a star-fit result
    dict (the key set owned by core/deconv/batched next to the
    result-dict constructor: ``EPOCH_AXIS_RESULT_KEYS``)."""
    if n_pad == 0:
        return out
    from ..core.deconv.batched import EPOCH_AXIS_RESULT_KEYS

    return {k: (v[:, :-n_pad] if k in EPOCH_AXIS_RESULT_KEYS else v)
            for k, v in out.items()}


def pad_batch_arrays(mesh, *arrays):
    """Pad leading axes to a multiple of the mesh size; keep this rank's.

    Every array is padded by repeating its LAST entry (well-conditioned
    duplicate work, exactly stripped by :func:`strip_batch`), and this
    rank keeps its share of the leading axis along ``batch``.

    Returns ``(local_arrays, n_pad)``.
    """
    n = int(np.shape(arrays[0])[0])
    for arr in arrays:
        if np.shape(arr)[0] != n:
            raise ValueError(
                f"inconsistent leading batch axes: {np.shape(arr)[0]} vs {n}")
    n_pad = (-n) % axis_size(mesh, BATCH_AXIS)
    return tuple(_local_rows(_repeat_last(a, n_pad), mesh)
                 for a in arrays), n_pad


def strip_batch(tree, n_pad):
    """Drop the padded batch entries from every leaf of a result tree."""
    if n_pad == 0:
        return tree
    if isinstance(tree, dict):
        return {k: strip_batch(v, n_pad) for k, v in tree.items()}
    return tree[:-n_pad]


def _gather_rows(x, group):
    """All-gather ``x`` over ``group``, concatenated along axis 0 in rank
    order, on the host. Gloo gathers host tensors; NCCL gathers device
    tensors, which are then copied to the host."""
    if dist.get_backend(group) != "nccl":
        x = x.cpu()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts).cpu()


def gather_to_host(mesh, tree):
    """All-gather a batch-sharded result tree, in rank order, to the host
    of every rank.

    Each rank holds the results of its share of the batch; every rank
    gathers them all before returning, so the caller sees the whole
    batch on every rank (with the padding still in: :func:`strip_batch`).
    A mesh without a ``batch`` extent above one has nothing to gather:
    the tree is returned unchanged.
    """
    if mesh is None or axis_size(mesh, BATCH_AXIS) <= 1:
        return tree
    group = mesh.get_group(BATCH_AXIS)

    def gather(node):
        if isinstance(node, dict):
            return {k: gather(v) for k, v in node.items()}
        return _gather_rows(node, group)

    return gather(tree)


class CheckpointShare:
    """How the ranks of a mesh share one checkpoint file
    (``core.optimize.run_segments``): the carry is gathered along
    ``batch`` (:meth:`full`); global rank 0 (:attr:`is_writer`) alone
    writes it, reads it and decides whether to resume, and
    :meth:`broadcast` hands its decision and its carry to the other ranks,
    which keep their share (:meth:`local`). So the ranks never split
    between resuming and starting afresh, and the file need not be on a
    disk they share. A barrier after each write keeps one rank's resume
    or deletion from racing another's write. Along ``epoch`` the carry is
    replicated."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.is_writer = dist.get_rank() == 0

    def full(self, x):
        """The whole batch's ``x`` (leading axis the batch share)."""
        if axis_size(self.mesh, BATCH_AXIS) <= 1:
            return x
        return _gather_rows(x, self.mesh.get_group(BATCH_AXIS))

    def local(self, x):
        """This rank's share of the whole batch's ``x``."""
        if axis_size(self.mesh, BATCH_AXIS) <= 1:
            return x
        return _local_rows(x, self.mesh)

    def broadcast(self, x):
        """Global rank 0's ``x`` on every rank, a new tensor where ``x``
        lies: through the card under NCCL, the host under gloo."""
        where = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend() == "nccl" else torch.device("cpu")
        y = x.detach().to(where, copy=True)
        dist.broadcast(y, src=0)
        return y.to(x.device)

    def barrier(self):
        dist.barrier()
