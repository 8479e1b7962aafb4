"""Device meshes over torch ranks for the epoch-sharded joint solves.

Twin of ``lightcurver_tpu/parallel/mesh.py``. A JAX device is one torch
rank here (one process, one card or the CPU), and a JAX ``Mesh`` is a
``torch.distributed.device_mesh.DeviceMesh`` whose axes carry JAX's names;
the collectives of an axis run on ``mesh.get_group(name)``. The epoch axis
of the joint multi-epoch fits becomes a mesh axis; the shared parameters
(background ``h``, source positions ``c_x/c_y``) and, in this port, the
per-epoch ones too, are replicated on every rank of it
(``parallel/deconv.py``).

A mesh spans the whole world: one that cannot be built over the ranks
there are raises a ``ValueError``, so a mesh that was asked for is never
dropped for one device.
"""

import torch
import torch.distributed as dist

EPOCH_AXIS = "epoch"


def world_size():
    """Ranks in the default process group: 1 when none is initialized."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size()


def mesh_device_type():
    """``"cuda"`` when the ranks talk over NCCL, else ``"cpu"`` (gloo, on
    host tensors or, with several ranks on one card, on CUDA tensors)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape, axis_names, devices=None):
    """A ``DeviceMesh`` of ``shape`` over every rank of the world.

    Args:
        shape: the mesh extents, whose product must be the world size.
        axis_names: one name per axis (``"epoch"``, ``"batch"``).
        devices: the global ranks in mesh order (default: 0, 1, ...).

    Raises:
        ValueError: no process group is initialized, or the mesh does not
            cover the world exactly.
    """
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("a mesh needs torch.distributed: call "
                         "parallel.distributed.initialize_distributed (or "
                         "start under torchrun) first")
    shape = tuple(int(n) for n in shape)
    n = 1
    for extent in shape:
        n *= extent
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of shape {shape} needs {n} ranks; the "
                         f"world has {dist.get_world_size()}")
    ranks = list(range(n)) if devices is None else [int(r) for r in devices]
    if sorted(ranks) != list(range(n)):
        raise ValueError(f"devices {ranks} are not the world's ranks "
                         f"0..{n - 1}")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(mesh_device_type(),
                      torch.tensor(ranks, dtype=torch.int64).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def mesh_1d(axis_name, n_devices=None, devices=None):
    """1-D mesh constructor shared by the epoch and batch meshes.

    Args:
        axis_name: the single mesh-axis name.
        n_devices: the number of ranks (default: the world size; any other
            count raises a ``ValueError``).
        devices: explicit global ranks (overrides n_devices).
    """
    if devices is None:
        n = world_size() if n_devices is None else int(n_devices)
        devices = range(n)
    devices = list(devices)
    return make_mesh((len(devices),), (axis_name,), devices)


def epoch_mesh(n_devices=None, devices=None):
    """1-D mesh over the epoch axis (see :func:`mesh_1d`).

    Returns:
        ``DeviceMesh`` with a single axis named ``"epoch"``.
    """
    return mesh_1d(EPOCH_AXIS, n_devices, devices)


def resolve_mesh(mesh, auto):
    """The mesh an entry point runs on: ``auto()`` for ``"auto"``, None
    for None (the unsharded fit), a ``DeviceMesh`` as it is; anything
    else is refused with a ``ValueError``."""
    if isinstance(mesh, str) and mesh == "auto":
        return auto()
    if mesh is None:
        return None
    # imported here: the unsharded path never pays for the import
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(mesh, DeviceMesh):
        return mesh
    raise ValueError(f"mesh={mesh!r}: 'auto', None or a DeviceMesh "
                     "expected")


def axis_size(mesh, name):
    """Extent of axis ``name`` of ``mesh``; 1 when the mesh lacks it."""
    names = mesh.mesh_dim_names or ()
    return mesh.shape[names.index(name)] if name in names else 1


def axis_rank(mesh, name):
    """This rank's index along axis ``name``; 0 when the mesh lacks it."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(name) if name in names else 0
