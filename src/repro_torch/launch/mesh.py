"""Process meshes for training across worker processes.

Twin of :mod:`repro.launch.mesh` over ``torch.distributed``. The reference
lays its USEC workers on the ``"data"`` axis of a device mesh and runs them
as one SPMD program; here each rank of an initialized process group is one
process. With one model shard a worker the mesh's one dim ``"data"`` spans
all of them; with M it is ``("data", "model")`` of D x M ranks, rank
``d * M + m`` (the reference's device order for ``make_mesh((D, M), ("data",
"model"))``): the M ranks of a data index hold one worker's model between
them, and the D ranks of a model index meet at the master combine. A data
index owns a contiguous run of the workers (:func:`workers_of`): one worker
when there are as many data indices as workers, several when there are
fewer. :func:`make_production_mesh` keeps the reference's production shapes
as plain data, and :func:`make_fake_mesh` lays one over a process group of
the ``"fake"`` backend for the dry-run (:mod:`repro_torch.launch.dryrun`),
the port's counterpart of the reference's forced host devices
(``repro.launch.hostdev``): torch has no device count to force, so a fake
group of 256 or 512 ranks stands in for the devices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

DATA_AXIS = "data"
MODEL_AXIS = "model"


class MeshSpec(NamedTuple):
    """A mesh's shape and axis names, without devices."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]


def make_production_mesh(multi_pod: bool = False) -> MeshSpec:
    """(16, 16) data x model single pod; (2, 16, 16) pod x data x model for
    the reference's 512-chip two-pod dry-run."""
    if multi_pod:
        return MeshSpec((2, 16, 16), ("pod", DATA_AXIS, MODEL_AXIS))
    return MeshSpec((16, 16), (DATA_AXIS, MODEL_AXIS))


def workers_of(rank: int, world: int, n_workers: int) -> range:
    """The workers rank ``rank`` of ``world`` runs: a contiguous run of
    ``n_workers // world``. Raises unless ``world`` divides ``n_workers``."""
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} of a world of {world}")
    if n_workers % world:
        raise ValueError(f"{n_workers} workers do not split evenly over "
                         f"{world} ranks")
    k = n_workers // world
    return range(rank * k, (rank + 1) * k)


def make_worker_mesh(n_workers: int, n_model: int = 1,
                     device_type: Optional[str] = None):
    """A ``DeviceMesh`` over every rank of the initialized default process
    group, for ``n_workers`` USEC workers of ``n_model`` model shards each:
    one dim ``"data"`` when ``n_model`` is 1, else ``("data", "model")`` of
    shape ``(world // n_model, n_model)``, rank ``d * n_model + m``.

    ``device_type`` defaults to ``"cuda"`` under NCCL and ``"cpu"``
    otherwise; a CUDA rank sets its device before calling this. Raises when
    ``n_model`` does not divide the world or the data indices do not split
    the workers evenly."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_worker_mesh needs an initialized default "
                           "process group")
    world = dist.get_world_size()
    if n_model < 1 or world % n_model:
        raise ValueError(f"{n_model} model shards do not divide a world of "
                         f"{world} ranks")
    workers_of(0, world // n_model, n_workers)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if n_model == 1:
        return init_device_mesh(device_type, (world,),
                                mesh_dim_names=(DATA_AXIS,))
    return init_device_mesh(device_type, (world // n_model, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def coordinates(mesh) -> Tuple[int, int]:
    """(data index, model index) of this rank in ``mesh``; the model index
    is 0 on a one-dim mesh."""
    names = mesh.mesh_dim_names
    m = mesh.get_local_rank(MODEL_AXIS) if MODEL_AXIS in names else 0
    return mesh.get_local_rank(DATA_AXIS), m


def data_group(mesh):
    """The ranks of this rank's model index: the master combine's group."""
    return mesh.get_group(DATA_AXIS)


def model_group(mesh):
    """The ranks holding this rank's worker's model, or None on a one-dim
    mesh."""
    if MODEL_AXIS not in mesh.mesh_dim_names:
        return None
    return mesh.get_group(MODEL_AXIS)


def make_fake_mesh(spec: MeshSpec, rank: int = 0):
    """A ``DeviceMesh("cuda", spec.shape)`` named ``spec.axis_names`` over a
    default process group of the ``"fake"`` backend of ``prod(spec.shape)``
    ranks, this process rank ``rank``: every collective returns at once and
    moves nothing, so one process traces rank ``rank``'s step of a mesh it
    does not have. A default group already in place is destroyed first
    (the caller owns this process's group; call
    ``torch.distributed.destroy_process_group()`` when done). This is the
    only place that uses the fake backend."""
    import math

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = math.prod(spec.shape)
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    return DeviceMesh("cuda", torch.arange(world).reshape(spec.shape),
                      mesh_dim_names=tuple(spec.axis_names))


def flat_group(mesh, axes: Tuple[str, ...]):
    """The process group over ``axes`` of ``mesh`` taken together (one dim
    as it is; ``("pod", "data")`` flattened into one group, the data axis
    of a two-pod mesh)."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[tuple(axes)]._flatten().get_group()