"""Process meshes for training across worker processes.

Twin of :mod:`repro.launch.mesh` over ``torch.distributed``. The reference
lays its USEC workers on the ``"data"`` axis of a device mesh and runs them
as one SPMD program; here each rank of an initialized process group is one
process, and the mesh's one dim ``"data"`` spans all of them. A rank owns a
contiguous run of the workers (:func:`workers_of`): one worker a rank when
there are as many ranks as workers, several when there are fewer.

Model shards (the reference's ``"model"`` axis) are ROADMAP.md Queue 1 item
13c and raise. :func:`make_production_mesh` keeps the reference's production
shapes as plain data for the dry-run (item 13d); it builds no process group.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

DATA_AXIS = "data"


class MeshSpec(NamedTuple):
    """A mesh's shape and axis names, without devices."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]


def make_production_mesh(multi_pod: bool = False) -> MeshSpec:
    """(16, 16) data x model single pod; (2, 16, 16) pod x data x model for
    the reference's 512-chip two-pod dry-run."""
    if multi_pod:
        return MeshSpec((2, 16, 16), ("pod", DATA_AXIS, "model"))
    return MeshSpec((16, 16), (DATA_AXIS, "model"))


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
    """A one-dim ``DeviceMesh`` named ``"data"`` over every rank of the
    initialized default process group, for ``n_workers`` USEC workers.

    ``device_type`` defaults to ``"cuda"`` under NCCL and ``"cpu"``
    otherwise; a CUDA rank sets its device before calling this. Raises when
    the ranks do not split the workers evenly, and for ``n_model > 1``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if n_model > 1:
        raise NotImplementedError(
            "model shards within a worker (n_model > 1) are ROADMAP.md "
            "Queue 1 item 13c, not ported to repro_torch yet")
    if not dist.is_initialized():
        raise RuntimeError("make_worker_mesh needs an initialized default "
                           "process group")
    world = dist.get_world_size()
    workers_of(0, world, n_workers)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world,),
                            mesh_dim_names=(DATA_AXIS,))
