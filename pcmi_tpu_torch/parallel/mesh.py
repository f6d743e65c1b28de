"""Device meshes for the scale-out layer (port of
``pcmi_tpu/parallel/mesh.py``).

A mesh has two axes: ``data`` (stereo pairs, acquisition dates: shards
that never talk) and ``tile`` (row bands of one rectified canvas, coupled
through the halo exchange of :mod:`pcmi_tpu_torch.parallel.halo`).

The reference is one process over many devices (``shard_map`` and GSPMD
over a ``jax.sharding.Mesh``); PyTorch runs one process per device. So a
mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the default process group, and every function of the layer takes
and returns the calling rank's local block. :func:`place` and
:func:`gather` are the counterparts of ``jax.device_put`` with a
``NamedSharding`` and of reading the global array back.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

DATA_AXIS = "data"
TILE_AXIS = "tile"


def backend_for(device_type: str) -> str:
    """The collective backend of a device type: NCCL on CUDA, gloo on the
    CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def ensure_process_group(device_type: str = "cuda") -> None:
    """A process that no launcher started gets a world of one rank (an
    in-process store), so a single device runs the layer unchanged."""
    if not dist.is_initialized():
        dist.init_process_group(backend_for(device_type),
                                store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(data: int = 1, tile: Optional[int] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A (data, tile) mesh over the first ``data * tile`` ranks of the
    world; ``tile=None`` takes all the ranks left."""
    ensure_process_group(device_type)
    n_dev = dist.get_world_size()
    if tile is None:
        if n_dev % data:
            raise ValueError(f"{n_dev} devices not divisible by data={data}")
        tile = n_dev // data
    n = data * tile
    if n > n_dev:
        raise ValueError(f"mesh {data}x{tile} needs {n} devices, have {n_dev}")
    return DeviceMesh(device_type, torch.arange(n).reshape(data, tile),
                      mesh_dim_names=(DATA_AXIS, TILE_AXIS))


def pair_sharding(mesh: DeviceMesh) -> tuple:
    """Placements of a (B, H, W) stack: pairs over ``data``, rows over
    ``tile``."""
    return (Shard(0), Shard(1))


def replicated(mesh: DeviceMesh) -> tuple:
    return tuple(Replicate() for _ in range(mesh.ndim))


def place(x: torch.Tensor, mesh: DeviceMesh, placements: Sequence
          ) -> torch.Tensor:
    """The calling rank's block of the global ``x`` under ``placements``
    (one per mesh axis): each ``Shard(d)`` cuts axis ``d`` into equal
    parts, one per rank along that mesh axis. Raises ``ValueError`` where
    an axis does not divide."""
    out = x
    for dim, p in enumerate(placements):
        if isinstance(p, Shard):
            n, r = mesh.size(dim), mesh.get_local_rank(dim)
            if out.shape[p.dim] % n:
                raise ValueError(
                    f"axis {p.dim} of {tuple(out.shape)} does not divide "
                    f"over {n} ranks of mesh axis "
                    f"{mesh.mesh_dim_names[dim]!r}")
            out = out.chunk(n, p.dim)[r]
    return out.contiguous()


def gather(x: torch.Tensor, mesh: DeviceMesh, placements: Sequence
           ) -> torch.Tensor:
    """The global tensor from every rank's block (an all-gather along
    each sharded mesh axis, innermost first); every rank gets it."""
    out = x.contiguous()
    for dim in reversed(range(len(placements))):
        p = placements[dim]
        if isinstance(p, Shard) and mesh.size(dim) > 1:
            parts = [torch.empty_like(out) for _ in range(mesh.size(dim))]
            dist.all_gather(parts, out, group=mesh.get_group(dim))
            out = torch.cat(parts, dim=p.dim)
    return out


def shard_blocks(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The calling rank's blocks of a leading block axis split over every
    mesh axis flattened (rank-major). Raises ``ValueError`` unless the
    block count divides by the mesh's size."""
    n = mesh.mesh.numel()
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} blocks not divisible by the "
                         f"{n} devices of the mesh")
    coord = mesh.get_coordinate()
    flat = 0
    for dim, c in enumerate(coord):
        flat = flat * mesh.size(dim) + c
    return x.chunk(n, 0)[flat].contiguous()


def all_reduce_mesh(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """``x`` summed over every rank of ``mesh``, in place (one
    ``all_reduce`` per mesh axis)."""
    for dim in range(mesh.ndim):
        if mesh.size(dim) > 1:
            dist.all_reduce(x, group=mesh.get_group(dim))
    return x
