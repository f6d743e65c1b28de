"""Multi-host start and a DCN-aware mesh (port of
``pcmi_tpu/parallel/multihost.py``).

Three tiers: one device; one host's devices as a (data, tile) mesh
(:mod:`pcmi_tpu_torch.parallel.mesh`); several hosts, where the axes that
never communicate (pairs, dates, AOIs of a sweep) span the hosts and the
tile axis with its halo exchange stays inside each host's links.

:func:`initialize` starts ``torch.distributed`` (the counterpart of
``jax.distributed.initialize``), one process per device;
:func:`make_multihost_mesh` builds a (dcn, data, tile) mesh whose leading
axis runs over hosts. A host is ``LOCAL_WORLD_SIZE`` consecutive ranks,
as launchers number them (one host when the variable is not set).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from pcmi_tpu_torch.parallel.mesh import (
    DATA_AXIS, TILE_AXIS, backend_for, ensure_process_group)

DCN_AXIS = "dcn"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device_type: str = "cuda") -> bool:
    """Start the process group when the run is multi-process: with a
    ``coordinator_address`` (``host:port``, or a URL such as
    ``file:///path``), else with a launcher's ``MASTER_ADDR`` and
    ``WORLD_SIZE`` in the environment (``RANK`` too). NCCL on CUDA, gloo
    on the CPU. Without either it returns False and touches no
    distributed state."""
    env = os.environ
    launched = "MASTER_ADDR" in env and "WORLD_SIZE" in env
    if coordinator_address is None and not launched:
        return False
    if coordinator_address is None:
        url = "env://"
    elif "://" in coordinator_address:
        url = coordinator_address
    else:
        url = f"tcp://{coordinator_address}"
    world = num_processes if num_processes is not None else int(
        env["WORLD_SIZE"])
    rank = process_id if process_id is not None else int(env["RANK"])
    dist.init_process_group(backend_for(device_type), init_method=url,
                            world_size=world, rank=rank)
    return True


def make_multihost_mesh(data: int = 1, tile: Optional[int] = None,
                        device_type: str = "cuda") -> DeviceMesh:
    """A (dcn, data, tile) mesh: hosts on the leading axis, each host's
    ranks as (data, tile). A single process gets a unit dcn axis."""
    ensure_process_group(device_type)
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local:
        raise ValueError(f"{world} ranks are not whole hosts of {local}")
    if tile is None:
        if local % max(data, 1):
            raise ValueError(
                f"{local} local devices not divisible by data={data}")
        tile = local // max(data, 1)
    if data * tile != local:
        raise ValueError(f"data*tile={data * tile} != local devices {local}")
    return DeviceMesh(device_type,
                      torch.arange(world).reshape(world // local, data, tile),
                      mesh_dim_names=(DCN_AXIS, DATA_AXIS, TILE_AXIS))
