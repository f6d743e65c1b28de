"""Mesh, placement and halo-exchange scale-out layer on
``torch.distributed`` (port of ``pcmi_tpu/parallel``)."""

from pcmi_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    TILE_AXIS,
    make_mesh,
    pair_sharding,
    replicated,
)
from pcmi_tpu_torch.parallel.fusion_sharded import sharded_dsm_update
from pcmi_tpu_torch.parallel.halo import halo_exchange_rows, sharded_rows_map
from pcmi_tpu_torch.parallel.multihost import (
    DCN_AXIS,
    initialize as initialize_multihost,
    make_multihost_mesh,
)
from pcmi_tpu_torch.parallel.stereo_sharded import (
    batched_pair_step,
    default_halo,
    sharded_disparity,
)

__all__ = [
    "DATA_AXIS",
    "TILE_AXIS",
    "DCN_AXIS",
    "initialize_multihost",
    "make_multihost_mesh",
    "make_mesh",
    "pair_sharding",
    "replicated",
    "sharded_dsm_update",
    "halo_exchange_rows",
    "sharded_rows_map",
    "batched_pair_step",
    "default_halo",
    "sharded_disparity",
]
