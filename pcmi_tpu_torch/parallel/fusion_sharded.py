"""Multi-device DSM fusion: point blocks over the mesh, grids summed
(port of ``pcmi_tpu/parallel/fusion_sharded.py``).

The streaming accumulator's running sums
(:class:`pcmi_tpu_torch.pipelines.streaming.StreamingDSM`) are additive:
each rank runs its own blocks (band tiles or pairs) through the
tile-local robust gate and ``dsm_update``, and one ``all_reduce`` of the
packed (weight, value, value squared) grids over the mesh merges them.
No scatter crosses a device; the collective moves 3 * ny * nx floats per
device whatever the point count. The result equals the sequential band
loop's up to the order of the float additions: the robust gate groups by
block in both.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from pcmi_tpu_torch.parallel.mesh import all_reduce_mesh


def sharded_dsm_update(mesh: DeviceMesh, origin: Tuple[float, float],
                       cell: float, shape: Tuple[int, int],
                       robust_sigma: float = 0.0,
                       robust_rounds: int = 3) -> Callable:
    """A fuser ``(xy (B_local, N, 2), values (B_local, N), weights
    (B_local, N)) -> StreamingDSM`` of the calling rank's point blocks
    (each ``N`` points with zero-weight padding; the global block axis is
    split over every mesh axis by
    :func:`pcmi_tpu_torch.parallel.mesh.shard_blocks`, which raises
    unless the block count divides by the mesh's size). Every rank gets
    the merged accumulator."""
    # lazy: pipelines.streaming imports this package (halo sizing)
    from pcmi_tpu_torch.pipelines.streaming import (
        StreamingDSM, dsm_update, empty_dsm)

    def fuse(xy, values, weights):
        acc = empty_dsm(shape, device=xy.device)
        for bxy, bv, bw in zip(xy, values, weights):
            acc = dsm_update(acc, bxy, bv, bw, origin, cell, shape,
                             robust_sigma=robust_sigma,
                             robust_rounds=robust_rounds)
        packed = all_reduce_mesh(torch.stack(acc), mesh)
        return StreamingDSM(*packed.unbind(0))

    return fuse
