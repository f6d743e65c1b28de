"""Halo exchange over row-band sharded images (port of
``pcmi_tpu/parallel/halo.py``).

When a rectified canvas is cut into row bands over the ``tile`` ranks,
every windowed op (census window, block aggregation, vertical SGM paths,
median and guided filters) needs ``halo`` rows of each neighbour band.
One exchange with each neighbour supplies them; the first and last band
receive zeros, which downstream code treats as invalid, as it does the
canvas border. Disparity search is horizontal and bands keep whole rows,
so no halo is needed along the epipolar axis.

The reference's two ``lax.ppermute``s are one ``batch_isend_irecv`` of
the calling rank with its neighbours on the tile group.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from pcmi_tpu_torch.parallel.mesh import TILE_AXIS


def _tile_group(mesh_or_group):
    if isinstance(mesh_or_group, DeviceMesh):
        return mesh_or_group.get_group(TILE_AXIS)
    return mesh_or_group


def halo_exchange_rows(x: torch.Tensor, halo: int,
                       mesh_or_group=None) -> torch.Tensor:
    """Extend the local row band ``x`` ((h_local, W) or (h_local, W, C))
    with ``halo`` rows from each neighbour on the tile group (a mesh's
    ``tile`` axis, a process group, or the world when ``None``):
    (h_local + 2 * halo, W[, C]), zeros where there is no neighbour."""
    if halo == 0:
        return x  # x[-0:] would be the whole band, not an empty slice
    if x.shape[0] < halo:
        raise ValueError(
            f"halo ({halo}) exceeds the local row band ({x.shape[0]}); use "
            f"fewer tile shards or a taller canvas: single-hop neighbour "
            f"exchange can only supply up to one band of context")
    group = _tile_group(mesh_or_group)
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    from_prev = x.new_zeros((halo,) + tuple(x.shape[1:]))
    from_next = torch.zeros_like(from_prev)
    ops = []
    for peer, send, recv in ((r - 1, x[:halo], from_prev),
                             (r + 1, x[-halo:], from_next)):
        if 0 <= peer < n:
            g = dist.get_global_rank(group, peer) if group is not None \
                else peer
            ops += [dist.P2POp(dist.isend, send.contiguous(), g, group),
                    dist.P2POp(dist.irecv, recv, g, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([from_prev, x, from_next], dim=0)


def sharded_rows_map(fn: Callable, mesh: DeviceMesh, halo: int) -> Callable:
    """Wrap ``fn(*bands) -> bands`` into a function of local (B_local,
    h_local, W) blocks: for each local stack element, halo-extend every
    input's rows, run ``fn`` and crop the halo back off. ``fn`` must keep
    its inputs' first two dimensions."""

    def single(*arrays):
        out = fn(*(halo_exchange_rows(a, halo, mesh) for a in arrays))
        outs = out if isinstance(out, tuple) else (out,)
        # explicit end index: [halo:-halo] is empty when halo == 0
        return tuple(o[halo: o.shape[0] - halo] for o in outs)

    def run(*stacks):
        rows = [single(*els) for els in zip(*stacks)]
        outs = tuple(torch.stack(col) for col in zip(*rows))
        return outs if len(outs) > 1 else outs[0]

    return run
