"""Multi-device stereo: pairs over ``data``, row bands over ``tile`` (port
of ``pcmi_tpu/parallel/stereo_sharded.py``).

* :func:`sharded_disparity`: each rank runs the windowed matcher
  (``compute_disparity`` with SGM, then ``refine_disparity``) on its row
  band extended by ``halo`` rows of each neighbour; the only
  communication is the halo exchange.
* :func:`batched_pair_step`: the whole per-pair core (``pair_core``),
  whose global reductions (the robust normalisation's quantiles, the
  plane fit) span the canvas. The reference lets GSPMD split each pair's
  rows over ``tile`` and insert those reductions' collectives. PyTorch
  has no such compiler: within the tile group the ranks all-gather each
  pair's row bands, every one of them runs ``pair_core`` on the whole
  pair, and each keeps its own band. The results are single-device
  ``pair_core``'s; the compute is repeated on every tile rank.

The halo must cover every windowed op's influence: census window, block
aggregation, guided-filter radius, speckle median and the decaying
vertical SGM recurrence (:func:`default_halo`, deliberately generous).
Functions take and return the calling rank's local blocks
(:func:`pcmi_tpu_torch.parallel.mesh.place`).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from pcmi_tpu_torch.config import StereoConfig
from pcmi_tpu_torch.ops.stereo.matching import (
    compute_disparity, refine_disparity)
from pcmi_tpu_torch.parallel.halo import halo_exchange_rows
from pcmi_tpu_torch.parallel.mesh import TILE_AXIS


def default_halo(cfg: StereoConfig) -> int:
    """Influence radius of the windowed ops (census window, block
    aggregation, guided filter, speckle median and the decaying vertical
    SGM recurrence), rounded up to 8 rows."""
    r = (cfg.census_window // 2
         + cfg.block_size
         + 2 * cfg.gf_radius * cfg.wls_passes
         + cfg.speckle_median_size
         + 16)  # vertical SGM decay allowance
    if cfg.hierarchical:
        # the coarse half-resolution pass doubles every footprint
        r *= 2
    return ((r + 7) // 8) * 8


def sharded_disparity(mesh: DeviceMesh, cfg: StereoConfig,
                      halo: int | None = None) -> Callable:
    """A matcher of local (B_local, h_local, W) blocks of the rectified
    left and right stacks and their validity masks (pairs over ``data``,
    rows over ``tile``) returning the local blocks of disparity and
    validity. Masks cross the exchange as float and are read back
    ``> 0.5``: halo rows that arrive as zeros at the canvas edges are
    invalid."""
    h = halo if halo is not None else default_halo(cfg)

    def single(left, right, vl, vr):
        le = halo_exchange_rows(left, h, mesh)
        re_ = halo_exchange_rows(right, h, mesh)
        ve = halo_exchange_rows(vl.float(), h, mesh) > 0.5
        we = halo_exchange_rows(vr.float(), h, mesh) > 0.5
        res = compute_disparity(le, re_, ve, we, cfg, aggregation="sgm")
        res = refine_disparity(res, le, cfg)
        # explicit end index: [h:-h] is empty when h == 0
        end = res.disparity.shape[0] - h
        return res.disparity[h:end], res.valid[h:end]

    def run(left, right, vl, vr):
        outs = [single(*els) for els in zip(left, right, vl, vr)]
        return (torch.stack([d for d, _ in outs]),
                torch.stack([v for _, v in outs]))

    return run


def batched_pair_step(mesh: DeviceMesh, cfg: StereoConfig,
                      ground_percentile=2.0) -> Callable:
    """The full pair core over the mesh: ``step(rects, tri_M, tri_b)`` of
    local blocks, ``rects`` (B_local, 2, h_local, W) (left and right,
    pairs over ``data``, rows over ``tile``), ``tri_M`` (B_local, 3, 4)
    and ``tri_b`` (B_local, 4) (pairs over ``data``), returns the local
    (B_local, h_local, W) blocks of disparity, validity and heights. Each
    pair's bands are all-gathered over the tile group and ``pair_core``
    runs on the whole pair on every tile rank (see the module's
    docstring)."""
    # lazy: pipelines.streaming imports this package for default_halo,
    # and pipelines.height_map comes with it
    from pcmi_tpu_torch.pipelines.height_map import pair_core

    group = mesh.get_group(TILE_AXIS)
    n = mesh.size(mesh.mesh_dim_names.index(TILE_AXIS))
    r = mesh.get_local_rank(TILE_AXIS)

    def whole(band):
        if n == 1:
            return band
        parts = [torch.empty_like(band) for _ in range(n)]
        dist.all_gather(parts, band.contiguous(), group=group)
        return torch.cat(parts, dim=-2)

    def step(rects, tri_M, tri_b):
        outs = []
        for pair, M, b in zip(rects, tri_M, tri_b):
            hl = pair.shape[-2]
            full = whole(pair)
            out = pair_core(full[0], full[1], M, b, cfg,
                            ground_percentile=ground_percentile)
            rows = slice(r * hl, (r + 1) * hl)
            outs.append((out.disparity[rows], out.valid[rows],
                         out.height[rows]))
        return tuple(torch.stack(col) for col in zip(*outs))

    return step
