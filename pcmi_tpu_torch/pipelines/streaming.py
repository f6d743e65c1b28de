"""Streaming whole-AOI pipeline: row-band tiles, bounded memory (port of
``pcmi_tpu/pipelines/streaming.py``).

  for each selected pair:
    build the rectification geometry once (host)
    normalise the whole rectified canvas once
    for each row band of the canvas:
      pair_core(band + halo, pre_normalised, row0) -> xyz, valid
      accumulate the band's valid points into the pair's DSM sums
  cross-pair median of the pairs' cell means

The accumulator keeps only (ny, nx) running sums (weight, weighted value,
weighted square), so the AOI size is bounded by the grid, not by the point
count. The halo covers the matcher's vertical influence
(:func:`pcmi_tpu_torch.parallel.stereo_sharded.default_halo`).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pcmi_tpu_torch.config import PipelineConfig
from pcmi_tpu_torch.geometry.pairs import ImageMeta, select_pairs, take_pairs
from pcmi_tpu_torch.geometry.rectify import (
    rectify_arrays, triangulation_operator)
from pcmi_tpu_torch.ops.normalize import normalise_image
from pcmi_tpu_torch.ops.pointcloud import cell_ids
from pcmi_tpu_torch.ops.segmented import (
    grid_segment_sums, robust_sigma_gate, sort_by_segment)
from pcmi_tpu_torch.parallel.stereo_sharded import default_halo
from pcmi_tpu_torch.pipelines.height_map import HeightMapPipeline, pair_core


class StreamingDSM(NamedTuple):
    wsum: torch.Tensor    # (ny, nx) weight sums
    vsum: torch.Tensor    # (ny, nx) weighted value sums
    vsq: torch.Tensor     # (ny, nx) weighted squared sums


def empty_dsm(shape: Tuple[int, int], device="cuda") -> StreamingDSM:
    return StreamingDSM(*(torch.zeros(shape, device=device)
                          for _ in range(3)))


def dsm_update(acc: StreamingDSM, xy: torch.Tensor, values: torch.Tensor,
               weights: torch.Tensor, origin: Tuple[float, float],
               cell: float, shape: Tuple[int, int],
               robust_sigma: float = 0.0,
               robust_rounds: int = 3) -> StreamingDSM:
    """Add one tile's points into the running DSM sums.

    ``robust_sigma > 0`` first drops, per cell, this tile's samples beyond
    ``robust_sigma`` tile-stds from the tile-cell mean, iterated
    ``robust_rounds`` times (:func:`pcmi_tpu_torch.ops.segmented
    .robust_sigma_gate`): iterating lets the majority surface win a cell
    that straddles a height step."""
    ny, nx = shape
    ids, w = cell_ids(xy, weights, origin, cell, shape)
    v = values.reshape(-1).float()
    ids, v, w, boundary = sort_by_segment(ids, v, w)
    if robust_sigma > 0:
        w = robust_sigma_gate(boundary, v, w, robust_sigma,
                              rounds=robust_rounds)
    # zero-weight rows may carry any value (out-of-bounds or invalid
    # pixels): zero them so the sums stay finite
    v = torch.where(w > 0, v, 0.0)
    packed = grid_segment_sums(ids, boundary, (w, w * v, w * v * v), ny * nx)
    return StreamingDSM(wsum=acc.wsum + packed[:, 0].reshape(ny, nx),
                        vsum=acc.vsum + packed[:, 1].reshape(ny, nx),
                        vsq=acc.vsq + packed[:, 2].reshape(ny, nx))


def dsm_finalize(acc: StreamingDSM) -> Tuple[np.ndarray, np.ndarray]:
    """(dsm, count) on the host: the weighted mean, NaN in empty cells."""
    wsum = acc.wsum.cpu().numpy()
    mean = acc.vsum.cpu().numpy() / np.maximum(wsum, 1e-12)
    mean[wsum <= 0] = np.nan
    return mean, wsum


def dsm_finalize_multi(accs: Sequence[StreamingDSM], min_pairs: int = 1,
                       mad_max: float | None = None,
                       accept2_delta: float | None = None):
    """Cross-pair median finalisation on the host (numpy, as the
    reference). Returns ``(dsm, count, n_pairs)``.

    The per-cell median of the pairs' cell means outvotes single-pair
    blunders. ``min_pairs`` NaN-masks cells seen by fewer pairs;
    ``mad_max`` (m) masks cells whose cross-pair median absolute deviation
    exceeds it; ``accept2_delta`` (m, with ``min_pairs > 2``) re-admits
    cells seen by exactly two pairs whose means agree within it (their
    mean is used)."""
    means, counts = [], []
    for acc in accs:
        m, c = dsm_finalize(acc)
        means.append(m)
        counts.append(c)
    stack = np.stack(means)                       # (P, ny, nx)
    n_pairs = np.isfinite(stack).sum(axis=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN cells
        dsm = np.nanmedian(stack, axis=0)
        if mad_max is not None:
            mad = np.nanmedian(np.abs(stack - dsm[None]), axis=0)
            dsm = np.where(mad <= mad_max, dsm, np.nan)
        if min_pairs > 1:
            dsm = np.where(n_pairs >= min_pairs, dsm, np.nan)
        if accept2_delta is not None and min_pairs > 2:
            rng2 = np.nanmax(stack, axis=0) - np.nanmin(stack, axis=0)
            take2 = (n_pairs == 2) & (rng2 <= accept2_delta)
            dsm = np.where(take2, np.nanmean(stack, axis=0), dsm)
    return dsm, np.sum(counts, axis=0), n_pairs


class StreamingAOIPipeline:
    """Run every selected pair over one AOI as fixed-shape band tiles on
    ``device``."""

    def __init__(self, cfg: PipelineConfig = PipelineConfig(),
                 band_rows: int = 256, halo: Optional[int] = None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.pipeline = HeightMapPipeline(cfg, device=device)
        self.band_rows = band_rows
        self.halo = halo

    def run(self, images: Sequence, rpcs: Sequence,
            metas: Sequence[ImageMeta], lon_range, lat_range,
            grid_cell: float = 1.0,
            grid_origin: Optional[Tuple[float, float]] = None,
            grid_shape: Optional[Tuple[int, int]] = None,
            n_pairs: Optional[int] = None, min_pairs: int = 1) -> dict:
        pairs = take_pairs(select_pairs(metas, self.cfg.pairs),
                           n_pairs or self.cfg.pairs.n_pairs)
        if not pairs:
            raise ValueError("no valid stereo pairs")
        pipe = self.pipeline
        dev = pipe.device
        geoms = [pipe.build_geometry(rpcs[p.i], rpcs[p.j], lon_range,
                                     lat_range, tuple(images[p.i].shape),
                                     tuple(images[p.j].shape))
                 for p in pairs]
        cfg_s = pipe.stereo_cfg_for(geoms)
        halo = self.halo if self.halo is not None else default_halo(cfg_s)

        if grid_origin is None or grid_shape is None:
            # the AOI extent in the local frame: every canvas' corners
            # triangulated at zero disparity (host math)
            xs, ys = [], []
            for g in geoms:
                M, b = (t.numpy() for t in triangulation_operator(g))
                hh, ww = g.out_shape
                corners = np.array(
                    [[0, 0, 0, 0], [0, hh, 0, hh], [ww, 0, ww, 0],
                     [ww, hh, ww, hh]], np.float32)
                xyz = (corners - b) @ M.T
                xs += list(xyz[:, 0])
                ys += list(xyz[:, 1])
            x0, y0 = float(np.floor(min(xs))), float(np.floor(min(ys)))
            nx = int(np.ceil((max(xs) - x0) / grid_cell)) + 1
            ny = int(np.ceil((max(ys) - y0) / grid_cell)) + 1
            grid_origin = (x0, y0)
            grid_shape = (ny, nx)

        accs: List[StreamingDSM] = []
        band = self.band_rows
        n_tiles = 0
        for p, geom in zip(pairs, geoms):
            acc = empty_dsm(grid_shape, dev)
            H, _ = geom.out_shape
            r1, r2 = rectify_arrays(
                torch.as_tensor(images[p.i], dtype=torch.float32).to(dev),
                torch.as_tensor(images[p.j], dtype=torch.float32).to(dev),
                torch.as_tensor(geom.H1, dtype=torch.float32),
                torch.as_tensor(geom.H2, dtype=torch.float32),
                geom.out_shape)
            # normalise ONCE over the whole canvas: per-band bounds would
            # give one pixel different radiometry in adjacent bands
            ss = cfg_s.norm_subsample
            m1, m2 = r1 >= 0, r2 >= 0
            r1 = torch.where(m1, normalise_image(r1, m1, subsample=ss)[0], -1.0)
            r2 = torch.where(m2, normalise_image(r2, m2, subsample=ss)[0], -1.0)
            M, b = (t.to(dev) for t in triangulation_operator(geom))
            pad = (0, 0, halo, halo + (-H) % band)
            r1p = F.pad(r1, pad, value=-1.0)
            r2p = F.pad(r2, pad, value=-1.0)
            for y0 in range(0, H, band):
                rows = slice(y0, y0 + band + 2 * halo)
                prod = pair_core(r1p[rows], r2p[rows], M, b, cfg_s,
                                 with_plane=False, row0=float(y0 - halo),
                                 pre_normalised=True)
                core = slice(halo, halo + band)
                xyz = prod.xyz[core]
                acc = dsm_update(acc, xyz[..., :2], xyz[..., 2],
                                 prod.valid[core].float(), grid_origin,
                                 grid_cell, grid_shape,
                                 robust_sigma=self.cfg.fusion.knn_sigma)
                n_tiles += 1
            accs.append(acc)

        dsm, count, n_pairs_per_cell = dsm_finalize_multi(
            accs, min_pairs=min_pairs)
        return {"dsm": dsm, "count": count,
                "n_pairs_per_cell": n_pairs_per_cell, "origin": grid_origin,
                "cell": grid_cell, "pairs": len(pairs), "tiles": n_tiles,
                "stereo_cfg": dataclasses.asdict(cfg_s)}
