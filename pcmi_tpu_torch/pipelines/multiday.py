"""Multi-day fusion: N stereo pairs -> one registered, filtered point cloud
and one DSM (port of ``pcmi_tpu/pipelines/multiday.py``).

The per-pair clouds share one local metric frame (``pair_core``
triangulates in the AOI frame), so fusion is:

1. pair selection across dates (convergence-angle heuristics);
2. per-pair stereo -> point cloud (one stereo config for all pairs);
3. ICP registration of every cloud onto the first, estimated on a random
   ``icp_subsample`` subset and applied to all points;
4. kNN statistical outlier rejection over the concatenated cloud;
5. per-pair DSM accumulators, fused by the cross-pair median;
6. optional K-means summary of the fused cloud.

The random draws of the reference (``jax.random`` keys k, 101, 102 + k
and 0) come from ``torch.Generator``s seeded with the same numbers: the
same seeds, a different draw.
"""

from __future__ import annotations

import logging
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pcmi_tpu_torch.config import FusionConfig, PipelineConfig
from pcmi_tpu_torch.geometry.pairs import ImageMeta, select_pairs, take_pairs
from pcmi_tpu_torch.ops import pointcloud as pc
from pcmi_tpu_torch.ops.stereo._build import KernelError
from pcmi_tpu_torch.pipelines.height_map import (
    HeightMapPipeline, product_point_cloud)
from pcmi_tpu_torch.pipelines.streaming import (
    dsm_finalize_multi, dsm_update, empty_dsm)
from pcmi_tpu_torch.utils.profiling import span

log = logging.getLogger("pcmi_tpu_torch")


class FusedCloud(NamedTuple):
    points: torch.Tensor       # (N, 3) local-frame metres (registered)
    weights: torch.Tensor      # (N,) 0/1 validity after outlier rejection
    dsm: torch.Tensor          # (ny, nx) fused height grid (NaN = empty)
    dsm_count: torch.Tensor    # (ny, nx) samples per cell
    grid_origin: Tuple[float, float]
    grid_cell: float
    icp_rmse: torch.Tensor     # (P,) per-pair registration residual
    kmeans_centroids: Optional[torch.Tensor]  # (K, 3) if clustering enabled
    n_pairs_per_cell: Optional[torch.Tensor] = None  # (ny, nx) redundancy


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _geometries(pipeline: HeightMapPipeline, chosen, images, rpcs,
                lon_range, lat_range):
    """Geometry per chosen pair; a pair whose geometry fails is skipped
    with a warning. Returns ``(usable pairs, geometries)``."""
    geoms, usable = [], []
    for p in chosen:
        try:
            geoms.append(pipeline.build_geometry(
                rpcs[p.i], rpcs[p.j], lon_range, lat_range,
                tuple(images[p.i].shape), tuple(images[p.j].shape)))
            usable.append(p)
        except KernelError:
            raise
        except Exception as exc:  # noqa: BLE001 (skipped, logged)
            log.warning("pair (%d, %d): geometry failed: %s", p.i, p.j, exc)
    return usable, geoms


def register_clouds(clouds: Sequence[torch.Tensor],
                    weights: Sequence[torch.Tensor], fus: FusionConfig,
                    subsets: Sequence[Optional[torch.Tensor]]):
    """ICP of every cloud onto the first. ``subsets[k]`` indexes the
    points of cloud k the transform is estimated on (None: all of them);
    the transform is applied to every point. Returns ``(registered,
    rmses)``."""
    def sub(k):
        idx = subsets[k]
        if idx is None:
            return clouds[k], weights[k]
        return clouds[k][idx], weights[k][idx]

    ref_s, ref_ws = sub(0)
    registered = [clouds[0]]
    rmses = [torch.zeros((), device=clouds[0].device)]
    for k in range(1, len(clouds)):
        pts_s, w_s = sub(k)
        res = pc.icp(pts_s, w_s > 0, ref_s, ref_ws > 0, iters=fus.icp_iters,
                     chunk=2048, mode="rigid")
        registered.append(pc.apply_rigid(clouds[k], res.R, res.t))
        rmses.append(res.rmse)
    return registered, rmses


def _grid_extent(pts: torch.Tensor, keep: torch.Tensor, cell: float):
    """Grid origin and shape covering the kept points (host scalars, from
    float32 extremes as in the reference)."""
    if not bool(keep.any()):
        return (0.0, 0.0), (1, 1)
    kept = pts[keep]
    lo = kept.amin(0).cpu().numpy()
    hi = kept.amax(0).cpu().numpy()
    x0, y0 = float(np.floor(lo[0])), float(np.floor(lo[1]))
    nx = int(np.ceil((hi[0] - x0) / cell)) + 1
    ny = int(np.ceil((hi[1] - y0) / cell)) + 1
    return (x0, y0), (ny, nx)


class MultiDayFusion:
    """Run the flagship pipeline over the selected pairs on ``device`` and
    fuse the clouds. A run is one span ``aoi`` with a child span per stage
    (``aoi.geometry``, ``aoi.stereo``, ``aoi.icp``, ``aoi.knn_mask``,
    ``aoi.dsm``, ``aoi.kmeans``); after a recorded :meth:`run`,
    :attr:`stage_ms` holds the device time of each stage but geometry."""

    def __init__(self, cfg: PipelineConfig = PipelineConfig(),
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.pipeline = HeightMapPipeline(cfg, device=device)
        self._run_span = None

    @property
    def device(self) -> torch.device:
        return self.pipeline.device

    @property
    def stage_ms(self) -> Dict[str, float]:
        """Device ms of the ``stereo``, ``icp``, ``knn_mask``, ``dsm`` and
        (with K-means) ``kmeans`` stages of the last recorded run; empty
        when the last run was not recorded
        (:func:`pcmi_tpu_torch.utils.profiling.recording`)."""
        if self._run_span is None:
            return {}
        return {s.name[len("aoi."):]: s.device_ms
                for s in self._run_span.children
                if s.name in _TIMED_STAGES}

    def select(self, metas: Sequence[ImageMeta]):
        return take_pairs(select_pairs(metas, self.cfg.pairs),
                          self.cfg.pairs.n_pairs)

    def run(self, images: Sequence, rpcs: Sequence,
            metas: Sequence[ImageMeta], lon_range, lat_range,
            points_per_pair: int = 1 << 17, with_kmeans: bool = False,
            grid_cell: Optional[float] = None, cache=None) -> FusedCloud:
        dev = self.device
        with span("aoi", dev) as run_span:
            self._run_span = run_span
            with span("aoi.geometry", dev):
                chosen = self.select(metas)
                if not chosen:
                    raise ValueError(
                        "no valid stereo pairs under the selection config")
                chosen, geoms = _geometries(self.pipeline, chosen, images,
                                            rpcs, lon_range, lat_range)
                if not chosen:
                    raise ValueError(
                        "every selected pair failed geometry construction")
                stereo_cfg = self.pipeline.stereo_cfg_for(geoms)

            # Per-pair failures degrade to a skipped pair, the reference's
            # semantics; a kernel or build failure is never a per-pair
            # fault and propagates.
            with span("aoi.stereo", dev, asked=len(chosen)) as stereo:
                clouds, weights = [], []
                for k, (p, geom) in enumerate(zip(chosen, geoms)):
                    try:
                        product = self.pipeline.process_pair(
                            images[p.i], images[p.j], geom, stereo_cfg,
                            cache=cache, with_plane=False)
                    except KernelError:
                        raise
                    except Exception as exc:  # noqa: BLE001 (skipped, logged)
                        log.warning("pair (%d, %d): stereo failed: %s",
                                    p.i, p.j, exc)
                        continue
                    pts, w = product_point_cloud(
                        product, max_points=points_per_pair,
                        generator=_generator(k, dev))
                    clouds.append(pts)
                    weights.append(w)
                stereo.count(fused=len(clouds),
                             skipped=len(chosen) - len(clouds))
            if not clouds:
                raise ValueError(
                    "every selected pair failed stereo processing")

            fus = self.cfg.fusion
            with span("aoi.icp", dev):
                subsets = []
                for k, pts in enumerate(clouds):
                    n = pts.shape[0]
                    seed = 101 if k == 0 else 102 + (k - 1)
                    subsets.append(
                        None if n <= fus.icp_subsample else torch.randperm(
                            n, generator=_generator(seed, dev),
                            device=dev)[:fus.icp_subsample])
                registered, rmses = register_clouds(clouds, weights, fus,
                                                    subsets)
                allpts = torch.cat(registered)
                allw = torch.cat(weights)

            with span("aoi.knn_mask", dev):
                keep = pc.knn_outlier_mask(allpts, allw > 0, k=fus.knn_k,
                                           sigma=fus.knn_sigma, chunk=2048)
                w_final = (allw > 0) & keep

            with span("aoi.dsm", dev):
                cell = float(grid_cell if grid_cell is not None
                             else fus.grid_cell)
                origin, shape = _grid_extent(allpts, w_final, cell)
                accs, offset = [], 0
                for pts in registered:
                    n = pts.shape[0]
                    accs.append(dsm_update(
                        empty_dsm(shape, dev), pts[:, :2], pts[:, 2],
                        w_final[offset:offset + n].float(), origin, cell,
                        shape, robust_sigma=fus.knn_sigma))
                    offset += n
                dsm, cnt, n_pairs_cell = dsm_finalize_multi(accs)

            centroids = None
            if with_kmeans:
                with span("aoi.kmeans", dev):
                    centroids = pc.kmeans(allpts, w_final.float(),
                                          k=fus.kmeans_clusters,
                                          iters=fus.kmeans_iters,
                                          generator=_generator(0, dev)
                                          ).centroids

            return FusedCloud(
                points=allpts, weights=w_final.float(),
                dsm=torch.from_numpy(dsm), dsm_count=torch.from_numpy(cnt),
                grid_origin=origin, grid_cell=cell,
                icp_rmse=torch.stack(rmses), kmeans_centroids=centroids,
                n_pairs_per_cell=torch.from_numpy(n_pairs_cell))


_TIMED_STAGES = ("aoi.stereo", "aoi.icp", "aoi.knn_mask", "aoi.dsm",
                 "aoi.kmeans")


def fused_consistency_dsm(images: Sequence, rpcs: Sequence,
                          metas: Sequence[ImageMeta], lon_range, lat_range,
                          cfg: PipelineConfig,
                          grid_origin: Tuple[float, float],
                          grid_shape: Tuple[int, int], cell: float,
                          n_pairs: int = 12, min_pairs: int = 5,
                          mad_max: float = 0.6,
                          device: str | torch.device = "cuda"):
    """Consistency-masked multi-date DSM: each pair's product gridded into
    its own accumulator (tile-local 3-sigma gate), fused by the cross-pair
    median with the MAD and redundancy gates
    (:func:`pcmi_tpu_torch.pipelines.streaming.dsm_finalize_multi`).

    The recipe for both hard regimes: steep/urban scenes, where two-view
    phantom matches pass every single-pair gate but decorrelate across
    geometries, and low texture (``gate_profile="lr"`` with
    ``presmooth_sigma``), where per-pair validity is permissive and the MAD
    gate rejects what the acquisitions do not agree on. Returns ``(dsm,
    count, n_pairs_per_cell)``; NaN = masked or empty."""
    pipeline = HeightMapPipeline(cfg, device=device)
    chosen = take_pairs(select_pairs(metas, cfg.pairs), max(n_pairs, 1))
    if not chosen:
        raise ValueError("no valid stereo pairs under the selection config")
    usable, geoms = _geometries(pipeline, chosen, images, rpcs, lon_range,
                                lat_range)
    stereo_cfg = pipeline.stereo_cfg_for(geoms)
    accs = []
    for p, geom in zip(usable, geoms):
        prod = pipeline.process_pair(images[p.i], images[p.j], geom,
                                     stereo_cfg, with_plane=False)
        xyz = prod.xyz.reshape(-1, 3)
        accs.append(dsm_update(
            empty_dsm(grid_shape, pipeline.device), xyz[:, :2], xyz[:, 2],
            prod.valid.reshape(-1).float(), grid_origin, cell, grid_shape,
            robust_sigma=3.0))
    return dsm_finalize_multi(accs, min_pairs=min_pairs, mad_max=mad_max)
