"""Multi-day fusion: N stereo pairs -> one registered, filtered point cloud
and one DSM. A frozen copy of the port's ``pipelines/multiday.py``
(``MultiDayFusion.run``), as one function:

1. pair selection across dates (convergence-angle heuristics);
2. per-pair stereo -> point cloud (one stereo config for all pairs);
3. ICP registration of every cloud onto the first, estimated on a random
   ``icp_subsample`` subset and applied to all points;
4. kNN statistical outlier rejection over the concatenated cloud;
5. per-pair DSM accumulators, fused by the cross-pair median;
6. optional K-means summary of the fused cloud.

The draws come from ``torch.Generator``s on the device seeded with k,
101, 102 + k and 0, as the port seeds them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from perfbench.reference.config import FusionConfig, PipelineConfig
from perfbench.reference.geometry.pairs import ImageMeta, select_pairs, take_pairs
from perfbench.reference.ops import pointcloud as pc
from perfbench.reference.pipelines.height_map import (
    build_geometry, process_pair, product_point_cloud, stereo_cfg_for)
from perfbench.reference.pipelines.streaming import (
    dsm_finalize_multi, dsm_update, empty_dsm)


class FusedCloud(NamedTuple):
    points: torch.Tensor       # (N, 3) local-frame metres (registered)
    weights: torch.Tensor      # (N,) 0/1 validity after outlier rejection
    dsm: np.ndarray            # (ny, nx) fused height grid (NaN = empty)
    dsm_count: np.ndarray      # (ny, nx) samples per cell
    grid_origin: Tuple[float, float]
    grid_cell: float
    icp_rmse: torch.Tensor     # (P,) per-pair registration residual
    kmeans_centroids: Optional[torch.Tensor]  # (K, 3) if clustering enabled
    n_pairs_per_cell: np.ndarray  # (ny, nx) redundancy


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


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
    float32 extremes)."""
    if not bool(keep.any()):
        return (0.0, 0.0), (1, 1)
    kept = pts[keep]
    lo = kept.amin(0).cpu().numpy()
    hi = kept.amax(0).cpu().numpy()
    x0, y0 = float(np.floor(lo[0])), float(np.floor(lo[1]))
    nx = int(np.ceil((hi[0] - x0) / cell)) + 1
    ny = int(np.ceil((hi[1] - y0) / cell)) + 1
    return (x0, y0), (ny, nx)


def fuse(cfg: PipelineConfig, images: Sequence, rpcs: Sequence,
         metas: Sequence[ImageMeta], lon_range, lat_range, device,
         points_per_pair: int = 1 << 17, with_kmeans: bool = False,
         grid_cell: Optional[float] = None) -> FusedCloud:
    """The whole multi-day fusion of the selected pairs on ``device``."""
    chosen = take_pairs(select_pairs(metas, cfg.pairs), cfg.pairs.n_pairs)
    if not chosen:
        raise ValueError("no valid stereo pairs under the selection config")
    geoms = [build_geometry(cfg, rpcs[p.i], rpcs[p.j], lon_range, lat_range,
                            tuple(images[p.i].shape),
                            tuple(images[p.j].shape)) for p in chosen]
    stereo_cfg = stereo_cfg_for(cfg, geoms)

    clouds, weights = [], []
    for k, (p, geom) in enumerate(zip(chosen, geoms)):
        product = process_pair(cfg, images[p.i], images[p.j], geom,
                               stereo_cfg, device, with_plane=False)
        pts, w = product_point_cloud(product, max_points=points_per_pair,
                                     generator=_generator(k, device))
        clouds.append(pts)
        weights.append(w)

    fus = cfg.fusion
    subsets = []
    for k, pts in enumerate(clouds):
        n = pts.shape[0]
        seed = 101 if k == 0 else 102 + (k - 1)
        subsets.append(None if n <= fus.icp_subsample else torch.randperm(
            n, generator=_generator(seed, device),
            device=device)[:fus.icp_subsample])
    registered, rmses = register_clouds(clouds, weights, fus, subsets)
    allpts = torch.cat(registered)
    allw = torch.cat(weights)

    keep = pc.knn_outlier_mask(allpts, allw > 0, k=fus.knn_k,
                               sigma=fus.knn_sigma, chunk=2048)
    w_final = (allw > 0) & keep

    cell = float(grid_cell if grid_cell is not None else fus.grid_cell)
    origin, shape = _grid_extent(allpts, w_final, cell)
    accs, offset = [], 0
    for pts in registered:
        n = pts.shape[0]
        accs.append(dsm_update(
            empty_dsm(shape, device), pts[:, :2], pts[:, 2],
            w_final[offset:offset + n].float(), origin, cell, shape,
            robust_sigma=fus.knn_sigma))
        offset += n
    dsm, cnt, n_pairs_cell = dsm_finalize_multi(accs)

    centroids = None
    if with_kmeans:
        centroids = pc.kmeans(allpts, w_final.float(),
                              k=fus.kmeans_clusters, iters=fus.kmeans_iters,
                              generator=_generator(0, device)).centroids
    return FusedCloud(
        points=allpts, weights=w_final.float(), dsm=dsm, dsm_count=cnt,
        grid_origin=origin, grid_cell=cell, icp_rmse=torch.stack(rmses),
        kmeans_centroids=centroids, n_pairs_per_cell=n_pairs_cell)
