"""Accuracy evaluation against synthetic ground truth (port of
``pcmi_tpu/pipelines/evaluation.py``; host numpy on the products).

Every accuracy number the port reports is computed here, the same way as
the reference's tests and bench compute theirs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pcmi_tpu_torch.config import PipelineConfig
from pcmi_tpu_torch.geometry.synthetic import SyntheticScene, aoi_lonlat_ranges
from pcmi_tpu_torch.geometry.pairs import ImageMeta
from pcmi_tpu_torch.pipelines.height_map import HeightMapPipeline
from pcmi_tpu_torch.pipelines.multiday import MultiDayFusion
from pcmi_tpu_torch.utils.profiling import recording


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def truth_on_grid(scene: SyntheticScene, xyz) -> tuple[np.ndarray, np.ndarray]:
    """Bilinearly sample the true terrain height at triangulated (x, y).

    Returns ``(truth, in_bounds)`` on the product grid."""
    ox, oy = scene.ground_origin
    terr = _np(scene.terrain)
    xyz = _np(xyz)
    gx = (xyz[..., 0] - ox) / scene.ground_gsd
    gy = (xyz[..., 1] - oy) / scene.ground_gsd
    gxc = np.clip(gx, 0, terr.shape[1] - 1)
    gyc = np.clip(gy, 0, terr.shape[0] - 1)
    x0 = np.floor(gxc).astype(int)
    y0 = np.floor(gyc).astype(int)
    x1 = np.clip(x0 + 1, 0, terr.shape[1] - 1)
    y1 = np.clip(y0 + 1, 0, terr.shape[0] - 1)
    tx = gxc - x0
    ty = gyc - y0
    t = (terr[y0, x0] * (1 - ty) * (1 - tx) + terr[y0, x1] * (1 - ty) * tx
         + terr[y1, x0] * ty * (1 - tx) + terr[y1, x1] * ty * tx)
    inb = ((gx >= 0) & (gx < terr.shape[1] - 1)
           & (gy >= 0) & (gy < terr.shape[0] - 1))
    return t, inb


def pair_observability(scene: SyntheticScene, pairs, cell: float,
                       grid_shape: tuple[int, int],
                       origin: tuple[float, float] | None = None,
                       margin_px: float = 0.0) -> np.ndarray:
    """Per-cell count of stereo pairs that image the cell centre in BOTH
    views: each cell centre, at the true terrain height, is projected
    through every view's RPC; a pair observes the cell when the projection
    lands inside both source images (shrunk by ``margin_px``). This is the
    completeness denominator for fused products: the AOI bounding box has
    corners outside every footprint. Returns an ``(ny, nx)`` int array."""
    ny, nx = grid_shape
    ox, oy = origin if origin is not None else scene.ground_origin
    xc = ox + (np.arange(nx, dtype=np.float64) + 0.5) * cell
    yc = oy + (np.arange(ny, dtype=np.float64) + 0.5) * cell
    xm, ym = np.meshgrid(xc, yc)
    truth, _ = truth_on_grid(scene, np.stack([xm, ym, np.zeros_like(xm)], -1))
    # the frame's float32 transform, as the reference evaluates it
    lon, lat, _ = scene.frame.to_geodetic(
        torch.from_numpy(xm.astype(np.float32)),
        torch.from_numpy(ym.astype(np.float32)), None)
    lon = lon.numpy().astype(np.float64)
    lat = lat.numpy().astype(np.float64)
    ok = []
    for v, img in enumerate(scene.images):
        h_im, w_im = img.shape[:2]
        col, row = scene.rpcs[v].project_np(
            lon.ravel(), lat.ravel(), np.asarray(truth, np.float64).ravel())
        ok.append(((col >= margin_px) & (col <= w_im - 1 - margin_px)
                   & (row >= margin_px) & (row <= h_im - 1 - margin_px))
                  .reshape(ny, nx))
    return sum((ok[i] & ok[j]).astype(np.int32) for i, j in pairs)


def evaluate_pair_accuracy(scene: SyntheticScene, cfg: PipelineConfig,
                           view_idx=(0, 1), device="cuda") -> dict:
    """Run the flagship pair pipeline on one scene and score it: height
    RMSE / bias against the exact terrain, and completeness (valid pixels
    over the observable footprint, where both rectified views carry
    data)."""
    i, j = view_idx
    pipe = HeightMapPipeline(cfg, device=device)
    geom = pipe.build_geometry(
        scene.rpcs[i], scene.rpcs[j], *aoi_lonlat_ranges(scene),
        tuple(scene.images[i].shape), tuple(scene.images[j].shape))
    product = pipe.process_pair(scene.images[i], scene.images[j], geom)
    valid = _np(product.valid)
    truth, inb = truth_on_grid(scene, product.xyz)
    m = valid & inb
    if not m.any():
        return {"rmse_m": float("nan"), "bias_m": float("nan"),
                "completeness": 0.0, "valid_fraction": 0.0}
    err = _np(product.height)[m] - truth[m]
    observable = (_np(product.rect_left) >= 0) & (_np(product.rect_right) >= 0)
    return {
        "rmse_m": float(np.sqrt(np.mean(err ** 2))),
        "bias_m": float(np.mean(err)),
        "abs_p90_m": float(np.quantile(np.abs(err), 0.9)),
        "completeness": float(valid.sum() / max(observable.sum(), 1)),
        "valid_fraction": float(valid.mean()),
    }


def evaluate_fused_dsm(scene: SyntheticScene, cfg: PipelineConfig, views,
                       n_pairs: int = 8, grid_cell: float = 1.0,
                       points_per_pair: int = 1 << 16,
                       flat_grad_m: float = 2.0, device="cuda",
                       with_kmeans: bool = False) -> dict:
    """Multi-date fusion accuracy through :class:`MultiDayFusion`:

    * ``completeness``: filled cells over all truth-covered grid cells;
    * ``rmse_m``: filled-cell height error against cell-centre truth;
    * ``rmse_flat_m``: the same on flat cells (|grad truth| at most
      ``flat_grad_m`` per cell).

    Besides the reference's keys it returns the number of pairs selected,
    the largest ICP residual and the fusion's ``stage_ms`` (the run is
    recorded for it)."""
    metas = [ImageMeta(i, inc, az, date=20.0 * i)
             for i, (inc, az) in enumerate(views)]
    fusion = MultiDayFusion(
        cfg.replace(pairs=dataclasses.replace(cfg.pairs, n_pairs=n_pairs)),
        device=device)
    with recording():
        fused = fusion.run(
            scene.images, scene.rpcs, metas, *aoi_lonlat_ranges(scene),
            points_per_pair=points_per_pair, grid_cell=grid_cell,
            with_kmeans=with_kmeans)
    dsm = _np(fused.dsm)
    ny, nx = dsm.shape
    x0, y0 = fused.grid_origin
    cell = fused.grid_cell
    terr = _np(scene.terrain)
    gx = (x0 + (np.arange(nx) + 0.5) * cell
          - scene.ground_origin[0]) / scene.ground_gsd
    gy = (y0 + (np.arange(ny) + 0.5) * cell
          - scene.ground_origin[1]) / scene.ground_gsd
    gxm, gym = np.meshgrid(gx, gy)
    inb = ((gxm >= 0) & (gxm < terr.shape[1] - 1)
           & (gym >= 0) & (gym < terr.shape[0] - 1))
    tt = terr[np.clip(gym.astype(int), 0, terr.shape[0] - 1),
              np.clip(gxm.astype(int), 0, terr.shape[1] - 1)]
    filled = np.isfinite(dsm) & inb
    comp = float(filled.sum() / max(inb.sum(), 1))
    err = dsm[filled] - tt[filled]
    rmse = float(np.sqrt(np.mean(err ** 2))) if filled.any() else float("nan")
    gyg, gxg = np.gradient(tt)
    flat = np.hypot(gyg, gxg) * (cell / scene.ground_gsd) <= flat_grad_m
    mf = filled & flat
    rmse_flat = (float(np.sqrt(np.mean((dsm[mf] - tt[mf]) ** 2)))
                 if mf.any() else float("nan"))
    icp = _np(fused.icp_rmse)
    return {
        "completeness": comp,
        "rmse_m": rmse,
        "rmse_flat_m": rmse_flat,
        "n_pairs": int(icp.shape[0]),
        "cells": int(inb.sum()),
        "filled": int(filled.sum()),
        "selected": len(fusion.select(metas)),
        "icp_rmse_max": float(icp.max()),
        "stage_ms": dict(fusion.stage_ms),
    }
