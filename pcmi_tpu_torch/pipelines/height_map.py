"""Flagship pipeline: stereo pair -> disparity -> height map -> 3D points
(port of ``pcmi_tpu/pipelines/height_map.py``).

  RPCs --host float64--> affine rectification geometry (geometry.rectify)
  images --device--> rectify warp -> robust normalise -> census/SGM
                     disparity -> guided-filter refine -> photoconsistency
                     -> blunder gates -> triangulate -> plane-relative heights

:func:`pair_core` runs eagerly on the device of its inputs;
:class:`HeightMapPipeline` takes that device as ``device=`` and moves the
images there. Both gate profiles ("strict" and "lr") are ported, the
row-band form the streaming pipeline uses (``row0``, ``pre_normalised``)
and the three matchers ``pair_core`` dispatches on: full search, the
banded tile-adaptive range (``adapt_band_rows > 0``,
:mod:`pcmi_tpu_torch.ops.stereo.banded`) and coarse-to-fine
(``hierarchical``, :mod:`pcmi_tpu_torch.ops.stereo.hierarchical`).
:class:`HeightMapExtractor` is the plugin over the pipeline.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pcmi_tpu_torch.config import PipelineConfig, StereoConfig
from pcmi_tpu_torch.geometry.pairs import select_pairs, take_pairs
from pcmi_tpu_torch.geometry.rectify import (
    RectifiedGeometry, build_geometry_from_rpcs, rectify_arrays,
    triangulate_from_operator, triangulation_operator)
from pcmi_tpu_torch.interface import Layer, SatellitePlugin
from pcmi_tpu_torch.ops.filters import gaussian_filter, separable_median_filter
from pcmi_tpu_torch.ops.morphology import binary_dilation
from pcmi_tpu_torch.ops.normalize import (
    masked_median_grid, masked_quantile_grid, normalise_image, snr_ratio)
from pcmi_tpu_torch.ops.pointcloud import (
    fit_plane, gumbel_noise, plane_relative_height)
from pcmi_tpu_torch.ops.stereo.banded import banded_disparity
from pcmi_tpu_torch.ops.stereo.hierarchical import (
    compute_disparity_hierarchical)
from pcmi_tpu_torch.ops.stereo.matching import (
    compute_disparity, refine_disparity, triangle_sum)


class PairProduct(NamedTuple):
    disparity: torch.Tensor   # (H, W) signed px, left-rectified frame
    valid: torch.Tensor       # (H, W) bool
    photo: torch.Tensor       # (H, W) photoconsistency in [0, 1] (0 = good)
    xyz: torch.Tensor         # (H, W, 3) local-frame metres
    height: torch.Tensor      # (H, W) absolute height z (NaN where invalid)
    rel_height: torch.Tensor  # (H, W) plane-relative, ground-zeroed (m)
    rect_left: torch.Tensor   # (H, W) normalised rectified left (-1 outside)
    rect_right: torch.Tensor  # (H, W) normalised rectified right


def required_max_disp(geoms: Sequence[RectifiedGeometry], h_range,
                      margin_px: int = 16) -> int:
    """Smallest /16 search width covering ``h_range`` for all geometries
    (disparity is exactly ``disp_gain * (z - h_mid)``)."""
    span = 0.0
    for g in geoms:
        half = max(abs(h_range[0] - g.h_mid), abs(h_range[1] - g.h_mid))
        span = max(span, abs(g.disp_gain) * half)
    total = 2 * (int(np.ceil(span)) + margin_px)
    return ((total + 15) // 16) * 16


def photoconsistency(left: torch.Tensor, right: torch.Tensor,
                     disparity: torch.Tensor, d_min: int = -160,
                     d_max: int = 160, stride: int = 1) -> torch.Tensor:
    """``|right(y, x - d) - left(y, x)|`` with the right view linearly
    interpolated on the ``stride``-px grid of shifts (:func:`triangle_sum`:
    the reference's scan of triangle-weighted shifted copies of the right
    image, as a gather of the neighbouring grid shifts), 1 where ``x - d``
    leaves the image or ``d`` the range."""
    w = left.shape[1]
    n_grid = len(range(d_min, d_max + stride, stride))
    r = triangle_sum(right, disparity, d_min, n_grid, stride)
    x2 = torch.arange(w, dtype=torch.float32, device=left.device) - disparity
    inb = (x2 >= 0) & (x2 <= w - 1) & (disparity >= d_min) & (disparity <= d_max)
    return torch.where(inb, (r - left).abs(), torch.ones_like(left))


def matcher_inputs(rect1: torch.Tensor, rect2: torch.Tensor,
                   cfg: StereoConfig, pre_normalised: bool = False):
    """What :func:`pair_core` hands the matcher: both rectified images
    normalised (and pre-smoothed), their validity masks shrunk away from
    undefined borders, and the raw masks: ``(n1, n2, v1, v2, mask1,
    mask2)``. ``pre_normalised`` inputs already carry whole-canvas
    normalisation (values in [0, 1], -1 outside) and are only clipped."""
    mask1 = rect1 >= 0
    mask2 = rect2 >= 0
    if pre_normalised:
        n1 = torch.clamp(rect1, 0.0, 1.0)
        n2 = torch.clamp(rect2, 0.0, 1.0)
    else:
        n1, _ = normalise_image(rect1, mask1, subsample=cfg.norm_subsample)
        n2, _ = normalise_image(rect2, mask2, subsample=cfg.norm_subsample)
    if cfg.presmooth_sigma > 0:
        n1 = gaussian_filter(n1, sigma=cfg.presmooth_sigma)
        n2 = gaussian_filter(n2, sigma=cfg.presmooth_sigma)
    v1 = mask1 & ~binary_dilation(~mask1, iterations=cfg.margin_undefined)
    v2 = mask2 & ~binary_dilation(~mask2, iterations=cfg.margin_undefined)
    return n1, n2, v1, v2, mask1, mask2


def pair_core(rect1: torch.Tensor, rect2: torch.Tensor, tri_M: torch.Tensor,
              tri_b: torch.Tensor, cfg: StereoConfig,
              ground_percentile: float = 2.0, cap_percentile: float = 98.0,
              with_plane: bool = True, row0: float = 0.0,
              pre_normalised: bool = False) -> PairProduct:
    """The per-pair compute core on the rectified canvas (see the
    reference's ``pair_core`` for the gate design).

    ``row0`` offsets the triangulation rows, so row-band tiles of one
    canvas triangulate in the canvas frame. ``with_plane=False`` skips the
    plane fit and ``rel_height`` (fusion reads only ``xyz`` and
    ``valid``). ``pre_normalised=True`` takes inputs normalised over the
    whole canvas (see :func:`matcher_inputs`); band tiles need it so
    every band shares one radiometry."""
    n1, n2, v1, v2, mask1, mask2 = matcher_inputs(rect1, rect2, cfg,
                                                  pre_normalised)
    noise_ratio = None
    if cfg.noise_adapt > 0 and cfg.gate_profile != "lr":
        noise_ratio = snr_ratio(n1, mask1)

    if cfg.adapt_band_rows > 0:
        # coarse pass -> tile offsets -> narrow search; disparities come
        # back in global coordinates, photo from the (equivalent) warped
        # frame
        res0, res, photo, _ = banded_disparity(n1, n2, v1, v2, cfg,
                                               noise_ratio=noise_ratio)
    else:
        if cfg.hierarchical:
            res0 = compute_disparity_hierarchical(
                n1, n2, v1, v2, cfg, local_disp=cfg.hierarchical_local_disp)
        else:
            res0 = compute_disparity(n1, n2, v1, v2, cfg, aggregation="sgm",
                                     noise_ratio=noise_ratio)
        res = refine_disparity(res0, n1, cfg)
        photo = photoconsistency(n1, n2, res.disparity,
                                 d_min=cfg.min_disparity,
                                 d_max=cfg.min_disparity + cfg.max_disp - 1,
                                 stride=cfg.disp_stride)
    if cfg.gate_profile == "lr":
        return _finalise_product(res, v1, mask1, mask2, n1, n2, photo, tri_M,
                                 tri_b, row0, with_plane, ground_percentile,
                                 cap_percentile)

    # blunder gates: speckle, discontinuity band, photoconsistency,
    # uniqueness
    med = separable_median_filter(res.disparity, cfg.speckle_median_size)
    speckle_ok = (res.disparity - med).abs() <= cfg.speckle_threshold
    gy, gx = torch.gradient(med)
    edge = torch.hypot(gy, gx) > cfg.edge_grad_threshold
    band = binary_dilation(edge, iterations=cfg.edge_dilation)
    photo_thresh = torch.tensor(cfg.photo_threshold, dtype=torch.float32,
                                device=photo.device)
    if cfg.photo_adapt_factor > 0:
        floor = masked_median_grid(photo, res.valid & v1, 0.0, 2.0)
        photo_thresh = torch.maximum(photo_thresh,
                                     cfg.photo_adapt_factor * floor)
    photo_ok = photo < photo_thresh
    unique_ok = res0.margin > cfg.min_margin
    gated_valid = res.valid & speckle_ok & ~band & photo_ok & unique_ok

    # band recovery: re-admit band pixels that pass independent checks
    if cfg.band_recover and res0.check_disparity is not None:
        agree_thr = torch.tensor(cfg.band_agree_threshold_eff,
                                 dtype=torch.float32, device=photo.device)
        band_margin = torch.tensor(cfg.band_margin_threshold,
                                   dtype=torch.float32, device=photo.device)
        if cfg.noise_adapt > 0 and noise_ratio is not None:
            r01 = torch.clamp((noise_ratio - 0.5) / 0.5, 0.0, 1.0)
            agree_thr = agree_thr + (cfg.noise_adapt * cfg.noise_agree_widen
                                     * r01)
            band_margin = band_margin + (
                cfg.noise_adapt * cfg.noise_margin_ramp
                * torch.clamp((noise_ratio - 0.8) / 0.2, 0.0, 1.0))
        agree = (res.disparity - res0.check_disparity).abs() <= agree_thr
        band_keep = (res0.valid & speckle_ok & photo_ok & band & agree
                     & (res0.margin > band_margin)
                     & (photo < cfg.band_photo_factor * photo_thresh))
        if res0.check_margin is not None and cfg.band_check_margin > 0:
            # the vertical checker's own uniqueness margin
            band_keep = band_keep & (res0.check_margin
                                     > cfg.band_check_margin)
        if cfg.band_core_excl > 0:
            band_keep = band_keep & ~binary_dilation(
                edge, iterations=cfg.band_core_excl)
        gated_valid = gated_valid | band_keep
    res = res._replace(valid=gated_valid)
    return _finalise_product(res, v1, mask1, mask2, n1, n2, photo, tri_M,
                             tri_b, row0, with_plane, ground_percentile,
                             cap_percentile)


def _finalise_product(res, v1, mask1, mask2, n1, n2, photo, tri_M, tri_b,
                      row0, with_plane, ground_percentile, cap_percentile):
    """Triangulation + plane-relative heights + product assembly."""
    xyz = triangulate_from_operator(res.disparity, tri_M, tri_b, row0=row0)
    valid = res.valid & v1
    nan = torch.full_like(res.disparity, float("nan"))
    height = torch.where(valid, xyz[..., 2], nan)
    if with_plane:
        plane = fit_plane(xyz, valid.float())
        rel = plane_relative_height(xyz, plane)
        inf = torch.tensor(float("inf"), device=rel.device)
        rlo = torch.where(valid, rel, inf).amin()
        rhi = torch.where(valid, rel, -inf).amax()
        rlo = torch.where(torch.isfinite(rlo), rlo, torch.zeros_like(rlo))
        rhi = torch.where(torch.isfinite(rhi), torch.maximum(rhi, rlo + 1e-6),
                          torch.ones_like(rhi))
        q0 = masked_quantile_grid(rel, valid, rlo, rhi,
                                  ground_percentile / 100.0)
        q1 = masked_quantile_grid(rel, valid, rlo, rhi,
                                  cap_percentile / 100.0)
        rel = torch.minimum(rel - q0, q1 - q0)
        rel = torch.where(valid, rel, nan)
    else:
        rel = nan
    return PairProduct(
        disparity=res.disparity, valid=valid, photo=photo, xyz=xyz,
        height=height, rel_height=rel,
        rect_left=torch.where(mask1, n1, -1.0),
        rect_right=torch.where(mask2, n2, -1.0))


class HeightMapPipeline:
    """Host orchestration: geometry on the host in float64, the per-pair
    compute on ``device`` (``"cuda"`` runs the CUDA kernels, ``"cpu"``
    their plain versions)."""

    def __init__(self, cfg: PipelineConfig = PipelineConfig(),
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)

    def build_geometry(self, rpc1, rpc2, lon_range, lat_range, shape1,
                       shape2) -> RectifiedGeometry:
        return build_geometry_from_rpcs(
            rpc1, rpc2, lon_range, lat_range, self.cfg.rectify.height_range,
            shape1, shape2, grid=self.cfg.rectify.probe_grid,
            pad_multiple=self.cfg.tiling.pad_multiple)

    def stereo_cfg_for(self, geoms: Sequence[RectifiedGeometry]) -> StereoConfig:
        """Stereo config with the search range sized to the geometry and,
        with ``cfg.metric_gates``, pixel gate thresholds derived from the
        physical ones through the disparity gain (quantised to 5% log
        steps, as in the reference, so nearby geometries share a config)."""
        md = required_max_disp(geoms, self.cfg.rectify.height_range)
        updates = dict(max_disp=md)
        if self.cfg.metric_gates and geoms:
            gain = max(abs(g.disp_gain) for g in geoms)

            def _q(x: float) -> float:
                return float(round(1.05 ** round(math.log(max(x, 1e-6))
                                                 / math.log(1.05)), 4))

            updates["speckle_threshold"] = _q(self.cfg.speckle_threshold_m * gain)
            updates["edge_grad_threshold"] = _q(self.cfg.edge_step_m * gain)
            updates["edge_dilation"] = self.cfg.stereo.block_size + 5
        return dataclasses.replace(self.cfg.stereo, **updates)

    def process_pair(self, img1, img2, geom: RectifiedGeometry,
                     stereo_cfg: Optional[StereoConfig] = None, cache=None,
                     with_plane: bool = True) -> PairProduct:
        """One stereo pair (images as arrays or tensors) -> pair product on
        the pipeline's device.

        ``cache`` (a :class:`pcmi_tpu_torch.utils.cache.StageCache`)
        returns the stored product for identical rectified inputs and
        config instead of recomputing it."""
        cfg = stereo_cfg or self.stereo_cfg_for([geom])
        dev = self.device
        img1 = torch.as_tensor(img1, dtype=torch.float32).to(dev)
        img2 = torch.as_tensor(img2, dtype=torch.float32).to(dev)
        H1 = torch.as_tensor(geom.H1, dtype=torch.float32)
        H2 = torch.as_tensor(geom.H2, dtype=torch.float32)
        r1, r2 = rectify_arrays(img1, img2, H1, H2, geom.out_shape)
        M, b = triangulation_operator(geom)
        M, b = M.to(dev), b.to(dev)
        kwargs = dict(ground_percentile=self.cfg.height_percentiles[0],
                      cap_percentile=self.cfg.height_percentiles[1],
                      with_plane=with_plane)
        if cache is None:
            return pair_core(r1, r2, M, b, cfg, **kwargs)

        def compute():
            out = pair_core(r1, r2, M, b, cfg, **kwargs)
            return {k: v.cpu().numpy() for k, v in out._asdict().items()}

        got = cache.get_or_compute(
            "pair_core", (repr(cfg), repr(sorted(kwargs.items())),
                          *(t.cpu().numpy() for t in (r1, r2, M, b))),
            compute)
        return PairProduct(**{k: torch.from_numpy(v).to(dev)
                              for k, v in got.items()})


def _gumbel_top_k(product: PairProduct, max_points: int,
                  noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``max_points`` pixels of largest ``log(w) + noise`` (all valid
    pixels rank above all invalid ones, a uniform draw among each)."""
    xyz = product.xyz.reshape(-1, 3)
    w = product.valid.reshape(-1).float()
    score = torch.log(torch.clamp(w, min=1e-12)) + noise
    idx = torch.topk(score, max_points).indices
    return xyz[idx], w[idx]


def product_point_cloud(product: PairProduct, max_points: int = 1 << 18,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flatten a pair product into fixed-size (N, 3) points + 0/1 validity
    weights. Invalid pixels stay with weight 0; when the canvas has more
    pixels than ``max_points``, a weighted Gumbel top-k keeps a uniform
    random subset of the valid ones, drawn from ``generator`` (on the
    product's device; by default a fresh one seeded with 0, as the
    reference draws from ``jax.random.PRNGKey(0)``)."""
    n = product.valid.numel()
    if n <= max_points:
        return product.xyz.reshape(-1, 3), product.valid.reshape(-1).float()
    noise = gumbel_noise(n, generator, product.xyz.device)
    return _gumbel_top_k(product, max_points, noise)


class HeightMapExtractor(SatellitePlugin):
    """Plugin adapter: emits the reference's layer set — disparity
    (turbo), photoconsistency, invalid-mask overlay, and a [z, y, x]
    points layer coloured by height. It runs on the device of the
    :class:`HeightMapPipeline` it is given, by default one on ``device``
    (``"cuda"``)."""

    def __init__(self, pipeline: HeightMapPipeline | None = None,
                 device="cuda"):
        self.pipeline = pipeline or HeightMapPipeline(device=device)
        self._sources = None

    @property
    def name(self) -> str:
        return "Multi-day 3D Point Cloud"

    def set_sources(self, images, rpcs, lon_range, lat_range):
        """Attach the acquisition stack (images as arrays or tensors)."""
        self._sources = (list(images), list(rpcs), lon_range, lat_range)

    def run(self, image=None, viewer=None, pair=None, metas=None,
            mode: str = "first", n: int = 1, seed: int = 0) -> List[Layer]:
        """Run one or more pairs and emit their layers.

        ``mode="first"`` takes the best ``n`` selected pairs, ``"random"``
        one random valid pair (``random.Random(seed)``), ``pair=(i, j)``
        an explicit pair. Pairs come from the convergence-angle selector
        when ``metas`` (a list of :class:`ImageMeta`) is given, otherwise
        consecutive indices are used. One stereo config covers all the
        chosen pairs.
        """
        if self._sources is None:
            raise RuntimeError("call set_sources(...) before run()")
        images, rpcs, lon_range, lat_range = self._sources

        if pair is not None:
            chosen = [tuple(pair)]
        elif metas is not None:
            ranked = select_pairs(metas, self.pipeline.cfg.pairs)
            if mode == "random":
                # sample from all valid pairs, not the best-n slice
                valid = [p for p in ranked if p.valid]
                cands = [random.Random(seed).choice(valid)] if valid else []
            else:
                cands = take_pairs(ranked, max(n, 1))
            chosen = [(p.i, p.j) for p in cands]
        else:
            chosen = [(k, k + 1) for k in range(min(n, len(images) - 1))]
        if not chosen:
            raise ValueError("no stereo pairs to process")

        geoms = [
            self.pipeline.build_geometry(
                rpcs[i], rpcs[j], lon_range, lat_range,
                tuple(images[i].shape), tuple(images[j].shape))
            for i, j in chosen
        ]
        stereo_cfg = self.pipeline.stereo_cfg_for(geoms)
        layers: List[Layer] = []
        for (i, j), geom in zip(chosen, geoms):
            product = self.pipeline.process_pair(images[i], images[j], geom,
                                                 stereo_cfg)
            layers.extend(self._product_layers(product, tag=f"{i}-{j}"))
        return layers

    def _product_layers(self, product: PairProduct,
                        tag: str = "") -> List[Layer]:
        suffix = f" [{tag}]" if tag else ""

        disparity = product.disparity.cpu().numpy()
        valid = product.valid.cpu().numpy()
        photo = product.photo.cpu().numpy()
        rel = product.rel_height.cpu().numpy()

        layers: List[Layer] = [
            (np.where(valid, disparity, np.nan),
             {"name": f"disparity{suffix}", "colormap": "turbo"}, "image"),
            (photo, {"name": f"photoconsistency{suffix}", "colormap": "gray"},
             "image"),
            ((~valid).astype(np.uint8),
             {"name": f"invalid mask{suffix}", "opacity": 0.4}, "image"),
        ]
        ys, xs = np.nonzero(valid)
        if len(ys):
            step = max(1, len(ys) // 200_000)
            ys, xs = ys[::step], xs[::step]
            pts = np.stack([rel[ys, xs], ys, xs], axis=1)
            layers.append(
                (pts, {
                    "name": f"point cloud{suffix}",
                    "features": {"height": rel[ys, xs]},
                    "size": 1,
                }, "points")
            )
        return layers
