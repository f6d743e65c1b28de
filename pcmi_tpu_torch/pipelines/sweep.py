"""Multi-AOI sweep (port of ``pcmi_tpu/pipelines/sweep.py``).

Runs the multi-day fusion over a list of AOIs, each under a profiling
scope ``aoi:<name>``, with an optional content-addressed stage cache, so
an interrupted sweep resumes: a pair whose rectified inputs and config
are cached is not recomputed. AOIs are independent.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import torch

from pcmi_tpu_torch.config import PipelineConfig
from pcmi_tpu_torch.geometry.pairs import ImageMeta
from pcmi_tpu_torch.pipelines.multiday import FusedCloud, MultiDayFusion
from pcmi_tpu_torch.utils.cache import StageCache
from pcmi_tpu_torch.utils.profiling import scope


@dataclass
class AOISpec:
    name: str
    images: Sequence
    rpcs: Sequence
    metas: Sequence[ImageMeta]
    lon_range: tuple
    lat_range: tuple


@dataclass
class SweepResult:
    fused: Dict[str, FusedCloud] = field(default_factory=dict)
    stats: Dict[str, dict] = field(default_factory=dict)


class MultiAOISweep:
    """:class:`MultiDayFusion` over AOIs on ``device``; ``cache_dir``
    keeps a :class:`StageCache` of the pair products there."""

    def __init__(self, cfg: PipelineConfig = PipelineConfig(),
                 cache_dir: Optional[str] = None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.fusion = MultiDayFusion(cfg, device=device)
        self.cache = StageCache(cache_dir) if cache_dir else None

    def run(self, aois: Sequence[AOISpec], points_per_pair: int = 1 << 16,
            grid_cell: Optional[float] = None,
            with_kmeans: bool = True) -> SweepResult:
        out = SweepResult()
        for aoi in aois:
            with scope(f"aoi:{aoi.name}"):
                fused = self.fusion.run(
                    aoi.images, aoi.rpcs, aoi.metas,
                    aoi.lon_range, aoi.lat_range,
                    points_per_pair=points_per_pair,
                    with_kmeans=with_kmeans, grid_cell=grid_cell,
                    cache=self.cache,
                )
            out.fused[aoi.name] = fused
            out.stats[aoi.name] = {
                "points": int((fused.weights > 0).sum()),
                "dsm_filled": float(torch.isfinite(fused.dsm).float().mean()),
                "icp_rmse_max": float(fused.icp_rmse.max()),
            }
        return out
