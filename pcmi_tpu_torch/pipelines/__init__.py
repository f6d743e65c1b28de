"""User-facing pipelines of the port."""

from pcmi_tpu_torch.pipelines.height_map import (
    HeightMapPipeline,
    PairProduct,
    pair_core,
    product_point_cloud,
    required_max_disp,
)
from pcmi_tpu_torch.pipelines.multiday import (
    FusedCloud,
    MultiDayFusion,
    fused_consistency_dsm,
)
from pcmi_tpu_torch.pipelines.streaming import StreamingAOIPipeline

__all__ = [
    "HeightMapPipeline",
    "PairProduct",
    "pair_core",
    "product_point_cloud",
    "required_max_disp",
    "FusedCloud",
    "MultiDayFusion",
    "fused_consistency_dsm",
    "StreamingAOIPipeline",
]
