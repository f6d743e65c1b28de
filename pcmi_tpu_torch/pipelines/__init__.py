"""User-facing pipelines of the port."""

from pcmi_tpu_torch.pipelines.height_map import (
    HeightMapExtractor,
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
from pcmi_tpu_torch.pipelines.sweep import AOISpec, MultiAOISweep
from pcmi_tpu_torch.pipelines.saliency import SaliencyDetector
from pcmi_tpu_torch.pipelines.restoration import (
    RestorationEngine, RestorationPlugin)
from pcmi_tpu_torch.pipelines.stitching import (
    ImageStitcher, ImageStitchingPlugin)
from pcmi_tpu_torch.pipelines.landuse import (
    OBIAClassifier, LandUseClassificationPlugin)
from pcmi_tpu_torch.pipelines.detection import (
    ObjectDetector, ObjectAnnotationPlugin)
from pcmi_tpu_torch.pipelines.superres import (
    InpaintingPlugin, SuperResolutionPlugin)
from pcmi_tpu_torch.pipelines.generative import (
    EnhancementProcessor,
    ImageRestorationProcessor,
    RestorationGenerativePlugin,
    StitchingProcessor,
    available_engines,
)

__all__ = [
    "HeightMapExtractor",
    "HeightMapPipeline",
    "PairProduct",
    "pair_core",
    "product_point_cloud",
    "required_max_disp",
    "FusedCloud",
    "MultiDayFusion",
    "fused_consistency_dsm",
    "StreamingAOIPipeline",
    "AOISpec",
    "MultiAOISweep",
    "SaliencyDetector",
    "RestorationEngine",
    "RestorationPlugin",
    "ImageStitcher",
    "ImageStitchingPlugin",
    "OBIAClassifier",
    "LandUseClassificationPlugin",
    "ObjectDetector",
    "ObjectAnnotationPlugin",
    "InpaintingPlugin",
    "SuperResolutionPlugin",
    "EnhancementProcessor",
    "ImageRestorationProcessor",
    "RestorationGenerativePlugin",
    "StitchingProcessor",
    "available_engines",
]
