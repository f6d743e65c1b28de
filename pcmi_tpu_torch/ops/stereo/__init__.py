"""Dense stereo matching of the port: the matcher on its CUDA kernels, the
banded and coarse-to-fine matchers (``pcmi_tpu/ops/stereo/__init__.py``'s
exports). Importing it neither builds nor loads the kernel library: that
happens at the first launch."""

from pcmi_tpu_torch.ops.stereo.matching import (
    DisparityResult,
    build_cost_volume,
    census_transform,
    compute_disparity,
    derive_right_volume,
    lr_consistency,
    refine_disparity,
    sgm_aggregate,
    wta_disparity,
)
from pcmi_tpu_torch.ops.stereo.banded import banded_disparity, window_coverage
from pcmi_tpu_torch.ops.stereo.hierarchical import (
    compute_disparity_hierarchical,
)

__all__ = [
    "DisparityResult",
    "banded_disparity",
    "window_coverage",
    "build_cost_volume",
    "census_transform",
    "compute_disparity",
    "compute_disparity_hierarchical",
    "derive_right_volume",
    "lr_consistency",
    "refine_disparity",
    "sgm_aggregate",
    "wta_disparity",
]
