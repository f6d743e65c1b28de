"""Shared array ops of the port (``pcmi_tpu/ops/__init__.py``'s exports)."""

from pcmi_tpu_torch.ops.normalize import (
    normalise_image,
    percentile_stretch,
    robust_bounds,
)
from pcmi_tpu_torch.ops.filters import (
    box_filter,
    gaussian_filter,
    gaussian_kernel1d,
    guided_filter,
)
from pcmi_tpu_torch.ops.morphology import (
    binary_closing,
    binary_dilation,
    binary_erosion,
    grey_erosion,
    distance_transform,
)
from pcmi_tpu_torch.ops.warp import (
    affine_warp,
    homography_warp,
    map_coordinates,
)

__all__ = [
    "normalise_image",
    "percentile_stretch",
    "robust_bounds",
    "box_filter",
    "gaussian_filter",
    "gaussian_kernel1d",
    "guided_filter",
    "binary_closing",
    "binary_dilation",
    "binary_erosion",
    "grey_erosion",
    "distance_transform",
    "affine_warp",
    "homography_warp",
    "map_coordinates",
]
