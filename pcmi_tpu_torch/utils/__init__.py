"""Tracing, logging and debug-image helpers of the port."""

from pcmi_tpu_torch.utils.profiling import (
    device_trace,
    profiler_offset_ns,
    recording,
    setup_logging,
    span,
    spans,
)
from pcmi_tpu_torch.utils.visualize import (
    normalise_for_display,
    render,
    save_disparity,
    save_image,
    turbo_colormap,
)

__all__ = [
    "normalise_for_display",
    "render",
    "save_disparity",
    "save_image",
    "turbo_colormap",
    "device_trace",
    "profiler_offset_ns",
    "recording",
    "setup_logging",
    "span",
    "spans",
]
