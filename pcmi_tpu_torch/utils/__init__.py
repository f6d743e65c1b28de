"""Profiling, logging and debug-image helpers of the port
(``pcmi_tpu/utils/__init__.py``'s exports)."""

from pcmi_tpu_torch.utils.profiling import (
    device_trace,
    dump_stats,
    reset_stats,
    scope,
    setup_logging,
    stats,
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
    "dump_stats",
    "reset_stats",
    "scope",
    "setup_logging",
    "stats",
]
