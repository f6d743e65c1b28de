"""AOI crop windows from KML + RPC (port of ``pcmi_tpu/io/crop.py``) —
replaces the GDAL RPC transformer path.

The AOI's four corners are projected to pixels through the RPC forward
model (host float64) at a given height and clamped to the image bounds;
the crop itself is an array slice.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from pcmi_tpu_torch.geometry.rpc import RPCCamera
from pcmi_tpu_torch.io.kml import kml_extent


@dataclass(frozen=True)
class CropWindow:
    """(x_off, y_off, width, height) in pixels."""

    x_off: int
    y_off: int
    width: int
    height: int

    @property
    def slices(self) -> Tuple[slice, slice]:
        return (slice(self.y_off, self.y_off + self.height),
                slice(self.x_off, self.x_off + self.width))

    def as_list(self):
        # [x0, y0, x1, y1, 0, 0, 0, 0], the crop record beside a raster
        return [self.x_off, self.y_off, self.x_off + self.width,
                self.y_off + self.height, 0, 0, 0, 0]


def crop_window_from_extent(
    rpc: RPCCamera,
    lon_range: Tuple[float, float],
    lat_range: Tuple[float, float],
    image_shape: Tuple[int, int],
    height: float = 0.0,
    pad: int = 0,
    align: int = 1,
) -> CropWindow:
    """Project the AOI corners through the RPC and clamp to image bounds.

    ``pad`` adds margin pixels first; ``align`` then rounds the window's
    origin down and its far corner up to a multiple.
    """
    lons = [lon_range[0], lon_range[0], lon_range[1], lon_range[1]]
    lats = [lat_range[0], lat_range[1], lat_range[0], lat_range[1]]
    col, row = rpc.project_np(np.asarray(lons), np.asarray(lats),
                              np.full(4, height))
    h, w = image_shape
    x0 = max(0, int(np.floor(col.min())) - pad)
    y0 = max(0, int(np.floor(row.min())) - pad)
    x1 = min(w, int(np.ceil(col.max())) + pad)
    y1 = min(h, int(np.ceil(row.max())) + pad)
    if x1 <= x0 or y1 <= y0:
        raise ValueError("AOI does not intersect the image")
    if align > 1:
        x0 = (x0 // align) * align
        y0 = (y0 // align) * align
        x1 = min(w, ((x1 + align - 1) // align) * align)
        y1 = min(h, ((y1 + align - 1) // align) * align)
    return CropWindow(x_off=x0, y_off=y0, width=x1 - x0, height=y1 - y0)


def crop_window_from_kml(
    rpc: RPCCamera, kml_path: str, image_shape, height: float = 0.0,
    pad: int = 0, align: int = 1,
) -> CropWindow:
    lon_range, lat_range = kml_extent(kml_path)
    return crop_window_from_extent(rpc, lon_range, lat_range, image_shape,
                                   height, pad, align)


def shift_rpc(rpc: RPCCamera, window: CropWindow) -> RPCCamera:
    """RPC for the cropped image: the pixel offsets shift by the window
    origin. The float32 fields subtract in float32, as the reference's;
    the float64 originals (exact in float64) shift with them."""
    f64 = None
    if rpc.f64 is not None:
        f64 = dict(rpc.f64)
        f64["SAMP_OFF"] = f64["SAMP_OFF"] - window.x_off
        f64["LINE_OFF"] = f64["LINE_OFF"] - window.y_off
    return dataclasses.replace(
        rpc,
        samp_off=rpc.samp_off - torch.tensor(window.x_off,
                                             dtype=torch.float32),
        line_off=rpc.line_off - torch.tensor(window.y_off,
                                             dtype=torch.float32),
        f64=f64)
