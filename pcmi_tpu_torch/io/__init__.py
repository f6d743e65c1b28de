"""Host-side I/O of the port: rasters, point clouds, NITF/RPC metadata,
KML AOIs (``pcmi_tpu/io/__init__.py``'s exports)."""

from pcmi_tpu_torch.io.kml import kml_extent, parse_kml_polygons
from pcmi_tpu_torch.io.nitf import (
    NITFMetadata, parse_nitf_tres, parse_rpc_sidecar)
from pcmi_tpu_torch.io.raster import (
    read_aux,
    read_ply,
    read_tiff,
    write_ply,
    write_tiff,
)
from pcmi_tpu_torch.io.native import (
    NativeRaster,
    TileLoader,
    read_tiff_fast,
)
from pcmi_tpu_torch.io.crop import (
    CropWindow,
    crop_window_from_extent,
    crop_window_from_kml,
    shift_rpc,
)

__all__ = [
    "kml_extent",
    "parse_kml_polygons",
    "NITFMetadata",
    "parse_nitf_tres",
    "parse_rpc_sidecar",
    "read_aux",
    "read_ply",
    "read_tiff",
    "write_ply",
    "write_tiff",
    "CropWindow",
    "crop_window_from_extent",
    "crop_window_from_kml",
    "shift_rpc",
    "NativeRaster",
    "TileLoader",
    "read_tiff_fast",
]
