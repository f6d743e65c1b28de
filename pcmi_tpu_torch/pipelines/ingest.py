"""Acquisition discovery + ingest: a directory of rasters -> pipeline
inputs (port of ``pcmi_tpu/pipelines/ingest.py``).

Discovery accepts NITF (metadata TREs + uncompressed or JPEG2000 image)
and TIFF (+ ``.RPB`` / ``_RPC.TXT`` sidecar, ``.aux.json`` tags), and
produces :class:`Acquisition` records with RPC cameras and view metadata.
:func:`prepare_aoi_stack` crops every image to a shared KML AOI through
the RPC projection. Images stay host numpy arrays:
:class:`~pcmi_tpu_torch.pipelines.height_map.HeightMapPipeline` moves
them to its device.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from pcmi_tpu_torch.geometry.pairs import ImageMeta
from pcmi_tpu_torch.geometry.rpc import RPCCamera
from pcmi_tpu_torch.io.crop import crop_window_from_extent, shift_rpc
from pcmi_tpu_torch.io.kml import kml_extent
from pcmi_tpu_torch.io.native import NativeRaster, read_tiff_fast
from pcmi_tpu_torch.io.nitf import (
    NITFMetadata, nitf_image_info, parse_rpc_sidecar, read_nitf_image)
from pcmi_tpu_torch.io.raster import read_aux

_NITF = (".ntf", ".nitf")


@dataclass
class Acquisition:
    path: str
    meta: NITFMetadata
    shape: Tuple[int, int]

    def load(self) -> np.ndarray:
        if self.path.lower().endswith(_NITF):
            return np.asarray(read_nitf_image(self.path), np.float32)
        return np.asarray(read_tiff_fast(self.path), np.float32)

    def load_window(self, win) -> np.ndarray:
        """Crop-window read: native windowed decode for TIFFs (no full
        read), full decode + slice otherwise."""
        if not self.path.lower().endswith(_NITF):
            try:
                with NativeRaster(self.path) as r:
                    return np.asarray(
                        r.read(win.y_off, win.x_off, win.height, win.width),
                        np.float32)
            except (RuntimeError, ValueError):
                pass
        return self.load()[win.slices]


def _tiff_shape(path: str) -> Optional[Tuple[int, int]]:
    """Header-only shape probe (native decoder); None -> caller falls back."""
    try:
        with NativeRaster(path) as r:
            return (r.height, r.width)
    except (RuntimeError, ValueError):
        return None


def _sidecar_rpc(path: str) -> Optional[RPCCamera]:
    base, _ = os.path.splitext(path)
    for cand in (base + ".RPB", base + ".rpb", base + "_RPC.TXT",
                 base + "_rpc.txt"):
        if os.path.exists(cand):
            with open(cand, "r", encoding="utf-8", errors="replace") as fh:
                tags = parse_rpc_sidecar(fh.read())
            if tags:
                return RPCCamera.from_dict(tags)
    return None


def discover_acquisitions(directory: str,
                          patterns=("*.ntf", "*.NTF", "*.tif", "*.TIF",
                                    "*.tiff", "*.TIFF")
                          ) -> List[Acquisition]:
    """Scan a directory for acquisitions with usable metadata (sorted by
    path; unreadable files and files without an RPC are skipped)."""
    out: List[Acquisition] = []
    paths: List[str] = []
    for pat in patterns:
        paths.extend(glob.glob(os.path.join(directory, pat)))
    for path in sorted(set(paths)):
        try:
            if path.lower().endswith(_NITF):
                meta = NITFMetadata.from_file(path)
                info = nitf_image_info(path)   # header-only shape probe
                shape = (int(info["nrows"]), int(info["ncols"]))
            else:
                rpc = _sidecar_rpc(path)
                if rpc is None:
                    continue
                aux = read_aux(path)
                meta = NITFMetadata(
                    incidence_deg=float(aux.get("incidence_deg", 0.0)),
                    azimuth_deg=float(aux.get("azimuth_deg", 0.0)),
                    datetime_str=str(aux.get("idatim", "")),
                    rpc=rpc, path=path,
                )
                shape = _tiff_shape(path)
                if shape is None:  # native decoder unavailable: full read
                    shape = np.asarray(read_tiff_fast(path)).shape[:2]
            if meta.rpc is None:
                continue
            out.append(Acquisition(path=path, meta=meta, shape=shape))
        except (ValueError, OSError):
            continue  # unreadable file: skip, don't crash the scan
    return out


def prepare_aoi_stack(
    acquisitions: Sequence[Acquisition],
    kml_path: Optional[str] = None,
    lon_range: Optional[Tuple[float, float]] = None,
    lat_range: Optional[Tuple[float, float]] = None,
    pad: int = 64,
    align: int = 64,
):
    """Crop every acquisition to the AOI; returns ``(images, rpcs, metas,
    lon_range, lat_range)``.

    Windows come from the RPC projection of the AOI corners (acquisitions
    the AOI misses are left out), RPCs are shifted to the crop frame, and
    the cropped pixels stay host float32 arrays.
    """
    if kml_path:
        lon_range, lat_range = kml_extent(kml_path)
    if lon_range is None or lat_range is None:
        raise ValueError("need kml_path or lon/lat ranges")

    images, rpcs, metas = [], [], []
    for acq in acquisitions:
        try:
            win = crop_window_from_extent(
                acq.meta.rpc, lon_range, lat_range, acq.shape,
                pad=pad, align=align,
            )
        except ValueError:
            continue  # AOI outside this acquisition
        images.append(acq.load_window(win))
        rpcs.append(shift_rpc(acq.meta.rpc, win))
        metas.append(ImageMeta(
            index=len(images) - 1,
            incidence_deg=acq.meta.incidence_deg,
            azimuth_deg=acq.meta.azimuth_deg,
            date=acq.meta.date_days,
            name=os.path.basename(acq.path),
        ))
    return images, rpcs, metas, lon_range, lat_range
