"""Raster + point-cloud I/O, dependency-free (port of
``pcmi_tpu/io/raster.py``: numpy and the standard library, the same bytes
on disk).

Replaces the reference's GDAL GTiff open/save (``utils.py:37-52``) and its
filesystem product bus. The runtime image (no tifffile/rasterio/cv2) forced
a from-scratch codec; it reads/writes baseline uncompressed TIFF — strip or
tiled layout, grayscale or multi-band, uint8/uint16/float32/float64 — which
covers every raster the pipeline produces, plus sidecar JSON for geo tags
and binary-little-endian PLY for point clouds.

The C++ fast path (:mod:`pcmi_tpu_torch.io.native`) accelerates big tiled reads;
this module is the always-available pure-Python fallback and the writer.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np

# TIFF tag ids
_T_WIDTH, _T_HEIGHT = 256, 257
_T_BITS, _T_COMPRESSION, _T_PHOTO = 258, 259, 262
_T_STRIP_OFFSETS, _T_SPP, _T_ROWS_PER_STRIP, _T_STRIP_COUNTS = 273, 277, 278, 279
_T_PLANAR = 284
_T_TILE_W, _T_TILE_H, _T_TILE_OFFSETS, _T_TILE_COUNTS = 322, 323, 324, 325
_T_SAMPLE_FORMAT = 339

_FMT_UINT, _FMT_INT, _FMT_FLOAT = 1, 2, 3

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8, 16: 8, 17: 8}


def _dtype_for(bits: int, fmt: int) -> np.dtype:
    if fmt == _FMT_FLOAT:
        return np.dtype({32: np.float32, 64: np.float64}[bits])
    if fmt == _FMT_INT:
        return np.dtype({8: np.int8, 16: np.int16, 32: np.int32}[bits])
    return np.dtype({8: np.uint8, 16: np.uint16, 32: np.uint32}[bits])


def _read_ifd_entries(buf: bytes, off: int, bo: str) -> Dict[int, np.ndarray]:
    (n,) = struct.unpack_from(bo + "H", buf, off)
    entries: Dict[int, np.ndarray] = {}
    for i in range(n):
        tag, typ, count = struct.unpack_from(bo + "HHI", buf, off + 2 + i * 12)
        size = _TYPE_SIZES.get(typ, 1) * count
        if size <= 4:
            raw = buf[off + 2 + i * 12 + 8: off + 2 + i * 12 + 8 + size]
        else:
            (ptr,) = struct.unpack_from(bo + "I", buf, off + 2 + i * 12 + 8)
            raw = buf[ptr: ptr + size]
        np_typ = {1: "u1", 3: "u2", 4: "u4", 6: "i1", 8: "i2", 9: "i4",
                  11: "f4", 12: "f8"}.get(typ)
        if np_typ is None:
            continue
        entries[tag] = np.frombuffer(raw, dtype=bo.replace("<", "<").replace(">", ">") + np_typ)
    return entries


def read_tiff(path: str) -> np.ndarray:
    """Read the first IFD of an uncompressed TIFF (strips or tiles)."""
    with open(path, "rb") as fh:
        buf = fh.read()
    if buf[:2] == b"II":
        bo = "<"
    elif buf[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError(f"{path}: not a TIFF")
    magic, ifd_off = struct.unpack_from(bo + "HI", buf, 2)
    if magic != 42:
        raise ValueError(f"{path}: BigTIFF/unknown magic {magic} unsupported")
    e = _read_ifd_entries(buf, ifd_off, bo)
    w = int(e[_T_WIDTH][0])
    h = int(e[_T_HEIGHT][0])
    spp = int(e.get(_T_SPP, np.array([1]))[0])
    bits = int(e[_T_BITS][0])
    comp = int(e.get(_T_COMPRESSION, np.array([1]))[0])
    if comp != 1:
        raise ValueError(f"{path}: compression {comp} unsupported (baseline only)")
    fmt = int(e.get(_T_SAMPLE_FORMAT, np.array([_FMT_UINT]))[0])
    dt = _dtype_for(bits, fmt).newbyteorder(bo)

    out = np.zeros((h, w, spp), dt)
    if _T_TILE_OFFSETS in e:
        tw = int(e[_T_TILE_W][0])
        th = int(e[_T_TILE_H][0])
        offs = e[_T_TILE_OFFSETS]
        tiles_across = (w + tw - 1) // tw
        for idx, off in enumerate(offs):
            ty, tx = divmod(idx, tiles_across)
            tile = np.frombuffer(
                buf, dt, count=tw * th * spp, offset=int(off)
            ).reshape(th, tw, spp)
            y0, x0 = ty * th, tx * tw
            out[y0: y0 + th, x0: x0 + tw] = tile[
                : max(0, min(th, h - y0)), : max(0, min(tw, w - x0))
            ]
    else:
        offs = e[_T_STRIP_OFFSETS]
        rps = int(e.get(_T_ROWS_PER_STRIP, np.array([h]))[0])
        for idx, off in enumerate(offs):
            y0 = idx * rps
            rows = min(rps, h - y0)
            strip = np.frombuffer(
                buf, dt, count=rows * w * spp, offset=int(off)
            ).reshape(rows, w, spp)
            out[y0: y0 + rows] = strip
    arr = out.astype(dt.newbyteorder("="))
    return arr[:, :, 0] if spp == 1 else arr


# GeoTIFF tags (spec 6.0 + GeoTIFF 1.1) and the GeoKeys the pipeline emits
_T_PIXEL_SCALE = 33550      # ModelPixelScaleTag, DOUBLE[3]
_T_TIEPOINT = 33922         # ModelTiepointTag, DOUBLE[6]
_T_GEO_KEYS = 34735         # GeoKeyDirectoryTag, SHORT[4n]
_GK_MODEL_TYPE = 1024       # 1 projected / 2 geographic
_GK_RASTER_TYPE = 1025      # 1 PixelIsArea
_GK_GEOGRAPHIC_CS = 2048    # EPSG geographic code (4326)
_GK_PROJECTED_CS = 3072     # EPSG projected code (326xx UTM, ...)


def write_tiff(path: str, img: np.ndarray, tags: Optional[dict] = None,
               geo: Optional[dict] = None) -> None:
    """Write an uncompressed little-endian strip TIFF (one strip).

    ``geo`` writes REAL GeoTIFF georeferencing (readable by GDAL/QGIS,
    parity with the reference's ``gdal.Translate`` GTiff outputs):
    ``{"origin": (x0, y0), "scale": (sx, sy), "epsg": 4326}`` — origin is
    the outer corner of pixel (0, 0), ``sy`` positive (north-up row step),
    ``epsg`` a geographic (4326) or projected (e.g. 32632) code; omit
    ``epsg`` for a local/engineering frame (keys then mark the CRS
    user-defined, 32767).

    ``tags`` (RPC dict, crop window, ...) still go to a sidecar
    ``<path>.aux.json`` — structured metadata that has no TIFF tag,
    mirroring the reference's habit of dropping ``.npy`` crop-info next to
    rasters (``preprocessing.py:88-93``).
    """
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, spp = img.shape
    if img.dtype == np.float64:
        img = img.astype(np.float32)
    bits = img.dtype.itemsize * 8
    fmt = _FMT_FLOAT if img.dtype.kind == "f" else (
        _FMT_INT if img.dtype.kind == "i" else _FMT_UINT
    )
    data = img.astype(img.dtype.newbyteorder("<")).tobytes()

    entries = []  # (tag, type, values)
    def add(tag, typ, vals):
        entries.append((tag, typ, vals))

    add(_T_WIDTH, 4, [w])
    add(_T_HEIGHT, 4, [h])
    add(_T_BITS, 3, [bits] * spp)
    add(_T_COMPRESSION, 3, [1])
    add(_T_PHOTO, 3, [1])
    add(_T_STRIP_OFFSETS, 4, [0])       # patched once data_off is known
    add(_T_SPP, 3, [spp])
    add(_T_ROWS_PER_STRIP, 4, [h])
    add(_T_STRIP_COUNTS, 4, [len(data)])
    add(_T_PLANAR, 3, [1])
    add(_T_SAMPLE_FORMAT, 3, [fmt] * spp)
    if geo:
        sx, sy = geo.get("scale", (1.0, 1.0))
        x0, y0 = geo.get("origin", (0.0, 0.0))
        add(_T_PIXEL_SCALE, 12, [float(sx), float(sy), 0.0])
        add(_T_TIEPOINT, 12, [0.0, 0.0, 0.0, float(x0), float(y0), 0.0])
        epsg = geo.get("epsg")
        if epsg is None:
            model, cs_key, cs = 1, _GK_PROJECTED_CS, 32767  # user-defined
        elif 4000 <= int(epsg) < 5000:
            model, cs_key, cs = 2, _GK_GEOGRAPHIC_CS, int(epsg)
        else:
            model, cs_key, cs = 1, _GK_PROJECTED_CS, int(epsg)
        keys = [
            (_GK_MODEL_TYPE, 0, 1, model),
            (_GK_RASTER_TYPE, 0, 1, 1),
            (cs_key, 0, 1, cs),
        ]
        directory = [1, 1, 0, len(keys)]
        for k in keys:
            directory += list(k)
        add(_T_GEO_KEYS, 3, directory)

    # generic layout: header + IFD + next-ptr, then out-of-line values,
    # then pixel data
    n = len(entries)
    ext_base = 8 + 2 + 12 * n + 4
    ext_size = sum(
        _TYPE_SIZES[typ] * len(vals)
        for _, typ, vals in entries
        if _TYPE_SIZES[typ] * len(vals) > 4
    )
    data_off = ext_base + ext_size
    for i, (tag, typ, vals) in enumerate(entries):
        if tag == _T_STRIP_OFFSETS:
            entries[i] = (tag, typ, [data_off])

    pack_char = {3: "H", 4: "I", 12: "d"}
    ext = b""
    out = struct.pack("<HHI", 0x4949, 42, 8)
    out += struct.pack("<H", n)
    for tag, typ, vals in sorted(entries):
        count = len(vals)
        size = _TYPE_SIZES[typ] * count
        if size <= 4:
            raw = struct.pack(f"<{count}{pack_char[typ]}", *vals)
            raw += b"\0" * (4 - len(raw))
            out += struct.pack("<HHI", tag, typ, count) + raw
        else:
            out += struct.pack("<HHII", tag, typ, count, ext_base + len(ext))
            ext += struct.pack(f"<{count}{pack_char[typ]}", *vals)
    out += struct.pack("<I", 0)  # next IFD
    out += ext
    assert len(out) == data_off, (len(out), data_off)
    with open(path, "wb") as fh:
        fh.write(out + data)
    if tags:
        with open(path + ".aux.json", "w", encoding="utf-8") as fh:
            json.dump(tags, fh, default=float)


def read_geo(path: str) -> Optional[dict]:
    """Georeferencing of a (Geo)TIFF written by :func:`write_tiff` (or any
    baseline GeoTIFF): ``{"origin", "scale", "epsg"}``; None if absent."""
    with open(path, "rb") as fh:
        buf = fh.read()  # IFD may sit anywhere (foreign writers put it last)
    if buf[:2] not in (b"II", b"MM"):
        raise ValueError(f"not a TIFF: {path}")
    bo = "<" if buf[:2] == b"II" else ">"
    (off,) = struct.unpack_from(bo + "I", buf, 4)
    entries = _read_ifd_entries(buf, off, bo)
    if _T_PIXEL_SCALE not in entries or _T_TIEPOINT not in entries:
        return None
    scale = entries[_T_PIXEL_SCALE]
    tie = entries[_T_TIEPOINT]
    epsg = None
    if _T_GEO_KEYS in entries:
        d = entries[_T_GEO_KEYS]
        for k in range(4, len(d) - 3, 4):
            if d[k] in (_GK_GEOGRAPHIC_CS, _GK_PROJECTED_CS) \
                    and d[k + 3] != 32767:
                epsg = int(d[k + 3])
    return {
        "origin": (float(tie[3]), float(tie[4])),
        "scale": (float(scale[0]), float(scale[1])),
        "epsg": epsg,
    }


def read_aux(path: str) -> dict:
    aux = path + ".aux.json"
    if os.path.exists(aux):
        with open(aux, "r", encoding="utf-8") as fh:
            return json.load(fh)
    return {}


def write_ply(path: str, points: np.ndarray,
              values: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY export of an (N, 3) cloud (+scalar field)."""
    points = np.asarray(points, np.float32)
    n = len(points)
    props = ["property float x", "property float y", "property float z"]
    if values is not None:
        props.append("property float height")
        body = np.concatenate(
            [points, np.asarray(values, np.float32).reshape(-1, 1)], axis=1
        )
    else:
        body = points
    header = "\n".join(
        ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        + props + ["end_header", ""]
    )
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(np.ascontiguousarray(body, "<f4").tobytes())


def read_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    with open(path, "rb") as fh:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += fh.readline()
        text = header.decode("ascii")
        n = int(next(l for l in text.splitlines() if l.startswith("element vertex")).split()[-1])
        n_props = sum(1 for l in text.splitlines() if l.startswith("property"))
        body = np.frombuffer(fh.read(), "<f4").reshape(n, n_props)
    pts = body[:, :3]
    vals = body[:, 3] if n_props > 3 else None
    return pts, vals
