"""ctypes bindings for the native raster runtime ``native/pcmi_io.cpp``
(port of ``pcmi_tpu/io/native.py``).

The library is a small owned C++ runtime: mmap'd baseline-TIFF decode and
an LRU window cache with prefetch threads. It is compiled at first use
with ``g++`` (a plain C interface bound with ctypes) into
``build/pcmi_tpu_torch/`` beside the package, under a name that carries a
hash of the source and the flags: an edited source builds anew, and an
unchanged one loads the library already there. The compiler writes a
temporary file that is then renamed into place, so processes building at
once never load a half-written library. :func:`read_tiff_fast` falls back
to the pure-Python codec (:mod:`pcmi_tpu_torch.io.raster`, the same
bytes) when the toolchain or the library is unavailable;
:func:`native_error` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

REPO_DIR = Path(__file__).resolve().parents[2]
SOURCE = REPO_DIR / "native" / "pcmi_io.cpp"
BUILD_DIR = REPO_DIR / "build" / "pcmi_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libpcmi_io_{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> Optional[str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except Exception as exc:  # g++ missing etc.
        return f"build spawn failed: {exc}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"g++ failed: {proc.stderr[-400:]}"
    os.replace(tmp, lib)
    return None


def get_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _lib_error
    with _lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        try:
            path = library_path()
        except OSError as exc:  # source missing
            _lib_error = str(exc)
            return None
        if not path.exists():
            err = _build(path)
            if err:
                _lib_error = err
                return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as exc:
            _lib_error = str(exc)
            return None
        lib.pcmi_open.restype = ctypes.c_void_p
        lib.pcmi_open.argtypes = [ctypes.c_char_p]
        lib.pcmi_close.argtypes = [ctypes.c_void_p]
        lib.pcmi_info.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_uint32)]
        lib.pcmi_read_window.restype = ctypes.c_int
        lib.pcmi_read_window.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p,
        ]
        lib.pcmi_loader_create.restype = ctypes.c_void_p
        lib.pcmi_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_uint32,
            ctypes.c_uint64, ctypes.c_int,
        ]
        lib.pcmi_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.pcmi_loader_get.restype = ctypes.c_int
        lib.pcmi_loader_get.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_void_p, ctypes.c_uint64,
        ]
        _lib = lib
        return _lib


def native_error() -> Optional[str]:
    """Why the library is unavailable (None when it loaded or was never
    asked for)."""
    return _lib_error


def _dtype_of(bits: int, fmt: int) -> np.dtype:
    table = {
        (3, 32): np.float32, (3, 64): np.float64,
        (2, 8): np.int8, (2, 16): np.int16, (2, 32): np.int32,
        (1, 8): np.uint8, (1, 16): np.uint16, (1, 32): np.uint32,
    }
    dt = table.get((fmt, bits))
    if dt is None:
        # ValueError (not KeyError) so read_tiff_fast's fallback catches it
        raise ValueError(f"unsupported TIFF sample type: {bits}-bit fmt={fmt}")
    return np.dtype(dt)


class NativeRaster:
    """One open TIFF; windowed reads through the native decoder."""

    def __init__(self, path: str):
        lib = get_library()
        if lib is None:
            raise RuntimeError(f"native io unavailable: {_lib_error}")
        self._lib = lib
        self._h = lib.pcmi_open(path.encode())
        if not self._h:
            raise ValueError(f"{path}: native decoder cannot open "
                             f"(compressed/BigTIFF unsupported)")
        info = (ctypes.c_uint32 * 6)()
        lib.pcmi_info(self._h, info)
        self.width, self.height, self.channels, bits, fmt, self.tiled = (
            int(info[0]), int(info[1]), int(info[2]), int(info[3]),
            int(info[4]), bool(info[5]),
        )
        self.dtype = _dtype_of(bits, fmt)

    def read(self, y0: int = 0, x0: int = 0, h: Optional[int] = None,
             w: Optional[int] = None) -> np.ndarray:
        h = self.height - y0 if h is None else h
        w = self.width - x0 if w is None else w
        out = np.empty((h, w, self.channels), self.dtype)
        rc = self._lib.pcmi_read_window(
            self._h, y0, x0, h, w, out.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise ValueError("window out of bounds")
        return out[:, :, 0] if self.channels == 1 else out

    def close(self):
        if self._h:
            self._lib.pcmi_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TileLoader:
    """Prefetching LRU tile loader over an acquisition stack: pipeline
    stages request (image, tile_y, tile_x) windows; the C++ side caches
    decoded windows and prefetches the 4-neighbourhood on worker
    threads."""

    def __init__(self, paths: Sequence[str], tile: int = 1024,
                 cache_mb: int = 512, threads: int = 2):
        lib = get_library()
        if lib is None:
            raise RuntimeError(f"native io unavailable: {_lib_error}")
        self._lib = lib
        self.tile = tile
        self.rasters = []
        try:
            for p in paths:
                self.rasters.append(NativeRaster(p))
        finally:
            # metadata captured; the loader reopens the files itself. A
            # failing path must not leak the rasters already opened.
            for r in self.rasters:
                r.close()
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._h = lib.pcmi_loader_create(
            arr, len(paths), tile, cache_mb << 20, threads)
        if not self._h:
            raise ValueError("loader creation failed (unsupported input?)")
        self.paths = list(paths)

    def get(self, img: int, ty: int, tx: int) -> np.ndarray:
        r = self.rasters[img]
        y0, x0 = ty * self.tile, tx * self.tile
        h = min(self.tile, r.height - y0)
        w = min(self.tile, r.width - x0)
        if h <= 0 or w <= 0:
            raise IndexError("tile outside image")
        out = np.empty((h, w, r.channels), r.dtype)
        rc = self._lib.pcmi_loader_get(
            self._h, img, ty, tx, out.ctypes.data_as(ctypes.c_void_p),
            out.nbytes)
        if rc < 0:
            raise ValueError(f"loader_get failed rc={rc}")
        return out[:, :, 0] if r.channels == 1 else out

    def close(self):
        if self._h:
            self._lib.pcmi_loader_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_tiff_fast(path: str) -> np.ndarray:
    """Native read with the pure-Python codec as fallback (the same array
    either way)."""
    try:
        with NativeRaster(path) as r:
            return r.read()
    except (RuntimeError, ValueError):
        from pcmi_tpu_torch.io.raster import read_tiff

        return read_tiff(path)
