"""The port's native raster binding (``pcmi_tpu_torch.io.native``), as
``tests/test_native_io.py`` holds the reference's: the C++ decoder against
the Python codec, the multiband case, the tile loader, and where the
library is built."""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pcmi_tpu_torch.io import native
from pcmi_tpu_torch.io.raster import read_tiff, write_tiff

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def lib():
    lib = native.get_library()
    if lib is None:
        pytest.skip(f"native toolchain unavailable: {native.native_error()}")
    return lib


def test_library_lives_under_build_named_by_hash(tmp_path, monkeypatch):
    """``build/pcmi_tpu_torch/libpcmi_io_<hash>.so``: never the reference's
    ``native/build/libpcmi_io.so``, and another source gives another
    name."""
    path = native.library_path()
    assert path.parent == REPO / "build" / "pcmi_tpu_torch"
    assert re.fullmatch(r"libpcmi_io_[0-9a-f]{16}\.so", path.name)
    assert native.SOURCE == REPO / "native" / "pcmi_io.cpp"
    src = tmp_path / "pcmi_io.cpp"
    shutil.copy(native.SOURCE, src)
    monkeypatch.setattr(native, "SOURCE", src)
    assert native.library_path() == path
    with open(src, "a") as fh:
        fh.write("// edited\n")
    assert native.library_path() != path
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path() != path


def test_loaded_library_is_the_hashed_build(lib):
    assert native.native_error() is None
    assert Path(lib._name) == native.library_path()
    assert native.library_path().exists()


def test_processes_building_at_once_load_one_library(tmp_path):
    """Two fresh processes build a fresh copy of the source into one
    directory at once: each compiles to a temporary name and renames it
    into place, so both load a whole library."""
    (tmp_path / "native").mkdir()
    shutil.copy(native.SOURCE, tmp_path / "native" / "pcmi_io.cpp")
    code = (
        "import sys\nfrom pathlib import Path\n"
        "from pcmi_tpu_torch.io import native\n"
        f"root = Path({str(tmp_path)!r})\n"
        "native.SOURCE = root / 'native' / 'pcmi_io.cpp'\n"
        "native.BUILD_DIR = root / 'build'\n"
        "assert native.get_library() is not None, native.native_error()\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        assert p.wait(timeout=300) == 0, p.stderr.read()
    built = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert built == [native.library_path().name]


def test_native_reads_python_written_tiff(tmp_path, lib, rng):
    img = rng.normal(size=(123, 77)).astype(np.float32)
    p = str(tmp_path / "a.tif")
    write_tiff(p, img)
    with native.NativeRaster(p) as r:
        assert (r.height, r.width, r.channels) == (123, 77, 1)
        assert r.dtype == np.float32 and not r.tiled
        np.testing.assert_array_equal(r.read(), img)
        np.testing.assert_array_equal(r.read(10, 20, 30, 40),
                                      img[10:40, 20:60])
        np.testing.assert_array_equal(r.read(10, 20, 30, 40),
                                      read_tiff(p)[10:40, 20:60])
        with pytest.raises(ValueError):
            r.read(100, 0, 30, 10)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_native_multiband(tmp_path, lib, rng, dtype):
    img = rng.uniform(0, 255, (64, 96, 3)).astype(dtype)
    p = str(tmp_path / "b.tif")
    write_tiff(p, img)
    with native.NativeRaster(p) as r:
        assert r.channels == 3 and r.dtype == dtype
        np.testing.assert_array_equal(r.read(), img)
        np.testing.assert_array_equal(r.read(5, 7, 11, 13), img[5:16, 7:20])


def test_tile_loader_windows_and_cache(tmp_path, lib, rng):
    imgs, paths = [], []
    for i in range(2):
        img = rng.normal(size=(300, 260)).astype(np.float32)
        p = str(tmp_path / f"s{i}.tif")
        write_tiff(p, img)
        imgs.append(img)
        paths.append(p)
    with native.TileLoader(paths, tile=128, cache_mb=8, threads=1) as ld:
        t00 = ld.get(0, 0, 0)
        np.testing.assert_array_equal(t00, imgs[0][:128, :128])
        t21 = ld.get(1, 2, 1)  # bottom partial tile: rows 256:300
        np.testing.assert_array_equal(t21, imgs[1][256:300, 128:256])
        # a repeated get hits the cache and stays identical
        np.testing.assert_array_equal(ld.get(0, 0, 0), t00)
        with pytest.raises(IndexError):
            ld.get(0, 9, 0)


def test_read_tiff_fast_matches_python_codec(tmp_path, rng):
    img = rng.normal(size=(50, 60)).astype(np.float32)
    p = str(tmp_path / "c.tif")
    write_tiff(p, img)
    np.testing.assert_array_equal(native.read_tiff_fast(p), img)


def test_read_tiff_fast_falls_back_without_library(tmp_path, rng,
                                                    monkeypatch):
    """Without the library the Python codec gives the same array, and
    ``native_error`` says why the native path did not run."""
    img = rng.uniform(0, 65535, (20, 30)).astype(np.uint16)
    p = str(tmp_path / "d.tif")
    write_tiff(p, img)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_error", "g++ failed: test")
    assert native.get_library() is None
    assert native.native_error() == "g++ failed: test"
    np.testing.assert_array_equal(native.read_tiff_fast(p), img)
    with pytest.raises(RuntimeError, match="native io unavailable"):
        native.NativeRaster(p)
