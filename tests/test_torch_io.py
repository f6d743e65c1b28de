"""The port's host I/O (``pcmi_tpu_torch.io``) against ``pcmi_tpu.io``.

Both packages write the same bytes for the same arrays and RPC, and each
reads the other's files to equal arrays and metadata. Inputs are numpy
draws from a seed; the port's RPC camera comes from the reference's
float64 tag dict through ``convert.rpc_from_reference``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ntf import assert_same_rpc
from pcmi_tpu.geometry.rpc import RPCCamera as JRPCCamera
from pcmi_tpu.io import crop as jcrop
from pcmi_tpu.io import jp2k as jjp2k
from pcmi_tpu.io import kml as jkml
from pcmi_tpu.io import nitf as jnitf
from pcmi_tpu.io import raster as jraster
from pcmi_tpu.io import sentinel as jsentinel
from pcmi_tpu.ops.normalize import percentile_stretch as jpercentile_stretch
from pcmi_tpu_torch import convert
from pcmi_tpu_torch.io import crop as tcrop
from pcmi_tpu_torch.io import jp2k as tjp2k
from pcmi_tpu_torch.io import kml as tkml
from pcmi_tpu_torch.io import nitf as tnitf
from pcmi_tpu_torch.io import raster as traster
from pcmi_tpu_torch.io import sentinel as tsentinel

torch.set_num_threads(1)

PACKAGES = {"ref": (jraster, jnitf), "port": (traster, tnitf)}
CROSS = [("ref", "port"), ("port", "ref")]


def _rpc_dict(seed: int) -> dict:
    """An RPC00B tag dict whose fields fit the TRE's fixed widths: offsets
    and scales at the TRE's own precision, small random higher-order
    coefficients."""
    rng = np.random.default_rng(seed)
    num_r = np.zeros(20)
    num_c = np.zeros(20)
    num_r[:4] = [-0.01, 0.05, -1.0, 0.02]
    num_c[:4] = [0.02, 1.0, 0.03, -0.04]
    num_r[4:] = rng.normal(0, 1e-3, 16)
    num_c[4:] = rng.normal(0, 1e-3, 16)
    den = np.zeros(20)
    den[0] = 1.0
    den[1:4] = rng.normal(0, 1e-4, 3)
    return dict(LINE_OFF=512.0, SAMP_OFF=640.0, LAT_OFF=-34.49,
                LONG_OFF=-58.58, HEIGHT_OFF=25.0, LINE_SCALE=600.0,
                SAMP_SCALE=700.0, LAT_SCALE=0.01, LONG_SCALE=0.012,
                HEIGHT_SCALE=50.0, LINE_NUM_COEFF=num_r,
                LINE_DEN_COEFF=den.copy(), SAMP_NUM_COEFF=num_c,
                SAMP_DEN_COEFF=den.copy())


def _cams(seed: int):
    d = _rpc_dict(seed)
    return JRPCCamera.from_dict(d), convert.rpc_from_reference(d)


# ---------------------------------------------------------------------------
# TIFF, GeoTIFF, aux tags, PLY
# ---------------------------------------------------------------------------

GEOS = [None, {"origin": (11.25, 47.5), "scale": (1e-5, -1e-5), "epsg": 4326},
        {"origin": (100.0, 250.0), "scale": (1.0, 1.0)},
        {"origin": (500000.0, 4e6), "scale": (0.5, 0.5), "epsg": 32632}]


def _image(kind: str, rng) -> np.ndarray:
    if kind == "rgb":
        return rng.normal(size=(20, 31, 3)).astype(np.float32)
    if kind == "float64":
        return rng.normal(size=(17, 9))
    return rng.uniform(0, 255, (37, 53)).astype(kind)


@pytest.mark.parametrize("kind", ["uint8", "uint16", "float32", "float64",
                                  "rgb"])
@pytest.mark.parametrize("geo", range(len(GEOS)))
def test_write_tiff_bytes_identical(tmp_path, rng, kind, geo):
    img = _image(kind, rng)
    tags = {"note": 1.5, "window": [1, 2, 3, 4]}
    paths = {}
    for name, (raster, _) in PACKAGES.items():
        paths[name] = str(tmp_path / f"{name}.tif")
        raster.write_tiff(paths[name], img, tags=tags, geo=GEOS[geo])
    with open(paths["ref"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    with open(paths["ref"] + ".aux.json") as a, \
            open(paths["port"] + ".aux.json") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("writer,reader", CROSS)
def test_tiff_cross_read(tmp_path, rng, writer, reader):
    wr, rd = PACKAGES[writer][0], PACKAGES[reader][0]
    for kind, geo in (("uint16", GEOS[1]), ("rgb", GEOS[3]),
                      ("float32", None)):
        img = _image(kind, rng)
        p = str(tmp_path / f"{kind}.tif")
        wr.write_tiff(p, img, tags={"incidence_deg": 12.5}, geo=geo)
        back = rd.read_tiff(p)
        assert back.dtype == img.dtype
        np.testing.assert_array_equal(back, img)
        assert rd.read_geo(p) == (None if geo is None else wr.read_geo(p))
        assert rd.read_aux(p) == {"incidence_deg": 12.5}
    assert rd.read_aux(str(tmp_path / "missing.tif")) == {}


@pytest.mark.parametrize("with_values", [False, True])
def test_write_ply_bytes_identical_and_cross_read(tmp_path, rng, with_values):
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    vals = rng.normal(size=100).astype(np.float32) if with_values else None
    for name, (raster, _) in PACKAGES.items():
        raster.write_ply(str(tmp_path / f"{name}.ply"), pts, vals)
    assert (tmp_path / "ref.ply").read_bytes() == \
        (tmp_path / "port.ply").read_bytes()
    for writer, reader in CROSS:
        p2, v2 = PACKAGES[reader][0].read_ply(str(tmp_path / f"{writer}.ply"))
        np.testing.assert_array_equal(p2, pts)
        if with_values:
            np.testing.assert_array_equal(v2, vals)
        else:
            assert v2 is None


# ---------------------------------------------------------------------------
# KML
# ---------------------------------------------------------------------------

KML = """<?xml version="1.0" encoding="UTF-8"?>
<kml xmlns="http://www.opengis.net/kml/2.2"><Document>
<Placemark><Polygon><outerBoundaryIs><LinearRing><coordinates>
-58.59,-34.495,0 -58.58,-34.495,0 -58.58,-34.485,0 -58.59,-34.485,0 -58.59,-34.495,0
</coordinates></LinearRing></outerBoundaryIs></Polygon></Placemark>
<Placemark><Polygon><outerBoundaryIs><LinearRing><coordinates>
-58.60,-34.50 -58.595,-34.50 -58.595,-34.49
</coordinates></LinearRing></outerBoundaryIs></Polygon></Placemark>
<Placemark><LineString><coordinates>1,2 3,4</coordinates></LineString></Placemark>
</Document></kml>"""


@pytest.mark.parametrize("from_file", [False, True])
def test_kml_agrees(tmp_path, from_file):
    src = KML
    if from_file:
        src = str(tmp_path / "aoi.kml")
        with open(src, "w", encoding="utf-8") as fh:
            fh.write(KML)
    assert tkml.parse_kml_polygons(src) == jkml.parse_kml_polygons(src)
    assert len(tkml.parse_kml_polygons(src)) == 2
    assert tkml.kml_extent(src) == jkml.kml_extent(src) == \
        ((-58.60, -58.58), (-34.50, -34.485))
    empty = '<kml xmlns="http://www.opengis.net/kml/2.2"><Document/></kml>'
    for mod in (tkml, jkml):
        with pytest.raises(ValueError):
            mod.kml_extent(empty)


# ---------------------------------------------------------------------------
# RPC sidecars, TREs, NITF
# ---------------------------------------------------------------------------

def _rpc_txt(d: dict) -> str:
    lines = [f"{k}: {d[k]:+.8f}" for k in (
        "LINE_OFF", "SAMP_OFF", "LAT_OFF", "LONG_OFF", "HEIGHT_OFF",
        "LINE_SCALE", "SAMP_SCALE", "LAT_SCALE", "LONG_SCALE",
        "HEIGHT_SCALE")]
    for k in ("LINE_NUM_COEFF", "LINE_DEN_COEFF", "SAMP_NUM_COEFF",
              "SAMP_DEN_COEFF"):
        lines += [f"{k}_{i + 1}: {v:+.9E}" for i, v in enumerate(d[k])]
    return "\n".join(lines)


def _rpb(d: dict) -> str:
    keys = {"lineOffset": "LINE_OFF", "sampOffset": "SAMP_OFF",
            "latOffset": "LAT_OFF", "longOffset": "LONG_OFF",
            "heightOffset": "HEIGHT_OFF", "lineScale": "LINE_SCALE",
            "sampScale": "SAMP_SCALE", "latScale": "LAT_SCALE",
            "longScale": "LONG_SCALE", "heightScale": "HEIGHT_SCALE"}
    out = ["satId = \"WV03\";", "BEGIN_GROUP = IMAGE"]
    out += [f"\t{k} = {d[v]:+.6f};" for k, v in keys.items()]
    for k, v in (("lineNumCoef", "LINE_NUM_COEFF"),
                 ("lineDenCoef", "LINE_DEN_COEFF"),
                 ("sampNumCoef", "SAMP_NUM_COEFF"),
                 ("sampDenCoef", "SAMP_DEN_COEFF")):
        out.append(f"\t{k} = (" + ",\n".join(f"{c:+.12E}" for c in d[v])
                   + ");")
    return "\n".join(out + ["END_GROUP = IMAGE", "END;"])


@pytest.mark.parametrize("form", ["txt", "rpb"])
def test_rpc_sidecar_agrees(form):
    d = _rpc_dict(3)
    text = _rpc_txt(d) if form == "txt" else _rpb(d)
    jt, tt = jnitf.parse_rpc_sidecar(text), tnitf.parse_rpc_sidecar(text)
    assert set(jt) == set(tt) and len(tt) == 14
    for k in jt:
        np.testing.assert_array_equal(np.asarray(tt[k]), np.asarray(jt[k]))
    assert_same_rpc(JRPCCamera.from_dict(jt),
                     tnitf.RPCCamera.from_dict(tt))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tre_bytes_identical(seed):
    jcam, tcam = _cams(seed)
    assert_same_rpc(jcam, tcam)
    assert tnitf.rpc00b_tre(tcam) == jnitf.rpc00b_tre(jcam)
    assert tnitf.rpc00b_tre(tcam, err_bias=1.25) == \
        jnitf.rpc00b_tre(jcam, err_bias=1.25)
    inc, az = 10.0 + 7.3 * seed, 80.0 + 101.7 * seed
    assert tnitf.use00a_tre(inc) == jnitf.use00a_tre(inc)
    assert tnitf.csexra_tre(inc, az) == jnitf.csexra_tre(inc, az)


def _nitf_inputs(rng, kind: str):
    if kind == "multi":
        return [rng.integers(0, 2048, (40, 56), dtype=np.uint16),
                rng.integers(0, 256, (20, 28), dtype=np.uint8)]
    if kind == "float32":
        return rng.normal(size=(33, 47)).astype(np.float32)
    return rng.integers(0, np.iinfo(kind).max, (33, 47), dtype=kind)


@pytest.mark.parametrize("kind", ["uint8", "uint16", "float32", "multi"])
def test_write_nitf_bytes_identical(tmp_path, rng, kind):
    img = _nitf_inputs(rng, kind)
    jcam, tcam = _cams(4)
    tres = {"ref": jnitf.rpc00b_tre(jcam) + jnitf.use00a_tre(18.5)
            + jnitf.csexra_tre(18.5, 132.7),
            "port": tnitf.rpc00b_tre(tcam) + tnitf.use00a_tre(18.5)
            + tnitf.csexra_tre(18.5, 132.7)}
    assert tres["ref"] == tres["port"]
    for name, (_, nitf) in PACKAGES.items():
        nitf.write_nitf(str(tmp_path / f"{name}.ntf"), img, tres=tres[name],
                        idatim="20190402110425")
    assert (tmp_path / "ref.ntf").read_bytes() == \
        (tmp_path / "port.ntf").read_bytes()


@pytest.mark.parametrize("writer,reader", CROSS)
def test_nitf_cross_read(tmp_path, rng, writer, reader):
    wn, rn = PACKAGES[writer][1], PACKAGES[reader][1]
    jcam, tcam = _cams(5)
    cam = jcam if writer == "ref" else tcam
    imgs = _nitf_inputs(rng, "multi")
    p = str(tmp_path / "x.ntf")
    wn.write_nitf(p, imgs, tres=wn.rpc00b_tre(cam) + wn.use00a_tre(24.5)
                  + wn.csexra_tre(24.5, 132.7), idatim="20190402110425")

    tags = rn.parse_nitf_tres(p)
    assert tags == wn.parse_nitf_tres(p)
    assert tags["IDATIM"] == "20190402110425"
    assert tags["OBL_ANG"] == tags["OBLIQUITY_ANGLE"] == 24.5
    assert tags["AZ_OF_OBLIQUITY"] == 132.7
    for seg, img in enumerate(imgs):
        info = rn.nitf_image_info(p, segment=seg)
        assert info == wn.nitf_image_info(p, segment=seg)
        assert (info["nrows"], info["ncols"], info["n_segments"]) == \
            (*img.shape, 2)
        np.testing.assert_array_equal(rn.read_nitf_image(p, segment=seg), img)
    for a, b in zip(rn.read_nitf_segments(p), imgs):
        np.testing.assert_array_equal(a, b)

    meta, other = rn.NITFMetadata.from_file(p), wn.NITFMetadata.from_file(p)
    assert (meta.incidence_deg, meta.azimuth_deg, meta.datetime_str,
            meta.date_days) == (other.incidence_deg, other.azimuth_deg,
                                other.datetime_str, other.date_days)
    assert meta.date_days > 7000
    np.testing.assert_array_equal(meta.get_view_vector(),
                                  other.get_view_vector())
    jm, tm = (meta, other) if reader == "ref" else (other, meta)
    assert_same_rpc(jm.rpc, tm.rpc)


def test_nitf_header_scan_and_errors(tmp_path):
    """The TRE scan over a hand-built blob (fields at the STDI-0002
    offsets) and the refusals of both packages agree."""
    use00a = (" " * 21 + "24.50" + " " * 81).encode("ascii")[:107]
    csexra = (" " * 91 + "024.50" + "0132.70" + " " * 30).encode("ascii")
    blob = (b"NITF02.10" + b"03" + b"BF01" + b"0" * 10 + b"20190402110425"
            + b"\0" * 100
            + b"USE00A" + f"{len(use00a):05d}".encode() + use00a
            + b"CSEXRA" + f"{len(csexra):05d}".encode() + csexra
            + jnitf.rpc00b_tre(_cams(6)[0]) + b"\0" * 64)
    p = tmp_path / "img.ntf"
    p.write_bytes(blob)
    tags = tnitf.parse_nitf_tres(str(p))
    assert tags == jnitf.parse_nitf_tres(str(p))
    meta = tnitf.NITFMetadata.from_tags(tags, path=str(p))
    assert meta.incidence_deg == 24.5 and meta.azimuth_deg == 132.7
    assert meta.path == str(p)
    bad = tmp_path / "bad.ntf"
    bad.write_bytes(b"XXXX" + b"\0" * 400)
    for nitf in (tnitf, jnitf):
        with pytest.raises(ValueError):
            nitf.parse_nitf_tres(str(bad))
        with pytest.raises(ValueError):
            nitf.write_nitf(str(tmp_path / "y.ntf"), np.zeros((4, 4), np.uint8),
                            compress="XX")
        with pytest.raises(ValueError):
            nitf.write_nitf(str(tmp_path / "y.ntf"),
                            np.zeros((4, 4), np.int32))


@pytest.mark.parametrize("s,days", [("20190402110425", None), ("2019", 0.0),
                                    ("", 0.0), ("20000101", 0.0),
                                    ("2000010212", 1.5)])
def test_date_days_agrees(s, days):
    tm = tnitf.NITFMetadata(1.0, 2.0, datetime_str=s)
    jm = jnitf.NITFMetadata(1.0, 2.0, datetime_str=s)
    assert tm.date_days == jm.date_days
    if days is not None:
        assert tm.date_days == days


# ---------------------------------------------------------------------------
# crop windows and shifted RPCs
# ---------------------------------------------------------------------------

EXTENTS = [((-58.585, -58.575), (-34.495, -34.485)),
           ((-58.59, -58.57), (-34.50, -34.48)),
           ((-58.581, -58.579), (-34.491, -34.489))]


@pytest.mark.parametrize("extent", range(len(EXTENTS)))
@pytest.mark.parametrize("pad,align,height", [(0, 1, 0.0), (4, 16, 0.0),
                                              (64, 64, 20.0)])
def test_crop_window_and_shift_rpc(extent, pad, align, height):
    jcam, tcam = _cams(7)
    lon_r, lat_r = EXTENTS[extent]
    jwin = jcrop.crop_window_from_extent(jcam, lon_r, lat_r, (1024, 1280),
                                         height=height, pad=pad, align=align)
    twin = tcrop.crop_window_from_extent(tcam, lon_r, lat_r, (1024, 1280),
                                         height=height, pad=pad, align=align)
    assert (twin.x_off, twin.y_off, twin.width, twin.height) == \
        (jwin.x_off, jwin.y_off, jwin.width, jwin.height)
    assert twin.slices == jwin.slices and twin.as_list() == jwin.as_list()
    assert_same_rpc(jcrop.shift_rpc(jcam, jwin), tcrop.shift_rpc(tcam, twin))
    # the shift moves projections by the window origin
    col, row = tcam.project_np([-58.58], [-34.49], [0.0])
    col2, row2 = tcrop.shift_rpc(tcam, twin).project_np([-58.58], [-34.49],
                                                       [0.0])
    np.testing.assert_allclose(col - col2, twin.x_off, atol=1e-6)
    np.testing.assert_allclose(row - row2, twin.y_off, atol=1e-6)


def test_shift_rpc_offsets_subtract_in_float32():
    """Offsets whose float32 difference rounds: the port's shifted fields
    are the reference's bits."""
    d = _rpc_dict(8)
    d.update(LINE_OFF=16777217.0, SAMP_OFF=0.1)
    jcam, tcam = JRPCCamera.from_dict(d), convert.rpc_from_reference(d)
    win = jcrop.CropWindow(x_off=3, y_off=1, width=5, height=5)
    j2 = jcrop.shift_rpc(jcam, win)
    t2 = tcrop.shift_rpc(tcam, tcrop.CropWindow(3, 1, 5, 5))
    assert_same_rpc(j2, t2)
    assert t2.samp_off.dtype == torch.float32
    assert float(t2.samp_off) == float(np.float32(0.1) - np.float32(3))


@pytest.mark.parametrize("mod", [tcrop, jcrop])
def test_crop_window_outside_raises(mod):
    cam = _cams(9)[0 if mod is jcrop else 1]
    with pytest.raises(ValueError):
        mod.crop_window_from_extent(cam, (10.0, 10.1), (10.0, 10.1), (64, 64))


def test_crop_window_from_kml(tmp_path):
    p = str(tmp_path / "aoi.kml")
    with open(p, "w", encoding="utf-8") as fh:
        fh.write(KML)
    jcam, tcam = _cams(10)
    jw = jcrop.crop_window_from_kml(jcam, p, (1024, 1280), pad=8, align=32)
    tw = tcrop.crop_window_from_kml(tcam, p, (1024, 1280), pad=8, align=32)
    assert tw.as_list() == jw.as_list()


# ---------------------------------------------------------------------------
# Sentinel-style band stacks
# ---------------------------------------------------------------------------

def _ref_bands_to_rgb(stack, rgb_bands=(3, 2, 1), p_lo=2.0, p_hi=98.0):
    """``pcmi_tpu.io.sentinel.bands_to_rgb``'s computation, on the
    reference's ``percentile_stretch``. The function itself cannot be
    called: it writes NaN into ``np.asarray`` of a JAX array, a read-only
    view, and raises ``ValueError``."""
    out = []
    for b in rgb_bands:
        band = stack[..., min(b, stack.shape[-1] - 1)]
        mask = np.isfinite(band)
        stretched = np.array(jpercentile_stretch(
            jnp.asarray(np.nan_to_num(band)), jnp.asarray(mask), p_lo, p_hi))
        stretched[~mask] = np.nan
        out.append(stretched)
    return np.stack(out, axis=-1)


def test_reference_bands_to_rgb_raises():
    with pytest.raises(ValueError, match="read-only"):
        jsentinel.bands_to_rgb(np.ones((4, 4, 3), np.float32))


@pytest.mark.parametrize("nbands", [1, 3, 5])
def test_bands_to_rgb_agrees(tmp_path, rng, nbands):
    stack = rng.uniform(0, 3000, (48, 40, nbands)).astype(np.float32)
    stack[5:9, 3:7, 0] = np.nan
    stack[::7, ::5, -1] = np.inf
    j = _ref_bands_to_rgb(stack)
    t = tsentinel.bands_to_rgb(stack, device="cpu")
    assert t.shape == j.shape == (48, 40, 3)
    assert (np.isnan(t) == np.isnan(j)).all()
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)

    p = str(tmp_path / "bands.tif")
    traster.write_tiff(p, stack[..., 0] if nbands == 1 else stack)
    bands = jsentinel.load_bands(p)
    np.testing.assert_array_equal(tsentinel.load_bands(p), bands)
    np.testing.assert_allclose(tsentinel.load_rgb(p, device="cpu"),
                               _ref_bands_to_rgb(bands), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# JPEG2000 (IC=C8 / M8), as tests/test_jp2k.py, across the packages
# ---------------------------------------------------------------------------

needs_j2k = pytest.mark.skipif(
    not (tjp2k.available() and jjp2k.available()),
    reason="no JPEG2000 codec in environment")


def test_jp2k_available_agrees():
    assert tjp2k.available() == jjp2k.available()


@needs_j2k
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_jp2k_codestream_cross_roundtrip(rng, dtype):
    img = rng.integers(0, 2048 if dtype == np.uint16 else 256, (93, 171),
                       dtype=dtype)
    data = tjp2k.encode(img)
    assert data == jjp2k.encode(img)
    assert tjp2k.is_j2k(data) and jjp2k.is_j2k(data)
    np.testing.assert_array_equal(tjp2k.decode(data), img)
    np.testing.assert_array_equal(tjp2k.decode(jjp2k.encode(img)), img)


@needs_j2k
def test_jp2k_lossy_agrees():
    img = (np.indices((128, 128)).sum(0) * 8).astype(np.uint16)
    data = tjp2k.encode(img, lossless=False, ratio=10.0)
    assert data == jjp2k.encode(img, lossless=False, ratio=10.0)
    out = tjp2k.decode(data).astype(np.float64)
    assert float(np.sqrt(np.mean((out - img) ** 2))) < 40.0


@needs_j2k
@pytest.mark.parametrize("compress,tile", [("C8", 0), ("C8", 128),
                                           ("M8", 128)])
def test_jp2k_nitf_cross_read(tmp_path, rng, compress, tile):
    pan = rng.integers(0, 2048, (300, 500), dtype=np.uint16)
    msi = rng.integers(0, 256, (150, 250), dtype=np.uint8)
    imgs = [msi] if (compress, tile) == ("C8", 128) else [pan, msi]
    for name, (_, nitf) in PACKAGES.items():
        nitf.write_nitf(str(tmp_path / f"{name}.ntf"), imgs, compress=compress,
                        tile_size=tile)
    assert (tmp_path / "ref.ntf").read_bytes() == \
        (tmp_path / "port.ntf").read_bytes()
    p = str(tmp_path / "ref.ntf")
    for seg, img in enumerate(imgs):
        info = tnitf.nitf_image_info(p, segment=seg)
        assert info == jnitf.nitf_image_info(p, segment=seg)
        assert info["ic"] == compress
        np.testing.assert_array_equal(tnitf.read_nitf_image(p, segment=seg),
                                      img)


@needs_j2k
def test_jp2k_refusals_agree(tmp_path, rng):
    img = rng.integers(0, 2048, (64, 64), dtype=np.uint16)
    for nitf in (tnitf, jnitf):
        with pytest.raises(ValueError, match="M8"):
            nitf.write_nitf(str(tmp_path / "x.ntf"), img, compress="C8",
                            tile_size=32)
    p = str(tmp_path / "bad.ntf")
    tnitf.write_nitf(p, img, compress="C8")
    data = bytearray(open(p, "rb").read())
    off = int(tnitf.nitf_image_info(p)["data_offset"])
    data[off:off + 64] = bytes(64)  # wipe SOC/SIZ
    open(p, "wb").write(bytes(data))
    for nitf in (tnitf, jnitf):
        with pytest.raises(Exception):
            nitf.read_nitf_image(p)
