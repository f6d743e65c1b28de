"""The port's ingest (``pcmi_tpu_torch.pipelines.ingest``) and multi-AOI
sweep against ``pcmi_tpu``'s, on the CPU, from NITF files on disk; and
the port's default random draws (``product_point_cloud`` and ``kmeans``
without a generator), seeded with 0 as the reference's ``PRNGKey(0)``.

The acquisitions are the reference's 256x256 seed-3 scene written by the
reference's writer (``tests/_torch_ntf.py``).
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from _torch_ntf import CFG as REF_CFG
from _torch_ntf import assert_same_rpc, dsm_errors, write_ntf_dir
from pcmi_tpu.io import crop as jcrop
from pcmi_tpu.io import nitf as jnitf
from pcmi_tpu.io import raster as jraster
from pcmi_tpu.pipelines import ingest as jing
from pcmi_tpu_torch import convert
from pcmi_tpu_torch.io import crop as tcrop
from pcmi_tpu_torch.io import jp2k
from pcmi_tpu_torch.io.nitf import _parse_rpc00b, rpc00b_tre
from pcmi_tpu_torch.ops import pointcloud as tpc
from pcmi_tpu_torch.pipelines import ingest as ting
from pcmi_tpu_torch.pipelines.height_map import PairProduct, product_point_cloud
from pcmi_tpu_torch.pipelines.sweep import AOISpec, MultiAOISweep
from pcmi_tpu_torch.utils import profiling

torch.set_num_threads(1)

CFG = convert.config_from_reference(REF_CFG)


@pytest.fixture(scope="module")
def ntf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("wv3")
    scene, port_scene = write_ntf_dir(d)
    return d, scene, port_scene


def _assert_same_acquisitions(jacqs, tacqs):
    assert [a.path for a in tacqs] == [a.path for a in jacqs]
    for j, t in zip(jacqs, tacqs):
        assert t.shape == j.shape
        for f in ("incidence_deg", "azimuth_deg", "datetime_str", "path"):
            assert getattr(t.meta, f) == getattr(j.meta, f), f
        assert t.meta.date_days == j.meta.date_days
        assert_same_rpc(j.meta.rpc, t.meta.rpc)


def test_discovery_matches_reference(ntf_dir):
    d, _, _ = ntf_dir
    tacqs = ting.discover_acquisitions(str(d))
    assert len(tacqs) == 2
    _assert_same_acquisitions(jing.discover_acquisitions(str(d)), tacqs)
    assert tacqs[0].meta.date_days != tacqs[1].meta.date_days
    for acq, (inc, az) in zip(tacqs, ((10.0, 80.0), (20.0, 250.0))):
        assert (acq.meta.incidence_deg, acq.meta.azimuth_deg) == (inc, az)
        assert acq.shape == (256, 256)


def test_rpc00b_anchor_is_representable(ntf_dir):
    """The scene's RPC survives the TRE's four decimals of LAT_OFF and
    LONG_OFF: the anchor (-58.58, -34.49) is written exactly."""
    _, scene, port_scene = ntf_dir
    for cam in port_scene.rpcs:
        tags = _parse_rpc00b(rpc00b_tre(cam)[11:])
        assert tags["LAT_OFF"] == -34.49 and tags["LONG_OFF"] == -58.58


@pytest.mark.parametrize("source,pad,align", [("kml", 4, 16),
                                              ("kml", 64, 64),
                                              ("extent", 0, 1)])
def test_prepare_aoi_stack_matches_reference(ntf_dir, source, pad, align):
    d, scene, _ = ntf_dir
    kw = dict(pad=pad, align=align)
    if source == "kml":
        kw["kml_path"] = str(d / "aoi.kml")
    else:
        from pcmi_tpu.geometry.synthetic import aoi_lonlat_ranges

        kw["lon_range"], kw["lat_range"] = aoi_lonlat_ranges(scene)
    jacqs = jing.discover_acquisitions(str(d))
    tacqs = ting.discover_acquisitions(str(d))
    jimgs, jrpcs, jmetas, jlon, jlat = jing.prepare_aoi_stack(jacqs, **kw)
    timgs, trpcs, tmetas, tlon, tlat = ting.prepare_aoi_stack(tacqs, **kw)
    assert (tlon, tlat) == (jlon, jlat)
    assert len(timgs) == len(jimgs) == 2
    for j, t in zip(jimgs, timgs):
        assert isinstance(t, np.ndarray) and t.dtype == np.float32
        np.testing.assert_array_equal(t, np.asarray(j))
    for j, t in zip(jrpcs, trpcs):
        assert_same_rpc(j, t)
    assert [dataclasses.astuple(m) for m in tmetas] == \
        [dataclasses.astuple(m) for m in jmetas]
    for ja, ta in zip(jacqs, tacqs):
        jw = jcrop.crop_window_from_extent(ja.meta.rpc, jlon, jlat, ja.shape,
                                           pad=pad, align=align)
        tw = tcrop.crop_window_from_extent(ta.meta.rpc, tlon, tlat, ta.shape,
                                           pad=pad, align=align)
        assert tw.as_list() == jw.as_list()
    if source == "kml" and pad == 4:
        assert timgs[0].shape[0] < 256  # actually cropped


def test_prepare_aoi_stack_skips_and_refuses(ntf_dir):
    d, _, _ = ntf_dir
    acqs = ting.discover_acquisitions(str(d))
    out = ting.prepare_aoi_stack(acqs, lon_range=(10.0, 10.1),
                                 lat_range=(10.0, 10.1))
    assert out[:3] == ([], [], [])
    with pytest.raises(ValueError):
        ting.prepare_aoi_stack(acqs)


@pytest.mark.parametrize("sidecar", ["_RPC.TXT", ".RPB"])
def test_tiff_acquisitions_with_sidecars(tmp_path, ntf_dir, sidecar):
    """TIFF acquisitions with an RPC sidecar and ``.aux.json`` view tags
    are discovered and cropped as the reference does; files without an
    RPC and unreadable files are skipped."""
    d, scene, _ = ntf_dir
    for i, cam in enumerate(scene.rpcs):
        f64 = cam._f64
        p = str(tmp_path / f"v{i}.tif")
        jraster.write_tiff(p, np.asarray(scene.images[i], np.float32),
                           tags={"incidence_deg": 10.0 + 10 * i,
                                 "azimuth_deg": 80.0 + 170 * i,
                                 "idatim": f"2019{4 + i:02d}02110000"})
        if sidecar == ".RPB":
            text = "".join(
                f"{k} = ({', '.join(f'{c:.15e}' for c in f64[v])});\n"
                if np.ndim(f64[v]) else f"{k} = {f64[v]:.15e};\n"
                for k, v in (("lineOffset", "LINE_OFF"),
                             ("sampOffset", "SAMP_OFF"),
                             ("latOffset", "LAT_OFF"),
                             ("longOffset", "LONG_OFF"),
                             ("heightOffset", "HEIGHT_OFF"),
                             ("lineScale", "LINE_SCALE"),
                             ("sampScale", "SAMP_SCALE"),
                             ("latScale", "LAT_SCALE"),
                             ("longScale", "LONG_SCALE"),
                             ("heightScale", "HEIGHT_SCALE"),
                             ("lineNumCoef", "LINE_NUM_COEFF"),
                             ("lineDenCoef", "LINE_DEN_COEFF"),
                             ("sampNumCoef", "SAMP_NUM_COEFF"),
                             ("sampDenCoef", "SAMP_DEN_COEFF")))
        else:
            text = "".join(
                "".join(f"{v}_{n + 1}: {c:.15e}\n"
                        for n, c in enumerate(f64[v]))
                if np.ndim(f64[v]) else f"{v}: {f64[v]:.15e}\n"
                for v in f64)
        (tmp_path / f"v{i}{sidecar}").write_text(text)
    jraster.write_tiff(str(tmp_path / "no_rpc.tif"), np.zeros((8, 8)))
    (tmp_path / "broken.ntf").write_bytes(b"NITF02.10 truncated")
    jacqs = jing.discover_acquisitions(str(tmp_path))
    tacqs = ting.discover_acquisitions(str(tmp_path))
    assert [a.path.rsplit("/", 1)[1] for a in tacqs] == ["v0.tif", "v1.tif"]
    _assert_same_acquisitions(jacqs, tacqs)
    kml = str(d / "aoi.kml")
    jimgs, jrpcs, *_ = jing.prepare_aoi_stack(jacqs, kml_path=kml)
    timgs, trpcs, *_ = ting.prepare_aoi_stack(tacqs, kml_path=kml)
    for j, t in zip(jimgs, timgs):
        np.testing.assert_array_equal(t, np.asarray(j))
    for j, t in zip(jrpcs, trpcs):
        assert_same_rpc(j, t)


@pytest.mark.skipif(not jp2k.available(),
                    reason="no JPEG2000 codec in environment")
def test_c8_acquisitions_through_ingest(tmp_path, ntf_dir):
    """JPEG2000 (IC=C8) NITFs with TREs, as real deliveries arrive, through
    both packages' discovery and cropping (``tests/test_jp2k.py``'s
    case): the same quantised pixels, cameras and metadata."""
    _, scene, _ = ntf_dir
    for i, (inc, az) in enumerate(((10.0, 80.0), (20.0, 250.0))):
        q = np.clip(np.asarray(scene.images[i], np.float32) * 2047.0, 0,
                    2047).astype(np.uint16)
        jnitf.write_nitf(str(tmp_path / f"c8_{i}.ntf"), q,
                         tres=(jnitf.rpc00b_tre(scene.rpcs[i])
                               + jnitf.use00a_tre(inc)
                               + jnitf.csexra_tre(inc, az)),
                         idatim=f"2019{4 + i:02d}02110000", compress="C8")
    jacqs = jing.discover_acquisitions(str(tmp_path))
    tacqs = ting.discover_acquisitions(str(tmp_path))
    assert len(tacqs) == 2
    _assert_same_acquisitions(jacqs, tacqs)
    kw = dict(pad=4, align=16)
    jimgs, jrpcs, *_ = jing.prepare_aoi_stack(
        jacqs, lon_range=(-58.5803, -58.5797), lat_range=(-34.4903, -34.4897),
        **kw)
    timgs, trpcs, *_ = ting.prepare_aoi_stack(
        tacqs, lon_range=(-58.5803, -58.5797), lat_range=(-34.4903, -34.4897),
        **kw)
    assert len(timgs) == 2 and timgs[0].shape[0] < 256
    for j, t in zip(jimgs, timgs):
        np.testing.assert_array_equal(t, np.asarray(j))
        assert t.max() <= 2047 and t.max() > 100
    for j, t in zip(jrpcs, trpcs):
        assert_same_rpc(j, t)


def test_sweep_resumes_from_the_stage_cache(ntf_dir, tmp_path):
    """``MultiAOISweep`` over the ingested stack as two AOIs with a
    ``StageCache``: the second AOI and the whole second run hit the cache
    (no pair is recomputed), the DSM is identical, each AOI of a recorded
    run is one ``sweep.aoi`` span counting the AOI's name, and the DSM
    meets ``tests/test_ingest.py``'s gates against the terrain."""
    d, scene, _ = ntf_dir
    acqs = ting.discover_acquisitions(str(d))
    images, rpcs, metas, lon_r, lat_r = ting.prepare_aoi_stack(
        acqs, kml_path=str(d / "aoi.kml"), pad=4, align=16)
    aois = [AOISpec(name, images, rpcs, metas, lon_r, lat_r)
            for name in ("site_a", "site_b")]
    sweep = MultiAOISweep(CFG, cache_dir=str(tmp_path / "stage"),
                          device="cpu")
    assert sweep.fusion.device == torch.device("cpu")
    t0 = time.perf_counter()
    with profiling.recording():
        first = sweep.run(aois, points_per_pair=1 << 14, grid_cell=2.0,
                          with_kmeans=False)
    t1 = time.perf_counter()
    assert (sweep.cache.misses, sweep.cache.hits) == (1, 1)
    again = sweep.run(aois[:1], points_per_pair=1 << 14, grid_cell=2.0,
                      with_kmeans=False)
    assert (sweep.cache.misses, sweep.cache.hits) == (1, 2)
    a, b = first.fused["site_a"], again.fused["site_a"]
    np.testing.assert_array_equal(a.dsm.numpy(), b.dsm.numpy())
    np.testing.assert_array_equal(a.dsm.numpy(),
                                  first.fused["site_b"].dsm.numpy())
    swept = [s for s in profiling.spans(t0, t1) if s.name == "sweep.aoi"]
    assert [s.counts["aoi"] for s in swept] == ["site_a", "site_b"]
    assert all(s.parent is None and [c.name for c in s.children] == ["aoi"]
               for s in swept)
    st = first.stats["site_a"]
    assert st["points"] > 1000 and st["dsm_filled"] > 0.05
    assert st["icp_rmse_max"] == 0.0  # one pair: nothing to register
    dsm = a.dsm.numpy()
    x0, y0 = a.grid_origin
    err = dsm_errors(dsm[::-1], x0, y0 + dsm.shape[0] * a.grid_cell,
                     a.grid_cell, a.grid_cell, scene)
    assert err.size > 200
    assert np.median(np.abs(err)) < 1.0
    assert float(np.sqrt(np.mean(err ** 2))) < 2.5
    json.dumps(first.stats)  # plain numbers


def test_sweep_defaults_to_the_card():
    sweep = MultiAOISweep(CFG)
    assert sweep.fusion.device == torch.device("cuda")
    assert sweep.cache is None


# ---------------------------------------------------------------------------
# the default random draws
# ---------------------------------------------------------------------------

def _product(n_side: int, seed: int) -> PairProduct:
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand(n_side, n_side, 3, generator=g)
    valid = torch.rand(n_side, n_side, generator=g) > 0.3
    z = torch.zeros(n_side, n_side)
    return PairProduct(disparity=z, valid=valid, photo=z, xyz=xyz, height=z,
                       rel_height=z, rect_left=z, rect_right=z)


def test_product_point_cloud_default_draw_is_seeded_with_zero():
    """On a canvas above ``max_points`` the subset is drawn: two calls
    without a generator keep the same points, those of a generator
    seeded with 0, and leave torch's global generator alone."""
    prod = _product(96, 0)
    state = torch.get_rng_state()
    a = product_point_cloud(prod, max_points=4096)
    b = product_point_cloud(prod, max_points=4096)
    assert torch.equal(torch.get_rng_state(), state)
    c = product_point_cloud(prod, max_points=4096,
                            generator=torch.Generator().manual_seed(0))
    d = product_point_cloud(prod, max_points=4096,
                            generator=torch.Generator().manual_seed(1))
    assert a[0].shape == (4096, 3) and float(a[1].sum()) == 4096
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert not torch.equal(a[0], d[0])


def test_kmeans_default_draw_is_seeded_with_zero():
    g = torch.Generator().manual_seed(3)
    pts = torch.rand(2000, 3, generator=g)
    w = (torch.rand(2000, generator=g) > 0.2).float()
    state = torch.get_rng_state()
    a = tpc.kmeans(pts, w, k=6, iters=5)
    b = tpc.kmeans(pts, w, k=6, iters=5)
    assert torch.equal(torch.get_rng_state(), state)
    c = tpc.kmeans(pts, w, k=6, iters=5,
                   generator=torch.Generator().manual_seed(0))
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)
