"""The strict single-pair height map past 727 planes, on the CPU: the depth
from which K1 takes its deep-volume launch plan on the card (8-column
accumulating vertical blocks, the deep horizontal form), as the
``highrise_pair`` configuration of the benchmark runs it.

* ``process_pair`` on a tiny scene (48x48 views of 32 m of ground at
  0.5 m, 0-40 m of relief with two buildings, the bench headline's two
  views) searched over -330..370 m, so the search is sized to 784 planes
  on a 112x592 canvas, against ``pcmi_tpu`` with the tolerances of
  ``test_torch_height_map.py`` and against the benchmark's plain
  reference (``perfbench/reference``) within the pair cell's limits;
* K1's launch plan at the configuration's depth;
* the configuration's scene and geometry give a depth in (727, 1024];
* the spans ``stereo.sgm`` and ``stereo.right`` inside ``pair.match``,
  their counts (``volume_bytes`` for each of the matcher's right views)
  and the readers of the new metrics on the recorded run.
"""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pcmi_tpu.config import (
    PipelineConfig, RectifyConfig, StereoConfig, TilingConfig)
from pcmi_tpu.geometry.synthetic import aoi_lonlat_ranges, make_stereo_scene
from pcmi_tpu.pipelines import height_map as jh
from pcmi_tpu_torch import convert
from pcmi_tpu_torch.geometry.synthetic import aoi_lonlat_ranges as port_aoi
from pcmi_tpu_torch.ops.stereo import kernels as K
from pcmi_tpu_torch.pipelines import height_map as th
from pcmi_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
H_RANGE = (-330.0, 370.0)
CFG = PipelineConfig(
    stereo=StereoConfig(block_size=9, census_window=5, margin_undefined=8),
    rectify=RectifyConfig(height_range=H_RANGE),
    tiling=TilingConfig(pad_multiple=16))
# the same settings as a configuration's ``pipeline`` section
SPEC = {"stereo": {"block_size": 9, "census_window": 5,
                   "margin_undefined": 8},
        "rectify": {"height_range": list(H_RANGE)},
        "tiling": {"pad_multiple": 16}}
DEEP = (727, 1024)   # K1 falls back to 8-column blocks past 727 planes


def _perfbench(name):
    from perfbench import harness

    return harness, harness.load_module(harness.PERFBENCH / name)


@pytest.fixture(scope="module")
def products():
    scene = make_stereo_scene(seed=1, out_shape=(48, 48),
                              ground_shape=(64, 64), gsd=0.5,
                              h_range=(0.0, 40.0),
                              views=((10.0, 80.0), (20.0, 250.0)),
                              terrain_kwargs=dict(n_buildings=2,
                                                  building_size_px=(6, 12)))
    ranges = aoi_lonlat_ranges(scene)
    jpipe = jh.HeightMapPipeline(CFG)
    jgeom = jpipe.build_geometry(scene.rpcs[0], scene.rpcs[1], *ranges,
                                 scene.images[0].shape, scene.images[1].shape)
    jprod = jpipe.process_pair(scene.images[0], scene.images[1], jgeom)
    jprod = jh.PairProduct(*[np.asarray(v) for v in jprod])

    rpc_dicts = [r._f64 for r in scene.rpcs]
    images = [np.asarray(im) for im in scene.images]
    port_scene = convert.scene_from_arrays(
        images, np.asarray(scene.terrain), scene.ground_origin,
        scene.ground_gsd, (float(scene.frame.lon0), float(scene.frame.lat0)),
        rpc_dicts, scene.h_range)
    tpipe = th.HeightMapPipeline(convert.config_from_reference(CFG),
                                 device="cpu")
    shapes = [tuple(im.shape) for im in port_scene.images]
    tgeom = tpipe.build_geometry(port_scene.rpcs[0], port_scene.rpcs[1],
                                 *port_aoi(port_scene), *shapes)
    t0 = time.perf_counter()
    with profiling.recording():
        tprod = tpipe.process_pair(port_scene.images[0],
                                   port_scene.images[1], tgeom)
    t1 = time.perf_counter()
    tprod = th.PairProduct(*[v.numpy() for v in tprod])

    from perfbench import stack
    from perfbench.reference import config as ref_config
    from perfbench.reference.geometry.rpc import RPCCamera
    from perfbench.reference.pipelines import height_map as rh

    rcfg = stack.pipeline_config(ref_config, SPEC)
    rrpcs = [RPCCamera.from_dict(d) for d in rpc_dicts]
    rgeom = rh.build_geometry(rcfg, rrpcs[0], rrpcs[1],
                              *port_aoi(port_scene), *shapes)
    with torch.no_grad():
        rprod = rh.process_pair(rcfg, port_scene.images[0],
                                port_scene.images[1], rgeom,
                                rh.stereo_cfg_for(rcfg, [rgeom]), "cpu")
    rprod = {k: getattr(rprod, k).numpy() for k in ("disparity", "valid",
                                                    "xyz")}
    return dict(jgeom=jgeom, tgeom=tgeom, jprod=jprod, tprod=tprod,
                rprod=rprod, jpipe=jpipe, tpipe=tpipe, window=(t0, t1))


# -- (a) process_pair at 784 planes ------------------------------------------


def test_deep_search_range(products):
    jg, tg = products["jgeom"], products["tgeom"]
    assert tg.out_shape == jg.out_shape == (112, 592)
    jcfg = products["jpipe"].stereo_cfg_for([jg])
    tcfg = products["tpipe"].stereo_cfg_for([tg])
    assert tcfg == convert.config_from_reference(jcfg)
    assert tcfg.max_disp == 784 and DEEP[0] < tcfg.max_disp <= DEEP[1]
    assert products["tprod"].disparity.shape == tg.out_shape


def test_deep_valid_masks_agree(products):
    jv, tv = products["jprod"].valid, products["tprod"].valid
    assert (jv == tv).mean() >= 0.9999
    assert tv.sum() > 300


def test_deep_disparity_agrees(products):
    jp, tp = products["jprod"], products["tprod"]
    both = jp.valid & tp.valid
    diff = np.abs(jp.disparity - tp.disparity)[both]
    assert (diff <= 1e-4).mean() >= 0.9999
    assert (np.abs(jp.disparity - tp.disparity) <= 1e-3).mean() >= 0.999


@pytest.mark.parametrize("field,tol", [("photo", 1e-4), ("rel_height", 1e-3),
                                       ("rect_left", 1e-4),
                                       ("rect_right", 1e-4), ("xyz", 1e-3)])
def test_deep_product_fields_agree(products, field, tol):
    a = getattr(products["jprod"], field)
    b = getattr(products["tprod"], field)
    assert (np.isfinite(a) == np.isfinite(b)).all()
    fin = np.isfinite(a)
    assert (np.abs(a - b)[fin] <= tol).mean() >= 0.9999


def test_deep_pair_matches_the_plain_reference(products):
    """The pair cell's comparison (``pair_stream.Driver.compare``) of the
    port's product against the benchmark's plain reference, within the
    cell's limits."""
    harness, stream = _perfbench("drivers/pair_stream.py")
    tp = products["tprod"]
    got = {"disparity": tp.disparity, "valid": tp.valid, "xyz": tp.xyz}
    limits = json.loads((harness.PERFBENCH / "traffic" / "pair_cycle.json"
                         ).read_text())["limits"]
    checks = stream.Driver.compare(got, products["rprod"])
    assert harness.holds(checks, limits), checks


# -- (b) K1's plan at the configuration's depth ------------------------------


@pytest.mark.parametrize("rows,cols", [(1152, 1664), (1536, 1536),
                                       (1280, 1280)])
def test_k1_plan_at_highrise_depth(rows, cols):
    """At 992 planes in float32 the accumulating vertical launch takes
    8-column blocks of 1-row tiles and the horizontal ones the deep form:
    blocks of one row and 16-step tiles (64-byte runs), the accumulating
    launch on the forward launch's tile; the forward vertical launch still
    fits 16 columns."""
    D = 992
    h_fwd, h_acc = (K.sgm_dir_plan(D, rows, True, a) for a in (False, True))
    v_fwd, v_acc = (K.sgm_dir_plan(D, cols, False, a) for a in (False, True))
    assert (v_acc.paths, v_acc.tile) == (8, 1)
    assert (v_fwd.paths, v_fwd.tile) == (16, 1)
    assert h_fwd == h_acc == (1, 16, K.sgm_dir_smem(D, 1, 16, False))
    assert h_fwd.tile * 4 >= 64
    assert all(p.smem <= K.SMEM_BLOCK_MAX
               for p in (h_fwd, h_acc, v_fwd, v_acc))
    # at the 288-plane cell's depth the 16-column blocks still fit
    assert [K.sgm_dir_plan(288, cols, False, a)[:2]
            for a in (False, True)] == [(16, 4), (16, 2)]
    # the fallback starts at 727 planes
    assert K.sgm_dir_plan(726, cols, False, True).paths == 16
    assert K.sgm_dir_plan(727, cols, False, True).paths == 8


# -- (c) the configuration's depth -------------------------------------------


def test_highrise_configuration_sizes_a_deep_search():
    from perfbench import stack
    from perfbench.scene import make_scene
    from pcmi_tpu_torch import config as program_config
    from pcmi_tpu_torch.geometry.pairs import ImageMeta
    from pcmi_tpu_torch.geometry.rpc import RPCCamera

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in bench["configs"]}["highrise_pair"]
    spec = json.loads((REPO / entry["file"]).read_text())
    assert spec["scene"]["h_range"] == [0.0, 180.0]
    assert spec["pipeline"]["rectify"]["height_range"] == [0.0, 180.0]
    scene = make_scene(spec["scene"], 2**31 + 11, "cpu")
    assert float(scene.terrain.max()) > 150.0
    rpcs, _ = stack.side_inputs(scene, RPCCamera, ImageMeta)
    pipe = th.HeightMapPipeline(
        stack.pipeline_config(program_config, spec["pipeline"]), device="cpu")
    geoms = [pipe.build_geometry(rpcs[i], rpcs[j], scene.lon_range,
                                 scene.lat_range, tuple(scene.images[i].shape),
                                 tuple(scene.images[j].shape))
             for i, j in scene.pairs()]
    scfg = pipe.stereo_cfg_for(geoms)
    planes = len(range(0, scfg.max_disp, scfg.disp_stride))
    assert scfg.max_disp == planes == 992
    assert DEEP[0] < planes <= DEEP[1] == K.SGM_DIR_MAX_DISP


# -- (d) the spans and the readers -------------------------------------------


def _recorded(products):
    t0, t1 = products["window"]
    return {s.name: s for s in profiling.spans(t0, t1)}


def test_view_spans_nest_inside_pair_match(products):
    got = _recorded(products)
    match = got["pair.match"]
    H, W = products["tgeom"].out_shape
    for name in ("stereo.sgm", "stereo.right"):
        s = got[name]
        assert s.parent == match.id and s.root == got["pair"].id
        # the plain versions run on the CPU: no launch, no plan; three
        # volumes at once: the cost volume and the horizontal and vertical
        # aggregates, then the cost, the right volume and its aggregate
        assert s.counts == {"planes": 784,
                            "volume_bytes": 3 * 784 * H * W * 4}
        assert s.device_ms > 0
    assert got["stereo.sgm"].t1 <= got["stereo.right"].t0


@pytest.mark.parametrize("right_sgm,held", [
    ("horizontal", (3, 3)), ("full", (3, 3)), ("diagonal", (4, 2))])
def test_view_spans_count_the_volumes_held(right_sgm, held):
    """Each right view of ``compute_disparity`` counts the volumes its
    view holds at once: the left view adds K2's combined aggregate under
    the diagonal right view, which then holds it beside the cost."""
    from pcmi_tpu_torch.config import StereoConfig as PortStereo
    from pcmi_tpu_torch.ops.stereo.matching import compute_disparity

    g = torch.Generator().manual_seed(3)
    left, right = torch.rand(2, 24, 40, generator=g)
    valid = torch.ones(24, 40, dtype=torch.bool)
    cfg = PortStereo(max_disp=16, block_size=3, census_window=3,
                     margin_undefined=2, right_sgm=right_sgm)
    t0 = time.perf_counter()
    with profiling.recording():
        compute_disparity(left, right, valid, valid, cfg)
    got = {s.name: s for s in profiling.spans(t0, time.perf_counter())}
    volume = 16 * 24 * 40 * 4
    assert (got["stereo.sgm"].counts["volume_bytes"],
            got["stereo.right"].counts["volume_bytes"]) == tuple(
                n * volume for n in held)


@pytest.mark.parametrize("metric,what", [
    ("kernels.sgm_ms", "stereo.sgm"),
    ("kernels.right_view_ms", "stereo.right"),
    ("memory.volume_gb", "volume_bytes")])
def test_highrise_readers_read_the_recorded_run(products, metric, what):
    harness, reader = _perfbench(f"metrics/{metric}.py")
    got = _recorded(products)
    run = harness.Run(None)
    t0, t1 = products["window"]
    run.requests = [dict(t0=t0, t1=t1, units=1)]
    if what == "volume_bytes":
        want = max(got[n].counts["volume_bytes"]
                   for n in ("stereo.sgm", "stereo.right")) / 1e9
    else:
        want = got[what].device_ms
    assert reader.read(run) == pytest.approx(want, rel=1e-12)
    # no request, or a window with none of the program's spans: nothing
    run.requests = []
    assert reader.read(run) is None
    run.requests = [dict(t0=t1 + 1.0, t1=t1 + 2.0, units=1)]
    assert reader.read(run) is None
