"""The port's tracer (``pcmi_tpu_torch.utils.profiling``) on the pair and
AOI paths, on the CPU: nothing is recorded with tracing off; under
``recording()`` the pair and the AOI request are trees of stage spans
that partition their parent; the spans share the profiler's clock; the
CUDA-event path with a stand-in for ``torch.cuda``; the buffer and the
trace file's program track."""

import glob
import inspect
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pcmi_tpu_torch.config import PipelineConfig, RectifyConfig, StereoConfig
from pcmi_tpu_torch.geometry.pairs import ImageMeta
from pcmi_tpu_torch.geometry.synthetic import (
    aoi_lonlat_ranges, make_stereo_scene)
from pcmi_tpu_torch.pipelines import multiday
from pcmi_tpu_torch.pipelines.height_map import HeightMapPipeline
from pcmi_tpu_torch.utils import profiling

torch.set_num_threads(1)

VIEWS3 = ((10.0, 80.0), (20.0, 250.0), (16.0, 170.0))
CFG = PipelineConfig(
    stereo=StereoConfig(block_size=9, census_window=5, margin_undefined=8,
                        disp_stride=2),
    rectify=RectifyConfig(height_range=(0.0, 6.0)))
PAIR_STAGES = ["pair.rectify", "pair.normalise", "pair.match", "pair.refine",
               "pair.finalise"]
AOI_STAGES = ["aoi.geometry", "aoi.stereo", "aoi.icp", "aoi.knn_mask",
              "aoi.dsm", "aoi.kmeans"]


@pytest.fixture(scope="module")
def scene():
    return make_stereo_scene(seed=1, out_shape=(96, 96),
                             ground_shape=(96, 96), gsd=0.5,
                             h_range=(0.0, 6.0), views=VIEWS3)


@pytest.fixture(scope="module")
def pair(scene):
    pipe = HeightMapPipeline(CFG, device="cpu")
    geom = pipe.build_geometry(scene.rpcs[0], scene.rpcs[1],
                               *aoi_lonlat_ranges(scene),
                               tuple(scene.images[0].shape),
                               tuple(scene.images[1].shape))
    return lambda: pipe.process_pair(scene.images[0], scene.images[1], geom)


def _fuse(scene):
    fusion = multiday.MultiDayFusion(CFG, device="cpu")
    metas = [ImageMeta(i, inc, az, date=30.0 * i)
             for i, (inc, az) in enumerate(VIEWS3)]
    fusion.run(scene.images, scene.rpcs, metas, *aoi_lonlat_ranges(scene),
               points_per_pair=1 << 10, with_kmeans=True, grid_cell=2.0)
    return fusion


def _recorded(fn):
    """``fn()`` under ``recording()``: its result and the spans it
    recorded."""
    t0 = time.perf_counter()
    with profiling.recording():
        out = fn()
    return out, profiling.spans(t0, time.perf_counter())


def _assert_partition(parent, names):
    """The children of ``parent`` are ``names`` in order, one after the
    other inside it, and cover most of it."""
    kids = parent.children
    assert [k.name for k in kids] == names
    assert all(k.parent == parent.id and k.root == parent.root for k in kids)
    assert kids[0].t0 >= parent.t0 and kids[-1].t1 <= parent.t1
    assert all(a.t1 <= b.t0 for a, b in zip(kids, kids[1:]))
    assert sum(k.device_ms for k in kids) >= 0.9 * parent.device_ms


def test_tracing_off_records_nothing(pair, scene, monkeypatch):
    """With tracing off a span is the shared no-op: no span, no CUDA
    event, no synchronisation, and ``stage_ms`` is empty; the fusion
    synchronises nowhere."""
    def refuse(*args, **kwargs):
        raise AssertionError("called with tracing off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    before = len(profiling.spans())
    assert profiling.span("x", "cuda", n=1) is profiling.span("y")
    with profiling.span("x", "cuda") as s:
        s.count(n=2)
    pair()
    fusion = _fuse(scene)
    assert fusion.stage_ms == {}
    assert len(profiling.spans()) == before
    assert "synchronize" not in inspect.getsource(multiday)


def test_pair_is_five_stages(pair):
    """A recorded pair: one root ``pair`` span whose five stage spans
    follow one another and cover it; the matcher's cost volumes (the main
    one and the checker's), its two views and its checker are nested spans
    with their counts."""
    _, rec = _recorded(pair)
    roots = [s for s in rec if s.parent is None]
    assert [s.name for s in roots] == ["pair"]
    top = roots[0]
    assert top.root == top.id
    _assert_partition(top, PAIR_STAGES)
    match = top.children[2]
    assert [k.name for k in match.children] == [
        "stereo.cost_volume", "stereo.sgm", "stereo.right", "stereo.checker"]
    volumes = [s for s in rec if s.name == "stereo.cost_volume"]
    assert len(volumes) == 2 and volumes[1].parent == match.children[3].id
    # on the CPU the plain versions run: no kernel launch is counted
    assert volumes[0].counts == {"planes": 24, "rows": 128, "cols": 128,
                                 "census_window": 5, "kernel_launches": 0,
                                 "census_launches": 0}
    assert all(s.root == top.id for s in rec)


def test_spans_share_the_profiler_clock(pair):
    """Under a profiler session (which records spans by itself), every
    ``aten::`` operation that starts inside the ``pair`` span, moved to
    the profiler's clock, lies inside one of its five stage spans."""
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pair()
    rec = profiling.spans(t0, time.perf_counter())
    top = next(s for s in rec if s.name == "pair")
    off = profiling.profiler_offset_ns()
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("aten::")]
    inside = [op for op in ops if top.t0 + off <= op[0] <= top.t1 + off]
    assert len(inside) > 100
    spans = [(k.t0 + off, k.t1 + off) for k in top.children]
    for a, b in inside:
        assert any(lo <= a and b <= hi for lo, hi in spans), (a, b)
    for lo, hi in spans:
        assert any(lo <= a and b <= hi for a, b in inside)


def test_aoi_stage_ms_under_recording(scene):
    """A recorded fusion: one ``aoi`` span of six stage spans that cover
    it, the stereo stage counting its pairs, and ``stage_ms`` with its
    five keys (device ms; the host's on the CPU)."""
    fusion, rec = _recorded(lambda: _fuse(scene))
    top = next(s for s in rec if s.name == "aoi")
    assert top.parent is None
    _assert_partition(top, AOI_STAGES)
    stereo = top.children[1]
    assert stereo.counts == {"asked": 3, "fused": 3, "skipped": 0}
    assert [k.name for k in stereo.children] == ["pair"] * 3
    ms = fusion.stage_ms
    assert list(ms) == ["stereo", "icp", "knn_mask", "dsm", "kmeans"]
    assert ms["stereo"] == top.children[1].device_ms
    assert all(v > 0 for v in ms.values())


class _Event:
    """A stand-in for ``torch.cuda.Event``, its time from a counter."""

    made, clock = [], iter(range(0, 10 ** 6, 4))

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = self.synced = None
        _Event.made.append(self)

    def record(self, stream):
        assert stream == "stream"
        self.at = next(_Event.clock)

    def synchronize(self):
        self.synced = True

    def elapsed_time(self, end):
        assert end.synced
        return float(end.at - self.at)


def test_cuda_spans_time_the_stream(monkeypatch):
    """On a CUDA device a span records an event on the current stream at
    its start and end, reads ``device_ms`` from them only when asked
    (waiting on the end event) and then drops them; a span opened while
    the stream captures a graph records no event."""
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: "stream")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    _Event.made.clear()
    with profiling.recording():
        with profiling.span("outer", "cuda") as outer:
            with profiling.span("inner", torch.device("cuda", 0)) as inner:
                pass
        capturing[0] = True
        with profiling.span("captured", "cuda") as captured:
            pass
    assert len(_Event.made) == 4
    assert all(e.synced is None for e in _Event.made)
    assert inner.device_ms == 4.0 and outer.device_ms == 12.0
    assert [e.synced for e in _Event.made] == [None, True, None, True]
    assert outer._events is None and inner._events is None
    assert captured.device_ms is None and captured.host_ms >= 0


def test_buffer_keeps_spans_across_sessions(monkeypatch):
    """A profiler session records spans; a later session does not clear
    them; a full buffer drops the oldest."""
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("first"):
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    assert [s.name for s in profiling.spans(t0, time.perf_counter())] == [
        "first"]
    monkeypatch.setattr(profiling, "_buffer",
                        profiling.collections.deque(maxlen=3))
    with profiling.recording():
        for k in range(5):
            with profiling.span(f"s{k}"):
                pass
    assert [s.name for s in profiling.spans()] == ["s2", "s3", "s4"]


def test_device_trace_writes_a_program_track(tmp_path, pair):
    """``device_trace`` exports the profiler's trace with the block's
    spans as a "program" process, on the trace's clock: the ``pair`` span
    starts before and ends after the ``aten::`` operations inside it."""
    with profiling.device_trace(str(tmp_path)):
        pair()
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path, encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    (pid,) = [e["pid"] for e in events if e.get("ph") == "M"
              and e["name"] == "process_name"
              and e["args"]["name"] == "program"]
    mine = [e for e in events if e.get("pid") == pid and e["ph"] == "X"]
    assert [e["name"] for e in mine if e["args"]["parent"] is None] == [
        "pair"]
    assert {e["name"] for e in mine} >= set(PAIR_STAGES)
    top = next(e for e in mine if e["name"] == "pair")
    ops = [e for e in events if e.get("ph") == "X"
           and str(e.get("name", "")).startswith("aten::")
           and top["ts"] <= e["ts"] <= top["ts"] + top["dur"]]
    assert len(ops) > 100
    assert all(e["ts"] + e["dur"] <= top["ts"] + top["dur"] for e in ops)
