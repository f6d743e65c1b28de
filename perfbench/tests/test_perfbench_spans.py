"""The readers of the program's spans on hand-made runs: spans recorded by
the program's tracer inside and outside the requests' windows, device
operations on the profiler's clock with idle gaps inside and outside the
``pair`` spans, and runs with no spans or no tracer."""

import time

import pytest

from perfbench import harness, program_spans
from pcmi_tpu_torch.utils import profiling

# reader -> (span it reads, field)
READERS = {
    "plain_ops.cost_volume_ms.pair": ("stereo.cost_volume", "device_ms"),
    "plain_ops.normalise_ms.pair": ("pair.normalise", "device_ms"),
    "plain_ops.refine_ms.pair": ("pair.refine", "device_ms"),
    "plain_ops.finalise_ms.pair": ("pair.finalise", "device_ms"),
    "geometry.host_ms.aoi": ("aoi.geometry", "host_ms"),
    "dsm.ms.aoi": ("aoi.dsm", "device_ms"),
}


def _read(metric, run):
    return harness.load_module(
        harness.PERFBENCH / "metrics" / f"{metric}.py").read(run)


def _run(windows, device_ops=()):
    run = harness.Run(None)
    run.requests = [dict(t0=a, t1=b, units=1) for a, b in windows]
    run.device_ops = list(device_ops)
    return run


def _request(name, twice=False):
    """One request's window holding one span ``name`` (two with
    ``twice``), with a span of the same name recorded before it; returns
    the window and the spans inside it."""
    with profiling.recording():
        with profiling.span(name):
            time.sleep(0.002)
        t0 = time.perf_counter()
        inside = []
        for _ in range(2 if twice else 1):
            with profiling.span("root"), profiling.span(name) as s:
                time.sleep(0.001)
            inside.append(s)
        t1 = time.perf_counter()
    return (t0, t1), inside


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_takes_its_spans_inside_the_requests(metric):
    name, field = READERS[metric]
    w1, in1 = _request(name, twice=True)
    w2, in2 = _request(name)
    got = _read(metric, _run([w1, w2]))
    want = (sum(getattr(s, field) for s in in1) + getattr(in2[0], field)) / 2
    assert got == pytest.approx(want, rel=1e-12)
    # the span recorded before each window is left out
    assert got < 0.5 * sum(getattr(s, field) for s in profiling.spans(
        w1[0] - 1.0, w2[1]) if s.name == name)


@pytest.mark.parametrize("metric", sorted(READERS) + [
    "host.idle_in_program_ms.pair"])
def test_reader_gives_none_without_spans(metric, monkeypatch):
    t0 = time.perf_counter()
    t1 = time.perf_counter()
    ops = [("k", 0.0, 1.0), ("k", 2.0, 3.0)]
    assert _read(metric, _run([(t0, t1)], ops)) is None
    assert _read(metric, _run([])) is None
    w, _ = _request("pair")
    monkeypatch.setattr(program_spans, "_tracer", lambda: None)
    assert _read(metric, _run([w], ops)) is None


def test_idle_gaps_inside_and_outside_pair_spans():
    """Gaps whose middle falls inside a request's ``pair`` span count;
    gaps before it, after it and in another span's time do not."""
    with profiling.recording():
        t0 = time.perf_counter()
        with profiling.span("pair") as pair:
            time.sleep(0.01)
        with profiling.span("caller"):
            time.sleep(0.005)
        t1 = time.perf_counter()
    off = profiling.profiler_offset_ns()

    def us(host_ns):
        return (host_ns + off) / 1e3

    p0, p1 = us(pair.t0), us(pair.t1)
    # each comment: the gap before the operation
    ops = [("op", p0 - 400.0, p0 - 300.0),
           ("op", p0 - 200.0, p0 + 1000.0),  # 100 us, middle before p0
           ("op", p0 + 1300.0, p0 + 2000.0),  # 300 us inside
           ("op", p0 + 1500.0, p0 + 2600.0),  # none: overlaps, merged
           ("op", p0 + 3000.0, p1 - 1000.0),  # 400 us inside
           ("op", p1 + 2000.0, p1 + 2500.0)]  # 3000 us, middle after p1
    got = _read("host.idle_in_program_ms.pair", _run([(t0, t1)], ops))
    assert got == pytest.approx(0.7, abs=1e-6)
    # two requests: the mean of their sums
    again = _read("host.idle_in_program_ms.pair",
                  _run([(t0, t1), (t0, t1)], ops))
    assert again == pytest.approx(0.7, abs=1e-6)
