"""What the metric readers take from the program's own tracer
(``pcmi_tpu_torch.utils.profiling``): the spans recorded inside each
traced request's window on the host clock, and the offset from that clock
to the profiler's.

The harness opens a ``torch.profiler`` session around the traced
stretches, and an active session is what turns the program's recording
on, so no file of the harness switches it. A request's window
``[t0, t1]`` (``time.perf_counter`` seconds, as ``run.requests`` holds
it) leaves out the warm-up and the second stretch, which is profiled on
the host too and keeps no requests. A program without the tracer gives
None here, and the readers then report nothing.
"""

from __future__ import annotations

import bisect
from typing import List, Optional


def _tracer():
    try:
        from pcmi_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "spans")
            and hasattr(profiling, "profiler_offset_ns")):
        return None
    return profiling


def request_spans(run) -> Optional[List[list]]:
    """For each traced request, the program's spans inside its window, in
    the order they opened; None without a tracer or requests."""
    tracer = _tracer()
    if tracer is None or not run.requests:
        return None
    return [tracer.spans(r["t0"], r["t1"]) for r in run.requests]


def mean_per_request(run, name: str, field: str = "device_ms"):
    """The mean, over the traced requests that recorded a span ``name``,
    of the sum of ``field`` (``device_ms`` or ``host_ms``) over those
    spans; None when no request recorded one."""
    per = request_spans(run)
    if per is None:
        return None
    totals = []
    for got in per:
        mine = [getattr(s, field) for s in got if s.name == name]
        if mine and None not in mine:
            totals.append(sum(mine))
    return sum(totals) / len(totals) if totals else None


def idle_in_spans_ms(run, name: str):
    """The mean per traced request of the device's idle time while the
    host was inside the request's span ``name``: the gaps between the
    merged intervals of ``run.device_ops`` (the profiler's clock, µs),
    each counted where its middle, moved to the host clock with the
    tracer's offset, falls inside such a span. None without spans, device
    operations or an offset."""
    per = request_spans(run)
    tracer = _tracer()
    off = tracer.profiler_offset_ns() if tracer is not None else None
    if per is None or off is None or not run.device_ops:
        return None
    mids, gaps, end = [], [], None
    for _, a, b in sorted(run.device_ops, key=lambda d: d[1]):
        if end is not None and a > end:
            mids.append(0.5 * (a + end) * 1e3 - off)
            gaps.append((a - end) / 1e3)
        end = b if end is None else max(end, b)
    totals = []
    for got in per:
        mine = [s for s in got if s.name == name]
        if not mine:
            continue
        ms = 0.0
        for s in mine:
            lo = bisect.bisect_left(mids, s.t0)
            hi = bisect.bisect_right(mids, s.t1)
            ms += sum(gaps[lo:hi])
        totals.append(ms)
    return sum(totals) / len(totals) if totals else None
