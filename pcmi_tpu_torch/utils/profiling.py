"""The program's tracer, device traces and structured logging.

``span(name, device, **counts)`` marks a stage of the program. It records
only inside :func:`recording` or while a ``torch.profiler`` session is
active; otherwise it returns one shared no-op context (one flag check: no
clock read, no allocation of a span, no event, no synchronisation). A
recorded :class:`Span` holds its name, its id, its parent's id (the
innermost span open on its thread) and its root's id, its host times
``t0`` and ``t1`` from ``time.perf_counter_ns`` and its counts; on a CUDA
device it also records a CUDA event on the current stream at its start
and at its end (not while the stream captures a graph), read into
``device_ms`` only when the span is first read. On the CPU ``device_ms``
is the host time. :func:`launched`, called by every kernel launch, counts
the launch in every span open on the thread.

Recorded spans go into a fixed-capacity buffer that drops the oldest and
is never cleared, so spans recorded under one profiler session are still
there after the next. :func:`spans` returns those inside a window of the
host clock; :func:`profiler_offset_ns` maps ``perf_counter_ns`` to the
profiler's event clock (Unix nanoseconds, which ``torch.profiler``'s
events carry), so a span can be laid beside the profiler's host and
device operations. ``torch.profiler.record_function`` is not used: its
ranges come back from the profiler as events on the device's timeline,
where they would count as device operations and fill the idle gaps.

``device_trace`` records a ``torch.profiler`` trace of a block into a
directory, with the block's spans as a "program" track on the same clock,
viewable in TensorBoard or Perfetto.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import logging
import os
import socket
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger("pcmi_tpu_torch")

# spans kept; the oldest go first
CAPACITY = 1 << 14

_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_open = threading.local()
_lock = threading.Lock()
_recording = 0
_offset_ns: Optional[int] = None


def _measure_offset() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, the wall clock read
    between two readings of the counter, from the closest of three
    brackets."""
    best = None
    for _ in range(3):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


def profiler_offset_ns() -> Optional[int]:
    """What to add to a ``time.perf_counter_ns`` reading to put it on the
    profiler's event clock, taken when recording last started (by
    :func:`recording` or by a root span); None before anything recorded."""
    return _offset_ns


class Span:
    """A recorded stage: host times in ``perf_counter_ns``, counts, the
    ids that place it in its tree and its children (spans closed inside
    it)."""

    __slots__ = ("name", "id", "parent", "root", "t0", "t1", "counts",
                 "children", "_events", "_device_ms", "_cuda")

    def __init__(self, name: str, cuda: Optional[torch.device], counts):
        self.name = name
        self.id = next(_ids)
        self.counts: Dict[str, object] = counts
        self.children: List[Span] = []
        self.parent = self.root = None
        self.t0 = self.t1 = None
        self._events = self._device_ms = None
        self._cuda = cuda

    def count(self, **counts) -> None:
        """Add or replace counts of this span."""
        self.counts.update(counts)

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """The time the device's stream took from this span's start to its
        end (waits for the end event on first read, then releases both);
        the host time on the CPU; None for a span opened while its stream
        captured a graph."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._events = None
        return self._device_ms

    def __enter__(self) -> "Span":
        global _offset_ns
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.root = self.id
            _offset_ns = _measure_offset()
        stack.append(self)
        if self._cuda is not None:
            stream = torch.cuda.current_stream(self._cuda)
            if not torch.cuda.is_current_stream_capturing():
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                self.t0 = time.perf_counter_ns()
                self._events[0].record(stream)
                return self
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self._cuda))
        self.t1 = time.perf_counter_ns()
        if self._cuda is None:
            self._device_ms = self.host_ms
        stack = _open.stack
        stack.pop()
        if stack:
            stack[-1].children.append(self)
        _buffer.append(self)
        return False


class _Off:
    """The context of every span that is not recorded."""

    children = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def count(self, **counts) -> None:
        pass


_OFF = _Off()


def active() -> bool:
    """Whether spans record now: inside :func:`recording` or while a
    ``torch.profiler`` session is active."""
    return bool(_recording or _autograd_profiler._is_profiler_enabled)


def span(name: str, device=None, **counts):
    """A context that records the block as span ``name`` with ``counts``
    when recording is on (:func:`active`), and otherwise does nothing.
    ``device`` is where the block's tensors live: on a CUDA device the
    span also times the device's current stream."""
    if not active():
        return _OFF
    dev = torch.device(device) if device is not None else None
    return Span(name, dev if dev is not None and dev.type == "cuda"
                else None, counts)


def launched(kernel: str, plan: Optional[str] = None) -> None:
    """Count one launch of ``kernel`` in every span open on this thread:
    ``launches`` maps kernels to launches, ``plans`` the launch plans given
    to launches; one flag check when spans do not record."""
    if not active():
        return
    for s in getattr(_open, "stack", ()):
        for key, name in (("launches", kernel), ("plans", plan)):
            if name is not None:
                n = s.counts.setdefault(key, {})
                n[name] = n.get(name, 0) + 1


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without a profiler."""
    global _recording, _offset_ns
    with _lock:
        _recording += 1
    _offset_ns = _measure_offset()
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def spans(t0_s: float = float("-inf"),
          t1_s: float = float("inf")) -> List[Span]:
    """The recorded spans that opened and closed inside ``[t0_s, t1_s]``
    (seconds of ``time.perf_counter``), in the order they opened, each
    with its ``device_ms`` read."""
    lo, hi = t0_s * 1e9, t1_s * 1e9
    out = sorted((s for s in list(_buffer) if s.t0 >= lo and s.t1 <= hi),
                 key=lambda s: s.t0)
    for s in out:
        s.device_ms
    return out


def _add_program_track(path: str, recorded: List[Span]) -> None:
    """Write ``recorded`` into the chrome trace at ``path`` as a process
    named "program", on the trace's clock (µs after its
    ``baseTimeNanoseconds``)."""
    with open(path, encoding="utf-8") as fh:
        trace = json.load(fh)
    events = trace.setdefault("traceEvents", [])
    base = trace.get("baseTimeNanoseconds", 0)
    pid = 1 + max((e["pid"] for e in events
                   if isinstance(e.get("pid"), int)), default=0)
    off = profiler_offset_ns() or _measure_offset()
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": "program"}})
    events.append({"ph": "M", "name": "process_sort_index", "pid": pid,
                   "tid": 0, "args": {"sort_index": -1}})
    for s in recorded:
        events.append({
            "ph": "X", "cat": "program", "name": s.name, "pid": pid, "tid": 0,
            "ts": (s.t0 + off - base) / 1e3, "dur": (s.t1 - s.t0) / 1e3,
            "args": {**{k: v if isinstance(v, (int, float, str)) else str(v)
                        for k, v in s.counts.items()},
                     "id": s.id, "parent": s.parent, "root": s.root,
                     "device_ms": s.device_ms}})
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(trace, fh)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Record a ``torch.profiler`` trace of the block (host and, with a
    card, CUDA activity) into ``logdir``, named as TensorBoard's handler
    names it, with the block's spans as a "program" track."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        yield
    t1 = time.perf_counter()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(
        logdir, f"{socket.gethostname()}_{os.getpid()}."
                f"{time.time_ns() // 1_000_000}.pt.trace.json")
    prof.export_chrome_trace(path)
    _add_program_track(path, spans(t0, t1))


def setup_logging(level: int = logging.INFO, path: Optional[str] = None):
    """Console (and optional file) logging for the package's logger."""
    handlers: list = [logging.StreamHandler()]
    if path:
        handlers.append(logging.FileHandler(path))
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        handlers=handlers,
        force=True,
    )
    return logger
