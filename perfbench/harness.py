"""The benchmark's harness: one run of one cell.

A run sets up the cell's driver (scene, program objects, warm-up of the
shapes the traffic uses), sends requests in a closed loop with one caller
for the measured window, keeps one answer of each distinct request drawn
from the seed, and then, with the window closed and the program's state freed,
recomputes the sampled answers with the plain reference and compares.
The metrics are read by small readers, one file each under
``perfbench/metrics``, from what the run recorded: request times on the
host clock and, with ``trace``, the profiler's device operations.

Everything cell-specific is found by name: the cell's entry in
``BENCHMARK.json`` names a configuration (``configs[].file``) and a
traffic mix (``perfbench/traffic/<traffic>.json``), the traffic mix names
its driver (``perfbench/drivers/<driver>.py``), and every metric the cell
reports has a reader ``perfbench/metrics/<metric>.py``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import random
import resource
import statistics
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

PERFBENCH = Path(__file__).resolve().parent
# modules that may not be loaded in a run, compared by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "pcmi_tpu")
# the window's line on standard error: request times averaged over
# stretches this long
STRETCH_S = 10.0


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules among :data:`FORBIDDEN`, whole
    (``pcmi_tpu_torch`` is not ``pcmi_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def load_module(path: Path, name: Optional[str] = None):
    """Import a file of the benchmark by its path (metric files carry dots
    in their names)."""
    spec = importlib.util.spec_from_file_location(
        name or f"perfbench_file_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic and
    metric lists."""

    def __init__(self, root: Path, name: str):
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.root = root
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = json.loads(
            (root / configs[self.entry["config"]]["file"]).read_text())
        self.traffic = json.loads(
            (PERFBENCH / "traffic" / f"{self.entry['traffic']}.json"
             ).read_text())

        def mine(metric):
            return name in metric.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    @property
    def chips(self) -> int:
        return int(self.entry.get("chips", 1))


class Run:
    """What a run recorded, as the metric readers read it: the cell, the
    set-up time, each request's host times (``t0``, ``t1``), ``units`` and
    the driver's ``info``, the window's length, :func:`host_reading` at
    its start and end and, with a trace, the device operations
    ``(name, start_us, end_us)`` and the device's busy time."""

    def __init__(self, cell: Cell):
        self.cell = cell
        self.setup_s = math.nan
        self.requests: List[dict] = []
        self.window_s = math.nan
        self.host: List[dict] = []
        self.device_ops: List[tuple] = []
        self.busy_s = math.nan

    @property
    def units(self) -> float:
        return float(sum(r["units"] for r in self.requests))

    def latencies_ms(self) -> List[float]:
        return [(r["t1"] - r["t0"]) * 1e3 for r in self.requests]

    def kernel_names(self, group: str) -> List[str]:
        """The name fragments of a kernel group: one file each under
        ``perfbench/kernels/<group>/``."""
        return sorted(p.read_text().strip()
                      for p in (PERFBENCH / "kernels" / group).glob("*.txt"))


def host_reading(device: str) -> dict:
    """Counters of this process and its machine at one moment, read and
    never set: the process's CPU seconds, the main thread's, its voluntary
    and involuntary context switches (``getrusage``), the load average and
    the mean clock of the cores it may run on (``/proc``, where the
    machine gives them) and the card's SM clock (MHz, through NVML where
    ``torch.cuda`` found ``pynvml``)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"cpu_s": ru.ru_utime + ru.ru_stime,
           "main_cpu_s": time.thread_time(),
           "nvcsw": ru.ru_nvcsw, "nivcsw": ru.ru_nivcsw}
    with contextlib.suppress(OSError, ValueError):
        out["loadavg"] = [float(x) for x in
                          Path("/proc/loadavg").read_text().split()[:3]]
    with contextlib.suppress(OSError, ValueError, AttributeError):
        cores = os.sched_getaffinity(0)
        mhz, core = [], None
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            key, _, value = line.partition(":")
            if key.strip() == "processor":
                core = int(value)
            elif key.strip() == "cpu MHz" and core in cores:
                mhz.append(float(value))
        if mhz:
            out["cpu_mhz"] = statistics.fmean(mhz)
    if torch.device(device).type == "cuda":
        with contextlib.suppress(Exception):  # no NVML: no clock
            out["sm_mhz"] = float(torch.cuda.clock_rate())
    return out


@contextlib.contextmanager
def pinned():
    """Run the block with the calling (main) thread alone on the last core
    the process may use and every other thread of the process on the rest;
    each thread's cores are given back on exit (a thread started inside
    gets all of the process's). Nothing is changed where the process has
    one core or the system has no ``/proc/self/task``."""
    try:
        cores = sorted(os.sched_getaffinity(0))
        tids = [int(t) for t in os.listdir("/proc/self/task")]
    except (OSError, AttributeError):
        cores, tids = [], []
    main = threading.get_native_id()
    before = {}
    if len(cores) > 1:
        for tid in tids:
            with contextlib.suppress(OSError):  # a thread that has ended
                before[tid] = os.sched_getaffinity(tid)
                os.sched_setaffinity(
                    tid, cores[-1:] if tid == main else cores[:-1])
    try:
        yield
    finally:
        for tid in ([int(t) for t in os.listdir("/proc/self/task")]
                    if before else []):
            with contextlib.suppress(OSError):
                os.sched_setaffinity(tid, before.get(tid, cores))


def _quartiles(values: List[float]) -> Optional[List[float]]:
    if len(values) < 2:
        return list(values) or None
    return statistics.quantiles(values, n=4)


def window_note(run: Run) -> dict:
    """What a window's requests did, for standard error: the quartiles of
    the request times, the mean request time and main-thread CPU time of
    each :data:`STRETCH_S` stretch of the window (by when a request
    ended), and how each of :func:`host_reading`'s counters moved over the
    window (clocks and the load average: at its start and end). Reads
    ``run`` and changes nothing in it."""
    lat = run.latencies_ms()
    stretches: Dict[int, List[tuple]] = {}
    if run.requests:
        start = run.requests[0]["t0"]
        for r, ms in zip(run.requests, lat):
            stretches.setdefault(int((r["t1"] - start) // STRETCH_S),
                                 []).append((ms, 1e3 * r.get("cpu_s", 0.0)))
    host: Dict[str, object] = {}
    if len(run.host) == 2:
        a, b = run.host
        for k in a.keys() & b.keys():
            host[k] = ([a[k], b[k]] if k in ("loadavg", "cpu_mhz", "sm_mhz")
                       else b[k] - a[k])
    means = [[statistics.fmean(c) for c in zip(*v)]
             for _, v in sorted(stretches.items())]
    return {"requests": len(lat), "request_ms_quartiles": _quartiles(lat),
            "stretch_s": STRETCH_S,
            "stretch_mean_ms": [m[0] for m in means],
            "stretch_cpu_ms": [m[1] for m in means],
            "host": dict(sorted(host.items()))}


def _union_us(intervals) -> float:
    busy, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _events(prof):
    """The profiler's raw events as ``(name, start_us, end_us)``, device
    operations and host operations apart, each sorted by start."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() / 1e3
        row = (e.name(), a, a + e.duration_ns() / 1e3)
        (dev if e.device_type() == DeviceType.CUDA else host).append(row)
    dev.sort(key=lambda d: d[1])
    host.sort(key=lambda h: h[1])
    return dev, host


def _top(d: Dict[str, float]) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]


def read_device_trace(prof, run: Run) -> list:
    """The device operations of a stretch profiled on the device alone:
    recorded in ``run`` with the device's busy time (the union of their
    intervals); returns the costliest operations by name."""
    dev, _ = _events(prof)
    run.device_ops = dev
    run.busy_s = _union_us((a, b) for _, a, b in dev) / 1e6
    by_name: Dict[str, float] = {}
    for name, a, b in dev:
        by_name[name[:96]] = by_name.get(name[:96], 0.0) + (b - a) / 1e6
    return _top(by_name)


def idle_gaps(prof) -> list:
    """The idle gaps between device operations of a stretch profiled on
    the host and the device, by the innermost host operation running at
    each gap's middle."""
    dev, host = _events(prof)
    # gaps in the order of their middles; host operations pushed in the
    # order of their starts; the top of the stack, once every operation
    # that ended before the middle is popped, is the innermost one running
    gaps: Dict[str, float] = {}
    stack: list = []
    i, end = 0, None
    for _, a, b in dev:
        if end is not None and a > end:
            mid = 0.5 * (a + end)
            while i < len(host) and host[i][1] <= mid:
                stack.append(host[i])
                i += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            key = stack[-1][0][:96] if stack else "(host between operations)"
            gaps[key] = gaps.get(key, 0.0) + (a - end) / 1e6
        end = b if end is None else max(end, b)
    return _top(gaps)


@contextlib.contextmanager
def precision(mode: str):
    """The float32 matrix-product mode a computation runs in: ``"float32"``
    (TF32 off) or ``"tf32"``; restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def load_driver(cell: Cell):
    return load_module(PERFBENCH / "drivers" / f"{cell.traffic['driver']}.py",
                       f"perfbench_driver_{cell.traffic['driver']}")


def synchronize(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class _Keep:
    """The answers kept for the check: one answer of each of the driver's
    keys (the key is an answer's first item), drawn from the seed among
    that key's answers (a reservoir of one per key)."""

    def __init__(self, seed: int):
        self.pick = random.Random(seed)
        self.seen: Dict[object, int] = {}
        self.kept: Dict[object, object] = {}

    def offer(self, answer) -> None:
        key = answer[0]
        n = self.seen[key] = self.seen.get(key, 0) + 1
        if self.pick.randrange(n) == 0:
            self.kept[key] = answer

    def answers(self) -> list:
        return list(self.kept.values())


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
            process_start: float, log: Callable[[str], None]):
    """Set up the cell's driver, run the window and keep the sampled
    answers. Returns ``(run, driver, kept, attempted, failed, peak,
    breakdown)``.

    With ``trace``, the window is a fixed stretch of
    ``trace_requests`` requests profiled on the device alone (the metrics
    and the costliest operations), then as many again profiled on the host
    and the device, whose only use is to name what the host did in the
    idle gaps: recording host operations slows the host, so the idle share
    is not read from that stretch."""
    run = Run(cell)
    marks = [("imports", time.perf_counter())]
    torch.zeros(1, device=device)
    synchronize(device)
    marks.append(("device start", time.perf_counter()))
    driver = load_driver(cell).Driver(cell.config, cell.traffic, seed, device)
    marks.append(("driver set-up (program imports, scene, geometry)",
                  time.perf_counter()))
    driver.warm_up()
    synchronize(device)
    marks.append(("warm-up (kernel library load or build, first calls)",
                  time.perf_counter()))
    t, split = process_start, []
    for name, m in marks:
        split.append(f"{name} {m - t:.3f} s")
        t = m
    log("set-up: " + ", ".join(split) + f"; of which scene "
        f"{getattr(driver, 'scene_s', math.nan):.3f} s")
    keep = _Keep(seed)
    counts = {"attempted": 0, "failed": 0}

    def serve(more: Callable[[float], bool], record: bool) -> float:
        """Requests in a closed loop while ``more(end of the last one)``;
        returns the end of the last one."""
        t_end = time.perf_counter()
        while more(t_end):
            t0, c0 = time.perf_counter(), time.thread_time()
            counts["attempted"] += 1
            try:
                out = driver.request()
                synchronize(device)
            except Exception as exc:  # noqa: BLE001 (counted, reported)
                counts["failed"] += 1
                log(f"request {counts['attempted']} failed: {exc!r}")
                t_end = time.perf_counter()
                continue
            t_end = time.perf_counter()
            if record:
                run.requests.append(dict(t0=t0, t1=t_end,
                                         cpu_s=time.thread_time() - c0,
                                         units=out["units"],
                                         **out.get("info", {})))
                keep.offer(out["answer"])
            del out
        return t_end

    def first(n: int) -> Callable[[float], bool]:
        start = counts["attempted"]
        return lambda _: counts["attempted"] - start < n

    breakdown = None
    run.setup_s = time.perf_counter() - process_start
    if trace:
        from torch.profiler import ProfilerActivity, profile

        n = int(cell.traffic["trace_requests"])
        # the device alone (on a CPU run, which has none, the host)
        alone = (ProfilerActivity.CUDA if torch.device(device).type == "cuda"
                 else ProfilerActivity.CPU)
        with profile(activities=[alone]) as prof:
            run.host.append(host_reading(device))
            t_start = time.perf_counter()
            t_end = serve(first(n), record=True)
            run.host.append(host_reading(device))
        run.window_s = t_end - t_start
        ops = read_device_trace(prof, run)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            serve(first(n), record=False)
        breakdown = {"device_ops": ops, "idle_gaps": idle_gaps(prof)}
        del prof
    else:
        with pinned():
            run.host.append(host_reading(device))
            t_start = time.perf_counter()
            deadline = t_start + seconds
            t_end = serve(lambda t: t < deadline, record=True)
            run.host.append(host_reading(device))
        run.window_s = t_end - t_start
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    return (run, driver, keep.answers(), counts["attempted"],
            counts["failed"], peak, breakdown)


def check(driver, answers: list, refs: Optional[dict] = None):
    """The largest of each number that ``driver.compare`` gives over the
    sampled ``(key, answer)`` pairs, each against the driver's reference
    (float32, as the configurations state) for its key, and the scene's truth lines (reported, not
    deciding). ``refs`` caches the reference's answers by key."""
    checks: Dict[str, float] = {}
    notes = []
    refs = {} if refs is None else refs
    for key, got in answers:
        notes.append(driver.truth(key, got))
        if key not in refs:
            refs[key] = driver.reference(key)
        for name, v in driver.compare(got, refs[key]).items():
            # a non-finite gap (a misshaped or non-finite answer) prints as
            # the largest float, which JSON can carry
            v = v if math.isfinite(v) else sys.float_info.max
            checks[name] = max(checks.get(name, 0.0), v)
    return checks, notes


def holds(checks: Dict[str, float], limits: Dict[str, float]) -> bool:
    """The comparison's rule: every compared number within its limit."""
    return all(v <= limits[k] for k, v in checks.items())


def read_metrics(run: Run, metrics: List[dict]) -> dict:
    out = {}
    for m in metrics:
        value = load_module(PERFBENCH / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", process_start: Optional[float] = None,
             log: Callable[[str], None] = lambda s: print(s, file=sys.stderr)
             ) -> dict:
    """One run of cell ``name``; returns the result object (without the
    import check, which :func:`main` makes)."""
    process_start = time.perf_counter() if process_start is None \
        else process_start
    cell = Cell(Path(root), name)
    run, driver, kept, attempted, failed, peak, breakdown = measure(
        cell, seed, seconds, trace, device, process_start, log)
    log("window: " + json.dumps(window_note(run)))
    answers = [driver.to_host(a) for a in kept]
    del kept
    driver.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks, notes = check(driver, answers)
    log(f"check: {len(answers)} answers against the reference in "
        f"{time.perf_counter() - t0:.3f} s")
    for line in notes:
        log(line)
    limits = cell.traffic["limits"]
    correct = failed == 0 and len(run.requests) > 0 and holds(checks, limits)
    metrics = read_metrics(run, cell.per_layer if trace else cell.end_to_end)
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = run.busy_s
        dev["window_s"] = run.window_s
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in checks.items()}
    return result


def main(name: str, seed: int, seconds: float, trace: bool, root: str,
         process_start: float) -> int:
    try:
        need = Cell(Path(root), name).chips
    except (OSError, KeyError, ValueError) as exc:
        print(f"perfbench: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"perfbench: {name} needs {need} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(Path(root), name, seed, seconds, trace, "cuda",
                      process_start)
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 4
    print(json.dumps(result))
    sys.stdout.flush()
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0
