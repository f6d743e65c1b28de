"""The window's line on standard error: the request times' quartiles, the
mean request time and main-thread CPU time of each 10 s stretch and the
host's counters over the window, printed beside a run and leaving its
result line as the metric readers give it."""

import copy
import json

import torch

from perfbench import harness


def _run(windows, cpu=None, host=()):
    run = harness.Run(None)
    run.requests = [dict(t0=a, t1=b, units=1) for a, b in windows]
    for r, c in zip(run.requests, cpu or []):
        r["cpu_s"] = c
    run.host = list(host)
    return run


def test_stretch_means_quartiles_and_host_deltas():
    # requests of 1, 2, 3 and 4 s back to back from t = 100 s: the first
    # three end inside the first 10 s, the fourth in the second stretch
    start = {"cpu_s": 10.0, "main_cpu_s": 4.0, "nvcsw": 7, "nivcsw": 2,
             "loadavg": [1.0, 0.5, 0.25], "sm_mhz": 1980.0}
    end = {"cpu_s": 22.5, "main_cpu_s": 13.0, "nvcsw": 19, "nivcsw": 5,
           "loadavg": [2.0, 1.0, 0.5], "sm_mhz": 1755.0, "cpu_mhz": 2400.0}
    run = _run([(100, 101), (101, 103), (103, 106), (106, 110.5)],
               cpu=[0.5, 1.0, 3.0, 4.0], host=[start, end])
    before = copy.deepcopy(vars(run))
    note = harness.window_note(run)
    assert vars(run) == before
    assert note["requests"] == 4
    assert note["stretch_mean_ms"] == [2000.0, 4500.0]
    assert note["stretch_cpu_ms"] == [1500.0, 4000.0]
    assert note["request_ms_quartiles"] == [1250.0, 2500.0, 4125.0]
    # counters as differences, clocks and the load average at both ends; a
    # counter read at one end only is left out
    assert note["host"] == {"cpu_s": 12.5, "main_cpu_s": 9.0, "nvcsw": 12,
                            "nivcsw": 3, "loadavg": [[1.0, 0.5, 0.25],
                                                     [2.0, 1.0, 0.5]],
                            "sm_mhz": [1980.0, 1755.0]}


def test_no_requests_and_no_card_clock_on_the_cpu():
    note = harness.window_note(_run([]))
    assert note["requests"] == 0 and note["stretch_mean_ms"] == []
    assert note["stretch_cpu_ms"] == [] and note["host"] == {}
    assert note["request_ms_quartiles"] is None
    reading = harness.host_reading("cpu")
    assert "sm_mhz" not in reading
    assert reading["cpu_s"] >= reading["main_cpu_s"] >= 0
    assert reading["nivcsw"] >= 0 and reading["nvcsw"] >= 0


def test_the_fuse_cell_prints_the_line_and_its_result_line_is_unchanged(
        tiny, monkeypatch):
    torch.set_num_threads(4)
    runs, lines = [], []
    real = harness.measure

    def keep(*a, **kw):
        out = real(*a, **kw)
        runs.append(out[0])
        return out

    monkeypatch.setattr(harness, "measure", keep)
    r = harness.run_cell(tiny, "d288_aoi.fuse", 2**31 + 3, 0.2, False,
                         device="cpu", log=lines.append)
    (run,) = runs
    (line,) = [s for s in lines if s.startswith("window: ")]
    assert json.loads(line[len("window: "):]) == harness.window_note(run)
    # the result line is the readers' numbers of the run, with no key of
    # the window's line
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "checks"]
    cell = harness.Cell(tiny, "d288_aoi.fuse")
    assert r["metrics"] == harness.read_metrics(run, cell.end_to_end)
    assert r["correct"] is True and r["attempted"] == len(run.requests)
    assert len(run.host) == 2 and all(q["cpu_s"] >= 0 for q in run.requests)


def test_pinned_gives_the_main_thread_a_core_and_gives_it_back():
    import os
    import threading

    cores = sorted(os.sched_getaffinity(0))
    side = threading.Thread(target=threading.Event().wait, args=(5,),
                            daemon=True)
    side.start()
    with harness.pinned():
        inside = os.sched_getaffinity(0)
        other = os.sched_getaffinity(side.native_id)
    assert os.sched_getaffinity(0) == set(cores)
    assert os.sched_getaffinity(side.native_id) == set(cores)
    if len(cores) > 1:
        assert inside == {cores[-1]} and other == set(cores[:-1])
    else:
        assert inside == other == set(cores)
