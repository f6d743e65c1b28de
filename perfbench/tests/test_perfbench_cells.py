"""Each cell's driver end to end on the CPU at a tiny size, through the
harness: the result line's shape, the metrics each mode reports, and a
correct comparison against the plain reference."""

import json

import pytest
import torch

from perfbench import harness

CELLS = [w["name"] for w in json.loads(
    (harness.PERFBENCH.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(tiny, cell, trace):
    torch.set_num_threads(4)
    r = harness.run_cell(tiny, cell, 2**31 + 7, 0.5, trace, device="cpu")
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    c = harness.Cell(tiny, cell)
    want = [m["name"] for m in (c.per_layer if trace else c.end_to_end)]
    if trace:
        # no device on the CPU: only host-side readings can be reported
        assert set(r["metrics"]) <= set(want)
        assert r["device"]["window_s"] > 0
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(r["metrics"]) == set(want)
        assert all(m["value"] > 0 for m in r["metrics"].values())
    for k, v in r["checks"].items():
        assert v["value"] <= v["limit"], k


def test_same_seed_same_inputs():
    from perfbench.scene import make_scene

    spec = dict(crop_px=48, ground_shape=[48, 48], gsd=0.5,
                h_range=[0.0, 6.0], views=[[20.0, 80.0], [30.0, 250.0]],
                terrain={"n_buildings": 2, "building_size_px": [4, 8]})
    a, b, c = (make_scene(spec, s) for s in (5, 5, 6))
    assert all(torch.equal(x, y) for x, y in zip(a.images, b.images))
    assert not torch.equal(a.images[0], c.images[0])
    assert [x.shape for x in a.images] == [x.shape for x in c.images]


def test_one_answer_of_each_key_drawn_from_the_seed():
    answers = [(k % 4, i) for i, k in enumerate(range(40))]

    def keep(seed):
        kept = harness._Keep(seed)
        for a in answers:
            kept.offer(a)
        return kept.answers()

    got = keep(11)
    assert got == keep(11)
    assert sorted(k for k, _ in got) == [0, 1, 2, 3]
    assert any(keep(s) != got for s in range(12, 20))
