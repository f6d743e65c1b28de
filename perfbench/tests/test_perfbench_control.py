"""The comparison that decides ``correct`` has to fail its control and
each fault a cell can have.

The control is the reference put in the program's place and computed in
a lower precision: bfloat16 cost volumes here (TF32 does not exist on the
CPU; the card test runs each cell's control at its own size: TF32, the
configurations' nearest lower precision, where it moves a number, else
the bfloat16 volumes). The faults are planted in the program underneath
a whole run, with the harness's look for a card skipped: an answer altered
where it is produced (a pair's disparities), half of the batch left out
(the fusion's pairs) and a step that returns its state unchanged (the
fusion's per-pair DSM update). No cell spans chips, so no exchange between
chips can be left out."""

import json

import pytest
import torch

from perfbench import harness
from perfbench.control import readings


def _control(root, cell: str, mode: str, seed: int = 5, device="cpu"):
    (row,) = readings(root, cell, seed, [mode], device)
    return {k: tuple(v) for k, v in row["checks"].items()}


@pytest.mark.parametrize("cell", ["d288_pair.strict", "d288_aoi.fuse"])
def test_bfloat16_control_is_not_correct(tiny, cell):
    torch.set_num_threads(4)
    got = _control(tiny, cell, "bfloat16")
    assert any(v > lim for v, lim in got.values()), got


def test_float32_reference_against_itself_is_correct(tiny):
    got = _control(tiny, "d288_pair.strict", "float32")
    assert all(v <= lim for v, lim in got.values()), got


def _altered_pair_core(monkeypatch):
    from pcmi_tpu_torch.pipelines import height_map

    real = height_map.pair_core

    def altered(*a, **kw):
        prod = real(*a, **kw)
        d = prod.disparity.clone()
        ys, xs = prod.valid.nonzero(as_tuple=True)
        d[ys[:16], xs[:16]] += 1.0   # sixteen valid pixels off by 1 px
        return prod._replace(disparity=d)

    monkeypatch.setattr(height_map, "pair_core", altered)


def _half_the_pairs(monkeypatch):
    from pcmi_tpu_torch.pipelines.multiday import MultiDayFusion

    real = MultiDayFusion.select

    def half(self, metas):
        chosen = real(self, metas)
        return chosen[:max(1, len(chosen) // 2)]

    monkeypatch.setattr(MultiDayFusion, "select", half)


def _state_unchanged(monkeypatch):
    from pcmi_tpu_torch.pipelines import multiday

    monkeypatch.setattr(multiday, "dsm_update", lambda acc, *a, **kw: acc)


@pytest.mark.parametrize("cell,plant", [
    ("d288_pair.strict", _altered_pair_core),
    ("d288_aoi.fuse", _half_the_pairs),
    ("d288_aoi.fuse", _state_unchanged),
])
def test_a_planted_fault_makes_the_run_incorrect(tiny, monkeypatch, cell,
                                                 plant):
    torch.set_num_threads(4)
    plant(monkeypatch)
    r = harness.run_cell(tiny, cell, 9, 0.2, False, device="cpu",
                         log=lambda s: None)
    assert r["correct"] is False, json.dumps(r["checks"])


# TF32 moves no number of the pair cell at its size (no matrix product on
# its path runs in TF32 there), so its control is the program's own
# bfloat16 mode
@pytest.mark.card
@pytest.mark.parametrize("cell,mode", [("d288_pair.strict", "bfloat16"),
                                       ("d288_aoi.fuse", "tf32")])
def test_controls_at_the_cells_own_size_are_not_correct(card, cell, mode):
    got = _control(harness.PERFBENCH.parent, cell, mode, seed=17,
                   device="cuda")
    assert any(v > lim for v, lim in got.values()), got
