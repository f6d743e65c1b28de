"""The pair stream whose reference takes its WTA on column pieces
(``drivers/pair_stream_pieces.py``): the pieces give the whole call's
numbers bit for bit, and its reference answer is ``pair_stream``'s."""

import json

import pytest
import torch

from perfbench import harness
from perfbench.reference.ops.stereo import kernels as ref_kernels

PIECES = harness.load_module(
    harness.PERFBENCH / "drivers" / "pair_stream_pieces.py",
    "perfbench_driver_pair_stream_pieces")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("two,subpixel,margin", [(True, True, True),
                                                 (False, True, False),
                                                 (False, False, False),
                                                 (False, True, True)])
@pytest.mark.parametrize("cols", [1, 7, 64, 500])
def test_wta_in_pieces_is_the_whole_wta(dtype, two, subpixel, margin, cols):
    g = torch.Generator().manual_seed(cols)
    a = torch.rand(24, 5, 61, generator=g).to(dtype)
    b = torch.rand(24, 5, 61, generator=g).to(dtype) if two else None
    a[:, :, 3] = 0.5            # ties: the first minimum wins in both
    a[:2, :, 9] = -1.0          # a best at the edge of the range
    args = (a, b, 0.25 if two else 0.5, -11, 2, subpixel, margin)
    whole = ref_kernels.wta(*args)
    with PIECES.wta_in_pieces(cols):
        assert ref_kernels.wta is not ref_kernels.wta_plain
        parts = ref_kernels.wta(*args)
    assert ref_kernels.wta is ref_kernels.wta_plain
    for w, p in zip(whole, parts):
        assert (w is None) == (p is None)
        if w is not None:
            assert torch.equal(w, p)


def test_the_aggregate_form_runs_whole():
    a = torch.rand(6, 3, 9)
    with PIECES.wta_in_pieces(2):
        got = ref_kernels.wta(a, a, 0.25, 0, 1, True, True, True)
    assert torch.equal(got[3], (a + a) * 0.25)


def test_pieces_reference_is_the_pair_streams(tiny):
    cell = harness.Cell(tiny, "highrise_pair.strict")
    assert cell.traffic["driver"] == "pair_stream_pieces"
    stream = json.loads((harness.PERFBENCH / "traffic" / "pair_cycle.json"
                         ).read_text())
    assert cell.traffic["limits"] == stream["limits"]
    torch.set_num_threads(4)
    drv = PIECES.Driver(cell.config, cell.traffic, 2**31 + 5, "cpu")
    whole = PIECES._stream.Driver.reference(drv, 0)
    parts = drv.reference(0)
    assert drv.compare(parts, whole) == {"valid_mismatch": 0.0,
                                         "disp_gap_px": 0.0, "xyz_gap_m": 0.0}
