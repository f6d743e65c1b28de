"""Driver of the single-pair height-map stream (``pair_stream``) for
volumes too deep for the reference's plain WTA to hold on one card.

Requests, answers and comparisons are ``pair_stream``'s. Only the
reference differs in how it computes: its winner-takes-all (the plain
form of K2, ``perfbench/reference/ops/stereo/kernels.wta``) runs on
column pieces of :data:`PIECE_COLS` and the pieces' planes are joined.
Every number of the WTA is a function of one pixel's column of the
volume (sums, the argmin and the minimum over D, the parabola, the
margin), so the pieces give the whole call's numbers bit for bit, while
the temporaries of one call (the combined volume, the shifted copies of
the parabola, the 64-bit distances of the margin: about five volumes at
once) shrink to a piece's.
"""

from __future__ import annotations

import contextlib

import torch

from perfbench import harness

# columns of a piece: at 1536 columns, a sixth of the call's temporaries
PIECE_COLS = 256

_stream = harness.load_module(harness.PERFBENCH / "drivers" / "pair_stream.py",
                              "perfbench_driver_pair_stream")


@contextlib.contextmanager
def wta_in_pieces(cols: int):
    """The reference's K2 taken on pieces of ``cols`` columns inside the
    block (a WTA that also returns the combined volume runs whole)."""
    from perfbench.reference.ops.stereo import kernels as ref_kernels

    whole = ref_kernels.wta

    def wta(a, b, scale, d_min, stride=1, subpixel=True, with_margin=True,
            with_aggregate=False):
        if with_aggregate:
            return whole(a, b, scale, d_min, stride, subpixel, with_margin,
                         with_aggregate)
        parts = [whole(a[..., x:x + cols],
                       None if b is None else b[..., x:x + cols], scale,
                       d_min, stride, subpixel, with_margin)
                 for x in range(0, a.shape[-1], cols)]
        return tuple(None if got[0] is None else torch.cat(got, 1)
                     for got in zip(*parts))

    ref_kernels.wta = wta
    try:
        yield
    finally:
        ref_kernels.wta = whole


class Driver(_stream.Driver):
    def reference(self, k: int, mode: str = "float32") -> dict:
        with wta_in_pieces(PIECE_COLS):
            return super().reference(k, mode)
