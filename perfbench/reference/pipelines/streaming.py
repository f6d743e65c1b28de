"""The DSM accumulators of the port's ``pipelines/streaming.py``, a frozen
copy: a pair's weighted cell sums (``dsm_update``) and the cross-pair
median of the pairs' cell means (``dsm_finalize_multi``), as the
multi-day fusion uses them."""

from __future__ import annotations

import warnings
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from perfbench.reference.ops.pointcloud import cell_ids
from perfbench.reference.ops.segmented import (
    grid_segment_sums, robust_sigma_gate, sort_by_segment)


class StreamingDSM(NamedTuple):
    wsum: torch.Tensor    # (ny, nx) weight sums
    vsum: torch.Tensor    # (ny, nx) weighted value sums
    vsq: torch.Tensor     # (ny, nx) weighted squared sums


def empty_dsm(shape: Tuple[int, int], device="cuda") -> StreamingDSM:
    return StreamingDSM(*(torch.zeros(shape, device=device)
                          for _ in range(3)))


def dsm_update(acc: StreamingDSM, xy: torch.Tensor, values: torch.Tensor,
               weights: torch.Tensor, origin: Tuple[float, float],
               cell: float, shape: Tuple[int, int],
               robust_sigma: float = 0.0,
               robust_rounds: int = 3) -> StreamingDSM:
    """Add one tile's points into the running DSM sums.

    ``robust_sigma > 0`` first drops, per cell, this tile's samples beyond
    ``robust_sigma`` tile-stds from the tile-cell mean, iterated
    ``robust_rounds`` times (:func:`perfbench.reference.ops.segmented
    .robust_sigma_gate`): iterating lets the majority surface win a cell
    that straddles a height step."""
    ny, nx = shape
    ids, w = cell_ids(xy, weights, origin, cell, shape)
    v = values.reshape(-1).float()
    ids, v, w, boundary = sort_by_segment(ids, v, w)
    if robust_sigma > 0:
        w = robust_sigma_gate(boundary, v, w, robust_sigma,
                              rounds=robust_rounds)
    # zero-weight rows may carry any value (out-of-bounds or invalid
    # pixels): zero them so the sums stay finite
    v = torch.where(w > 0, v, 0.0)
    packed = grid_segment_sums(ids, boundary, (w, w * v, w * v * v), ny * nx)
    return StreamingDSM(wsum=acc.wsum + packed[:, 0].reshape(ny, nx),
                        vsum=acc.vsum + packed[:, 1].reshape(ny, nx),
                        vsq=acc.vsq + packed[:, 2].reshape(ny, nx))


def dsm_finalize(acc: StreamingDSM) -> Tuple[np.ndarray, np.ndarray]:
    """(dsm, count) on the host: the weighted mean, NaN in empty cells."""
    wsum = acc.wsum.cpu().numpy()
    mean = acc.vsum.cpu().numpy() / np.maximum(wsum, 1e-12)
    mean[wsum <= 0] = np.nan
    return mean, wsum


def dsm_finalize_multi(accs: Sequence[StreamingDSM], min_pairs: int = 1,
                       mad_max: float | None = None,
                       accept2_delta: float | None = None):
    """Cross-pair median finalisation on the host (numpy, as the
    reference). Returns ``(dsm, count, n_pairs)``.

    The per-cell median of the pairs' cell means outvotes single-pair
    blunders. ``min_pairs`` NaN-masks cells seen by fewer pairs;
    ``mad_max`` (m) masks cells whose cross-pair median absolute deviation
    exceeds it; ``accept2_delta`` (m, with ``min_pairs > 2``) re-admits
    cells seen by exactly two pairs whose means agree within it (their
    mean is used)."""
    means, counts = [], []
    for acc in accs:
        m, c = dsm_finalize(acc)
        means.append(m)
        counts.append(c)
    stack = np.stack(means)                       # (P, ny, nx)
    n_pairs = np.isfinite(stack).sum(axis=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN cells
        dsm = np.nanmedian(stack, axis=0)
        if mad_max is not None:
            mad = np.nanmedian(np.abs(stack - dsm[None]), axis=0)
            dsm = np.where(mad <= mad_max, dsm, np.nan)
        if min_pairs > 1:
            dsm = np.where(n_pairs >= min_pairs, dsm, np.nan)
        if accept2_delta is not None and min_pairs > 2:
            rng2 = np.nanmax(stack, axis=0) - np.nanmin(stack, axis=0)
            take2 = (n_pairs == 2) & (rng2 <= accept2_delta)
            dsm = np.where(take2, np.nanmean(stack, axis=0), dsm)
    return dsm, np.sum(counts, axis=0), n_pairs
