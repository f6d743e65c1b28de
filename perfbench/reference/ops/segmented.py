"""Sort-segmented reductions (a frozen copy of the port's
``ops/segmented.py``).

The pattern is the reference's: sort the points by cell id once, carrying
their payloads, compute per-cell statistics, compare each point with its
cell's statistics, and write per-cell sums into the grid. One stable
``torch.sort`` does the sort.

The per-point segment totals keep the reference's arithmetic on purpose:
float32 running sums over blocks of 16384 sorted points (a block cumsum,
the prefix at the last segment start recovered by a cummax, carries
across blocks), forward and backward, ``total = fwd + bwd - x``. Those
totals carry an error of about one float32 ulp of the block's running
sum, not of the segment's own sum. For metre-scale heights that error
exceeds a cell's variance (``E[v^2] - mean^2`` cancels), so the sigma
gate's std is noise and the gate drops whole cells of a tile at random.
That thinning shapes the reference's fused products: on the D = 288
scene the gate keeps 38 % of the samples, and the fused DSM (cross-pair
median, ``min_pairs=3``) comes out at RMSE 1.20 m, completeness 0.781;
with exact float64 statistics the gate is inert at the ~9 samples a
0.6 m cell holds (a 3-sigma clip cannot reject any of n <= 10 samples)
and the same recipe gives RMSE 1.61 m at completeness 0.858 (H100 80GB
HBM3, 700 W). The port follows the reference; see ROADMAP.md Queue 3.

The grid write is the direct form: ``index_add_`` of the payloads into
the cells, accumulated in float64. The reference compacts its blocked
totals instead; the cell sums agree within that form's error.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

# block width of the reference's two-level scans
_LANES = 16384


def sort_by_segment(ids: torch.Tensor, *payloads: torch.Tensor):
    """Sort ``ids`` ascending (stable, as ``jax.lax.sort``), carrying
    ``payloads`` along. Returns ``(ids_sorted, payloads_sorted...,
    boundary)``; ``boundary[i]`` marks the first element of each equal-id
    run."""
    ids_s, order = torch.sort(ids, stable=True)
    boundary = torch.ones_like(ids_s, dtype=torch.bool)
    boundary[1:] = ids_s[1:] != ids_s[:-1]
    return (ids_s, *(p[order] for p in payloads), boundary)


def _block_carries(tails: torch.Tensor, any_b: torch.Tensor) -> torch.Tensor:
    """Running sum flowing into each block: ``c[0] = 0``, ``c[j + 1] =
    tails[j]`` after a block that holds a segment start, else ``c[j] +
    tails[j]`` (the reference's sequential carry scan, here as a prefix
    difference over the few blocks)."""
    nb = tails.numel()
    pex = F.pad(torch.cumsum(tails.double(), 0), (1, 0))
    idx = torch.arange(nb, device=tails.device)
    start = torch.cummax(torch.where(any_b, idx, -1), 0).values.clamp(min=0)
    after = pex[1:] - pex[start]
    return F.pad(after[:-1], (1, 0)).float()


def _blocked_run_sums(boundary: torch.Tensor,
                      xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Within-segment inclusive running sums of non-negative float32
    ``xs``, in the reference's blocked ``(nb, 16384)`` form."""
    n = boundary.shape[0]
    nb = -(-n // _LANES)
    pad = nb * _LANES - n
    # padding opens a fresh zero-weight segment: it cannot leak carries
    f2 = F.pad(boundary, (0, pad), value=True).view(nb, _LANES)
    seen = torch.cumsum(f2, 1) > 0
    any_b = f2.any(1)
    outs = []
    for x in xs:
        x2 = F.pad(x, (0, pad)).view(nb, _LANES)
        s2 = torch.cumsum(x2, 1)
        # prefix at the latest in-block boundary: s is monotone, so cummax
        base = torch.cummax(torch.where(f2, s2 - x2, -1.0), 1).values
        run_in = s2 - torch.where(seen, base.clamp(min=0.0), 0.0)
        carry = _block_carries(run_in[:, -1], any_b)
        out = run_in + torch.where(seen, 0.0, carry[:, None])
        outs.append(out.reshape(-1)[:n])
    return outs


def _totals_nonneg(boundary: torch.Tensor,
                   xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per-point segment totals of non-negative ``xs``: forward run +
    backward run - self."""
    fwd = _blocked_run_sums(boundary, xs)
    end = F.pad(boundary[1:], (0, 1), value=True)
    bwd = _blocked_run_sums(end.flip(0), [x.flip(0) for x in xs])
    return [f + b.flip(0) - x for f, b, x in zip(fwd, bwd, xs)]


def segment_totals_at_points(boundary: torch.Tensor,
                             *vals: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Per-point segment totals of each of ``vals`` (sorted domain).

    Signed values are shifted non-negative by their global minimum and
    the shift is restored through the segment's member count. As in the
    reference, ``vals`` must be finite everywhere: callers zero the values
    of zero-weight members first."""
    vals = [v.float() for v in vals]
    mins = [torch.clamp(v.min(), max=0.0) for v in vals]
    outs = _totals_nonneg(boundary, [torch.ones_like(vals[0]),
                                     *(v - m for v, m in zip(vals, mins))])
    counts = outs[0]
    return tuple(o + m * counts for o, m in zip(outs[1:], mins))


def robust_sigma_gate(boundary: torch.Tensor, v: torch.Tensor,
                      w0: torch.Tensor, sigma: float,
                      rounds: int = 3) -> torch.Tensor:
    """Iterated per-segment sigma-clipping weights (sorted domain).

    Per round: weighted mean and std per segment from the blocked totals,
    then members further than ``sigma`` stds (+1e-6) from the mean get
    weight 0; the next round recomputes from the survivors. The values are
    shifted by their valid minimum (``v - vmin``, clamped at 0) as in the
    reference, and zero-weight members are zeroed first, so a NaN riding
    along with ``w0 == 0`` cannot poison the tile."""
    valid = w0 > 0
    vmin = torch.where(valid, v, float("inf")).amin()
    vmin = torch.where(torch.isfinite(vmin), torch.clamp(vmin, max=0.0),
                       torch.zeros_like(vmin))
    vshift = torch.where(valid, v - vmin, 0.0)
    w = w0
    for _ in range(max(rounds, 1)):
        ws, vs, vq = _totals_nonneg(boundary,
                                    [w, w * vshift, w * vshift * vshift])
        ws = torch.clamp(ws, min=1e-12)
        mean = vs / ws
        std = torch.sqrt(torch.clamp(vq / ws - mean ** 2, min=0.0))
        w = w0 * ((vshift - mean).abs() <= sigma * std + 1e-6)
    return w


def grid_segment_sums(ids_sorted: torch.Tensor, boundary: torch.Tensor,
                      payloads: Sequence[torch.Tensor],
                      num: int) -> torch.Tensor:
    """Per-cell sums of sorted-by-id payloads, ``(num, k)`` float32 (summed
    in float64). Empty cells are exactly 0. ``boundary`` is kept for the
    reference's signature; the sums go straight into the cells."""
    del boundary
    vals = torch.stack([p.double() for p in payloads], dim=1)
    out = torch.zeros((num, vals.shape[1]), dtype=torch.float64,
                      device=vals.device)
    return out.index_add_(0, ids_sorted.long(), vals).float()
