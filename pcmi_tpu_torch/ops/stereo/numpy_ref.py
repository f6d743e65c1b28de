"""CPU NumPy reference for the dense stereo matcher (the port's own copy
of ``pcmi_tpu/ops/stereo/numpy_ref.py``: the port imports nothing of
``pcmi_tpu``).

The oracle the box matcher is held against: the same census + AD cost,
box aggregation, WTA + parabola sub-pixel and L/R consistency rule as
:mod:`pcmi_tpu_torch.ops.stereo.matching`, and ``aggregation="sgm"`` adds
the same 4-path semi-global regularisation. The matching envelope mirrors
the SGBM setup the reference system used: a signed search range
``[-max_disp/2, max_disp/2)``, block aggregation, L/R consistency
thresholds of 1.5 / 3.0 px.
"""

from __future__ import annotations

import numpy as np


def census_transform_np(img: np.ndarray, window: int = 7):
    """Census transform: per-pixel bit-string of (neighbour < centre).

    Returns two uint32 planes packing up to 48 comparison bits (window 7x7
    minus centre). Border pixels compare against replicated edges.
    """
    h, w = img.shape
    r = window // 2
    padded = np.pad(img, r, mode="edge")
    bits0 = np.zeros((h, w), np.uint32)
    bits1 = np.zeros((h, w), np.uint32)
    idx = 0
    for dy in range(window):
        for dx in range(window):
            if dy == r and dx == r:
                continue
            neigh = padded[dy : dy + h, dx : dx + w]
            bit = (neigh < img).astype(np.uint32)
            if idx < 24:
                bits0 |= bit << np.uint32(idx)
            else:
                bits1 |= bit << np.uint32(idx - 24)
            idx += 1
    return bits0, bits1


def _popcount32(x: np.ndarray) -> np.ndarray:
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0x3F


def matching_cost_np(
    left: np.ndarray,
    right: np.ndarray,
    valid_l: np.ndarray,
    valid_r: np.ndarray,
    d: int,
    census_l,
    census_r,
    ad_weight: float = 0.3,
    census_window: int = 7,
    invalid_cost: float = 1.0,
):
    """Unit-scale matching cost for one signed disparity ``d``.

    Convention: ``right[y, x - d]`` matches ``left[y, x]`` (``x2 = x1 - d``,
    the sign the triangulation layer assumes; positive disparity = higher
    ground under positive ``disp_gain``).
    """
    h, w = left.shape
    n_census = census_window * census_window - 1
    shifted = np.full_like(right, np.nan)
    sv = np.zeros_like(valid_r)
    s0 = np.zeros_like(census_r[0])
    s1 = np.zeros_like(census_r[1])
    if d >= 0:
        if d < w:
            shifted[:, d:] = right[:, : w - d]
            sv[:, d:] = valid_r[:, : w - d]
            s0[:, d:] = census_r[0][:, : w - d]
            s1[:, d:] = census_r[1][:, : w - d]
    else:
        if -d < w:
            shifted[:, :d] = right[:, -d:]
            sv[:, :d] = valid_r[:, -d:]
            s0[:, :d] = census_r[0][:, -d:]
            s1[:, :d] = census_r[1][:, -d:]
    ham = _popcount32(census_l[0] ^ s0) + _popcount32(census_l[1] ^ s1)
    census_cost = ham.astype(np.float32) / n_census
    ad = np.minimum(np.abs(left - np.nan_to_num(shifted)), 0.5) / 0.5
    cost = (1.0 - ad_weight) * census_cost + ad_weight * ad
    ok = valid_l & sv
    return np.where(ok, cost, invalid_cost).astype(np.float32)


def box_aggregate_np(cost: np.ndarray, block: int = 15) -> np.ndarray:
    """Mean filter over ``block x block`` (edge-padded), per disparity."""
    r = block // 2
    padded = np.pad(cost, ((r, r), (r, r)), mode="edge")
    ii = padded.cumsum(0).cumsum(1)
    ii = np.pad(ii, ((1, 0), (1, 0)))
    h, w = cost.shape
    out = (
        ii[block : block + h, block : block + w]
        - ii[:h, block : block + w]
        - ii[block : block + h, :w]
        + ii[:h, :w]
    )
    return (out / (block * block)).astype(np.float32)


def disparity_wta_np(
    left: np.ndarray,
    right: np.ndarray,
    valid_l: np.ndarray,
    valid_r: np.ndarray,
    max_disp: int = 288,
    block: int = 15,
    ad_weight: float = 0.3,
    census_window: int = 7,
    aggregation: str = "box",
):
    """Winner-takes-all disparity with parabola sub-pixel refinement.

    ``aggregation="sgm"`` adds the 4-path semi-global pass after box
    aggregation (the matcher's default work). Returns
    ``(disparity, best_cost)``; disparity is float px in
    ``[-max_disp/2, max_disp/2)``.
    """
    h, w = left.shape
    d_min = -max_disp // 2
    census_l = census_transform_np(left, census_window)
    census_r = census_transform_np(right, census_window)

    costs = []
    for di in range(max_disp):
        d = d_min + di
        c = matching_cost_np(
            left, right, valid_l, valid_r, d, census_l, census_r,
            ad_weight, census_window,
        )
        c = box_aggregate_np(c, block)
        costs.append(c)

    vol = np.stack(costs)  # (D, H, W)
    if aggregation == "sgm":
        vol = sgm_aggregate_np(vol)
    best_d = vol.argmin(0)
    yy, xx = np.mgrid[:h, :w]
    best = vol[best_d, yy, xx]
    prev_at_best = vol[np.clip(best_d - 1, 0, max_disp - 1), yy, xx]
    next_at_best = vol[np.clip(best_d + 1, 0, max_disp - 1), yy, xx]

    denom = prev_at_best - 2 * best + next_at_best
    offset = np.where(
        (denom > 1e-9) & (best_d > 0) & (best_d < max_disp - 1),
        0.5 * (prev_at_best - next_at_best) / np.maximum(denom, 1e-9),
        0.0,
    )
    disp = (d_min + best_d + np.clip(offset, -1, 1)).astype(np.float32)
    return disp, best


def sgm_aggregate_np(vol: np.ndarray, p1: float = 0.03, p2: float = 0.48):
    """4-path semi-global aggregation (Hirschmüller 2008), NumPy reference.

    The recurrence of the matcher's SGM directions (L/R/T/B paths,
    averaged), so the oracle does the same regularisation work as the
    matcher."""
    D, h, w = vol.shape
    out = np.zeros_like(vol)
    for axis, reverse in ((2, False), (2, True), (1, False), (1, True)):
        span = vol.shape[axis]
        acc = np.zeros_like(vol)
        prev = None
        order = range(span - 1, -1, -1) if reverse else range(span)
        for i in order:
            c = vol[:, :, i] if axis == 2 else vol[:, i, :]
            if prev is None:
                cur = c.copy()
            else:
                m = prev.min(0)
                inf_row = np.full((1, prev.shape[1]), np.inf, vol.dtype)
                up = np.concatenate([inf_row, prev[:-1]])
                dn = np.concatenate([prev[1:], inf_row])
                best = np.minimum(np.minimum(prev, m[None] + p2),
                                  np.minimum(up + p1, dn + p1))
                cur = c + best - m[None]
            if axis == 2:
                acc[:, :, i] = cur
            else:
                acc[:, i, :] = cur
            prev = cur
        out += acc
    return (out / 4.0).astype(np.float32)


def lr_consistency_np(disp_l: np.ndarray, disp_r: np.ndarray, thresh: float = 1.5):
    """Left/right consistency mask.

    With ``x2 = x1 - dL(x1)`` and the right map satisfying
    ``x1 = x2 + dR(x2)``, consistency is ``|dL(x1) - dR(x1 - dL(x1))| <= t``
    — the vectorised gather-compare of reference
    ``left_right_consistency`` (``disparity.py:229-250``).
    """
    h, w = disp_l.shape
    xs = np.arange(w)[None, :].repeat(h, 0)
    x2 = np.rint(xs - disp_l).astype(np.int64)
    inb = (x2 >= 0) & (x2 < w)
    x2c = np.clip(x2, 0, w - 1)
    ys = np.arange(h)[:, None].repeat(w, 1)
    diff = np.abs(disp_l - disp_r[ys, x2c])
    return inb & (diff <= thresh)


def stereo_pipeline_np(
    left: np.ndarray,
    right: np.ndarray,
    valid_l: np.ndarray | None = None,
    valid_r: np.ndarray | None = None,
    max_disp: int = 288,
    block: int = 15,
    lr_thresh: float = 1.5,
    aggregation: str = "box",
):
    """Full CPU reference: WTA both directions + L/R consistency.

    The right-image disparity is computed by swapping and mirroring so the
    same matcher code runs both directions (the reference instead builds a
    dedicated right matcher via ``ximgproc.createRightMatcher``,
    ``disparity.py:263-283``).
    """
    if valid_l is None:
        valid_l = left >= 0
    if valid_r is None:
        valid_r = right >= 0
    disp_l, cost_l = disparity_wta_np(left, right, valid_l, valid_r, max_disp,
                                      block, aggregation=aggregation)
    # Right disparity via mirror trick: flip x of both images and swap roles;
    # dR(x2) in the flipped frame equals the unflipped dR.
    fl = left[:, ::-1]
    fr = right[:, ::-1]
    fvl = valid_l[:, ::-1]
    fvr = valid_r[:, ::-1]
    disp_r_f, _ = disparity_wta_np(fr, fl, fvr, fvl, max_disp, block,
                                   aggregation=aggregation)
    disp_r = disp_r_f[:, ::-1]
    mask = lr_consistency_np(disp_l, disp_r, lr_thresh)
    return disp_l, disp_r, mask & valid_l
