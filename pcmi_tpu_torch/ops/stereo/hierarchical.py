"""Coarse-to-fine dense matching (port of
``pcmi_tpu/ops/stereo/hierarchical.py``): a full signed search on the 2x
downsampled pair fixes a smooth base disparity; the full-resolution pass
searches only a small residual window around the base, against the right
view warped by it.

Validity: the coarse pass contributes its L/R verdict (upsampled), the
fine pass its own L/R check in the warped frame. The composed disparity is
``base + local``; the right-view disparity is resampled from the composed
field (unmatched cells take an out-of-range 1e9). The reference notes that
the base warp stretches texture across discontinuities, so the mode misses
the 1 m gate on built-up scenes; full search stays the default
(``StereoConfig.hierarchical=False``).

Both passes run the matcher on its kernels (K1-K3). Where the reference
scans the static disparity range to avoid gathers on its chip (the base
warp, the right-view resample), this port gathers or scatters the same
elements: the warp adds the neighbouring shifts' triangle-weighted terms
(:func:`pcmi_tpu_torch.ops.stereo.matching.triangle_sum`), and the
resample keeps, for each right pixel, the hit of the smallest shift (the
scan's "first hit wins").
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pcmi_tpu_torch.config import StereoConfig
from pcmi_tpu_torch.ops.filters import separable_median_filter
from pcmi_tpu_torch.ops.stereo.banded import cell_sum
from pcmi_tpu_torch.ops.stereo.matching import (
    DisparityResult, compute_disparity, mul_add, refine_disparity,
    triangle_sum)


def _down2(img: torch.Tensor) -> torch.Tensor:
    """2x2 mean pool (a trailing odd row or column is dropped)."""
    h, w = img.shape
    return cell_sum(img[:h // 2 * 2, :w // 2 * 2], 2) / 4


def _linear_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.resize(method="linear")``
    upsampling one axis, in its float32 arithmetic: half-pixel centres,
    triangle weights renormalised to sum 1 (so the border clamps)."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * float(inv_scale) - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[:, None]).abs()
    wts = torch.clamp(1 - x, min=0.0)
    total = wts.sum(0, keepdim=True)
    wts = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                      wts / torch.where(total != 0, total, 1.0),
                      torch.zeros_like(wts))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], wts, torch.zeros_like(wts))


def _up_last(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """Upsample the last axis to ``n_out``: each output is the product of
    its (at most two) nonzero :func:`_linear_weights` taps with the input,
    accumulated from the lower tap up, the upper one by one multiply-add
    (:func:`~pcmi_tpu_torch.ops.stereo.matching.mul_add`), as the
    reference's weight-matrix product computes it on the CPU."""
    wts = _linear_weights(x.shape[-1], n_out, x.device)
    k0 = (wts > 0).int().argmax(0)
    k1 = torch.clamp(k0 + 1, max=x.shape[-1] - 1)
    cols = torch.arange(n_out, device=x.device)
    w0 = wts[k0, cols]
    w1 = torch.where(k1 > k0, wts[k1, cols], 0.0)
    return mul_add(w1, x[..., k1], w0 * x[..., k0])


def _up2(img: torch.Tensor, shape) -> torch.Tensor:
    """Bilinear upsampling to ``shape`` as ``jax.image.resize(...,
    "linear")`` computes it on the reference's CPU backend (whatever the
    exact scale, odd sizes too): columns first, then rows."""
    h, w = shape
    out = _up_last(img, w) if img.shape[1] != w else img
    if out.shape[0] != h:
        out = _up_last(out.T, h).T
    return out


def _warp_right_by(right: torch.Tensor, base: torch.Tensor, d_min: int,
                   d_max: int) -> torch.Tensor:
    """``right_w(y, x) = right(y, x - base(y, x))``, linearly interpolated
    (0 outside the image; shifts limited to ``[d_min, d_max]``)."""
    return triangle_sum(right, base, d_min, d_max - d_min + 1)


def _resample_right_disp(disp: torch.Tensor, d_min: int, d_max: int):
    """The right view's disparity from the left one: ``d_R(x) = d_L(x + s)``
    for the smallest ``s`` in ``[d_min, d_max]`` with ``round(d_L(x + s))
    == s``. Returns ``(d_R, found)``; ``d_R`` is 0 where no left pixel
    lands."""
    h, w = disp.shape
    r = torch.round(disp)
    xs = torch.arange(w, dtype=torch.float32, device=disp.device)
    x_r = xs - r                       # where each left pixel lands
    ok = (r >= d_min) & (r <= d_max) & (x_r >= 0) & (x_r <= w - 1)
    none = d_max + 1
    s_best = torch.full((h, w + 1), none, dtype=torch.long,
                        device=disp.device)
    # column w collects the pixels that land nowhere
    idx = torch.where(ok, x_r, float(w)).long()
    s_best.scatter_reduce_(1, idx, torch.where(ok, r, float(none)).long(),
                           reduce="amin")
    s_best = s_best[:, :w]
    got = s_best <= d_max
    src = torch.where(got, s_best, 0) + torch.arange(w, device=disp.device)
    val = torch.gather(disp, 1, torch.where(got, src, 0))
    return torch.where(got, val, torch.zeros_like(val)), got


def compute_disparity_hierarchical(left: torch.Tensor, right: torch.Tensor,
                                   valid_l: torch.Tensor,
                                   valid_r: torch.Tensor, cfg: StereoConfig,
                                   local_disp: int = 16) -> DisparityResult:
    """Two-level matcher with :func:`compute_disparity`'s interface: a
    half-resolution full search, then a ``local_disp``-wide search around
    its upsampled (median-filtered) base. Both passes derive their own
    noise ratio, as the reference's do."""
    left = left.float()
    right = right.float()
    h, w = left.shape

    # coarse full-range pass at half resolution
    cfg_c = dataclasses.replace(
        cfg, max_disp=max(16, cfg.max_disp // 2),
        block_size=max(5, cfg.block_size // 2 | 1),
        census_window=min(cfg.census_window, 5),
        gf_radius=max(2, cfg.gf_radius // 2),
        speckle_median_size=max(5, cfg.speckle_median_size // 2 | 1))
    lc, rc = _down2(left), _down2(right)
    vlc = _down2(valid_l.float()) > 0.5
    vrc = _down2(valid_r.float()) > 0.5
    res_c = compute_disparity(lc, rc, vlc, vrc, cfg_c, aggregation="sgm")
    res_c = refine_disparity(res_c, lc, cfg_c)

    base = _up2(separable_median_filter(res_c.disparity, 5) * 2.0, (h, w))
    base_valid = _up2(res_c.valid.float(), (h, w)) > 0.5

    # fine local pass around the warped base
    d_min = cfg.min_disparity
    d_max = cfg.min_disparity + cfg.max_disp - 1
    base = torch.clamp(base, d_min + local_disp // 2, d_max - local_disp // 2)
    right_w = _warp_right_by(right, base, d_min, d_max)
    # the warped view's validity is valid_r warped by the same base
    valid_rw = _warp_right_by(valid_r.float(), base, d_min, d_max) > 0.99
    cfg_f = dataclasses.replace(cfg, max_disp=local_disp)
    res_f = compute_disparity(left, right_w, valid_l, valid_rw, cfg_f,
                              aggregation="sgm")

    disp = base + res_f.disparity
    disp_r, got = _resample_right_disp(disp, d_min, d_max)
    # unmatched right cells get an out-of-range sentinel: 0.0 is a legal
    # disparity and would pass downstream L/R rechecks
    return DisparityResult(
        disparity=disp, valid=res_f.valid & base_valid, cost=res_f.cost,
        disparity_right=torch.where(got, disp_r,
                                    torch.full_like(disp_r, 1e9)),
        margin=res_f.margin,
        check_disparity=(None if res_f.check_disparity is None
                         else base + res_f.check_disparity))
