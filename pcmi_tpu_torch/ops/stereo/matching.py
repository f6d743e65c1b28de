"""Dense stereo matcher: census+AD cost, SGM, WTA, L/R check (port of
``pcmi_tpu/ops/stereo/matching.py``).

:func:`compute_disparity` follows the reference's structure. The default
(``aggregation="sgm"``, ``right_sgm="horizontal"``) runs its TPU branch:

* the census+AD cost volume (two census launches and K7 ``cost_volume``,
  one launch that writes the box-aggregated volume);
* left view: 4 SGM directions (K1 ``sgm_dir``; lr+rl and tb+bt each
  accumulated into one volume) -> combine ``(h + v) * 0.25`` + WTA with
  parabola and margin (K2 ``wta``);
* right view: derive the right volume (K3 ``derive_right``) -> the 2
  horizontal directions -> integer argmin (K2), in
  :func:`pcmi_tpu_torch.ops.stereo.layouts.right_disparity_fused`;
* the census cross-checker's own volume (K7 again) and WTA (K2).

The variants follow the reference's other branches, on the same kernels:
``right_sgm="derived"`` (the materialised left aggregate, shifted into the
right frame), ``"diagonal"`` (K2 also writes the combined aggregate, and
the right view is one diagonal argmin over it:
:func:`diag_right_disparity`), ``"full"`` (4-path SGM on the right
volume), ``right_subpixel``, ``aggregation="box"`` and the vertical
cross-checker (``band_check_mode="vertical"``).

Which device runs a step is decided only inside the kernel wrappers
(:mod:`pcmi_tpu_torch.ops.stereo.kernels`): CUDA tensors launch the
kernels, CPU tensors run their plain versions.
``StereoConfig.sgm_backend`` selects among the reference's TPU code paths
and is not read: every branch here computes what the reference's
``sgm_backend="pallas"`` branch does. ``cost_dtype`` sets the stored type
of every volume on both devices: ``"float32"``, or ``"bfloat16"`` with the
reference's rounding (the cost is computed in float32 and rounded once as
it is stored; the kernels keep their recurrence state and the (H, W)
planes in float32 and round each volume they store; sums and means of
stored volumes are bfloat16 operations). It is a mode with results of its
own, not only a smaller volume. ``"auto"`` is float32 on every device. The
reference builds the cost volume outside any Pallas kernel; here the card
builds it with the census kernel and K7 ``cost_volume``
(:func:`build_cost_volume`), bit for bit as their plain versions.

Where the reference scans a static disparity range or takes contiguous
row slices to avoid gathers on its chip (the L/R check, :func:`shift_rows`,
:func:`triangle_sum`), this port gathers: the result is the same element.
``row_shift`` composes the banded matcher's per-tile offsets into the cost
volume (:mod:`pcmi_tpu_torch.ops.stereo.banded`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from pcmi_tpu_torch.config import StereoConfig
from pcmi_tpu_torch.ops.fused import mul_add
from pcmi_tpu_torch.ops.stereo import kernels as K
from pcmi_tpu_torch.ops.stereo.kernels import _edge_pad, _sliding_sum
from pcmi_tpu_torch.ops.stereo.layouts import right_disparity_fused
from pcmi_tpu_torch.utils.profiling import active, span

# the kernels of the spans stereo.sgm and stereo.right: K1, K2, K3
_VIEW_KERNELS = ("sgm_dir", "wta", "derive_right")


class DisparityResult(NamedTuple):
    disparity: torch.Tensor        # (H, W) float32, signed px
    valid: torch.Tensor            # (H, W) bool, passed L/R check & masks
    cost: torch.Tensor             # (H, W) float32 best aggregated cost
    disparity_right: torch.Tensor  # (H, W) float32 right-image disparity
    # WTA uniqueness: (best cost outside +-1 px of the winner) - (best)
    margin: torch.Tensor | None = None
    # independent cross-matcher estimate (band recovery)
    check_disparity: torch.Tensor | None = None
    # the vertical cross-checker's own WTA uniqueness margin
    check_margin: torch.Tensor | None = None


def census_transform(img: torch.Tensor, window: int = 7):
    """Census transform into two int32 planes of 24 neighbour bits each
    (the reference's uint32 planes, same bit order): the census kernel on
    the card, :func:`~pcmi_tpu_torch.ops.stereo.kernels.census_plain` on
    the CPU."""
    return K.census(img, window)


def _vertical_box(vol: torch.Tensor, k: int) -> torch.Tensor:
    """Edge-padded mean over the H axis of a (D, H, W) volume: the
    aggregation of the vertical-support cross-checker."""
    padded = _edge_pad(vol, k // 2, -2)
    acc = _sliding_sum(padded, k, 1, vol.shape[1])
    if acc.dtype == torch.bfloat16:
        # a tensor divisor (made on the device, so no step waits for a
        # copy): a true bfloat16 division on every device, where a Python
        # scalar may become a product with the rounded reciprocal
        return acc / torch.full((), float(k), dtype=acc.dtype,
                                device=acc.device)
    return acc / k


def shift_rows(img: torch.Tensor, shifts: torch.Tensor, pad: int, fill,
               chunk: int = 1) -> torch.Tensor:
    """``out(y, x) = img(y, x - shifts[...])``, ``fill`` where that column
    lies outside the image: the column warp of the banded matcher
    (:mod:`pcmi_tpu_torch.ops.stereo.banded`). ``shifts`` is an integer
    tensor, one of:

    * (H,): one shift per row;
    * (H, W) with ``chunk == 1``: one shift per pixel;
    * (H, W // chunk) with ``chunk > 1``: one shift per ``chunk``-px span.

    ``pad`` must bound ``max |shifts|``. The reference takes contiguous
    slices of the ``pad``-padded rows (a slice start is clamped into the
    padded row, as a dynamic slice's is) to avoid gathers on its chip;
    here every form is one ``torch.gather`` of the same elements."""
    h, w = img.shape
    shifts = shifts.long()
    padded = img.new_full((h, w + 2 * pad), fill)
    padded[:, pad:pad + w] = img
    cols = torch.arange(w, device=img.device)
    if shifts.dim() == 1:
        start = torch.clamp(pad - shifts, 0, 2 * pad)
        idx = start[:, None] + cols
    elif chunk > 1:
        nc = w // chunk
        if nc * chunk != w or tuple(shifts.shape) != (h, nc):
            raise ValueError(f"chunked shifts must be (H, W/chunk); got "
                             f"{tuple(shifts.shape)} for W={w}, chunk={chunk}")
        starts = torch.clamp(
            pad + torch.arange(nc, device=img.device) * chunk - shifts,
            0, w + 2 * pad - chunk)
        idx = (starts[:, :, None] + torch.arange(chunk, device=img.device)
               ).reshape(h, w)
    else:
        idx = cols + pad - shifts
    return torch.gather(padded, 1, idx)


def triangle_sum(plane: torch.Tensor, shift: torch.Tensor, d_min: int,
                 n_grid: int, stride: int = 1,
                 edge: bool = False) -> torch.Tensor:
    """``sum_k max(1 - |shift - s_k| / stride, 0) * plane(y, x - s_k)`` over
    the grid shifts ``s_k = d_min + k * stride``, ``k < n_grid``: ``plane``
    linearly interpolated at ``x - shift`` on that grid, edge-extended past
    its columns (``edge``) or 0 there.

    The reference scans every grid shift and accumulates
    ``acc + wgt * shifted``, which its compiler fuses into one multiply-add
    per shift; a shift contributes only within ``stride`` of ``shift``, so
    this gathers the (at most three) neighbouring grid shifts and
    accumulates their terms in the same ascending order, each rounded as
    :func:`mul_add` says: on the CPU the same float32 sum."""
    h, w = plane.shape
    k_lo = torch.floor((shift - d_min) / stride)
    xs = torch.arange(w, dtype=torch.float32, device=plane.device)
    acc = torch.zeros_like(plane)
    for dk in (-1, 0, 1):
        k = k_lo + dk
        s = d_min + k * stride
        wgt = torch.clamp(1.0 - (shift - s).abs() / stride, min=0.0)
        src = xs - s
        ok = (k >= 0) & (k < n_grid)
        if edge:
            src = torch.clamp(src, 0, w - 1)
        else:
            ok = ok & (src >= 0) & (src <= w - 1)
        val = torch.gather(plane, 1, torch.where(ok, src, 0.0).long())
        acc = torch.where(ok, mul_add(wgt, val, acc), acc)
    return acc


def cost_dtype(cfg: StereoConfig) -> torch.dtype:
    """The stored type of the matcher's volumes (``StereoConfig.cost_dtype``;
    ``"auto"`` is float32 on every device)."""
    return torch.bfloat16 if cfg.cost_dtype == "bfloat16" else torch.float32


def build_cost_volume(left: torch.Tensor, right: torch.Tensor,
                      valid_l: torch.Tensor, valid_r: torch.Tensor,
                      cfg: StereoConfig,
                      row_shift: torch.Tensor | None = None,
                      row_shift_pad: int = 0,
                      row_shift_chunk: int = 1) -> torch.Tensor:
    """(D, H, W) box-aggregated census+AD matching cost, computed in
    float32 and stored as :func:`cost_dtype` says (one rounding); slice i
    holds disparity ``min_disparity + i * disp_stride``. On the card: two
    census launches and one of K7 (:func:`kernels.cost_volume
    <pcmi_tpu_torch.ops.stereo.kernels.cost_volume>`), which writes the
    volume once; on the CPU their plain versions.

    ``row_shift`` (the banded matcher) searches the global disparity
    ``row_shift[...] + d`` at slice d: the census planes are computed on
    the UNWARPED right view and shifted afterwards (:func:`shift_rows`, with
    ``row_shift_pad`` and ``row_shift_chunk``), as is ``valid_r``, so each
    cost is the full search's cost at the composed disparity."""
    h, w = left.shape
    dev = left.device
    planes = len(range(0, cfg.max_disp, cfg.disp_stride))
    with span("stereo.cost_volume", dev, planes=planes, rows=h, cols=w,
              census_window=cfg.census_window) as rec:
        launched = K.LAUNCHES["cost_volume"], K.LAUNCHES["census"]
        cl0, cl1 = census_transform(left, cfg.census_window)
        cr0, cr1 = census_transform(right, cfg.census_window)
        if row_shift is not None:
            sp, ck = row_shift_pad, row_shift_chunk
            right = shift_rows(right, row_shift, sp, 0.0, chunk=ck)
            valid_r = shift_rows(valid_r.bool(), row_shift, sp, False,
                                 chunk=ck)
            cr0 = shift_rows(cr0, row_shift, sp, 0, chunk=ck)
            cr1 = shift_rows(cr1, row_shift, sp, 0, chunk=ck)
        vol = K.cost_volume(left, (cl0, cl1), valid_l, right, (cr0, cr1),
                            valid_r, d_min=cfg.min_disparity, planes=planes,
                            stride=cfg.disp_stride, block=cfg.block_size,
                            census_window=cfg.census_window,
                            ad_weight=cfg.ad_weight, dtype=cost_dtype(cfg))
        rec.count(kernel_launches=K.LAUNCHES["cost_volume"] - launched[0],
                 census_launches=K.LAUNCHES["census"] - launched[1])
        return vol


def sgm_aggregate(vol: torch.Tensor, cfg: StereoConfig,
                  dirs: str = "4") -> torch.Tensor:
    """Semi-global aggregation of a (D, H, W) volume: the mean of the 4
    paths, of the 2 horizontal ("h") or the 2 vertical ("v") ones: the
    volume-level form of the reference's ``sgm_aggregate``, which the
    derived right view materialises (the main path and the diagonal right
    view combine inside the WTA)."""
    p1, p2 = cfg.sgm_p1, cfg.sgm_p2
    horiz = vert = None
    if dirs in ("4", "h"):
        horiz = K.sgm_pair(vol, p1, p2, horizontal=True)
        if dirs == "h":
            return horiz / 2.0
    vert = K.sgm_pair(vol, p1, p2, horizontal=False)
    if dirs == "v":
        return vert / 2.0
    return (horiz + vert) / cfg.sgm_paths


def wta_disparity(vol: torch.Tensor, d_min: int, with_margin: bool = False,
                  subpixel: bool = True, stride: int = 1):
    """Argmin over D + parabola sub-pixel (K2 on one volume). Returns
    ``(disp, best)``, or ``(disp, best, margin)`` with ``with_margin``."""
    disp, best, margin = K.wta(vol, None, 1.0, d_min, stride, subpixel,
                               with_margin)
    return (disp, best, margin) if with_margin else (disp, best)


def lr_consistency(disp_l: torch.Tensor, disp_r: torch.Tensor, thresh: float,
                   d_min: int, d_max: int, stride: int = 1) -> torch.Tensor:
    """``|dL(x) - dR(x - round(dL))| <= t``, with the lookup shift rounded
    to the ``stride`` grid; shifts outside [d_min, d_max] or the image
    fail."""
    h, w = disp_l.shape
    d_round = torch.round(disp_l / stride) * stride
    xs = torch.arange(w, dtype=torch.float32, device=disp_l.device)
    x2 = xs - d_round
    inb = (x2 >= 0) & (x2 < w) & (d_round >= d_min) & (d_round <= d_max)
    idx = torch.where(inb, x2, torch.zeros_like(x2)).long()
    dr = torch.gather(disp_r, 1, idx)
    return inb & ((disp_l - dr).abs() <= thresh)


def derive_right_volume(vol: torch.Tensor, d_min: int, fill: float = 1.0,
                        stride: int = 1) -> torch.Tensor:
    """Right-view volume ``C_R(d, y, x) = C_L(d, y, x + d)`` (K3)."""
    return K.derive_right(vol, d_min, fill=fill, stride=stride)


def diag_right_disparity(s_dhw: torch.Tensor, d_min: int,
                         stride: int = 1) -> torch.Tensor:
    """Right-view integer disparity as a diagonal argmin over the LEFT
    combined SGM aggregate ``S`` (D, H, W), as K2 writes it with
    ``with_aggregate``:

        disp_r[y, x] = d_min + stride * argmin_i S[i, y, x + d_i]

    (``d_i = d_min + i * stride``; candidates with ``x + d_i`` outside
    ``[0, w)`` are excluded, ties go to the lowest ``i``, all-excluded
    pixels take ``i = 0``): the argmin of the fill-padded ``"derived"``
    right volume without the derive, the 2-path SGM and the second WTA
    (the reference's ``diag_right_disparity_wdh``, an XLA scan there, plain
    PyTorch here)."""
    D, h, w = s_dhw.shape
    d_max = d_min + (D - 1) * stride
    lo, hi = max(0, -d_min), max(0, d_max)
    # rows padded with BIG, read through a view whose slice i starts d_i
    # columns to the right: one argmin (first minimum) over that view
    padded = F.pad(s_dhw, (lo, hi), value=K.BIG)
    wp = w + lo + hi
    shifted = padded.as_strided((D, h, w), (h * wp + stride, wp, 1),
                                lo + d_min)
    return d_min + stride * shifted.argmin(0).float()


def _view_launches() -> int:
    return sum(K.LAUNCHES[k] for k in _VIEW_KERNELS)


def _nbytes(*vols: torch.Tensor) -> int:
    return sum(v.numel() * v.element_size() for v in vols)


def _count_view(rec, vol: torch.Tensor, axes: str, launched: int,
                held: int) -> None:
    """The counts of a view's span (``stereo.sgm``, ``stereo.right``) over
    a volume shaped and stored as ``vol``: the planes, K1's plans along
    ``axes`` (``"plain"`` off the card, ``"none"`` without a K1 launch),
    the launches of K1-K3 since ``launched`` and ``volume_bytes``: ``held``,
    the bytes of the (D, H, W) volumes the view held at once at its peak;
    nothing when spans do not record."""
    if not active():
        return
    if vol.device.type != "cuda":
        plan = "plain"
    else:
        esize = vol.element_size()
        plan = ", ".join(K.sgm_pair_plan_text(tuple(vol.shape), a == "h",
                                              esize) for a in axes) or "none"
    rec.count(planes=vol.shape[0], plan=plan,
              launches=_view_launches() - launched,
              volume_bytes=held)


def compute_disparity(left: torch.Tensor, right: torch.Tensor,
                      valid_l: torch.Tensor, valid_r: torch.Tensor,
                      cfg: StereoConfig = StereoConfig(),
                      aggregation: str = "sgm",
                      noise_ratio: torch.Tensor | None = None,
                      row_shift: torch.Tensor | None = None,
                      row_shift_pad: int = 0,
                      row_shift_chunk: int = 1) -> DisparityResult:
    """Full two-direction matcher. ``aggregation`` is ``"sgm"`` (4-path
    semi-global smoothing before the WTA) or ``"box"`` (the box-aggregated
    cost alone). ``noise_ratio`` is the scene's SNR proxy
    (:func:`pcmi_tpu_torch.ops.normalize.snr_ratio`), derived from ``left``
    when not given. ``row_shift``, ``row_shift_pad`` and
    ``row_shift_chunk`` go to every cost volume built here (see
    :func:`build_cost_volume`). ``cfg.adapt_band_rows`` and
    ``cfg.hierarchical`` are not read: ``pair_core`` dispatches on them, as
    the reference's does."""
    if aggregation not in ("sgm", "box"):
        raise ValueError(f"compute_disparity: unknown aggregation "
                         f"{aggregation!r} (expected sgm/box)")
    shift = dict(row_shift=row_shift, row_shift_pad=row_shift_pad,
                 row_shift_chunk=row_shift_chunk)
    left = left.float()
    right = right.float()
    stride = cfg.disp_stride
    d_min = cfg.min_disparity
    p1, p2 = cfg.sgm_p1, cfg.sgm_p2
    # the diagonal right view is an integer argmin by construction
    sub_r = cfg.right_subpixel and cfg.right_sgm != "diagonal"

    vol_l = build_cost_volume(left, right, valid_l, valid_r, cfg, **shift)
    if aggregation == "box" or cfg.right_sgm == "derived":
        # one volume for both views: the left one, shifted into the right
        # frame (an SGM aggregate is filled above any aggregated cost, so
        # padding never wins the right WTA)
        if aggregation == "box":
            agg_l, fill = vol_l, 1.0
        else:
            agg_l, fill = sgm_aggregate(vol_l, cfg), 1e4
        del vol_l
        disp_l, cost_l, margin = K.wta(agg_l, None, 1.0, d_min, stride)
        agg_r = derive_right_volume(agg_l, d_min, fill=fill, stride=stride)
        del agg_l
        disp_r, _, _ = K.wta(agg_r, None, 1.0, d_min, stride,
                             subpixel=sub_r, with_margin=False)
        del agg_r
    else:
        # left view: 4 directions -> (h + v) * 0.25 -> WTA + parabola +
        # margin; for the diagonal right view K2 also writes the combined
        # aggregate (no combine pass, no derive, no second WTA)
        diagonal = cfg.right_sgm == "diagonal"
        dev = left.device
        with span("stereo.sgm", dev) as rec:
            launched = _view_launches()
            horiz = K.sgm_pair(vol_l, p1, p2, horizontal=True)
            vert = K.sgm_pair(vol_l, p1, p2, horizontal=False)
            disp_l, cost_l, margin, *agg_l = K.wta(
                horiz, vert, 0.25, d_min, stride, subpixel=True,
                with_margin=True, with_aggregate=diagonal)
            _count_view(rec, vol_l, "hv", launched,
                        _nbytes(vol_l, horiz, vert, *agg_l))
            del horiz, vert
        with span("stereo.right", dev) as rec:
            launched = _view_launches()
            if diagonal:
                _count_view(rec, vol_l, "", launched, _nbytes(vol_l, *agg_l))
                del vol_l
                disp_r = diag_right_disparity(agg_l.pop(), d_min, stride)
            elif cfg.right_sgm == "full":
                vol_r = derive_right_volume(vol_l, d_min, stride=stride)
                del vol_l
                horiz = K.sgm_pair(vol_r, p1, p2, horizontal=True)
                vert = K.sgm_pair(vol_r, p1, p2, horizontal=False)
                held = _nbytes(vol_r, horiz, vert)
                del vol_r
                disp_r, _, _ = K.wta(horiz, vert, 0.25, d_min, stride,
                                     subpixel=sub_r, with_margin=False)
                _count_view(rec, horiz, "hv", launched, held)
                del horiz, vert
            else:
                disp_r = right_disparity_fused(vol_l, p1, p2, d_min,
                                               stride=stride, subpixel=sub_r)
                # at its peak: the left volume, K3's right volume and the
                # right view's horizontal aggregate
                _count_view(rec, vol_l, "h", launched, 3 * _nbytes(vol_l))
                del vol_l

    ok = lr_consistency(disp_l, disp_r, cfg.lr_threshold_eff, d_min=d_min,
                        d_max=d_min + cfg.max_disp - 1, stride=stride)

    check = check_margin = None
    if cfg.band_recover:
        with span("stereo.checker", left.device):
            # independent cross-matcher; its inputs blend toward a sigma=1
            # Gaussian smooth as the scene's noise ratio rises
            cl, cr = left, right
            if cfg.noise_adapt > 0:
                from pcmi_tpu_torch.ops.filters import gaussian_filter
                from pcmi_tpu_torch.ops.normalize import snr_ratio

                if noise_ratio is None:
                    noise_ratio = snr_ratio(left, valid_l)
                t = cfg.noise_adapt * torch.clamp((noise_ratio - 0.5) / 0.5,
                                                  0.0, 1.0)
                cl = (1.0 - t) * left + t * gaussian_filter(left, sigma=1.0)
                cr = (1.0 - t) * right + t * gaussian_filter(right, sigma=1.0)
            if cfg.band_check_mode == "vertical":
                # census 3, a vertical-only box and the 2 vertical SGM
                # directions: ~1 px of horizontal fattening
                cfg_s = dataclasses.replace(
                    cfg, block_size=1, census_window=cfg.band_check_census)
                vol_s = build_cost_volume(cl, cr, valid_l, valid_r, cfg_s,
                                          **shift)
                vol_s = _vertical_box(vol_s, cfg.band_check_vbox)
                vert = K.sgm_pair(vol_s, p1, p2, horizontal=False)
                del vol_s
                check, _, check_margin = K.wta(vert, None, 0.5, d_min, stride)
                del vert
            else:
                # small-window, no-SGM cross-matcher
                cfg_s = dataclasses.replace(
                    cfg, block_size=cfg.band_check_block,
                    census_window=cfg.band_check_census)
                vol_s = build_cost_volume(cl, cr, valid_l, valid_r, cfg_s,
                                          **shift)
                check, _ = wta_disparity(vol_s, d_min, stride=stride)

    return DisparityResult(disparity=disp_l, valid=ok & valid_l, cost=cost_l,
                           disparity_right=disp_r, margin=margin,
                           check_disparity=check, check_margin=check_margin)


def refine_disparity(result: DisparityResult, guide: torch.Tensor,
                     cfg: StereoConfig = StereoConfig()) -> DisparityResult:
    """Edge-aware refinement: fill L/R-inconsistent pixels from confident
    neighbours (masked guided filter), re-smooth ``wls_passes - 1`` times,
    then re-admit filled pixels that pass the relaxed L/R threshold."""
    from pcmi_tpu_torch.ops.filters import guided_filter, masked_guided_filter

    disp = result.disparity
    valid = result.valid
    filled = masked_guided_filter(guide, disp, valid, radius=cfg.gf_radius,
                                  eps=cfg.gf_eps)
    disp = torch.where(valid, disp, filled)
    for _ in range(max(cfg.wls_passes - 1, 0)):
        smoothed = guided_filter(guide, disp, radius=cfg.gf_radius,
                                 eps=cfg.gf_eps)
        disp = torch.where(valid, disp, smoothed)
    readmit = lr_consistency(
        disp, result.disparity_right, cfg.lr_threshold_final_eff,
        d_min=cfg.min_disparity, d_max=cfg.min_disparity + cfg.max_disp - 1,
        stride=cfg.disp_stride)
    return DisparityResult(
        disparity=disp, valid=result.valid | readmit, cost=result.cost,
        disparity_right=result.disparity_right, margin=result.margin,
        check_disparity=result.check_disparity)
