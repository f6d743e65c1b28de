"""Tile-adaptive disparity range (port of ``pcmi_tpu/ops/stereo/banded.py``):
a coarse pass -> per-tile window offsets -> a narrow full-resolution search
around a smooth integer warp.

1. **Coarse pass**: the full matcher at ``1/adapt_coarse_scale`` resolution
   (:func:`coarse_config`: census and block 5, derived right view, no
   cross-checker, stride 1).
2. **Tile offsets**: for every ``adapt_band_rows x adapt_band_cols`` tile,
   the window offset that covers the most coarse-disparity mass, read off
   the tile's count-CDF (:func:`band_centers`), bilinearly interpolated to
   an integer offset field and clamped so every window stays inside the
   envelope (:func:`field_offsets`).
3. **Warp + narrow search**: the unchanged matcher with ``max_disp =
   adapt_local_disp`` against the offset-warped right view. The census
   planes are computed on the UNWARPED right view and warped afterwards
   (``build_cost_volume(row_shift=...)``), so each cost is the full
   search's cost at the composed disparity; global disparity is
   ``dl + o(y, x - dl)`` (:func:`compose_global`).

Both passes run on the matcher's kernels (K1-K3), on volumes of their own
shapes. Where the reference scans the static disparity range with
triangle weights to avoid gathers on its chip (:func:`compose_global`),
this port gathers the neighbouring grid shifts
(:func:`pcmi_tpu_torch.ops.stereo.matching.triangle_sum`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from pcmi_tpu_torch.config import StereoConfig, _round_up
from pcmi_tpu_torch.ops.stereo.matching import (
    DisparityResult, compute_disparity, refine_disparity, shift_rows,
    triangle_sum)


def cell_sum(img: torch.Tensor, scale: int) -> torch.Tensor:
    """Sums over the ``scale x scale`` cells of an (H, W) image whose sides
    are multiples of ``scale``, each added up in row-major order from 0, as
    the reference's reduction adds them (so the float32 sums agree)."""
    h, w = img.shape
    x = img.reshape(h // scale, scale, w // scale, scale)
    acc = torch.zeros_like(x[:, 0, :, 0])
    for i in range(scale):
        for j in range(scale):
            acc = acc + x[:, i, :, j]
    return acc


def pool_masked(img: torch.Tensor, mask: torch.Tensor, scale: int):
    """Masked ``scale x scale`` mean pool: ``(pooled, pooled_valid)``; a
    coarse cell is valid when at least half its fine pixels are."""
    h, w = img.shape
    ph, pw = (-h) % scale, (-w) % scale
    if ph or pw:
        img = F.pad(img, (0, pw, 0, ph))
        mask = F.pad(mask, (0, pw, 0, ph))
    cnt = cell_sum(mask.float(), scale)
    val = cell_sum(img * mask, scale) / torch.clamp(cnt, min=1.0)
    return val, cnt >= (scale * scale) / 2.0


def coarse_config(cfg: StereoConfig) -> StereoConfig:
    """Matcher config of the 1/scale coarse pass: small census and block
    (the downsample already aggregates), derived right view, no
    cross-checker, stride 1."""
    md = _round_up(-(-cfg.max_disp // cfg.adapt_coarse_scale), 16)
    return dataclasses.replace(cfg, max_disp=md, block_size=5,
                               census_window=5, disp_stride=1,
                               band_recover=False, right_sgm="derived",
                               adapt_band_rows=0)


def band_centers(disp_px: torch.Tensor, valid: torch.Tensor, n_tiles_y: int,
                 d_min: float, d_max: float, half: float,
                 n_tiles_x: int = 1, margin: float = 8.0, bins: int = 128,
                 min_count: int = 24):
    """``((ty, tx) centers, (ty, tx) counts)``: for each tile the offset
    whose window ``+-(half - margin)`` covers the most valid coarse
    disparities, from the tile's count-CDF over ``bins`` thresholds
    (argmax plateau-centred); tiles with fewer than ``min_count`` valid
    cells take the whole frame's offset. Rows and columns past an
    integral tiling are ignored."""
    hc, wc = disp_px.shape
    ty, tx = n_tiles_y, n_tiles_x
    rows, cols = hc // ty, wc // tx

    def tiles(a):
        return (a[:rows * ty, :cols * tx].reshape(ty, rows, tx, cols)
                .permute(0, 2, 1, 3).reshape(ty * tx, rows * cols))

    xb, mb = tiles(disp_px), tiles(valid)
    j = torch.arange(bins, dtype=torch.float32, device=disp_px.device)
    # the thresholds in the reference's float32 order of operations
    ts = d_min + (d_max - d_min) * j / (bins - 1)
    counts = ((xb[:, :, None] <= ts) & mb[:, :, None]).sum(
        1, dtype=torch.float32)   # (ty*tx, bins), cumulative over thresholds
    bin_w = (d_max - d_min) / (bins - 1)
    s = max(int((half - margin) / max(bin_w, 1e-6)), 1)

    def plateau_center(cum):
        cp = F.pad(cum[None], (s, s), mode="replicate")[0]
        cov = cp[:, 2 * s:] - cp[:, :-2 * s]   # mass within +-(half - margin)
        best = cov.amax(-1, keepdim=True)
        isb = (cov >= best - 1e-6).float()
        jstar = (isb * j).sum(-1) / torch.clamp(isb.sum(-1), min=1.0)
        return d_min + bin_w * jstar

    centers = plateau_center(counts)
    n_tile = counts[:, -1]
    g_center = plateau_center(counts.sum(0, keepdim=True))[0]
    centers = torch.where(n_tile >= min_count, centers, g_center)
    return centers.reshape(ty, tx), n_tile.reshape(ty, tx)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor):
    """``jnp.interp`` along the last axis of ``fp`` (``xp`` increasing):
    ``fp[i-1] + ((x - xp[i-1]) / (xp[i] - xp[i-1])) * (fp[i] - fp[i-1])``
    with ``i`` from a right-sided search, flat past both ends."""
    k = xp.shape[0]
    if k == 1:
        return fp[..., :1].expand(*fp.shape[:-1], x.shape[0])
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, k - 1)
    f = fp[..., i - 1] + ((x - xp[i - 1]) / (xp[i] - xp[i - 1])) * (
        fp[..., i] - fp[..., i - 1])
    f = torch.where(x < xp[0], fp[..., :1], f)
    return torch.where(x > xp[-1], fp[..., -1:], f)


def field_offsets(centers: torch.Tensor, tile_rows: int, tile_cols: int,
                  height: int, width: int, o_min: float, o_max: float,
                  x_coords: torch.Tensor | None = None) -> torch.Tensor:
    """Bilinear interpolation of the (ty, tx) tile centers to an int32
    offset field (separable, rows then columns; edge tiles extend flat),
    clamped to ``[o_min, o_max]`` and rounded half to even. ``x_coords``
    overrides the column sample positions (the chunked warp samples chunk
    centres: an (H, n_chunks) field)."""
    ty, tx = centers.shape
    dev = centers.device
    yc = (torch.arange(ty, dtype=torch.float32, device=dev) + 0.5) * tile_rows
    xc = (torch.arange(tx, dtype=torch.float32, device=dev) + 0.5) * tile_cols
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = (torch.arange(width, dtype=torch.float32, device=dev)
          if x_coords is None else x_coords.float())
    coly = _interp(ys, yc, centers.float().T).T     # (H, tx)
    full = _interp(xs, xc, coly)                    # (H, len(xs))
    return torch.round(torch.clamp(full, o_min, o_max)).to(torch.int32)


def compose_global(disp_local: torch.Tensor, o_chunks: torch.Tensor,
                   chunk: int, d_min: int, d_max: int,
                   stride: int = 1) -> torch.Tensor:
    """Global disparity ``dl + o(y, x - dl)``: the offset at the matched
    RIGHT position, linearly interpolated between the grid shifts
    ``d_min, d_min + stride, ... , d_max + stride`` around ``dl`` (the
    offset plane edge-extended past the image). Row-constant offsets
    (one chunk) compose exactly."""
    h, w = disp_local.shape
    if o_chunks.shape[1] == 1:
        return disp_local + o_chunks.float()
    o_plane = (torch.repeat_interleave(o_chunks, chunk, dim=1)[:, :w]
               if chunk > 1 else o_chunks).float()
    n_grid = len(range(d_min, d_max + stride, stride))
    return disp_local + triangle_sum(o_plane, disp_local, d_min, n_grid,
                                     stride, edge=True)


def _warp_chunk(cfg: StereoConfig, width: int) -> int:
    """The warp's chunk width: whole rows in row mode, else the largest
    power-of-two divisor of ``width`` that is <= ``adapt_warp_chunk``."""
    if cfg.adapt_band_cols == 0:
        return width
    ck = cfg.adapt_warp_chunk
    while ck > 1 and width % ck:
        ck //= 2
    return max(ck, 1)


def _offset_bounds(cfg: StereoConfig):
    """The range of window offsets that keeps an ``adapt_local_disp``
    window inside the ``max_disp`` envelope (the envelope's centre when
    the window is as wide)."""
    d_min_g = cfg.min_disparity
    d_max_g = cfg.min_disparity + cfg.max_disp - 1
    half = cfg.adapt_local_disp // 2
    o_lo, o_hi = float(d_min_g + half), float(d_max_g - (half - 1))
    if o_lo > o_hi:
        o_lo = o_hi = float(d_min_g + cfg.max_disp // 2)
    return o_lo, o_hi


def _offsets_from_coarse(left, right, valid_l, valid_r, cfg: StereoConfig,
                         noise_ratio=None):
    """``((H, W/chunk) int32 offsets sampled at the warp chunks' centres,
    the coarse pass's result)`` for the configured tiling."""
    h, w = left.shape
    scale = cfg.adapt_coarse_scale
    rows = cfg.adapt_band_rows
    cols = cfg.adapt_band_cols or w
    ty, tx = max(h // rows, 1), max(w // cols, 1)
    d_min_g = cfg.min_disparity
    d_max_g = cfg.min_disparity + cfg.max_disp - 1
    half = cfg.adapt_local_disp // 2
    o_lo, o_hi = _offset_bounds(cfg)

    lc, vlc = pool_masked(left, valid_l, scale)
    rc, vrc = pool_masked(right, valid_r, scale)
    cres = compute_disparity(lc, rc, vlc, vrc, coarse_config(cfg),
                             aggregation="sgm", noise_ratio=noise_ratio)
    centers, _ = band_centers(cres.disparity * scale, cres.valid, ty,
                              float(d_min_g), float(d_max_g),
                              half=float(half), n_tiles_x=tx)
    ck = _warp_chunk(cfg, w)
    xs = (torch.arange(w // ck, dtype=torch.float32, device=left.device)
          + 0.5) * ck
    o_chunks = field_offsets(centers, rows, cols, h, w // ck, o_lo, o_hi,
                             x_coords=xs)
    return o_chunks, cres


def banded_disparity(left: torch.Tensor, right: torch.Tensor,
                     valid_l: torch.Tensor, valid_r: torch.Tensor,
                     cfg: StereoConfig,
                     noise_ratio: torch.Tensor | None = None,
                     offsets: torch.Tensor | None = None):
    """The tile-adaptive matcher: ``(res0, res, photo, o_chunks)``.

    ``res0`` / ``res`` are :func:`compute_disparity` / :func:`refine_disparity`
    results with ``disparity`` and ``check_disparity`` recomposed to GLOBAL
    coordinates (``margin``, ``valid`` and ``cost`` do not depend on the
    warp); ``disparity_right`` stays in the warped frame, where its only
    consumer (refinement's L/R recheck) has already run. ``photo`` is the
    refined field's photoconsistency, computed in the warped frame (the
    global frame's values at ``adapt_local_disp`` grid shifts instead of
    ``max_disp``).

    ``offsets`` replaces the coarse pass with a caller's (H,) or (H, W)
    offset field (clamped to the envelope, rounded, sampled at the warp
    chunks' centres): a hook for tests and experts."""
    from pcmi_tpu_torch.pipelines.height_map import photoconsistency

    h, w = left.shape
    o_lo, o_hi = _offset_bounds(cfg)
    chunk = _warp_chunk(cfg, w)
    nc = w // chunk
    if offsets is not None:
        o = torch.round(torch.clamp(offsets.float(), o_lo, o_hi)).to(
            torch.int32)
        if o.dim() == 1:
            o_chunks = o[:, None].expand(h, nc).contiguous()
        else:
            o_chunks = o[:, chunk // 2::chunk][:, :nc]
    else:
        o_chunks, _ = _offsets_from_coarse(left, right, valid_l, valid_r,
                                           cfg, noise_ratio)

    # the narrow matcher, the offset composed inside the cost build
    pad = cfg.max_disp // 2 + 1
    lcfg = dataclasses.replace(cfg, max_disp=cfg.adapt_local_disp,
                               adapt_band_rows=0)
    res0 = compute_disparity(left, right, valid_l, valid_r, lcfg,
                             aggregation="sgm", noise_ratio=noise_ratio,
                             row_shift=o_chunks, row_shift_pad=pad,
                             row_shift_chunk=chunk)
    res = refine_disparity(res0, left, lcfg)
    # photoconsistency reads single right intensities: the plain warp is
    # exact for it
    right_w = shift_rows(right, o_chunks, pad, 0.0, chunk=chunk)
    d_lo = lcfg.min_disparity
    d_hi = lcfg.min_disparity + lcfg.max_disp - 1
    photo = photoconsistency(left, right_w, res.disparity, d_min=d_lo,
                             d_max=d_hi, stride=lcfg.disp_stride)

    def to_global(r: DisparityResult) -> DisparityResult:
        def g(d):
            return None if d is None else compose_global(
                d, o_chunks, chunk, d_lo, d_hi, stride=lcfg.disp_stride)

        return r._replace(disparity=g(r.disparity),
                          check_disparity=g(r.check_disparity))

    return to_global(res0), to_global(res), photo, o_chunks


def window_coverage(left, right, valid_l, valid_r,
                    cfg: StereoConfig) -> torch.Tensor:
    """Diagnostic: the share of coarse-valid pixels whose coarse disparity
    lies inside their tile's local window, with 4 px of slack for coarse
    error (near 1.0: ``adapt_local_disp`` covers the scene's relief)."""
    o_chunks, cres = _offsets_from_coarse(left, right, valid_l, valid_r, cfg)
    scale = cfg.adapt_coarse_scale
    half = cfg.adapt_local_disp // 2
    disp_c = cres.disparity * scale
    hc, wc = disp_c.shape
    chunk = _warp_chunk(cfg, left.shape[1])
    o_field = torch.repeat_interleave(o_chunks, chunk, dim=1)
    oc = o_field[scale // 2::scale, scale // 2::scale][:hc, :wc]
    inside = (disp_c - oc.float()).abs() <= (half - 4)
    n = torch.clamp(cres.valid.sum(), min=1)
    return (inside & cres.valid).sum() / n
