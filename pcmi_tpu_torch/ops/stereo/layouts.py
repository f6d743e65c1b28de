"""The matcher's alternative-layout entry points (port of the volume-level
functions of ``pcmi_tpu/ops/stereo/pallas_kernels.py`` that run TPU kernels
#6-#8).

* :func:`sgm_aggregate_hwd`: ``sgm_aggregate_pallas`` (``:444``), 4-path
  SGM over an (H, W, D) volume through K4 ``sgm_hwd`` (``_dir_call``
  ``:417``);
* :func:`sgm_aggregate_blocked`: ``sgm_aggregate_pallas_blocked``
  (``:243``), 4-path SGM through a blocked (nb, S, Dp, 128) relayout,
  through K5 ``sgm_blocked`` (``_blocked_dir_sum`` ``:219``);
* :func:`right_disparity_fused`: ``right_disparity_fused_pallas``
  (``:901``), the right view's integer disparity from the left cost
  volume; with ``use_wdh_derive`` the derive runs in the (W, Dp, H) layout
  through K6 ``derive_right_wdh`` (``derive_right_wdh_pallas`` ``:829``).

All three give the same numbers as the main path's K1-K3 forms: the
reference's add orders commute, and its disparity (``BIG``) and spatial
(zero) padding wash out of the result. Volumes are float32 or bfloat16
(:func:`sgm_aggregate_hwd` float32 only, as the reference's); disparities
are padded to a multiple of 8 for either type, where the reference pads a
bfloat16 volume to 16 for its chip's tiles: the padding is cropped, so no
result depends on it. The main path calls only
:func:`right_disparity_fused` without ``use_wdh_derive``. The relayouts
around the kernels are plain PyTorch, as the reference's are XLA ops.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pcmi_tpu_torch.ops.stereo import kernels as K


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_volume(vol: torch.Tensor, dp: int, hp: int, wp: int) -> torch.Tensor:
    """(D, H, W) -> (dp, hp, wp): disparities padded with ``BIG``, then
    space with zeros (so padded columns are 0 for padded disparities too)."""
    d, h, w = vol.shape
    vol = F.pad(vol, (0, 0, 0, 0, 0, dp - d), value=K.BIG)
    return F.pad(vol, (0, wp - w, 0, hp - h), value=0.0)


def sgm_aggregate_hwd(vol_hwd: torch.Tensor, p1: float, p2: float,
                      band: int = 128, chunk: int = 32) -> torch.Tensor:
    """The (H, W, D) mean of the four SGM directions,
    ``(tb + bt + (lr + rl)) * 0.25``. ``band`` and ``chunk`` set the TPU's
    padding granularity and do not change the result; they are accepted
    for the reference's signature. A bfloat16 volume raises ``TypeError``,
    as the reference's kernel refuses one."""
    vert = K.sgm_hwd(vol_hwd, p1, p2, scan_axis=0, reverse=False)
    K.sgm_hwd(vol_hwd, p1, p2, scan_axis=0, reverse=True, out=vert)
    horiz = K.sgm_hwd(vol_hwd, p1, p2, scan_axis=1, reverse=False)
    K.sgm_hwd(vol_hwd, p1, p2, scan_axis=1, reverse=True, out=horiz)
    return (vert + horiz) * 0.25


def _blocked_dir_sum(vol_b: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """Forward, then backward + forward, over a (nb, S, Dp, 128) volume."""
    fwd = K.sgm_blocked(vol_b, p1, p2, reverse=False)
    return K.sgm_blocked(vol_b, p1, p2, reverse=True, prev=fwd)


def sgm_aggregate_blocked(vol_dhw: torch.Tensor, p1: float, p2: float,
                          chunk: int = 32) -> torch.Tensor:
    """The (D, H, W) mean of the four SGM directions through the blocked
    layout: D padded to a multiple of 8 with ``BIG``, H and W to a multiple
    of ``max(128, chunk)`` with zeros, each axis scanned over bands of 128
    contiguous lanes, the result cropped."""
    if vol_dhw.dim() != 3:
        raise ValueError(f"sgm_aggregate_blocked: expected (D, H, W), got "
                         f"{tuple(vol_dhw.shape)}")
    d, h, w = vol_dhw.shape
    gran = max(K.BAND, chunk)
    dp, hp, wp = _round_up(d, 8), _round_up(h, gran), _round_up(w, gran)
    vol = _pad_volume(vol_dhw, dp, hp, wp)

    # vertical: scan H; bands of 128 contiguous columns
    vb = vol.permute(1, 0, 2).reshape(hp, dp, wp // K.BAND, K.BAND)
    vert = _blocked_dir_sum(vb.permute(2, 0, 1, 3).contiguous(), p1, p2)
    vert = vert.permute(1, 2, 0, 3).reshape(hp, dp, wp).permute(1, 0, 2)

    # horizontal: scan W; bands of 128 contiguous rows
    hb = vol.permute(2, 0, 1).reshape(wp, dp, hp // K.BAND, K.BAND)
    horiz = _blocked_dir_sum(hb.permute(2, 0, 1, 3).contiguous(), p1, p2)
    horiz = horiz.permute(1, 2, 0, 3).reshape(wp, dp, hp).permute(1, 2, 0)

    return ((vert + horiz) * 0.25)[:d, :h, :w].contiguous()


def right_disparity_fused(vol_dhw: torch.Tensor, p1: float, p2: float,
                          d_min: int, stride: int = 1, fill: float = 1.0,
                          band: int = 128, chunk: int | None = None,
                          use_wdh_derive: bool = False,
                          subpixel: bool = False) -> torch.Tensor:
    """The right view's disparity ``[h, w]`` from the LEFT cost volume:
    derive the right volume, run the two horizontal SGM directions and take
    the WTA of their mean (K2; the integer argmin, or with ``subpixel`` the
    parabola, which the reference runs unfused).

    Without ``use_wdh_derive`` the derive is K3 on (D, H, W). With it the
    volume is padded as the reference pads it (D to a multiple of 8, H and
    W to ``lcm(band, chunk)``), moved to (Wp, Dp, Hp), derived there by K6
    and moved back to (D, H, W) for K1 and K2; the result is the same.
    ``band`` and ``chunk`` only set that padding."""
    if vol_dhw.dim() != 3:
        raise ValueError(f"right_disparity_fused: expected (D, H, W), got "
                         f"{tuple(vol_dhw.shape)}")
    d, h, w = vol_dhw.shape
    if use_wdh_derive:
        dp = _round_up(d, 8)
        if chunk is None:  # the reference's VMEM-budget rule
            chunk = 8
            while chunk < 64 and 4 * (2 * chunk) * dp * band * 4 <= 12e6:
                chunk *= 2
        gran = math.lcm(band, chunk)
        hp, wp = _round_up(h, gran), _round_up(w, gran)
        vol_h = _pad_volume(vol_dhw, dp, hp, wp).permute(2, 0, 1).contiguous()
        volr_h = K.derive_right_wdh(vol_h, d, w, d_min, stride, fill)
        del vol_h
        vol_r = volr_h.permute(1, 2, 0)[:d, :h, :w].contiguous()
        del volr_h
    else:
        vol_r = K.derive_right(vol_dhw, d_min, fill=fill, stride=stride)
    horiz = K.sgm_pair(vol_r, p1, p2, horizontal=True)
    del vol_r
    # the two-path mean's x0.5 is kept, so the best cost is the reference's
    disp, _, _ = K.wta(horiz, None, 0.5, d_min, stride, subpixel=subpixel,
                       with_margin=False)
    return disp
