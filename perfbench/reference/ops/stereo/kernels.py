"""Plain PyTorch forms of the matcher's three main-path kernels: one SGM
direction (K1), combine + winner-takes-all (K2) and the right-view derive
(K3). A frozen copy of the port's plain versions
(``ops/stereo/kernels.py``), on any device, with no CUDA launch.
"""

from __future__ import annotations

import torch

BIG = 1e9  # "no neighbour" / "never wins"


def _scan_plain(cost: torch.Tensor, axis: int, d_axis: int, p1: float,
                p2: float, reverse: bool, out: torch.Tensor | None,
                round_first: bool = True) -> torch.Tensor:
    """One SGM direction along ``axis`` of ``cost`` (``matching._sgm_scan``);
    ``d_axis`` is the disparity axis of a scan step's state. With ``out``
    given the direction is added into it (in place), else a new volume is
    returned. The output is preallocated and written step by step.

    The state is float32 whatever ``cost`` stores. A bfloat16 ``out`` takes
    the direction by one of the reference's two rules: ``round_first``
    rounds the direction to bfloat16 and adds two stored values (K1: ``lr +
    rl`` of two stored volumes), else the float32 state is added and the sum
    rounded once (K5's ``prev`` form). In float32 the two are one."""
    n = cost.shape[axis]
    acc = out is not None
    if out is None:
        out = torch.empty_like(cost)
    prev = torch.zeros_like(cost.select(axis, 0), dtype=torch.float32)
    nd = prev.shape[d_axis]
    big = torch.full_like(prev.narrow(d_axis, 0, 1), BIG)
    for t in range(n):
        s = n - 1 - t if reverse else t
        c = cost.select(axis, s)
        m = prev.amin(d_axis, keepdim=True)
        up = torch.cat([big, prev.narrow(d_axis, 0, nd - 1)], d_axis)
        dn = torch.cat([prev.narrow(d_axis, 1, nd - 1), big], d_axis)
        best = torch.minimum(torch.minimum(prev, m + p2),
                             torch.minimum(up + p1, dn + p1))
        prev = c + best - m
        o = out.select(axis, s)
        if not acc:
            o.copy_(prev)
        elif round_first:
            o.add_(prev.to(o.dtype))
        else:
            o.copy_(prev + o)
    return out


def sgm_dir_plain(cost: torch.Tensor, p1: float, p2: float, horizontal: bool,
                  reverse: bool, out: torch.Tensor | None = None) -> torch.Tensor:
    """One SGM direction over a (D, H, W) volume (``matching._sgm_scan``).

    ``horizontal`` scans along W (state (D, H)), else along H (state
    (D, W)); ``reverse`` scans from the far end. With ``out`` given the
    direction is added into it (in place), else a new volume is returned.
    A bfloat16 volume is widened as it is read and the direction rounded
    as it is stored; added into ``out`` it is rounded first, so ``out``
    is the bfloat16 sum of two stored volumes, as the reference's
    ``lr + rl``."""
    return _scan_plain(cost, 2 if horizontal else 1, 0, p1, p2, reverse, out)


def wta_plain(a: torch.Tensor, b: torch.Tensor | None, scale: float,
              d_min: int, stride: int = 1, subpixel: bool = True,
              with_margin: bool = True, with_aggregate: bool = False):
    """Combine ``s = (a + b) * scale`` (or ``a * scale``) and take the WTA
    in the XLA form of ``matching.wta_disparity``.

    Returns ``(disp, best, margin)``; ``margin`` is None without
    ``with_margin``. With ``with_aggregate`` the combined (D, H, W) volume
    ``s`` is a fourth value (``sgm4_wta_fused_pallas(with_aggregate=True)``,
    in this port's layout).

    On bfloat16 volumes ``a + b`` and the product are bfloat16 operations
    (each rounded to nearest-even, ``scale`` rounded too: 1, 0.5 and 0.25,
    the scales the matcher uses, are exact); ``s`` is then widened and the
    argmin, the parabola, the best cost and the margin are float32. Where
    no slice lies more than one away from the best (D <= 3) the margin is
    ``BIG - best`` with ``BIG`` in the volume's dtype (998244352 in
    bfloat16), as the reference's."""
    stored_big = torch.tensor(BIG, dtype=a.dtype).item()
    if a.dtype == torch.bfloat16:
        vol = a + b if b is not None else a
        if scale != 1.0:
            sc = torch.tensor(scale, dtype=torch.bfloat16).item()
            vol = (vol.float() * sc).to(torch.bfloat16)
    else:
        vol = (a + b) * scale if b is not None else a * scale
    agg = vol if with_aggregate else None
    vol = vol.float()
    D = vol.shape[0]
    best_d = vol.argmin(0)
    best = vol.amin(0)
    if subpixel:
        big = torch.full_like(vol[:1], BIG)
        prev = torch.cat([big, vol[:-1]], 0).gather(0, best_d[None])[0]
        nxt = torch.cat([vol[1:], big], 0).gather(0, best_d[None])[0]
        denom = prev - 2 * best + nxt
        ok = (denom > 1e-9) & (best_d > 0) & (best_d < D - 1)
        offset = torch.where(ok, 0.5 * (prev - nxt) / denom.clamp_min(1e-9),
                             torch.zeros_like(denom))
        disp = d_min + stride * (best_d.float() + offset.clamp(-1.0, 1.0))
    else:
        disp = d_min + stride * best_d.float()
    margin = None
    if with_margin:
        ds = torch.arange(D, device=vol.device).view(D, 1, 1)
        away = (ds - best_d[None]).abs() > 1
        second = torch.where(away, vol,
                             torch.full_like(vol, stored_big)).amin(0)
        margin = second - best
    return (disp, best, margin, agg) if with_aggregate else (disp, best,
                                                             margin)


def derive_right_plain(vol: torch.Tensor, d_min: int, fill: float = 1.0,
                       stride: int = 1) -> torch.Tensor:
    """``out[i, y, x] = vol[i, y, x + d_min + i*stride]``, ``fill`` outside
    (``matching.derive_right_volume``); ``fill`` in the volume's dtype
    (1e4 is 9984 in bfloat16)."""
    D, h, w = vol.shape
    pad = max(abs(d_min), abs(d_min + (D - 1) * stride)) + 1
    volp = torch.nn.functional.pad(vol, (pad, pad), value=fill)
    out = torch.empty_like(vol)
    for i in range(D):
        start = pad + d_min + i * stride
        out[i] = volp[i, :, start:start + w]
    return out


def sgm_pair(cost: torch.Tensor, p1: float, p2: float,
             horizontal: bool) -> torch.Tensor:
    """Sum of the two directions along one axis (lr + rl, or tb + bt)."""
    out = sgm_dir_plain(cost, p1, p2, horizontal, reverse=False)
    return sgm_dir_plain(cost, p1, p2, horizontal, reverse=True, out=out)


wta = wta_plain
derive_right = derive_right_plain
