"""Radiometric normalisation and grid quantiles (a frozen copy of the port's
``ops/normalize.py``).

The grid quantiles feed the matcher's thresholds, so they are ported
exactly: the same thresholds, the same first-crossing ``argmax`` and the
same interpolation, with exact integer counts. Counting differs in form
only: the reference compares every element against all thresholds (an
``[N, bins]`` compare, the shape its chip fuses); here the masked values
are sorted once and each threshold's count is its ``searchsorted``
position. On an NVIDIA H100 80GB HBM3 at 700 W one counting pass over the
headline canvas took 0.114 ms this way, 0.665 ms as the compare and
0.210 ms as a scatter-add histogram (PERF.md). All values stay tensors, so
no step waits for the device.
"""

from __future__ import annotations

import torch

from perfbench.reference.ops.fused import mul_add, recip


def _counts(xf: torch.Tensor, mf: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """``counts[j] = #{i : mf[i] and xf[i] <= ts[j]}`` as float32 (masked
    values sort past every finite threshold)."""
    s = torch.sort(torch.where(mf, xf, float("inf"))).values
    return torch.searchsorted(s, ts.contiguous(), right=True).float()


def _masked_quantile(x: torch.Tensor, mask: torch.Tensor, q) -> torch.Tensor:
    """Exact quantiles of ``x[mask]``: masked values go to ``+inf``, the
    flat array is sorted once and read at ``int(q * (n_valid - 1))``. ``q``
    is a scalar or a vector; an empty mask reads element 0 (``+inf``)."""
    flat = torch.where(mask.reshape(-1), x.reshape(-1), float("inf"))
    order = torch.sort(flat).values
    n_valid = torch.clamp(mask.sum(), min=1)
    q = torch.as_tensor(q, dtype=torch.float32, device=x.device)
    idx = (q * (n_valid - 1)).to(torch.int32).clamp(0, flat.numel() - 1)
    return order[idx.long()]


def _first_true(b: torch.Tensor) -> torch.Tensor:
    return torch.argmax(b.to(torch.uint8))


def masked_quantile_grid(x: torch.Tensor, mask: torch.Tensor, lo, hi,
                         q: float = 0.5, bins: int = 64,
                         stages: int = 2) -> torch.Tensor:
    """Approximate q-quantile of ``x[mask]``: ``stages`` passes, each
    counting under ``bins`` linear thresholds over the current bracket and
    narrowing it to the bin where the count crosses ``q * n_valid``."""
    dev = x.device
    xf = x.reshape(-1).float()
    mf = mask.reshape(-1)
    lo = torch.as_tensor(lo, dtype=torch.float32, device=dev)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=dev)
    n = torch.clamp(mf.sum().float(), min=1.0)
    target = torch.tensor(q, dtype=torch.float32, device=dev) * n
    k = torch.arange(bins, dtype=torch.float32, device=dev)
    step = recip(bins - 1).to(dev)
    c_lo = torch.zeros((), dtype=torch.float32, device=dev)
    c_hi = n
    for _ in range(stages):
        # lo + (hi - lo) * k / (bins - 1), in the reference's rounding on
        # the CPU: a product with the constant's reciprocal, reassociated,
        # and one multiply-add
        ts = mul_add(k, step * (hi - lo), lo)
        counts = _counts(xf, mf, ts)
        reach = counts >= target
        idx = _first_true(reach)
        i0 = torch.clamp(idx - 1, min=0)
        any_reach = reach.any()
        t0 = torch.where(idx == 0, lo, ts[i0])
        c0 = torch.where(idx == 0, c_lo, counts[i0])
        t1 = torch.where(any_reach, ts[idx], hi)
        c1 = torch.where(any_reach, counts[idx], c_hi)
        lo, hi, c_lo, c_hi = t0, t1, c0, c1
    frac = torch.where(c_hi > c_lo,
                       (target - c_lo) / torch.clamp(c_hi - c_lo, min=1e-6),
                       torch.zeros_like(target))
    return lo + frac.clamp(0.0, 1.0) * (hi - lo)


def masked_median_grid(x: torch.Tensor, mask: torch.Tensor, lo, hi,
                       bins: int = 64, geometric: bool = True) -> torch.Tensor:
    """Approximate median of ``x[mask]`` in one counting pass over ``bins``
    thresholds spanning [lo, hi] (log-spaced over [hi/2^12, hi] when
    ``geometric``), interpolated linearly at the crossing."""
    dev = x.device
    xf = x.reshape(-1).float()
    mf = mask.reshape(-1)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=dev)
    lo = torch.as_tensor(lo, dtype=torch.float32, device=dev)
    j = torch.arange(bins, dtype=torch.float32, device=dev)
    if geometric:
        ts = hi * torch.exp2(-12.0 * (1.0 - j / (bins - 1)))
    else:
        ts = lo + (hi - lo) * j / (bins - 1)
    counts = _counts(xf, mf, ts)
    n = torch.clamp(counts[-1], min=1.0)
    target = 0.5 * n
    reach = counts >= target
    idx = _first_true(reach)
    i0 = torch.clamp(idx - 1, min=0)
    c0, c1 = counts[i0], counts[idx]
    t0, t1 = ts[i0], ts[idx]
    frac = torch.where(c1 > c0, (target - c0) / torch.clamp(c1 - c0, min=1e-6),
                       torch.zeros_like(target))
    med = t0 + frac.clamp(0.0, 1.0) * (t1 - t0)
    return torch.where(idx == 0, ts[0] * 0.5, med)


def robust_bounds(img: torch.Tensor, mask: torch.Tensor, nb: float = 8.0,
                  subsample: int = 1):
    """Median -+ nb*MAD bounds over valid pixels. ``subsample > 1`` on a
    2-D image runs two-stage 64-bin grid quantiles at full resolution;
    otherwise both medians are exact (one sort each)."""
    if not (subsample > 1 and img.dim() == 2):
        med = _masked_quantile(img, mask, 0.5)
        mad = _masked_quantile((img - med).abs(), mask, 0.5)
        return med - nb * mad, med + nb * mad
    inf = torch.tensor(float("inf"), device=img.device)
    lo = torch.where(mask, img, inf).amin()
    hi = torch.where(mask, img, -inf).amax()
    lo = torch.where(torch.isfinite(lo), lo, torch.zeros_like(lo))
    hi = torch.where(torch.isfinite(hi), hi, torch.ones_like(hi))
    med = masked_quantile_grid(img, mask, lo, hi, 0.5, bins=64, stages=2)
    mad = masked_quantile_grid((img - med).abs(), mask, 0.0, hi - lo, 0.5,
                               bins=64, stages=2)
    return med - nb * mad, med + nb * mad


def normalise_image(img: torch.Tensor, mask: torch.Tensor | None = None,
                    nb: float = 8.0, subsample: int = 1):
    """Robust [0, 1] normalisation over valid pixels; returns
    ``(normalised, mask)`` with invalid pixels at 0."""
    img = img.float()
    if mask is None:
        mask = img >= 0
    lo, hi = robust_bounds(img, mask, nb, subsample=subsample)
    scale = torch.where(hi > lo, 1.0 / (hi - lo), torch.zeros_like(hi))
    out = ((img - lo) * scale).clamp(0.0, 1.0)
    return torch.where(mask, out, torch.zeros_like(out)), mask


def snr_ratio(img: torch.Tensor, mask: torch.Tensor,
              subsample: int = 4) -> torch.Tensor:
    """Per-scene noise/signal ratio: Immerkaer's Laplacian noise estimate
    over the high-pass amplitude ``|f - G_2(f)|``, both as full-resolution
    grid medians. ``subsample`` is accepted for the reference's signature
    and, as there, not used."""
    del subsample
    from perfbench.reference.ops.filters import gaussian_filter

    f = img.float()
    lap = (4.0 * f[1:-1, 1:-1] - f[:-2, 1:-1] - f[2:, 1:-1]
           - f[1:-1, :-2] - f[1:-1, 2:])
    m4 = (mask[1:-1, 1:-1] & mask[:-2, 1:-1] & mask[2:, 1:-1]
          & mask[1:-1, :-2] & mask[1:-1, 2:])
    noise = masked_median_grid(lap.abs(), m4, 0.0, 8.0) * (
        1.4826 / torch.sqrt(torch.tensor(20.0)))
    hp = (f - gaussian_filter(f, sigma=2.0)).abs()
    signal = masked_median_grid(hp, mask, 0.0, 2.0)
    return noise / torch.clamp(signal, min=1e-6)
