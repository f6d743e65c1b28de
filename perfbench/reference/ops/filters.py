"""Separable and edge-aware filters (a frozen copy of the port's
``ops/filters.py``).

Images are (H, W) float32, or (H, W, C) where the reference takes those
(filtered over the first two axes). Linear filters are sums of shifted
slices of a reflect-padded image (OpenCV's BORDER_REFLECT_101), in the
reference's tap order; the median is the reference's Batcher min/max
network over edge-padded shifts, so it returns the same element. The
filter bank is one float32 convolution (TF32 is off in this package).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _pad_axis(img: torch.Tensor, pad: int, axis: int, mode: str) -> torch.Tensor:
    """Pad axis 0 or 1 of an (H, W) or (H, W, C) image (``mode`` "reflect"
    or "replicate")."""
    widths = (pad, pad, 0, 0) if axis == 1 else (0, 0, pad, pad)
    if img.dim() == 2:
        return F.pad(img[None, None], widths, mode=mode)[0, 0]
    return F.pad(img.permute(2, 0, 1)[None], widths,
                 mode=mode)[0].permute(1, 2, 0)


def _conv1d_along(img: torch.Tensor, kernel, axis: int) -> torch.Tensor:
    """Correlate a 1-D kernel (float32 values) along ``axis``, reflect-padded."""
    k = len(kernel)
    padded = _pad_axis(img, k // 2, axis, "reflect")
    n = img.shape[axis]
    out = torch.zeros_like(img)
    for i in range(k):
        out = out + kernel[i] * padded.narrow(axis, i, n)
    return out


def separable_filter(img: torch.Tensor, ky, kx) -> torch.Tensor:
    """Rows with ``ky``, then columns with ``kx``."""
    return _conv1d_along(_conv1d_along(img, ky, 0), kx, 1)


def gaussian_kernel1d(sigma: float, radius: int | None = None) -> torch.Tensor:
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return torch.from_numpy((k / k.sum()).astype(np.float32))


def gaussian_filter(img: torch.Tensor, sigma: float,
                    radius: int | None = None) -> torch.Tensor:
    img = img.float()
    k = gaussian_kernel1d(sigma, radius).to(img.device)
    return separable_filter(img, k, k)


def box_filter(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Mean over a ``2r+1`` window (constant area, reflect padding)."""
    img = img.float()
    k = torch.ones(2 * radius + 1, dtype=torch.float32,
                   device=img.device) / np.float32(2 * radius + 1)
    return separable_filter(img, k, k)


def guided_filter(guide: torch.Tensor, src: torch.Tensor, radius: int = 9,
                  eps: float = 1e-3) -> torch.Tensor:
    """Fast guided filter (He, Sun, Tang 2010): edge-aware smoothing of
    ``src`` guided by ``guide``."""
    I = guide.float()
    p = src.float()
    mean_I = box_filter(I, radius)
    mean_p = box_filter(p, radius)
    corr_I = box_filter(I * I, radius)
    corr_Ip = box_filter(I * p, radius)
    var_I = corr_I - mean_I * mean_I
    cov_Ip = corr_Ip - mean_I * mean_p
    a = cov_Ip / (var_I + eps)
    b = mean_p - a * mean_I
    mean_a = box_filter(a, radius)
    mean_b = box_filter(b, radius)
    return mean_a * I + mean_b


def masked_guided_filter(guide: torch.Tensor, src: torch.Tensor,
                         mask: torch.Tensor, radius: int = 9,
                         eps: float = 1e-3) -> torch.Tensor:
    """Guided filter where only ``mask`` pixels of ``src`` contribute (the
    in-fill of low-confidence disparities)."""
    I = guide.float()
    m = mask.float()
    p = src.float() * m
    n = box_filter(m, radius)
    safe = torch.clamp(n, min=1e-6)
    mean_I = box_filter(I * m, radius) / safe
    mean_p = box_filter(p, radius) / safe
    corr_I = box_filter(I * I * m, radius) / safe
    corr_Ip = box_filter(I * p, radius) / safe
    var_I = torch.clamp(corr_I - mean_I * mean_I, min=0.0)
    cov_Ip = corr_Ip - mean_I * mean_p
    a = cov_Ip / (var_I + eps)
    b = mean_p - a * mean_I
    mean_a = box_filter(a * m, radius) / safe
    mean_b = box_filter(b * m, radius) / safe
    return mean_a * I + mean_b


def _batcher_pairs(n: int):
    """Compare-exchange index pairs of Batcher's odd-even mergesort."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


def _median_along(img: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    """1-D running median along ``axis`` via the Batcher network."""
    padded = _pad_axis(img, size // 2, axis, "replicate")
    n = img.shape[axis]
    planes = [padded.narrow(axis, i, n) for i in range(size)]
    for a, b in _batcher_pairs(size):
        planes[a], planes[b] = (torch.minimum(planes[a], planes[b]),
                                torch.maximum(planes[a], planes[b]))
    return planes[size // 2]


def separable_median_filter(img: torch.Tensor, size: int = 9) -> torch.Tensor:
    """Median along rows, then along columns (the separable approximation
    of a 2-D median)."""
    return _median_along(_median_along(img.float(), size, 0), size, 1)
