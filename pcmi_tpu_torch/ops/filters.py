"""Separable and edge-aware filters (port of ``pcmi_tpu/ops/filters.py``).

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


def gabor_bank(ksize: int = 31,
               thetas=(0.0, np.pi / 4, np.pi / 2, 3 * np.pi / 4),
               sigmas=(2.0, 4.0), lambdas=(8.0, 16.0),
               gamma: float = 0.5) -> torch.Tensor:
    """The OBIA classifier's Gabor bank (orientations x sigmas x
    wavelengths, zero-mean kernels of ``ksize``): ``(N, k, k)`` float32,
    built on the host in float64 as the reference builds it."""
    half = ksize // 2
    ys, xs = np.mgrid[-half:half + 1, -half:half + 1]
    kernels = []
    for theta in thetas:
        xr = xs * np.cos(theta) + ys * np.sin(theta)
        yr = -xs * np.sin(theta) + ys * np.cos(theta)
        for sigma in sigmas:
            for lam in lambdas:
                g = np.exp(-(xr ** 2 + (gamma * yr) ** 2) / (2 * sigma ** 2))
                g = g * np.cos(2 * np.pi * xr / lam)
                kernels.append((g - g.mean()).astype(np.float32))
    return torch.from_numpy(np.stack(kernels))


def filter_bank_2d(img: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Correlate an (H, W) image with (N, k, k) kernels, zero padding of
    ``k // 2``: ``(N, H, W)``."""
    k = kernels.shape[-1]
    w = kernels.to(img.device, torch.float32)[:, None]
    return F.conv2d(img.float()[None, None], w, padding=k // 2)[0]


def masked_jacobi_fill(image: torch.Tensor, mask: torch.Tensor,
                       iters: int = 128) -> torch.Tensor:
    """Fill the ``mask`` holes of an (H, W) or (H, W, C) image by Jacobi
    relaxation from the rim: the holes start at the mean of the known
    pixels, then take ``iters`` times a radius-2, sigma-1.5 Gaussian blur
    while the known pixels stay."""
    img = image.float()
    m = mask.float()
    m3 = m[..., None] if img.dim() == 3 and m.dim() == 2 else m
    w = torch.broadcast_to(1.0 - m3, img.shape)
    known_mean = (img * w).sum() / torch.clamp(w.sum(), min=1.0)
    x = img * (1.0 - m3) + known_mean * m3
    hole = m3 > 0.5
    for _ in range(iters):
        x = torch.where(hole, gaussian_filter(x, 1.5, radius=2), img)
    return x


def unsharp_mask(img: torch.Tensor, amount: float = 1.5,
                 sigma: float = 2.0) -> torch.Tensor:
    """``(1 + amount) * img - amount * blur``, clipped to [0, 1]."""
    blur = gaussian_filter(img, sigma)
    return torch.clamp((1.0 + amount) * img - amount * blur, 0.0, 1.0)


def local_entropy(img01: torch.Tensor, radius: int = 5,
                  n_bins: int = 16) -> torch.Tensor:
    """Local Shannon entropy (bits) of a [0, 1] image: triangular soft
    binning into ``n_bins`` bins, a box mean of each bin's weights over a
    ``2 * radius + 1`` window, then ``-sum p log2 p``."""
    img01 = img01.float()
    centers = (torch.arange(n_bins, dtype=torch.float32,
                            device=img01.device) + 0.5) / n_bins
    dist = (img01[..., None] - centers).abs() * n_bins
    probs = box_filter(torch.clamp(1.0 - dist, min=0.0), radius)
    probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-8)
    return -(probs * torch.log2(torch.clamp(probs, min=1e-8))).sum(-1)
