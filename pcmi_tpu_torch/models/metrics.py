"""Image quality metrics: PSNR and SSIM (port of
``pcmi_tpu/models/metrics.py``).

The quality gates of the generative components are numeric: SR must beat
bicubic PSNR, inpainting must beat the diffusion prefill.
"""

from __future__ import annotations

import torch

from pcmi_tpu_torch.ops.filters import box_filter


def psnr(pred: torch.Tensor, target: torch.Tensor, mask=None,
         peak: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB; optional pixel mask (e.g. in-hole)."""
    se = (pred.float() - target.float()) ** 2
    if mask is not None:
        m = torch.broadcast_to(mask.float(), se.shape)
        mse = (se * m).sum() / torch.clamp(m.sum(), min=1.0)
    else:
        mse = se.mean()
    return 10.0 * torch.log10(peak ** 2 / torch.clamp(mse, min=1e-12))


def _box_hw(img: torch.Tensor, r: int) -> torch.Tensor:
    """:func:`box_filter` over the H, W axes of an (H, W), (H, W, C) or
    (B, H, W, C) image."""
    if img.dim() < 4:
        return box_filter(img, r)
    b, h, w, c = img.shape
    flat = img.permute(1, 2, 0, 3).reshape(h, w, b * c)
    return box_filter(flat, r).reshape(h, w, b, c).permute(2, 0, 1, 3)


def ssim(pred: torch.Tensor, target: torch.Tensor, window: int = 7,
         peak: float = 1.0) -> torch.Tensor:
    """Mean SSIM over (..., H, W, C) images, uniform window (Wang 2004)."""
    x = pred.float()
    y = target.float()
    r = window // 2
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    mx = _box_hw(x, r)
    my = _box_hw(y, r)
    vx = _box_hw(x * x, r) - mx * mx
    vy = _box_hw(y * y, r) - my * my
    cxy = _box_hw(x * y, r) - mx * my
    s = ((2 * mx * my + c1) * (2 * cxy + c2)) / (
        (mx * mx + my * my + c1) * (vx + vy + c2))
    return s.mean()
