"""Morphology and distance transforms (port of
``pcmi_tpu/ops/morphology.py``).

Every operation is a ``size x size`` min or max over a window with the
reference's ``reduce_window(padding="SAME")`` placement (``(size - 1) // 2``
before, the rest after; outside counts as -inf for a max, +inf for a min),
computed as one max pool.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _window_max(x: torch.Tensor, size: int) -> torch.Tensor:
    """Max over a ``size x size`` window of an (H, W) float image, with the
    reference's "SAME" placement (-inf outside)."""
    lo = (size - 1) // 2
    hi = size - 1 - lo
    x = F.pad(x[None, None], (lo, hi, lo, hi), value=float("-inf"))
    return F.max_pool2d(x, size, stride=1)[0, 0]


def _window_min(x: torch.Tensor, size: int) -> torch.Tensor:
    return -_window_max(-x, size)


def binary_dilation(mask: torch.Tensor, iterations: int = 1,
                    size: int = 3) -> torch.Tensor:
    """Iterated square dilation as ONE max over a window of
    ``(size-1)*iterations + 1`` (outside counts as False), as the
    reference's ``reduce_window`` does."""
    return _window_max(mask.float(), (size - 1) * iterations + 1) > 0.5


def binary_erosion(mask: torch.Tensor, iterations: int = 1,
                   size: int = 3) -> torch.Tensor:
    """Iterated square erosion as one min over a window of
    ``(size-1)*iterations + 1`` (outside counts as True)."""
    return _window_min(mask.float(), (size - 1) * iterations + 1) > 0.5


def binary_closing(mask: torch.Tensor, size: int = 3) -> torch.Tensor:
    """Dilation then erosion, each over a ``size x size`` window."""
    x = _window_max(mask.float(), size)
    return _window_min(x, size) > 0.5


def grey_erosion(img: torch.Tensor, size: int) -> torch.Tensor:
    """Min filter over a ``size x size`` window (the dark channel's
    erosion)."""
    return _window_min(img.float(), size)


def grey_dilation(img: torch.Tensor, size: int) -> torch.Tensor:
    """Max filter over a ``size x size`` window."""
    return _window_max(img.float(), size)


def distance_transform(mask: torch.Tensor, max_dist: int = 32) -> torch.Tensor:
    """Approximate distance from each True pixel to the nearest False one,
    clipped at ``max_dist``: ``max_dist`` chamfer passes, each a 3x3 min
    plus one (the reference's iterated min-plus sweeps)."""
    big = float(max_dist)
    d = torch.where(mask.bool(), big, 0.0)
    for _ in range(max_dist):
        d = torch.minimum(d, _window_min(d, 3) + 1.0)
    return torch.clamp(d, max=big)
