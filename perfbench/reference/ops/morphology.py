"""Morphology and distance transforms (a frozen copy of the port's
``ops/morphology.py``).

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
