"""Binary morphology (port of ``pcmi_tpu/ops/morphology.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def binary_dilation(mask: torch.Tensor, iterations: int = 1,
                    size: int = 3) -> torch.Tensor:
    """Iterated square dilation as ONE max-pool of window
    ``(size-1)*iterations + 1`` with "SAME" padding (outside counts as
    False), as the reference's ``reduce_window`` does."""
    eff = (size - 1) * iterations + 1
    x = mask.float()[None, None]
    x = F.max_pool2d(x, eff, stride=1, padding=eff // 2)
    return x[0, 0] > 0.5
