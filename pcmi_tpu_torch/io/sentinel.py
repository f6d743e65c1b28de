"""Sentinel-2 style band loaders (port of ``pcmi_tpu/io/sentinel.py``).

RGB previews from bands 4/3/2 with a 2-98 percentile stretch, NaN kept
where a band is not finite. The stretch runs on ``device``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from pcmi_tpu_torch.io.native import read_tiff_fast
from pcmi_tpu_torch.ops.normalize import percentile_stretch


def load_bands(path: str) -> np.ndarray:
    """(H, W, B) float32 band stack from a multi-band TIFF."""
    arr = np.asarray(read_tiff_fast(path), np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def bands_to_rgb(stack: np.ndarray, rgb_bands: Sequence[int] = (3, 2, 1),
                 p_lo: float = 2.0, p_hi: float = 98.0,
                 device: str | torch.device = "cuda") -> np.ndarray:
    """Bands 4/3/2 (0-indexed 3/2/1) -> stretched RGB in [0, 1], NaN-safe."""
    out = []
    for b in rgb_bands:
        band = stack[..., min(b, stack.shape[-1] - 1)]
        mask = np.isfinite(band)
        stretched = percentile_stretch(
            torch.from_numpy(np.nan_to_num(band).astype(np.float32)).to(device),
            torch.from_numpy(mask).to(device), p_lo, p_hi).cpu().numpy()
        stretched[~mask] = np.nan
        out.append(stretched)
    return np.stack(out, axis=-1)


def load_rgb(path: str, rgb_bands: Sequence[int] = (3, 2, 1),
             device: str | torch.device = "cuda") -> np.ndarray:
    """File -> stretched RGB (bands 4/3/2 by default)."""
    return bands_to_rgb(load_bands(path), rgb_bands, device=device)
