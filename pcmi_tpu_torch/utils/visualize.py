"""Debug visualization dumps (port of ``pcmi_tpu/utils/visualize.py``;
numpy and PIL only).

A polynomial turbo colormap, 2-98 percentile display normalisation, NaNs
painted red, written with PIL or, where PIL is missing, as ``.npy``.
Callers pass numpy arrays (``tensor.cpu().numpy()``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def turbo_colormap(x01: np.ndarray) -> np.ndarray:
    """Google turbo colormap, 4th-order polynomial fit; x in [0,1] -> RGB."""
    x = np.clip(np.asarray(x01, np.float32), 0.0, 1.0)
    r = 0.13572138 + x * (4.61539260 + x * (-42.66032258 + x * (
        132.13108234 + x * (-152.94239396 + x * 59.28637943))))
    g = 0.09140261 + x * (2.19418839 + x * (4.84296658 + x * (
        -14.18503333 + x * (4.27729857 + x * 2.82956604))))
    b = 0.10667330 + x * (12.64194608 + x * (-60.58204836 + x * (
        110.36276771 + x * (-89.90310912 + x * 27.34824973))))
    return np.clip(np.stack([r, g, b], -1), 0.0, 1.0)


def normalise_for_display(img: np.ndarray, p_lo: float = 2.0,
                          p_hi: float = 98.0) -> np.ndarray:
    """2-98 percentile stretch ignoring NaNs (ref ``utils.py:9-14``)."""
    img = np.asarray(img, np.float32)
    finite = np.isfinite(img)
    if not finite.any():
        return np.zeros_like(img)
    lo, hi = np.percentile(img[finite], [p_lo, p_hi])
    out = (img - lo) / max(hi - lo, 1e-9)
    return np.clip(out, 0.0, 1.0)


def render(img: np.ndarray, colormap: Optional[str] = None,
           nan_color=(1.0, 0.0, 0.0)) -> np.ndarray:
    """Float image -> uint8 RGB with NaNs painted (ref ``imsave`` ``:54-73``)."""
    img = np.asarray(img, np.float32)
    nan_mask = ~np.isfinite(img)
    x = normalise_for_display(img)
    rgb = turbo_colormap(x) if colormap == "turbo" else np.stack([x] * 3, -1)
    rgb[nan_mask] = nan_color
    return (rgb * 255).astype(np.uint8)


def save_image(path: str, img: np.ndarray, colormap: Optional[str] = None):
    """Save a debug PNG (PIL); falls back to .npy beside the path where
    PIL is missing or cannot write that file."""
    rgb = render(img, colormap)
    try:
        from PIL import Image

        Image.fromarray(rgb).save(path)
    except (ImportError, OSError, ValueError, KeyError):
        np.save(path + ".npy", rgb)


def save_disparity(path: str, disparity: np.ndarray,
                   valid: Optional[np.ndarray] = None):
    """Turbo disparity dump with invalid pixels red (ref ``save_disparity``
    ``utils.py:17-28``)."""
    disp = np.asarray(disparity, np.float32).copy()
    if valid is not None:
        disp[~np.asarray(valid, bool)] = np.nan
    save_image(path, disp, colormap="turbo")
