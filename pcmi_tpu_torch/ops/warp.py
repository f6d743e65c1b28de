"""Bilinear image warps (port of ``pcmi_tpu/ops/warp.py``).

One bilinear ``map_coordinates`` gather serves the rectification warps,
the homography warp and the synthetic renderer. Arithmetic follows the
reference step by step in float32.
"""

from __future__ import annotations

import torch


def map_coordinates(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    fill: float = 0.0) -> torch.Tensor:
    """Bilinear sample of ``img`` (H, W) at float coords ``(ys, xs)``.

    Out-of-bounds samples return ``fill``; the output has the coords'
    shape."""
    h, w = img.shape
    img = img.float()
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    ty = ys - y0
    tx = xs - x0

    def gather(yi, xi):
        # NaN coords sample index 0; `inside` masks them to `fill` below
        yc = yi.clamp(0, h - 1).nan_to_num(0.0).long()
        xc = xi.clamp(0, w - 1).nan_to_num(0.0).long()
        return img[yc, xc]

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    top = v00 * (1 - tx) + v01 * tx
    bot = v10 * (1 - tx) + v11 * tx
    out = top * (1 - ty) + bot * ty
    inside = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    return torch.where(inside, out, torch.full_like(out, fill))


def _grid(out_shape, device):
    h, w = out_shape
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return ys, xs


def affine_warp(img: torch.Tensor, matrix: torch.Tensor, out_shape,
                fill: float = 0.0) -> torch.Tensor:
    """Warp ``img`` with a 2x3 or 3x3 *output->input* affine ``matrix``:
    ``out[y, x] = img[M @ (x, y, 1)]`` (OpenCV ``WARP_INVERSE_MAP``)."""
    ys, xs = _grid(out_shape, img.device)
    m = matrix.float()
    xi = m[0, 0] * xs + m[0, 1] * ys + m[0, 2]
    yi = m[1, 0] * xs + m[1, 1] * ys + m[1, 2]
    return map_coordinates(img, yi, xi, fill)


def homography_warp(img: torch.Tensor, matrix: torch.Tensor, out_shape,
                    fill: float = 0.0) -> torch.Tensor:
    """Warp ``img`` with a 3x3 *output->input* homography (the inverse
    convention of ``cv2.warpPerspective``); a projective denominator of
    magnitude <= 1e-8 is taken as 1e-8."""
    ys, xs = _grid(out_shape, img.device)
    m = torch.as_tensor(matrix, dtype=torch.float32, device=img.device)
    xi = m[0, 0] * xs + m[0, 1] * ys + m[0, 2]
    yi = m[1, 0] * xs + m[1, 1] * ys + m[1, 2]
    zi = m[2, 0] * xs + m[2, 1] * ys + m[2, 2]
    zi = torch.where(zi.abs() > 1e-8, zi, 1e-8)
    return map_coordinates(img, yi / zi, xi / zi, fill)


def warp_points_affine(matrix: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Apply a 2x3 or 3x3 affine to (N, 2) (x, y) points, float32."""
    xy = torch.as_tensor(xy, dtype=torch.float32)
    m = torch.as_tensor(matrix, dtype=torch.float32, device=xy.device)
    homo = torch.cat([xy, torch.ones_like(xy[:, :1])], 1)
    return homo @ m[:2].T


def invert_affine(matrix: torch.Tensor) -> torch.Tensor:
    """Invert a 2x3 (promoted to 3x3) or 3x3 affine matrix, float32."""
    m = torch.as_tensor(matrix, dtype=torch.float32)
    if m.shape == (2, 3):
        m = torch.cat([m, m.new_tensor([[0.0, 0.0, 1.0]])], 0)
    return torch.linalg.inv(m)
