"""Bilinear image warps (a frozen copy of the port's
``ops/warp.py``).

One bilinear ``map_coordinates`` gather serves the rectification warps,
the homography warp and the synthetic renderer. Arithmetic follows the
reference step by step in float32, with its compiler's multiply-adds on
the CPU (:func:`~perfbench.reference.ops.fused.mul_add`): an affine map's
``m0 * x + m1 * y`` and each bilinear blend ``p * (1 - t) + q * t`` round
their first product into the sum once.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.ops.fused import mul_add


def map_coordinates(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    fill: float = 0.0) -> torch.Tensor:
    """Bilinear sample of ``img`` (H, W) at float coords ``(ys, xs)``.

    Out-of-bounds samples return ``fill``; the output has the coords'
    shape. A stack of images (..., H, W) is sampled at the same coords,
    image by image."""
    h, w = img.shape[-2:]
    img = img.float()
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    ty = ys - y0
    tx = xs - x0

    def gather(yi, xi):
        # NaN coords sample index 0; `inside` masks them to `fill` below
        yc = yi.clamp(0, h - 1).nan_to_num(0.0).long()
        xc = xi.clamp(0, w - 1).nan_to_num(0.0).long()
        return img[..., yc, xc]

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    top = mul_add(v00, 1 - tx, v01 * tx)
    bot = mul_add(v10, 1 - tx, v11 * tx)
    out = mul_add(top, 1 - ty, bot * ty)
    inside = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    return torch.where(inside, out, torch.full_like(out, fill))


def _affine(m: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    """``m[0] * xs + m[1] * ys + m[2]`` for a matrix row ``m``."""
    return mul_add(m[0], xs, m[1] * ys) + m[2]


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
    return map_coordinates(img, _affine(m[1], xs, ys), _affine(m[0], xs, ys),
                           fill)


def invert_affine(matrix: torch.Tensor) -> torch.Tensor:
    """Invert a 2x3 (promoted to 3x3) or 3x3 affine matrix, float32, on
    its device. On the host, as the reference's ``jnp.linalg.inv`` does on
    the CPU: LAPACK's ``sgetrf`` (partial pivoting), then ``strsm`` on the
    permuted identity, unit lower and upper triangles in turn
    (``torch.linalg.inv`` rounds differently, and an ulp in a coordinate
    offset moves whole rows of a rectified image). The rectifier builds its
    matrices on the host; a matrix on the card is inverted there by
    ``torch.linalg.inv``, without a copy to the host."""
    t = torch.as_tensor(matrix, dtype=torch.float32)
    if t.shape == (2, 3):
        t = torch.cat([t, t.new_tensor([[0.0, 0.0, 1.0]])], 0)
    if t.device.type != "cpu":
        return torch.linalg.inv(t)
    from scipy.linalg import blas, lapack

    lu, piv, _ = lapack.sgetrf(t.numpy())  # singular: inf / nan, as the reference
    perm = np.arange(len(t))
    for i, p in enumerate(piv):
        perm[i], perm[p] = perm[p], perm[i]
    x = np.eye(len(t), dtype=np.float32)[perm]
    x = blas.strsm(1.0, lu, x, side=0, lower=1, diag=1)
    x = blas.strsm(1.0, lu, x, side=0, lower=0, diag=0)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))
