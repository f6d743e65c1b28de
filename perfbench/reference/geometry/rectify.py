"""Affine epipolar rectification and triangulation (a frozen copy of the port's
``geometry/rectify.py``).

Geometry solves run on the host in float64 numpy, exactly as in the
reference; the warps and the per-pixel triangulation are float32 tensor
code on the images' device (the triangulation product in full float32).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from perfbench.reference.geometry.affine import (
    AffineCamera, LocalFrame, fit_affine_camera, probe_grid)
from perfbench.reference.geometry.rpc import RPCCamera
from perfbench.reference.ops.warp import affine_warp, invert_affine


def _f64(t) -> np.ndarray:
    return np.asarray(t.cpu().numpy() if torch.is_tensor(t) else t, np.float64)


def fit_affine_fundamental(p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """Fit (a, b, c, d, e) with ``a x2 + b y2 + c x1 + d y1 + e = 0`` by a
    centred SVD over (N, 2) correspondences."""
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    m1 = p1.mean(0)
    m2 = p2.mean(0)
    X = np.concatenate([p2 - m2, p1 - m1], axis=1)
    _, _, vt = np.linalg.svd(X, full_matrices=False)
    abcd = vt[-1]
    e = -float(abcd[:2] @ m2 + abcd[2:] @ m1)
    return np.concatenate([abcd, [e]])


@dataclass(frozen=True)
class RectifiedGeometry:
    """Host-side rectification result (plain numpy)."""

    H1: np.ndarray          # (2, 3) image1 -> rectified1
    H2: np.ndarray          # (2, 3) image2 -> rectified2
    out_shape: tuple        # (H, W) common rectified canvas
    cam1_rect: AffineCamera
    cam2_rect: AffineCamera
    frame: LocalFrame
    epipolar_residual: float  # max |y1' - y2'| over probes, px
    disp_gain: float        # disparity = disp_gain * (height - h_mid), px/m
    h_mid: float            # height at which disparity is zero (m)


def _compose(H: np.ndarray, cam: AffineCamera) -> AffineCamera:
    """Rectified camera = 2x3 pixel transform o affine camera (float64)."""
    L = np.asarray(H[:, :2], np.float64)
    t = np.asarray(H[:, 2], np.float64)
    A = L @ _f64(cam.A)
    b = L @ _f64(cam.b) + t
    return AffineCamera(A=torch.from_numpy(A.astype(np.float32)),
                        b=torch.from_numpy(b.astype(np.float32)))


def compute_rectification(cam1: AffineCamera, cam2: AffineCamera,
                          frame: LocalFrame, probes_local: np.ndarray,
                          shape1: tuple, shape2: tuple,
                          pad_multiple: int = 128) -> RectifiedGeometry:
    """Rectifying 2x3 transforms from two affine cameras over an (N, 3)
    probe lattice in the local frame; the canvas spans the probes'
    projections, padded to ``pad_multiple`` (``shape1``/``shape2`` are
    reserved, as in the reference)."""
    P = np.asarray(probes_local, np.float64)
    p1 = P @ _f64(cam1.A).T + _f64(cam1.b)
    p2 = P @ _f64(cam2.A).T + _f64(cam2.b)

    a, b, c, d, e = fit_affine_fundamental(p1, p2)
    n1 = float(np.hypot(c, d))

    dir1 = np.array([-d, c]) / n1
    H1 = np.array([
        [dir1[0], dir1[1], 0.0],
        [-c / n1, -d / n1, 0.0],
    ])
    # x1' is exactly affine in (x2, y2, z) for affine cameras; image 2's
    # x-row aligns the images at the mid height, so d = delta (z - h_mid)
    x1p = p1 @ dir1
    h_mid = float(np.median(P[:, 2]))
    design = np.stack([p2[:, 0], p2[:, 1], P[:, 2], np.ones(len(P))], axis=1)
    (alpha, beta, delta, gamma), *_ = np.linalg.lstsq(design, x1p, rcond=None)
    x_resid = float(np.abs(design @ [alpha, beta, delta, gamma] - x1p).max())
    H2 = np.array([
        [alpha, beta, gamma + delta * h_mid],
        [a / n1, b / n1, e / n1],
    ])

    y1p = p1 @ H1[1, :2] + H1[1, 2]
    y2p = p2 @ H2[1, :2] + H2[1, 2]
    resid = max(float(np.abs(y1p - y2p).max()), x_resid)

    x1r = p1 @ H1[0, :2] + H1[0, 2]
    x2r = p2 @ H2[0, :2] + H2[0, 2]
    tx = -min(x1r.min(), x2r.min())
    ty = -min(y1p.min(), y2p.min())
    H1[:, 2] += [tx, ty]
    H2[:, 2] += [tx, ty]

    def _pad(v):
        return int(np.ceil(v / pad_multiple) * pad_multiple)

    width = _pad(max(x1r.max(), x2r.max()) + tx + 1)
    height = _pad(max(y1p.max(), y2p.max()) + ty + 1)

    return RectifiedGeometry(
        H1=H1, H2=H2, out_shape=(height, width),
        cam1_rect=_compose(H1, cam1), cam2_rect=_compose(H2, cam2),
        frame=frame, epipolar_residual=resid,
        disp_gain=float(delta), h_mid=h_mid,
    )


def rectify_arrays(img1: torch.Tensor, img2: torch.Tensor, H1: torch.Tensor,
                   H2: torch.Tensor, out_shape, fill: float = -1.0):
    """Warp both images onto the rectified canvas (bilinear); ``H1``/``H2``
    are float32 (2, 3) image -> rectified transforms. Fill -1 is the
    undefined-pixel sentinel (masks are ``img >= 0``)."""
    r1 = affine_warp(img1, invert_affine(H1), out_shape, fill=fill)
    r2 = affine_warp(img2, invert_affine(H2), out_shape, fill=fill)
    return r1, r2


def triangulate_from_operator(disparity: torch.Tensor, tri_M: torch.Tensor,
                              tri_b: torch.Tensor, row0: float = 0.0):
    """Dense disparity -> (H, W, 3) local-frame points through the constant
    (3, 4) operator; convention ``x2 = x1 - d``."""
    h, w = disparity.shape
    dev = disparity.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w) + row0
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    x2 = xs - disparity.float()
    obs = torch.stack([xs, ys, x2, ys], dim=-1)
    return (obs - tri_b.to(dev)) @ tri_M.to(dev).T


def triangulation_operator(geom: RectifiedGeometry):
    """The constant (3, 4) least-squares triangulation matrix (host float64
    pinv) and the stacked camera offsets, both as float32 tensors."""
    A_stack = np.concatenate([_f64(geom.cam1_rect.A), _f64(geom.cam2_rect.A)])
    b_stack = np.concatenate([_f64(geom.cam1_rect.b), _f64(geom.cam2_rect.b)])
    M = np.linalg.pinv(A_stack)
    return (torch.from_numpy(M.astype(np.float32)),
            torch.from_numpy(b_stack.astype(np.float32)))


def build_geometry_from_rpcs(rpc1: RPCCamera, rpc2: RPCCamera, lon_range,
                             lat_range, h_range, shape1, shape2,
                             grid=(8, 8, 5),
                             pad_multiple: int = 128) -> RectifiedGeometry:
    """RPC pair + AOI volume -> rectification geometry."""
    frame = LocalFrame(lon0=0.5 * (lon_range[0] + lon_range[1]),
                       lat0=0.5 * (lat_range[0] + lat_range[1]))
    llh = probe_grid(lon_range, lat_range, h_range, grid)
    cam1 = fit_affine_camera(rpc1, frame, llh)
    cam2 = fit_affine_camera(rpc2, frame, llh)
    x, y, z = frame.to_local_np(llh[:, 0], llh[:, 1], llh[:, 2])
    probes_local = np.stack([x, y, z], axis=1)
    return compute_rectification(cam1, cam2, frame, probes_local, shape1,
                                 shape2, pad_multiple)
