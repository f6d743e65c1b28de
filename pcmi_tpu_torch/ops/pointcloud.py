"""Plane fit and plane-relative heights (port of the plane-fit part of
``pcmi_tpu/ops/pointcloud.py``; the fusion ops are not ported yet)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Plane(NamedTuple):
    normal: torch.Tensor    # (3,) unit normal, oriented +z
    centroid: torch.Tensor  # (3,)


def fit_plane(xyz: torch.Tensor, weights: torch.Tensor) -> Plane:
    """Weighted least-squares plane through ``xyz`` ((N, 3) or (H, W, 3)):
    the smallest-eigenvalue eigenvector of the 3x3 weighted scatter
    matrix, oriented +z. The product runs in full float32 (no TF32)."""
    pts = xyz.reshape(-1, 3).float()
    w = weights.reshape(-1).float()
    wsum = torch.clamp(w.sum(), min=1e-6)
    mu = (pts * w[:, None]).sum(0) / wsum
    centred = (pts - mu) * torch.sqrt(w)[:, None]
    cov = (centred.T @ centred) / wsum
    _, vecs = torch.linalg.eigh(cov)
    n = vecs[:, 0]
    n = torch.where(n[2] < 0, -n, n)
    return Plane(normal=n, centroid=mu)


def plane_relative_height(xyz: torch.Tensor, plane: Plane) -> torch.Tensor:
    """Signed distance of each point to the plane along its normal."""
    return (xyz - plane.centroid) @ plane.normal
