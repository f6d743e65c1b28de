"""Local metric frames and affine-camera fits of RPC cameras (a frozen copy of the port's
``geometry/affine.py``).

The fit runs on the host in float64 numpy, as in the reference; the fitted
camera is stored in float32 like the reference's, so the rectification
that follows starts from the same numbers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from perfbench.reference.geometry.rpc import RPCCamera

# metres per degree at the equator (WGS84 mean)
M_PER_DEG_LAT = 111_132.0
M_PER_DEG_LON_EQ = 111_320.0


@dataclass
class LocalFrame:
    """Equirectangular ENU frame anchored at (lon0, lat0, h0=0). The anchor
    is held as float32 values, as the reference holds it."""

    lon0: float
    lat0: float

    def __post_init__(self):
        self.lon0 = float(np.float32(self.lon0))
        self.lat0 = float(np.float32(self.lat0))

    def to_geodetic(self, x: torch.Tensor, y: torch.Tensor, z):
        """Local metres -> (lon, lat, z), float32 as in the reference."""
        lat0 = torch.tensor(self.lat0, dtype=torch.float32, device=x.device)
        lon = self.lon0 + x / (M_PER_DEG_LON_EQ * torch.cos(torch.deg2rad(lat0)))
        lat = self.lat0 + y / M_PER_DEG_LAT
        return lon, lat, z

    def to_local_np(self, lon, lat, h):
        """Geodetic -> local metres, host float64 (the geometry fit's path)."""
        x = (np.asarray(lon, np.float64) - self.lon0) * M_PER_DEG_LON_EQ \
            * np.cos(np.radians(self.lat0))
        y = (np.asarray(lat, np.float64) - self.lat0) * M_PER_DEG_LAT
        return x, y, np.asarray(h, np.float64)


@dataclass
class AffineCamera:
    """2x4 affine camera in a local metric frame: ``pix = A @ xyz + b``;
    ``A`` (2, 3) and ``b`` (2,) float32 tensors, pixels as (col, row)."""

    A: torch.Tensor
    b: torch.Tensor


def probe_grid(lon_range, lat_range, h_range, shape=(8, 8, 5)) -> np.ndarray:
    """Regular (N, 3) lon/lat/h probe lattice over the AOI volume."""
    lons = np.linspace(lon_range[0], lon_range[1], shape[0])
    lats = np.linspace(lat_range[0], lat_range[1], shape[1])
    hs = np.linspace(h_range[0], h_range[1], shape[2])
    g = np.stack(np.meshgrid(lons, lats, hs, indexing="ij"), axis=-1)
    return g.reshape(-1, 3)


def fit_affine_camera(rpc: RPCCamera, frame: LocalFrame,
                      probes_llh: np.ndarray) -> AffineCamera:
    """Least-squares affine camera through RPC projections of a probe
    lattice, host float64 end to end."""
    col, row = rpc.project_np(probes_llh[:, 0], probes_llh[:, 1],
                              probes_llh[:, 2])
    x, y, z = frame.to_local_np(probes_llh[:, 0], probes_llh[:, 1],
                                probes_llh[:, 2])
    X = np.stack([x, y, z, np.ones(len(probes_llh))], axis=1)
    pix = np.stack([col, row], axis=1)
    theta, *_ = np.linalg.lstsq(X, pix, rcond=None)
    return AffineCamera(
        A=torch.from_numpy(theta[:3].T.astype(np.float32)),
        b=torch.from_numpy(theta[3].astype(np.float32)),
    )
