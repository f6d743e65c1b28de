"""RPC00B rational polynomial camera (a frozen copy of the port's
``geometry/rpc.py``, without the inverse).

    row = LINE_OFF + LINE_SCALE * num_row(P, L, H) / den_row(P, L, H)
    col = SAMP_OFF + SAMP_SCALE * num_col(P, L, H) / den_col(P, L, H)

with P, L, H the normalised latitude, longitude and height and the RPC00B
monomial order. Fields are float32 tensors; :meth:`RPCCamera.from_dict`
also keeps the float64 originals for the host geometry fit
(:meth:`RPCCamera.project_np`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# RPC00B / GDAL coefficient ordering: monomials of (L=lon_n, P=lat_n, H=h_n)
# 1, L, P, H, LP, LH, PH, L^2, P^2, H^2,
# PLH, L^3, LP^2, LH^2, L^2P, P^3, PH^2, L^2H, P^2H, H^3


def _monomials(L, P, H, stack):
    one = L * 0 + 1
    return stack(
        [
            one, L, P, H,
            L * P, L * H, P * H, L * L, P * P, H * H,
            P * L * H, L ** 3, L * P * P, L * H * H, L * L * P,
            P ** 3, P * H * H, L * L * H, P * P * H, H ** 3,
        ],
        -1,
    )


_F64_KEYS = {
    "line_off": "LINE_OFF", "samp_off": "SAMP_OFF", "lat_off": "LAT_OFF",
    "long_off": "LONG_OFF", "height_off": "HEIGHT_OFF",
    "line_scale": "LINE_SCALE", "samp_scale": "SAMP_SCALE",
    "lat_scale": "LAT_SCALE", "long_scale": "LONG_SCALE",
    "height_scale": "HEIGHT_SCALE", "line_num": "LINE_NUM_COEFF",
    "line_den": "LINE_DEN_COEFF", "samp_num": "SAMP_NUM_COEFF",
    "samp_den": "SAMP_DEN_COEFF",
}


@dataclass
class RPCCamera:
    """RPC00B camera. Fields are float32 scalars or (20,) tensors; ``f64``
    holds the float64 values by GDAL key when built by :meth:`from_dict`."""

    line_off: torch.Tensor
    samp_off: torch.Tensor
    lat_off: torch.Tensor
    long_off: torch.Tensor
    height_off: torch.Tensor
    line_scale: torch.Tensor
    samp_scale: torch.Tensor
    lat_scale: torch.Tensor
    long_scale: torch.Tensor
    height_scale: torch.Tensor
    line_num: torch.Tensor  # (20,)
    line_den: torch.Tensor
    samp_num: torch.Tensor
    samp_den: torch.Tensor
    f64: dict | None = None

    @classmethod
    def from_dict(cls, d: dict) -> "RPCCamera":
        """Build from a GDAL-style RPC tag dict (LINE_OFF, LINE_NUM_COEFF...),
        keeping the float64 originals: rounding LAT_OFF/LONG_OFF to float32
        before the host fit biases each camera by ~0.3 px at WV3 scale."""
        f64: dict = {}
        fields = {}
        for field, key in _F64_KEYS.items():
            v = d[key]
            if isinstance(v, str):
                v = [float(t) for t in v.split()]
            if np.ndim(v) == 0:
                f64[key] = float(v)
            else:
                f64[key] = np.asarray(v, np.float64)
            fields[field] = torch.as_tensor(np.float32(f64[key]))
        return cls(**fields, f64=f64)

    def _host(self, field: str):
        """Float64 value of a field (exact when built by from_dict)."""
        if self.f64 is not None:
            return self.f64[_F64_KEYS[field]]
        return getattr(self, field).double().numpy()

    def project(self, lon, lat, h):
        """Forward: geodetic -> (col, row) pixels, float32 tensors."""
        L = (lon - self.long_off) / self.long_scale
        P = (lat - self.lat_off) / self.lat_scale
        H = (h - self.height_off) / self.height_scale
        m = _monomials(L, P, H, torch.stack)
        row = self.line_off + self.line_scale * (m @ self.line_num) / (
            m @ self.line_den)
        col = self.samp_off + self.samp_scale * (m @ self.samp_num) / (
            m @ self.samp_den)
        return col, row


    def project_np(self, lon, lat, h):
        """Host float64 forward projection (the geometry fit's path)."""
        lon = np.asarray(lon, np.float64)
        lat = np.asarray(lat, np.float64)
        h = np.asarray(h, np.float64)
        L = (lon - self._host("long_off")) / self._host("long_scale")
        P = (lat - self._host("lat_off")) / self._host("lat_scale")
        H = (h - self._host("height_off")) / self._host("height_scale")
        m = _monomials(L, P, H, np.stack)
        row_n = m @ self._host("line_num")
        row_d = m @ self._host("line_den")
        col_n = m @ self._host("samp_num")
        col_d = m @ self._host("samp_den")
        row = self._host("line_off") + self._host("line_scale") * row_n / row_d
        col = self._host("samp_off") + self._host("samp_scale") * col_n / col_d
        return col, row
