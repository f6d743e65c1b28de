"""Carry state from ``pcmi_tpu`` objects into the port's.

The caller turns the reference's objects into numpy arrays and plain
dicts first (``np.asarray`` on arrays; an RPC camera's float64 tag dict);
nothing here sees a JAX type, so the same scene can run through both
packages.
"""

from __future__ import annotations

import numpy as np
import torch

from pcmi_tpu_torch.geometry.affine import LocalFrame
from pcmi_tpu_torch.geometry.rpc import RPCCamera
from pcmi_tpu_torch.geometry.synthetic import SyntheticScene


def rpc_from_reference(d: dict) -> RPCCamera:
    """RPC camera from the GDAL-style float64 tag dict that
    ``pcmi_tpu.geometry.rpc.RPCCamera.from_dict`` keeps as ``cam._f64``."""
    return RPCCamera.from_dict(d)


def scene_from_arrays(images, terrain, ground_origin, ground_gsd: float,
                      frame_lonlat, rpc_dicts, h_range) -> SyntheticScene:
    """A :class:`SyntheticScene` from the reference scene's arrays:
    ``images`` (per view, (H, W)), ``terrain`` (Hg, Wg), the ground origin
    and gsd, the frame anchor ``(lon0, lat0)`` and each view's RPC dict.
    Cameras, per-view truth and the texture are not carried."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32).copy())

    return SyntheticScene(
        images=[t(im) for im in images],
        heights=[],
        cameras=[],
        rpcs=[rpc_from_reference(d) for d in rpc_dicts],
        frame=LocalFrame(lon0=float(frame_lonlat[0]),
                         lat0=float(frame_lonlat[1])),
        terrain=t(terrain),
        texture=None,
        ground_gsd=float(ground_gsd),
        ground_origin=tuple(float(v) for v in ground_origin),
        h_range=tuple(h_range))
