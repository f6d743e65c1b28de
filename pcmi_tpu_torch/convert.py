"""Carry state from ``pcmi_tpu`` objects into the port's.

Nothing here imports JAX or ``pcmi_tpu``: arrays are read through
``np.asarray`` (which a JAX array supports), records through their
attributes, an RPC camera through its float64 tag dict. So a scene, a pair
selection or a running DSM that the reference started can be carried
over and finished by the port. A reference config becomes the port's own
through :func:`config_from_reference`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pcmi_tpu_torch import config

from pcmi_tpu_torch.geometry.affine import LocalFrame
from pcmi_tpu_torch.geometry.pairs import ImageMeta
from pcmi_tpu_torch.geometry.rpc import RPCCamera
from pcmi_tpu_torch.geometry.synthetic import SyntheticScene
from pcmi_tpu_torch.pipelines.streaming import StreamingDSM


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


def tensor_from_reference(a) -> torch.Tensor:
    """A reference array as a CPU tensor of the same element type. numpy
    has no bfloat16 of its own, so such an array travels through float32
    (every bfloat16 value is a float32 value: exact both ways)."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def metas_from_reference(metas) -> list[ImageMeta]:
    """The port's :class:`ImageMeta` records from the reference's."""
    return [ImageMeta(index=int(m.index),
                      incidence_deg=float(m.incidence_deg),
                      azimuth_deg=float(m.azimuth_deg), date=float(m.date),
                      name=str(m.name))
            for m in metas]


def streaming_dsm_from_reference(acc, device="cuda") -> StreamingDSM:
    """A reference ``StreamingDSM`` (running weight, value and square
    sums) as the port's float32 tensors on ``device``, ready for the
    port's ``dsm_update`` and ``dsm_finalize``."""
    return StreamingDSM(*(
        torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
        for a in (acc.wsum, acc.vsum, acc.vsq)))


def config_from_reference(cfg):
    """The port's config equal to a reference config (``StereoConfig``,
    ``PipelineConfig`` or any other class of :mod:`pcmi_tpu_torch.config`),
    rebuilt field by field, nested configs included."""
    cls = getattr(config, type(cfg).__name__, None)
    if not (isinstance(cls, type) and dataclasses.is_dataclass(cls)):
        raise TypeError(f"no port config class for {type(cfg).__name__}")
    return cls(**{
        f.name: (config_from_reference(v)
                 if dataclasses.is_dataclass(v := getattr(cfg, f.name)) else v)
        for f in dataclasses.fields(cfg)})
