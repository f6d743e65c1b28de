"""Super-resolution + inpainting plugins (port of
``pcmi_tpu/pipelines/superres.py``).

``SuperResolutionPlugin`` runs a U-Net residual model over the bicubic 4x
upsample and returns LR / bicubic / SR layers; ``InpaintingPlugin``
detects near-black holes and repaints them. Both drive the port's
:mod:`pcmi_tpu_torch.models.unet` networks on ``device`` (default
``"cuda"``). A ``checkpoint`` is a ``state_dict`` file
(``torch.save(model.state_dict(), path)``; the reference's orbax
directories cannot be read here). With no checkpoint on disk the plugins
still run, on an untrained network drawn from a ``torch.Generator``
seeded with 0: Flax's initialisers, but a draw of the port's own, not the
reference's ``PRNGKey(0)`` weights.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from pcmi_tpu_torch.interface import Layer, SatellitePlugin
from pcmi_tpu_torch.models.unet import InpaintUNet, SRUNet, bicubic_upsample
from pcmi_tpu_torch.ops.filters import masked_jacobi_fill
from pcmi_tpu_torch.ops.morphology import binary_dilation


def _pad_to_multiple(arr: np.ndarray, m: int):
    """Edge-pad H, W to multiples of ``m`` (U-Net decoders need it);
    returns (padded, (h0, w0)) for cropping back."""
    h0, w0 = arr.shape[:2]
    ph = (-h0) % m
    pw = (-w0) % m
    if ph or pw:
        widths = [(0, ph), (0, pw)] + [(0, 0)] * (arr.ndim - 2)
        arr = np.pad(arr, widths, mode="edge")
    return arr, (h0, w0)


def create_inpaint_mask(image: np.ndarray, thresh: float = 1.0 / 255.0,
                        margin: int = 2, device="cuda") -> np.ndarray:
    """Near-black hole detection (all channels <= ``thresh`` of the
    image's scale), dilated by ``margin`` on ``device``; a host mask."""
    img = np.asarray(image, np.float32)
    scale = img.max() if img.max() > 1.5 else 1.0
    mono = (img / scale)
    if mono.ndim == 3:
        hole = (mono <= thresh).all(-1)
    else:
        hole = mono <= thresh
    return binary_dilation(torch.from_numpy(hole).to(device),
                           iterations=margin).cpu().numpy()


class _Network:
    """A U-Net that moves to its device, and loads its checkpoint, at its
    first use."""

    def __init__(self, model: torch.nn.Module, checkpoint: Optional[str],
                 device):
        self.model = model
        self.checkpoint = checkpoint
        self.device = torch.device(device)
        self._ready = False

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not self._ready:
            self.model.to(self.device).eval()
            if self.checkpoint and os.path.exists(self.checkpoint):
                self.model.load_state_dict(torch.load(
                    self.checkpoint, map_location=self.device,
                    weights_only=True))
            self._ready = True
        with torch.no_grad():
            return self.model(x)


class SuperResolutionPlugin(SatellitePlugin):
    """4x super-resolution over the bicubic upsample."""

    def __init__(self, checkpoint: Optional[str] = None, factor: int = 4,
                 device="cuda"):
        self.model = SRUNet()
        self.factor = factor
        self.checkpoint = checkpoint
        self.device = torch.device(device)
        self._net = _Network(self.model, checkpoint, self.device)

    @property
    def name(self) -> str:
        return "Super Resolution"

    def run(self, image: np.ndarray, viewer=None) -> List[Layer]:
        img = np.asarray(image, np.float32)
        scale = img.max() if img.max() > 1.5 else 1.0
        x = img / scale
        if x.ndim == 2:
            x = np.stack([x] * 3, -1)
        # SRUNet has 2 downsamples: the 4x-upsampled frame needs H, W % 4 == 0,
        # i.e. the LR frame padded to even dims
        x, (h0, w0) = _pad_to_multiple(x, 2)
        lr = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)[None]
        up = bicubic_upsample(lr, self.factor)
        sr = self._net(up)
        f = self.factor
        up_np = up[0, : h0 * f, : w0 * f].cpu().numpy()
        sr_np = sr[0, : h0 * f, : w0 * f].cpu().numpy()
        return [
            (image, {"name": "low-res input"}, "image"),
            (up_np * scale, {"name": "bicubic 4x"}, "image"),
            (np.clip(sr_np, 0, 1) * scale, {"name": "super-res 4x"}, "image"),
        ]


class InpaintingPlugin(SatellitePlugin):
    """Hole inpainting: a Jacobi prefill of the hole, then the U-Net's
    masked residual."""

    def __init__(self, checkpoint: Optional[str] = None, device="cuda"):
        self.model = InpaintUNet()
        self.checkpoint = checkpoint
        self.device = torch.device(device)
        self._net = _Network(self.model, checkpoint, self.device)

    @property
    def name(self) -> str:
        return "Inpainting"

    def run(self, image: np.ndarray, viewer=None,
            mask: Optional[np.ndarray] = None) -> List[Layer]:
        img = np.asarray(image, np.float32)
        scale = img.max() if img.max() > 1.5 else 1.0
        x = img / scale
        if x.ndim == 2:
            x = np.stack([x] * 3, -1)
        if mask is None:
            mask = create_inpaint_mask(img, device=self.device)
        # InpaintUNet has 3 downsamples -> H, W must be multiples of 8
        x, (h0, w0) = _pad_to_multiple(x, 8)
        mask_p, _ = _pad_to_multiple(np.asarray(mask, np.float32), 8)
        dev = self.device
        m = torch.from_numpy(np.ascontiguousarray(mask_p)).to(dev)
        rgb = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        # prefill conditioning, as the reference's trainer conditions
        filled = masked_jacobi_fill(rgb, m, 64)
        inp = torch.cat([filled, m[..., None]], dim=-1)[None]
        out = self._net(inp)
        return [
            (image, {"name": "input"}, "image"),
            (np.asarray(mask).astype(np.uint8),
             {"name": "hole mask", "opacity": 0.4}, "image"),
            (np.clip(out[0, :h0, :w0].cpu().numpy(), 0, 1) * scale,
             {"name": "inpainted"}, "image"),
        ]
