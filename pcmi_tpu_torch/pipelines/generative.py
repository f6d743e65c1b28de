"""Generative restoration, stitching and enhancement processors and their
engines (port of ``pcmi_tpu/pipelines/generative.py``).

Three task processors share their pre- and post-steps:

* NaN-mask extraction with a dilation margin;
* a masked diffusion prefill (:func:`diffusion_prefill`, Jacobi relaxation
  of the hole from its rim) that seeds the generative engine with
  something smooth;
* a distance-feathered re-blend of the engine's output;
* a side-by-side composite with an ``overlap`` gap for stitching;
* a high-frequency re-blend for enhancement.

Engines answer ``restore(image, mask)``, ``stitch`` and ``enhance``:
:class:`pcmi_tpu_torch.models.dip.DIPEngine` and
:class:`pcmi_tpu_torch.models.diffusion.TiledDiffusionEngine`. The
processors and the plugin run on ``device`` (default ``"cuda"``) and take
and return host arrays.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from pcmi_tpu_torch.interface import Layer, SatellitePlugin
from pcmi_tpu_torch.models.diffusion import TiledDiffusionEngine
from pcmi_tpu_torch.models.dip import DIPConfig, DIPEngine
from pcmi_tpu_torch.models.dip import _as_tensor as _tensor
from pcmi_tpu_torch.ops.filters import gaussian_filter, masked_jacobi_fill
from pcmi_tpu_torch.ops.fused import mul_add, recip
from pcmi_tpu_torch.ops.morphology import binary_dilation, distance_transform

# one implementation, shared with the inpainting trainer's conditioning
diffusion_prefill = masked_jacobi_fill


def feather_blend(original: torch.Tensor, generated: torch.Tensor,
                  mask: torch.Tensor, blend_width: int = 8) -> torch.Tensor:
    """Distance-feathered composite of ``generated`` into ``original``
    inside ``mask``: weight ``clip(d / blend_width, 0, 1)`` with ``d`` the
    chamfer distance to the nearest pixel outside the mask (rounded as
    the reference's compiler rounds it on the CPU)."""
    d = distance_transform(mask > 0.5, max_dist=blend_width)
    alpha = torch.clamp(d * recip(blend_width).to(d.device), 0.0, 1.0)
    # the reference's compiler fuses the first product of an (H, W, C)
    # blend into its multiply-add on the CPU, the second of an (H, W) one
    if original.dim() == 3:
        alpha = alpha[..., None]
        return mul_add(original, 1.0 - alpha, generated * alpha)
    return mul_add(generated, alpha, original * (1.0 - alpha))


def nan_mask(image, margin: int = 10, device="cuda") -> np.ndarray:
    """Non-finite pixels (any channel) as a hole mask, dilated by
    ``margin`` on ``device``; a host bool array."""
    m = ~np.isfinite(np.asarray(image))
    if m.ndim == 3:
        m = m.any(-1)
    return binary_dilation(torch.from_numpy(m).to(device),
                           iterations=margin).cpu().numpy()


class ImageRestorationProcessor:
    """mask -> prefill -> ``engine.restore`` -> feathered blend."""

    def __init__(self, engine, margin: int = 10, blend_width: int = 8,
                 device="cuda"):
        self.engine = engine
        self.margin = margin
        self.blend_width = blend_width
        self.device = torch.device(device)

    def process(self, image: np.ndarray, mask: np.ndarray | None = None):
        img = np.asarray(image, np.float32)
        if mask is None:
            mask = nan_mask(img, self.margin, self.device)
        m = _tensor(mask, self.device)
        clean = torch.nan_to_num(_tensor(img, self.device))
        prefilled = diffusion_prefill(clean, m)
        restored = self.engine.restore(prefilled, m).output
        return feather_blend(clean, restored.to(self.device), m,
                             self.blend_width).cpu().numpy()


class StitchingProcessor:
    """Side-by-side composite with an ``overlap`` gap the engine fills."""

    def __init__(self, engine, overlap: int = 64, blend_width: int = 5,
                 device="cuda"):
        self.engine = engine
        self.overlap = overlap
        self.blend_width = blend_width
        self.device = torch.device(device)

    def compose(self, left: np.ndarray, right: np.ndarray):
        """(canvas, mask): the two images side by side (cut to the shorter
        height) with ``overlap`` zero columns between them, the gap 1 in
        the mask."""
        left = np.asarray(left, np.float32)
        right = np.asarray(right, np.float32)
        h = min(left.shape[0], right.shape[0])
        left, right = left[:h], right[:h]
        gap = self.overlap
        w = left.shape[1] + gap + right.shape[1]
        canvas = np.zeros((h, w) + left.shape[2:], np.float32)
        canvas[:, : left.shape[1]] = left
        canvas[:, left.shape[1] + gap:] = right
        mask = np.zeros((h, w), np.float32)
        mask[:, left.shape[1]: left.shape[1] + gap] = 1.0
        return canvas, mask

    def process(self, left: np.ndarray, right: np.ndarray):
        canvas, mask = self.compose(left, right)
        m = _tensor(mask, self.device)
        c = _tensor(canvas, self.device)
        out = self.engine.stitch(diffusion_prefill(c, m), m).output
        return feather_blend(c, out.to(self.device), m,
                             self.blend_width).cpu().numpy()


class EnhancementProcessor:
    """The engine's whole-image reconstruction plus ``hf_weight`` times the
    original's high frequencies (above a ``hf_sigma`` Gaussian), clipped
    to [0, 1]."""

    def __init__(self, engine, hf_sigma: float = 2.0, hf_weight: float = 0.6,
                 device="cuda"):
        self.engine = engine
        self.hf_sigma = hf_sigma
        self.hf_weight = hf_weight
        self.device = torch.device(device)

    def process(self, image: np.ndarray):
        img = _tensor(image, self.device)
        # enhance() fits the whole (known) image: an all-hole mask would
        # train on zero loss
        out = self.engine.enhance(img).output.to(self.device)
        hf = img - gaussian_filter(img, self.hf_sigma)
        return torch.clamp(out + self.hf_weight * hf, 0.0, 1.0).cpu().numpy()


def available_engines() -> Dict[str, Callable]:
    """Engine registry: name -> engine class (each takes ``device=``)."""
    return {"Deep Image Prior": DIPEngine, "Diffusion": TiledDiffusionEngine}


class RestorationGenerativePlugin(SatellitePlugin):
    """NaN-hole restoration through a generative engine (by default
    ``DIPEngine(DIPConfig(iters=300))``) on ``device``."""

    def __init__(self, engine=None, device="cuda"):
        if engine is None:
            engine = DIPEngine(DIPConfig(iters=300), device=device)
        self.processor = ImageRestorationProcessor(engine, device=device)

    @property
    def name(self) -> str:
        return "Generative Restoration"

    def run(self, image: np.ndarray, viewer=None) -> List[Layer]:
        img = np.asarray(image, np.float32)
        # [0, 1] at the engine boundary: DIP's sigmoid head cannot reach
        # 0-255 values
        scale = (img.max() if np.isfinite(img).any() and np.nanmax(img) > 1.5
                 else 1.0)
        restored = self.processor.process(img / scale) * scale
        return [
            (image, {"name": "input"}, "image"),
            (restored, {"name": "restored"}, "image"),
        ]
