"""Classical restoration: NLM denoise -> dark-channel dehaze -> unsharp
(port of ``pcmi_tpu/pipelines/restoration.py``).

Non-local means is the shifted-SSD formulation: every search offset
contributes ``exp(-boxfilter((I - shift(I))²)/h²)·shift(I)``. The weights
of one row of offsets are computed as one batch; the terms are then added
one offset at a time, in the reference's row-major order. Dark Channel
Prior dehazing (min-channel erosion, atmospheric light from the brightest
0.1 % of the dark channel, transmission ``1 - 0.95·dark`` clipped to
[0.1, 1] and Gaussian-refined, radiance ``J = (I - A)/t + A``), unsharp
masking, and the synthetic haze + noise degradation used to test them.
Images are float32 [0, 1], ``(H, W)`` or ``(H, W, 3)``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from pcmi_tpu_torch.interface import Layer, SatellitePlugin
from pcmi_tpu_torch.ops.filters import box_filter, gaussian_filter, unsharp_mask
from pcmi_tpu_torch.ops.morphology import grey_erosion
from pcmi_tpu_torch.ops.normalize import _masked_quantile
from pcmi_tpu_torch.ops.warp import map_coordinates
from pcmi_tpu_torch.pipelines.saliency import _linspace, _reflect_index


def _reflect_pad(x: torch.Tensor, r: int) -> torch.Tensor:
    """numpy ``mode="reflect"`` padding of the first two axes by ``r``."""
    ri = _reflect_index(x.shape[0], r, r, x.device)
    ci = _reflect_index(x.shape[1], r, r, x.device)
    return x[ri][:, ci]


def nlm_denoise(
    img: torch.Tensor,
    h: float = 6.0 / 255.0,
    template: int = 7,
    search: int = 21,
) -> torch.Tensor:
    """Non-local means on [0, 1] images (OpenCV's h = 6 on uint8 is 6/255
    here); the patch distance is taken on the channel mean."""
    x = img.float()
    mono = x if x.dim() == 2 else x.mean(-1)
    H, W = mono.shape
    r = search // 2
    tpad = template // 2
    h2 = h * h * template * template
    mp = _reflect_pad(mono, r)
    xp = _reflect_pad(x, r)
    num = torch.zeros_like(x)
    den = torch.zeros_like(mono)
    for oy in range(search):
        # one row of offsets: the weights as one (H, W, search) batch ...
        cores = mp[oy:oy + H].unfold(1, W, 1)[:, :search]       # (H, S, W)
        ssd = box_filter(((mono[:, None, :] - cores) ** 2).permute(0, 2, 1),
                         tpad)                                  # (H, W, S)
        wgt = torch.exp(-ssd / h2)
        for ox in range(search):
            # ... and the terms added in the reference's order
            w = wgt[..., ox]
            sx = xp[oy:oy + H, ox:ox + W]
            num = num + (w[..., None] if x.dim() == 3 else w) * sx
            den = den + w
    den = torch.clamp(den, min=1e-8)
    return num / (den[..., None] if x.dim() == 3 else den)


class DehazeResult(NamedTuple):
    radiance: torch.Tensor      # restored image
    transmission: torch.Tensor  # (H, W) in [0.1, 1]
    atmosphere: torch.Tensor    # scalar or (3,) airlight


def dark_channel_dehaze(
    img: torch.Tensor, erosion: int = 25, strength: float = 0.95
) -> DehazeResult:
    """Dark Channel Prior dehazing."""
    x = img.float()
    chan_min = x if x.dim() == 2 else x.amin(-1)
    dark = grey_erosion(chan_min, erosion)

    # atmospheric light: median intensity of the top 0.1 % dark-channel
    # pixels
    q = _masked_quantile(dark, torch.ones_like(dark, dtype=torch.bool), 0.999)
    top = dark >= q
    inten = x if x.dim() == 2 else x.mean(-1)
    A_scalar = _masked_quantile(inten, top, 0.5)
    A = A_scalar if x.dim() == 2 else A_scalar.expand(3)

    t = 1.0 - strength * dark / torch.clamp(A_scalar, min=1e-6)
    t = torch.clamp(t, 0.1, 1.0)
    t = gaussian_filter(t, 8.0)  # refined with a large Gaussian
    t = torch.clamp(t, 0.1, 1.0)
    tb = t if x.dim() == 2 else t[..., None]
    J = (x - A) / tb + A
    return DehazeResult(radiance=torch.clamp(J, 0.0, 1.0), transmission=t,
                        atmosphere=A)


def _degrade(img: torch.Tensor, low: torch.Tensor, noise: torch.Tensor,
             haze_strength: float = 0.6, noise_sigma: float = 0.02):
    """:func:`add_degradation` from its draws: ``low``, uniform on
    ``(h // 32 + 2, w // 32 + 2)``, and ``noise``, standard normal of the
    image's shape."""
    x = img.float()
    h, w = x.shape[:2]
    ys = _linspace(low.shape[0] - 2.0, h, x.device)
    xs = _linspace(low.shape[1] - 2.0, w, x.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    t_field = 1.0 - haze_strength * (0.5 + 0.5 * map_coordinates(
        low.to(x.device), gy, gx))
    A = 0.9
    tb = t_field if x.dim() == 2 else t_field[..., None]
    hazy = x * tb + A * (1.0 - tb)
    noisy = hazy + noise_sigma * noise.to(x.device)
    return torch.clamp(noisy, 0.0, 1.0), t_field


def add_degradation(
    img: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    haze_strength: float = 0.6,
    noise_sigma: float = 0.02,
):
    """Synthetic haze + Gaussian noise, the fault-injection path of the
    restoration tests: a smooth transmission field (a coarse uniform draw
    bilinearly upsampled), airlight 0.9, then noise.

    The draws come from ``generator`` on its own device (by default a CPU
    generator seeded with 0, the counterpart of the reference's
    ``PRNGKey(0)``) and are moved to the image's device, so the same
    generator gives the same degradation on every device."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    h, w = img.shape[:2]
    gdev = generator.device
    low = torch.rand((h // 32 + 2, w // 32 + 2), generator=generator,
                     device=gdev)
    noise = torch.randn(tuple(img.shape), generator=generator, device=gdev)
    return _degrade(img, low, noise, haze_strength, noise_sigma)


class RestorationEngine:
    """restore(): denoise -> dehaze -> sharpen."""

    def __init__(self, nlm_h: float = 6.0 / 255.0, erosion: int = 25,
                 unsharp_amount: float = 0.5):
        self.nlm_h = nlm_h
        self.erosion = erosion
        self.unsharp_amount = unsharp_amount

    def restore(self, img: torch.Tensor):
        den = nlm_denoise(img, h=self.nlm_h)
        dh = dark_channel_dehaze(den, erosion=self.erosion)
        sharp = unsharp_mask(dh.radiance, amount=self.unsharp_amount)
        return {
            "denoised": den,
            "dehazed": dh.radiance,
            "transmission": dh.transmission,
            "output": sharp,
        }


class RestorationPlugin(SatellitePlugin):
    """Layers input / denoised / dehazed / restored / transmission
    (viridis); runs on ``device`` (default ``"cuda"``)."""

    def __init__(self, engine: RestorationEngine | None = None,
                 device="cuda"):
        self.engine = engine or RestorationEngine()
        self.device = torch.device(device)

    @property
    def name(self) -> str:
        return "Image Restoration"

    def run(self, image: np.ndarray, viewer=None) -> List[Layer]:
        img = np.asarray(image, np.float32)
        scale = img.max() if img.max() > 1.5 else 1.0
        out = self.engine.restore(
            torch.from_numpy(img / scale).to(self.device))
        host = {k: v.cpu().numpy() for k, v in out.items()}
        return [
            (image, {"name": "input"}, "image"),
            (host["denoised"] * scale, {"name": "denoised"}, "image"),
            (host["dehazed"] * scale, {"name": "dehazed"}, "image"),
            (host["output"] * scale, {"name": "restored"}, "image"),
            (host["transmission"],
             {"name": "transmission", "colormap": "viridis"}, "image"),
        ]
