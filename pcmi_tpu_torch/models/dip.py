"""Deep Image Prior engine (port of ``pcmi_tpu/models/dip.py``).

A fixed 32-channel noise input is pushed through a small U-Net; Adam
minimises the MSE against the *known* pixels only, and the converged
output fills the holes. The reference runs the whole optimisation as one
``lax.scan``; here it is a Python loop of ``torch.optim.Adam`` steps on
the engine's ``device`` (default ``"cuda"``).

The noise input, the network's initial weights and each step's input
jitter come from one CPU ``torch.Generator`` seeded with ``seed`` (the
reference draws them from ``jax.random``) and move to the device, so CPU
and card runs of one seed start alike. :meth:`DIPEngine._fit` takes them
from outside instead.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Iterable, NamedTuple, Optional

import numpy as np
import torch

from pcmi_tpu_torch.models.training import adam, apply_gradients
from pcmi_tpu_torch.models.unet import DIPUNet, _init_params, image_resize


@dataclasses.dataclass(frozen=True)
class DIPConfig:
    iters: int = 800
    lr: float = 1e-2
    noise_channels: int = 32
    noise_reg: float = 0.03       # per-step input jitter
    max_size: int = 512           # larger images are fitted downscaled


class DIPResult(NamedTuple):
    output: torch.Tensor          # (H, W, C) restored image
    losses: torch.Tensor          # (iters,) loss curve


def _as_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


class DIPEngine:
    """restore/stitch/enhance(image, mask) — mask 1 = pixel to synthesise.

    ``model`` is the network recipe (a :class:`DIPUNet` whose
    ``in_channels`` is the config's ``noise_channels``); every run fits a
    fresh copy of it, its weights drawn anew."""

    def __init__(self, cfg: DIPConfig = DIPConfig(), device="cuda",
                 model: Optional[DIPUNet] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model or DIPUNet(in_channels=cfg.noise_channels)

    def _fit(self, image: torch.Tensor, known: torch.Tensor,
             z0: torch.Tensor, net: torch.nn.Module,
             jitter: Iterable[torch.Tensor]):
        """The optimisation from given draws: ``net`` (trained in place)
        from its current weights, the (1, H, W, noise_channels) input
        ``z0``, and one standard-normal (1, H, W, noise_channels) draw per
        step in ``jitter``. Returns (output (H, W, C), losses)."""
        cfg = self.cfg
        dev = self.device
        net = net.to(dev).train()
        z0 = z0.to(dev)
        target = image.to(dev)[None]
        kw = known.to(dev)[None, ..., None].float()
        denom = torch.clamp(kw.sum(), min=1.0)
        opt = adam(net.parameters(), dev, lr=cfg.lr)
        params = list(net.parameters())
        losses = []
        n = 0
        for noise in jitter:
            if n == cfg.iters:
                break
            z = z0 + cfg.noise_reg * noise.to(dev)
            loss = (((net(z) - target) ** 2) * kw).sum() / denom
            apply_gradients(opt, params, loss)
            losses.append(loss.detach())
            n += 1
        if n != cfg.iters:
            raise ValueError(f"jitter gave {n} draws for {cfg.iters} steps")
        with torch.no_grad():
            out = net(z0)[0]
        return out, torch.stack(losses) if losses else torch.zeros(0, device=dev)

    def _run(self, image: torch.Tensor, known: torch.Tensor, seed: int):
        """The draws of ``seed`` (noise input, weights, then each step's
        jitter, from one CPU generator) through :meth:`_fit`."""
        cfg = self.cfg
        h, w = image.shape[:2]
        rng = torch.Generator().manual_seed(int(seed))
        shape = (1, h, w, cfg.noise_channels)
        z0 = 0.1 * torch.randn(shape, generator=rng)
        net = copy.deepcopy(self.model)
        _init_params(net, rng)

        def jitter():
            for _ in range(cfg.iters):
                yield torch.randn(shape, generator=rng)

        return self._fit(image, known, z0, net, jitter())

    def _prep(self, image, mask):
        """Channelise, downscale to ``max_size`` (antialiased linear, as
        ``jax.image.resize``), pad to the U-Net's stride. Returns the image,
        the mask, the original size and whether the image was 2-D."""
        dev = self.device
        img = _as_tensor(image, dev)
        squeeze = img.dim() == 2
        if squeeze:
            img = img[..., None]
        m = _as_tensor(mask, dev)
        if m.dim() == 3:
            m = m[..., 0]
        h0, w0 = img.shape[:2]
        scale = max(h0, w0) / self.cfg.max_size
        if scale > 1.0:
            h1 = int(round(h0 / scale))
            w1 = int(round(w0 / scale))
            img = image_resize(img, (h1, w1, img.shape[-1]), "linear")
            m = (image_resize(m, (h1, w1), "linear") > 0.25).float()
        stride = 2 ** (len(self.model.widths) - 1)
        ph = (-img.shape[0]) % stride
        pw = (-img.shape[1]) % stride
        if ph or pw:
            img = torch.nn.functional.pad(
                img.permute(2, 0, 1)[None], (0, pw, 0, ph),
                mode="replicate")[0].permute(1, 2, 0)
            m = torch.nn.functional.pad(m, (0, pw, 0, ph))
        return img, m, (h0, w0), squeeze

    def _finish(self, out, orig_image, mask_full, size, squeeze):
        h0, w0 = size
        dev = self.device
        if out.shape[:2] != (h0, w0):
            out = image_resize(out, (h0, w0, out.shape[-1]), "linear")
        img = _as_tensor(orig_image, dev)
        if squeeze:
            img = img[..., None]
        m = _as_tensor(mask_full, dev)
        if m.dim() == 3:
            m = m[..., 0]
        comp = torch.where((m < 0.5)[..., None], img, out)
        if squeeze:
            comp = comp[..., 0]
        return comp

    def restore(self, image, mask, seed: int = 0) -> DIPResult:
        """``mask`` 1 = hole. Returns the reconstruction composited so the
        known pixels keep their values."""
        img, m, size, squeeze = self._prep(image, mask)
        out, losses = self._run(img, m < 0.5, seed)
        comp = self._finish(out, image, mask, size, squeeze)
        return DIPResult(output=comp, losses=losses)

    # stitching = restoring the composite's gap: same semantics
    stitch = restore

    def enhance(self, image, mask=None, seed: int = 0) -> DIPResult:
        """Fit the whole image (every pixel known) and return the network's
        reconstruction: the prior is the enhancer."""
        img, _, size, squeeze = self._prep(image,
                                           torch.zeros(tuple(image.shape[:2])))
        known = torch.ones(img.shape[:2], dtype=torch.bool, device=img.device)
        out, losses = self._run(img, known, seed)
        h0, w0 = size
        if out.shape[:2] != (h0, w0):
            out = image_resize(out, (h0, w0, out.shape[-1]), "linear")
        if squeeze:
            out = out[..., 0]
        return DIPResult(output=out, losses=losses)
