"""Trainable object detector: center-heatmap dense prediction (port of
``pcmi_tpu/models/detector.py``).

Anchor-free center-point detection (CenterNet-style): dense per-pixel
heads, no anchor matching, decode by 3x3 max-pool peak picking:

* backbone: a small norm-free trunk of the U-Net family's ``ConvBlock``s;
* heads: center heatmap (sigmoid focal loss), box size and center offset
  (L1 at the centers), and for oriented boxes (sin 2θ, cos 2θ);
* decode: peaks, then the ``max_boxes`` best in the reference's order
  (:func:`pcmi_tpu_torch.ops.pointcloud.top_k`: the lower index first
  among equal scores), as the fixed (N, K, 6) output the port's
  :class:`~pcmi_tpu_torch.pipelines.detection.ObjectDetector` takes.

Everything runs on the trainer's ``device`` (default ``"cuda"``) in
float32 (no TF32). Weights and synthetic scenes draw from CPU
``torch.Generator``s (not the reference's ``jax.random`` streams) and move
to the device; :func:`render_obb_batch` and
:func:`render_detection_batch` take given draws instead.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pcmi_tpu_torch.models.training import adam, apply_gradients
from pcmi_tpu_torch.models.unet import (
    ConvBlock, SameConv2d, _down, _init_params, image_resize)
from pcmi_tpu_torch.ops.pointcloud import top_k

HEAT_BIAS = -2.19  # sigmoid(-2.19) ~ 0.1: the focal loss's prior


class CenterNetHead(nn.Module):
    """(B, H, W, C_in) -> heatmap logits (B, H/4, W/4, n_classes), size
    (.., 2), offset (.., 2)[, angle (.., 2)]: output stride 4.

    ``with_angle`` adds an oriented-box head predicting (sin 2θ, cos 2θ),
    continuous under the rectangle's π symmetry."""

    def __init__(self, widths: Sequence[int] = (32, 64, 128),
                 n_classes: int = 1, with_angle: bool = False,
                 in_channels: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w0, w1, w2 = tuple(widths)
        self.widths = (w0, w1, w2)
        self.n_classes = n_classes
        self.with_angle = with_angle
        self.blocks = nn.ModuleList([
            ConvBlock(w0, False, in_channels), ConvBlock(w1, False, w0),
            ConvBlock(w2, False, w1), ConvBlock(w2, False, w2)])
        self.heat = SameConv2d(w2, n_classes, 1)
        self.size = SameConv2d(w2, 2, 1)
        self.offset = SameConv2d(w2, 2, 1)
        self.angle = SameConv2d(w2, 2, 1) if with_angle else None
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Flax's initialisers drawn from ``generator``, the heatmap's
        bias at :data:`HEAT_BIAS`."""
        _init_params(self, generator)
        with torch.no_grad():
            self.heat.bias.fill_(HEAT_BIAS)

    def forward(self, x: torch.Tensor):
        h = x.permute(0, 3, 1, 2)
        h = _down(self.blocks[0](h))
        h = _down(self.blocks[1](h))
        h = self.blocks[3](self.blocks[2](h))
        heads = [self.heat, self.size, self.offset]
        if self.with_angle:
            heads.append(self.angle)
        return tuple(head(h).permute(0, 2, 3, 1) for head in heads)


def gaussian_heatmap(centers: torch.Tensor, valid: torch.Tensor,
                     shape: Tuple[int, int], sigma: torch.Tensor
                     ) -> torch.Tensor:
    """Ground-truth center gaussians: (..., N, 2) centers, (..., N)
    validity and sigmas -> (..., H, W), the max over the N objects, each
    pinned to exactly 1.0 at its rounded center cell."""
    hh, ww = shape
    dev = centers.device
    ys = torch.arange(hh, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(ww, dtype=torch.float32, device=dev)[None, :]
    cy = centers[..., 0, None, None]
    cx = centers[..., 1, None, None]
    s = sigma[..., None, None]
    d2 = (ys - cy) ** 2 + (xs - cx) ** 2
    g = torch.exp(-d2 / (2 * s ** 2))
    peak = (ys == torch.round(cy)) & (xs == torch.round(cx))
    maps = torch.where(valid[..., None, None], torch.maximum(g, peak.float()),
                       0.0)
    return maps.amax(dim=-3)


def focal_loss(pred_logits, gt_heat, alpha=2.0, beta=4.0):
    """CenterNet's penalty-reduced focal loss."""
    p = torch.sigmoid(pred_logits)
    pos = gt_heat >= 0.999
    pos_loss = -((1 - p) ** alpha) * torch.log(torch.clamp(p, min=1e-6)) * pos
    neg_loss = (-((1 - gt_heat) ** beta) * (p ** alpha)
                * torch.log(torch.clamp(1 - p, min=1e-6)) * (~pos))
    n_pos = torch.clamp(pos.sum().float(), min=1.0)
    return (pos_loss.sum() + neg_loss.sum()) / n_pos


@dataclasses.dataclass(frozen=True)
class DetectorTrainConfig:
    lr: float = 1e-3
    stride: int = 4
    w_size: float = 0.1
    w_offset: float = 1.0
    w_angle: float = 1.0
    max_objects: int = 32


def _gather(t: torch.Tensor, ci: torch.Tensor) -> torch.Tensor:
    """``t[b, ci[b, k, 0], ci[b, k, 1]]`` for (B, h, w, C) ``t``."""
    bidx = torch.arange(t.shape[0], device=t.device)[:, None]
    return t[bidx, ci[..., 0], ci[..., 1]]


def _center_cells(centers: torch.Tensor, hh: int, ww: int) -> torch.Tensor:
    """Integer cells of (B, K, 2) centers (truncated, clipped)."""
    ci = centers.to(torch.int32)
    hi = torch.tensor([hh - 1, ww - 1], dtype=torch.int32, device=ci.device)
    return torch.minimum(torch.clamp(ci, min=0), hi).long()


def _peaks(heat: torch.Tensor, score_thresh: float) -> torch.Tensor:
    """Scores of the 3x3 local maxima above ``score_thresh`` ("SAME",
    -inf outside), 0 elsewhere; (N, h, w)."""
    x = F.pad(heat[:, None], (1, 1, 1, 1), value=float("-inf"))
    peaks = F.max_pool2d(x, 3, stride=1)[:, 0]
    is_peak = (heat == peaks) & (heat > score_thresh)
    return torch.where(is_peak, heat, torch.zeros_like(heat))


class _Trainer:
    """Shared set-up of the two detector trainers."""

    def __init__(self, cfg: DetectorTrainConfig, model: nn.Module, device):
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)

    def optimizer(self, net: nn.Module) -> torch.optim.Adam:
        return adam(net.parameters(), self.device, lr=self.cfg.lr)

    def init(self, sample_images=None, rng: Optional[torch.Generator] = None):
        """A copy of the model with weights drawn from ``rng`` (a CPU
        generator; by default one seeded with 0) on the device, and its
        optimiser. ``sample_images`` is accepted for the reference's
        signature."""
        if rng is None:
            rng = torch.Generator().manual_seed(0)
        net = copy.deepcopy(self.model)
        net.reset_parameters(rng)
        net = net.to(self.device)
        return net, self.optimizer(net)

    def _finish(self, net, opt, total, parts):
        apply_gradients(opt, list(net.parameters()), total)
        return net, opt, {"loss": total.detach(),
                          **{k: v.detach() for k, v in parts.items()}}


class DetectorTrainer(_Trainer):
    """Train step over (images, boxes, box_valid) batches: ``boxes`` are
    (B, K, 4) ``(y0, x0, y1, x1)`` padded with zeros, ``box_valid`` (B, K)
    bool."""

    def __init__(self, cfg: DetectorTrainConfig = DetectorTrainConfig(),
                 model: Optional[nn.Module] = None, device="cuda"):
        super().__init__(cfg, model or CenterNetHead(), device)

    def _targets(self, boxes, valid, out_shape):
        s = self.cfg.stride
        cy = (boxes[:, :, 0] + boxes[:, :, 2]) / 2 / s
        cx = (boxes[:, :, 1] + boxes[:, :, 3]) / 2 / s
        hgt = (boxes[:, :, 2] - boxes[:, :, 0]) / s
        wid = (boxes[:, :, 3] - boxes[:, :, 1]) / s
        sigma = torch.clamp(torch.sqrt(torch.clamp(hgt * wid, min=1.0)) / 3.0,
                            min=1.0)
        centers = torch.stack([cy, cx], dim=-1)
        heat = gaussian_heatmap(centers, valid, out_shape, sigma)
        return heat[..., None], centers, torch.stack([hgt, wid], -1)

    def train_step(self, net, opt, images, boxes, box_valid):
        """One Adam step of ``net`` (in place); returns ``(net, opt,
        losses)``."""
        cfg = self.cfg
        dev = self.device
        images = torch.as_tensor(images, dtype=torch.float32).to(dev)
        boxes = torch.as_tensor(boxes, dtype=torch.float32).to(dev)
        box_valid = torch.as_tensor(box_valid).to(dev).bool()
        heat_l, size_p, off_p = net(images)
        hh, ww = heat_l.shape[1:3]
        gt_heat, centers, sizes = self._targets(boxes, box_valid, (hh, ww))
        l_heat = focal_loss(heat_l[..., 0], gt_heat[..., 0])
        ci = _center_cells(centers, hh, ww)
        sp, op = _gather(size_p, ci), _gather(off_p, ci)
        v = box_valid.float()[..., None]
        n = torch.clamp(v.sum(), min=1.0)
        l_size = ((sp - sizes).abs() * v).sum() / n
        frac = centers - torch.floor(centers)
        l_off = ((op - frac).abs() * v).sum() / n
        total = l_heat + cfg.w_size * l_size + cfg.w_offset * l_off
        return self._finish(net, opt, total,
                            {"heat": l_heat, "size": l_size, "off": l_off})

    def make_tile_detector(self, net, max_boxes: int = 16,
                           score_thresh: float = 0.25):
        """Adapter: (N, T, T[, C]) batch -> (N, max_boxes, 6) = (y0, x0,
        y1, x1, score, class), for ``ObjectDetector``."""
        s = self.cfg.stride

        def detect(batch):
            x = torch.as_tensor(batch, dtype=torch.float32)
            x = x[..., None] if x.dim() == 3 else x
            with torch.no_grad():
                heat_l, size_p, off_p = net(x.to(next(net.parameters()).device))
            heat_all = torch.sigmoid(heat_l)
            heat = heat_all.amax(dim=-1)
            cls = torch.argmax(heat_all, dim=-1)
            score = _peaks(heat, score_thresh)
            n, hh, ww = score.shape
            top, idx = top_k(score.reshape(n, -1), max_boxes)
            ci = torch.stack([idx // ww, idx % ww], -1)
            sz, of = _gather(size_p, ci), _gather(off_p, ci)
            bidx = torch.arange(n, device=idx.device)[:, None]
            kls = cls[bidx, ci[..., 0], ci[..., 1]].float()
            cy = (ci[..., 0].float() + of[..., 0]) * s
            cx = (ci[..., 1].float() + of[..., 1]) * s
            bh = torch.clamp(sz[..., 0], min=0.0) * s
            bw = torch.clamp(sz[..., 1], min=0.0) * s
            return torch.stack([cy - bh / 2, cx - bw / 2, cy + bh / 2,
                                cx + bw / 2, top, kls], dim=-1)

        return detect


class OBBDetectorTrainer(_Trainer):
    """Oriented-box trainer on the same head with the (sin 2θ, cos 2θ)
    output. Ground truth per image: ``obbs`` (B, K, 5) = (cy, cx, h, w,
    theta), ``valid`` (B, K) bool. Decode emits (N, K, 6) = (cy, cx, h, w,
    theta, score); :mod:`pcmi_tpu_torch.models.detector_eval` scores it."""

    def __init__(self, cfg: DetectorTrainConfig = DetectorTrainConfig(),
                 model: Optional[nn.Module] = None, device="cuda"):
        model = model or CenterNetHead(with_angle=True)
        if not getattr(model, "with_angle", False):
            raise ValueError("OBBDetectorTrainer needs a with_angle head")
        super().__init__(cfg, model, device)

    def train_step(self, net, opt, images, obbs, valid):
        cfg = self.cfg
        s = cfg.stride
        dev = self.device
        images = torch.as_tensor(images, dtype=torch.float32).to(dev)
        obbs = torch.as_tensor(obbs, dtype=torch.float32).to(dev)
        valid = torch.as_tensor(valid).to(dev).bool()
        heat_l, size_p, off_p, ang_p = net(images)
        hh, ww = heat_l.shape[1:3]
        cy = obbs[:, :, 0] / s
        cx = obbs[:, :, 1] / s
        sizes = obbs[:, :, 2:4] / s
        theta = obbs[:, :, 4]
        sigma = torch.clamp(torch.sqrt(torch.clamp(
            sizes[..., 0] * sizes[..., 1], min=1.0)) / 3.0, min=1.0)
        centers = torch.stack([cy, cx], dim=-1)
        gt_heat = gaussian_heatmap(centers, valid, (hh, ww), sigma)
        l_heat = focal_loss(heat_l[..., 0], gt_heat)
        ci = _center_cells(centers, hh, ww)
        sp, op, ap_ = (_gather(t, ci) for t in (size_p, off_p, ang_p))
        v = valid.float()[..., None]
        n = torch.clamp(v.sum(), min=1.0)
        l_size = ((sp - sizes).abs() * v).sum() / n
        frac = centers - torch.floor(centers)
        l_off = ((op - frac).abs() * v).sum() / n
        gt_ang = torch.stack([torch.sin(2 * theta), torch.cos(2 * theta)], -1)
        l_ang = ((ap_ - gt_ang).abs() * v).sum() / n
        total = (l_heat + cfg.w_size * l_size + cfg.w_offset * l_off
                 + cfg.w_angle * l_ang)
        return self._finish(net, opt, total, {
            "heat": l_heat, "size": l_size, "off": l_off, "angle": l_ang})

    def make_obb_detector(self, net, max_boxes: int = 16,
                          score_thresh: float = 0.25):
        """(N, T, T[, C]) batch -> (N, max_boxes, 6) = (cy, cx, h, w, θ,
        score)."""
        s = self.cfg.stride

        def detect(batch):
            x = torch.as_tensor(batch, dtype=torch.float32)
            x = x[..., None] if x.dim() == 3 else x
            with torch.no_grad():
                heat_l, size_p, off_p, ang_p = net(
                    x.to(next(net.parameters()).device))
            heat = torch.sigmoid(heat_l).amax(dim=-1)
            score = _peaks(heat, score_thresh)
            n, hh, ww = score.shape
            top, idx = top_k(score.reshape(n, -1), max_boxes)
            ci = torch.stack([idx // ww, idx % ww], -1)
            sz, of, ag = (_gather(t, ci) for t in (size_p, off_p, ang_p))
            theta = 0.5 * torch.atan2(ag[..., 0], ag[..., 1])
            return torch.stack([
                (ci[..., 0].float() + of[..., 0]) * s,
                (ci[..., 1].float() + of[..., 1]) * s,
                torch.clamp(sz[..., 0], min=0.0) * s,
                torch.clamp(sz[..., 1], min=0.0) * s,
                theta, top], dim=-1)

        return detect


# ---------------------------------------------------------------------------
# synthetic training scenes
# ---------------------------------------------------------------------------


def _grid(size: int, device):
    ys = torch.arange(size, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(size, dtype=torch.float32, device=device)[None, :]
    return ys, xs


def _box_frame(ys, xs, cy, cx, th):
    """(u, w): coordinates along and across a box rotated by ``th``,
    broadcast (B, K, H, W)."""
    dy = ys - cy[..., None, None]
    dx = xs - cx[..., None, None]
    c, s = torch.cos(th)[..., None, None], torch.sin(th)[..., None, None]
    return dy * c + dx * s, -dy * s + dx * c


def _stamp(images: torch.Tensor, marks: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) images plus the (B, K, H, W) marks' sum, in [0, 1]."""
    return torch.clamp(images[..., 0] + marks.sum(1), 0, 1)[..., None]


def render_obb_batch(size: int, draws: dict, hard: bool = False):
    """The OBB scene of given draws (tensors on one device): ``gy`` (B,
    size/8 + 2, size/8 + 2, 1) and ``g2`` (B, size/2, size/2, 1) ground
    octaves, ``n_obj`` (B,), per object ``cy``, ``cx``, ``length``,
    ``span``, ``theta``, ``bright`` (B, K); with ``hard``, per distractor
    ``dy``, ``dx``, ``dl``, ``dw``, ``dth``, ``dbr``, ``round`` (B, 4) and
    the roads' ``p0`` (B, 2, 2) and ``ang`` (B, 2). Returns ``(images
    (B, size, size, 1), obbs (B, K, 5), valid (B, K))``."""
    d = draws
    b, k = d["cy"].shape
    dev = d["cy"].device
    ground = image_resize(d["gy"], (b, size, size, 1), "linear")
    ground = 0.45 + 0.12 * ground + 0.06 * image_resize(
        d["g2"], (b, size, size, 1), "linear")
    valid = torch.arange(k, device=dev)[None, :] < d["n_obj"][:, None]
    ys, xs = _grid(size, dev)
    L, Wd = d["length"][..., None, None], d["span"][..., None, None]
    u, w_ = _box_frame(ys, xs, d["cy"], d["cx"], d["theta"])
    fuselage = (u.abs() < L / 2) & (w_.abs() < L / 8)
    wing = (u.abs() < L / 8) & (w_.abs() < Wd / 2)
    tail = (u > L / 2 - L / 6) & (u.abs() < L / 2) & (w_.abs() < Wd / 4)
    shape = fuselage | wing | tail
    marks = torch.where(valid[..., None, None] & shape,
                        d["bright"][..., None, None], 0.0)
    images = _stamp(ground, marks)
    if hard:
        Ld, Wdd = d["dl"][..., None, None], d["dw"][..., None, None]
        u, w_ = _box_frame(ys, xs, d["dy"], d["dx"], d["dth"])
        rect = (u.abs() < Ld / 2) & (w_.abs() < Wdd / 2)
        dy = ys - d["dy"][..., None, None]
        dx = xs - d["dx"][..., None, None]
        disk = (dy * dy + dx * dx) < (Ld / 2) ** 2
        marks = torch.where(torch.where(d["round"][..., None, None], disk,
                                        rect), d["dbr"][..., None, None], 0.0)
        images = _stamp(images, marks)
        p, a = d["p0"], d["ang"]
        dist = ((ys - p[..., 0, None, None]) * torch.sin(a)[..., None, None]
                - (xs - p[..., 1, None, None]) * torch.cos(a)[..., None, None]
                ).abs()
        images = _stamp(images, torch.where(dist < 1.5, -0.25, 0.0))
    obbs = torch.stack([d["cy"], d["cx"], d["length"], d["span"],
                        d["theta"]], dim=-1)
    return images, obbs, valid


def synthesize_obb_batch(rng: Optional[torch.Generator], batch: int = 8,
                         size: int = 128, max_objects: int = 5,
                         hard: bool = False, device="cuda"):
    """Aircraft-like oriented targets on textured ground with exact OBB
    truth: low-frequency terrain, rotated "plane" shapes (fuselage, wing
    bar, tail) at random orientation, scale and contrast. ``hard`` adds
    plane-bright distractors (wingless rectangles and round tanks), two
    dark road lines per scene, a 2x wider target scale range and a lower
    contrast floor. The draws come from ``rng`` (a CPU generator; by
    default one seeded with 0) in the distributions of the reference, and
    the scene is rendered on ``device`` (:func:`render_obb_batch`)."""
    if rng is None:
        rng = torch.Generator().manual_seed(0)
    b, k = batch, max_objects

    def uni(shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=rng)

    lo_l, hi_l = (11.0, 34.0) if hard else (16.0, 30.0)
    lo_b = 0.18 if hard else 0.25
    d = {"gy": torch.randn((b, size // 8 + 2, size // 8 + 2, 1), generator=rng),
         "g2": torch.randn((b, size // 2, size // 2, 1), generator=rng),
         "n_obj": torch.randint(1, k + 1, (b,), generator=rng),
         "cy": uni((b, k), 0.18, 0.82) * size,
         "cx": uni((b, k), 0.18, 0.82) * size,
         "length": uni((b, k), lo_l, hi_l)}
    d["span"] = d["length"] * uni((b, k), 0.7, 0.95)
    d["theta"] = uni((b, k), -np.pi / 2, np.pi / 2)
    d["bright"] = uni((b, k), lo_b, 0.45)
    if hard:
        nd = 4
        d.update(dy=uni((b, nd)) * size, dx=uni((b, nd)) * size,
                 dl=uni((b, nd), 8.0, 26.0))
        d["dw"] = d["dl"] * uni((b, nd), 0.3, 0.6)
        d.update(dth=uni((b, nd), -np.pi / 2, np.pi / 2),
                 dbr=uni((b, nd), lo_b, 0.45), round=uni((b, nd)) < 0.4,
                 p0=uni((b, 2, 2)) * size, ang=uni((b, 2), 0.0, np.pi))
    return render_obb_batch(size, {n: t.to(device) for n, t in d.items()},
                            hard)


def render_detection_batch(size: int, base: torch.Tensor, n_obj, cy, cx, hw):
    """Bright rectangles (0.9) of (B, K, 2) sizes ``hw`` at (B, K) centers
    over the (B, size, size, 1) ``base``: ``(images, boxes (B, K, 4),
    valid)``, the first ``n_obj`` objects of each image valid."""
    k = cy.shape[1]
    valid = torch.arange(k, device=cy.device)[None, :] < n_obj[:, None]
    ys, xs = _grid(size, cy.device)
    inside = (((ys - cy[..., None, None]).abs() < hw[..., 0, None, None] / 2)
              & ((xs - cx[..., None, None]).abs() < hw[..., 1, None, None] / 2))
    blobs = torch.where(valid[..., None, None] & inside, 0.9, 0.0)
    images = _stamp(base, blobs)
    boxes = torch.stack([cy - hw[..., 0] / 2, cx - hw[..., 1] / 2,
                         cy + hw[..., 0] / 2, cx + hw[..., 1] / 2], dim=-1)
    return images, boxes, valid


def synthesize_detection_batch(rng: Optional[torch.Generator], batch: int = 8,
                               size: int = 128, max_objects: int = 6,
                               device="cuda"):
    """Random bright-rectangle scenes and their ground-truth boxes, drawn
    from ``rng`` (a CPU generator; by default one seeded with 0) and
    rendered on ``device``."""
    if rng is None:
        rng = torch.Generator().manual_seed(0)
    b, k = batch, max_objects
    base = 0.1 * torch.rand((b, size, size, 1), generator=rng)
    n_obj = torch.randint(1, k + 1, (b,), generator=rng)
    cy = (0.15 + 0.7 * torch.rand((b, k), generator=rng)) * size
    cx = (0.15 + 0.7 * torch.rand((b, k), generator=rng)) * size
    hw = 8.0 + 16.0 * torch.rand((b, k, 2), generator=rng)
    return render_detection_batch(
        size, *(t.to(device) for t in (base, n_obj, cy, cx, hw)))
