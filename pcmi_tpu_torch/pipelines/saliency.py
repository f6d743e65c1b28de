"""Spectral-residual saliency detection (Hou & Zhang), tiled and batched
(port of ``pcmi_tpu/pipelines/saliency.py``).

The image is cut into padded tiles, each tile is downscaled, FFT'd, the
log-amplitude spectrum is compared to its local average (the "spectral
residual"), and the inverse transform's squared magnitude becomes the
saliency map; tiles are reassembled without their padding, then
thresholded into detection boxes.

All tiles go through one batched ``torch.fft.fft2`` / ``ifft2`` in
complex64. Connected components are the reference's iterated 3x3 max
propagation over integer labels; the host reads back only the box list.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from pcmi_tpu_torch.interface import Layer, SatellitePlugin
from pcmi_tpu_torch.ops.filters import box_filter, gaussian_filter
from pcmi_tpu_torch.ops.morphology import binary_closing
from pcmi_tpu_torch.ops.warp import map_coordinates


def _linspace(stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(0.0, stop, num)`` as the reference's compiler
    evaluates it in float32: ``stop * (i / (num - 1))`` folded into
    ``i * c`` with ``c = float32(float32(1 / (num - 1)) * stop)``, the last
    point exactly ``stop``."""
    if num == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    div = num - 1
    c = np.float32(np.float32(1.0) / np.float32(div)) * np.float32(stop)
    i = torch.arange(div, dtype=torch.float32, device=device)
    end = torch.full((1,), stop, dtype=torch.float32, device=device)
    return torch.cat([i * np.float32(c), end])


def _resize(img: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an (..., h, w) stack onto an evenly spaced grid
    that keeps both corners."""
    h, w = img.shape[-2:]
    ys = _linspace(h - 1.0, shape[0], img.device)
    xs = _linspace(w - 1.0, shape[1], img.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return map_coordinates(img, gy, gx)


def _planes_last(fn, stack: torch.Tensor, *args) -> torch.Tensor:
    """Apply an (H, W, C) filter to an (N, H, W) stack, plane by plane."""
    return fn(stack.permute(1, 2, 0), *args).permute(2, 0, 1)


def spectral_residual_tile(tile: torch.Tensor,
                           work: Tuple[int, int] = (72, 72)) -> torch.Tensor:
    """Saliency of a tile, or of an (N, T, T) stack of tiles: downscale ->
    log-spectrum residual -> |IFFT|^2 -> Gaussian smooth -> per-tile [0, 1]
    normalise."""
    one = tile.dim() == 2
    tiles = tile[None] if one else tile
    small = _resize(tiles.float(), work)
    F = torch.fft.fft2(small)
    amp = F.abs()
    amp_safe = torch.clamp(amp, min=1e-9)
    log_amp = torch.log(amp_safe)
    avg = _planes_last(box_filter, log_amp, 1)  # 3x3 box
    residual = log_amp - avg
    F2 = torch.exp(residual) * (F / amp_safe)
    sal = torch.fft.ifft2(F2).abs() ** 2
    sal = _planes_last(gaussian_filter, sal, 2.5, 4)
    sal = sal - sal.amin(dim=(-2, -1), keepdim=True)
    sal = sal / torch.clamp(sal.amax(dim=(-2, -1), keepdim=True), min=1e-9)
    out = _resize(sal, tiles.shape[-2:])
    return out[0] if one else out


def _reflect_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Source indices of numpy's ``mode="reflect"`` padding of an axis of
    ``n`` by ``lo`` before and ``hi`` after (pads longer than the axis
    reflect again)."""
    i = torch.arange(-lo, n + hi, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - j, j)


def spectral_residual_map(
    img: torch.Tensor,
    tile: int = 512,
    pad: int = 64,
    work: Tuple[int, int] = (72, 72),
) -> torch.Tensor:
    """Full-image saliency via overlapping tiles: every padded tile of the
    reflect-padded image goes through :func:`spectral_residual_tile` as
    one batch, and the tiles' cores are put back."""
    h, w = img.shape
    ny = -(-h // tile)
    nx = -(-w // tile)
    ri = _reflect_index(h, pad, ny * tile - h + pad, img.device)
    ci = _reflect_index(w, pad, nx * tile - w + pad, img.device)
    padded = img.float()[ri][:, ci]
    size = tile + 2 * pad
    batch = padded.unfold(0, size, tile).unfold(1, size, tile)
    sal = spectral_residual_tile(batch.reshape(ny * nx, size, size), work)
    core = sal[:, pad:pad + tile, pad:pad + tile].reshape(ny, nx, tile, tile)
    return core.permute(0, 2, 1, 3).reshape(ny * tile, nx * tile)[:h, :w]


def _max3x3(lab: torch.Tensor) -> torch.Tensor:
    """3x3 max over integer labels of an (..., H, W) stack, outside = -1."""
    h, w = lab.shape[-2:]
    p = torch.nn.functional.pad(lab, (1, 1, 1, 1), value=-1)
    out = p[..., 0:h, 0:w]
    for dy in range(3):
        for dx in range(3):
            if dy or dx:
                out = torch.maximum(out, p[..., dy:dy + h, dx:dx + w])
    return out


# Steps between the reads of whether a propagation step changed anything.
_CHECK_EVERY = 8


def label_components(mask: torch.Tensor, max_iters: int = 128) -> torch.Tensor:
    """Connected-component labels by iterated 3x3 max propagation, of an
    (H, W) mask or of an (N, H, W) stack (each plane on its own).

    Each foreground pixel starts with its flat index within its plane;
    the neighbourhood max (over int32 labels, background -1) is propagated
    until a fixpoint, or for ``max_iters`` steps. A fixpoint does not
    change under further steps, so whether a step changed anything is read
    back only every ``_CHECK_EVERY`` steps (and never past ``max_iters``
    steps in all): the labels are those of testing after every step.
    """
    h, w = mask.shape[-2:]
    mask = mask.bool()
    idx = torch.arange(h * w, dtype=torch.int32,
                       device=mask.device).reshape(h, w)
    neg = torch.full((), -1, dtype=torch.int32, device=mask.device)
    lab = torch.where(mask, idx, neg)
    for i in range(max_iters):
        new = torch.where(mask, _max3x3(lab), neg)
        if (i + 1) % _CHECK_EVERY == 0 or i + 1 == max_iters:
            if torch.equal(new, lab):
                return new
        lab = new
    return lab


def extract_boxes(labels, min_size: int = 20) -> List[Tuple[int, int, int, int]]:
    """Host-side ``(y0, x0, y1, x1)`` boxes of a label map, one per label in
    ascending order, those whose box area is below ``min_size`` dropped."""
    if isinstance(labels, torch.Tensor):
        labels = labels.cpu().numpy()
    labels = np.asarray(labels)
    ys, xs = np.nonzero(labels >= 0)
    if not len(ys):
        return []
    ids, inv = np.unique(labels[ys, xs], return_inverse=True)
    n = len(ids)
    y0 = np.full(n, np.iinfo(np.int64).max)
    x0 = np.full(n, np.iinfo(np.int64).max)
    y1 = np.full(n, -1)
    x1 = np.full(n, -1)
    np.minimum.at(y0, inv, ys)
    np.minimum.at(x0, inv, xs)
    np.maximum.at(y1, inv, ys)
    np.maximum.at(x1, inv, xs)
    keep = (y1 - y0 + 1) * (x1 - x0 + 1) >= min_size
    return [(int(a), int(b), int(c) + 1, int(d) + 1)
            for a, b, c, d in zip(y0[keep], x0[keep], y1[keep], x1[keep])]


class SaliencyDetector(SatellitePlugin):
    """Returns the input, an inferno saliency layer, and red rectangle
    shapes; runs on ``device`` (default ``"cuda"``)."""

    def __init__(self, tile: int = 512, pad: int = 64, min_box: int = 20,
                 device="cuda"):
        self.tile = tile
        self.pad = pad
        self.min_box = min_box
        self.device = torch.device(device)

    @property
    def name(self) -> str:
        return "Saliency Detection"

    def run(self, image: np.ndarray, viewer=None) -> List[Layer]:
        img = np.asarray(image, np.float32)
        if img.ndim == 3:
            img = img.mean(axis=-1)
        scale = img.max() if img.max() > 0 else 1.0
        sal = spectral_residual_map(
            torch.from_numpy(img / scale).to(self.device),
            tile=self.tile, pad=self.pad)
        # threshold at min(3 * mean, max), the mean taken on the host
        sal_np = sal.cpu().numpy()
        thresh = min(3.0 * float(sal_np.mean()), float(sal_np.max()))
        mask = binary_closing(sal >= thresh, size=5)
        boxes = extract_boxes(label_components(mask), self.min_box)
        rects = [
            np.array([[y0, x0], [y0, x1], [y1, x1], [y1, x0]], np.float32)
            for (y0, x0, y1, x1) in boxes
        ]
        layers: List[Layer] = [
            (image, {"name": "input"}, "image"),
            (sal_np, {"name": "saliency", "colormap": "inferno"}, "image"),
        ]
        if rects:
            layers.append((
                np.stack(rects),
                {"name": "detections", "edge_color": "red",
                 "face_color": "transparent", "shape_type": "rectangle"},
                "shapes",
            ))
        return layers
