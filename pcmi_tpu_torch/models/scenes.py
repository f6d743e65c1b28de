"""Synthetic RGB training scenes for the generative models (the port's
counterpart of ``make_scene_rgb`` and its pool, and of
``make_styled_scene`` and ``STYLE_CAPTIONS``, in the reference's
``bench_generative.py``).

A scene has learnable structure: Voronoi field parcels, dark roads,
bright buildings with offset shadows and mild noise. Purely random
texture would be unrecoverable, and on it bicubic upsampling or a smooth
fill would be near optimal. Scenes are numpy draws from
``numpy.random.default_rng(seed)``: the reference draws the same scene
from the seed its ``jax.random`` key gives. Training batches sample a
pool on the device with random flips and transposes from a
``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def make_scene_rgb(seed: int, size: int = 96) -> np.ndarray:
    """(size, size, 3) float32 scene in [0, 1] of ``seed``."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)

    # field parcels: nearest-seed (Voronoi) labels -> parcel reflectance
    k = 12
    seeds = rng.uniform(0, size, (k, 2)).astype(np.float32)
    d2 = (ys[..., None] - seeds[:, 0]) ** 2 + (xs[..., None] - seeds[:, 1]) ** 2
    lab = np.argmin(d2, axis=-1)
    refl = rng.uniform(0.2, 0.8, k).astype(np.float32)
    g = refl[lab]

    # roads: 2-3 straight dark lines
    for _ in range(rng.integers(2, 4)):
        p = rng.uniform(0, size, 2)
        th = rng.uniform(0, np.pi)
        n_ = np.array([np.sin(th), -np.cos(th)])
        dist = np.abs((ys - p[0]) * n_[0] + (xs - p[1]) * n_[1])
        g = np.where(dist < 1.5, 0.12, g)

    # buildings: bright rectangles with a dark offset shadow
    for _ in range(rng.integers(3, 7)):
        cy, cx = rng.uniform(8, size - 8, 2)
        hh, ww = rng.uniform(3, 9, 2)
        b = (np.abs(ys - cy) < hh) & (np.abs(xs - cx) < ww)
        s = (np.abs(ys - cy - hh) < 2) & (np.abs(xs - cx - ww / 2) < ww)
        g = np.where(s, 0.08, g)
        g = np.where(b, 0.85, g)

    g = g + rng.normal(0, 0.02, g.shape).astype(np.float32)
    rgb = np.stack([0.92 * g + 0.04, g, 0.85 * g + 0.06], axis=-1)
    return np.clip(rgb, 0.0, 1.0).astype(np.float32)


def scene_batch(seeds: Sequence[int], size: int, device="cuda") -> torch.Tensor:
    """(len(seeds), size, size, 3) scenes on ``device``."""
    return torch.from_numpy(np.stack([make_scene_rgb(int(s), size)
                                      for s in seeds])).to(device)


def make_pool(seed: int, n_scenes: int, size: int, device="cuda"
              ) -> torch.Tensor:
    """A pool of ``n_scenes`` scenes whose seeds are drawn from
    ``numpy.random.default_rng(seed)``; training samples batches from it
    on the device (scene synthesis is host work)."""
    seeds = np.random.default_rng(seed).integers(0, 2**31 - 1, n_scenes)
    return scene_batch(seeds, size, device)


def sample_batch(pool: torch.Tensor, batch: int,
                 rng: Optional[torch.Generator]) -> torch.Tensor:
    """``batch`` scenes of ``pool``, each flipped left-right and then
    transposed with probability 1/2, drawn from ``rng`` (a CPU
    generator)."""
    idx = torch.randint(0, pool.shape[0], (batch,), generator=rng)
    flip = torch.rand((batch,), generator=rng) < 0.5
    rot = torch.rand((batch,), generator=rng) < 0.5
    dev = pool.device
    out = pool[idx.to(dev)]
    out = torch.where(flip.to(dev)[:, None, None, None], out.flip(2), out)
    return torch.where(rot.to(dev)[:, None, None, None],
                       out.transpose(1, 2), out)


def make_styled_scene(seed: int, style: str, size: int = 64) -> np.ndarray:
    """(size, size, 3) float32 scene in [0, 1] of one of two styles for
    prompt steering: ``fields`` (dark Voronoi parcels, thin roads, no
    buildings) or ``urban`` (bright dense blocks with shadows). The
    reference derives ``seed`` from its key with ``jax.random.randint``."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    k = 10
    seeds = rng.uniform(0, size, (k, 2)).astype(np.float32)
    d2 = (ys[..., None] - seeds[:, 0]) ** 2 + (xs[..., None] - seeds[:, 1]) ** 2
    lab = np.argmin(d2, axis=-1)
    if style == "fields":
        refl = rng.uniform(0.15, 0.45, k).astype(np.float32)
        g = refl[lab]
        for _ in range(rng.integers(1, 3)):
            p = rng.uniform(0, size, 2)
            th = rng.uniform(0, np.pi)
            n_ = np.array([np.sin(th), -np.cos(th)])
            dist = np.abs((ys - p[0]) * n_[0] + (xs - p[1]) * n_[1])
            g = np.where(dist < 1.2, 0.1, g)
    elif style == "urban":
        refl = rng.uniform(0.35, 0.55, k).astype(np.float32)
        g = refl[lab]
        for _ in range(rng.integers(10, 16)):
            cy, cx = rng.uniform(4, size - 4, 2)
            hh, ww = rng.uniform(2, 6, 2)
            b = (np.abs(ys - cy) < hh) & (np.abs(xs - cx) < ww)
            s = (np.abs(ys - cy - hh) < 1.5) & (np.abs(xs - cx - ww / 2) < ww)
            g = np.where(s, 0.08, g)
            g = np.where(b, 0.9, g)
    else:
        raise ValueError(style)
    g = g + rng.normal(0, 0.02, g.shape).astype(np.float32)
    rgb = np.stack([0.92 * g + 0.04, g, 0.85 * g + 0.06], axis=-1)
    return np.clip(rgb, 0.0, 1.0).astype(np.float32)


STYLE_CAPTIONS = {
    "fields": ("dark farm fields", "flat rural fields", "quiet dark farmland",
               "rural parcels with road", "dark flat fields"),
    "urban": ("bright urban blocks", "dense city buildings",
              "bright dense urban", "urban buildings with shadows",
              "dense bright blocks"),
}
