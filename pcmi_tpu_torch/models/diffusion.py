"""Tiled MultiDiffusion inpainting engine, image-space DDPM / DDIM /
DPM-Solver++ (port of ``pcmi_tpu/models/diffusion.py``).

Tiles of ``cfg.tile`` pixels at ``cfg.stride`` cover the canvas; at every
sampling step all tiles go through the epsilon model as one batch, their
noise predictions are blended with Gaussian weights, and the known region
is re-noised to the next level so it stays locked. The epsilon model is
:class:`CondUNet`, conditioned on the noisy image, the masked image and
the mask (and a Sobel edge map with ``edge_conditioning``), a sinusoidal
timestep embedding, and optionally a class embedding and a
:class:`TextEncoder` over hashed prompt tokens, with classifier-free
guidance at sampling.

The reference's ``lax.scan`` over timesteps is a Python loop here; each
step's scalar coefficients are float32 numpy values on the host, so the
loop never waits for the device. Tensors are NHWC at the boundary, as
the reference's. The engine runs on ``device`` (default ``"cuda"``).
Random draws (initial noise, the locking noise of every step, training
timesteps and noise, the guidance dropout, initial weights) come from
CPU ``torch.Generator``s seeded with the caller's seed and move to the
device; the reference draws them from ``jax.random``, so the two
packages' samples of one seed differ. The private ``_draws`` arguments
take them from outside. "params" in the reference's signatures is a
network here: a :class:`CondUNet` holding the weights
(:meth:`TiledDiffusionEngine.init_params`,
:func:`pcmi_tpu_torch.convert.diffusion_state_dict` for the reference's).
"""

from __future__ import annotations

import copy
import dataclasses
import logging
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pcmi_tpu_torch.models.dip import DIPResult
from pcmi_tpu_torch.models.dip import _as_tensor as _as_float
from pcmi_tpu_torch.models.losses import draws_to
from pcmi_tpu_torch.models.unet import (
    ConvBlock, SameConv2d, _down, _init_params, _up)

MAX_PROMPT_TOKENS = 8
TOKEN_HASH_BUCKETS = 512


def tokenize_prompt(prompt: str | None,
                    max_tokens: int = MAX_PROMPT_TOKENS) -> np.ndarray:
    """Hash-tokenise a free-text prompt into (max_tokens,) int32 ids: FNV-1a
    over each lowercased word into ``TOKEN_HASH_BUCKETS - 1`` buckets, id 0
    the pad (so the empty prompt is the unconditional embedding)."""
    ids = np.zeros((max_tokens,), np.int32)
    if not prompt:
        return ids
    words = str(prompt).lower().split()
    for i, wd in enumerate(words[:max_tokens]):
        acc = 2166136261
        for ch in wd.encode():
            acc = ((acc ^ ch) * 16777619) & 0xFFFFFFFF
        ids[i] = acc % (TOKEN_HASH_BUCKETS - 1) + 1
    return ids


def _linspace32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` in float32 as the reference's
    compiler evaluates it: ``start * (1 - i * r) + i * (stop * r)`` with
    ``r = 1 / (num - 1)`` (a division by a constant becomes a product with
    its reciprocal, and ``stop * (i * r)`` is reassociated), each
    operation rounded to float32, the last element ``stop``."""
    f = np.float32
    if num == 1:
        return np.array([start], np.float32)
    r = f(1) / f(num - 1)
    i = np.arange(num - 1, dtype=np.float32)
    out = f(start) * (f(1) - i * r) + i * (f(stop) * r)
    return np.concatenate([out, [f(stop)]]).astype(np.float32)


class TextEncoder(nn.Module):
    """Hashed word embeddings -> order-aware 1-D convolution (kernel 3,
    "SAME") -> GELU (tanh form, Flax's default) -> masked mean over the
    non-pad tokens -> dense: the (B, dim) conditioning vector of (B, L)
    token ids."""

    def __init__(self, dim: int = 32):
        super().__init__()
        self.embed = nn.Embedding(TOKEN_HASH_BUCKETS, dim)
        self.conv = nn.Conv1d(dim, dim, 3, padding=1)
        self.dense = nn.Linear(dim, dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        emb = self.embed(tokens.long())
        mask = (tokens > 0)[..., None].to(emb.dtype)
        h = self.conv((emb * mask).transpose(1, 2)).transpose(1, 2)
        h = F.gelu(h, approximate="tanh")
        pooled = (h * mask).sum(1) / torch.clamp(mask.sum(1), min=1.0)
        return self.dense(pooled)


class CondUNet(nn.Module):
    """Epsilon model over (B, T, T, C_img) ``x_t`` and the (B, T, T,
    C_cond) conditioning stack (masked image, mask, optionally edges),
    NHWC. A 32-wide sinusoidal timestep embedding (plus the class
    embedding with ``n_classes > 0`` and the :class:`TextEncoder`'s vector
    with ``text_conditioning``) is projected by one dense layer per
    encoder level and the bottleneck and added after its ``ConvBlock``.

    ``in_channels`` (x_t's and the conditioning's together) is what the
    reference infers at ``init``; by default ``2 * out_channels + 1``.
    Weights are drawn from ``generator`` (a CPU one seeded with 0 by
    default) with Flax's initialisers, not the reference's draw."""

    def __init__(self, widths: Sequence[int] = (32, 64, 128),
                 out_channels: int = 3, n_classes: int = 0,
                 text_conditioning: bool = False,
                 in_channels: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = tuple(widths)
        self.widths = widths
        self.out_channels = out_channels
        self.n_classes = n_classes
        self.text_conditioning = text_conditioning
        self.in_channels = in_channels or 2 * out_channels + 1
        self.class_embed = nn.Embedding(n_classes, 32) if n_classes else None
        self.text = TextEncoder(32) if text_conditioning else None
        chans = (self.in_channels,) + widths[:-2]
        self.enc = nn.ModuleList(ConvBlock(w, True, c)
                                 for w, c in zip(widths[:-1], chans))
        self.enc_temb = nn.ModuleList(nn.Linear(32, w) for w in widths[:-1])
        self.mid = ConvBlock(widths[-1], True, widths[-2])
        self.mid_temb = nn.Linear(32, widths[-1])
        dec_w = widths[:-1][::-1]
        self.ups = nn.ModuleList(SameConv2d(c, w, 3) for w, c in
                                 zip(dec_w, (widths[-1],) + dec_w[:-1]))
        self.dec = nn.ModuleList(ConvBlock(w, True, 2 * w) for w in dec_w)
        self.head = SameConv2d(widths[0], out_channels, 1)
        self.register_buffer("freqs", torch.exp(torch.from_numpy(
            _linspace32(0.0, 6.0, 16))), persistent=False)
        _init_params(self, generator)

    def forward(self, x_t: torch.Tensor, t: torch.Tensor, cond: torch.Tensor,
                class_id: Optional[torch.Tensor] = None,
                tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
        dev = x_t.device
        arg = t.float()[:, None] * self.freqs
        temb = torch.cat([torch.sin(arg), torch.cos(arg)], dim=1)  # (B, 32)
        if self.class_embed is not None:
            cid = (torch.zeros(t.shape, dtype=torch.long, device=dev)
                   if class_id is None else class_id.long())
            temb = temb + self.class_embed(cid)
        if self.text is not None:
            tok = (torch.zeros((x_t.shape[0], MAX_PROMPT_TOKENS),
                               dtype=torch.long, device=dev)
                   if tokens is None else tokens)
            temb = temb + self.text(tok)
        h = torch.cat([x_t, cond], dim=-1).permute(0, 3, 1, 2)
        skips = []
        for blk, dense in zip(self.enc, self.enc_temb):
            h = blk(h) + dense(temb)[:, :, None, None]
            skips.append(h)
            h = _down(h)
        h = self.mid(h) + self.mid_temb(temb)[:, :, None, None]
        for up, blk, skip in zip(self.ups, self.dec, reversed(skips)):
            h = blk(torch.cat([_up(h, up), skip], dim=1))
        return self.head(h).permute(0, 2, 3, 1)


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    steps: int = 27
    train_timesteps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    tile: int = 64
    stride: int = 48
    img_channels: int = 3
    # a Sobel edge map of the known region (zero in the hole) joins the
    # conditioning stack
    edge_conditioning: bool = False
    # class vocabulary of the learned class embedding; a prompt maps to the
    # first name it contains (class_for_prompt)
    class_names: tuple = ()
    # free-text conditioning through the TextEncoder over hashed tokens
    text_conditioning: bool = False
    # classifier-free guidance: the training dropout probability of the
    # semantic conditioning, and the default guidance scale (1 = plain)
    cfg_dropout: float = 0.1
    guidance: float = 1.0


class Schedule(NamedTuple):
    alphas_bar: torch.Tensor      # (T,) float32 cumulative products


def _alphas_bar(cfg: DiffusionConfig) -> np.ndarray:
    betas = np.linspace(cfg.beta_start, cfg.beta_end, cfg.train_timesteps)
    return np.cumprod(1.0 - betas).astype(np.float32)


def make_schedule(cfg: DiffusionConfig, device="cuda") -> Schedule:
    """The cumulative products of ``1 - beta`` (float64, then float32) on
    ``device``."""
    return Schedule(alphas_bar=torch.from_numpy(_alphas_bar(cfg)).to(device))


def karras_sigmas(cfg: DiffusionConfig, steps: int, rho: float = 7.0):
    """Karras et al. sigmas between the VP schedule's extremes, spaced by
    ``sigma ** (1 / rho)``, with the nearest trained timestep of each:
    ``(sigmas (steps + 1,) float32 ending in 0, t_indices (steps,)
    int32)``, numpy, computed in float64."""
    betas = np.linspace(cfg.beta_start, cfg.beta_end, cfg.train_timesteps)
    ab = np.cumprod(1.0 - betas).astype(np.float64)
    sig_grid = np.sqrt((1.0 - ab) / ab)
    s_min, s_max = float(sig_grid[0]), float(sig_grid[-1])
    ramp = np.linspace(0.0, 1.0, steps)
    sigmas = (s_max ** (1 / rho)
              + ramp * (s_min ** (1 / rho) - s_max ** (1 / rho))) ** rho
    t_idx = np.abs(sig_grid[None, :] - sigmas[:, None]).argmin(axis=1)
    sigmas = np.concatenate([sigmas, [0.0]])
    return sigmas.astype(np.float32), t_idx.astype(np.int32)


def sobel_edges(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sobel gradient magnitude of the channel mean, zero in the hole:
    ``img`` (..., H, W, C) or (H, W), ``mask`` (..., H, W, 1); returns
    (..., H, W, 1). Circular at the borders, as the reference's rolls."""
    m = img.mean(dim=-1) if img.dim() >= 3 else img
    H, W = -2, -1

    def r(x, s, d):
        return torch.roll(x, s, d)

    gx = (r(m, -1, W) - r(m, 1, W)
          + 0.5 * (r(r(m, -1, W), 1, H) - r(r(m, 1, W), 1, H))
          + 0.5 * (r(r(m, -1, W), -1, H) - r(r(m, 1, W), -1, H)))
    gy = (r(m, -1, H) - r(m, 1, H)
          + 0.5 * (r(r(m, -1, H), 1, W) - r(r(m, 1, H), 1, W))
          + 0.5 * (r(r(m, -1, H), -1, W) - r(r(m, 1, H), -1, W)))
    return torch.hypot(gx, gy)[..., None] * (1.0 - mask)


def _cond_stack(cfg: DiffusionConfig, image: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    parts = [image * (1 - mask), mask]
    if cfg.edge_conditioning:
        parts.append(sobel_edges(image, mask))
    return torch.cat(parts, dim=-1)


def gaussian_weights(tile: int, device="cuda") -> torch.Tensor:
    """(tile, tile, 1) float32 blend weights, sigma ``tile / 4``."""
    x = np.arange(tile) - (tile - 1) / 2
    g = np.exp(-(x ** 2) / (2 * (tile / 4) ** 2))
    return torch.from_numpy(np.outer(g, g).astype(np.float32))[..., None] \
        .to(device)


def tile_origins(size: int, tile: int, stride: int):
    """Tile origins covering ``size``: every ``stride``, then one flush
    with the far edge."""
    if size <= tile:
        return [0]
    out = list(range(0, size - tile, stride))
    out.append(size - tile)
    return out


def _cover(size: int, tile: int, origins):
    """Along one axis: (K, size) indices of the tiles covering each pixel
    in increasing order (-1 past the pixel's last) and the pixel's
    offsets in them; K is the most tiles covering one pixel."""
    lists = [[k for k, o in enumerate(origins) if o <= p < o + tile]
             for p in range(size)]
    K = max(len(c) for c in lists)
    idx = np.full((K, size), -1, np.int64)
    off = np.zeros((K, size), np.int64)
    for p, c in enumerate(lists):
        for j, k in enumerate(c):
            idx[j, p] = k
            off[j, p] = p - origins[k]
    return idx, off


def _pad_edge(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """(H, W, C) padded by ``ph`` rows and ``pw`` columns at the far edges,
    repeating the edge pixels."""
    h, w = x.shape[:2]
    iy = torch.clamp(torch.arange(h + ph, device=x.device), max=h - 1)
    ix = torch.clamp(torch.arange(w + pw, device=x.device), max=w - 1)
    return x[iy][:, ix]


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


class TiledDiffusionEngine:
    """MultiDiffusion inpainting over canvases of any size.

    ``model`` is the network recipe (by default a :class:`CondUNet` of the
    config's channels, classes and text conditioning);
    :meth:`init_params` copies it with fresh weights. The sampling methods
    take the trained network as their first argument (the reference's
    ``params``)."""

    def __init__(self, cfg: DiffusionConfig = DiffusionConfig(),
                 model: Optional[nn.Module] = None, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        c = cfg.img_channels
        self.model = model or CondUNet(
            out_channels=c, n_classes=len(cfg.class_names),
            text_conditioning=cfg.text_conditioning,
            in_channels=2 * c + 1 + (1 if cfg.edge_conditioning else 0))
        self.schedule = make_schedule(cfg, self.device)
        self._ab = _alphas_bar(cfg)   # the same float32 values, on the host
        self._params = None

    def class_for_prompt(self, prompt) -> int:
        """The class of a prompt: an integer as given, else the first
        vocabulary name the prompt contains (case-insensitive), else 0."""
        if isinstance(prompt, (int, np.integer)):
            return int(prompt)
        if prompt:
            low = str(prompt).lower()
            for k, name in enumerate(self.cfg.class_names):
                if name.lower() in low:
                    return k
        return 0

    def tokens_for_prompt(self, prompt) -> Optional[torch.Tensor]:
        if not self.cfg.text_conditioning:
            return None
        return torch.from_numpy(tokenize_prompt(prompt).astype(np.int64)) \
            .to(self.device)

    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> nn.Module:
        """A copy of ``model`` on the device with weights drawn from
        ``generator`` (a CPU one; by default seeded with 0)."""
        net = copy.deepcopy(self.model)
        _init_params(net, generator)
        return net.to(self.device)

    def train_draws(self, b: int, shape, generator: torch.Generator):
        """One training step's draws from ``generator``: timestep indices
        (b,), noise of ``shape`` and the guidance-dropout flags (b,)."""
        t_idx = torch.randint(0, self.cfg.train_timesteps, (b,),
                              generator=generator)
        noise = torch.randn(tuple(shape), generator=generator)
        drop = torch.rand((b,), generator=generator) < self.cfg.cfg_dropout
        return t_idx, noise, drop

    def train_step_loss(self, net: nn.Module, images: torch.Tensor,
                        masks: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        class_ids: Optional[torch.Tensor] = None,
                        tokens: Optional[torch.Tensor] = None,
                        _draws=None) -> torch.Tensor:
        """Denoising score-matching loss of ``net`` on (B, H, W, C)
        ``images`` with (B, H, W, 1) hole ``masks``. With ``cfg_dropout >
        0`` the class ids and tokens given are dropped per sample to the
        unconditional branch (class 0, all-pad tokens), the
        classifier-free-guidance recipe. Draws come from ``generator`` (a
        CPU one seeded with 0 by default) or, as ``(t_idx, noise, drop)``,
        from ``_draws``."""
        cfg = self.cfg
        dev = self.device
        images = _as_float(images, dev)
        masks = _as_float(masks, dev)
        b = images.shape[0]
        if _draws is None:
            _draws = self.train_draws(
                b, images.shape, generator if generator is not None
                else _gen(0))
        t_idx, noise, drop = (draws_to(d, dev) for d in _draws)
        ab = self.schedule.alphas_bar[t_idx.long()][:, None, None, None]
        x_t = torch.sqrt(ab) * images + torch.sqrt(1 - ab) * noise
        cond = _cond_stack(cfg, images, masks)
        class_ids = None if class_ids is None else class_ids.to(dev)
        tokens = None if tokens is None else tokens.to(dev)
        if cfg.cfg_dropout > 0 and (class_ids is not None
                                    or tokens is not None):
            if class_ids is not None:
                class_ids = torch.where(drop, 0, class_ids)
            if tokens is not None:
                tokens = torch.where(drop[:, None], 0, tokens)
        t01 = t_idx.float() / cfg.train_timesteps
        eps = net(x_t, t01, cond, class_ids, tokens)
        return torch.mean((eps - noise) ** 2)

    def _tiler(self, canvas):
        """(slice_tiles, blend_tiles) over the MultiDiffusion tile grid of
        an (H, W) canvas. ``slice_tiles`` cuts an (H, W, C) tensor into
        (n, tile, tile, C) with one gather; ``blend_tiles`` sums the
        Gaussian-weighted tiles back and divides by the summed weights.
        Each pixel's sum is taken in the reference's order: over the tiles
        covering it in their row-major order, starting from 0."""
        cfg = self.cfg
        dev = self.device
        h, w = canvas
        t = cfg.tile
        oy = tile_origins(h, t, cfg.stride)
        ox = tile_origins(w, t, cfg.stride)
        n, nx = len(oy) * len(ox), len(ox)
        wts = gaussian_weights(t, dev)
        ar = torch.arange(t, device=dev)
        rows = (torch.tensor(oy, device=dev)[:, None] + ar) \
            .repeat_interleave(len(ox), 0)                      # (n, t)
        cols = (torch.tensor(ox, device=dev)[:, None] + ar).repeat(len(oy), 1)
        (iy, dy), (ix, dx) = (
            (torch.from_numpy(a).to(dev) for a in _cover(size, t, o))
            for size, o in ((h, oy), (w, ox)))
        # (h, w) index into the tiles (n: an appended zero tile) and
        # offsets inside them, for each covering (ky, kx) in order
        terms = []
        for ky in range(iy.shape[0]):
            for kx in range(ix.shape[0]):
                ok = (iy[ky] >= 0)[:, None] & (ix[kx] >= 0)[None, :]
                tid = torch.where(ok, iy[ky][:, None] * nx + ix[kx][None, :],
                                  n)
                terms.append((tid, dy[ky][:, None], dx[kx][None, :]))

        def accumulate(weighted):
            padded = torch.cat([weighted, weighted.new_zeros(
                (1,) + weighted.shape[1:])])
            acc = None
            for tid, oy_, ox_ in terms:
                part = padded[tid, oy_, ox_]
                acc = part if acc is None else acc + part
            return acc

        norm = accumulate(wts.expand(n, t, t, 1))

        def slice_tiles(full):
            return full[rows[:, :, None], cols[:, None, :]]

        def blend_tiles(tiles):
            return accumulate(tiles * wts) / norm

        return slice_tiles, blend_tiles

    def _eps_fn(self, net, slice_tiles, blend_tiles, cond_full, class_id,
                tokens, neg_tokens, guidance: float):
        """``eps_of(x, t01)``: the blended epsilon over the tile grid. With
        semantic conditioning and ``guidance != 1`` (or a negative prompt)
        the conditional and the unconditional (or negative-prompt) tiles
        run as one stacked batch and ``eps = eps_u + g * (eps_c - eps_u)``.
        ``t01`` is a float (a float32 value)."""
        dev = self.device
        has_sem = class_id is not None or tokens is not None
        use_cfg = (guidance != 1.0 or neg_tokens is not None) and has_sem
        tiles_c = slice_tiles(cond_full)
        n = tiles_c.shape[0]
        cid = (None if class_id is None
               else torch.full((n,), int(class_id), dtype=torch.long,
                               device=dev))
        tok = None if tokens is None else tokens[None].expand(n, -1)
        if use_cfg:
            tiles_c = torch.cat([tiles_c, tiles_c])
            if cid is not None:
                cid = torch.cat([cid, torch.zeros_like(cid)])
            if tok is not None:
                base = (torch.zeros_like(tokens) if neg_tokens is None
                        else neg_tokens)
                tok = torch.cat([tok, base[None].expand(n, -1)])

        def eps_of(x, t01):
            tiles_x = slice_tiles(x)
            if use_cfg:
                tiles_x = torch.cat([tiles_x, tiles_x])
            tvec = torch.full((tiles_x.shape[0],), float(t01),
                              dtype=torch.float32, device=dev)
            with torch.no_grad():
                out = net(tiles_x, tvec, tiles_c, cid, tok)
            if not use_cfg:
                return blend_tiles(out)
            e_c, e_u = out[:n], out[n:]
            return blend_tiles(e_u + guidance * (e_c - e_u))

        return eps_of

    def _noise(self, generator, shape, steps: int, _draws):
        """(initial noise, one locking draw per step) of ``shape``."""
        if _draws is not None:
            x0, per_step = _draws
            return (draws_to(x0, self.device),
                    [draws_to(d, self.device) for d in per_step])
        x0 = draws_to(torch.randn(shape, generator=generator), self.device)
        return x0, (draws_to(torch.randn(shape, generator=generator),
                             self.device) for _ in range(steps))

    def _t01(self, t) -> float:
        return float(np.float32(t) / np.float32(self.cfg.train_timesteps))

    def _setup(self, net, image, mask, canvas, class_id, tokens, neg_tokens,
               guidance):
        slice_tiles, blend_tiles = self._tiler(canvas)
        cond_full = _cond_stack(self.cfg, image, mask)
        return self._eps_fn(net, slice_tiles, blend_tiles, cond_full,
                            class_id, tokens, neg_tokens, guidance)

    def _sample(self, net, image, mask, generator, canvas, class_id=None,
                tokens=None, neg_tokens=None, guidance: float = 1.0,
                _draws=None) -> torch.Tensor:
        """DDIM over ``cfg.steps`` timesteps with the tiled epsilon and
        the known region re-noised to each next level. ``_draws``: (initial
        noise, [one draw per step]) of the padded canvas's shape."""
        cfg = self.cfg
        f = np.float32
        h, w = canvas
        eps_of = self._setup(net, image, mask, canvas, class_id, tokens,
                             neg_tokens, guidance)
        t_steps = _linspace32(cfg.train_timesteps - 1, 0,
                              cfg.steps).astype(np.int32)
        x, noises = self._noise(generator, (h, w, cfg.img_channels),
                                cfg.steps, _draws)
        hole = mask > 0.5
        nexts = list(t_steps[1:]) + [-1]
        for t_cur, t_next, noise in zip(t_steps, nexts, noises):
            ab_t = self._ab[t_cur]
            ab_n = self._ab[t_next] if t_next >= 0 else f(1.0)
            eps = eps_of(x, self._t01(t_cur))
            x0 = (x - float(np.sqrt(f(1) - ab_t)) * eps) / float(np.sqrt(ab_t))
            x0 = torch.clamp(x0, -2.0, 2.0)
            a, b = float(np.sqrt(ab_n)), float(np.sqrt(f(1) - ab_n))
            known_t = a * image + b * noise
            x = torch.where(hole, a * x0 + b * eps, known_t)
        return torch.where(hole, x, image)

    def _sample_dpmpp(self, net, image, mask, generator, canvas,
                      class_id=None, tokens=None, neg_tokens=None,
                      guidance: float = 1.0, _draws=None) -> torch.Tensor:
        """DPM-Solver++(2M) over Karras sigmas in the sigma-space variable
        ``x0 + sigma * eps``, the VP epsilon model queried at the nearest
        trained timestep with the matching VP scaling, the known region
        re-noised to each next sigma."""
        cfg = self.cfg
        f = np.float32
        h, w = canvas
        eps_of = self._setup(net, image, mask, canvas, class_id, tokens,
                             neg_tokens, guidance)
        sigmas, t_idx = karras_sigmas(cfg, cfg.steps)
        x, noises = self._noise(generator, (h, w, cfg.img_channels),
                                cfg.steps, _draws)
        x = x * float(sigmas[0])
        hole = mask > 0.5
        old_denoised = torch.zeros_like(x)
        for i, noise in zip(range(cfg.steps), noises):
            sig, sig_next = sigmas[i], sigmas[i + 1]
            ti = t_idx[i]
            x_vp = x * float(np.sqrt(self._ab[ti]))
            denoised = x - float(sig) * eps_of(x_vp, self._t01(ti))
            t_cur = -np.log(np.maximum(sig, f(1e-8)))
            t_next = -np.log(np.maximum(sig_next, f(1e-8)))
            h_step = t_next - t_cur
            if sig_next > 0:
                if i > 0:
                    prev_sig = sigmas[i - 1]
                    h_last = t_cur + np.log(np.maximum(prev_sig, f(1e-8)))
                    r = h_last / (f(1e-8) if h_step == 0 else h_step)
                    q = f(1) / (f(2) * np.maximum(r, f(1e-6)))
                    d = float(f(1) + q) * denoised - float(q) * old_denoised
                else:
                    d = denoised
                x_new = (float(sig_next / np.maximum(sig, f(1e-8))) * x
                         - float(np.expm1(-h_step)) * d)
            else:
                x_new = denoised
            known = image + float(sig_next) * noise
            x = torch.where(hole, x_new, known)
            old_denoised = denoised
        return torch.where(hole, x, image)

    def inpaint(self, params, image, mask, seed: int = 0,
                method: str = "dpmpp", prompt=None, negative_prompt=None,
                guidance: float | None = None) -> torch.Tensor:
        """Fill ``mask``'s hole (H, W, 1), 1 = hole) of ``image`` (H, W, C)
        in about [-1, 1] with the network ``params``: ``method`` "dpmpp"
        (DPM-Solver++ 2M, Karras sigmas) or "ddim". Canvases smaller than
        a tile are padded with their edge pixels (the mask with zeros) and
        cropped back. ``prompt`` conditions the fill (free text with
        ``text_conditioning``, else the class vocabulary),
        ``negative_prompt`` replaces the unconditional branch, and
        ``guidance`` (default ``cfg.guidance``) scales the conditioning.
        Returns an (H, W, C) tensor on the device."""
        cfg = self.cfg
        dev = self.device
        image = _as_float(image, dev)
        mask = _as_float(mask, dev)
        h, w = image.shape[:2]
        ph, pw = max(cfg.tile - h, 0), max(cfg.tile - w, 0)
        img, msk = image, mask
        if ph or pw:
            img = _pad_edge(img, ph, pw)
            msk = F.pad(msk, (0, 0, 0, pw, 0, ph))
        fn = self._sample_dpmpp if method == "dpmpp" else self._sample
        cid = self.class_for_prompt(prompt) if cfg.class_names else None
        tok = self.tokens_for_prompt(prompt)
        ntok = (self.tokens_for_prompt(negative_prompt)
                if negative_prompt and cfg.text_conditioning else None)
        g = float(cfg.guidance if guidance is None else guidance)
        out = fn(params, img, msk, _gen(seed), canvas=tuple(img.shape[:2]),
                 class_id=cid, tokens=tok, neg_tokens=ntok, guidance=g)
        return out[:h, :w]

    # the duck-typed engine surface (restore / stitch / enhance) of
    # DIPEngine, so the generative processors take either engine

    def _ensure_params(self) -> nn.Module:
        if self._params is None:
            logging.getLogger("pcmi_tpu_torch").warning(
                "TiledDiffusionEngine running with freshly-initialised "
                "weights: train or load a network for real quality")
            self._params = self.init_params(_gen(0))
        return self._params

    def load_params(self, params: nn.Module) -> None:
        """Use the network ``params`` (a trained :class:`CondUNet`)."""
        self._params = params.to(self.device)

    def _channels(self, image):
        img = _as_float(image, self.device)
        squeeze = img.dim() == 2
        if squeeze:
            img = img[..., None]
        if img.shape[-1] != self.cfg.img_channels:
            img = img[..., :1].repeat(1, 1, self.cfg.img_channels)
        return img, squeeze

    def _duck(self, image, mask, seed=0, prompt=None, **_ignored):
        params = self._ensure_params()
        img, squeeze = self._channels(image)
        m = _as_float(mask, self.device)
        m = m[..., None] if m.dim() == 2 else m[..., :1]
        out = self.inpaint(params, img * 2.0 - 1.0, m, seed=seed,
                           prompt=prompt)
        out = torch.clamp((out + 1.0) * 0.5, 0.0, 1.0)
        if squeeze or out.shape[-1] != image.shape[-1]:
            out = out[..., 0]
        return DIPResult(output=out, losses=torch.zeros(0, device=self.device))

    restore = _duck
    stitch = _duck

    def enhance(self, image, mask=None, seed: int = 0, strength: float = 0.3):
        """img2img: noise the whole frame to ``strength`` of the schedule
        and denoise it conditioned on itself (mask 0: all known)."""
        params = self._ensure_params()
        img, squeeze = self._channels(image)
        x = img * 2.0 - 1.0
        out = self._img2img(params, x, _gen(seed), canvas=tuple(x.shape[:2]),
                            strength=strength)
        out = torch.clamp((out + 1.0) * 0.5, 0.0, 1.0)
        if squeeze:
            out = out[..., 0]
        return DIPResult(output=out, losses=torch.zeros(0, device=self.device))

    def _img2img(self, net, image, generator, canvas, strength=0.3,
                 _draws=None) -> torch.Tensor:
        """DDIM from timestep ``int(T * strength) - 1`` over
        ``max(2, int(steps * strength))`` steps, unconditioned; ``_draws``
        the initial noise of the padded canvas."""
        cfg = self.cfg
        f = np.float32
        h, w = canvas
        ph, pw = max(cfg.tile - h, 0), max(cfg.tile - w, 0)
        if ph or pw:
            image = _pad_edge(image, ph, pw)
        hh, ww = image.shape[:2]
        slice_tiles, blend_tiles = self._tiler((hh, ww))
        zero_mask = torch.zeros((hh, ww, 1), device=self.device)
        eps_of = self._eps_fn(net, slice_tiles, blend_tiles,
                              _cond_stack(cfg, image, zero_mask), None, None,
                              None, 1.0)
        t0 = int(cfg.train_timesteps * strength)
        n_steps = max(2, int(cfg.steps * strength))
        t_steps = _linspace32(t0 - 1, 0, n_steps).astype(np.int32)
        noise = draws_to(torch.randn(tuple(image.shape), generator=generator)
                         if _draws is None else _draws, self.device)
        ab0 = self._ab[t0 - 1]
        x = (float(np.sqrt(ab0)) * image
             + float(np.sqrt(f(1) - ab0)) * noise)
        nexts = list(t_steps[1:]) + [-1]
        for t_cur, t_next in zip(t_steps, nexts):
            ab_t = self._ab[t_cur]
            ab_n = self._ab[t_next] if t_next >= 0 else f(1.0)
            eps = eps_of(x, self._t01(t_cur))
            x0 = torch.clamp(
                (x - float(np.sqrt(f(1) - ab_t)) * eps) / float(np.sqrt(ab_t)),
                -2.0, 2.0)
            x = float(np.sqrt(ab_n)) * x0 + float(np.sqrt(f(1) - ab_n)) * eps
        return x[:h, :w]
