"""Training losses of the inpainting and super-resolution GANs (port of
``pcmi_tpu/models/losses.py``).

* :func:`residual_inpaint_loss` — masked L1 + image-gradient L1 + a
  boundary-ring term that weights the annulus just outside the hole.
* :func:`hinge_d_loss`, :func:`hinge_g_loss` — hinge GAN losses.
* :func:`mixge_loss` — MSE + 0.1 · gradient difference (SR training).
* :func:`random_hole_masks` — random connected hole masks grown by
  max-pool frontier steps (the inpainting trainer's fault injection).

Images are NHWC float32 tensors, as the reference's. The hole masks draw
from a ``torch.Generator`` on the host (not the reference's
``jax.random`` stream) and move to the device;
:func:`grow_hole_masks` takes given seeds and keep draws instead.
"""

from __future__ import annotations

import contextvars
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

# The process group of the data-parallel step running in this context
# (``training.data_parallel_step``), else None: its ranks hold equal
# shards of one batch.
DATA_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "data_parallel_group", default=None)


def draws_to(t: torch.Tensor, device) -> torch.Tensor:
    """A host draw on ``device``: to a card through pinned memory without
    waiting for the card (a pageable copy would wait for its queue)."""
    device = torch.device(device)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def batch_normaliser(count: torch.Tensor) -> torch.Tensor:
    """The divisor of a loss summed over the batch: ``count``, the local
    batch's count, clamped at 1 as the reference clamps it. In a
    data-parallel step it is the whole batch's count (the group's sum),
    clamped, divided by the group's size: the ranks' losses then average
    to exactly the whole batch's loss, also where the whole batch counts
    fewer than one per rank, or none."""
    group = DATA_GROUP.get()
    if group is None:
        return torch.clamp(count, min=1.0)
    total = count.detach().clone()
    dist.all_reduce(total, group=group)
    return torch.clamp(total, min=1.0) / dist.get_world_size(group)


def _grad_xy(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    dy = x[:, 1:, :, :] - x[:, :-1, :, :]
    dx = x[:, :, 1:, :] - x[:, :, :-1, :]
    return dy, dx


def masked_l1(pred, target, mask):
    """Mean |pred - target| over mask pixels (mask broadcast over
    channels), over the whole batch's pixels in a data-parallel step
    (:func:`batch_normaliser`)."""
    num = ((pred - target).abs() * mask).sum()
    return num / batch_normaliser(mask.sum() * pred.shape[-1]
                                  / mask.shape[-1])


def gradient_l1(pred, target):
    py, px = _grad_xy(pred)
    ty, tx = _grad_xy(target)
    return (py - ty).abs().mean() + (px - tx).abs().mean()


def _window_max(m: torch.Tensor, size: int) -> torch.Tensor:
    """Max over an odd ``size x size`` window of (B, H, W), "SAME"
    placement with -inf outside (``lax.reduce_window``'s; the pooling's
    own padding is -inf)."""
    assert size % 2 == 1, size
    return F.max_pool2d(m[:, None], size, stride=1, padding=size // 2)[:, 0]


def boundary_ring_mask(mask: torch.Tensor, width: int = 4) -> torch.Tensor:
    """Annulus of ``width`` px just outside the hole, (B, H, W, 1)
    float32."""
    m = mask[..., 0] if mask.dim() == 4 else mask
    if m.dim() != 3:
        raise ValueError("mask must be (B, H, W) or (B, H, W, 1)")
    grown = _window_max(m.float(), 2 * width + 1)
    ring = (grown > 0.5) & (m < 0.5)
    return ring[..., None].float()


def residual_inpaint_loss(pred, target, mask, w_grad=0.5, w_ring=0.5,
                          ring_width=4):
    """Masked L1 + gradient + boundary-ring loss; returns ``(total,
    parts)``."""
    hole = masked_l1(pred, target, mask)
    grad = gradient_l1(pred, target)
    ring = masked_l1(pred, target, boundary_ring_mask(mask, ring_width))
    return hole + w_grad * grad + w_ring * ring, {
        "hole_l1": hole, "grad": grad, "ring": ring,
    }


def hinge_d_loss(real_logits, fake_logits):
    return (F.relu(1.0 - real_logits).mean()
            + F.relu(1.0 + fake_logits).mean())


def hinge_g_loss(fake_logits):
    return -fake_logits.mean()


def mixge_loss(pred, target, w_grad: float = 0.1):
    """MSE + ``w_grad`` · gradient difference (SR reconstruction loss)."""
    mse = ((pred - target) ** 2).mean()
    py, px = _grad_xy(pred)
    ty, tx = _grad_xy(target)
    ge = ((py - ty) ** 2).mean() + ((px - tx) ** 2).mean()
    return mse + w_grad * ge


def grow_hole_masks(shape: Tuple[int, int, int], seeds_y: torch.Tensor,
                    seeds_x: torch.Tensor,
                    keeps: Sequence[torch.Tensor]) -> torch.Tensor:
    """Connected blob masks from given draws: the (B, n_seeds) seed
    pixels set, then per growth step a 3x3 dilation whose new pixels stay
    where that step's (B, H, W) ``keeps`` is True. Returns (B, H, W, 1)
    float32, 1 = hole, on the seeds' device."""
    b, h, w = shape
    dev = seeds_y.device
    mask = torch.zeros((b, h * w), dtype=torch.float32, device=dev)
    mask.scatter_(1, (seeds_y * w + seeds_x).long(), 1.0)
    mask = mask.view(b, h, w)
    for keep in keeps:
        mask = torch.maximum(mask, _window_max(mask, 3) * keep.to(dev))
    return mask[..., None]


def random_hole_masks(rng: Optional[torch.Generator],
                      shape: Tuple[int, int, int], n_seeds: int = 6,
                      steps: int = 10, p_grow: float = 0.7,
                      device="cuda") -> torch.Tensor:
    """Connected random blob masks by max-pool frontier growth: seed a
    few pixels per image (rows and columns uniform in [size / 8,
    7 size / 8)), then ``steps`` times dilate and keep each grown pixel
    with probability ``p_grow``. The draws come from ``rng`` (a CPU
    generator; by default one seeded with 0) and move to ``device``.
    Returns (B, H, W, 1) float32, 1 = hole."""
    if rng is None:
        rng = torch.Generator().manual_seed(0)
    return grow_hole_masks(shape, *(
        draws_to(t, device)
        for t in hole_mask_draws(rng, shape, n_seeds, steps, p_grow)))


def hole_mask_draws(rng: torch.Generator, shape: Tuple[int, int, int],
                    n_seeds: int = 6, steps: int = 10, p_grow: float = 0.7):
    """:func:`random_hole_masks`' draws from ``rng`` on the host, in its
    order: (B, n_seeds) seed rows and columns, (steps, B, H, W) keeps."""
    b, h, w = shape
    seeds_y = torch.randint(h // 8, 7 * h // 8, (b, n_seeds), generator=rng)
    seeds_x = torch.randint(w // 8, 7 * w // 8, (b, n_seeds), generator=rng)
    keeps = torch.rand((steps, b, h, w), generator=rng) < p_grow
    return seeds_y, seeds_x, keeps
