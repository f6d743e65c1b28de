"""Numeric quality gates of the port's learned components, the port's
versions of ``tests/test_quality_gates.py``'s two training gates, at
their sizes (48 px scenes, batch 8, 120 steps) with the port's draws:

* SR: the trained ``SRUNet`` beats bicubic PSNR on held-out scenes;
* inpainting: the trained ``InpaintUNet`` beats the Jacobi prefill's
  in-hole PSNR on held-out scenes.

Scenes come from ``pcmi_tpu_torch.models.scenes`` (the reference's scene
recipe, numpy draws from a seed); batches, hole masks and weights from
CPU ``torch.Generator``s. As in the reference, these budgets guard the
training plumbing; ``chip_smoke.py`` phase 13 runs the full budgets on
the card.
"""

import numpy as np
import torch

from pcmi_tpu_torch.models.losses import random_hole_masks
from pcmi_tpu_torch.models.metrics import psnr
from pcmi_tpu_torch.models.scenes import make_pool, sample_batch, scene_batch
from pcmi_tpu_torch.models.training import (
    InpaintGANTrainer,
    InpaintTrainConfig,
    SRGANTrainer,
    SRTrainConfig,
    make_sr_pairs,
)
from pcmi_tpu_torch.models.unet import (
    InpaintUNet,
    PatchDiscriminator,
    SRUNet,
    bicubic_upsample,
)
from pcmi_tpu_torch.pipelines.generative import diffusion_prefill

torch.set_num_threads(1)


def _held_out(seed, n, size):
    seeds = np.random.default_rng(seed).integers(0, 2**31 - 1, n)
    return scene_batch(seeds, size, device="cpu")


def test_sr_beats_bicubic_held_out():
    size, batch = 48, 8
    trainer = SRGANTrainer(
        SRTrainConfig(warmup_steps=10**6, compute_dtype="float32"),
        generator=SRUNet(widths=(16, 32, 64)),
        discriminator=PatchDiscriminator(widths=(16, 32, 64, 64)),
        device="cpu")
    pool = make_pool(0, 24, size, device="cpu")
    state = trainer.init(None, torch.Generator().manual_seed(1))
    rng = torch.Generator().manual_seed(0)
    for _ in range(120):
        lr_b, hr_b = make_sr_pairs(sample_batch(pool, batch, rng))
        state, _ = trainer.train_step(state, lr_b, hr_b)
    lr_t, hr_t = make_sr_pairs(_held_out(50_000, batch, size))
    p_sr = float(psnr(trainer.infer(state, lr_t), hr_t))
    p_bi = float(psnr(bicubic_upsample(lr_t, 4), hr_t))
    assert p_sr > p_bi, f"SR {p_sr:.2f} dB vs bicubic {p_bi:.2f} dB"


def test_inpaint_beats_prefill_held_out():
    size, batch = 48, 8
    trainer = InpaintGANTrainer(
        InpaintTrainConfig(compute_dtype="float32", w_gan=0.0,
                           mask_seeds=4, mask_steps=8),
        generator=InpaintUNet(widths=(24, 48, 96, 96)),
        discriminator=PatchDiscriminator(widths=(16, 32, 64, 64)),
        device="cpu")
    pool = make_pool(0, 24, size, device="cpu")
    state = trainer.init(None, torch.Generator().manual_seed(3))
    rng = torch.Generator().manual_seed(2)
    for _ in range(120):
        state, _ = trainer.train_step(state, sample_batch(pool, batch, rng),
                                      rng)
    imgs_t = _held_out(60_000, batch, size)
    mask = random_hole_masks(torch.Generator().manual_seed(61_000),
                             (batch, size, size), 4, 8, device="cpu")
    out = trainer.infer(state, imgs_t, mask)
    pre = torch.stack([diffusion_prefill(imgs_t[i], mask[i, ..., 0] > 0.5)
                       for i in range(batch)])
    p_model = float(psnr(out, imgs_t, mask=mask))
    p_pre = float(psnr(pre, imgs_t, mask=mask))
    assert p_model > p_pre, (
        f"inpaint {p_model:.2f} dB vs prefill {p_pre:.2f} dB in-hole")
