#!/usr/bin/env python3
"""Measurements of the port's trainers beyond chip_smoke's phase 13.

    python3 train_probe.py export
        on the CPU, with JAX (``JAX_PLATFORMS=cpu``): writes the reference
        benches' own draws into ``reference_draws.npz`` (see
        ``chip_smoke.reference_draws``): the scene seeds of
        ``bench_generative``'s pools and held-out sets (the inpainting and
        SR benches' and the diffusion bench's for its seeds 0-2), its
        held-out hole masks, and the draws of ``bench_detector``'s 64
        held-out scenes;
    python3 train_probe.py inpaint --config bench|record --steps N --every K
        on the card: the inpainting GAN on the reference bench's pool of 48
        scenes, its in-hole gain over the Jacobi prefill on the bench's 3
        held-out sets (the reference's scenes and masks) every K steps,
        without and with the flip ensemble. ``bench``: the bench's
        configuration (widths 48/96/192/384, cosine decay over N steps);
        ``record``: the configuration of the bench's 12,000-step record
        (the trainer's defaults: widths 32/64/128/256, constant learning
        rate, evaluated without the ensemble). ``--seed`` picks the
        weights and the batch stream (0: chip_smoke's);
        ``--deterministic`` runs under
        ``torch.use_deterministic_algorithms(True)`` with cuDNN's
        deterministic algorithms and ``CUBLAS_WORKSPACE_CONFIG=:4096:8``;
    python3 train_probe.py obb --runs 4 --eval-sets 1
        on the card: chip_smoke's OBB detector case (``bench_detector.py``'s
        configuration) trained --runs times, each from its own weights and
        batch stream (seeds 200 + r, 100 + r), each scored on the bench's
        64 held-out scenes (the reference's draws) and on --eval-sets sets
        of 64 drawn by the port (seeds 10,000 + e): mAP50 of each;
    python3 train_probe.py ab --steps 400 --w-gan 0.1 --every 100
        on the CPU: the reference (``pcmi_tpu``) and the port trained side
        by side at 48 px, widths (24, 48, 96, 96), from one state on the
        same batches and hole masks (the reference's draws; ``--seed``
        picks the state and the batch stream), the gain over the prefill
        on 2 held-out seeds every K steps. Needs JAX
        (``JAX_PLATFORMS=cpu``); runs one package per process
        (``--package ref`` or ``port``).
    python3 train_probe.py diffgap --steps 4000 --every 1000 --modes M,...
        on the card: chip_smoke's diffusion training (phase 14, seed 0) and,
        every K steps, its card-against-CPU comparison on the weights of
        that step, the CPU once and the card once per mode (by default
        twice as the port runs, ``port``; twice ``deterministic``, under
        ``torch.use_deterministic_algorithms(True, warn_only=True)`` with
        cuDNN's deterministic algorithms; once ``tf32``, with TF32
        convolutions and matrix products). Per card run: the loss and
        fill gaps, the whole gradient's relative gap, the worst leaf's
        apart for the embedding's leaves (``enc_temb``, ``mid_temb``,
        ``text``) and for the rest, each worst leaf's share of the whole
        gradient's norm, the largest leaf gap to the earlier run of its
        mode, and how many of the step's leaky ReLU signs and max-pool
        choices differ from the CPU's.

Each prints one line per evaluation.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def export(path: str) -> None:
    import jax

    sys.path.insert(0, "tests")
    from _torch_draws import obb_draws
    from pcmi_tpu.models.losses import random_hole_masks

    r = jax.random

    def scene_seeds(key, n):  # bench_generative._batch's per-scene seeds
        return np.array([int(r.randint(k, (), 0, 2**31 - 1))
                         for k in r.split(key, n)], np.int64)

    out = {"inpaint_pool_seeds": scene_seeds(r.PRNGKey(0), 48),
           "sr_eval_seeds": scene_seeds(r.PRNGKey(50_000), 8)}
    seeds, masks = [], []
    for es in range(3):
        seeds.append(scene_seeds(r.PRNGKey(60_000 + 97 * es), 8))
        m = random_hole_masks(r.PRNGKey(61_000 + 97 * es), (8, 96, 96), 6, 10)
        masks.append(np.asarray(m)[..., 0] > 0.5)
    out["inpaint_eval_seeds"] = np.stack(seeds)
    out["inpaint_eval_masks"] = np.packbits(np.stack(masks), axis=-1)
    # bench_diffusion(seed=s), s = 0, 1, 2: the 24 fields and 24 urban
    # pool scenes' seeds and the two held-out scenes' (make_styled_scene)
    pool, held = [], []
    for s in range(3):
        kf, ku = r.split(r.PRNGKey(s))
        pool.append([scene_seeds(k, 24) for k in (kf, ku)])
        held.append([int(r.randint(r.PRNGKey(90_000 + s + i), (), 0,
                                   2**31 - 1)) for i in range(2)])
    out["diffusion_pool_seeds"] = np.array(pool, np.int64)
    out["diffusion_eval_seeds"] = np.array(held, np.int64)
    key, parts = r.PRNGKey(10_000), []
    for _ in range(8):
        key, sub = r.split(key)
        parts.append(obb_draws(sub, 8, 128, hard=True))
    for k in parts[0]:
        out["obb_" + k] = np.concatenate([p[k].numpy() for p in parts])
    np.savez_compressed(path, **out)
    print(f"export {path}: " + ", ".join(f"{k} {v.shape}"
                                          for k, v in out.items()))


def inpaint(config: str, steps: int, every: int, seed: int,
            deterministic: bool = False) -> None:
    import chip_smoke as cs
    from pcmi_tpu_torch.models.scenes import sample_batch, scene_batch
    from pcmi_tpu_torch.models.training import (
        InpaintGANTrainer, InpaintTrainConfig)
    from pcmi_tpu_torch.models.unet import InpaintUNet

    print(cs.phase_device())
    T = cs.TRAIN
    draws = cs.reference_draws()
    if config == "bench":
        trainer = InpaintGANTrainer(
            InpaintTrainConfig(total_steps=steps),
            generator=InpaintUNet(widths=T["inpaint_widths"]), device="cuda")
    else:
        trainer = InpaintGANTrainer(InpaintTrainConfig(), device="cuda")
    pool = scene_batch(draws["inpaint_pool_seeds"], T["inpaint_size"], "cuda")
    sets = cs.inpaint_eval_sets(draws, "cuda")
    state = trainer.init(None, cs._gen(1 + 100 * seed))
    rng = cs._gen(100 * seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        state, _m = trainer.train_step(
            state, sample_batch(pool, T["inpaint_batch"], rng), rng)
        if (i + 1) % every == 0:
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            plain, ens = (cs.inpaint_gains(trainer, state, sets, e)
                          for e in (False, True))
            print(f"inpaint {config} seed {seed}"
                  f"{' deterministic' if deterministic else ''} "
                  f"step {i + 1} {s:.1f} s "
                  f"prefill_psnr {plain['prefill_psnr']:.4f} gains_db "
                  f"{[round(g, 3) for g in plain['gains_db']]} ensemble "
                  f"{[round(g, 3) for g in ens['gains_db']]}", flush=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter() - s


def obb(runs: int, eval_sets: int) -> None:
    import chip_smoke as cs
    from pcmi_tpu_torch.models.detector import (
        DetectorTrainConfig, OBBDetectorTrainer, synthesize_obb_batch)

    print(cs.phase_device())
    T = cs.TRAIN
    draws = cs.reference_draws()
    for r in range(runs):
        trainer = OBBDetectorTrainer(DetectorTrainConfig(lr=1e-3),
                                     device="cuda")
        net, opt = trainer.init(None, cs._gen(200 + r))
        rng = cs._gen(100 + r)
        for _ in range(T["obb_steps"]):
            trainer.train_step(net, opt, *synthesize_obb_batch(
                rng, T["obb_batch"], T["obb_size"], hard=True, device="cuda"))
        detect = trainer.make_obb_detector(net, max_boxes=8,
                                           score_thresh=0.25)
        named = [("bench", cs.obb_bench_scenes(draws, "cuda"))]
        for e in range(eval_sets):
            erng = cs._gen(10_000 + e)
            named.append((f"port {e}", [
                synthesize_obb_batch(erng, 8, T["obb_size"], hard=True,
                                     device="cuda")
                for _ in range(T["obb_eval"] // 8)]))
        for name, batches in named:
            ap, stats = cs.obb_map50(detect, batches)
            print(f"obb run {r} scenes {name} map50 {ap:.4f} recall "
                  f"{stats['recall']:.4f} precision {stats['precision']:.4f} "
                  f"objects {stats['n_gt']}", flush=True)


def ab(package: str, steps: int, w_gan: float, seed: int, every: int) -> None:
    import jax
    import jax.numpy as jnp

    from bench_generative import _batch, make_pool, sample_batch
    from pcmi_tpu.models import training as jt, unet as ju
    from pcmi_tpu.models.losses import random_hole_masks
    from pcmi_tpu.models.metrics import psnr
    from pcmi_tpu.pipelines.generative import diffusion_prefill

    torch.set_num_threads(3)
    size, b = 48, 8
    cfg = dict(w_gan=w_gan, total_steps=steps)
    widths, d_widths = (24, 48, 96, 96), (16, 32, 64, 64)
    ref = jt.InpaintGANTrainer(jt.InpaintTrainConfig(**cfg),
                               generator=ju.InpaintUNet(widths=widths),
                               discriminator=ju.PatchDiscriminator(
                                   widths=d_widths))
    pool = make_pool(jax.random.PRNGKey(0), 24, size)
    state = ref.init(jax.random.PRNGKey(3 + 100 * seed), pool[:b])
    if package == "port":
        from pcmi_tpu_torch import convert
        from pcmi_tpu_torch.models import training as tt, unet as tu

        port = tt.InpaintGANTrainer(
            tt.InpaintTrainConfig(**cfg), generator=tu.InpaintUNet(widths=widths),
            discriminator=tu.PatchDiscriminator(widths=d_widths), device="cpu")
        state = convert.gan_state_from_reference(state, port)
    evals = []
    for es in range(2):
        imgs = _batch(jax.random.PRNGKey(60_000 + 97 * es), b, size)
        mask = random_hole_masks(jax.random.PRNGKey(61_000 + 97 * es),
                                 (b, size, size), 6, 10)
        pre = jnp.stack([diffusion_prefill(imgs[i], mask[i, ..., 0] > 0.5)
                         for i in range(b)])
        evals.append((imgs, mask, float(psnr(pre, imgs, mask=mask))))
    key = jax.random.PRNGKey(2 + 100 * seed)
    for i in range(steps):
        key, k1, k2 = jax.random.split(key, 3)
        imgs = sample_batch(k1, pool, b)
        if package == "ref":
            state, _m = ref.train_step(state, imgs, k2)
        else:  # the masks the reference's step draws from k2
            km, _ = jax.random.split(k2)
            mask = random_hole_masks(km, (b, size, size), 6, 10)
            state, _m = port._step(state, torch.from_numpy(np.array(imgs)),
                                   torch.from_numpy(np.array(mask)))
        if (i + 1) % every == 0:
            gains = []
            for im, mk, p in evals:
                if package == "ref":
                    out = ref.infer(state, im, mk, ensemble=True)
                else:
                    out = jnp.asarray(port.infer(state, np.array(im),
                                                 np.array(mk),
                                                 ensemble=True).numpy())
                gains.append(round(float(psnr(out, im, mask=mk)) - p, 3))
            print(f"ab {package} w_gan={w_gan} seed {seed} step {i + 1} "
                  f"gains_db {gains}", flush=True)


# the leaves on the timestep and text embedding's path: it is added after
# a ConvBlock as a constant per channel, and every later ConvBlock's
# instance norm removes such a constant but for the zero-padded borders of
# the convolution before it, so their gradients are sums that nearly cancel
EMBED_LEAVES = ("enc_temb.", "mid_temb.", "text.", "class_embed.")


def _kinks(net, x: dict, dev: str) -> list:
    """Where the training step's forward on ``dev`` meets a kink: each
    leaky ReLU's signs, in order, then each 2x2 max pool's chosen
    inputs, on the host."""
    import copy

    import chip_smoke as cs
    from pcmi_tpu_torch.models import diffusion, unet

    leaky, down = unet._leaky, diffusion._down
    signs, picks = [], []

    def rec_leaky(t):
        signs.append((t > 0).cpu())
        return leaky(t)

    def rec_down(t):
        out, idx = torch.nn.functional.max_pool2d(t, 2, 2,
                                                  return_indices=True)
        picks.append(idx.cpu())
        return out

    unet._leaky, diffusion._down = rec_leaky, rec_down
    try:
        with torch.no_grad():
            cs._diffusion_engine(dev).train_step_loss(
                copy.deepcopy(net).to(dev), x["imgs"], x["masks"], None,
                None, x["tokens"], _draws=x["train"])
    finally:
        unet._leaky, diffusion._down = leaky, down
    return signs + picks


def diffgap(steps: int, every: int, modes) -> None:
    import chip_smoke as cs

    print(cs.phase_device())
    D = cs.DIFFUSION
    draws = cs.reference_draws()
    _eng, net, step, _ = cs._diffusion_trainer(D["gated_seed"], draws,
                                               "cuda", steps)
    x = cs._diffusion_cmp_inputs(draws)
    null = cs._norm_biases(net)
    for i in range(steps):
        step(i)
        if (i + 1) % every:
            continue
        cpu = cs._diffusion_cmp_run(net, x, "cpu")
        cpu_kinks = _kinks(net, x, "cpu")
        total = float(torch.cat([g.reshape(-1) for g in cpu[1].values()])
                      .norm())
        earlier: dict = {}
        for mode in modes:
            with cs._card_mode(mode) as caught:
                card = cs._diffusion_cmp_run(net, x, "cuda")
                kinks = _kinks(net, x, "cuda")
            gaps = cs._diffusion_gaps(card, cpu, net)
            rel = cs._leaf_gaps(card[1], cpu[1], null)
            row = dict(step=i + 1, mode=mode, loss=gaps["loss"],
                       ddim=gaps["ddim"], dpmpp=gaps["dpmpp"],
                       grad_all=gaps["grad_all"],
                       kinks_flipped=[int((a != b).sum()) for a, b in
                                      zip(kinks, cpu_kinks)])
            for part, keep in (("embed", True), ("conv", False)):
                sub = {k: v for k, v in rel.items()
                       if k.startswith(EMBED_LEAVES) == keep}
                k = max(sub, key=sub.get)
                row[part] = [k, sub[k], float(cpu[1][k].norm()) / total]
            if mode in earlier:
                row["to_earlier"] = max(cs._leaf_gaps(
                    card[1], earlier[mode][1], null).values())
            earlier[mode] = card
            if caught:
                row["not_deterministic"] = caught
            print("diffgap " + json.dumps(row), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["export", "inpaint", "obb", "ab",
                                     "diffgap"])
    ap.add_argument("--out", default="reference_draws.npz")
    ap.add_argument("--config", choices=["bench", "record"], default="bench")
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--every", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--w-gan", type=float, default=0.1)
    ap.add_argument("--package", choices=["ref", "port"], default="port")
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--eval-sets", type=int, default=1)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--modes", default="port,port,deterministic,"
                    "deterministic,tf32")
    a = ap.parse_args()
    if a.deterministic or a.mode == "diffgap":
        # before the first CUDA call: cuBLAS reads it when it starts
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    if a.deterministic:
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    if a.mode == "export":
        export(a.out)
    elif a.mode == "inpaint":
        inpaint(a.config, a.steps, a.every, a.seed, a.deterministic)
    elif a.mode == "diffgap":
        diffgap(a.steps, a.every, a.modes.split(","))
    elif a.mode == "obb":
        obb(a.runs, a.eval_sets)
    else:
        ab(a.package, a.steps, a.w_gan, a.seed, a.every)


if __name__ == "__main__":
    main()
