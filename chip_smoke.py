#!/usr/bin/env python3
"""Drive the PyTorch port (``pcmi_tpu_torch``) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. device: the card's name and power limit (``nvidia-smi``), the torch,
   CUDA and nvcc versions;
2. build: the six CUDA kernels from ``pcmi_tpu_torch/csrc`` (one nvcc per
   source, all started together, then one link);
3. kernel parity: K1 ``sgm_dir`` and K4 ``sgm_hwd`` (all four directions,
   forward and accumulate), K3 ``derive_right`` and K5 ``sgm_blocked``
   (both directions, with and without ``prev``) bit-exact against their
   plain versions on small awkward volumes (``RAGGED``,
   ``RAGGED_BLOCKED``; both hold volumes of 600 and of 1024 planes, the
   most the SGM kernels take), K2 ``wta`` in every instantiation (one or
   two inputs, parabola, margin, combined aggregate) on the same volumes
   and on ``RAGGED_WTA`` (D from 1 to 5 and past its 4- and 8-slice
   chunks, odd and even H * W), K6 ``derive_right_wdh`` on
   ``RAGGED_WDH`` (rows that are not a multiple of 16 bytes, Dp ==
   d_real, w == Wp, shifts that leave whole rows to ``fill``, fills 1.0
   and 1e4); K1, K2, K3, K5 and K6 in float32 and in bfloat16 (storage
   2, 4 and 8 bytes past an aligned address), K4 in float32 (in
   bfloat16 it must raise ``TypeError``);
   then each kernel against its plain PyTorch version on seeded
   inputs on the card at two volume shapes, (80, 896, 896) (the headline
   pair) and (144, 1152, 1152) at stride 2 (D = 288 search at stride 2),
   each time beside its bound (``bound``: bytes over 3.35 TB/s or float32
   operations over 67 TFLOP/s, whichever is larger), K2 in each of its
   four main-path forms (``WTA_FORMS``) beside its own bound, and one
   PyTorch call computing the same function (``library_ms``): for K3 and
   K6 a ``torch.gather`` over a volume prepared beforehand, for K2 a
   ``torch.min`` over D (its one-input integer form);
   K1 ``sgm_dir``, K3 ``derive_right``, K4 ``sgm_hwd``, K5 ``sgm_blocked``
   and K6 ``derive_right_wdh`` must be bit-exact, K2 ``wta`` exact in its
   argmin indices, disparity within 1e-5 px, best cost and margin within
   1e-6 (on the ragged volumes every output bit-exact), its combined
   aggregate (``with_aggregate``) bit-exact and the diagonal argmin over
   it equal to the derived right view's; the two alternative-layout SGMs
   (``layouts.sgm_aggregate_hwd`` and
   ``sgm_aggregate_blocked``) within 1e-4 of K1's ``sgm_aggregate``, and
   the (W, Dp, H)-derive right view equal to the default one; then all
   of this once more on bfloat16 volumes (every kernel but K4), with the
   same gates, volumes and indices bit-exact, against bounds whose
   volumes count 2 bytes an element (the (H, W) planes stay float32),
   and K5's aggregate within four bfloat16 steps of K1's (``_agg_tol``);
4. headline slice: the port's seed-1 synthetic scene (512x512 images,
   640x640 ground, heights 0-40 m) through ``HeightMapPipeline`` on
   ``cuda`` (``build_geometry`` -> ``process_pair``); height RMSE against
   the scene's exact truth must be <= 1.0 m, the valid fraction of the
   observable canvas >= 0.5, and one pair must launch exactly 6 ``sgm_dir``,
   3 ``wta`` and 1 ``derive_right`` and none of K4-K6;
5. alternative layouts: the three entry points of ``ops.stereo.layouts``
   on the headline pair's cost volume, with the launch counts set to 0
   just before and read just after (each of K4-K6 must launch), their
   results held against the main path's K1-K3 forms; then on the
   bfloat16 cost volume (K5 and K6 must launch, ``sgm_aggregate_hwd``
   must refuse it);
6. matcher variants: ``compute_disparity`` on the headline pair with
   ``right_sgm`` derived / diagonal / full, ``right_subpixel``,
   ``aggregation="box"`` and ``band_check_mode="vertical"``; every output
   finite, diagonal equal to derived with 4 ``sgm_dir``, one ``wta`` fewer
   and no ``derive_right`` launch;
7. the D = 288 pair at full width: the seed-3 scene of ``bench.py``'s
   MAX_DISP = 288 envelope (896x896 images, five views, 0-48 m), pair
   (0, 1) on the canvas of all ten pairs, ``disp_stride=2``, as ``strict``
   (gated at RMSE <= 1.0 m and valid >= 0.5) and as ``dense`` (the
   vertical cross-checker; finite and its launch counts only);
7b. the bfloat16 mode end to end: the headline pair (phase 4's entry
   point) and the D = 288 pair, strict and dense (phase 7's), under
   ``cost_dtype="bfloat16"``: RMSE <= 1.0 m and valid >= 0.5 (headline,
   strict), 6/3/1 launches (8/3/1 dense), each printed beside its
   float32 run: RMSE, valid fraction, peak memory and ms per pair, timed
   in turns float32, bfloat16, bfloat16, float32 (min, median, max);
7c. the matchers that narrow the search, on phase 7's strict pair
   through ``pair_core``: banded (``adapt_band_rows=64``,
   ``adapt_band_cols=64``, ``adapt_local_disp=96``; 10 ``sgm_dir``, 5
   ``wta``, 2 ``derive_right`` launches) and hierarchical
   (``hierarchical_local_disp=16``; 12/6/2), every output finite, each
   K1, K2 and K3 launch of one more run bit-exact against its plain
   version on the volumes the matcher handed it, banded
   RMSE <= 1.0 m and valid >= 0.5, hierarchical valid > 0.08; each
   printed beside the full search (RMSE, valid fraction, peak memory, ms
   per pair in turns full, banded, hierarchical, hierarchical, banded,
   full);
8. the fused D = 288 DSM (``bench.py``'s fused section, uncut): all ten
   pairs of phase 7's scene, dense, on the common 1152x1152 canvas, each
   through ``pair_core`` and ``dsm_update`` (3-sigma gate) on the 0.6 m
   grid, then ``dsm_finalize_multi(min_pairs=3, mad_max=1.2,
   accept2_delta=0.7)``. Exactly 80 ``sgm_dir``, 30 ``wta`` and 10
   ``derive_right`` launches; every pair's product finite; the fused RMSE
   below the mean dense pair RMSE and bbox completeness >= 0.65. The
   reference's six d288 gates are printed, not enforced (it fails two);
9. ``MultiDayFusion`` on the card through ``evaluate_fused_dsm`` (phase
   7's strict config, 10 pairs asked, 1 << 16 points per pair, 0.6 m
   grid, K-means on): every selected pair processed, the largest ICP
   residual < 2.0 m, filled cells >= 0.3 of the in-bounds cells, a time
   per stage; then ``StreamingAOIPipeline(band_rows=256)`` on pair (0, 1)
   against the monolithic pair on its 2 m grid: median |diff| < 0.05 m
   and > 90% within 0.5 m (``tests/test_streaming.py``'s bounds). Launch
   counts: 6/3/1 per pair and per band tile;
10. the low-texture fused recipe (``bench.py``'s lowtex_fused, uncut):
    8 views of 448x448, 16 "lr"-profile pairs, ``min_pairs=7``,
    ``mad_max=0.7``, 2 m cells, seeds 11-13: RMSE <= 1.0 m and
    completeness >= 0.4 on every seed (the reference's >= 0.5 is
    printed);
11. from disk: phase 7's scene anchored at (-58.58, -34.49), which
    RPC00B's fixed decimals hold exactly (its images and terrain
    compared with phase 7's), written as five NITF files (RPC00B, USE00A
    and CSEXRA TREs, five dates) with a KML of its extent; the native
    I/O library must load. Then, on the default device, the port's own
    entry points: ``cli.main(["height-map", ...])`` with phase 7's strict
    config as ``--set`` overrides (exit 0, 6/3/1 launches, height,
    disparity, cloud and DSM written and finite where valid, the
    north-up DSM against the terrain at median |error| < 1.0 m and RMSE
    < 2.5 m as ``tests/test_ingest.py`` computes them, the pair's valid
    fraction beside an in-memory run of the same pair),
    ``cli.main(["fuse", ...])`` (6/3/1 per processed pair, the same DSM
    gates, ``MultiDayFusion.stage_ms``), ``MultiAOISweep`` twice over the
    ingested stack with a stage cache (the second run all cache hits, no
    launch, the DSM identical) and ``HeightMapExtractor`` through
    ``PluginRunner`` on the CLI's pair (no error, its disparity and point
    cloud layers, 6/3/1); host ms of discovery, cropping and each
    command, the crop windows, peak memory;
12. the component plugins through ``registry.create(name, device="cuda")``
    at the sizes users run them: saliency on a 2048x2048 pan with a 32x32
    object in each of its 16 tiles (tile 512, pad 64), detection on a
    2048x2048 pan with 16 planted 32-40 px objects (tile 640, overlap 0.2:
    16 slices), restoration of a 1024x1024 RGB image hazed by the port's
    ``add_degradation`` (NLM search 21, template 7), stitching of two
    1024x1024 crops of one 1031x1536 texture offset by (7, 512), land-use on
    a 1024x1024 RGB scene of two textures (1500 segments, k = 5),
    super-resolution of a 512x512 RGB image to 2048x2048 and inpainting of a
    1024x1024 RGB image with a 96x96 hole: median ms of 3 runs after a
    warm-up, peak MB above what earlier phases hold, and the reference's
    own gates scaled to these sizes
    (saliency: a box on every object and the map's mean inside each > 3x its
    mean; detection: every object's centre inside a box whose centre is
    within 30 px of it, the reference's 12 px scaled by the slices' 640 /
    256 px; restoration: the dehazed contrast > 1.2x the hazy one, the
    transmission in [0.1, 1]; stitching: the shift within 1 px with >= 8
    inliers, the mosaic the texture; land-use: the superpixels covering the
    image, the smooth and noisy halves of the reference's scene in two
    classes (> 0.8 and > 0.65 of each half); super-resolution: the bicubic
    layer > 25 dB; inpainting: the hole mask exact and the image kept
    outside it); then each plugin on a small crop (192x192; a 64x64 input
    for super-resolution) on the card and on the CPU with the same weights
    and draws: continuous outputs within 1e-3, discrete ones (labels, boxes
    as covered pixels, masks, seams) equal on >= 99 % of their elements; one
    more run of each under ``torch.profiler`` gives the device's busy share
    and its three costliest operations. No stereo kernel launches in this
    phase;
13. training at the reference benches' widths (``TRAIN``), on their own
    data: the scene seeds, held-out hole masks and held-out OBB scenes
    that the reference draws (``reference_draws.npz``, written by
    ``python3 train_probe.py export``; the scenes are numpy draws in both
    packages): the default ``SRGANTrainer`` for 2,500 steps at 96², batch
    8 (SR beats bicubic on the bench's held-out scenes);
    ``InpaintGANTrainer`` in the configuration of the inpainting bench's
    12,000-step record (the trainer's defaults, GAN term 0.1, constant
    learning rate) for 12,000 steps, on the bench's 3 held-out sets
    against the Jacobi prefill in-hole (every set beats it with the flip
    ensemble; without it, the record's evaluation, reported beside the
    record's +1.061 dB); ``DIPConfig(iters=300).enhance`` of a noisy 96²
    scene (the output beats the noisy input); the
    ``generative-restoration`` plugin from the registry on a 192² scene
    with a NaN hole (finite, known pixels kept);
    ``OBBDetectorTrainer(lr=1e-3)`` for 1,500 steps, batch 16, 128² hard
    scenes, mAP50 over the bench's 64 held-out scenes (>= 0.9; the
    reference scores 0.9476 there; 64 scenes the port draws reported);
    ``make_tile_detector`` of a briefly trained ``DetectorTrainer``
    through ``ObjectDetector`` (runs end to end); each with its training
    seconds, ms per step and peak MB (SR, inpainting and OBB: five more
    steps under ``torch.profiler`` for the device's busy share and its
    costliest operations); then three steps of each trainer (the
    inpainting GAN on float32 and on bfloat16-rounded inputs) and of DIP
    on the card and on the CPU from one state, each held to its
    ``CMP_BOUNDS`` (losses; each parameter's first-step gradient against
    its own norm; the share of parameters within 1e-4 after the third
    step; DIP's output); a checkpoint round trip on the card (bit-equal),
    and ``registry.failures()`` empty. No stereo kernel launches in this
    phase;
14. tiled diffusion (``bench_generative.bench_diffusion``, uncut,
    ``DIFFUSION``): ``DiffusionConfig(steps=18, tile=32, stride=24,
    train_timesteps=400, text_conditioning=True)``, ``CondUNet(widths=(16,
    32, 64))``, the bench's 48 styled 64² scenes of each of its seeds 0-2
    (``reference_draws.npz``), batch 16, Adam 2e-3, 4,000 steps, hole
    masks ``random_hole_masks(..., 8, 16)``; the bench's evaluation on its
    two held-out scenes (centre hole, guidance 1 and 3) and its three
    gates (steer > 0.02, divergence at guidance 3 above guidance 1, the
    matched prompt's PSNR above the mismatched one) on seed 0, seeds 1-2
    reported; loss at step 20 and at the end, training s, ms per step,
    peak MB, busy share over 5 profiled steps; then the trained engine
    through ``RestorationGenerativePlugin(engine=...)`` on a 1024² RGB
    image with NaN holes (finite, known pixels kept) and
    ``EnhancementProcessor`` on 512², median ms; one training step and one
    DDIM and one DPM++ fill at guidance 3 on the card and on the CPU from
    shared weights and draws (``DIFF_CMP_BOUNDS``), and a control of the
    card's run with TF32 that must exceed one of those bounds. No stereo
    kernel launches;
15. the scale-out layer on one card, a 1 x 1 mesh over a world-size-1
    NCCL group: the halo exchange pads zeros; ``sharded_disparity`` on the
    headline pair's matcher inputs (interior rows within 0.51 px of the
    single-device matcher on > 98 %, 6/3/1 launches);
    ``batched_pair_step`` on phase 7's pairs 0 and 1 (bit-equal to
    ``pair_core``, 12/6/2 launches); ``sharded_dsm_update`` equal to the
    sequential loop; ``data_parallel_step`` of one inpainting GAN step,
    one ``DetectorTrainer`` and one ``OBBDetectorTrainer`` step (four
    128 px scenes) within phase 13's card-against-CPU bounds of the plain
    step; a checkpoint round trip of the stepped detector's ``(net,
    opt)`` (bit-equal, the template untouched, a step from it finite).

The last lines are a summary of phases 7b-15 (under 1500 characters;
each phase prints its full line above), a JSON object with each kernel's
numbers (``{"kernels": [...]}``; under ``bf16`` the bfloat16 form's
launches on the bfloat16 headline pair or layouts run, and its error,
time and bound at the same shape; its plain version's time is in phase
3's lines), the card's name and power limit, then
``{"ok": true, "device": {...}}``. Without a CUDA card the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

SHAPES = (((80, 896, 896), 1), ((144, 1152, 1152), 2))
_PK = "pcmi_tpu/ops/stereo/pallas_kernels.py"
KERNELS = {  # name: (source, the TPU kernels it replaces)
    "sgm_dir": ("pcmi_tpu_torch/csrc/sgm_dir.cu", f"{_PK}:157"),
    "wta": ("pcmi_tpu_torch/csrc/wta.cu", f"{_PK}:1071,901,574"),
    "derive_right": ("pcmi_tpu_torch/csrc/derive_right.cu", f"{_PK}:683"),
    "sgm_hwd": ("pcmi_tpu_torch/csrc/sgm_hwd.cu", f"{_PK}:417"),
    "sgm_blocked": ("pcmi_tpu_torch/csrc/sgm_blocked.cu", f"{_PK}:219"),
    "derive_right_wdh": ("pcmi_tpu_torch/csrc/derive_right_wdh.cu",
                         f"{_PK}:829"),
}
NONE = dict.fromkeys(KERNELS, 0)
# The card's published peaks (H100 SXM): HBM bytes/s and float32 operations/s
# outside the tensor cores. A kernel's bound is the larger of its bytes
# (each input read once, each output written once) and its operations over
# these rates.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# per (D, H, W) volume: (volumes moved, planes moved, operations per
# element); the SGMs are the mean of a forward launch (2 volumes) and an
# accumulating one (3), K2 ("wta") is the left view (2 inputs, 3 planes
# out), "wta:<form>" each form of WTA_FORMS
WORK = {
    "sgm_dir": (2.5, 0, 8.5), "sgm_hwd": (2.5, 0, 8.5),
    "sgm_blocked": (2.5, 0, 8.5), "wta": (2, 3, 6),
    "wta:left": (2, 3, 6), "wta:left_s": (3, 3, 6),
    "wta:right": (1, 2, 3), "wta:checker": (1, 3, 5),
    "derive_right": (2, 0, 0), "derive_right_wdh": (2, 0, 0),
}
# K2's forms on the main path: (second input?, scale, subpixel, margin,
# combined aggregate out): the left view, with S (right_sgm="diagonal"),
# the right view's integer argmin and the cross-checker's WTA
WTA_FORMS = {
    "left": (True, 0.25, True, True, False),
    "left_s": (True, 0.25, True, True, True),
    "right": (False, 0.5, False, False, False),
    "checker": (False, 1.0, True, True, False),
}
# K2's ragged volumes: D from 1 to 5 and D past a multiple of its d-chunks
# (4 slices in float32, 8 in bfloat16), odd and even H * W
RAGGED_WTA = tuple((D, h, w) for D in (1, 2, 3, 4, 5, 13, 21, 37)
                   for h, w in ((7, 9), (6, 10)))
# K6's ragged padded (Wp, Dp, Hp) volumes with (d_real, w): rows of 84, 24
# and 512 bytes in float32 (42, 12, 256 in bfloat16), Dp == d_real and
# w == Wp, d_real < Dp and w < Wp
RAGGED_WDH = (((48, 16, 21), 13, 37), ((40, 12, 32), 12, 40),
              ((33, 9, 6), 9, 30), ((20, 8, 128), 5, 20))
# small awkward volumes for K1, K3 and (moved to (H, W, D)) K4: partial
# tiles and ring tails, rows that are not 16-byte aligned, a ragged last
# 128-wide chunk, odd D, D > 256
RAGGED = (((7, 37, 53), 1), ((1, 33, 129), 1), ((144, 19, 1030), 2),
          ((300, 21, 67), 1), ((9, 5, 1028), 2), ((5, 3, 4), 1),
          # past 512 planes: 600 (32 per lane, 19 used) and the most the
          # SGM kernels take, 1024, on 1030 columns (blocks of 16 columns
          # fall back to 8 where accumulating in float32)
          ((600, 13, 67), 1), ((1024, 3, 1030), 2))
# blocked (nb, S, Dp, 128) volumes for K5: Dp = 8, not a multiple of 32 and
# above 256, one band and several, fewer steps than a tile and ring tails,
# 600 and 1024 planes (8 bands: blocks of 16 lanes, or 8 with `prev`)
RAGGED_BLOCKED = ((1, 3, 8), (3, 13, 40), (2, 21, 300), (1, 37, 37),
                  (1, 9, 600), (8, 3, 1024))
PER_PAIR = {**NONE, "sgm_dir": 6, "wta": 3, "derive_right": 1}
# the vertical cross-checker adds its 2 vertical directions
PER_DENSE_PAIR = {**PER_PAIR, "sgm_dir": 8}
# the banded matcher: the coarse pass (derived right view, no checker:
# 4 sgm_dir, 2 wta, 1 derive_right) and the narrow main path; the
# hierarchical one: two main paths
PER_BANDED_PAIR = {**PER_PAIR, "sgm_dir": 10, "wta": 5, "derive_right": 2}
PER_HIER_PAIR = {**PER_PAIR, "sgm_dir": 12, "wta": 6, "derive_right": 2}


def _run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def phase_device() -> str:
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    from pcmi_tpu_torch.ops.stereo._build import find_nvcc

    print([ln for ln in _run([find_nvcc(), "--version"]).splitlines()
           if "release" in ln][0])
    return smi


def phase_build() -> None:
    from pcmi_tpu_torch.ops.stereo import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    print(f"build: {len(_build.sources())} sources "
          f"{[s.name for s in _build.sources()]} -> {lib.name} "
          f"in {time.perf_counter() - t0:.1f} s")
    log = lib.with_suffix(".log")
    if log.exists():
        for ln in log.read_text().splitlines():
            if "registers" in ln or "Compiling entry" in ln:
                print("  ptxas:", ln.strip())


def _median_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def _maxerr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def _esize(dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


def _name(dtype) -> str:
    return "bfloat16" if dtype == torch.bfloat16 else "float32"


def bound(name: str, shape, esize: int = 4) -> tuple[float, str]:
    """The least time in ms the card could take for one launch of kernel
    ``name`` on a (D, H, W) volume of ``esize``-byte elements (the (H, W)
    planes are float32 for either), and what bounds it."""
    D, H, W = shape
    vols, planes, ops = WORK[name]
    nbytes = vols * D * H * W * esize + planes * H * W * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops * D * H * W / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _gather_right(vol, d_min: int, stride: int):
    """K3's yardstick: one ``torch.gather`` along W over a volume padded
    with the fill value, its index built beforehand."""
    D, H, W = vol.shape
    pad = max(abs(d_min), abs(d_min + (D - 1) * stride)) + 1
    volp = torch.nn.functional.pad(vol, (pad, pad), value=1.0)
    shift = pad + d_min + stride * torch.arange(D, device=vol.device)
    idx = (shift[:, None, None] + torch.arange(W, device=vol.device)
           ).expand(D, H, W)
    return lambda: torch.gather(volp, 2, idx)


def _gather_wdh(vol, d_real: int, w: int, d_min: int, stride: int,
                fill: float):
    """K6's yardstick: one ``torch.gather`` along Wp over a volume
    prepared beforehand: the image's columns padded with ``fill`` on both
    sides, ``BIG`` rows for ``d >= d_real`` and a zero row at the end, to
    which the index sends every ``x >= w``."""
    wp, dp, hp = vol.shape
    pad = abs(d_min) + (dp - 1) * abs(stride) + 1
    side = torch.full((pad, dp, hp), fill, dtype=vol.dtype,
                      device=vol.device)
    src = torch.cat([side, vol[:w], side,
                     torch.zeros_like(vol[:1])]).contiguous()
    src[:, d_real:] = 1e9
    src[-1] = 0
    x = torch.arange(wp, device=vol.device)[:, None]
    d = torch.arange(dp, device=vol.device)[None, :]
    idx = torch.where(x < w, pad + x + d_min + d * stride,
                      src.shape[0] - 1)
    idx = idx[:, :, None].expand(wp, dp, hp)
    return lambda: torch.gather(src, 0, idx)


def phase_parity(shape, stride: int, seed: int,
                 dtype=torch.float32) -> dict:
    """Each kernel against its plain version at one volume shape, on
    float32 or bfloat16 volumes (K4 is float32 only: in bfloat16 it must
    raise ``TypeError``)."""
    from pcmi_tpu_torch.ops.stereo import kernels as K
    from pcmi_tpu_torch.ops.stereo.matching import diag_right_disparity

    D, H, W = shape
    d_min = -(D * stride) // 2
    p1, p2 = 0.03, 0.48
    esize = _esize(dtype)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    vol = torch.rand(shape, generator=gen, device="cuda").to(dtype)
    res = {}
    ok = True

    # K1: the four left-view directions, as the path launches them
    def sgm_k(v, horizontal):
        return K.sgm_pair(v, p1, p2, horizontal)

    def sgm_p(v, horizontal):
        out = K.sgm_dir_plain(v, p1, p2, horizontal, False)
        return K.sgm_dir_plain(v, p1, p2, horizontal, True, out=out)

    h, v = sgm_k(vol, True), sgm_k(vol, False)
    hp, vp = sgm_p(vol, True), sgm_p(vol, False)
    torch.cuda.synchronize()
    err = max(_maxerr(h, hp), _maxerr(v, vp))
    exact = torch.equal(h, hp) and torch.equal(v, vp)
    ms_h = _median_ms(lambda: sgm_k(vol, True), 3) / 2
    ms_v = _median_ms(lambda: sgm_k(vol, False), 3) / 2
    pms = _median_ms(lambda: (sgm_p(vol, True), sgm_p(vol, False)), 2) / 4
    b1 = bound("sgm_dir", shape, esize)[0]
    print(f"  sgm_dir per launch: horizontal {ms_h:.3f} ms "
          f"({b1 / ms_h:.1%} of its {b1:.3f} ms bound), vertical "
          f"{ms_v:.3f} ms ({b1 / ms_v:.1%})")
    del hp, vp
    res["sgm_dir"] = dict(max_abs_err=err, exact=exact, ms=(ms_h + ms_v) / 2,
                          plain_ms=pms)
    ok &= exact

    # K2: left view (two inputs, x0.25, parabola, margin), right view (one
    # input, argmin only) and checker (one input, parabola), plus the left
    # inputs without the parabola for the raw argmin indices
    confs = {
        "left": (h, v, 0.25, True, True),
        "right": (h, None, 0.5, False, False),
        "checker": (vol, None, 1.0, True, False),
        "index": (h, v, 0.25, False, False),
    }
    werr = 0.0
    wexact = True
    for name, (a, b, sc, sub, mg) in confs.items():
        got = K.wta(a, b, sc, d_min, stride, sub, mg)
        ref = K.wta_plain(a, b, sc, d_min, stride, sub, mg)
        torch.cuda.synchronize()
        de = _maxerr(got[0], ref[0])
        be = _maxerr(got[1], ref[1])
        me = _maxerr(got[2], ref[2]) if mg else 0.0
        if name in ("right", "index"):
            idx_ok = torch.equal(got[0], ref[0])
        else:
            idx_ok = de <= 1e-5
        good = idx_ok and be <= 1e-6 and me <= 1e-6
        wexact &= torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        werr = max(werr, de, be, me)
        print(f"  wta[{name}] D={D} disp_err={de:.3g} best_err={be:.3g} "
              f"margin_err={me:.3g} {'ok' if good else 'FAIL'}")
        ok &= good
    ms = _median_ms(lambda: K.wta(h, v, 0.25, d_min, stride, True, True), 5)
    pms = _median_ms(
        lambda: K.wta_plain(h, v, 0.25, d_min, stride, True, True), 3)
    # the left view with the combined aggregate S as a fourth output
    got = K.wta(h, v, 0.25, d_min, stride, True, True, with_aggregate=True)
    ref = K.wta_plain(h, v, 0.25, d_min, stride, True, True,
                      with_aggregate=True)
    base = K.wta(h, v, 0.25, d_min, stride, True, True)
    torch.cuda.synchronize()
    s_err = _maxerr(got[3], ref[3])
    s_ok = torch.equal(got[3], ref[3]) and all(
        torch.equal(g, r) for g, r in zip(got[:3], base))
    # the diagonal right view read from S, against the derived chain on S
    # (derive with the 1e4 fill, integer WTA)
    s_vol = got[3]
    del got, ref, base

    def derived_right():
        return K.wta(K.derive_right(s_vol, d_min, 1e4, stride), None, 1.0,
                     d_min, stride, False, False)[0]

    diag_ok = torch.equal(diag_right_disparity(s_vol, d_min, stride),
                          derived_right())
    ms_diag = _median_ms(
        lambda: diag_right_disparity(s_vol, d_min, stride), 5)
    ms_der = _median_ms(derived_right, 5)
    del s_vol
    print(f"  wta[left + aggregate] D={D} S_err={s_err:.3g} "
          f"{'ok' if s_ok else 'FAIL'}; diag_right_disparity(S) "
          f"{ms_diag:.3f} ms (plain), equal to derive_right + integer wta "
          f"on S ({ms_der:.3f} ms) {diag_ok}")
    ok &= s_ok and diag_ok
    # each form's time against its own bound (WORK["wta:<form>"]), on the
    # left view's inputs
    form_ms = {}
    for form, (two, sc, sub, mg, agg) in WTA_FORMS.items():
        form_ms[form] = ms if form == "left" else _median_ms(
            lambda: K.wta(h, v if two else None, sc, d_min, stride, sub, mg,
                          agg), 5)
        bf = bound(f"wta:{form}", shape, esize)[0]
        print(f"  wta form {form}: {form_ms[form]:.3f} ms "
              f"({bf / form_ms[form]:.1%} of its {bf:.3f} ms bound)")
    # K2's yardstick: one torch.min over D, the one-input integer form up to
    # the affine d_min + stride * index (the port never calls it)
    lib_ms = _median_ms(lambda: torch.min(h, dim=0), 5)
    idx = torch.min(h, dim=0).indices
    same = torch.equal(d_min + stride * idx.float(),
                       K.wta(h, None, 0.5, d_min, stride, False, False)[0])
    print(f"  wta: torch.min(dim=0) {lib_ms:.3f} ms, the same indices as "
          f"K2's right form {same}; K2's right form "
          f"{'faster' if form_ms['right'] < lib_ms else 'SLOWER'}")
    res["wta"] = dict(max_abs_err=max(werr, s_err), exact=wexact and s_ok,
                      ms=ms, plain_ms=pms, library_ms=lib_ms, forms=form_ms)

    # K3, and its yardstick: one torch.gather (the port never calls it)
    got = K.derive_right(vol, d_min, 1.0, stride)
    ref = K.derive_right_plain(vol, d_min, 1.0, stride)
    gather = _gather_right(vol, d_min, stride)
    torch.cuda.synchronize()
    exact = torch.equal(got, ref)
    err = _maxerr(got, ref)
    print(f"  derive_right: torch.gather gives the same volume "
          f"{torch.equal(gather(), ref)}")
    del got, ref
    res["derive_right"] = dict(
        max_abs_err=err, exact=exact,
        ms=_median_ms(lambda: K.derive_right(vol, d_min, 1.0, stride), 5),
        plain_ms=_median_ms(
            lambda: K.derive_right_plain(vol, d_min, 1.0, stride), 3),
        library_ms=_median_ms(gather, 5))
    del gather
    ok &= exact

    # the K1 reference the alternative layouts are held against
    ref4 = (h + v) / 4.0
    del h, v
    res.update(_parity_layouts(vol, ref4, p1, p2, d_min, stride))
    ok &= all(r["exact"] for r in res.values())
    for name, r in res.items():
        r["bound_ms"], r["bound_by"] = bound(name, shape, esize)
        r.setdefault("library_ms", None)
        lib = (f"  library {r['library_ms']:.3f} ms" if r["library_ms"]
               else "")
        print(f"parity {_name(dtype)} {name} shape={tuple(shape)} "
              f"stride={stride}: "
              f"max_abs_err={r['max_abs_err']:.3g} exact={r['exact']} "
              f"kernel {r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  "
              f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}, "
              f"{r['bound_ms'] / r['ms']:.1%}){lib}")
    if not ok:
        raise SystemExit(f"kernel parity failed at {shape} in {_name(dtype)}")
    return res


def _wta_all_forms(a, b, d_min: int, stride: int) -> list:
    """K2 in each of its instantiations (one or two inputs, with or without
    the parabola, with or without the margin, and with the combined
    aggregate) on ``a`` (and ``b``): the forms whose outputs are not all
    bit-exact against the plain version's."""
    from pcmi_tpu_torch.ops.stereo import kernels as K

    bad = []
    for two, sub, mg in itertools.product((True, False), repeat=3):
        for agg in (False, True) if two else (False,):
            scale = 0.25 if two else (1.0 if mg else 0.5)
            args = (a, b if two else None, scale, d_min, stride, sub, mg,
                    agg)
            got, ref = K.wta(*args), K.wta_plain(*args)
            torch.cuda.synchronize()
            if not all((g is None and r is None) or torch.equal(g, r)
                       for g, r in zip(got, ref)):
                bad.append((two, sub, mg, agg))
    return bad


def _offset_rand(shape, offset: int, dt, gen):
    """A seeded volume of ``shape`` whose storage starts ``offset``
    elements past an aligned address."""
    n = math.prod(shape)
    return torch.rand(n + offset, generator=gen, device="cuda").to(dt)[
        offset:].view(shape)


def phase_ragged() -> None:
    """K1 and K4 (all four directions, forward and accumulate) and K3
    (shifts of either sign, one past the row) bit-exact against their plain
    versions on :data:`RAGGED`, and once more on a volume whose storage
    starts 4 bytes past an aligned address; K2 in every instantiation on
    the same volumes and on :data:`RAGGED_WTA` (storage 0, 4 and, in
    bfloat16, 2 bytes past an aligned address); K5 (both directions, with
    and without ``prev``) on :data:`RAGGED_BLOCKED`; K6 on the padded
    volumes of :data:`RAGGED_WDH` (storage 0, 4, 8 and, in bfloat16, 2
    bytes past an aligned address; shifts that copy, that leave rows
    wholly outside the image, fills 1.0 and 1e4). K1, K2, K3, K5 and K6
    in float32 and in bfloat16; every output bit-exact."""
    from pcmi_tpu_torch.ops.stereo import kernels as K
    from pcmi_tpu_torch.ops.stereo._build import load

    lib = load()
    if (lib.pcmi_sgm_dir_max_disp(), lib.pcmi_sgm_hwd_max_disp(),
            lib.pcmi_sgm_blocked_max_disp()) != (
            K.SGM_DIR_MAX_DISP, K.SGM_HWD_MAX_DISP, K.SGM_BLOCKED_MAX_DISP):
        raise SystemExit("the wrappers' and the kernels' largest D differ")
    p1, p2 = 0.03, 0.48
    gen = torch.Generator(device="cuda").manual_seed(7)
    f32, b16 = torch.float32, torch.bfloat16
    cases = [(shape, stride, 0, dt) for dt in (f32, b16)
             for shape, stride in RAGGED]
    # storage that starts 4 bytes past an aligned address, and in bfloat16
    # also 2 bytes past one (below cp.async's smallest copy)
    cases += [((4, 9, 64), 1, 1, f32), ((4, 9, 64), 1, 2, b16),
              ((4, 9, 64), 1, 1, b16)]
    bad = []
    for shape, stride, offset, dt in cases:
        D, H, W = shape
        n = D * H * W
        vol = torch.rand(n + offset, generator=gen, device="cuda").to(dt)[
            offset:].view(shape)
        base = torch.rand(shape, generator=gen, device="cuda").to(dt)
        plans = set()
        for horizontal, reverse in itertools.product((True, False),
                                                     repeat=2):
            for acc in (False, True):
                plans.add(K.sgm_dir_plan(D, H if horizontal else W,
                                         horizontal, acc, _esize(dt)))
                out = base.clone() if acc else None
                got = K.sgm_dir(vol, p1, p2, horizontal, reverse, out=out)
                ref = K.sgm_dir_plain(vol, p1, p2, horizontal, reverse,
                                      out=base.clone() if acc else None)
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    bad.append(("sgm_dir", _name(dt), shape, horizontal,
                                reverse, acc, _maxerr(got, ref)))
        for d_min in (-(D * stride) // 2, 3, -D * stride - 2, W):
            got = K.derive_right(vol, d_min, 0.5, stride)
            ref = K.derive_right_plain(vol, d_min, 0.5, stride)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                bad.append(("derive_right", _name(dt), shape, d_min,
                            _maxerr(got, ref)))
        # K2 on the same extents (an odd H * W, or storage off a 4-byte
        # address, takes bfloat16 one pixel per thread)
        forms = _wta_all_forms(vol, base, -(D * stride) // 2, stride)
        if forms:
            bad.append(("wta", _name(dt), shape, offset, forms))
        if dt == b16:
            print(f"ragged bfloat16 {shape} stride={stride} offset={offset}:"
                  f" sgm_dir plans {sorted(tuple(p) for p in plans)}")
            continue
        # K4 (float32 only) on the same extents with D on the fast axis
        hwd = torch.rand(n + offset, generator=gen, device="cuda")[
            offset:].view(H, W, D)
        base = base.permute(1, 2, 0).contiguous()
        for axis, reverse, acc in itertools.product(
                (0, 1), (False, True), (False, True)):
            got = K.sgm_hwd(hwd, p1, p2, axis, reverse,
                            out=base.clone() if acc else None)
            ref = K.sgm_hwd_plain(hwd, p1, p2, axis, reverse,
                                  out=base.clone() if acc else None)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                bad.append(("sgm_hwd", shape, axis, reverse, acc,
                            _maxerr(got, ref)))
        print(f"ragged {shape} stride={stride} offset={offset}: sgm_dir "
              f"plans {sorted(tuple(p) for p in plans)}, sgm_hwd plans "
              f"{[tuple(K.sgm_hwd_plan(D, a)) for a in (False, True)]}")
    for (nb, S, Dp), dt in itertools.product(RAGGED_BLOCKED, (f32, b16)):
        vb = torch.rand((nb, S, Dp, K.BAND), generator=gen,
                        device="cuda").to(dt)
        prev = torch.rand(vb.shape, generator=gen, device="cuda").to(dt)
        for reverse, pv in itertools.product((False, True), (None, prev)):
            got = K.sgm_blocked(vb, p1, p2, reverse, prev=pv)
            ref = K.sgm_blocked_plain(vb, p1, p2, reverse, prev=pv)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                bad.append(("sgm_blocked", _name(dt), tuple(vb.shape),
                            reverse, pv is not None, _maxerr(got, ref)))
        print(f"ragged blocked {_name(dt)} {tuple(vb.shape)}: sgm_blocked "
              f"plans {[tuple(K.sgm_blocked_plan(Dp, nb, a, _esize(dt))) for a in (False, True)]}")
    n_wta = 0
    for dt, (D, h, w) in itertools.product((f32, b16), RAGGED_WTA):
        stride = 1 + D % 2
        for offset in (0, 1, 2) if dt == b16 else (0, 1):
            a = _offset_rand((D, h, w), offset, dt, gen)
            b = _offset_rand((D, h, w), offset, dt, gen)
            forms = _wta_all_forms(a, b, -(D * stride) // 2, stride)
            n_wta += 1
            if forms:
                bad.append(("wta", _name(dt), (D, h, w), offset, forms))
    # K6 in both types on padded (Wp, Dp, Hp) volumes: rows copied, rows
    # whose source lies wholly outside [0, w) (all `fill`), BIG and 0 rows
    n_wdh = 0
    for dt, (shape, d_real, w) in itertools.product((f32, b16), RAGGED_WDH):
        dp = shape[1]
        for offset in (0, 1, 2, 4) if dt == b16 else (0, 1, 2):
            wdh = _offset_rand(shape, offset, dt, gen)
            for d_min, stride, fill in ((0, 1, 1.0), (-4, 2, 1.0),
                                        (-12, 1, 1e4), (w + 3, 1, 1e4),
                                        (-w - 2 * dp, 2, 1.0)):
                got = K.derive_right_wdh(wdh, d_real, w, d_min, stride, fill)
                ref = K.derive_right_wdh_plain(wdh, d_real, w, d_min, stride,
                                               fill)
                torch.cuda.synchronize()
                n_wdh += 1
                if not torch.equal(got, ref):
                    bad.append(("derive_right_wdh", _name(dt), shape, offset,
                                d_min, stride, fill, _maxerr(got, ref)))
    try:
        K.sgm_hwd(torch.zeros((4, 5, 8), dtype=b16, device="cuda"), p1, p2,
                  0, False)
        bad.append(("sgm_hwd", "took a bfloat16 volume"))
    except TypeError:
        pass
    print(f"ragged: {len(cases)} + {2 * len(RAGGED_BLOCKED)} volumes, K2 "
          f"every form on {n_wta} more, K6 {n_wdh} launches, "
          f"mismatches {bad}")
    if bad:
        raise SystemExit(f"ragged parity failed: {bad}")


def _agg_tol(ref4) -> float:
    """How far a layouts aggregate may lie from K1's ``ref4``: 1e-4 in
    float32; in bfloat16 four steps of the largest value (K5 rounds
    ``state + prev`` once where K1 adds two stored volumes, so each pair of
    directions may land a step apart before the combine)."""
    if ref4.dtype == torch.float32:
        return 1e-4
    return float(ref4.max()) / 32


def _parity_hwd(vol, ref4, p1, p2) -> dict:
    """K4 on the (H, W, D) volume, both scan axes, each as a fwd + bwd
    pair (float32 only)."""
    from pcmi_tpu_torch.ops.stereo import kernels as K
    from pcmi_tpu_torch.ops.stereo import layouts as L

    hwd = vol.permute(1, 2, 0).contiguous()

    def hwd_k(axis):
        out = K.sgm_hwd(hwd, p1, p2, axis, False)
        return K.sgm_hwd(hwd, p1, p2, axis, True, out=out)

    def hwd_p(axis):
        out = K.sgm_hwd_plain(hwd, p1, p2, axis, False)
        return K.sgm_hwd_plain(hwd, p1, p2, axis, True, out=out)

    err, exact = 0.0, True
    for axis in (0, 1):
        got, ref = hwd_k(axis), hwd_p(axis)
        torch.cuda.synchronize()
        err = max(err, _maxerr(got, ref))
        exact &= torch.equal(got, ref)
        del got, ref
    ms_v = _median_ms(lambda: hwd_k(0), 3) / 2
    ms_h = _median_ms(lambda: hwd_k(1), 3) / 2
    pms = _median_ms(lambda: (hwd_p(0), hwd_p(1)), 1) / 4
    agg = L.sgm_aggregate_hwd(hwd, p1, p2).permute(2, 0, 1)
    agg_err = _maxerr(agg, ref4)
    del agg
    ms_agg = _median_ms(lambda: L.sgm_aggregate_hwd(hwd, p1, p2), 3)
    del hwd
    b4 = bound("sgm_hwd", vol.shape)[0]
    print(f"  sgm_hwd per launch: horizontal {ms_h:.3f} ms "
          f"({b4 / ms_h:.1%} of its {b4:.3f} ms bound), vertical "
          f"{ms_v:.3f} ms ({b4 / ms_v:.1%}); sgm_aggregate_hwd {ms_agg:.3f} ms, "
          f"max |diff| to K1's sgm_aggregate {agg_err:.3g}")
    return dict(max_abs_err=err, exact=exact and agg_err <= 1e-4,
                ms=(ms_h + ms_v) / 2, plain_ms=pms)


def _parity_layouts(vol, ref4, p1, p2, d_min, stride) -> dict:
    """K4-K6 against their plain versions (bit-exact) and their entry
    points against the main path's K1-K3 forms, on one volume."""
    from pcmi_tpu_torch.ops.stereo import kernels as K
    from pcmi_tpu_torch.ops.stereo import layouts as L

    D, H, W = vol.shape
    res = {}
    esize = _esize(vol.dtype)
    tol = _agg_tol(ref4)
    if esize == 4:
        res["sgm_hwd"] = _parity_hwd(vol, ref4, p1, p2)

    # K5 on the blocked (nb, S, D, 128) volumes of both scan axes (W and H
    # are multiples of 128 and D of 8 here, so no padding)
    blocked = {
        "vertical": vol.permute(1, 0, 2).reshape(H, D, W // 128, 128)
        .permute(2, 0, 1, 3).contiguous(),
        "horizontal": vol.permute(2, 0, 1).reshape(W, D, H // 128, 128)
        .permute(2, 0, 1, 3).contiguous(),
    }

    def blk(f, vb):
        fwd = f(vb, p1, p2, False)
        return f(vb, p1, p2, True, prev=fwd)

    err, exact, ms, pms = 0.0, True, [], []
    for name, vb in blocked.items():
        got, ref = blk(K.sgm_blocked, vb), blk(K.sgm_blocked_plain, vb)
        torch.cuda.synchronize()
        err = max(err, _maxerr(got, ref))
        exact &= torch.equal(got, ref)
        del got, ref
        ms.append(_median_ms(lambda: blk(K.sgm_blocked, vb), 3) / 2)
        pms.append(_median_ms(lambda: blk(K.sgm_blocked_plain, vb), 1) / 2)
    del blocked
    agg = L.sgm_aggregate_blocked(vol, p1, p2)
    agg_err = _maxerr(agg, ref4)
    del agg
    ms_agg = _median_ms(lambda: L.sgm_aggregate_blocked(vol, p1, p2), 3)
    b5 = bound("sgm_blocked", vol.shape, esize)[0]
    print(f"  sgm_blocked per launch: horizontal {ms[1]:.3f} ms "
          f"({b5 / ms[1]:.1%} of its {b5:.3f} ms bound), vertical "
          f"{ms[0]:.3f} ms ({b5 / ms[0]:.1%}); sgm_aggregate_blocked "
          f"{ms_agg:.3f} ms, max |diff| to K1's sgm_aggregate {agg_err:.3g}")
    res["sgm_blocked"] = dict(max_abs_err=err,
                              exact=exact and agg_err <= tol,
                              ms=sum(ms) / 2, plain_ms=sum(pms) / 2)

    # K6 on the (W, D, H) volume at the main path's extents
    wdh = vol.permute(2, 0, 1).contiguous()
    got = K.derive_right_wdh(wdh, D, W, d_min, stride, 1.0)
    ref = K.derive_right_wdh_plain(wdh, D, W, d_min, stride, 1.0)
    torch.cuda.synchronize()
    err, exact = _maxerr(got, ref), torch.equal(got, ref)
    del got, ref
    ms = _median_ms(lambda: K.derive_right_wdh(wdh, D, W, d_min, stride), 5)
    pms = _median_ms(
        lambda: K.derive_right_wdh_plain(wdh, D, W, d_min, stride), 3)
    gather = _gather_wdh(wdh, D, W, d_min, stride, 1.0)
    g_same = torch.equal(gather(), K.derive_right_wdh_plain(
        wdh, D, W, d_min, stride))
    print(f"  derive_right_wdh: torch.gather gives the same volume {g_same}")
    lib_ms = _median_ms(gather, 5)
    del wdh, gather
    r_wdh = L.right_disparity_fused(vol, p1, p2, d_min, stride,
                                    use_wdh_derive=True)
    r_def = L.right_disparity_fused(vol, p1, p2, d_min, stride)
    same = torch.equal(r_wdh, r_def)
    print(f"  right_disparity_fused: use_wdh_derive equal to the default "
          f"{same}")
    res["derive_right_wdh"] = dict(max_abs_err=err, exact=exact and same,
                                   ms=ms, plain_ms=pms, library_ms=lib_ms)
    return res


class Headline(NamedTuple):
    """Phase 4's pipeline, geometry, matcher config and images on the card,
    reused by phases 5, 6 and 7b."""
    pipe: object
    geom: object
    scfg: object
    img1: object
    img2: object
    scene: object


def phase_headline() -> dict:
    from pcmi_tpu_torch.config import (
        PipelineConfig, RectifyConfig, StereoConfig)
    from pcmi_tpu_torch.geometry.synthetic import (
        aoi_lonlat_ranges, make_stereo_scene)
    from pcmi_tpu_torch.ops.stereo import kernels as K
    from pcmi_tpu_torch.pipelines.height_map import HeightMapPipeline

    scene = make_stereo_scene(seed=1, out_shape=(512, 512),
                              ground_shape=(640, 640), h_range=(0.0, 40.0),
                              views=((10.0, 80.0), (20.0, 250.0)))
    cfg = PipelineConfig(
        stereo=StereoConfig(block_size=9, census_window=5,
                            margin_undefined=8),
        rectify=RectifyConfig(height_range=(0.0, 40.0)))
    pipe = HeightMapPipeline(cfg, device="cuda")
    geom = pipe.build_geometry(scene.rpcs[0], scene.rpcs[1],
                               *aoi_lonlat_ranges(scene),
                               tuple(scene.images[0].shape),
                               tuple(scene.images[1].shape))
    scfg = pipe.stereo_cfg_for([geom])
    img1 = scene.images[0].to("cuda")
    img2 = scene.images[1].to("cuda")

    def pair():
        return pipe.process_pair(img1, img2, geom, scfg)

    pair()  # warm-up: kernel library load, allocator
    torch.cuda.synchronize()
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    prod = pair()
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ms = _median_ms(pair, 5)  # one more warm-up inside, then 5 timed

    h, w = geom.out_shape
    ctx = Headline(pipe, geom, scfg, img1, img2, scene)
    rmse, vf = _headline_accuracy(ctx, prod)
    out = dict(canvas=[h, w], max_disp=scfg.max_disp, height_rmse_m=rmse,
               valid_fraction=vf, ms_per_pair=ms,
               mpix_per_s=h * w / ms / 1e3, peak_mem_mb=peak / 2**20,
               launches=launches)
    print("headline:", json.dumps(out))
    if not rmse <= 1.0:
        raise SystemExit(f"headline: height RMSE {rmse} m > 1.0 m")
    if not vf >= 0.5:
        raise SystemExit(f"headline: valid fraction {vf} < 0.5")
    if launches != PER_PAIR:
        raise SystemExit(f"headline: launches per pair {launches}, "
                         f"expected {PER_PAIR}")
    return out, ctx


def _headline_accuracy(ctx, prod):
    """Height RMSE of a headline pair product against the scene's exact
    truth and its valid share of the observable canvas. Fails the run on a
    non-finite or misshaped product."""
    scene = ctx.scene
    h, w = ctx.geom.out_shape
    valid = prod.valid.cpu().numpy()
    xyz = prod.xyz.cpu().numpy()
    height = prod.height.cpu().numpy()
    if not (np.isfinite(xyz).all() and xyz.shape == (h, w, 3)):
        raise SystemExit("headline: non-finite or misshaped xyz")
    ox, oy = scene.ground_origin
    terr = scene.terrain.cpu().numpy()
    gx = (xyz[..., 0] - ox) / scene.ground_gsd
    gy = (xyz[..., 1] - oy) / scene.ground_gsd
    inb = ((gx >= 0) & (gx < terr.shape[1] - 1)
           & (gy >= 0) & (gy < terr.shape[0] - 1))
    tt = terr[np.clip(gy.astype(int), 0, terr.shape[0] - 1),
              np.clip(gx.astype(int), 0, terr.shape[1] - 1)]
    m = valid & inb
    rmse = float(np.sqrt(np.mean((height[m] - tt[m]) ** 2)))
    observable = ((prod.rect_left >= 0) & (prod.rect_right >= 0)).cpu().numpy()
    return rmse, float(valid.sum() / max(observable.sum(), 1))


def _matcher_inputs(ctx):
    """The headline pair as ``pair_core`` hands it to the matcher."""
    from pcmi_tpu_torch.geometry.rectify import rectify_arrays
    from pcmi_tpu_torch.pipelines.height_map import matcher_inputs

    pipe, geom, scfg, img1, img2 = ctx[:5]
    r1, r2 = rectify_arrays(img1, img2,
                            torch.as_tensor(geom.H1, dtype=torch.float32),
                            torch.as_tensor(geom.H2, dtype=torch.float32),
                            geom.out_shape)
    return matcher_inputs(r1, r2, scfg)[:4]


def phase_layouts(ctx, cost_dtype: str = "float32") -> dict:
    """The entry points of ``ops.stereo.layouts`` on the headline pair's
    cost volume, counted, and held against the main path's forms. In
    bfloat16 ``sgm_aggregate_hwd`` must refuse the volume."""
    from pcmi_tpu_torch.ops.stereo import kernels as K
    from pcmi_tpu_torch.ops.stereo import layouts as L
    from pcmi_tpu_torch.ops.stereo.matching import (
        build_cost_volume, sgm_aggregate)

    scfg = dataclasses.replace(ctx[2], cost_dtype=cost_dtype)
    n1, n2, v1, v2 = _matcher_inputs(ctx)
    vol = build_cost_volume(n1, n2, v1, v2, scfg)
    p1, p2, d_min = scfg.sgm_p1, scfg.sgm_p2, scfg.min_disparity
    f32 = vol.dtype == torch.float32
    torch.cuda.synchronize()
    K.reset_launches()
    hwd = None
    if f32:
        hwd = L.sgm_aggregate_hwd(vol.permute(1, 2, 0).contiguous(), p1, p2)
    blk = L.sgm_aggregate_blocked(vol, p1, p2)
    r_wdh = L.right_disparity_fused(vol, p1, p2, d_min, scfg.disp_stride,
                                    use_wdh_derive=True)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    if not f32:
        try:
            L.sgm_aggregate_hwd(vol.permute(1, 2, 0).contiguous(), p1, p2)
            raise SystemExit("layouts: sgm_aggregate_hwd took bfloat16")
        except TypeError:
            pass
    ref = sgm_aggregate(vol, scfg)
    r_def = L.right_disparity_fused(vol, p1, p2, d_min, scfg.disp_stride)
    out = dict(dtype=_name(vol.dtype), shape=list(vol.shape),
               launches=launches,
               hwd_err=_maxerr(hwd.permute(2, 0, 1), ref) if f32 else None,
               blocked_err=_maxerr(blk, ref), tolerance=_agg_tol(ref),
               wdh_right_equal=torch.equal(r_wdh, r_def))
    print("layouts:", json.dumps(out))
    missing = [k for k in (("sgm_hwd",) if f32 else ())
               + ("sgm_blocked", "derive_right_wdh") if launches[k] < 1]
    if missing:
        raise SystemExit(f"layouts: {missing} never launched")
    if not ((not f32 or out["hwd_err"] <= 1e-4)
            and out["blocked_err"] <= out["tolerance"]
            and out["wdh_right_equal"]):
        raise SystemExit("layouts: results differ from the main path's")
    return out


VARIANTS = {
    "derived": (dict(right_sgm="derived"), "sgm"),
    "diagonal": (dict(right_sgm="diagonal"), "sgm"),
    "full": (dict(right_sgm="full"), "sgm"),
    "right_subpixel": (dict(right_subpixel=True), "sgm"),
    "box": ({}, "box"),
    "vertical": (dict(band_check_mode="vertical"), "sgm"),
}


def phase_variants(ctx) -> dict:
    """``compute_disparity``'s ported variants on the headline pair."""
    from pcmi_tpu_torch.ops.stereo import kernels as K
    from pcmi_tpu_torch.ops.stereo.matching import compute_disparity

    scfg = ctx[2]
    n1, n2, v1, v2 = _matcher_inputs(ctx)
    observable = float(v1.sum())
    results, report = {}, {}
    for name, (kw, aggregation) in VARIANTS.items():
        cfg = dataclasses.replace(scfg, **kw)
        def run():
            return compute_disparity(n1, n2, v1, v2, cfg,
                                     aggregation=aggregation)

        K.reset_launches()
        res = run()
        torch.cuda.synchronize()
        launches = {k: n for k, n in K.LAUNCHES.items() if n}
        ms = _median_ms(run, 3)
        fields = {f: t for f, t in res._asdict().items() if t is not None}
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in fields.values())
        report[name] = dict(
            finite=finite, fields=sorted(fields), ms=ms,
            valid_fraction=float(res.valid.sum()) / max(observable, 1.0),
            launches=launches)
        print(f"variant {name}: {json.dumps(report[name])}")
        if not finite:
            raise SystemExit(f"variants: {name} gave non-finite output")
        results[name] = res
    a, b = results["derived"], results["diagonal"]
    same = all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("disparity", "disparity_right", "valid"))
    print(f"variants: diagonal equal to derived {same}")
    if not same:
        raise SystemExit("variants: diagonal differs from derived")
    # diagonal: K2 writes the aggregate, so no combine pass, no derive and
    # no second WTA
    der, dia = (report[k]["launches"] for k in ("derived", "diagonal"))
    if dia != {"sgm_dir": 4, "wta": der["wta"] - 1} or der.get(
            "derive_right") != 1:
        raise SystemExit(f"variants: launches derived {der}, diagonal {dia}")
    return report


D288_VIEWS = ((25.0, 80.0), (35.0, 250.0), (30.0, 160.0), (20.0, 20.0),
              (28.0, 305.0))
D288_H_RANGE = (0.0, 48.0)


class D288(NamedTuple):
    """Phase 7's scene and geometry, reused by phases 8 and 9."""
    scene: object
    cfg: object          # PipelineConfig (strict gates, disp_stride=2)
    strict: object       # its StereoConfig for all ten geometries
    pairs: list
    geoms: list
    canvas: tuple        # the common (padded) canvas of the ten pairs


def _d288_inputs(ctx: D288, idx: int):
    """Pair ``idx`` rectified on the card and padded to the common canvas
    (-1 outside), with its triangulation operator."""
    from pcmi_tpu_torch.geometry.rectify import (
        rectify_arrays, triangulation_operator)

    (i, j), g = ctx.pairs[idx], ctx.geoms[idx]
    r1, r2 = rectify_arrays(ctx.scene.images[i].to("cuda"),
                            ctx.scene.images[j].to("cuda"),
                            torch.as_tensor(g.H1, dtype=torch.float32),
                            torch.as_tensor(g.H2, dtype=torch.float32),
                            g.out_shape)
    (hc, wc), (gh, gw) = ctx.canvas, g.out_shape
    pad = (0, wc - gw, 0, hc - gh)
    r1 = torch.nn.functional.pad(r1, pad, value=-1.0)
    r2 = torch.nn.functional.pad(r2, pad, value=-1.0)
    M, b = (t.to("cuda") for t in triangulation_operator(g))
    return r1, r2, M, b


def _pair_accuracy(scene, prod, r1, r2):
    """Height RMSE of a pair product against the scene's truth and its
    valid share of the observable canvas (``bench.py``'s pair_accuracy).
    Fails the run on a non-finite or misshaped product."""
    from pcmi_tpu_torch.pipelines.evaluation import truth_on_grid

    valid = prod.valid.cpu().numpy()
    xyz = prod.xyz.cpu().numpy()
    if not (np.isfinite(xyz).all() and xyz.shape == (*r1.shape, 3)):
        raise SystemExit("non-finite or misshaped xyz")
    truth, inb = truth_on_grid(scene, xyz)
    m = valid & inb
    rmse = float(np.sqrt(np.mean((prod.height.cpu().numpy()[m] - truth[m])
                                 ** 2)))
    observable = ((r1 >= 0) & (r2 >= 0)).sum().item()
    return rmse, float(valid.sum() / max(observable, 1))


def phase_d288() -> tuple[dict, D288]:
    """The MAX_DISP = 288 pair at full width (``bench.py``'s d288 scene):
    ``strict`` gated, ``dense`` reported."""
    from pcmi_tpu_torch.config import (
        PipelineConfig, RectifyConfig, StereoConfig)
    from pcmi_tpu_torch.geometry.synthetic import (
        aoi_lonlat_ranges, make_stereo_scene)
    from pcmi_tpu_torch.ops.stereo import kernels as K
    from pcmi_tpu_torch.pipelines.height_map import (
        HeightMapPipeline, pair_core)

    t0 = time.perf_counter()
    scene = make_stereo_scene(
        seed=3, out_shape=(896, 896), ground_shape=(768, 768), gsd=0.2,
        h_range=D288_H_RANGE, views=D288_VIEWS,
        terrain_kwargs=dict(terrain_fraction=0.6, building_size_px=(50, 125),
                            building_h_m=(8.0, 18.0)))
    cfg = PipelineConfig(
        stereo=StereoConfig(block_size=9, census_window=5,
                            margin_undefined=8, disp_stride=2),
        rectify=RectifyConfig(height_range=D288_H_RANGE))
    pipe = HeightMapPipeline(cfg, device="cuda")
    pairs = list(itertools.combinations(range(5), 2))
    geoms = [pipe.build_geometry(scene.rpcs[i], scene.rpcs[j],
                                 *aoi_lonlat_ranges(scene),
                                 tuple(scene.images[i].shape),
                                 tuple(scene.images[j].shape))
             for i, j in pairs]
    strict = pipe.stereo_cfg_for(geoms)
    hc = max(g.out_shape[0] for g in geoms)
    wc = max(g.out_shape[1] for g in geoms)
    ctx = D288(scene, cfg, strict, pairs, geoms, (hc, wc))
    print(f"d288: max_disp {strict.max_disp}, canvas {hc}x{wc}, scene and "
          f"geometry in {time.perf_counter() - t0:.1f} s")
    r1, r2, M, b = _d288_inputs(ctx, 0)

    out = {}
    modes = (("strict", strict, PER_PAIR),
             ("dense", dataclasses.replace(strict, band_check_mode="vertical"),
              PER_DENSE_PAIR))
    for name, scfg, expected in modes:
        def pair():
            return pair_core(r1, r2, M, b, scfg,
                             ground_percentile=cfg.height_percentiles[0],
                             cap_percentile=cfg.height_percentiles[1])

        pair()  # warm-up
        torch.cuda.synchronize()
        K.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        prod = pair()
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        ms = _median_ms(pair, 3)
        rmse, vf = _pair_accuracy(scene, prod, r1, r2)
        out[name] = dict(canvas=[hc, wc], max_disp=scfg.max_disp,
                         height_rmse_m=rmse, valid_fraction=vf,
                         ms_per_pair=ms, peak_mem_mb=peak / 2**20,
                         launches={k: n for k, n in launches.items() if n})
        print(f"d288 {name}:", json.dumps(out[name]))
        if launches != expected:
            raise SystemExit(f"d288 {name}: launches {launches}, expected "
                             f"{expected}")
    if not out["strict"]["height_rmse_m"] <= 1.0:
        raise SystemExit(f"d288 strict: height RMSE "
                         f"{out['strict']['height_rmse_m']} m > 1.0 m")
    if not out["strict"]["valid_fraction"] >= 0.5:
        raise SystemExit(f"d288 strict: valid fraction "
                         f"{out['strict']['valid_fraction']} < 0.5")
    return out, ctx


def _turns(fns: dict, order, reps: int = 3) -> dict:
    """Time the functions of ``fns`` in turns (``order`` names them, each
    turn ``reps`` runs after one warm-up run): all times in ms per name."""
    times = {k: [] for k in fns}
    for k in order:
        fns[k]()
        torch.cuda.synchronize()
        for _ in range(reps):
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return times


def _min_med_max(ts) -> list:
    return [min(ts), statistics.median(ts), max(ts)]


def phase_bf16_pairs(ctx, head: dict, dctx: D288, d288: dict) -> dict:
    """The headline pair and the D = 288 pair under
    ``cost_dtype="bfloat16"``, through the same entry points as phases 4
    and 7 and with their gates: RMSE <= 1.0 m, valid >= 0.5 and 6/3/1
    launches (headline and strict), 8/3/1 and finite (dense). Each is
    printed beside its float32 run, timed in turns float32, bfloat16,
    bfloat16, float32 (min, median and max of six runs each)."""
    from pcmi_tpu_torch.ops.stereo import kernels as K
    from pcmi_tpu_torch.pipelines.height_map import pair_core

    pipe, geom, scfg, img1, img2 = ctx[:5]
    r1, r2, M, b = _d288_inputs(dctx, 0)
    pcts = dict(ground_percentile=dctx.cfg.height_percentiles[0],
                cap_percentile=dctx.cfg.height_percentiles[1])
    dense = dataclasses.replace(dctx.strict, band_check_mode="vertical")

    def b16(cfg):
        return dataclasses.replace(cfg, cost_dtype="bfloat16")

    cells = {
        "headline": (lambda c: pipe.process_pair(img1, img2, geom, c), scfg,
                     head, PER_PAIR),
        "d288_strict": (lambda c: pair_core(r1, r2, M, b, c, **pcts),
                        dctx.strict, d288["strict"], PER_PAIR),
        "d288_dense": (lambda c: pair_core(r1, r2, M, b, c, **pcts), dense,
                       d288["dense"], PER_DENSE_PAIR),
    }
    out = {}
    for name, (run, cfg, f32, expected) in cells.items():
        cfg16 = b16(cfg)
        run(cfg16)  # warm-up
        torch.cuda.synchronize()
        K.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        prod = run(cfg16)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        if name == "headline":
            rmse, vf = _headline_accuracy(ctx, prod)
        else:
            rmse, vf = _pair_accuracy(dctx.scene, prod, r1, r2)
        ts = _turns({"float32": lambda: run(cfg), "bfloat16": lambda: run(cfg16)},
                    ("float32", "bfloat16", "bfloat16", "float32"))
        out[name] = dict(
            height_rmse_m=rmse, valid_fraction=vf, peak_mem_mb=peak / 2**20,
            ms_per_pair=_min_med_max(ts["bfloat16"]),
            launches={k: n for k, n in launches.items() if n},
            float32=dict(height_rmse_m=f32["height_rmse_m"],
                         valid_fraction=f32["valid_fraction"],
                         peak_mem_mb=f32["peak_mem_mb"],
                         ms_per_pair=_min_med_max(ts["float32"])))
        print(f"bfloat16 {name}:", json.dumps(out[name]))
        _launched(f"bfloat16 {name}", launches, expected)
        if name != "d288_dense":
            if not rmse <= 1.0:
                raise SystemExit(f"bfloat16 {name}: height RMSE {rmse} m > "
                                 f"1.0 m")
            if not vf >= 0.5:
                raise SystemExit(f"bfloat16 {name}: valid fraction {vf} < "
                                 f"0.5")
    return out


def _finite_product(prod) -> bool:
    """Every field of a pair product that is defined everywhere is finite
    (``height`` and ``rel_height`` are NaN off the valid pixels)."""
    return all(bool(torch.isfinite(getattr(prod, f)).all())
               for f in ("disparity", "photo", "xyz", "rect_left",
                         "rect_right"))


MAIN_KERNELS = ("sgm_dir", "wta", "derive_right")


@contextlib.contextmanager
def _captured(calls: list):
    """While open, every call of the main path's kernel wrappers (K1
    ``sgm_dir``, K2 ``wta``, K3 ``derive_right``) appends ``(name, args,
    kwargs, result)`` to ``calls``: copies of the tensors it was handed,
    taken before the call (so an accumulating launch's ``out`` as it was),
    and of what the kernel returned. ``sgm_pair`` and the matchers reach
    the wrappers through the module, so every launch passes here."""
    from pcmi_tpu_torch.ops.stereo import kernels as K

    def copy(x):
        if isinstance(x, tuple):
            return tuple(copy(v) for v in x)
        return x.clone() if isinstance(x, torch.Tensor) else x

    def hook(name, fn):
        def call(*args, **kwargs):
            a, kw = copy(args), {k: copy(v) for k, v in kwargs.items()}
            res = fn(*args, **kwargs)
            calls.append((name, a, kw, copy(res)))
            return res
        return call

    orig = {n: getattr(K, n) for n in MAIN_KERNELS}
    try:
        for n, fn in orig.items():
            setattr(K, n, hook(n, fn))
        yield calls
    finally:
        for n, fn in orig.items():
            setattr(K, n, fn)


def _replay_plain(calls: list) -> tuple[dict, list]:
    """Each captured launch against its plain version on the same card
    tensors: the shapes seen per kernel (``"DxHxW": launches``) and the
    launches whose outputs are not all bit-exact."""
    from pcmi_tpu_torch.ops.stereo import kernels as K

    shapes = {n: {} for n in MAIN_KERNELS}
    bad = []
    for name, args, kwargs, got in calls:
        ref = getattr(K, f"{name}_plain")(*args, **kwargs)
        torch.cuda.synchronize()
        pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
        key = "x".join(map(str, args[0].shape))
        shapes[name][key] = shapes[name].get(key, 0) + 1
        if not all((g is None and r is None) or torch.equal(g, r)
                   for g, r in pairs):
            bad.append(f"{name} {key}")
    return {n: v for n, v in shapes.items() if v}, bad


def phase_adaptive_pairs(dctx: D288, d288: dict) -> dict:
    """The D = 288 pair of phase 7 (strict gates) through ``pair_core``
    with the two matchers that narrow the search: banded
    (``adapt_band_rows=64``, ``adapt_band_cols=64``,
    ``adapt_local_disp=96``: a coarse pass at 1/4 scale, then 48 planes at
    stride 2 around per-tile offsets) and hierarchical
    (``hierarchical_local_disp=16``: 72 planes at half resolution, then 8
    around the upsampled base). Each printed beside the full search: RMSE,
    valid fraction, peak memory, launches and ms per pair, timed in turns
    full, banded, hierarchical, hierarchical, banded, full (min, median,
    max of six runs each). Gates: launches as pinned (10/5/2 and 12/6/2),
    every output finite, every launch of K1, K2 and K3 in one more run of
    each matcher bit-exact against its plain version on the tensors that
    matcher handed it (the shapes printed under ``kernel_shapes``),
    banded RMSE <= 1.0 m and valid >= 0.5
    (``tests/test_banded.py``'s), hierarchical valid > 0.08
    (``tests/test_hierarchical.py``'s; its RMSE is printed)."""
    from pcmi_tpu_torch.ops.stereo import kernels as K
    from pcmi_tpu_torch.pipelines.height_map import pair_core

    r1, r2, M, b = _d288_inputs(dctx, 0)
    pcts = dict(ground_percentile=dctx.cfg.height_percentiles[0],
                cap_percentile=dctx.cfg.height_percentiles[1])
    cfgs = {
        "full": dctx.strict,
        "banded": dataclasses.replace(dctx.strict, adapt_band_rows=64,
                                      adapt_band_cols=64,
                                      adapt_local_disp=96),
        "hierarchical": dataclasses.replace(dctx.strict, hierarchical=True,
                                            hierarchical_local_disp=16),
    }
    runs = {k: (lambda c=c: pair_core(r1, r2, M, b, c, **pcts))
            for k, c in cfgs.items()}
    expected = {"banded": PER_BANDED_PAIR, "hierarchical": PER_HIER_PAIR}
    out = {}
    for name in expected:
        runs[name]()  # warm-up
        torch.cuda.synchronize()
        K.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        prod = runs[name]()
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        finite = _finite_product(prod)
        rmse, vf = _pair_accuracy(dctx.scene, prod, r1, r2)
        # one more run, its kernels' inputs and outputs kept, each launch
        # then held against its plain version on the same tensors
        with _captured([]) as calls:
            runs[name]()
        torch.cuda.synchronize()
        shapes, bad = _replay_plain(calls)
        del calls
        out[name] = dict(height_rmse_m=rmse, valid_fraction=vf,
                         peak_mem_mb=peak / 2**20, finite=finite,
                         launches={k: n for k, n in launches.items() if n},
                         plain_exact=not bad, kernel_shapes=shapes)
        if bad:
            print(f"adaptive {name}: not bit-exact against the plain "
                  f"versions: {bad}")
    ts = _turns(runs, ("full", "banded", "hierarchical", "hierarchical",
                       "banded", "full"))
    for name in expected:
        out[name]["ms_per_pair"] = _min_med_max(ts[name])
        print(f"adaptive {name}:", json.dumps(out[name]))
    out["full"] = dict(height_rmse_m=d288["strict"]["height_rmse_m"],
                       valid_fraction=d288["strict"]["valid_fraction"],
                       peak_mem_mb=d288["strict"]["peak_mem_mb"],
                       ms_per_pair=_min_med_max(ts["full"]))
    print("adaptive full:", json.dumps(out["full"]))
    for name, exp in expected.items():
        _launched(f"adaptive {name}", {**NONE, **out[name]["launches"]}, exp)
        if not out[name]["finite"]:
            raise SystemExit(f"adaptive {name}: non-finite output")
        if not out[name]["plain_exact"]:
            raise SystemExit(f"adaptive {name}: a kernel disagrees with its "
                             f"plain version at the matcher's shapes")
    ban, hier = out["banded"], out["hierarchical"]
    if not ban["height_rmse_m"] <= 1.0:
        raise SystemExit(f"adaptive banded: height RMSE "
                         f"{ban['height_rmse_m']} m > 1.0 m")
    if not ban["valid_fraction"] >= 0.5:
        raise SystemExit(f"adaptive banded: valid fraction "
                         f"{ban['valid_fraction']} < 0.5")
    if not hier["valid_fraction"] > 0.08:
        raise SystemExit(f"adaptive hierarchical: valid fraction "
                         f"{hier['valid_fraction']} <= 0.08")
    return out


def _cell_truth(scene, cell: float):
    """The DSM grid over the scene's terrain at ``cell`` metres, its
    cell-centre truth and in-bounds mask (``bench.py``'s fused scoring)."""
    terr = scene.terrain.cpu().numpy()
    hg, wg = terr.shape
    ny, nx = int(hg * scene.ground_gsd / cell), int(wg * scene.ground_gsd / cell)
    gxm, gym = np.meshgrid((np.arange(nx) + 0.5) * cell / scene.ground_gsd,
                           (np.arange(ny) + 0.5) * cell / scene.ground_gsd)
    inb = (gxm < wg - 1) & (gym < hg - 1)
    truth = terr[np.clip(gym.astype(int), 0, hg - 1),
                 np.clip(gxm.astype(int), 0, wg - 1)]
    return (ny, nx), truth, inb


def _launched(name: str, launches: dict, expected: dict) -> None:
    if launches != expected:
        raise SystemExit(f"{name}: launches {launches}, expected {expected}")


def phase_fused_d288(ctx: D288, d288: dict) -> dict:
    """Phase 8: all ten pairs of the D = 288 scene, dense, each into its
    own DSM accumulator (tile-local 3-sigma gate) on the 0.6 m grid, fused
    by the cross-pair median with ``min_pairs=3``, ``mad_max=1.2``,
    ``accept2_delta=0.7`` (``bench.py``'s fused section)."""
    from pcmi_tpu_torch.ops.stereo import kernels as K
    from pcmi_tpu_torch.pipelines.evaluation import pair_observability
    from pcmi_tpu_torch.pipelines.height_map import pair_core
    from pcmi_tpu_torch.pipelines.streaming import (
        dsm_finalize_multi, dsm_update, empty_dsm)

    scene, cell = ctx.scene, 0.6
    dense = dataclasses.replace(ctx.strict, band_check_mode="vertical")
    shape, truth, inb = _cell_truth(scene, cell)
    accs, stats, pair_ms, upd_ms = [], [], [], []
    torch.cuda.synchronize()
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    for idx in range(len(ctx.pairs)):
        r1, r2, M, b = _d288_inputs(ctx, idx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prod = pair_core(r1, r2, M, b, dense, with_plane=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        xyz = prod.xyz.reshape(-1, 3)
        accs.append(dsm_update(empty_dsm(shape, "cuda"), xyz[:, :2],
                               xyz[:, 2], prod.valid.reshape(-1).float(),
                               scene.ground_origin, cell, shape,
                               robust_sigma=3.0))
        torch.cuda.synchronize()
        upd_ms.append((time.perf_counter() - t1) * 1e3)
        pair_ms.append((t1 - t0) * 1e3)
        try:
            stats.append(_pair_accuracy(scene, prod, r1, r2))
        except SystemExit as exc:
            raise SystemExit(f"fused_d288 pair {ctx.pairs[idx]}: {exc}")
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    dsm, _, _ = dsm_finalize_multi(accs, min_pairs=3, mad_max=1.2,
                                   accept2_delta=0.7)
    filled = np.isfinite(dsm) & inb
    err = dsm[filled] - truth[filled]
    rmse = float(np.sqrt(np.mean(err ** 2))) if filled.any() else math.nan
    obs = pair_observability(scene, ctx.pairs, cell, shape)
    comp = {k: float((filled & m).sum() / max(m.sum(), 1))
            for k, m in (("bbox", inb), ("obs1", (obs >= 1) & inb),
                         ("obs2", (obs >= 2) & inb))}
    tail = float((np.abs(err) > 2).mean()) if filled.any() else math.nan
    mean_rmse = float(np.mean([r for r, _ in stats]))
    out = dict(
        pairs=len(stats), grid=list(shape), cell_m=cell,
        pair_rmse_m=[r for r, _ in stats],
        pair_completeness=[c for _, c in stats], mean_pair_rmse_m=mean_rmse,
        mean_pair_completeness=float(np.mean([c for _, c in stats])),
        rmse_m=rmse, completeness=comp["bbox"],
        completeness_obs1=comp["obs1"], completeness_obs2=comp["obs2"],
        tail_gt2m=tail, ms_per_pair=float(np.mean(pair_ms)),
        ms_per_dsm_update=float(np.mean(upd_ms)), peak_mem_mb=peak / 2**20,
        launches={k: n for k, n in launches.items() if n},
        gates={
            "strict_rmse_le_1m": d288["strict"]["height_rmse_m"] <= 1.0,
            "strict_valid_fraction_ge_0.5":
                d288["strict"]["valid_fraction"] >= 0.5,
            "fused_completeness_ge_0.65": comp["bbox"] >= 0.65,
            "fused_completeness_obs2_ge_0.8": comp["obs2"] >= 0.8,
            "fused_rmse_le_1m": rmse <= 1.0,
            "fused_tail_gt2m_le_0.015": tail <= 0.015})
    print("fused_d288:", json.dumps(out))
    _launched("fused_d288", launches,
              {k: 10 * n for k, n in PER_DENSE_PAIR.items()})
    if not rmse < mean_rmse:
        raise SystemExit(f"fused_d288: fused RMSE {rmse} m not below the "
                         f"mean dense pair RMSE {mean_rmse} m")
    if not comp["bbox"] >= 0.65:
        raise SystemExit(f"fused_d288: completeness {comp['bbox']} < 0.65")
    return out


def phase_multiday(ctx: D288) -> dict:
    """Phase 9: ``MultiDayFusion`` (through ``evaluate_fused_dsm``) and
    ``StreamingAOIPipeline`` on the D = 288 scene."""
    from pcmi_tpu_torch.geometry.pairs import ImageMeta
    from pcmi_tpu_torch.geometry.synthetic import aoi_lonlat_ranges
    from pcmi_tpu_torch.ops.pointcloud import grid_fuse
    from pcmi_tpu_torch.ops.stereo import kernels as K
    from pcmi_tpu_torch.pipelines import HeightMapPipeline
    from pcmi_tpu_torch.pipelines import StreamingAOIPipeline
    from pcmi_tpu_torch.pipelines.evaluation import evaluate_fused_dsm

    scene = ctx.scene
    torch.cuda.synchronize()
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = evaluate_fused_dsm(scene, ctx.cfg, D288_VIEWS, n_pairs=10,
                             grid_cell=0.6, points_per_pair=1 << 16,
                             device="cuda", with_kmeans=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    n, st = res["n_pairs"], res["stage_ms"]
    md = dict(
        selected=res["selected"], processed=n, points=n << 16,
        icp_rmse_max_m=res["icp_rmse_max"], rmse_m=res["rmse_m"],
        completeness=res["completeness"],
        stereo_ms_per_pair=st["stereo"] / n,
        icp_ms_per_pair=st["icp"] / max(n - 1, 1), knn_mask_ms=st["knn_mask"],
        dsm_ms=st["dsm"], kmeans_ms=st["kmeans"], run_s=wall,
        peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20,
        launches={k: c for k, c in launches.items() if c})
    print("multiday:", json.dumps(md))
    _launched("multiday", launches, {k: n * c for k, c in PER_PAIR.items()})
    if n != res["selected"]:
        raise SystemExit(f"multiday: {n} pairs processed of "
                         f"{res['selected']} selected")
    if not res["icp_rmse_max"] < 2.0:
        raise SystemExit(f"multiday: ICP residual {res['icp_rmse_max']} m")
    if not res["filled"] >= 0.3 * res["cells"]:
        raise SystemExit(f"multiday: {res['filled']} of {res['cells']} "
                         f"cells filled")

    # streaming: pair (0, 1) as 256-row bands, against the monolithic pair
    # gridded without a gate on the same grid (tests/test_streaming.py).
    # The pair converges at ~59 degrees, beyond the default selection's
    # 45; phases 7 and 8 run it, so the selection limit is lifted here.
    metas = [ImageMeta(i, inc, az, date=20.0 * i)
             for i, (inc, az) in enumerate(D288_VIEWS[:2])]
    scfg = ctx.cfg.replace(pairs=dataclasses.replace(
        ctx.cfg.pairs, max_convergence_deg=90.0))
    aoi = aoi_lonlat_ranges(scene)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    out = StreamingAOIPipeline(scfg, band_rows=256, device="cuda").run(
        scene.images, scene.rpcs, metas, *aoi, grid_cell=2.0, n_pairs=1)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    pipe = HeightMapPipeline(ctx.cfg, device="cuda")
    geom = pipe.build_geometry(scene.rpcs[0], scene.rpcs[1], *aoi,
                               tuple(scene.images[0].shape),
                               tuple(scene.images[1].shape))
    prod = pipe.process_pair(scene.images[0], scene.images[1], geom)
    mono, _ = grid_fuse(prod.xyz[..., :2].reshape(-1, 2),
                        prod.xyz[..., 2].reshape(-1),
                        prod.valid.reshape(-1).float(), out["origin"],
                        out["cell"], out["dsm"].shape, robust_sigma=1e9)
    mono = mono.cpu().numpy()
    both = np.isfinite(out["dsm"]) & np.isfinite(mono)
    diff = np.abs(out["dsm"] - mono)[both]
    sm = dict(tiles=out["tiles"], cells_both=int(both.sum()),
              median_diff_m=float(np.median(diff)) if both.any() else math.nan,
              within_0p5m=float((diff < 0.5).mean()) if both.any() else 0.0,
              run_s=stream_s, launches={k: c for k, c in launches.items() if c})
    print("streaming:", json.dumps(sm))
    _launched("streaming", launches,
              {k: out["tiles"] * c for k, c in PER_PAIR.items()})
    if not (both.sum() > 500 and sm["median_diff_m"] < 0.05
            and sm["within_0p5m"] > 0.9):
        raise SystemExit("streaming: band DSM differs from the monolithic "
                         "one beyond the reference test's bounds")
    return md, sm


LOWTEX_VIEWS = ((12.0, 90.0), (22.0, 260.0), (16.0, 175.0), (26.0, 15.0),
                (19.0, 305.0), (11.0, 215.0), (24.0, 130.0), (14.0, 40.0))


def phase_lowtex(seeds=(11, 12, 13)) -> dict:
    """Phase 10: the low-texture fused recipe (``bench.py``'s lowtex_fused):
    16 "lr"-profile pairs of 8 presmoothed views, cross-pair median with
    ``min_pairs=7`` and ``mad_max=0.7`` on a 2 m grid, per seed."""
    from pcmi_tpu_torch.config import (
        PipelineConfig, RectifyConfig, StereoConfig)
    from pcmi_tpu_torch.geometry.pairs import ImageMeta
    from pcmi_tpu_torch.geometry.synthetic import (
        aoi_lonlat_ranges, make_family_scene)
    from pcmi_tpu_torch.ops.stereo import kernels as K
    from pcmi_tpu_torch.pipelines import fused_consistency_dsm

    h_range, cell = (0.0, 40.0), 2.0
    cfg = PipelineConfig(
        stereo=StereoConfig(block_size=9, census_window=5,
                            margin_undefined=8, gate_profile="lr",
                            presmooth_sigma=1.5),
        rectify=RectifyConfig(height_range=h_range))
    metas = [ImageMeta(i, inc, az, date=20.0 * i)
             for i, (inc, az) in enumerate(LOWTEX_VIEWS)]
    per_seed = []
    torch.cuda.synchronize()
    K.reset_launches()
    for seed in seeds:
        t0 = time.perf_counter()
        scene = make_family_scene("lowtex", seed=seed, out_shape=(448, 448),
                                  ground_shape=(448, 448), h_range=h_range,
                                  views=LOWTEX_VIEWS)
        shape, truth, inb = _cell_truth(scene, cell)
        t1 = time.perf_counter()
        dsm, _, _ = fused_consistency_dsm(
            scene.images, scene.rpcs, metas, *aoi_lonlat_ranges(scene), cfg,
            scene.ground_origin, shape, cell, n_pairs=16, min_pairs=7,
            mad_max=0.7, device="cuda")
        torch.cuda.synchronize()
        filled = np.isfinite(dsm) & inb
        err = dsm[filled] - truth[filled]
        per_seed.append(dict(
            seed=seed, completeness=float(filled.sum() / max(inb.sum(), 1)),
            rmse_m=float(np.sqrt(np.mean(err ** 2))) if filled.any()
            else math.nan, scene_s=t1 - t0,
            fuse_s=time.perf_counter() - t1))
        print(f"lowtex_fused seed {seed}:", json.dumps(per_seed[-1]))
    launches = dict(K.LAUNCHES)
    worst_rmse = max(s["rmse_m"] for s in per_seed)
    worst_comp = min(s["completeness"] for s in per_seed)
    out = {"seeds": per_seed, "worst_rmse_m": worst_rmse,
           "worst_completeness": worst_comp,
           "reference_gate_completeness_ge_0.5": worst_comp >= 0.5,
           "launches": {k: c for k, c in launches.items() if c}}
    print("lowtex_fused:", json.dumps(out))
    if not all(launches[k] >= 16 * len(seeds)
               for k in ("sgm_dir", "wta", "derive_right")) or any(
            launches[k] for k in ("sgm_hwd", "sgm_blocked",
                                  "derive_right_wdh")):
        raise SystemExit(f"lowtex_fused: launches {launches}")
    if not worst_rmse <= 1.0:
        raise SystemExit(f"lowtex_fused: RMSE {worst_rmse} m > 1.0 m")
    if not worst_comp >= 0.4:
        raise SystemExit(f"lowtex_fused: completeness {worst_comp} < 0.4")
    return out


# Phase 11: the D = 288 scene anchored where RPC00B's four decimals of
# LAT_OFF and LONG_OFF hold it exactly, as NITF files on disk
FROM_DISK_ORIGIN = (-58.58, -34.49)
FROM_DISK_SET = ("stereo.block_size=9", "stereo.census_window=5",
                 "stereo.margin_undefined=8", "stereo.disp_stride=2",
                 "rectify.height_range=[0.0,48.0]")


def _write_kml(path: str, lon_r, lat_r) -> None:
    ring = " ".join(f"{lon},{lat},0" for lon, lat in (
        (lon_r[0], lat_r[0]), (lon_r[1], lat_r[0]), (lon_r[1], lat_r[1]),
        (lon_r[0], lat_r[1]), (lon_r[0], lat_r[0])))
    with open(path, "w", encoding="utf-8") as fh:
        fh.write('<?xml version="1.0"?><kml xmlns="http://www.opengis.net/'
                 'kml/2.2"><Placemark><Polygon><outerBoundaryIs><LinearRing>'
                 f"<coordinates>{ring}</coordinates></LinearRing>"
                 "</outerBoundaryIs></Polygon></Placemark></kml>")


def _dsm_gates(name: str, dsm, x0: float, ytop: float, cell: float,
               scene) -> dict:
    """A north-up DSM (row 0 northernmost) against the scene's terrain,
    cell centres sampled as ``tests/test_ingest.py`` does: median |error|
    < 1.0 m and RMSE < 2.5 m, over more than 200 cells."""
    ny, nx = dsm.shape
    cx, cy = np.meshgrid(x0 + (np.arange(nx) + 0.5) * cell,
                         ytop - (np.arange(ny) + 0.5) * cell)
    ox, oy = scene.ground_origin
    terr = scene.terrain.cpu().numpy()
    gx = (cx - ox) / scene.ground_gsd
    gy = (cy - oy) / scene.ground_gsd
    inb = ((gx >= 0) & (gx < terr.shape[1] - 1) & (gy >= 0)
           & (gy < terr.shape[0] - 1))
    tt = terr[np.clip(gy.astype(int), 0, terr.shape[0] - 1),
              np.clip(gx.astype(int), 0, terr.shape[1] - 1)]
    m = np.isfinite(dsm) & inb
    err = dsm[m] - tt[m]
    out = dict(cells=int(m.sum()),
               median_abs_m=float(np.median(np.abs(err))) if m.any()
               else math.nan,
               rmse_m=float(np.sqrt(np.mean(err ** 2))) if m.any()
               else math.nan)
    if not (out["cells"] > 200 and out["median_abs_m"] < 1.0
            and out["rmse_m"] < 2.5):
        raise SystemExit(f"{name}: DSM against the terrain {out}")
    return out


def _cli(argv: list) -> tuple[int, dict, float]:
    """``pcmi_tpu_torch.cli.main(argv)``: its exit code, its JSON summary
    line and its host ms up to ``torch.cuda.synchronize()``."""
    import io
    from contextlib import redirect_stdout

    from pcmi_tpu_torch import cli

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else {}), ms


@contextlib.contextmanager
def _fusions():
    """Every ``MultiDayFusion`` made inside the block (the CLI's ``fuse``
    makes its own), for its ``stage_ms``."""
    from pcmi_tpu_torch.pipelines import multiday

    made, cls = [], multiday.MultiDayFusion

    class Recorded(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    multiday.MultiDayFusion = Recorded
    try:
        yield made
    finally:
        multiday.MultiDayFusion = cls


def phase_from_disk(dctx: D288) -> dict:
    """Phase 11: phase 7's scene as NITF files on disk (RPC00B, USE00A,
    CSEXRA, five dates) with a KML of its extent, through the port's own
    entry points on the card: ``cli.main(["height-map", ...])`` and
    ``["fuse", ...]``, ``MultiAOISweep`` twice over the ingested stack
    with a stage cache, and ``HeightMapExtractor`` through
    ``PluginRunner``."""
    import tempfile

    from pcmi_tpu_torch.geometry.synthetic import (
        aoi_lonlat_ranges, make_stereo_scene)
    from pcmi_tpu_torch.io import native
    from pcmi_tpu_torch.io.crop import crop_window_from_extent
    from pcmi_tpu_torch.io.nitf import (
        csexra_tre, rpc00b_tre, use00a_tre, write_nitf)
    from pcmi_tpu_torch.io.raster import read_geo, read_ply, read_tiff
    from pcmi_tpu_torch.ops.stereo import kernels as K
    from pcmi_tpu_torch.pipelines.height_map import (
        HeightMapExtractor, HeightMapPipeline)
    from pcmi_tpu_torch.pipelines.ingest import (
        discover_acquisitions, prepare_aoi_stack)
    from pcmi_tpu_torch.pipelines.sweep import AOISpec, MultiAOISweep
    from pcmi_tpu_torch.utils.profiling import recording
    from pcmi_tpu_torch.viewer import PluginRunner

    t_phase = time.perf_counter()
    if native.get_library() is None:
        raise SystemExit(f"from_disk: the native I/O library did not load: "
                         f"{native.native_error()}")
    scene = make_stereo_scene(
        seed=3, out_shape=(896, 896), ground_shape=(768, 768), gsd=0.2,
        h_range=D288_H_RANGE, views=D288_VIEWS,
        origin_lonlat=FROM_DISK_ORIGIN,
        terrain_kwargs=dict(terrain_fraction=0.6, building_size_px=(50, 125),
                            building_h_m=(8.0, 18.0)))
    same = all(torch.equal(a, b)
               for a, b in zip(scene.images, dctx.scene.images)) and \
        torch.equal(scene.terrain, dctx.scene.terrain)
    print(f"from_disk: images and terrain at {FROM_DISK_ORIGIN} equal to "
          f"phase 7's: {same}")
    out = dict(images_equal_phase7=same)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        d = os.path.join(tmp, "acq")
        os.makedirs(d)
        t0 = time.perf_counter()
        for i, (inc, az) in enumerate(D288_VIEWS):
            write_nitf(os.path.join(d, f"view_{i}.ntf"),
                       scene.images[i].numpy(),
                       tres=(rpc00b_tre(scene.rpcs[i]) + use00a_tre(inc)
                             + csexra_tre(inc, az)),
                       idatim=f"2019{3 + 2 * i:02d}1{i}103000")
        kml = os.path.join(d, "aoi.kml")
        _write_kml(kml, *aoi_lonlat_ranges(scene))
        out["write_ms"] = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        acqs = discover_acquisitions(d)
        out["discover_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        images, rpcs, metas, lon_r, lat_r = prepare_aoi_stack(
            acqs, kml_path=kml)
        out["prepare_ms"] = (time.perf_counter() - t0) * 1e3
        out["windows"] = [crop_window_from_extent(
            a.meta.rpc, lon_r, lat_r, a.shape, pad=64, align=64).as_list()[:4]
            for a in acqs]
        if len(acqs) != 5 or len(images) != 5 or \
                len({m.date for m in metas}) != 5:
            raise SystemExit(f"from_disk: {len(acqs)} acquisitions, "
                             f"{len(images)} cropped, dates "
                             f"{[m.date for m in metas]}")
        torch.cuda.reset_peak_memory_stats()

        # height-map on the default device
        hm_dir = os.path.join(tmp, "hm")
        K.reset_launches()
        rc, hm, out["height_map_ms"] = _cli(
            ["height-map", "--images", d, "--kml", kml, "--output", hm_dir]
            + [a for kv in FROM_DISK_SET for a in ("--set", kv)])
        launches = dict(K.LAUNCHES)
        print("from_disk height-map:", rc, json.dumps(hm))
        if rc != 0:
            raise SystemExit(f"from_disk: height-map exit code {rc}")
        _launched("from_disk height-map", launches, PER_PAIR)
        height = read_tiff(os.path.join(hm_dir, "height.tif"))
        disp = read_tiff(os.path.join(hm_dir, "disparity.tif"))
        pts, _ = read_ply(os.path.join(hm_dir, "cloud.ply"))
        valid = np.isfinite(height)
        if not (list(height.shape) == hm["canvas"] == list(disp.shape)
                and np.isfinite(disp[valid]).all()
                and valid.mean() == hm["valid_fraction"]
                and len(pts) == hm["points"] and np.isfinite(pts).all()):
            raise SystemExit("from_disk: height-map rasters or cloud")
        dsm_path = os.path.join(hm_dir, "dsm.tif")
        geo = read_geo(dsm_path)
        i, j = (metas[[m.name for m in metas].index(n)].index
                for n in hm["pair"])
        out["height_map"] = dict(
            pair=[i, j], canvas=hm["canvas"],
            valid_fraction=hm["valid_fraction"], points=hm["points"],
            dsm=_dsm_gates("from_disk height-map", read_tiff(dsm_path),
                           *geo["origin"], geo["scale"][0], scene))
        # the same pair in memory: the scene's own views and exact RPCs
        pipe = HeightMapPipeline(dctx.cfg, device="cuda")
        geom = pipe.build_geometry(scene.rpcs[i], scene.rpcs[j],
                                   *aoi_lonlat_ranges(scene),
                                   tuple(scene.images[i].shape),
                                   tuple(scene.images[j].shape))
        prod = pipe.process_pair(scene.images[i], scene.images[j], geom)
        out["height_map"]["in_memory"] = dict(
            canvas=list(geom.out_shape),
            valid_fraction=float(prod.valid.cpu().numpy().mean()))

        # fuse on the default device
        fuse_dir = os.path.join(tmp, "fuse")
        K.reset_launches()
        with _fusions() as made, recording():
            rc, fu, out["fuse_ms"] = _cli(
                ["fuse", "--images", d, "--kml", kml, "--output", fuse_dir]
                + [a for kv in FROM_DISK_SET for a in ("--set", kv)])
        launches = dict(K.LAUNCHES)
        print("from_disk fuse:", rc, json.dumps(fu))
        if rc != 0:
            raise SystemExit(f"from_disk: fuse exit code {rc}")
        n = len(fu["icp_rmse"])
        _launched("from_disk fuse", launches,
                  {k: n * c for k, c in PER_PAIR.items()})
        dsm_path = os.path.join(fuse_dir, "dsm.tif")
        geo = read_geo(dsm_path)
        out["fuse"] = dict(
            pairs=n, points=fu["points"], stage_ms=made[0].stage_ms,
            icp_rmse_max_m=max(fu["icp_rmse"]),
            dsm=_dsm_gates("from_disk fuse", read_tiff(dsm_path),
                           *geo["origin"], geo["scale"][0], scene))

        # the sweep twice with a stage cache: the second run all hits
        sweep = MultiAOISweep(dctx.cfg, cache_dir=os.path.join(tmp, "cache"),
                              device="cuda")
        aoi = [AOISpec("disk", images, rpcs, metas, lon_r, lat_r)]
        runs = []
        for _ in range(2):
            K.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sweep.run(aoi, grid_cell=2.0)
            torch.cuda.synchronize()
            runs.append(dict(dsm=res.fused["disk"].dsm.numpy(),
                             launches=dict(K.LAUNCHES),
                             ms=(time.perf_counter() - t0) * 1e3,
                             hits=sweep.cache.hits,
                             misses=sweep.cache.misses))
        pairs = runs[0]["misses"]
        _launched("from_disk sweep, first run", runs[0]["launches"],
                  {k: pairs * c for k, c in PER_PAIR.items()})
        _launched("from_disk sweep, second run", runs[1]["launches"], NONE)
        same = np.array_equal(runs[0]["dsm"], runs[1]["dsm"], equal_nan=True)
        if not (runs[0]["hits"] == 0 and runs[1]["hits"] == pairs
                and runs[1]["misses"] == pairs and same):
            raise SystemExit(f"from_disk sweep: {runs}, DSMs equal {same}")
        out["sweep"] = dict(pairs=pairs, ms=[r["ms"] for r in runs],
                            second_run_hits=runs[1]["hits"],
                            dsm_identical=same)

        # the plugin through the host's runner, on one pair
        plugin = HeightMapExtractor(HeightMapPipeline(dctx.cfg,
                                                      device="cuda"))
        plugin.set_sources(images, rpcs, lon_r, lat_r)
        runner = PluginRunner(plugin)
        layers: list = []
        K.reset_launches()
        runner.run(pair=(i, j), on_done=layers.extend)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        names = [p["name"] for _, p, _ in layers]
        print("from_disk plugin:", runner.last_error, names)
        _launched("from_disk plugin", launches, PER_PAIR)
        if runner.last_error is not None or not (
                f"disparity [{i}-{j}]" in names
                and f"point cloud [{i}-{j}]" in names):
            raise SystemExit(f"from_disk plugin: {runner.last_error} "
                             f"{names}")
        out["plugin_layers"] = names
    out["peak_mem_mb"] = torch.cuda.max_memory_allocated() / 2**20
    out["phase_s"] = time.perf_counter() - t_phase
    print("from_disk:", json.dumps(out))
    return out


# Phase 12: the component plugins at the sizes users run them, and each on
# a small crop on the card and on the CPU with the same weights and draws
COMPONENT_SEED = 12


def _smooth_texture(rng, h: int, w: int, c: int | None = None,
                    passes: int = 2) -> np.ndarray:
    """Seeded uniform noise smoothed by ``passes`` of a 3-tap blur along
    both axes (the reference tests' ``_texture``), float32 in [0, 1]."""
    t = rng.uniform(0, 1, (h, w) if c is None else (h, w, c))
    for _ in range(passes):
        t = 0.5 * t + 0.25 * np.roll(t, 1, 0) + 0.25 * np.roll(t, 1, 1)
    return t.astype(np.float32)


def _blob_scene(rng, size: int, blobs, bright: float = 1.0) -> np.ndarray:
    """Faint uniform noise with bright square blobs ``(y, x, side)``."""
    img = rng.uniform(0, 0.05, (size, size)).astype(np.float32)
    for y, x, s in blobs:
        img[y:y + s, x:x + s] = bright
    return img


def _two_texture_rgb(rng, size: int) -> np.ndarray:
    """The reference's land-use scene (``tests/test_components2.py``): a
    smooth left half and a noisy right half, as RGB."""
    img = np.zeros((size, size), np.float32)
    img[:, :size // 2] = 0.3
    img[:, size // 2:] = rng.uniform(0, 1, (size, size - size // 2))
    return np.repeat(img[..., None], 3, -1)


def _box_raster(shape, rects) -> np.ndarray:
    """The pixels covered by shapes-layer rectangles (corners (y, x))."""
    out = np.zeros(shape, bool)
    for r in np.asarray(rects).reshape(-1, 4, 2):
        y0, x0 = np.floor(r.min(0)).astype(int)
        y1, x1 = np.ceil(r.max(0)).astype(int)
        out[max(y0, 0):y1, max(x0, 0):x1] = True
    return out


def _shapes_of(layers):
    return [d for d, _, k in layers if k == "shapes"]


def _components_cases(rng, small: bool) -> dict:
    """Per plugin: (create kwargs, run args, run kwargs, context)."""
    cases = {}
    # saliency: 2048x2048 pan, tile 512, pad 64: 16 tiles
    size, tile = (192, 128) if small else (2048, 512)
    side = 12 if small else 32
    # one object per tile, away from the tile's edges (a tile without one
    # is normalised to its own noise peak)
    blobs = [(int((i + 0.25 + 0.5 * fy) * tile),
              int((j + 0.25 + 0.5 * fx) * tile), side)
             for i in range(size // tile) for j in range(size // tile)
             for fy, fx in [rng.uniform(0, 1, 2)]]
    pan = 0.2 + 0.03 * _smooth_texture(rng, size, size, passes=3)
    for y, x, s in blobs:
        pan[y:y + s, x:x + s] += 0.8
    cases["saliency"] = (dict(tile=tile, pad=32 if small else 64), (pan,),
                         {}, dict(blobs=blobs))
    # detection: 2048x2048 pan with planted blobs, tile 640, overlap 0.2
    cells = 2 if small else 4
    blobs = [(int((i + 0.3 + 0.4 * fy) * size / cells),
              int((j + 0.3 + 0.4 * fx) * size / cells),
              (14 if small else 32) + 4 * ((i + j) % 3))
             for i in range(cells) for j in range(cells)
             for fy, fx in [rng.uniform(0, 1, 2)]]
    cases["detection"] = (dict(), (_blob_scene(rng, size, blobs),), {},
                          dict(blobs=blobs))
    # restoration: 1024x1024 RGB hazed by the port's add_degradation
    size = 192 if small else 1024
    clean = 0.15 + 0.7 * _smooth_texture(rng, size, size, 3, passes=3)
    cases["restoration"] = (dict(), (clean,), {}, dict(clean=clean))
    # stitching: two 1024x1024 crops of one 1031x1536 texture at (7, 512)
    h, w, off = (192, 192, (7, 96)) if small else (1024, 1024, (7, 512))
    tex = _smooth_texture(rng, h + off[0] + 1, w + off[1] + 1)
    img2 = tex[off[0]:off[0] + h, off[1]:off[1] + w].copy()
    ctx = dict(offset=off)
    if small:
        # the whole-pixel pair users stitch (crops of one scene), held
        # card against CPU on the mosaics' common region
        ctx["whole_pixel"] = (dict(), (tex[:h, :w],), dict(image2=img2),
                              dict(offset=off))
        # for the card against the CPU on every layer: a sub-pixel shift,
        # so that the canvas's corners fall between pixels (at whole
        # pixels the card's and the CPU's canvases may round one pixel
        # apart), and a brightness ramp that vanishes on one column of the
        # overlap, so that the seam's energy has one clear valley
        img2 = img2.copy()
        fy, fx = 0.37, 0.61
        img2 = ((1 - fy) * (1 - fx) * img2
                + (1 - fy) * fx * tex[off[0]:off[0] + h, off[1] + 1:]
                + fy * (1 - fx) * tex[off[0] + 1:, off[1]:off[1] + w]
                + fy * fx * tex[off[0] + 1:, off[1] + 1:])
        img2 += 0.2 * np.abs(np.arange(w) - w // 4) / w
    tex = tex[:h + off[0], :w + off[1]]
    cases["stitching"] = (dict(), (tex[:h, :w],), dict(image2=img2),
                          dict(ctx, texture=tex))
    # land-use: 1024x1024 RGB, the default 1500 segments, k = 5
    cases["land-use"] = (dict(), (_two_texture_rgb(rng, size),), {}, {})
    # super-resolution: 512x512 RGB -> 2048x2048
    lr_size = 64 if small else 512
    hr = _smooth_texture(rng, 4 * lr_size, 4 * lr_size, 3, passes=8)
    lr = hr.reshape(lr_size, 4, lr_size, 4, 3).mean(axis=(1, 3))
    cases["super-resolution"] = (dict(), (lr,), {}, dict(hr=hr))
    # inpainting: 1024x1024 RGB with a 96x96 hole
    hole = (24, 24) if small else (96, 96)
    img = 0.2 + 0.7 * _smooth_texture(rng, size, size, 3, passes=3)
    y0, x0 = size // 3, size // 2
    img[y0:y0 + hole[0], x0:x0 + hole[1]] = 0.0
    cases["inpainting"] = (dict(), (img,), {},
                           dict(hole=(y0, x0) + hole))
    return cases


def _component_gates(name: str, layers, ctx: dict, args) -> dict:
    """The reference's own assertions for each plugin (tests/
    test_components.py, test_components2.py, test_models.py), scaled to
    phase 12's sizes; raises on a failed gate."""
    out: dict = {}
    data = {p["name"]: d for d, p, _ in layers}
    image = args[0]
    if name == "saliency":
        sal = data["saliency"]
        rects = _shapes_of(layers)
        centres = (np.asarray(rects[0]).mean(axis=1) if rects
                   else np.zeros((0, 2)))
        ratios, found = [], []
        for y, x, s in ctx["blobs"]:
            inside = sal[y:y + s, x:x + s].mean()
            ratios.append(float(inside / sal.mean()))
            cy, cx = y + s / 2, x + s / 2
            found.append(bool(len(centres)) and bool(
                (np.abs(centres - [cy, cx]).max(1) < 32).any()))
        out.update(boxes=len(centres), inside_over_mean=min(ratios),
                   blobs_boxed=f"{sum(found)}/{len(found)}")
        ok = min(ratios) > 3.0 and all(found)
    elif name == "detection":
        # every planted object's centre inside a box, and a box centre
        # within the reference's 12 px (L1) of it, scaled by the slices'
        # 640 / 256 px (the blob detector's saliency is 72 px a side in
        # every slice, so its boxes coarsen with the slice)
        rects = _shapes_of(layers)
        boxes = np.asarray(rects[0]) if rects else np.zeros((0, 4, 2))
        lo = boxes.min(axis=1) if len(boxes) else np.zeros((0, 2))
        hi = boxes.max(axis=1) if len(boxes) else np.zeros((0, 2))
        found, dists = [], []
        for y, x, s in ctx["blobs"]:
            c = np.array([y + s / 2, x + s / 2])
            found.append(bool(((lo <= c) & (c <= hi)).all(1).any()))
            dists.append(float(np.abs((lo + hi) / 2 - c).sum(1).min())
                         if len(boxes) else math.inf)
        out.update(boxes=len(boxes),
                   objects_boxed=f"{sum(found)}/{len(found)}",
                   worst_centre_l1_px=max(dists))
        ok = all(found) and max(dists) < 12 * 640 / 256
    elif name == "restoration":
        hazy = image
        c_hazy = float(hazy.std())
        c_out = float(data["dehazed"].std())
        t = data["transmission"]
        err_in = float(np.abs(hazy - ctx["clean"]).mean())
        err_out = float(np.abs(data["restored"] - ctx["clean"]).mean())
        out.update(contrast_gain=c_out / c_hazy, t_min=float(t.min()),
                   t_max=float(t.max()), mae_hazy=err_in, mae_restored=err_out)
        ok = (c_out > 1.2 * c_hazy and t.min() >= 0.1 and t.max() <= 1.0
              and all(np.isfinite(d).all() for d in data.values()))
    elif name == "stitching":
        res = ctx["result"]
        Hn = res.homography.cpu().numpy().astype(np.float64)
        Hn = Hn / Hn[2, 2]
        dy, dx = ctx["offset"]
        tex = ctx["texture"]
        mosaic = data["mosaic"]
        y0, x0 = res.canvas_offset
        # the canvas is the texture's, give or take the one pixel that a
        # shift a hair under the true one rounds up to
        ok_shape = ((y0, x0) == (0, 0) and all(
            0 <= m - t <= 1 for m, t in zip(mosaic.shape, tex.shape)))
        region = mosaic[:tex.shape[0], :tex.shape[1]]
        err = (np.abs(region - tex)[np.isfinite(region)] if ok_shape
               else np.array([np.inf]))
        # reported, not gated: the share of the texture the mosaic holds
        # within 0.05 (the reference warps the second image with its
        # shift's axes swapped, so only the first image's part matches)
        full = np.abs(region - tex) <= 0.05 if ok_shape else np.zeros(1)
        out.update(n_inliers=int(res.n_inliers), shift_xy=[Hn[0, 2], Hn[1, 2]],
                   canvas=list(mosaic.shape), mosaic_median_err=float(
                       np.median(err)), texture_matched=float(full.mean()))
        ok = (int(res.n_inliers) >= 8 and abs(Hn[0, 2] + dx) <= 1.0
              and abs(Hn[1, 2] + dy) <= 1.0 and ok_shape
              and float(np.median(err)) < 0.05)
    elif name == "land-use":
        cls = data["classification"]
        w = cls.shape[1]
        left = cls[:, : int(w * 0.42)]
        right = cls[:, int(w * 0.58):]
        lm = int(np.bincount(left.reshape(-1)).argmax())
        rm = int(np.bincount(right.reshape(-1)).argmax())
        sp = ctx["result"].superpixels.cpu().numpy()
        n_sp = len(np.unique(sp))
        mean_size = sp.size / n_sp
        out.update(superpixels=n_sp, mean_px=mean_size, modes=[lm, rm],
                   dominance=[float((left == lm).mean()),
                              float((right == rm).mean())])
        ok = (sp.min() >= 0 and sp.max() < 1500 and n_sp > 750
              and mean_size > 0.28 * sp.size / 1500 and cls.min() >= 0
              and cls.max() < 5 and lm != rm
              and out["dominance"][0] > 0.8 and out["dominance"][1] > 0.65
              and np.isfinite(data["pca"]).all())
    elif name == "super-resolution":
        up, sr = data["bicubic 4x"], data["super-res 4x"]
        mse = float(np.mean((up - ctx["hr"]) ** 2))
        psnr = 10 * math.log10(1.0 / max(mse, 1e-12))
        out.update(shape=list(sr.shape), bicubic_psnr_db=psnr)
        ok = (up.shape == sr.shape == ctx["hr"].shape
              and np.isfinite(sr).all() and 0 <= sr.min() and sr.max() <= 1
              and psnr > 25.0)
    else:  # inpainting
        y0, x0, hh, ww = ctx["hole"]
        mask = data["hole mask"].astype(bool)
        want = np.zeros_like(mask)
        want[max(y0 - 2, 0):y0 + hh + 2, max(x0 - 2, 0):x0 + ww + 2] = True
        outside = float(np.abs(data["inpainted"][~mask] - image[~mask]).max())
        inside = data["inpainted"][mask]
        out.update(mask_px=int(mask.sum()), outside_max_err=outside,
                   hole_mean=float(inside.mean()))
        ok = (np.array_equal(mask, want) and outside <= 1e-6
              and np.isfinite(inside).all())
    if not ok:
        raise SystemExit(f"components {name}: gates failed {out}")
    return out


def _component(name: str, device: str, case, ctx: dict):
    """The plugin made once by ``registry.create`` on ``device``, and a
    call that runs it on the case's inputs and returns numpy layers; what
    the plugin computes beneath its layers (the stitch result, the OBIA
    result) goes to ``ctx["result"]`` for the gates."""
    from pcmi_tpu_torch import registry
    from pcmi_tpu_torch.interface import as_numpy_layers

    kw, args, run_kw, _ = case
    plugin = registry.create(name, device=device, **kw)
    inner = {"stitching": (getattr(plugin, "stitcher", None), "stitch"),
             "land-use": (getattr(plugin, "classifier", None),
                          "run_obia_pipeline")}.get(name)
    if inner is not None:
        obj, meth = inner
        call = getattr(obj, meth)

        def recorded(*a, **k):
            ctx["result"] = call(*a, **k)
            return ctx["result"]

        setattr(obj, meth, recorded)
    return lambda: as_numpy_layers(plugin.run(*args, **run_kw))


def _hazed(clean: np.ndarray, device: str) -> np.ndarray:
    from pcmi_tpu_torch.pipelines.restoration import add_degradation

    hazy, _ = add_degradation(torch.from_numpy(clean).to(device),
                              torch.Generator().manual_seed(COMPONENT_SEED),
                              haze_strength=0.6, noise_sigma=0.02)
    return hazy.cpu().numpy()


def _card_vs_cpu(name: str, case) -> dict:
    """The plugin on the card and on the CPU with the same weights and
    draws: continuous outputs within 1e-3, discrete ones (labels, boxes
    as covered pixels, hole masks) equal on >= 99 % of their elements."""
    ctx_g, ctx_c = {}, {}
    g = _component(name, "cuda", case, ctx_g)()
    c = _component(name, "cpu", case, ctx_c)()
    cont, disc = [], []
    if [(p["name"], k) for _, p, k in g] != [(p["name"], k) for _, p, k in c]:
        raise SystemExit(f"components {name}: card and CPU layers differ")
    shape = case[1][0].shape[:2]
    same_sp = True
    if name == "land-use":
        sp_g = ctx_g["result"].superpixels.cpu().numpy()
        sp_c = ctx_c["result"].superpixels.cpu().numpy()
        disc.append(float((sp_g == sp_c).mean()))
        same_sp = sp_g == sp_c
    for (a, p, k), (b, _, _) in zip(g, c):
        if k == "shapes":
            disc.append(float((_box_raster(shape, a)
                               == _box_raster(shape, b)).mean()))
        elif k == "labels" or p["name"] in ("hole mask", "superpixels"):
            disc.append(float((a == b).mean()))
        elif a.shape != b.shape:
            raise SystemExit(f"components {name}: {p['name']} shapes "
                             f"{a.shape} / {b.shape}")
        elif p["name"] == "pca":
            # eigh fixes no eigenvector's sign: a channel may be 1 - x
            for ch in range(3):
                x, y = a[..., ch][same_sp], b[..., ch][same_sp]
                cont.append(float(min(np.abs(x - y).max(),
                                      np.abs(x - (1 - y)).max())))
        else:
            both = np.isfinite(a) & np.isfinite(b)
            disc.append(float((np.isfinite(a) == np.isfinite(b)).mean()))
            scale = max(float(np.abs(b[both]).max()), 1.0) if both.any() \
                else 1.0
            cont.append(float(np.abs(a[both] - b[both]).max()) / scale
                        if both.any() else 0.0)
    if name == "stitching":
        disc.append(float((ctx_g["result"].seam.cpu().numpy()
                           == ctx_c["result"].seam.cpu().numpy()).mean()))
    out = dict(max_rel_err=max(cont) if cont else 0.0,
               min_agree=min(disc) if disc else 1.0)
    if not (out["max_rel_err"] <= 1e-3 and out["min_agree"] >= 0.99):
        raise SystemExit(f"components {name}: card against CPU {out}")
    return out


def _stitch_whole_pixel(case) -> dict:
    """Stitching on the card and on the CPU at a whole-pixel shift. The
    two homographies differ by float32 rounding, and at a whole pixel a
    canvas corner and an edge line of the second image lie within that
    rounding of an integer: the canvases may come out a pixel apart, the
    line may be sampled on one device and not on the other, and the seam
    through the overlap may then take another path. So the mosaics are
    compared pixel by pixel on the region both canvases cover (placed by
    their offsets in the first image's frame): equal within 1e-3 on >= 99 %
    of it, as a discrete output, with the canvases at most a pixel apart
    and the homographies within 1e-3; the largest difference and the rows
    that hold it are reported."""
    ctx_g, ctx_c = {}, {}
    g = {p["name"]: d for d, p, _ in _component("stitching", "cuda", case,
                                                  ctx_g)()}
    c = {p["name"]: d for d, p, _ in _component("stitching", "cpu", case,
                                                  ctx_c)()}
    rg, rc = ctx_g["result"], ctx_c["result"]
    mg, mc = g["mosaic"], c["mosaic"]
    (gy, gx), (cy, cx) = rg.canvas_offset, rc.canvas_offset
    y0, x0 = max(gy, cy), max(gx, cx)
    y1 = min(gy + mg.shape[0], cy + mc.shape[0])
    x1 = min(gx + mg.shape[1], cx + mc.shape[1])
    a = mg[y0 - gy:y1 - gy, x0 - gx:x1 - gx]
    b = mc[y0 - cy:y1 - cy, x0 - cx:x1 - cx]
    both = np.isfinite(a) & np.isfinite(b)
    diff = np.where(both, np.abs(a - b), 0.0)
    Hg = rg.homography.cpu().numpy().astype(np.float64)
    Hc = rc.homography.cpu().numpy().astype(np.float64)
    Hg, Hc = Hg / Hg[2, 2], Hc / Hc[2, 2]
    seam_g, seam_c = rg.seam.cpu().numpy(), rc.seam.cpu().numpy()
    out = dict(canvas=[list(mg.shape), list(mc.shape)],
               canvas_offset=[list(rg.canvas_offset), list(rc.canvas_offset)],
               canvas_diff_px=[abs(p - q) for p, q in zip(mg.shape, mc.shape)],
               common=[y1 - y0, x1 - x0],
               finite_agree=float((np.isfinite(a) == np.isfinite(b)).mean()),
               agree=float((np.isfinite(a) == np.isfinite(b))
                           [diff <= 1e-3].sum() / a.size),
               max_abs_err=float(diff.max()),
               rows_over_1e3=np.unique(np.nonzero(diff > 1e-3)[0]
                                       + y0)[:20].tolist(),
               H_max_rel_diff=float(np.abs(Hg - Hc).max()
                                    / max(np.abs(Hc).max(), 1.0)),
               shift_yx=[[float(Hg[1, 2]), float(Hg[0, 2])],
                         [float(Hc[1, 2]), float(Hc[0, 2])]],
               n_inliers=[int(rg.n_inliers), int(rc.n_inliers)],
               seam_agree=(float((seam_g == seam_c).mean())
                           if seam_g.shape == seam_c.shape else None))
    if not (max(out["canvas_diff_px"]) <= 1 and out["agree"] >= 0.99
            and out["H_max_rel_diff"] <= 1e-3):
        raise SystemExit(f"components stitching: whole-pixel card against "
                         f"CPU {out}")
    return out


def _profiled(fn) -> dict:
    """One run of ``fn`` under ``torch.profiler``: its wall ms (the
    profiler's own host cost included), the device's busy ms (the union of
    its kernel and copy intervals), their ratio, and the three device
    operations that took the most time (by name, ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return dict(wall_ms=wall, busy_ms=busy / 1e3, busy_share=busy / 1e3 / wall,
                device_ops=len(dev), top=[[k[:48], v / 1e3] for k, v in top])


def phase_components(smi: str) -> dict:
    """Phase 12: the seven component plugins through
    ``registry.create(name, device="cuda")`` at the sizes users run them
    (median ms of 3 runs after a warm-up, peak MB, the reference's gates,
    one more run under the profiler for the device's busy share), then
    each on a small crop on the card and on the CPU."""
    from pcmi_tpu_torch.ops.stereo import kernels as K

    t_phase = time.perf_counter()
    full = _components_cases(np.random.default_rng(COMPONENT_SEED), False)
    small = _components_cases(np.random.default_rng(COMPONENT_SEED + 1),
                              True)
    for cases, dev in ((full, "cuda"), (small, "cpu")):
        kw, args, run_kw, ctx = cases["restoration"]
        cases["restoration"] = (kw, (_hazed(args[0], dev),), run_kw, ctx)
    out: dict = {"card": smi}
    K.reset_launches()
    for name, case in full.items():
        ctx = dict(case[3])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # earlier phases' tensors
        # the plugin is built once, as the viewer host and the CLI do, and
        # its build (a U-Net's weights drawn on the host and copied over)
        # is timed apart from its runs
        t0 = time.perf_counter()
        run = _component(name, "cuda", case, ctx)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        ts = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            layers = run()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        row = dict(ms=statistics.median(ts[1:]), warmup_ms=ts[0],
                   build_ms=build_ms,
                   peak_mb=(torch.cuda.max_memory_allocated() - held) / 2**20)
        row["gates"] = _component_gates(name, layers, ctx, case[1])
        row["profile"] = _profiled(run)
        row["card_vs_cpu"] = _card_vs_cpu(name, small[name])
        if name == "stitching":
            row["whole_pixel_card_vs_cpu"] = _stitch_whole_pixel(
                small["stitching"][3]["whole_pixel"])
        out[name] = row
        print(f"components {name}: {json.dumps(_sig(row, 6))} ({smi})")
    # no stereo kernel lies on these paths
    _launched("components", dict(K.LAUNCHES), NONE)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"components: phase {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 13: the trainers and generative restoration
# ---------------------------------------------------------------------------

# the reference benches' sizes (bench_generative.py:104-195, :372-390;
# bench_detector.py); the inpainting budgets are cut (:func:`_train_inpaint`)
TRAIN = dict(
    sr_steps=2500, sr_size=96, sr_batch=8,
    inpaint_steps=2000, inpaint_gan_steps=4000,
    inpaint_widths=(48, 96, 192, 384), inpaint_size=96,
    inpaint_batch=8,
    dip_iters=300, dip_size=96, plugin_size=192,
    obb_steps=1500, obb_batch=16, obb_size=128, obb_eval=64,
    tile_steps=300, tile_scene=512,
    # card against CPU: CMP_STEPS steps of each trainer at these batches
    cmp_batch=2, cmp_size=64)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _peak_start() -> int:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak_mb(held: int) -> float:
    return (torch.cuda.max_memory_allocated() - held) / 2**20


def _steps(step, n: int):
    """``step(i)`` for i < n: (seconds, ms per step) up to a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        step(i)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    return s, s * 1e3 / max(n, 1)


def reference_draws() -> dict:
    """The reference benches' own draws, written by ``python3 train_probe.py
    export`` into ``reference_draws.npz`` beside this script: the scene
    seeds of ``bench_generative``'s pool (``inpaint_pool_seeds``) and
    held-out sets (``sr_eval_seeds``, ``inpaint_eval_seeds`` (3, 8)), its
    held-out hole masks (``inpaint_eval_masks``, (3, 8, 96, 96) as bits
    along the last axis) and ``bench_detector``'s 64 held-out OBB scenes
    (``obb_*``: :func:`render_obb_batch`'s draws). The scenes themselves
    are numpy draws from those seeds in both packages."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "reference_draws.npz")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def inpaint_eval_sets(draws: dict, dev: str) -> list:
    """``bench_inpaint``'s held-out sets: (images, (B, H, W, 1) masks)."""
    from pcmi_tpu_torch.models.scenes import scene_batch

    size = TRAIN["inpaint_size"]
    out = []
    for seeds, bits in zip(draws["inpaint_eval_seeds"],
                           draws["inpaint_eval_masks"]):
        mask = np.unpackbits(bits, axis=-1)[..., :size].astype(np.float32)
        out.append((scene_batch(seeds, size, dev),
                    torch.from_numpy(mask[..., None]).to(dev)))
    return out


def inpaint_gains(trainer, state, sets: list, ensemble: bool) -> dict:
    """In-hole PSNR of the trained generator and of the 128-iteration
    Jacobi prefill on each held-out set, their differences (dB) and the
    composite SSIMs (``bench_inpaint``'s evaluation)."""
    from pcmi_tpu_torch.models.metrics import psnr, ssim
    from pcmi_tpu_torch.ops.filters import masked_jacobi_fill_batch

    rows = []
    for imgs, mask in sets:
        out = trainer.infer(state, imgs, mask, ensemble=ensemble)
        pre = masked_jacobi_fill_batch(imgs, mask[..., 0], 128)
        rows.append((float(psnr(out, imgs, mask=mask)),
                     float(psnr(pre, imgs, mask=mask)),
                     float(ssim(torch.where(mask > 0.5, out, imgs), imgs)),
                     float(ssim(torch.where(mask > 0.5, pre, imgs), imgs))))
    p, pre, s, s_pre = (np.asarray(c) for c in zip(*rows))
    g = p - pre
    return dict(inpaint_psnr=float(p.mean()), prefill_psnr=float(pre.mean()),
                gain_db=float(g.mean()), gain_db_min=float(g.min()),
                gain_db_std=float(g.std()), gains_db=g.tolist(),
                ssim=float(s.mean()), ssim_prefill=float(s_pre.mean()))


def obb_map50(detect, batches) -> tuple:
    """mAP50 (and its counts) of ``detect`` over ``batches`` of (images,
    obbs, valid), the detections scored above 0.25 (``bench_detector``)."""
    from pcmi_tpu_torch.models.detector_eval import map50

    dets, gts = [], []
    for imgs, obbs, valid in batches:
        got = detect(imgs).cpu().numpy()
        obbs, valid = obbs.cpu().numpy(), valid.cpu().numpy()
        for i in range(len(got)):
            dets.append(got[i][got[i][:, 5] > 0.25])
            gts.append(obbs[i][valid[i]])
    ap, stats = map50(dets, gts)
    stats.pop("pr_curve")
    return ap, stats


def obb_bench_scenes(draws: dict, dev: str):
    """``bench_detector``'s 64 held-out hard scenes, rendered by the port
    from the reference's draws, in batches of 8."""
    from pcmi_tpu_torch.models.detector import render_obb_batch

    obb = {k[4:]: v for k, v in draws.items() if k.startswith("obb_")}
    for i in range(0, len(obb["cy"]), 8):
        yield render_obb_batch(
            TRAIN["obb_size"],
            {k: torch.from_numpy(v[i:i + 8]).to(dev) for k, v in obb.items()},
            hard=True)


def _train_sr(dev: str) -> dict:
    """``bench_generative.bench_sr``: the default ``SRGANTrainer`` (GAN off:
    its warm-up is the whole budget) on the bench's pool of 48 scenes,
    then its held-out scenes against bicubic (the reference's scene seeds,
    :func:`reference_draws`)."""
    from pcmi_tpu_torch.models.metrics import psnr
    from pcmi_tpu_torch.models.scenes import sample_batch, scene_batch
    from pcmi_tpu_torch.models.training import (
        SRGANTrainer, SRTrainConfig, make_sr_pairs)
    from pcmi_tpu_torch.models.unet import bicubic_upsample

    T = TRAIN
    held = _peak_start()
    trainer = SRGANTrainer(SRTrainConfig(warmup_steps=max(T["sr_steps"], 1)),
                           device=dev)
    draws = reference_draws()
    pool = scene_batch(draws["inpaint_pool_seeds"], T["sr_size"], dev)
    box = [trainer.init(None, _gen(1))]
    rng = _gen(0)

    def step(_):
        lr_b, hr_b = make_sr_pairs(sample_batch(pool, T["sr_batch"], rng))
        box[0], _m = trainer.train_step(box[0], lr_b, hr_b)

    s, ms = _steps(step, T["sr_steps"])
    lr_t, hr_t = make_sr_pairs(scene_batch(draws["sr_eval_seeds"],
                                           T["sr_size"], dev))
    p_sr = float(psnr(trainer.infer(box[0], lr_t), hr_t))
    p_bi = float(psnr(bicubic_upsample(lr_t, 4), hr_t))
    out = dict(steps=T["sr_steps"], train_s=s, ms_step=ms,
               peak_mb=_peak_mb(held), sr_psnr=p_sr, bicubic_psnr=p_bi,
               gain_db=p_sr - p_bi,
               profile=_profiled(lambda: [step(0) for _ in range(5)]))
    if not out["gain_db"] > 0:
        raise SystemExit(f"training sr: SR below bicubic {out}")
    return out


def _train_inpaint(dev: str, gan: bool):
    """``bench_generative.bench_inpaint`` on the bench's pool of 48 scenes,
    scored on its 3 held-out sets (the reference's scenes and hole masks,
    :func:`reference_draws`) against the 128-iteration Jacobi prefill
    in-hole, with the flip ensemble and without. ``gan=False``: the gated
    run, the bench's widths (48-384) with cosine decay over 2,000 steps and
    without the GAN term (the reference's tier-1 gate setting); every set
    must beat the prefill with the ensemble. ``gan=True``: the
    configuration of the bench's 12,000-step record (the trainer's
    defaults: widths 32-256, GAN term 0.1, constant learning rate), cut to
    ``inpaint_gan_steps`` and reported: runs of it on the card with the
    same code and seeds spread over about 2 dB, from below the prefill to
    the record's gain (PERF.md §6), so one run cannot carry the gate."""
    from pcmi_tpu_torch.models.scenes import sample_batch, scene_batch
    from pcmi_tpu_torch.models.training import (
        InpaintGANTrainer, InpaintTrainConfig)
    from pcmi_tpu_torch.models.unet import InpaintUNet

    T = TRAIN
    b = T["inpaint_batch"]
    draws = reference_draws()
    held = _peak_start()
    if gan:
        steps = T["inpaint_gan_steps"]
        trainer = InpaintGANTrainer(InpaintTrainConfig(), device=dev)
    else:
        steps = T["inpaint_steps"]
        trainer = InpaintGANTrainer(
            InpaintTrainConfig(total_steps=steps, w_gan=0.0),
            generator=InpaintUNet(widths=T["inpaint_widths"]), device=dev)
    pool = scene_batch(draws["inpaint_pool_seeds"], T["inpaint_size"], dev)
    box = [trainer.init(None, _gen(1))]
    rng = _gen(0)

    def step(_):
        box[0], _m = trainer.train_step(box[0], sample_batch(pool, b, rng),
                                        rng)

    s, ms = _steps(step, steps)
    sets = inpaint_eval_sets(draws, dev)
    ens = inpaint_gains(trainer, box[0], sets, ensemble=True)
    plain = inpaint_gains(trainer, box[0], sets, ensemble=False)
    out = dict(steps=steps, w_gan=trainer.cfg.w_gan, train_s=s, ms_step=ms,
               peak_mb=_peak_mb(held), **ens, plain={k: plain[k] for k in (
                   "inpaint_psnr", "gain_db", "gain_db_min", "gains_db")},
               profile=_profiled(lambda: [step(0) for _ in range(5)]))
    if not (gan or ens["gain_db_min"] > 0):
        raise SystemExit(f"training inpaint: a set below the prefill {out}")
    return out, trainer, box[0]


def _train_dip(dev: str) -> dict:
    """``bench_generative.bench_dip``: ``DIPConfig(iters=300).enhance`` of
    a 96² scene with N(0, 0.1²) noise against the noisy input."""
    from pcmi_tpu_torch.models.dip import DIPConfig, DIPEngine
    from pcmi_tpu_torch.models.metrics import psnr
    from pcmi_tpu_torch.models.scenes import make_scene_rgb

    T = TRAIN
    clean = torch.from_numpy(make_scene_rgb(70_000, T["dip_size"])).to(dev)
    noise = torch.randn(clean.shape, generator=_gen(70_001)).to(dev)
    noisy = torch.clamp(clean + 0.1 * noise, 0.0, 1.0)
    held = _peak_start()
    engine = DIPEngine(DIPConfig(iters=T["dip_iters"]), device=dev)
    box = []
    s, _ms = _steps(lambda _: box.append(engine.enhance(noisy)), 1)
    res = box[0]
    p_out = float(psnr(res.output, clean))
    p_in = float(psnr(noisy, clean))
    losses = res.losses.cpu().numpy()
    out = dict(iters=T["dip_iters"], train_s=s,
               ms_step=s * 1e3 / T["dip_iters"], peak_mb=_peak_mb(held),
               dip_psnr=p_out, noisy_psnr=p_in, gain_db=p_out - p_in,
               loss_first=float(losses[0]), loss_last=float(losses[-1]))
    if not out["gain_db"] > 0:
        raise SystemExit(f"training dip: no denoising {out}")
    return out


def _train_plugin(dev: str) -> dict:
    """``registry.create("generative-restoration", device=...)`` on an
    RGB scene with a NaN hole: finite, every pixel outside the hole and
    its margin kept bit for bit."""
    from pcmi_tpu_torch import registry
    from pcmi_tpu_torch.models.scenes import make_scene_rgb
    from pcmi_tpu_torch.pipelines.generative import nan_mask

    size = TRAIN["plugin_size"]
    img = make_scene_rgb(71_000, size)
    img[size // 2 - 12: size // 2 + 12, size // 3: size // 3 + 24] = np.nan
    held = _peak_start()
    plugin = registry.create("generative-restoration", device=dev)
    box = []
    s, _ms = _steps(lambda _: box.append(plugin.run(img)), 1)
    restored = box[0][1][0]
    keep = ~nan_mask(img, 10, dev)
    out = dict(run_s=s, peak_mb=_peak_mb(held),
               finite=bool(np.isfinite(restored).all()),
               kept=bool(np.array_equal(restored[keep], img[keep])),
               hole_px=int((~keep).sum()))
    if not (out["finite"] and out["kept"]
            and [p["name"] for _, p, _ in box[0]] == ["input", "restored"]):
        raise SystemExit(f"training plugin: {out}")
    return out


def _train_obb(dev: str) -> dict:
    """``bench_detector.py``: ``OBBDetectorTrainer(lr=1e-3)`` on a fresh
    hard batch each step, then mAP50 over the bench's 64 held-out scenes,
    rendered from the reference's own draws (:func:`obb_bench_scenes`; the
    reference scores 0.9476 on them, ``BENCH_DETECTOR.json``), and, as a
    second reading, over 64 held-out scenes that the port draws (seed
    10,000)."""
    from pcmi_tpu_torch.models.detector import (
        DetectorTrainConfig, OBBDetectorTrainer, synthesize_obb_batch)

    T = TRAIN
    held = _peak_start()
    trainer = OBBDetectorTrainer(DetectorTrainConfig(lr=1e-3), device=dev)
    net, opt = trainer.init(None, _gen(1))
    rng = _gen(0)
    last = []

    def step(i):
        batch = synthesize_obb_batch(rng, T["obb_batch"], T["obb_size"],
                                     hard=True, device=dev)
        _n, _o, m = trainer.train_step(net, opt, *batch)
        if i == T["obb_steps"] - 1:
            last.append(m["loss"])

    s, ms = _steps(step, T["obb_steps"])
    detect = trainer.make_obb_detector(net, max_boxes=8, score_thresh=0.25)
    ap, stats = obb_map50(detect, obb_bench_scenes(reference_draws(), dev))
    erng = _gen(10_000)
    ap_port, _ = obb_map50(detect, [
        synthesize_obb_batch(erng, 8, T["obb_size"], hard=True, device=dev)
        for _ in range(T["obb_eval"] // 8)])
    out = dict(steps=T["obb_steps"], train_s=s, ms_step=ms,
               peak_mb=_peak_mb(held), final_loss=float(last[0]),
               map50=ap, map50_port_scenes=ap_port, **stats,
               profile=_profiled(lambda: [step(0) for _ in range(5)]))
    if not ap >= 0.9:
        raise SystemExit(f"training obb: mAP50 below 0.9 {out}")
    return out


def _train_tile(dev: str) -> dict:
    """``make_tile_detector`` of a briefly trained ``DetectorTrainer``
    driving the port's ``ObjectDetector`` over a larger scene in tiles of
    128: it runs end to end; how many objects it finds is reported."""
    from pcmi_tpu_torch.models.detector import (
        DetectorTrainer, synthesize_detection_batch)
    from pcmi_tpu_torch.pipelines.detection import ObjectDetector

    T = TRAIN
    trainer = DetectorTrainer(device=dev)
    net, opt = trainer.init(None, _gen(2))
    rng = _gen(3)

    def step(_):
        trainer.train_step(net, opt, *synthesize_detection_batch(
            rng, 16, 128, device=dev))

    s, ms = _steps(step, T["tile_steps"])
    scene, boxes, valid = synthesize_detection_batch(
        _gen(99), 1, T["tile_scene"], max_objects=24, device=dev)
    driver = ObjectDetector(detector=trainer.make_tile_detector(
        net, score_thresh=0.2), tile=128, score_thresh=0.2, device=dev)
    t0 = time.perf_counter()
    det = driver.detect(scene[0, :, :, 0].cpu().numpy())
    detect_ms = (time.perf_counter() - t0) * 1e3
    gt = boxes[0][valid[0]].cpu().numpy()
    gt_c = (gt[:, :2] + gt[:, 2:]) / 2
    got_c = (det.boxes[:, :2] + det.boxes[:, 2:]) / 2
    near = (np.abs(gt_c[:, None] - got_c[None]).sum(-1).min(1) < 12
            if len(got_c) else np.zeros(len(gt_c), bool))
    out = dict(steps=T["tile_steps"], train_s=s, ms_step=ms,
               detect_ms=detect_ms, boxes=len(det.boxes), objects=len(gt),
               found=float(near.mean()))
    if not (len(det.boxes) and np.isfinite(det.boxes).all()):
        raise SystemExit(f"training tile detector: {out}")
    return out


def _norm_biases(net) -> set:
    """Biases that an instance norm follows: no output depends on them,
    so Adam moves them by rounding noise scaled to a full step."""
    from pcmi_tpu_torch.models.unet import ConvBlock, PatchDiscriminator

    out = set()
    for name, m in net.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, ConvBlock) and m.norm:
            out |= {pre + "conv0.bias", pre + "conv1.bias"}
        if isinstance(m, PatchDiscriminator):
            out |= {f"{pre}convs.{i}.bias" for i in range(1, len(m.convs))}
    return out


def _grads(net) -> dict:
    """Each parameter's gradient of the last step, on the host."""
    return {k: p.grad.detach().cpu().clone()
            for k, p in net.named_parameters()}


def _close(cpu_net, card_net, grads_cpu: dict, grads_card: dict,
           lr: float) -> dict:
    """The card's network against the CPU's: the first step's gradients,
    leaf by leaf, as ``|card - cpu| / |cpu|`` (L2 norms; the worst leaf is
    ``grad_rel``), and after the last step the share of the parameters
    within half an Adam step (``lr / 2``) of each other and the largest
    difference. The biases an instance norm follows are left out of both:
    no output depends on them, so their gradient is rounding alone, which
    Adam scales to a full step."""
    null = _norm_biases(cpu_net)
    card = dict(card_net.named_parameters())
    worst, close, total, grad_rel = 0.0, 0, 0, 0.0
    for k, v in cpu_net.named_parameters():
        if k in null:
            continue
        d = (card[k].detach().cpu() - v.detach()).abs()
        worst = max(worst, float(d.max()))
        close += int((d <= lr / 2).sum())
        total += d.numel()
        g = grads_cpu[k]
        grad_rel = max(grad_rel, float((grads_card[k] - g).norm())
                       / max(float(g.norm()), 1e-30))
    return dict(grad_rel=grad_rel, share=close / total, max_diff=worst)


# card against CPU over CMP_STEPS steps from one state, per case: the
# first step's largest loss difference, the worst leaf's first-step
# gradient gap (:func:`_close`) and the least share of parameters within
# half an Adam step after the last step (bounds set from the card's
# readings with margin, PERF.md §6). The inpainting GAN on bfloat16-rounded
# inputs (its default) parts further: a generator output the devices
# compute an ulp apart may round to bfloat16 values 2**-8 apart, and D's
# gradient there with it. DIP's output is compared after one step.
CMP_STEPS = 3
CMP_BOUNDS = {
    "inpaint_f32": (1e-4, 5e-3, 0.98),
    "inpaint_bf16": (2e-4, 5e-2, 0.9),
    "sr": (1e-4, 1e-4, 0.999),
    "obb": (1e-4, 5e-4, 0.999),
    "detector": (1e-4, 1e-3, 0.999),
    "dip": (1e-4, 1e-2, 0.9),
}
CMP_DIP_OUT = 0.1


def _train_card_vs_cpu(dev: str) -> dict:
    """CMP_STEPS steps of each trainer (and of DIP) from one state on one
    batch stream on the card and on the CPU, each held to its
    ``CMP_BOUNDS`` row; the later steps' losses are reported."""
    import copy

    from pcmi_tpu_torch.models.detector import (
        DetectorTrainConfig, DetectorTrainer, OBBDetectorTrainer,
        synthesize_detection_batch, synthesize_obb_batch)
    from pcmi_tpu_torch.models.dip import DIPConfig, DIPEngine
    from pcmi_tpu_torch.models.losses import random_hole_masks
    from pcmi_tpu_torch.models.scenes import make_pool
    from pcmi_tpu_torch.models.training import (
        InpaintGANTrainer, InpaintTrainConfig, SRGANTrainer, SRTrainConfig,
        make_sr_pairs)
    from pcmi_tpu_torch.models.unet import InpaintUNet, _init_params

    T = TRAIN
    b, size = T["cmp_batch"], T["cmp_size"]
    out = {}

    def losses_close(mc, mg):
        return max(abs(float(mc[k]) - float(mg[k])) for k in mc)

    def lr_of(opt):
        return opt.param_groups[0]["lr"]

    def judge(name, row, nets):
        lim_loss, lim_grad, lim_share = CMP_BOUNDS[name]
        row["ok"] = (row["loss_first"] <= lim_loss
                     and all(row[n]["grad_rel"] <= lim_grad
                             and row[n]["share"] >= lim_share for n in nets))
        out[name] = row

    def gan(name, make, batches):
        tc, tg = make("cpu"), make(dev)
        sc = tc.init(None, _gen(7))
        sg = tg.optimizers(copy.deepcopy(sc.g).to(dev),
                           copy.deepcopy(sc.d).to(dev))
        step = "_step" if name.startswith("inpaint") else "train_step"
        diffs, first = [], None
        for args in batches:
            sc, mc = getattr(tc, step)(sc, *args)
            sg, mg = getattr(tg, step)(sg, *(a.to(dev) for a in args))
            diffs.append(losses_close(mc, mg))
            first = first or {n: (_grads(getattr(sc, n)),
                                  _grads(getattr(sg, n))) for n in "gd"}
        judge(name, dict(loss_first=diffs[0], loss_diff=max(diffs), **{
            n: _close(getattr(sc, n), getattr(sg, n), *first[n],
                      lr_of(getattr(sc, f"{n}_opt"))) for n in "gd"}), "gd")

    imgs = [make_pool(5 + i, b, size, "cpu") for i in range(CMP_STEPS)]
    masks = [random_hole_masks(_gen(8 + i), (b, size, size), 6, 10,
                               device="cpu") for i in range(CMP_STEPS)]
    for name, dtype in (("inpaint_f32", "float32"),
                        ("inpaint_bf16", "bfloat16")):
        gan(name, lambda d: InpaintGANTrainer(
            InpaintTrainConfig(total_steps=T["inpaint_steps"],
                               compute_dtype=dtype),
            generator=InpaintUNet(widths=T["inpaint_widths"]), device=d),
            list(zip(imgs, masks)))
    gan("sr", lambda d: SRGANTrainer(SRTrainConfig(warmup_steps=0), device=d),
        [make_sr_pairs(x) for x in imgs])

    for name, make, synth in (
            ("obb", lambda d: OBBDetectorTrainer(DetectorTrainConfig(lr=1e-3),
                                                 device=d),
             lambda r: synthesize_obb_batch(r, 4, 128, hard=True,
                                            device="cpu")),
            ("detector", lambda d: DetectorTrainer(device=d),
             lambda r: synthesize_detection_batch(r, 4, 128, device="cpu"))):
        tc, tg = make("cpu"), make(dev)
        nc, oc = tc.init(None, _gen(10))
        ng = copy.deepcopy(nc).to(dev)
        og = tg.optimizer(ng)
        rng, diffs, first = _gen(9), [], None
        for _ in range(CMP_STEPS):
            batch = synth(rng)
            nc, oc, mc = tc.train_step(nc, oc, *batch)
            ng, og, mg = tg.train_step(ng, og, *(t.to(dev) for t in batch))
            diffs.append(losses_close(mc, mg))
            first = first or (_grads(nc), _grads(ng))
        judge(name, dict(loss_first=diffs[0], loss_diff=max(diffs),
                         net=_close(nc, ng, *first, lr_of(oc))), ["net"])

    # DIP from one noise input, weights and jitter: one step for the
    # gradients and the output, CMP_STEPS for the parameters
    img = imgs[0][0]
    known = torch.ones(img.shape[:2], dtype=torch.bool)
    known[size // 4: size // 2, size // 4: size // 2] = False
    rng = _gen(11)
    cfg = DIPConfig(iters=CMP_STEPS)
    z0 = 0.1 * torch.randn((1, size, size, cfg.noise_channels), generator=rng)
    net = copy.deepcopy(DIPEngine(cfg, device="cpu").model)
    _init_params(net, rng)
    jit = [torch.randn(z0.shape, generator=rng) for _ in range(CMP_STEPS)]
    one = DIPConfig(iters=1)
    nets = [copy.deepcopy(net) for _ in range(4)]
    o1c, l1c = DIPEngine(one, device="cpu")._fit(img, known, z0, nets[0],
                                                 jit[:1])
    o1g, l1g = DIPEngine(one, device=dev)._fit(img, known, z0, nets[1],
                                               jit[:1])
    _oc, lc = DIPEngine(cfg, device="cpu")._fit(img, known, z0, nets[2], jit)
    _og, lg = DIPEngine(cfg, device=dev)._fit(img, known, z0, nets[3], jit)
    row = dict(loss_first=float((l1c - l1g.cpu()).abs().max()),
               loss_diff=float((lc - lg.cpu()).abs().max()),
               out_diff=float((o1c - o1g.cpu()).abs().max()),
               net=_close(nets[2], nets[3], _grads(nets[0]), _grads(nets[1]),
                          cfg.lr))
    judge("dip", row, ["net"])
    row["ok"] = row["ok"] and row["out_diff"] <= CMP_DIP_OUT
    bad = [k for k, v in out.items() if not v["ok"]]
    if bad:
        raise SystemExit(f"training card against CPU: {bad} {out}")
    return out


def _train_checkpoint(trainer, state) -> dict:
    """``save_checkpoint`` / ``restore_checkpoint`` of the trained
    inpainting state on the card: every tensor bit-equal, the step kept,
    and a step from the restored state finite."""
    from pcmi_tpu_torch.models.scenes import make_pool
    from pcmi_tpu_torch.models.training import (
        restore_checkpoint, save_checkpoint)

    os.makedirs("build", exist_ok=True)
    path = os.path.join("build", "chip_smoke_inpaint.pt")
    t0 = time.perf_counter()
    save_checkpoint(path, state)
    template = trainer.init(None, _gen(12))
    back = restore_checkpoint(path, template)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3

    def leaves(s):
        out = [v for n in (s.g, s.d) for v in n.state_dict().values()]
        for o in (s.g_opt, s.d_opt):
            for st in o.state_dict()["state"].values():
                out += [st[k] for k in sorted(st)]
        return out

    same = all(torch.equal(a, c) for a, c in zip(leaves(state), leaves(back)))
    imgs = make_pool(13, 2, TRAIN["inpaint_size"], trainer.device)
    _s, m = trainer.train_step(back, imgs, _gen(14))
    out = dict(ms=ms, mb=os.path.getsize(path) / 2**20, equal=same,
               step=back.step, resumed_loss=float(m["g_loss"]))
    os.remove(path)
    if not (same and back.step == state.step
            and np.isfinite(out["resumed_loss"])):
        raise SystemExit(f"training checkpoint: {out}")
    return out


def phase_training(smi: str) -> dict:
    """Phase 13: the trainers, DIP and generative restoration on the card
    at the reference benches' widths, each with its gate, training seconds,
    ms per step and peak MB; then the card against the CPU, a checkpoint
    round trip and the registry. No stereo kernel launches."""
    from pcmi_tpu_torch import registry
    from pcmi_tpu_torch.ops.stereo import kernels as K

    t_phase = time.perf_counter()
    K.reset_launches()
    out: dict = {"card": smi}
    cases = (("sr", _train_sr),
             ("inpaint", lambda d: _train_inpaint(d, gan=False)),
             ("inpaint_gan", lambda d: _train_inpaint(d, gan=True)),
             ("dip", _train_dip), ("plugin", _train_plugin),
             ("obb", _train_obb), ("tile", _train_tile))
    inpaint = None
    for name, fn in cases:
        row = fn("cuda")
        if name.startswith("inpaint"):
            row, *state = row
            inpaint = inpaint or state
        out[name] = row
        print(f"training {name}: {json.dumps(_sig(row, 6))} ({smi})")
    out["card_vs_cpu"] = _train_card_vs_cpu("cuda")
    print(f"training card_vs_cpu: {json.dumps(_sig(out['card_vs_cpu'], 4))}")
    out["checkpoint"] = _train_checkpoint(*inpaint)
    print(f"training checkpoint: {json.dumps(_sig(out['checkpoint'], 6))}")
    fails = registry.failures()
    if fails:
        raise SystemExit(f"training: registry failures {sorted(fails)}")
    out["registry"] = registry.available()
    _launched("training", dict(K.LAUNCHES), NONE)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"training: phase {out['phase_s']:.1f} s, registry "
          f"{len(out['registry'])} plugins, none failing")
    return out



# ---------------------------------------------------------------------------
# phase 14: tiled diffusion (bench_generative.bench_diffusion, uncut)
# ---------------------------------------------------------------------------

# bench_generative.py:249-369: the engine, the widths, the budget, the
# batch, the hole masks and the evaluation of bench_diffusion; the gates
# (:413-417) hold on its seed 0, seeds 1-2 are reported beside it
DIFFUSION = dict(
    steps=4000, size=64, batch=16, lr=2e-3, widths=(16, 32, 64),
    sample_steps=18, tile=32, stride=24, timesteps=400, dropout=0.1,
    hole_seeds=8, hole_steps=16, seeds=(0, 1, 2), gated_seed=0,
    plugin_size=1024, enhance_size=512, cmp_batch=4)
DIFFUSION_PROMPTS = {"fields": "dark farm fields",
                     "urban": "bright urban blocks"}
# card against CPU on shared weights and draws: one training step's loss
# (absolute), the whole gradient's gap and the worst leaf's (each relative
# to its norm; the biases an instance norm follows left out), the DDIM and
# DPM++ fills with guidance 3 (largest absolute difference). Readings
# (``train_probe.py diffgap``, 12 checkpoints of two trainings; PERF.md
# §6): with no leaky ReLU whose input lies within rounding of zero the
# whole gradient is within 2.5e-6 and the worst leaf within 7.5e-6; one
# such ReLU taking the other slope on one device (1 of 1.7 million signs, in
# 1 of 12 checkpoints) moved the whole gradient by 4.1e-4 and the leaves
# beside it by up to 3.2e-3 (6.1e-3 in an earlier call), in deterministic
# runs alike. The DDIM and DPM++ gaps stayed below 1.3e-5 and 6.4e-5. A
# run with TF32 convolutions and matrix products, which the phase repeats
# as a control that must exceed a bound, reads the whole gradient at
# 5.6e-3 to 1.2e-2 and the fills at 1.7e-3 to 1.7e-2. The worst leaf is
# printed as ``grad_leaf``
DIFF_CMP_BOUNDS = dict(loss=1e-5, grad_all=2e-3, grad_rel=5e-2,
                       ddim=2e-4, dpmpp=1e-3)


def _diffusion_engine(dev: str):
    from pcmi_tpu_torch.models.diffusion import (
        CondUNet, DiffusionConfig, TiledDiffusionEngine)

    D = DIFFUSION
    cfg = DiffusionConfig(steps=D["sample_steps"], tile=D["tile"],
                          stride=D["stride"], img_channels=3,
                          train_timesteps=D["timesteps"],
                          text_conditioning=True, cfg_dropout=D["dropout"])
    return TiledDiffusionEngine(cfg, device=dev, model=CondUNet(
        widths=D["widths"], out_channels=3, text_conditioning=True))


def _diffusion_pool(draws: dict, seed: int, dev: str):
    """bench_diffusion(seed)'s 24 fields and 24 urban scenes (the
    reference's seeds) and its caption tokens, (2, 5, L)."""
    from pcmi_tpu_torch.models.diffusion import tokenize_prompt
    from pcmi_tpu_torch.models.scenes import STYLE_CAPTIONS, make_styled_scene

    size = DIFFUSION["size"]
    pool = np.stack([make_styled_scene(int(s), style, size)
                     for style, seeds in zip(
                         ("fields", "urban"), draws["diffusion_pool_seeds"][seed])
                     for s in seeds])
    toks = np.stack([[tokenize_prompt(c) for c in STYLE_CAPTIONS[s]]
                     for s in ("fields", "urban")]).astype(np.int64)
    return torch.from_numpy(pool).to(dev), torch.from_numpy(toks).to(dev)


def _diffusion_trainer(seed: int, draws: dict, dev: str, steps: int):
    """bench_diffusion's training loop: (engine, network, ``step(i)``, the
    losses of steps 20 and ``steps - 1``). Each step's styles, scenes and
    caption variants, hole masks and training draws come from one CPU
    generator (the reference splits a key), drawn in order by a thread
    that keeps two steps ahead of the card's work."""
    import queue
    import threading

    from pcmi_tpu_torch.models.losses import (
        draws_to, grow_hole_masks, hole_mask_draws)
    from pcmi_tpu_torch.models.training import adam, apply_gradients

    D = DIFFUSION
    size, b = D["size"], D["batch"]
    eng = _diffusion_engine(dev)
    pool, toks = _diffusion_pool(draws, seed, dev)
    n_pool = pool.shape[0] // 2
    net = eng.init_params(_gen(seed + 1))
    params = list(net.parameters())
    opt = adam(params, dev, lr=D["lr"])
    rng = _gen(3000 + seed)
    pin = ((lambda t: t) if torch.device(dev).type == "cpu"
           else (lambda t: t.pin_memory()))
    ahead: queue.Queue = queue.Queue(maxsize=2)

    def produce():
        try:
            for _ in range(steps):
                style = torch.randint(0, 2, (b,), generator=rng)
                idx = (torch.randint(0, n_pool, (b,), generator=rng)
                       + style * n_pool)
                variant = torch.randint(0, toks.shape[1], (b,), generator=rng)
                holes = hole_mask_draws(rng, (b, size, size),
                                        D["hole_seeds"], D["hole_steps"])
                train = eng.train_draws(b, (b, size, size, 3), rng)
                ahead.put([pin(t) for t in (
                    torch.stack([idx, style, variant]), *holes, *train)])
        except Exception as exc:  # handed to the step that waits for it
            ahead.put(exc)

    threading.Thread(target=produce, daemon=True).start()
    losses: dict = {}

    def step(i):
        item = ahead.get()
        if isinstance(item, Exception):
            raise item
        batch, *holes_train = (draws_to(t, dev) for t in item)
        idx, style, variant = batch
        imgs = pool[idx] * 2.0 - 1.0
        tk = toks[style, variant]
        masks = grow_hole_masks((b, size, size), *holes_train[:3])
        loss = eng.train_step_loss(net, imgs, masks, None, None, tk,
                                   _draws=holes_train[3:])
        apply_gradients(opt, params, loss)
        if i in (20, steps - 1):
            losses[i] = loss.detach()

    return eng, net, step, losses


def _diffusion_eval(eng, net, seed: int, draws: dict, dev: str) -> dict:
    """bench_diffusion's held-out evaluation: its two scenes (one per
    style) with the centre hole, each filled under the matched and the
    mismatched prompt at guidance 1 and 3 (DPM++, seeds 7 and 8): in-hole
    L1 divergence of the two fills per guidance, the brightness steer and
    the matched prompt's PSNR advantage at guidance 3."""
    from pcmi_tpu_torch.models.metrics import psnr
    from pcmi_tpu_torch.models.scenes import make_styled_scene

    size = DIFFUSION["size"]
    q = size // 4
    hole = torch.zeros((size, size, 1), device=dev)
    hole[q:size - q, q:size - q] = 1.0
    hv = hole[..., 0] > 0.5
    div = {1.0: [], 3.0: []}
    steer, adv = [], []
    for s_i, style in enumerate(("fields", "urban")):
        img = torch.from_numpy(make_styled_scene(
            int(draws["diffusion_eval_seeds"][seed][s_i]), style, size)).to(dev)
        other = "urban" if style == "fields" else "fields"
        for g in (1.0, 3.0):
            fa, fb = ((eng.inpaint(net, img * 2.0 - 1.0, hole, seed=7 + s_i,
                                   prompt=DIFFUSION_PROMPTS[p], guidance=g)
                       + 1.0) * 0.5 for p in (style, other))
            div[g].append(float((fa - fb).abs()[hv].mean()))
            if g == 3.0:
                adv.append(float(psnr(fa[None], img[None], mask=hole[None]))
                           - float(psnr(fb[None], img[None],
                                        mask=hole[None])))
                sign = 1.0 if style == "urban" else -1.0
                steer.append(sign * float(fa[hv].mean() - fb[hv].mean()))
    return dict(divergence_g1=float(np.mean(div[1.0])),
                divergence_g3=float(np.mean(div[3.0])),
                steer_brightness=float(np.mean(steer)),
                matched_minus_mismatched_db=float(np.mean(adv)))


def _diffusion_gates(row: dict) -> dict:
    """bench_generative.py:413-417."""
    return dict(steers=row["steer_brightness"] > 0.02,
                cfg_amplifies=row["divergence_g3"] > row["divergence_g1"],
                matched_better=row["matched_minus_mismatched_db"] > 0)


def _nan_holes(img: np.ndarray) -> np.ndarray:
    """``img`` with three rectangular NaN holes."""
    out = img.copy()
    h, w = out.shape[:2]
    for y, x, hh, ww in ((h // 5, w // 4, 40, 64), (h // 2, w // 2, 96, 48),
                         (3 * h // 4, w // 6, 24, 120)):
        out[y:y + hh, x:x + ww] = np.nan
    return out


def _diffusion_user_path(eng, net) -> dict:
    """The trained engine through the user's entry points on the card:
    ``RestorationGenerativePlugin(engine=...)`` on a 1024² RGB image with
    NaN holes (tiled DPM++; finite, the pixels outside the holes and their
    margin kept) and ``EnhancementProcessor`` on 512² (img2img; finite),
    each median ms of 3 after a warm-up, with peak MB."""
    from pcmi_tpu_torch.models.scenes import make_styled_scene
    from pcmi_tpu_torch.pipelines.generative import (
        EnhancementProcessor, RestorationGenerativePlugin, nan_mask)

    D = DIFFUSION
    eng.load_params(net)
    img = make_styled_scene(91_000, "urban", D["plugin_size"])
    holed = _nan_holes(img)
    plugin = RestorationGenerativePlugin(engine=eng, device="cuda")
    held = _peak_start()
    box = []
    ms = _median_ms(lambda: box.append(plugin.run(holed)), 3)
    restored = box[-1][1][0]
    keep = ~nan_mask(holed, 10, "cuda")
    out = dict(fill_ms=ms, fill_peak_mb=_peak_mb(held),
               fill_finite=bool(np.isfinite(restored).all()),
               fill_kept=bool(np.array_equal(restored[keep], img[keep])),
               hole_px=int((~keep).sum()))
    small = make_styled_scene(91_001, "fields", D["enhance_size"])
    proc = EnhancementProcessor(eng, device="cuda")
    held = _peak_start()
    box = []
    out["enhance_ms"] = _median_ms(lambda: box.append(proc.process(small)), 3)
    out["enhance_peak_mb"] = _peak_mb(held)
    out["enhance_finite"] = bool(np.isfinite(box[-1]).all()
                                 and box[-1].shape == small.shape)
    if not (out["fill_finite"] and out["fill_kept"]
            and out["enhance_finite"]):
        raise SystemExit(f"diffusion user path: {out}")
    return out


@contextlib.contextmanager
def _card_mode(mode: str):
    """The card's arithmetic for one run: ``port`` (as the package sets
    it), ``deterministic`` or ``tf32``; yields the list that receives the
    messages of the operations without a deterministic version."""
    import warnings

    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = (torch.are_deterministic_algorithms_enabled(), cudnn.deterministic,
            cudnn.benchmark, cudnn.allow_tf32, mm.allow_tf32)
    caught: list = []
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        if mode == "deterministic":
            torch.use_deterministic_algorithms(True, warn_only=True)
            cudnn.deterministic, cudnn.benchmark = True, False
        elif mode == "tf32":
            cudnn.allow_tf32 = mm.allow_tf32 = True
        try:
            yield caught
        finally:
            torch.use_deterministic_algorithms(prev[0])
            (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
             mm.allow_tf32) = prev[1:]
            caught.extend(sorted({str(m.message)[:100] for m in w}))


def _diffusion_cmp_inputs(draws: dict) -> dict:
    """The card-against-CPU comparison's shared inputs, on the host: a
    batch of 4 pool scenes, their captions and hole masks, the training
    draws, bench_diffusion's held-out urban scene with the centre hole,
    the urban prompt and the samplers' draws."""
    from pcmi_tpu_torch.models.losses import random_hole_masks
    from pcmi_tpu_torch.models.scenes import make_styled_scene

    D = DIFFUSION
    size, b = D["size"], D["cmp_batch"]
    pool, toks = _diffusion_pool(draws, D["gated_seed"], "cpu")
    imgs = pool[::12][:b] * 2.0 - 1.0
    hole = torch.zeros((size, size, 1))
    hole[size // 4:3 * size // 4, size // 4:3 * size // 4] = 1.0
    g = _gen(6)
    eng = _diffusion_engine("cpu")
    return dict(
        imgs=imgs, tokens=toks[torch.arange(b) % 2,
                               torch.arange(b) % toks.shape[1]],
        masks=random_hole_masks(_gen(5), (b, size, size), D["hole_seeds"],
                                D["hole_steps"], device="cpu"),
        train=eng.train_draws(b, imgs.shape, _gen(7)),
        scene=torch.from_numpy(make_styled_scene(
            int(draws["diffusion_eval_seeds"][D["gated_seed"]][1]), "urban",
            size)) * 2.0 - 1.0,
        hole=hole, prompt=eng.tokens_for_prompt(DIFFUSION_PROMPTS["urban"]),
        sample=(torch.randn((size, size, 3), generator=g),
                [torch.randn((size, size, 3), generator=g)
                 for _ in range(D["sample_steps"])]))


def _diffusion_cmp_run(net, x: dict, dev: str):
    """A copy of ``net`` on ``dev``: one training step's loss and each
    leaf's gradient, and the DDIM and DPM++ fills with guidance 3, on the
    shared inputs ``x``."""
    import copy

    eng = _diffusion_engine(dev)
    n = copy.deepcopy(net).to(dev)
    loss = eng.train_step_loss(n, x["imgs"], x["masks"], None, None,
                               x["tokens"], _draws=x["train"])
    loss.backward()
    size = DIFFUSION["size"]
    fills = {m: fn(n, x["scene"].to(dev), x["hole"].to(dev), None,
                   (size, size), tokens=x["prompt"].to(dev), guidance=3.0,
                   _draws=x["sample"]).cpu()
             for m, fn in (("ddim", eng._sample),
                           ("dpmpp", eng._sample_dpmpp))}
    return loss.item(), _grads(n), fills


def _leaf_gaps(g_card: dict, g_cpu: dict, null: set) -> dict:
    """Each leaf's ``|card - cpu| / |cpu|`` (L2 norms), the biases an
    instance norm follows left out."""
    return {k: float((g_card[k] - g_cpu[k]).norm())
            / max(float(g_cpu[k].norm()), 1e-30)
            for k in g_cpu if k not in null}


def _diffusion_gaps(card, cpu, net) -> dict:
    """The card's run against the CPU's (:func:`_diffusion_cmp_run`): the
    loss's absolute gap, the whole gradient's and the worst leaf's
    relative gaps, and the fills' largest absolute difference; the worst
    leaf as ``grad_leaf``."""
    (l_card, g_card, f_card), (l_cpu, g_cpu, f_cpu) = card, cpu
    null = _norm_biases(net)
    rel = _leaf_gaps(g_card, g_cpu, null)
    worst = max(rel, key=rel.get)
    keys = [k for k in g_cpu if k not in null]
    whole = [torch.cat([g[k].reshape(-1) for k in keys])
             for g in (g_card, g_cpu)]
    out = dict(loss=abs(l_card - l_cpu),
               grad_all=float((whole[0] - whole[1]).norm())
               / float(whole[1].norm()),
               grad_rel=rel[worst])
    for m in ("ddim", "dpmpp"):
        out[m] = float((f_card[m] - f_cpu[m]).abs().max())
    out["grad_leaf"] = worst
    return out


def _diffusion_card_vs_cpu(net, draws: dict) -> dict:
    """One training step and one DDIM and one DPM++ fill (guidance 3, the
    urban prompt, bench_diffusion's held-out urban scene and centre hole)
    on the card and on the CPU from the trained weights and shared draws,
    held to ``DIFF_CMP_BOUNDS``; then the card's run again with TF32
    convolutions and matrix products, which must exceed at least one of
    them (listed under ``tf32_beyond``)."""
    x = _diffusion_cmp_inputs(draws)
    cpu = _diffusion_cmp_run(net, x, "cpu")
    out = _diffusion_gaps(_diffusion_cmp_run(net, x, "cuda"), cpu, net)
    with _card_mode("tf32"):
        ctl = _diffusion_gaps(_diffusion_cmp_run(net, x, "cuda"), cpu, net)
    bad = {k: out[k] for k, b in DIFF_CMP_BOUNDS.items() if not out[k] <= b}
    out["tf32_beyond"] = {k: ctl[k] for k, b in DIFF_CMP_BOUNDS.items()
                          if not ctl[k] <= b}
    if bad or not out["tf32_beyond"]:
        raise SystemExit(f"diffusion card_vs_cpu beyond {DIFF_CMP_BOUNDS}, "
                         f"or its TF32 control within them: {out}")
    return out


def _diffusion_run(seed: int):
    """bench_diffusion(seed) on the card: 4,000 training steps, then its
    evaluation and gates. Returns (row, engine, network)."""
    D = DIFFUSION
    draws = reference_draws()
    eng, net, step, losses = _diffusion_trainer(seed, draws, "cuda",
                                                D["steps"])
    held = _peak_start()
    s, ms = _steps(step, D["steps"])
    row = dict(loss_20=float(losses[20]),
               loss_end=float(losses[D["steps"] - 1]), train_s=s,
               ms_step=ms, peak_mb=_peak_mb(held))
    row.update(_diffusion_eval(eng, net, seed, draws, "cuda"))
    row["gates"] = _diffusion_gates(row)
    return row, eng, net


def _diffusion_row(seed: int) -> dict:
    return _diffusion_run(seed)[0]


def phase_diffusion(smi: str) -> dict:
    """Phase 14: bench_diffusion on the card, uncut: the gated seed alone,
    then the bench's other seeds at once, one process each (the step is
    host-bound); then the user's path and the card against the CPU. No
    stereo kernel launches."""
    import multiprocessing

    from pcmi_tpu_torch.ops.stereo import kernels as K

    D = DIFFUSION
    t_phase = time.perf_counter()
    K.reset_launches()
    draws = reference_draws()
    out: dict = {"card": smi}
    row, eng, net = _diffusion_run(D["gated_seed"])
    rest = [s for s in D["seeds"] if s != D["gated_seed"]]
    with multiprocessing.get_context("spawn").Pool(len(rest)) as pool:
        rows = pool.map(_diffusion_row, rest)
    for seed, r in zip([D["gated_seed"]] + rest, [row] + rows):
        r["processes"] = 1 if seed == D["gated_seed"] else len(rest)
        out[f"seed{seed}"] = r
        print(f"diffusion seed {seed}: {json.dumps(_sig(r, 6))} ({smi})")
    pstep = _diffusion_trainer(D["gated_seed"], draws, "cuda", 7)[2]
    _steps(pstep, 2)  # warm-up
    prof = _profiled(lambda: [pstep(i) for i in range(2, 7)])
    out["profile"] = prof
    print(f"diffusion profile (5 steps): {json.dumps(_sig(prof, 4))}")
    out["user"] = _diffusion_user_path(eng, net)
    print(f"diffusion user path: {json.dumps(_sig(out['user'], 6))} ({smi})")
    out["card_vs_cpu"] = _diffusion_card_vs_cpu(net, draws)
    print(f"diffusion card_vs_cpu: {json.dumps(_sig(out['card_vs_cpu'], 4))}"
          f" (bounds {DIFF_CMP_BOUNDS})")
    _launched("diffusion", dict(K.LAUNCHES), NONE)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"diffusion: phase {out['phase_s']:.1f} s, gates on seed "
          f"{D['gated_seed']} {row['gates']}")
    if not all(row["gates"].values()):
        raise SystemExit(f"diffusion: a gate of bench_generative.py:413-417 "
                         f"fails on seed {D['gated_seed']}: {row}")
    return out


# ---------------------------------------------------------------------------
# phase 15: the scale-out layer on one card (a world of one NCCL rank)
# ---------------------------------------------------------------------------


def _nan_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def phase_parallel(ctx: "Headline", dctx: "D288") -> dict:
    """Phase 15: ``pcmi_tpu_torch.parallel`` and ``data_parallel_step`` on
    a 1 x 1 mesh over a world-size-1 NCCL group (the multi-rank cases run
    on the CPU in ``tests/test_torch_parallel.py``): the halo exchange
    pads zeros; ``sharded_disparity`` on the headline pair's matcher
    inputs agrees with ``compute_disparity`` + ``refine_disparity`` on
    the interior rows (within 0.51 px on > 98 %, ``tests/test_parallel.py``)
    with 6/3/1 launches; ``batched_pair_step`` on phase 7's pairs 0 and 1
    equals ``pair_core`` pair by pair with 12/6/2 launches;
    ``sharded_dsm_update`` equals the sequential ``dsm_update`` loop;
    ``data_parallel_step`` of one inpainting GAN step and of one step of
    each detector trainer equals the plain step within phase 13's
    card-against-CPU bounds (:func:`_dp_detectors`, which also
    round-trips a detector checkpoint)."""
    import torch.distributed as dist

    from pcmi_tpu_torch.models.losses import random_hole_masks
    from pcmi_tpu_torch.models.training import (
        InpaintGANTrainer, InpaintTrainConfig, data_parallel_step)
    from pcmi_tpu_torch.ops.stereo import kernels as K
    from pcmi_tpu_torch.ops.stereo.matching import (
        compute_disparity, refine_disparity)
    from pcmi_tpu_torch.parallel import (
        batched_pair_step, halo_exchange_rows, make_mesh, sharded_disparity,
        sharded_dsm_update)
    from pcmi_tpu_torch.parallel.mesh import shard_blocks
    from pcmi_tpu_torch.pipelines.height_map import pair_core
    from pcmi_tpu_torch.pipelines.streaming import dsm_update, empty_dsm

    t_phase = time.perf_counter()
    mesh = make_mesh(1, 1, device_type="cuda")
    out: dict = dict(world=dist.get_world_size(), backend=dist.get_backend())

    x = torch.rand((64, 48), generator=_gen(3)).to("cuda")
    ext = halo_exchange_rows(x, 8, mesh)
    out["halo_zeros"] = bool(ext.shape == (80, 48) and not ext[:8].any()
                             and not ext[-8:].any()
                             and torch.equal(ext[8:-8], x))

    n1, n2, v1, v2 = _matcher_inputs(ctx)
    scfg = ctx.scfg
    K.reset_launches()
    disp, ok = sharded_disparity(mesh, scfg)(n1[None], n2[None], v1[None],
                                              v2[None])
    torch.cuda.synchronize()
    out["sd_launches"] = dict(K.LAUNCHES)
    ref = refine_disparity(compute_disparity(n1, n2, v1, v2, scfg, "sgm"),
                           n1, scfg)
    h = n1.shape[0]
    inner = slice(16, h - 16)
    out["sd_close"] = float(((disp[0] - ref.disparity).abs()[inner] <= 0.51)
                            .float().mean())

    pairs = [_d288_inputs(dctx, k) for k in (0, 1)]
    rects = torch.stack([torch.stack(p[:2]) for p in pairs])
    tri_M = torch.stack([p[2] for p in pairs])
    tri_b = torch.stack([p[3] for p in pairs])
    K.reset_launches()
    t0 = time.perf_counter()
    bp = batched_pair_step(mesh, dctx.strict)(rects, tri_M, tri_b)
    torch.cuda.synchronize()
    out["bp_ms"] = (time.perf_counter() - t0) * 1e3
    out["bp_launches"] = dict(K.LAUNCHES)
    same = []
    for k, (r1, r2, M, b) in enumerate(pairs):
        prod = pair_core(r1, r2, M, b, dctx.strict)
        same.append(bool(torch.equal(bp[0][k], prod.disparity)
                         and torch.equal(bp[1][k], prod.valid)
                         and _nan_equal(bp[2][k], prod.height)))
    out["bp_equal"] = same

    g = _gen(4)
    xy = (torch.rand((8, 1 << 16, 2), generator=g) * 264 - 4).to("cuda")
    vals = (torch.randn((8, 1 << 16), generator=g) * 5 + 20).to("cuda")
    wts = (torch.rand((8, 1 << 16), generator=g) > 0.1).float().to("cuda")
    out["dsm_equal"] = []
    for sigma in (0.0, 3.0):
        acc = sharded_dsm_update(mesh, (0.0, 0.0), 1.0, (256, 256),
                                 robust_sigma=sigma)(
            *(shard_blocks(a, mesh) for a in (xy, vals, wts)))
        seq = empty_dsm((256, 256), "cuda")
        for k in range(8):
            seq = dsm_update(seq, xy[k], vals[k], wts[k], (0.0, 0.0), 1.0,
                             (256, 256), robust_sigma=sigma)
        out["dsm_equal"].append(all(torch.equal(a, s)
                                    for a, s in zip(acc, seq)))

    T = TRAIN
    trainer = InpaintGANTrainer(InpaintTrainConfig(compute_dtype="float32"),
                                device="cuda")
    size, b = T["cmp_size"], 4
    images = torch.rand((b, size, size, 3), generator=_gen(5)).to("cuda")
    masks = random_hole_masks(_gen(6), (b, size, size), 6, 10, device="cuda")
    plain, m_plain = trainer._step(trainer.init(None, _gen(0)), images, masks)
    dp, m_dp = data_parallel_step(trainer._step, mesh)(
        trainer.init(None, _gen(0)), images, masks)
    loss_bound, _, share_bound = CMP_BOUNDS["inpaint_f32"]
    out["dp_loss"] = max(abs(float(m_plain[k]) - float(m_dp[k]))
                         for k in m_plain)
    close = total = 0
    for net_a, net_b in ((plain.g, dp.g), (plain.d, dp.d)):
        null = _norm_biases(net_a)
        pb = dict(net_b.named_parameters())
        for k, p in net_a.named_parameters():
            if k not in null:
                d = (p - pb[k]).abs()
                close += int((d <= trainer.cfg.lr_g / 2).sum())
                total += d.numel()
    out["dp_share"] = close / total
    out["dp_detectors"] = _dp_detectors(mesh)
    dist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"parallel: {json.dumps(_sig(out, 6))}")
    if not (out["halo_zeros"] and out["sd_close"] > 0.98
            and out["sd_launches"] == PER_PAIR and all(out["bp_equal"])
            and out["bp_launches"] == {k: 2 * v for k, v in PER_PAIR.items()}
            and all(out["dsm_equal"]) and out["dp_loss"] <= loss_bound
            and out["dp_share"] >= share_bound
            and all(r["ok"] for r in out["dp_detectors"].values())):
        raise SystemExit(f"parallel: {out}")
    return out


def _dp_detectors(mesh) -> dict:
    """``data_parallel_step`` of one step of each detector trainer on
    ``mesh`` against the plain step from the same weights on the same
    four 128 px scenes (phase 13's card-against-CPU batches): the losses
    within the trainer's ``CMP_BOUNDS`` loss bound and at least its share
    of the parameters within half an Adam step (``ms``: the wrapped step,
    host clock to a synchronise, after the plain step). Then
    ``save_checkpoint`` / ``restore_checkpoint`` of the OBB detector's
    stepped ``(net, opt)`` into another draw's state: every tensor
    bit-equal, the template untouched, one more step from the restored
    state finite (its loss gap to the same step from the saved state
    reported)."""
    import copy

    from pcmi_tpu_torch.models.detector import (
        DetectorTrainConfig, DetectorTrainer, OBBDetectorTrainer,
        synthesize_detection_batch, synthesize_obb_batch)
    from pcmi_tpu_torch.models.training import (
        data_parallel_step, restore_checkpoint, save_checkpoint)

    out: dict = {}
    cases = (
        ("detector", DetectorTrainer(device="cuda"),
         lambda r: synthesize_detection_batch(r, 4, 128, device="cuda")),
        ("obb", OBBDetectorTrainer(DetectorTrainConfig(lr=1e-3),
                                   device="cuda"),
         lambda r: synthesize_obb_batch(r, 4, 128, hard=True,
                                        device="cuda")))
    for name, trainer, synth in cases:
        batch = synth(_gen(9))
        net, opt = trainer.init(None, _gen(10))
        dp_net = copy.deepcopy(net)
        dp_opt = trainer.optimizer(dp_net)
        net, opt, m = trainer.train_step(net, opt, *batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dp_net, dp_opt, m_dp = data_parallel_step(trainer.train_step, mesh)(
            dp_net, dp_opt, *batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        lr = trainer.cfg.lr
        gaps = [(p - q).abs() for p, q in zip(net.parameters(),
                                               dp_net.parameters())]
        share = (sum(int((g <= lr / 2).sum()) for g in gaps)
                 / sum(g.numel() for g in gaps))
        loss_bound, _, share_bound = CMP_BOUNDS[name]
        row = dict(loss=max(abs(float(m[k]) - float(m_dp[k])) for k in m),
                   share=share, ms=ms)
        row["ok"] = row["loss"] <= loss_bound and share >= share_bound
        out[name] = row

    def leaves(n, o):
        t = list(n.state_dict().values())
        for st in o.state_dict()["state"].values():
            t += [st[k] for k in sorted(st)]
        return t

    os.makedirs("build", exist_ok=True)
    path = os.path.join("build", "chip_smoke_detector.pt")
    template = trainer.init(None, _gen(12))
    before = [t.clone() for t in leaves(*template)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(path, (dp_net, dp_opt))
    back = restore_checkpoint(path, template)
    torch.cuda.synchronize()
    ck = dict(ms=(time.perf_counter() - t0) * 1e3,
              equal=all(torch.equal(a, b) for a, b in zip(
                  leaves(dp_net, dp_opt), leaves(*back))),
              template_kept=all(torch.equal(a, b) for a, b in zip(
                  before, leaves(*template))))
    os.remove(path)
    nxt = synth(_gen(13))
    _n, _o, m_back = trainer.train_step(*back, *nxt)
    _n, _o, m_saved = trainer.train_step(dp_net, dp_opt, *nxt)
    ck["resumed_loss"] = float(m_back["loss"])
    ck["resumed_gap"] = abs(float(m_back["loss"]) - float(m_saved["loss"]))
    ck["ok"] = (ck["equal"] and ck["template_kept"]
                and math.isfinite(ck["resumed_loss"]))
    out["checkpoint"] = ck
    return out


def _sig(x, digits: int):
    """``x`` with every float rounded to ``digits`` significant digits (and
    written as an integer where that is exact)."""
    if isinstance(x, float):
        r = float(f"{x:.{digits}g}")
        return int(r) if r.is_integer() else r
    if isinstance(x, dict):
        return {k: _sig(v, digits) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_sig(v, digits) for v in x]
    return x


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import pcmi_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = phase_device()
    phase_build()
    phase_ragged()
    par = [phase_parity(shape, stride, seed=i)
           for i, (shape, stride) in enumerate(SHAPES)]
    par16 = [phase_parity(shape, stride, seed=i, dtype=torch.bfloat16)
             for i, (shape, stride) in enumerate(SHAPES)]
    head, ctx = phase_headline()
    lay = phase_layouts(ctx)
    lay16 = phase_layouts(ctx, "bfloat16")
    phase_variants(ctx)
    d288, dctx = phase_d288()
    pairs16 = phase_bf16_pairs(ctx, head, dctx, d288)
    adaptive = phase_adaptive_pairs(dctx, d288)
    fused = phase_fused_d288(dctx, d288)
    md, stream = phase_multiday(dctx)
    lowtex = phase_lowtex()
    disk = phase_from_disk(dctx)
    comp = phase_components(smi)
    train = phase_training(smi)
    diff = phase_diffusion(smi)
    par_run = phase_parallel(ctx, dctx)
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = par[0][name]
        layouts = name in ("sgm_hwd", "sgm_blocked", "derive_right_wdh")
        run = lay if layouts else head
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=run["launches"][name],
            max_abs_err=max(p[name]["max_abs_err"] for p in par),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
        if name in par16[0]:  # every kernel but K4, float32 only
            r = par16[0][name]
            run = lay16 if layouts else pairs16["headline"]
            kernels[-1]["bf16"] = dict(
                launches=run["launches"][name],
                max_abs_err=max(p[name]["max_abs_err"] for p in par16),
                ms=r["ms"], bound_ms=r["bound_ms"])

    # the phases' own lines above carry every field and digit; these lines
    # stay short for readers of the output's tail
    summary = {
        "fused_d288": {
            "rmse_m": fused["rmse_m"], "comp": fused["completeness"],
            "obs2": fused["completeness_obs2"],
            "pair_rmse_m": fused["mean_pair_rmse_m"],
            "ms_pair": fused["ms_per_pair"],
            "ms_update": fused["ms_per_dsm_update"]},
        "multiday": {
            "pairs": md["processed"], "icp_max_m": md["icp_rmse_max_m"],
            "rmse_m": md["rmse_m"], "comp": md["completeness"],
            "knn_ms": md["knn_mask_ms"]},
        "streaming": {"tiles": stream["tiles"],
                      "median_m": stream["median_diff_m"]},
        "lowtex_fused": {"seeds": len(lowtex["seeds"]),
                         "worst_rmse_m": lowtex["worst_rmse_m"],
                         "worst_comp": lowtex["worst_completeness"]},
        "bfloat16": {
            k: {"rmse_m": [v["height_rmse_m"],
                           v["float32"]["height_rmse_m"]],
                "valid": [v["valid_fraction"],
                          v["float32"]["valid_fraction"]],
                "ms": [v["ms_per_pair"][1], v["float32"]["ms_per_pair"][1]],
                "peak_mb": [v["peak_mem_mb"], v["float32"]["peak_mem_mb"]]}
            for k, v in pairs16.items()},
        "adaptive": {
            k: {"rmse_m": v["height_rmse_m"], "valid": v["valid_fraction"],
                "ms": v["ms_per_pair"][1], "peak_mb": v["peak_mem_mb"]}
            for k, v in adaptive.items()},
        "from_disk": {
            "pair": disk["height_map"]["pair"],
            "valid": disk["height_map"]["valid_fraction"],
            "dsm_rmse_m": [disk["height_map"]["dsm"]["rmse_m"],
                           disk["fuse"]["dsm"]["rmse_m"]],
            "ms": [disk["height_map_ms"], disk["fuse_ms"]]},
        "components_ms": {k: v["ms"] for k, v in comp.items()
                          if isinstance(v, dict)},
        "training": {
            "db": {k: train[k]["gain_db"]
                   for k in ("sr", "inpaint", "inpaint_gan", "dip")},
            "inpaint_min_db": train["inpaint"]["gain_db_min"],
            "map50": train["obb"]["map50"],
            "ms_step": {k: train[k]["ms_step"]
                        for k in ("sr", "inpaint", "dip", "obb")},
            "s": train["phase_s"]},
        "diffusion": {  # per seed: steer, divergence g1, g3, dB
            "seeds": [[diff[f"seed{k}"][m] for m in (
                "steer_brightness", "divergence_g1", "divergence_g3",
                "matched_minus_mismatched_db")] for k in DIFFUSION["seeds"]],
            "ok": all(diff[f"seed{DIFFUSION['gated_seed']}"]["gates"]
                      .values()),
            "ms": diff[f"seed{DIFFUSION['gated_seed']}"]["ms_step"],
            "fill": diff["user"]["fill_ms"], "s": diff["phase_s"]},
        "parallel": {"close": par_run["sd_close"],
                     "eq": all(par_run["bp_equal"]),
                     "det": [par_run["dp_detectors"][k]["loss"]
                             for k in ("detector", "obb")],
                     "k1": [par_run["sd_launches"]["sgm_dir"],
                            par_run["bp_launches"]["sgm_dir"]],
                     "s": par_run["phase_s"]}}
    line = json.dumps(_sig(summary, 3), separators=(",", ":"))
    kline = json.dumps({"kernels": _sig(kernels, 3)}, separators=(",", ":"))
    if len(line) >= 1500 or len(kline) >= 2000:
        raise SystemExit(f"summary lines of {len(line)} and {len(kline)} "
                         f"characters")
    print(line)
    print(kline)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
