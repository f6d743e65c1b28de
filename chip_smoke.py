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
    printed).

The last lines are a summary of phases 7b-10 (under 1500 characters;
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
            for k, v in adaptive.items()}}
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
