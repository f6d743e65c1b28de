#!/usr/bin/env python3
"""Drive the PyTorch port (``pcmi_tpu_torch``) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. device: the card's name and power limit (``nvidia-smi``), the torch,
   CUDA and nvcc versions;
2. build: the six CUDA kernels from ``pcmi_tpu_torch/csrc`` (one nvcc per
   source, all started together, then one link);
3. kernel parity: each kernel against its plain PyTorch version on seeded
   inputs on the card at two volume shapes, (80, 896, 896) (the headline
   pair) and (144, 1152, 1152) at stride 2 (D = 288 search at stride 2);
   K1 ``sgm_dir``, K3 ``derive_right``, K4 ``sgm_hwd``, K5 ``sgm_blocked``
   and K6 ``derive_right_wdh`` must be bit-exact, K2 ``wta`` exact in its
   argmin indices, disparity within 1e-5 px, best cost and margin within
   1e-6; the two alternative-layout SGMs (``layouts.sgm_aggregate_hwd`` and
   ``sgm_aggregate_blocked``) within 1e-4 of K1's ``sgm_aggregate``, and
   the (W, Dp, H)-derive right view equal to the default one;
4. headline slice: the port's seed-1 synthetic scene (512x512 images,
   640x640 ground, heights 0-40 m) through ``HeightMapPipeline`` on
   ``cuda`` (``build_geometry`` -> ``process_pair``); height RMSE against
   the scene's exact truth must be <= 1.0 m, the valid fraction of the
   observable canvas >= 0.5, and one pair must launch exactly 6 ``sgm_dir``,
   3 ``wta`` and 1 ``derive_right`` and none of K4-K6;
5. alternative layouts: the three entry points of ``ops.stereo.layouts``
   on the headline pair's cost volume, with the launch counts set to 0
   just before and read just after (each of K4-K6 must launch), their
   results held against the main path's K1-K3 forms;
6. matcher variants: ``compute_disparity`` on the headline pair with
   ``right_sgm`` derived / diagonal / full, ``right_subpixel``,
   ``aggregation="box"`` and ``band_check_mode="vertical"``; every output
   finite, diagonal equal to derived;
7. the D = 288 pair at full width: the seed-3 scene of ``bench.py``'s
   MAX_DISP = 288 envelope (896x896 images, five views, 0-48 m), pair
   (0, 1) on the canvas of all ten pairs, ``disp_stride=2``, as ``strict``
   (gated at RMSE <= 1.0 m and valid >= 0.5) and as ``dense`` (the
   vertical cross-checker; finite and its launch counts only).

The last two lines are a JSON object with each kernel's numbers, then
``{"ok": true, "device": {...}}``. Without a CUDA card the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SHAPES = (((80, 896, 896), 1), ((144, 1152, 1152), 2))
_PK = "pcmi_tpu/ops/stereo/pallas_kernels.py"
KERNELS = {  # name: (source, the TPU kernels it replaces)
    "sgm_dir": ("pcmi_tpu_torch/csrc/sgm_dir.cu", f"{_PK}:157"),
    "wta": ("pcmi_tpu_torch/csrc/wta.cu",
            f"{_PK}:1071;{_PK}:901;{_PK}:574"),
    "derive_right": ("pcmi_tpu_torch/csrc/derive_right.cu", f"{_PK}:683"),
    "sgm_hwd": ("pcmi_tpu_torch/csrc/sgm_hwd.cu", f"{_PK}:417"),
    "sgm_blocked": ("pcmi_tpu_torch/csrc/sgm_blocked.cu", f"{_PK}:219"),
    "derive_right_wdh": ("pcmi_tpu_torch/csrc/derive_right_wdh.cu",
                         f"{_PK}:829"),
}
NONE = dict.fromkeys(KERNELS, 0)
PER_PAIR = {**NONE, "sgm_dir": 6, "wta": 3, "derive_right": 1}
# the vertical cross-checker adds its 2 vertical directions
PER_DENSE_PAIR = {**PER_PAIR, "sgm_dir": 8}


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


def phase_parity(shape, stride: int, seed: int) -> dict:
    """Each kernel against its plain version at one volume shape."""
    from pcmi_tpu_torch.ops.stereo import kernels as K

    D, H, W = shape
    d_min = -(D * stride) // 2
    p1, p2 = 0.03, 0.48
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    vol = torch.rand(shape, generator=gen, device="cuda")
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
    print(f"  sgm_dir per launch: horizontal {ms_h:.3f} ms, "
          f"vertical {ms_v:.3f} ms")
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
    res["wta"] = dict(max_abs_err=werr, exact=wexact, ms=ms, plain_ms=pms)

    # K3
    got = K.derive_right(vol, d_min, 1.0, stride)
    ref = K.derive_right_plain(vol, d_min, 1.0, stride)
    torch.cuda.synchronize()
    exact = torch.equal(got, ref)
    res["derive_right"] = dict(
        max_abs_err=_maxerr(got, ref), exact=exact,
        ms=_median_ms(lambda: K.derive_right(vol, d_min, 1.0, stride), 5),
        plain_ms=_median_ms(
            lambda: K.derive_right_plain(vol, d_min, 1.0, stride), 3))
    ok &= exact

    # the K1 reference the alternative layouts are held against
    ref4 = (h + v) / 4.0
    del h, v
    res.update(_parity_layouts(vol, ref4, p1, p2, d_min, stride))
    ok &= all(res[n]["exact"] for n in ("sgm_hwd", "sgm_blocked",
                                        "derive_right_wdh"))
    for name, r in res.items():
        print(f"parity {name} shape={tuple(shape)} stride={stride}: "
              f"max_abs_err={r['max_abs_err']:.3g} exact={r['exact']} "
              f"kernel {r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms")
    if not ok:
        raise SystemExit(f"kernel parity failed at {shape}")
    return res


def _parity_layouts(vol, ref4, p1, p2, d_min, stride) -> dict:
    """K4-K6 against their plain versions (bit-exact) and their entry
    points against the main path's K1-K3 forms, on one volume."""
    from pcmi_tpu_torch.ops.stereo import kernels as K
    from pcmi_tpu_torch.ops.stereo import layouts as L

    D, H, W = vol.shape
    res = {}

    # K4 on the (H, W, D) volume, both scan axes, each as a fwd + bwd pair
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
    print(f"  sgm_hwd per launch: horizontal {ms_h:.3f} ms, vertical "
          f"{ms_v:.3f} ms; sgm_aggregate_hwd {ms_agg:.3f} ms, "
          f"max |diff| to K1's sgm_aggregate {agg_err:.3g}")
    res["sgm_hwd"] = dict(max_abs_err=err, exact=exact and agg_err <= 1e-4,
                          ms=(ms_h + ms_v) / 2, plain_ms=pms)

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
    print(f"  sgm_blocked per launch: vertical {ms[0]:.3f} ms, horizontal "
          f"{ms[1]:.3f} ms; sgm_aggregate_blocked {ms_agg:.3f} ms, "
          f"max |diff| to K1's sgm_aggregate {agg_err:.3g}")
    res["sgm_blocked"] = dict(max_abs_err=err,
                              exact=exact and agg_err <= 1e-4,
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
    del wdh
    r_wdh = L.right_disparity_fused(vol, p1, p2, d_min, stride,
                                    use_wdh_derive=True)
    r_def = L.right_disparity_fused(vol, p1, p2, d_min, stride)
    same = torch.equal(r_wdh, r_def)
    print(f"  right_disparity_fused: use_wdh_derive equal to the default "
          f"{same}")
    res["derive_right_wdh"] = dict(max_abs_err=err, exact=exact and same,
                                   ms=ms, plain_ms=pms)
    return res


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
    vf = float(valid.sum() / max(observable.sum(), 1))
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
    return out, (pipe, geom, scfg, img1, img2)


def _matcher_inputs(ctx):
    """The headline pair as ``pair_core`` hands it to the matcher."""
    from pcmi_tpu_torch.geometry.rectify import rectify_arrays
    from pcmi_tpu_torch.pipelines.height_map import matcher_inputs

    pipe, geom, scfg, img1, img2 = ctx
    r1, r2 = rectify_arrays(img1, img2,
                            torch.as_tensor(geom.H1, dtype=torch.float32),
                            torch.as_tensor(geom.H2, dtype=torch.float32),
                            geom.out_shape)
    return matcher_inputs(r1, r2, scfg)[:4]


def phase_layouts(ctx) -> dict:
    """The entry points of ``ops.stereo.layouts`` on the headline pair's
    cost volume, counted, and held against the main path's forms."""
    from pcmi_tpu_torch.ops.stereo import kernels as K
    from pcmi_tpu_torch.ops.stereo import layouts as L
    from pcmi_tpu_torch.ops.stereo.matching import (
        build_cost_volume, sgm_aggregate)

    scfg = ctx[2]
    n1, n2, v1, v2 = _matcher_inputs(ctx)
    vol = build_cost_volume(n1, n2, v1, v2, scfg)
    p1, p2, d_min = scfg.sgm_p1, scfg.sgm_p2, scfg.min_disparity
    torch.cuda.synchronize()
    K.reset_launches()
    hwd = L.sgm_aggregate_hwd(vol.permute(1, 2, 0).contiguous(), p1, p2)
    blk = L.sgm_aggregate_blocked(vol, p1, p2)
    r_wdh = L.right_disparity_fused(vol, p1, p2, d_min, scfg.disp_stride,
                                    use_wdh_derive=True)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    ref = sgm_aggregate(vol, scfg)
    r_def = L.right_disparity_fused(vol, p1, p2, d_min, scfg.disp_stride)
    out = dict(shape=list(vol.shape), launches=launches,
               hwd_err=_maxerr(hwd.permute(2, 0, 1), ref),
               blocked_err=_maxerr(blk, ref),
               wdh_right_equal=torch.equal(r_wdh, r_def))
    print("layouts:", json.dumps(out))
    missing = [k for k in ("sgm_hwd", "sgm_blocked", "derive_right_wdh")
               if launches[k] < 1]
    if missing:
        raise SystemExit(f"layouts: {missing} never launched")
    if not (out["hwd_err"] <= 1e-4 and out["blocked_err"] <= 1e-4
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
        K.reset_launches()
        t0 = time.perf_counter()
        res = compute_disparity(n1, n2, v1, v2, cfg, aggregation=aggregation)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        fields = {f: t for f, t in res._asdict().items() if t is not None}
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in fields.values())
        report[name] = dict(
            finite=finite, fields=sorted(fields), ms=ms,
            valid_fraction=float(res.valid.sum()) / max(observable, 1.0),
            launches={k: n for k, n in K.LAUNCHES.items() if n})
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
    return report


def _truth_on_grid(scene, xyz: np.ndarray):
    """Bilinear truth height under each triangulated (x, y) and the
    in-bounds mask (``pcmi_tpu.pipelines.evaluation.truth_on_grid``)."""
    ox, oy = scene.ground_origin
    terr = scene.terrain.cpu().numpy()
    gx = (xyz[..., 0] - ox) / scene.ground_gsd
    gy = (xyz[..., 1] - oy) / scene.ground_gsd
    gxc = np.clip(gx, 0, terr.shape[1] - 1)
    gyc = np.clip(gy, 0, terr.shape[0] - 1)
    x0 = np.floor(gxc).astype(int)
    y0 = np.floor(gyc).astype(int)
    x1 = np.clip(x0 + 1, 0, terr.shape[1] - 1)
    y1 = np.clip(y0 + 1, 0, terr.shape[0] - 1)
    tx, ty = gxc - x0, gyc - y0
    t = (terr[y0, x0] * (1 - ty) * (1 - tx) + terr[y0, x1] * (1 - ty) * tx
         + terr[y1, x0] * ty * (1 - tx) + terr[y1, x1] * ty * tx)
    inb = ((gx >= 0) & (gx < terr.shape[1] - 1)
           & (gy >= 0) & (gy < terr.shape[0] - 1))
    return t, inb


def phase_d288() -> dict:
    """The MAX_DISP = 288 pair at full width (``bench.py``'s d288 scene):
    ``strict`` gated, ``dense`` reported."""
    from pcmi_tpu_torch.config import (
        PipelineConfig, RectifyConfig, StereoConfig)
    from pcmi_tpu_torch.geometry.rectify import (
        rectify_arrays, triangulation_operator)
    from pcmi_tpu_torch.geometry.synthetic import (
        aoi_lonlat_ranges, make_stereo_scene)
    from pcmi_tpu_torch.ops.stereo import kernels as K
    from pcmi_tpu_torch.pipelines.height_map import (
        HeightMapPipeline, pair_core)

    t0 = time.perf_counter()
    h_range = (0.0, 48.0)
    scene = make_stereo_scene(
        seed=3, out_shape=(896, 896), ground_shape=(768, 768), gsd=0.2,
        h_range=h_range,
        views=((25.0, 80.0), (35.0, 250.0), (30.0, 160.0),
               (20.0, 20.0), (28.0, 305.0)),
        terrain_kwargs=dict(terrain_fraction=0.6, building_size_px=(50, 125),
                            building_h_m=(8.0, 18.0)))
    cfg = PipelineConfig(
        stereo=StereoConfig(block_size=9, census_window=5,
                            margin_undefined=8, disp_stride=2),
        rectify=RectifyConfig(height_range=h_range))
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
    print(f"d288: max_disp {strict.max_disp}, canvas {hc}x{wc}, scene and "
          f"geometry in {time.perf_counter() - t0:.1f} s")
    g = geoms[0]
    r1, r2 = rectify_arrays(scene.images[0].to("cuda"),
                            scene.images[1].to("cuda"),
                            torch.as_tensor(g.H1, dtype=torch.float32),
                            torch.as_tensor(g.H2, dtype=torch.float32),
                            g.out_shape)
    gh, gw = g.out_shape
    r1 = torch.nn.functional.pad(r1, (0, wc - gw, 0, hc - gh), value=-1.0)
    r2 = torch.nn.functional.pad(r2, (0, wc - gw, 0, hc - gh), value=-1.0)
    M, b = (t.to("cuda") for t in triangulation_operator(g))
    observable = ((r1 >= 0) & (r2 >= 0)).sum().item()

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
        valid = prod.valid.cpu().numpy()
        xyz = prod.xyz.cpu().numpy()
        height = prod.height.cpu().numpy()
        if not (np.isfinite(xyz).all() and xyz.shape == (hc, wc, 3)):
            raise SystemExit(f"d288 {name}: non-finite or misshaped xyz")
        truth, inb = _truth_on_grid(scene, xyz)
        m = valid & inb
        rmse = float(np.sqrt(np.mean((height[m] - truth[m]) ** 2)))
        vf = float(valid.sum() / max(observable, 1))
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
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import pcmi_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = phase_device()
    phase_build()
    par = [phase_parity(shape, stride, seed=i)
           for i, (shape, stride) in enumerate(SHAPES)]
    head, ctx = phase_headline()
    lay = phase_layouts(ctx)
    variants = phase_variants(ctx)
    d288 = phase_d288()
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = par[0][name]
        run = lay if name in ("sgm_hwd", "sgm_blocked",
                              "derive_right_wdh") else head
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=run["launches"][name],
            max_abs_err=max(p[name]["max_abs_err"] for p in par),
            ms=r["ms"], plain_ms=r["plain_ms"]))
    print(json.dumps({"kernels": kernels, "card": smi, "headline": head,
                      "d288": d288,
                      "variants_valid_fraction": {
                          k: v["valid_fraction"]
                          for k, v in variants.items()}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
