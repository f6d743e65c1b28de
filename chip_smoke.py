#!/usr/bin/env python3
"""Drive the PyTorch port (``pcmi_tpu_torch``) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. device: the card's name and power limit (``nvidia-smi``), the torch,
   CUDA and nvcc versions;
2. build: the three CUDA kernels from ``pcmi_tpu_torch/csrc`` (nvcc);
3. kernel parity: each kernel against its plain PyTorch version on seeded
   inputs on the card at two volume shapes, (80, 896, 896) (the headline
   pair) and (144, 1152, 1152) at stride 2 (D = 288 search at stride 2);
   K1 ``sgm_dir`` and K3 ``derive_right`` must be bit-exact, K2 ``wta``
   exact in its argmin indices, disparity within 1e-5 px, best cost and
   margin within 1e-6;
4. headline slice: the port's seed-1 synthetic scene (512x512 images,
   640x640 ground, heights 0-40 m) through ``HeightMapPipeline`` on
   ``cuda`` (``build_geometry`` -> ``process_pair``); height RMSE against
   the scene's exact truth must be <= 1.0 m, the valid fraction of the
   observable canvas >= 0.5, and one pair must launch exactly 6 ``sgm_dir``,
   3 ``wta`` and 1 ``derive_right``.

The last two lines are a JSON object with each kernel's numbers, then
``{"ok": true, "device": {...}}``. Without a CUDA card the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SHAPES = (((80, 896, 896), 1), ((144, 1152, 1152), 2))
KERNELS = {
    "sgm_dir": ("pcmi_tpu_torch/csrc/sgm_dir.cu",
                "pcmi_tpu/ops/stereo/pallas_kernels.py:157"),
    "wta": ("pcmi_tpu_torch/csrc/wta.cu",
            "pcmi_tpu/ops/stereo/pallas_kernels.py:1071"),
    "derive_right": ("pcmi_tpu_torch/csrc/derive_right.cu",
                     "pcmi_tpu/ops/stereo/pallas_kernels.py:683"),
}
PER_PAIR = {"sgm_dir": 6, "wta": 3, "derive_right": 1}


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
    for name, r in res.items():
        print(f"parity {name} shape={tuple(shape)} stride={stride}: "
              f"max_abs_err={r['max_abs_err']:.3g} exact={r['exact']} "
              f"kernel {r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms")
    if not ok:
        raise SystemExit(f"kernel parity failed at {shape}")
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
    head = phase_headline()
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = par[0][name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=head["launches"][name],
            max_abs_err=max(p[name]["max_abs_err"] for p in par),
            ms=r["ms"], plain_ms=r["plain_ms"]))
    print(json.dumps({"kernels": kernels, "card": smi,
                      "headline": head}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
