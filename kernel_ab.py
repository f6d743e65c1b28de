#!/usr/bin/env python3
"""Time the port's hand-written kernels (K1 ``sgm_dir``, K2 ``wta``, K3
``derive_right``, K4 ``sgm_hwd``, K5 ``sgm_blocked``, K6
``derive_right_wdh``) of one or more checkouts on one CUDA card, in turns,
one process per turn.

    python3 kernel_ab.py ROOT[:DTYPE] [ROOT[:DTYPE] ...]

Each ROOT is a directory holding a ``pcmi_tpu_torch`` package (this
checkout, or an older one unpacked beside it); the turns run in the order
given, so ``parent new new parent`` compares two versions on one card.
DTYPE is the volumes' element type, ``float32`` (the default) or
``bfloat16`` (a checkout whose kernels take it; K4, float32 only, is then
left out), so ``parent new new:bfloat16 new new:bfloat16 parent`` times
the float32 kernels of both trees in turns and the bfloat16 ones beside
them. Each turn builds that checkout's kernels, checks each kernel bit-exact against
its plain version, and times, with CUDA events over 10 launches after a
warm-up, K1's and K4's four launch kinds (horizontal / vertical, forward /
accumulate), K5's (both scan axes' blocked volumes, forward / with
``prev``), K3, K2's four forms (``chip_smoke.WTA_FORMS``: the left view
with and without the combined aggregate, the right view's argmin, the
checker's WTA) and K6 on the (W, D, H) copy of the volume, at (80, 896, 896) stride 1
and (144, 1152, 1152) stride 2.
It prints one JSON line per turn, each time beside its bound: the bytes the
launch must move (each input read once, each output written once, 4 or 2
bytes a volume element, 4 a plane element) over the H100's 3.35 TB/s. The
card's name and power limit come first.

    python3 kernel_ab.py --deep ROOT[:DTYPE] [ROOT[:DTYPE] ...]

runs the same turns at the depths past 512 planes (``DEEP_SHAPES``:
(600, 256, 1024) and (1024, 256, 1024), stride 1), where the SGM kernels
take their one kernel of 32 disparities per lane.

    python3 kernel_ab.py --ablate [--dtype DTYPE]

takes K1, K4, K5 and K2 of this checkout apart through build-time
switches: each launch kind at both shapes timed as built (``full``), as
``copy_only`` and as ``scan_only``. For K1, K4 and K5 (``csrc/sgm_tile.cuh``)
``copy_only`` leaves the scan out (``-DSGM_NO_SCAN``: the copies and stores
alone) and ``scan_only`` the device-memory traffic (``-DSGM_NO_COPY``: the
scan alone, on whatever the ring holds); for K2 (``csrc/wta.cu``, each
form) ``copy_only`` folds the combined values into a sum in
place of the walk (``-DWTA_NO_CHAIN``: loads, combine and stores alone) and
``scan_only`` makes the values in registers from the pixel and slice index
(``-DWTA_NO_LOADS``: combine and walk alone). One JSON line each; then
``torch.profiler``'s device time of the kernels one ``sgm_pair`` per axis
launches.

    python3 kernel_ab.py --plans [--dtype DTYPE]

times this checkout's K5 at blocks of 8 and 16 lanes with every tile
length that fits, and K4 at tiles of 1 to 32 steps, beside the plan the
wrappers choose (one JSON line per launch kind and shape).
"""

from __future__ import annotations

import itertools
import json
import subprocess
import sys
from pathlib import Path

# K2's four main-path forms (second input?, scale, subpixel, margin,
# aggregate out) and each form's volumes and (H, W) planes moved
from chip_smoke import WORK, WTA_FORMS

HBM_BYTES_PER_S = 3.35e12
SHAPES = (((80, 896, 896), 1), ((144, 1152, 1152), 2))
DEEP_SHAPES = (((600, 256, 1024), 1), ((1024, 256, 1024), 1))
P1, P2 = 0.03, 0.48
AXES = ((True, "h"), (False, "v"))   # (horizontal, name)


def _events_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _bound_ms(volumes: float, v_bytes: int, plane_bytes: int = 0) -> float:
    return (volumes * v_bytes + plane_bytes) / HBM_BYTES_PER_S * 1e3


def _wta_row(K, form: str, a, b, d_min: int, stride: int) -> dict:
    """K2 in one form of :data:`WTA_FORMS` on ``a`` (and ``b``): every
    output bit-exact against its plain version, its time and its bound."""
    import torch

    two, scale, sub, mg, with_s = WTA_FORMS[form]
    vols, planes, _ = WORK[f"wta:{form}"]
    args = (a, b if two else None, scale, d_min, stride, sub, mg, with_s)
    got, ref = K.wta(*args), K.wta_plain(*args)
    ok = all(torch.equal(g, r) for g, r in zip(got, ref) if r is not None)
    del got, ref
    ms = _events_ms(lambda: K.wta(*args))
    D, H, W = a.shape
    bound = _bound_ms(vols, a.numel() * a.element_size(), planes * H * W * 4)
    return dict(exact=bool(ok), ms=ms, bound_ms=bound, share=bound / ms)


DTYPES = ("float32", "bfloat16")


def _volumes(shape, dtype: str = "float32"):
    """The seeded cost volume of ``shape`` and a second one (the
    accumulator, or ``prev``), rounded to ``dtype``."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(shape[0])
    dt = getattr(torch, dtype)
    return (torch.rand(shape, generator=gen, device="cuda").to(dt),
            torch.rand(shape, generator=gen, device="cuda").to(dt))


def _blocked(vol, horizontal: bool):
    """The blocked (nb, S, D, 128) copy of a (D, H, W) volume whose scan
    axis is W (``horizontal``) or H; H and W are multiples of 128."""
    D, H, W = vol.shape
    if horizontal:
        v = vol.permute(2, 0, 1).reshape(W, D, H // 128, 128)
    else:
        v = vol.permute(1, 0, 2).reshape(H, D, W // 128, 128)
    return v.permute(2, 0, 1, 3).contiguous()


def _pair_row(fwd, acc, fwd_plain, acc_plain, v_bytes: int) -> dict:
    """Exactness and times of a forward launch (2 volumes) and of one with
    a second input (3 volumes); ``acc(first)`` takes the forward result."""
    import torch

    first = fwd()
    ok = torch.equal(first, fwd_plain())
    ok &= torch.equal(acc(first.clone()), acc_plain(first.clone()))
    ms_f, ms_a = _events_ms(fwd), _events_ms(lambda: acc(first))
    b_f, b_a = _bound_ms(2, v_bytes), _bound_ms(3, v_bytes)
    return dict(exact=bool(ok), fwd_ms=ms_f, acc_ms=ms_a,
                mean_ms=(ms_f + ms_a) / 2, bound_ms=(b_f + b_a) / 2,
                share=(b_f + b_a) / (ms_f + ms_a))


def turn(root: str, dtype: str = "float32", shapes=SHAPES) -> dict:
    root = str(Path(root).resolve())
    sys.path.insert(0, root)
    import torch
    from pcmi_tpu_torch.ops.stereo import kernels as K

    assert K.__file__.startswith(root), K.__file__
    res = {"root": root, "dtype": dtype}
    for (D, H, W), stride in shapes:
        vol, acc = _volumes((D, H, W), dtype)
        v_bytes = vol.numel() * vol.element_size()
        row = {}
        for horizontal, axis in AXES:
            row[f"sgm_{axis}"] = _pair_row(
                lambda: K.sgm_dir(vol, P1, P2, horizontal, False),
                lambda o: K.sgm_dir(vol, P1, P2, horizontal, True, out=o),
                lambda: K.sgm_dir_plain(vol, P1, P2, horizontal, False),
                lambda o: K.sgm_dir_plain(vol, P1, P2, horizontal, True,
                                          out=o), v_bytes)
        d_min = -(D * stride) // 2
        got = K.derive_right(vol, d_min, 1.0, stride)
        ok = torch.equal(got, K.derive_right_plain(vol, d_min, 1.0, stride))
        del got
        ms = _events_ms(lambda: K.derive_right(vol, d_min, 1.0, stride))
        row["derive_right"] = dict(exact=bool(ok), ms=ms,
                                   bound_ms=_bound_ms(2, v_bytes),
                                   share=_bound_ms(2, v_bytes) / ms)
        for form in WTA_FORMS:
            row[f"wta_{form}"] = _wta_row(K, form, vol, acc, d_min, stride)
        del acc
        # K6 on the (W, D, H) copy of the volume, unpadded (as chip_smoke's
        # phase 3 runs it)
        wdh = vol.permute(2, 0, 1).contiguous()
        got = K.derive_right_wdh(wdh, D, W, d_min, stride, 1.0)
        ok = torch.equal(got, K.derive_right_wdh_plain(wdh, D, W, d_min,
                                                       stride, 1.0))
        del got
        ms = _events_ms(lambda: K.derive_right_wdh(wdh, D, W, d_min, stride,
                                                   1.0))
        row["derive_right_wdh"] = dict(exact=bool(ok), ms=ms,
                                       bound_ms=_bound_ms(2, v_bytes),
                                       share=_bound_ms(2, v_bytes) / ms)
        del wdh
        hwd = vol.permute(1, 2, 0).contiguous()
        for horizontal, axis in AXES if dtype == "float32" else ():
            ax = 1 if horizontal else 0
            row[f"hwd_{axis}"] = _pair_row(
                lambda: K.sgm_hwd(hwd, P1, P2, ax, False),
                lambda o: K.sgm_hwd(hwd, P1, P2, ax, True, out=o),
                lambda: K.sgm_hwd_plain(hwd, P1, P2, ax, False),
                lambda o: K.sgm_hwd_plain(hwd, P1, P2, ax, True, out=o),
                v_bytes)
        del hwd
        for horizontal, axis in AXES:
            vb = _blocked(vol, horizontal)
            row[f"blocked_{axis}"] = _pair_row(
                lambda: K.sgm_blocked(vb, P1, P2, False),
                lambda o: K.sgm_blocked(vb, P1, P2, True, prev=o),
                lambda: K.sgm_blocked_plain(vb, P1, P2, False),
                lambda o: K.sgm_blocked_plain(vb, P1, P2, True, prev=o),
                v_bytes)
            del vb
        res[f"{D}x{H}x{W}"] = row
        del vol
        torch.cuda.empty_cache()
    return res


def _bind(lib):
    import ctypes

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    argtypes = {
        "pcmi_sgm_dir": [p, p, i, i, i, i, i, i, f, f, i, i, i, p],
        "pcmi_sgm_hwd": [p, p, i, i, i, i, i, i, f, f, i, p],
        "pcmi_sgm_blocked": [p, p, p, i, i, i, f, f, i, i, i, i, p],
        "pcmi_wta": [p, p, i, i, i, f, f, f, i, p, p, p, p, i, p],
    }
    for name, types in argtypes.items():
        getattr(lib, name).argtypes = types
        getattr(lib, name).restype = i
    return lib


_ABLATED = ("sgm_dir.cu", "sgm_hwd.cu", "sgm_blocked.cu", "wta.cu")
# variant: extra nvcc flags; the switches are in sgm_tile.cuh and wta.cu
ABLATIONS = {
    "full": (),
    "copy_only": ("-DSGM_NO_SCAN", "-DWTA_NO_CHAIN"),
    "scan_only": ("-DSGM_NO_COPY", "-DWTA_NO_LOADS"),
}
PLANS = {"full": ()}


def _ablation_libs(root: Path, variants: dict) -> dict:
    """Build each variant of the SGM kernels and K2 (one nvcc each, all
    started together) into ``build/kernel_ab`` and load it."""
    import ctypes

    from pcmi_tpu_torch.ops.stereo import _build

    out = root / "build/kernel_ab"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in variants.items():
        so = out / f"ablated_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "--threads",
             str(len(_ABLATED)), "-shared", "-o",
             str(so), *(str(_build.CSRC_DIR / s) for s in _ABLATED)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"ablation {name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _raw_launchers(K, vol, out, hwd, hwd_out, blocked):
    """``{kernel: f(lib, axis/horizontal, second input?, plan)}``: direct
    calls of the C entry points, reverse scans, on preallocated tensors."""
    import torch

    D, H, W = vol.shape
    bf16 = int(vol.dtype == torch.bfloat16)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def k1(lib, horizontal, acc, plan):
        return lib.pcmi_sgm_dir(vol.data_ptr(), out.data_ptr(), D, H, W,
                                int(horizontal), 1, int(acc), P1, P2,
                                plan[0], plan[1], bf16, stream())

    def k4(lib, horizontal, acc, plan):
        return lib.pcmi_sgm_hwd(hwd.data_ptr(), hwd_out.data_ptr(), H, W, D,
                                int(horizontal), 1, int(acc), P1, P2,
                                plan[0], stream())

    def k5(lib, horizontal, acc, plan):
        vb = blocked[horizontal]
        return lib.pcmi_sgm_blocked(
            vb.data_ptr(), out.data_ptr() if acc else None,
            hwd_out.data_ptr(), vb.shape[0], vb.shape[1], D, P1, P2, 1,
            plan[0], plan[1], bf16, stream())

    if bf16:  # K4 is float32 only
        return {"sgm_dir": k1, "sgm_blocked": k5}
    return {"sgm_dir": k1, "sgm_hwd": k4, "sgm_blocked": k5}


def _timed(call, *args) -> float | None:
    """ms per launch, or None where the entry point refuses the plan."""
    if call(*args):
        return None

    def run():
        if call(*args):
            raise SystemExit("launch refused after it was accepted")
    return _events_ms(run)


def _wta_ablation(libs: dict, vol, second, d_min: int, stride: int) -> None:
    """One JSON line per K2 form: its time in each build variant."""
    import torch

    D, H, W = vol.shape
    disp, best, margin = (torch.empty((H, W), device="cuda")
                          for _ in range(3))
    agg = torch.empty_like(vol)
    bf16 = int(vol.dtype == torch.bfloat16)
    for form, (two, scale, sub, mg, with_s) in WTA_FORMS.items():
        vols, planes, _ = WORK[f"wta:{form}"]

        def call(lib):
            return lib.pcmi_wta(
                vol.data_ptr(), second.data_ptr() if two else None, D, H, W,
                scale, float(d_min), float(stride), int(sub),
                disp.data_ptr(), best.data_ptr(),
                margin.data_ptr() if mg else None,
                agg.data_ptr() if with_s else None, bf16,
                torch.cuda.current_stream().cuda_stream)

        row = dict(kernel="wta", form=form, dtype=str(vol.dtype)[6:],
                   shape=[D, H, W], bound_ms=_bound_ms(
                       vols, vol.numel() * vol.element_size(),
                       planes * H * W * 4))
        for variant, lib in libs.items():
            row[f"{variant}_ms"] = _timed(call, lib)
        print(json.dumps(row), flush=True)


def _study(ablation: bool, dtype: str = "float32") -> None:
    import torch

    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from pcmi_tpu_torch.ops.stereo import kernels as K

    libs = {n: _bind(lib) for n, lib in _ablation_libs(
        root, ABLATIONS if ablation else PLANS).items()}
    esize = 2 if dtype == "bfloat16" else 4
    for (D, H, W), stride in SHAPES:
        vol, out = _volumes((D, H, W), dtype)
        if ablation:
            _wta_ablation(libs, vol, out, -(D * stride) // 2, stride)
        hwd = vol.permute(1, 2, 0).contiguous()
        hwd_out = torch.empty_like(hwd)
        blocked = {hz: _blocked(vol, hz) for hz, _ in AXES}
        calls = _raw_launchers(K, vol, out, hwd, hwd_out, blocked)
        v_bytes = vol.numel() * esize
        for name, (horizontal, axis), acc in itertools.product(
                calls, AXES, (False, True)):
            if name == "sgm_dir":
                chosen = K.sgm_dir_plan(D, H if horizontal else W,
                                        horizontal, acc, esize)[:2]
                plans = [chosen]
            elif name == "sgm_hwd":
                chosen = (K.sgm_hwd_plan(D, acc).tile,)
                plans = [(t,) for t in (1, 2, 4, 8, 16, 32)]
            else:
                chosen = K.sgm_blocked_plan(
                    D, blocked[horizontal].shape[0], acc, esize)[:2]
                plans = list(itertools.product((8, 16), (1, 2, 4, 8)))
            row = dict(kernel=name, dtype=dtype, shape=[D, H, W], axis=axis,
                       second_input=acc, plan=list(chosen),
                       bound_ms=_bound_ms(3 if acc else 2, v_bytes))
            if ablation:
                for variant, lib in libs.items():
                    row[f"{variant}_ms"] = _timed(
                        calls[name], lib, horizontal, acc, chosen)
            else:
                row["ms_by_plan"] = {
                    "x".join(map(str, plan)): _timed(
                        calls[name], libs["full"], horizontal, acc, plan)
                    for plan in plans}
            print(json.dumps(row), flush=True)
        del hwd, hwd_out, blocked, calls
        if ablation:
            prof_ms = {}
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for horizontal, _ in AXES:
                    K.sgm_pair(vol, P1, P2, horizontal)
                torch.cuda.synchronize()
            for ev in prof.key_averages():
                t = getattr(ev, "device_time_total", None)
                if t is None:
                    t = ev.cuda_time_total
                if "sgm_tile" in ev.key:
                    prof_ms[ev.key[:60]] = dict(count=ev.count, ms=t / 1e3)
            print(json.dumps(dict(shape=[D, H, W], profiler=prof_ms)),
                  flush=True)
        del vol, out
        torch.cuda.empty_cache()


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def _root_dtype(arg: str) -> tuple[str, str]:
    """``ROOT`` or ``ROOT:DTYPE`` as (root, dtype)."""
    root, _, dtype = arg.partition(":")
    dtype = dtype or "float32"
    if dtype not in DTYPES:
        raise SystemExit(f"kernel_ab: unknown dtype {dtype!r}")
    return root, dtype


def main() -> int:
    if sys.argv[1:2] in (["--ablate"], ["--plans"]) and (
            len(sys.argv) == 2 or (len(sys.argv) == 4
                                   and sys.argv[2] == "--dtype")):
        dtype = _root_dtype(":" + sys.argv[3])[1] if len(sys.argv) == 4 \
            else "float32"
        print(_smi())
        _study(ablation=sys.argv[1] == "--ablate", dtype=dtype)
        return 0
    if len(sys.argv) >= 3 and sys.argv[1] == "--turn":
        shapes = DEEP_SHAPES if sys.argv[3:] == ["--deep"] else SHAPES
        print(json.dumps(turn(*_root_dtype(sys.argv[2]), shapes=shapes)))
        return 0
    import torch

    deep = sys.argv[1:2] == ["--deep"]
    roots = sys.argv[2:] if deep else sys.argv[1:]
    if not torch.cuda.is_available() or not roots:
        print("kernel_ab: needs a CUDA card and at least one ROOT",
              file=sys.stderr)
        return 1
    print(_smi())
    for root in roots:
        proc = subprocess.run([sys.executable, __file__, "--turn", root,
                               *(["--deep"] if deep else [])],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
