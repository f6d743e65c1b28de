#!/usr/bin/env python3
"""Time the main path's SGM and right-view kernels (K1 ``sgm_dir``, K3
``derive_right``) of one or more checkouts of the port on one CUDA card,
in turns, one process per turn.

    python3 kernel_ab.py ROOT [ROOT ...]

Each ROOT is a directory holding a ``pcmi_tpu_torch`` package (this
checkout, or an older one unpacked beside it); the turns run in the order
given, so ``parent new new parent`` compares two versions on one card. Each
turn builds that checkout's kernels, checks K1 and K3 bit-exact against
their plain versions, and times, with CUDA events over 10 launches after a
warm-up, K1's four launch kinds (horizontal / vertical, forward /
accumulate) and K3 at (80, 896, 896) stride 1 and (144, 1152, 1152) stride 2.
It prints one JSON line per turn, each time beside its bound: the bytes the
launch must move (each input read once, each output written once) over the
H100's 3.35 TB/s. The card's name and power limit come first.

    python3 kernel_ab.py --ablate

takes K1 of this checkout apart at its launch plans: each launch kind at
both shapes timed as built, with the scan left out (the tile copies
alone) and with the copies left out (the scan alone, on whatever the ring
holds), one JSON line each; then ``torch.profiler``'s device time of the
kernels one ``sgm_pair`` per axis launches.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
SHAPES = (((80, 896, 896), 1), ((144, 1152, 1152), 2))


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


def turn(root: str) -> dict:
    sys.path.insert(0, root)
    import torch
    from pcmi_tpu_torch.ops.stereo import kernels as K

    assert K.__file__.startswith(root), K.__file__
    res = {"root": root}
    p1, p2 = 0.03, 0.48
    for (D, H, W), stride in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(D)
        vol = torch.rand((D, H, W), generator=gen, device="cuda")
        acc = torch.rand((D, H, W), generator=gen, device="cuda")
        v_bytes = vol.numel() * 4
        row = {}
        for horizontal, axis in ((True, "h"), (False, "v")):
            fwd = K.sgm_dir(vol, p1, p2, horizontal, False)
            ref = K.sgm_dir_plain(vol, p1, p2, horizontal, False)
            ok = torch.equal(fwd, ref)
            del ref
            got = K.sgm_dir(vol, p1, p2, horizontal, True, out=acc.clone())
            ok &= torch.equal(got, K.sgm_dir_plain(vol, p1, p2, horizontal,
                                                   True, out=acc.clone()))
            del got
            ms_f = _events_ms(lambda: K.sgm_dir(vol, p1, p2, horizontal,
                                                False, out=None))
            ms_a = _events_ms(lambda: K.sgm_dir(vol, p1, p2, horizontal,
                                                True, out=fwd))
            bound_f = 2 * v_bytes / HBM_BYTES_PER_S * 1e3
            bound_a = 3 * v_bytes / HBM_BYTES_PER_S * 1e3
            row[f"sgm_{axis}"] = dict(
                exact=bool(ok), fwd_ms=ms_f, acc_ms=ms_a,
                mean_ms=(ms_f + ms_a) / 2, bound_ms=(bound_f + bound_a) / 2,
                share=(bound_f + bound_a) / (ms_f + ms_a))
            del fwd
        d_min = -(D * stride) // 2
        got = K.derive_right(vol, d_min, 1.0, stride)
        ok = torch.equal(got, K.derive_right_plain(vol, d_min, 1.0, stride))
        del got
        ms = _events_ms(lambda: K.derive_right(vol, d_min, 1.0, stride))
        bound = 2 * v_bytes / HBM_BYTES_PER_S * 1e3
        row["derive_right"] = dict(exact=bool(ok), ms=ms, bound_ms=bound,
                                   share=bound / ms)
        res[f"{D}x{H}x{W}"] = row
        del vol, acc
        torch.cuda.empty_cache()
    return res


# K1's source, cut down: (pattern, replacement) pairs for each variant
ABLATIONS = {
    "full": (),
    "copy_only": (("const bool active = warp < g.P && lo + warp < g.span;",
                   "const bool active = false;"),),
    "scan_only": (("      cp_async(c + si, cost + gi, g.vec);\n"
                   "      if (kAcc) cp_async(c + tile + si, out + gi, g.vec);\n",
                   ""),
                  ("    const float* res = cbuf(j);\n",
                   "    const float* res = cbuf(j);\n    if (false)\n")),
}


def _ablation_libs(root: Path) -> dict:
    """Build each variant of ``csrc/sgm_dir.cu`` (one nvcc each, all
    started together) into ``build/kernel_ab`` and load it."""
    import ctypes

    from pcmi_tpu_torch.ops.stereo import _build

    src = (root / "pcmi_tpu_torch/csrc/sgm_dir.cu").read_text()
    out = root / "build/kernel_ab"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in ABLATIONS.items():
        text = src
        for a, b in subs:
            if a not in text:
                raise SystemExit(f"ablation {name}: pattern not in the source")
            text = text.replace(a, b)
        (out / f"k1_{name}.cu").write_text(text)
        so = out / f"k1_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(so), str(out / f"k1_{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"ablation {name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.pcmi_sgm_dir.argtypes = [p, p, i, i, i, i, i, i, f, f, i, i, p]
        lib.pcmi_sgm_dir.restype = i
        libs[name] = lib
    return libs


def ablate() -> None:
    import torch

    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from pcmi_tpu_torch.ops.stereo import kernels as K

    libs = _ablation_libs(root)
    p1, p2 = 0.03, 0.48
    for (D, H, W), _ in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(D)
        vol = torch.rand((D, H, W), generator=gen, device="cuda")
        out = torch.rand((D, H, W), generator=gen, device="cuda")
        v_bytes = vol.numel() * 4
        for horizontal in (True, False):
            for acc in (False, True):
                plan = K.sgm_dir_plan(D, H if horizontal else W, horizontal,
                                      acc)
                row = dict(shape=[D, H, W], horizontal=horizontal,
                           accumulate=acc, plan=list(plan),
                           bound_ms=(3 if acc else 2) * v_bytes
                           / HBM_BYTES_PER_S * 1e3)
                for name, lib in libs.items():
                    def run(lib=lib):
                        rc = lib.pcmi_sgm_dir(
                            vol.data_ptr(), out.data_ptr(), D, H, W,
                            int(horizontal), 1, int(acc), p1, p2, plan.paths,
                            plan.tile, torch.cuda.current_stream().cuda_stream)
                        if rc:
                            raise SystemExit(f"ablation {name}: rc {rc}")
                    row[f"{name}_ms"] = _events_ms(run)
                print(json.dumps(row), flush=True)
        prof_ms = {}
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for horizontal in (True, False):
                K.sgm_pair(vol, p1, p2, horizontal)
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = ev.cuda_time_total
            if "sgm_dir" in ev.key:
                prof_ms[ev.key[:60]] = dict(count=ev.count, ms=t / 1e3)
        print(json.dumps(dict(shape=[D, H, W], profiler=prof_ms)), flush=True)
        del vol, out
        torch.cuda.empty_cache()


def main() -> int:
    if sys.argv[1:] == ["--ablate"]:
        ablate()
        return 0
    if len(sys.argv) >= 3 and sys.argv[1] == "--turn":
        print(json.dumps(turn(sys.argv[2])))
        return 0
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print("kernel_ab: needs a CUDA card and at least one ROOT",
              file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for root in sys.argv[1:]:
        proc = subprocess.run([sys.executable, __file__, "--turn", root],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
