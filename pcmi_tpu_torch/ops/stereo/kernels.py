"""The matcher's hand-written Hopper kernels, their plain versions and
their wrappers.

* K1 ``sgm_dir``: one SGM direction over (D, H, W); replaces
  ``_dir_call_sub`` / ``_make_dir_kernel_sub``
  (``pcmi_tpu/ops/stereo/pallas_kernels.py``). Source ``csrc/sgm_dir.cu``.
* K2 ``wta``: combine + winner-takes-all, with the combined aggregate as a
  fourth output on request; replaces
  ``sgm4_wta_fused_pallas`` / ``_make_wta3_kernel`` (``with_aggregate``
  included),
  ``right_disparity_fused_pallas`` / ``_make_wta2_kernel`` and
  ``wta_fused_pallas`` / ``_make_wta_kernel``. Source ``csrc/wta.cu``.
* K3 ``derive_right``: right-view volume; replaces ``derive_right_pallas``
  / ``_make_derive_kernel``. Source ``csrc/derive_right.cu``.
* K4 ``sgm_hwd``: one SGM direction over (H, W, D); replaces ``_dir_call``
  / ``_make_dir_kernel``. Source ``csrc/sgm_hwd.cu``.
* K5 ``sgm_blocked``: one SGM direction over a blocked (nb, S, Dp, 128)
  volume, optionally adding a second input; replaces ``_blocked_dir_sum``
  / ``_make_blocked_kernel``. Source ``csrc/sgm_blocked.cu``.
* K6 ``derive_right_wdh``: right-view volume in the padded (Wp, Dp, Hp)
  layout; replaces ``derive_right_wdh_pallas`` /
  ``_make_derive_wdh_kernel``. Source ``csrc/derive_right_wdh.cu``.
* K7 ``cost_volume``: the box-aggregated census+AD cost volume, written
  once; and ``census``, the census transform of one image. No TPU kernel:
  the reference builds both in XLA (``matching.build_cost_volume``).
  Source ``csrc/cost_volume.cu``.

Each wrapper of K1-K6 takes contiguous float32 or bfloat16 tensors (all
tensors of one call the same; K4 float32 only, as its TPU kernel), on any
device, and
raises (``TypeError`` for another dtype, ``ValueError`` for a wrong shape or
layout) before it runs anything. A tensor on the CPU then goes through the
kernel's plain PyTorch version; a CUDA tensor launches the kernel on the
current stream, or raises :class:`KernelError` (a failed build or a
refused launch). There is no fallback from the card to the plain version.
:data:`LAUNCHES` counts kernel launches per kernel; only a launch adds to
it.

Volumes are stored in float32 or, under
``StereoConfig.cost_dtype="bfloat16"``, in bfloat16, with the TPU kernels'
rounding rules: a kernel widens what it reads, keeps the recurrence state
and every (H, W) plane in float32, and rounds a volume to nearest-even
where it stores it; sums of two stored volumes are bfloat16 adds (both
operands already rounded, the sum rounded again). ``BIG`` and ``fill``
take the stored dtype's value where they are stored (998244352 and, for
``fill=1e4``, 9984 in bfloat16). Each source file
notes what bounds its kernel on the card and what its design does about it.
K1-K3, K7 and the census run on the matcher's main path; K4-K6 behind the
alternative-layout entry points of :mod:`pcmi_tpu_torch.ops.stereo.layouts`. K1 and K5 are one
tile kernel (``csrc/sgm_tile.cuh``) under two sets of strides, and K4 uses
its scan step; each has a launch plan here (:func:`sgm_dir_plan`,
:func:`sgm_blocked_plan`, :func:`sgm_hwd_plan`, and K7's
:func:`cost_volume_plan`) that the CPU tests check against the card's
shared memory.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from pcmi_tpu_torch.ops.stereo._build import KernelError

BIG = 1e9  # the reference's "no neighbour" / "never wins" value

LAUNCHES = {"sgm_dir": 0, "wta": 0, "derive_right": 0, "sgm_hwd": 0,
            "sgm_blocked": 0, "derive_right_wdh": 0, "cost_volume": 0,
            "census": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


VOLUME_DTYPES = (torch.float32, torch.bfloat16)


def _on_cuda(name: str, *tensors: torch.Tensor | None,
             dtypes=VOLUME_DTYPES) -> bool:
    """True for CUDA tensors, False for CPU ones, after checking that all
    lie on one device, share one of ``dtypes`` and are contiguous."""
    ts = [t for t in tensors if t is not None]
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in ts:
        if t.dtype not in dtypes or t.dtype != ts[0].dtype:
            raise TypeError(
                f"{name}: expected all tensors in one of "
                f"{[str(d).split('.')[-1] for d in dtypes]}, got "
                f"{[str(u.dtype).split('.')[-1] for u in ts]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return dev.type == "cuda"


def _check(name: str, rc: int) -> None:
    if rc != 0:
        raise KernelError(f"{name}: CUDA launch failed, cudaError_t {rc}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# K1 sgm_dir
# ---------------------------------------------------------------------------


def _scan_plain(cost: torch.Tensor, axis: int, d_axis: int, p1: float,
                p2: float, reverse: bool, out: torch.Tensor | None,
                round_first: bool = True) -> torch.Tensor:
    """One SGM direction along ``axis`` of ``cost`` (``matching._sgm_scan``);
    ``d_axis`` is the disparity axis of a scan step's state. With ``out``
    given the direction is added into it (in place), else a new volume is
    returned. The output is preallocated and written step by step.

    The state is float32 whatever ``cost`` stores. A bfloat16 ``out`` takes
    the direction by one of the reference's two rules: ``round_first``
    rounds the direction to bfloat16 and adds two stored values (K1: ``lr +
    rl`` of two stored volumes), else the float32 state is added and the sum
    rounded once (K5's ``prev`` form). In float32 the two are one."""
    n = cost.shape[axis]
    acc = out is not None
    if out is None:
        out = torch.empty_like(cost)
    prev = torch.zeros_like(cost.select(axis, 0), dtype=torch.float32)
    nd = prev.shape[d_axis]
    big = torch.full_like(prev.narrow(d_axis, 0, 1), BIG)
    for t in range(n):
        s = n - 1 - t if reverse else t
        c = cost.select(axis, s)
        m = prev.amin(d_axis, keepdim=True)
        up = torch.cat([big, prev.narrow(d_axis, 0, nd - 1)], d_axis)
        dn = torch.cat([prev.narrow(d_axis, 1, nd - 1), big], d_axis)
        best = torch.minimum(torch.minimum(prev, m + p2),
                             torch.minimum(up + p1, dn + p1))
        prev = c + best - m
        o = out.select(axis, s)
        if not acc:
            o.copy_(prev)
        elif round_first:
            o.add_(prev.to(o.dtype))
        else:
            o.copy_(prev + o)
    return out


def sgm_dir_plain(cost: torch.Tensor, p1: float, p2: float, horizontal: bool,
                  reverse: bool, out: torch.Tensor | None = None) -> torch.Tensor:
    """One SGM direction over a (D, H, W) volume (``matching._sgm_scan``).

    ``horizontal`` scans along W (state (D, H)), else along H (state
    (D, W)); ``reverse`` scans from the far end. With ``out`` given the
    direction is added into it (in place), else a new volume is returned.
    A bfloat16 volume is widened as it is read and the direction rounded
    as it is stored; added into ``out`` it is rounded first, so ``out``
    is the bfloat16 sum of two stored volumes, as the reference's
    ``lr + rl``."""
    return _scan_plain(cost, 2 if horizontal else 1, 0, p1, p2, reverse, out)


SGM_DIR_MAX_DISP = 1024      # csrc/sgm_tile.cuh: 32 disparities per lane
SMEM_BLOCK_MAX = 232_448     # shared memory one block may use on sm_90


class SgmDirPlan(NamedTuple):
    """K1's launch plan: blocks of ``paths`` paths (one warp each; the
    kernel adds warps that only copy, up to 8), tiles of ``tile`` scan
    steps, ``smem`` bytes of shared memory per block."""
    paths: int
    tile: int
    smem: int


def _esize(dtype: torch.dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


def sgm_dir_smem(D: int, paths: int, tile: int, accumulate: bool,
                 esize: int = 4) -> int:
    """Shared memory of one block of the tile kernel of K1 and K5
    (``tile_smem_bytes`` in ``csrc/sgm_tile.cuh``): a ring of two tiles of
    ``D`` planes of ``paths * tile`` elements of ``esize`` bytes plus 16
    bytes, twice that with ``accumulate`` (the tile of the second input
    beside the cost tile)."""
    return (2 * D * (paths * tile + 16 // esize) * (2 if accumulate else 1)
            * esize)


def sgm_dir_plan(D: int, span: int, horizontal: bool, accumulate: bool,
                 esize: int = 4) -> SgmDirPlan:
    """K1's launch plan for ``span`` paths of ``D`` disparities stored in
    ``esize`` bytes each (a bfloat16 tile is half the bytes, so a deep
    volume may take a longer tile than in float32).

    Horizontal scans take blocks of 4 rows and the longest tile (32, 16,
    ... steps: the run of x each (d, row) moves); vertical ones blocks of
    16 columns where that still gives 64 blocks, else 8, and tiles of 8, 4,
    2 or 1 rows; each the longest that fits. Past 512 disparities a
    vertical block of 16 columns may not fit at all (accumulating, from
    D = 727 in float32): it then takes 8."""
    if not 1 <= D <= SGM_DIR_MAX_DISP:
        raise ValueError(f"sgm_dir: D={D} outside [1, {SGM_DIR_MAX_DISP}]")
    if horizontal:
        options = ((4, (32, 16, 8, 4, 2, 1)),)
    else:
        options = tuple((p, (8, 4, 2, 1))
                        for p in ((16, 8) if span >= 16 * 64 else (8,)))
    for paths, tiles in options:
        for tile in tiles:
            smem = sgm_dir_smem(D, paths, tile, accumulate, esize)
            if smem <= SMEM_BLOCK_MAX:
                return SgmDirPlan(paths, tile, smem)
    raise ValueError(f"sgm_dir: no launch plan fits D={D}")


def sgm_pair_plan_text(shape, horizontal: bool, esize: int = 4) -> str:
    """K1's plans for :func:`sgm_pair` on a (D, H, W) volume, as a span's
    count: the axis (``h`` or ``v``), then paths x tile steps of the
    forward launch and of the accumulating one, e.g. ``"h 4x4+4x2"``."""
    D, H, W = shape
    span = H if horizontal else W
    fwd, acc = (sgm_dir_plan(D, span, horizontal, a, esize)
                for a in (False, True))
    return (f"{'h' if horizontal else 'v'} {fwd.paths}x{fwd.tile}"
            f"+{acc.paths}x{acc.tile}")


def sgm_dir(cost: torch.Tensor, p1: float, p2: float, horizontal: bool,
            reverse: bool, out: torch.Tensor | None = None) -> torch.Tensor:
    """K1 wrapper: see :func:`sgm_dir_plain` for the semantics."""
    if cost.dim() != 3:
        raise ValueError(f"sgm_dir: expected (D, H, W), got {tuple(cost.shape)}")
    if out is not None and out.shape != cost.shape:
        raise ValueError("sgm_dir: out must have the cost volume's shape")
    if not _on_cuda("sgm_dir", cost, out):
        return sgm_dir_plain(cost, p1, p2, horizontal, reverse, out)
    from pcmi_tpu_torch.ops.stereo._build import load

    lib = load()
    D, H, W = cost.shape
    acc = out is not None
    esize = _esize(cost.dtype)
    plan = sgm_dir_plan(D, H if horizontal else W, horizontal, acc, esize)
    if out is None:
        out = torch.empty_like(cost)
    rc = lib.pcmi_sgm_dir(cost.data_ptr(), out.data_ptr(), D, H, W,
                          int(horizontal), int(reverse), int(acc),
                          float(p1), float(p2), plan.paths, plan.tile,
                          int(esize == 2), _stream())
    _check("sgm_dir", rc)
    LAUNCHES["sgm_dir"] += 1
    return out


def sgm_pair(cost: torch.Tensor, p1: float, p2: float,
             horizontal: bool) -> torch.Tensor:
    """Sum of the two directions along one axis (lr + rl, or tb + bt)."""
    out = sgm_dir(cost, p1, p2, horizontal, reverse=False)
    return sgm_dir(cost, p1, p2, horizontal, reverse=True, out=out)


# ---------------------------------------------------------------------------
# K2 wta
# ---------------------------------------------------------------------------


def wta_plain(a: torch.Tensor, b: torch.Tensor | None, scale: float,
              d_min: int, stride: int = 1, subpixel: bool = True,
              with_margin: bool = True, with_aggregate: bool = False):
    """Combine ``s = (a + b) * scale`` (or ``a * scale``) and take the WTA
    in the XLA form of ``matching.wta_disparity``.

    Returns ``(disp, best, margin)``; ``margin`` is None without
    ``with_margin``. With ``with_aggregate`` the combined (D, H, W) volume
    ``s`` is a fourth value (``sgm4_wta_fused_pallas(with_aggregate=True)``,
    in this port's layout).

    On bfloat16 volumes ``a + b`` and the product are bfloat16 operations
    (each rounded to nearest-even, ``scale`` rounded too: 1, 0.5 and 0.25,
    the scales the matcher uses, are exact); ``s`` is then widened and the
    argmin, the parabola, the best cost and the margin are float32. Where
    no slice lies more than one away from the best (D <= 3) the margin is
    ``BIG - best`` with ``BIG`` in the volume's dtype (998244352 in
    bfloat16), as the reference's."""
    stored_big = torch.tensor(BIG, dtype=a.dtype).item()
    if a.dtype == torch.bfloat16:
        vol = a + b if b is not None else a
        if scale != 1.0:
            sc = torch.tensor(scale, dtype=torch.bfloat16).item()
            vol = (vol.float() * sc).to(torch.bfloat16)
    else:
        vol = (a + b) * scale if b is not None else a * scale
    agg = vol if with_aggregate else None
    vol = vol.float()
    D = vol.shape[0]
    best_d = vol.argmin(0)
    best = vol.amin(0)
    if subpixel:
        big = torch.full_like(vol[:1], BIG)
        prev = torch.cat([big, vol[:-1]], 0).gather(0, best_d[None])[0]
        nxt = torch.cat([vol[1:], big], 0).gather(0, best_d[None])[0]
        denom = prev - 2 * best + nxt
        ok = (denom > 1e-9) & (best_d > 0) & (best_d < D - 1)
        offset = torch.where(ok, 0.5 * (prev - nxt) / denom.clamp_min(1e-9),
                             torch.zeros_like(denom))
        disp = d_min + stride * (best_d.float() + offset.clamp(-1.0, 1.0))
    else:
        disp = d_min + stride * best_d.float()
    margin = None
    if with_margin:
        ds = torch.arange(D, device=vol.device).view(D, 1, 1)
        away = (ds - best_d[None]).abs() > 1
        second = torch.where(away, vol,
                             torch.full_like(vol, stored_big)).amin(0)
        margin = second - best
    return (disp, best, margin, agg) if with_aggregate else (disp, best,
                                                             margin)


def wta(a: torch.Tensor, b: torch.Tensor | None, scale: float, d_min: int,
        stride: int = 1, subpixel: bool = True, with_margin: bool = True,
        with_aggregate: bool = False):
    """K2 wrapper: see :func:`wta_plain` for the semantics. The combined
    aggregate exists only for two inputs: ``with_aggregate`` with one
    raises."""
    if a.dim() != 3 or (b is not None and b.shape != a.shape):
        raise ValueError("wta: expected one or two (D, H, W) volumes")
    if with_aggregate and b is None:
        raise ValueError("wta: with_aggregate combines two volumes")
    if not _on_cuda("wta", a, b):
        return wta_plain(a, b, scale, d_min, stride, subpixel, with_margin,
                         with_aggregate)
    from pcmi_tpu_torch.ops.stereo._build import load

    lib = load()
    D, H, W = a.shape
    disp = torch.empty((H, W), dtype=torch.float32, device=a.device)
    best = torch.empty_like(disp)
    margin = torch.empty_like(disp) if with_margin else None
    agg = torch.empty_like(a) if with_aggregate else None
    rc = lib.pcmi_wta(a.data_ptr(), b.data_ptr() if b is not None else None,
                      D, H, W, float(scale), float(d_min), float(stride),
                      int(subpixel), disp.data_ptr(), best.data_ptr(),
                      margin.data_ptr() if margin is not None else None,
                      agg.data_ptr() if agg is not None else None,
                      int(a.dtype == torch.bfloat16), _stream())
    _check("wta", rc)
    LAUNCHES["wta"] += 1
    return (disp, best, margin, agg) if with_aggregate else (disp, best,
                                                             margin)


# ---------------------------------------------------------------------------
# K3 derive_right
# ---------------------------------------------------------------------------


def derive_right_plain(vol: torch.Tensor, d_min: int, fill: float = 1.0,
                       stride: int = 1) -> torch.Tensor:
    """``out[i, y, x] = vol[i, y, x + d_min + i*stride]``, ``fill`` outside
    (``matching.derive_right_volume``); ``fill`` in the volume's dtype
    (1e4 is 9984 in bfloat16)."""
    D, h, w = vol.shape
    pad = max(abs(d_min), abs(d_min + (D - 1) * stride)) + 1
    volp = torch.nn.functional.pad(vol, (pad, pad), value=fill)
    out = torch.empty_like(vol)
    for i in range(D):
        start = pad + d_min + i * stride
        out[i] = volp[i, :, start:start + w]
    return out


def derive_right(vol: torch.Tensor, d_min: int, fill: float = 1.0,
                 stride: int = 1) -> torch.Tensor:
    """K3 wrapper: see :func:`derive_right_plain` for the semantics."""
    if vol.dim() != 3:
        raise ValueError(f"derive_right: expected (D, H, W), got {tuple(vol.shape)}")
    if not _on_cuda("derive_right", vol):
        return derive_right_plain(vol, d_min, fill, stride)
    from pcmi_tpu_torch.ops.stereo._build import load

    lib = load()
    D, H, W = vol.shape
    out = torch.empty_like(vol)
    rc = lib.pcmi_derive_right(vol.data_ptr(), out.data_ptr(), D, H, W,
                               int(d_min), int(stride), float(fill),
                               int(vol.dtype == torch.bfloat16), _stream())
    _check("derive_right", rc)
    LAUNCHES["derive_right"] += 1
    return out


# ---------------------------------------------------------------------------
# K4 sgm_hwd
# ---------------------------------------------------------------------------


def sgm_hwd_plain(cost: torch.Tensor, p1: float, p2: float, scan_axis: int,
                  reverse: bool, out: torch.Tensor | None = None) -> torch.Tensor:
    """One SGM direction over an (H, W, D) volume: ``scan_axis`` 0 scans H
    (state (W, D)), 1 scans W (state (H, D)). ``reverse`` and ``out`` as in
    :func:`sgm_dir_plain`."""
    return _scan_plain(cost, scan_axis, 1, p1, p2, reverse, out)


SGM_HWD_MAX_DISP = 1024      # csrc/sgm_tile.cuh: 32 disparities per lane
SGM_HWD_WARPS = 2            # csrc/sgm_hwd.cu: warps (paths) per block
_HWD_WARP_RING = 10 * 1024   # one warp's ring; longer ones measured slower


class SgmHwdPlan(NamedTuple):
    """K4's launch plan: each warp of a block streams its path through a
    ring of two tiles of ``tile`` scan steps; ``smem`` bytes of shared
    memory per block."""
    tile: int
    smem: int


def sgm_hwd_smem(D: int, tile: int, accumulate: bool) -> int:
    """Shared memory of one K4 block: per warp a ring of two tiles of
    ``tile`` steps of ``D`` floats (rounded up to 4), twice that with
    ``accumulate`` (the tile of ``out`` beside the cost tile)."""
    return (SGM_HWD_WARPS * 2 * (2 if accumulate else 1) * tile
            * (-(-D // 4) * 4) * 4)


def sgm_hwd_plan(D: int, accumulate: bool) -> SgmHwdPlan:
    """K4's launch plan for paths of ``D`` disparities: the longest tile
    (16, 8, ... steps) whose ring stays within 10 KB per warp, the fastest
    on the H100 at the two D measured: 16 steps forward and 8 accumulating
    at D = 80, 8 and 4 at D = 144. Where not even one step fits that
    (accumulating past 640 disparities), tiles of one step."""
    if not 1 <= D <= SGM_HWD_MAX_DISP:
        raise ValueError(f"sgm_hwd: D={D} outside [1, {SGM_HWD_MAX_DISP}]")
    for tile in (16, 8, 4, 2, 1):
        smem = sgm_hwd_smem(D, tile, accumulate)
        if smem <= SGM_HWD_WARPS * _HWD_WARP_RING or (
                tile == 1 and smem <= SMEM_BLOCK_MAX):
            return SgmHwdPlan(tile, smem)
    raise ValueError(f"sgm_hwd: no launch plan fits D={D}")


def sgm_hwd(cost: torch.Tensor, p1: float, p2: float, scan_axis: int,
            reverse: bool, out: torch.Tensor | None = None) -> torch.Tensor:
    """K4 wrapper: see :func:`sgm_hwd_plain` for the semantics. float32
    only: the TPU kernel it replaces raises for a bfloat16 volume."""
    if cost.dim() != 3:
        raise ValueError(f"sgm_hwd: expected (H, W, D), got {tuple(cost.shape)}")
    if scan_axis not in (0, 1):
        raise ValueError(f"sgm_hwd: scan_axis must be 0 or 1, got {scan_axis}")
    if out is not None and out.shape != cost.shape:
        raise ValueError("sgm_hwd: out must have the cost volume's shape")
    if not _on_cuda("sgm_hwd", cost, out, dtypes=(torch.float32,)):
        return sgm_hwd_plain(cost, p1, p2, scan_axis, reverse, out)
    from pcmi_tpu_torch.ops.stereo._build import load

    lib = load()
    H, W, D = cost.shape
    acc = out is not None
    plan = sgm_hwd_plan(D, acc)
    if out is None:
        out = torch.empty_like(cost)
    rc = lib.pcmi_sgm_hwd(cost.data_ptr(), out.data_ptr(), H, W, D,
                          int(scan_axis), int(reverse), int(acc), float(p1),
                          float(p2), plan.tile, _stream())
    _check("sgm_hwd", rc)
    LAUNCHES["sgm_hwd"] += 1
    return out


# ---------------------------------------------------------------------------
# K5 sgm_blocked
# ---------------------------------------------------------------------------

BAND = 128  # lanes per band of the blocked layout


def sgm_blocked_plain(cost: torch.Tensor, p1: float, p2: float,
                      reverse: bool,
                      prev: torch.Tensor | None = None) -> torch.Tensor:
    """One SGM direction over a blocked (nb, S, Dp, 128) volume, scanning S
    (state (nb, Dp, 128)); with ``prev`` the output is that direction plus
    ``prev`` (the reference's ``with_prev`` backward pass). In bfloat16
    the float32 state is added to ``prev`` and the sum rounded once."""
    out = prev.clone() if prev is not None else None
    return _scan_plain(cost, 1, 1, p1, p2, reverse, out, round_first=False)


SGM_BLOCKED_MAX_DISP = SGM_DIR_MAX_DISP   # the tile kernel is K1's


def sgm_blocked_plan(Dp: int, nb: int, with_prev: bool,
                     esize: int = 4) -> SgmDirPlan:
    """K5's launch plan for ``nb`` bands of ``Dp`` disparities: that of
    K1's vertical scans over ``nb * 128`` columns (blocks of 16
    neighbouring lanes of a band where that gives 64 blocks, else 8; the
    longest tile that fits). On the H100 blocks of 8 lanes win at 7 bands
    of Dp = 80 and 16 at 9 bands of Dp = 144."""
    if not 1 <= Dp <= SGM_BLOCKED_MAX_DISP:
        raise ValueError(f"sgm_blocked: Dp={Dp} outside "
                         f"[1, {SGM_BLOCKED_MAX_DISP}]")
    return sgm_dir_plan(Dp, nb * BAND, False, with_prev, esize)


def sgm_blocked(cost: torch.Tensor, p1: float, p2: float, reverse: bool,
                prev: torch.Tensor | None = None) -> torch.Tensor:
    """K5 wrapper: see :func:`sgm_blocked_plain` for the semantics."""
    if cost.dim() != 4 or cost.shape[3] != BAND:
        raise ValueError(f"sgm_blocked: expected (nb, S, Dp, {BAND}), got "
                         f"{tuple(cost.shape)}")
    if prev is not None and prev.shape != cost.shape:
        raise ValueError("sgm_blocked: prev must have the cost volume's shape")
    if not _on_cuda("sgm_blocked", cost, prev):
        return sgm_blocked_plain(cost, p1, p2, reverse, prev)
    from pcmi_tpu_torch.ops.stereo._build import load

    lib = load()
    nb, S, Dp, _ = cost.shape
    esize = _esize(cost.dtype)
    plan = sgm_blocked_plan(Dp, nb, prev is not None, esize)
    if any(t.data_ptr() % 16 for t in (cost, prev) if t is not None):
        raise ValueError("sgm_blocked: inputs must be 16-byte aligned")
    out = torch.empty_like(cost)
    rc = lib.pcmi_sgm_blocked(cost.data_ptr(),
                              prev.data_ptr() if prev is not None else None,
                              out.data_ptr(), nb, S, Dp, float(p1), float(p2),
                              int(reverse), plan.paths, plan.tile,
                              int(esize == 2), _stream())
    _check("sgm_blocked", rc)
    LAUNCHES["sgm_blocked"] += 1
    return out


# ---------------------------------------------------------------------------
# K6 derive_right_wdh
# ---------------------------------------------------------------------------


def derive_right_wdh_plain(vol: torch.Tensor, d_real: int, w: int, d_min: int,
                           stride: int = 1, fill: float = 1.0) -> torch.Tensor:
    """Right-view volume in the padded (Wp, Dp, Hp) layout:
    ``out[x, d, y] = vol[x + d_min + d*stride, d, y]`` for ``x < w`` and
    ``d < d_real``, ``fill`` where that column lies outside ``[0, w)``,
    ``BIG`` for ``d >= d_real`` and 0 for ``x >= w`` (which wins); ``fill``
    and ``BIG`` in the volume's dtype."""
    wp, dp, hp = vol.shape
    out = torch.zeros_like(vol)
    out[:w, d_real:] = BIG
    for d in range(d_real):
        o = d_min + d * stride
        out[:w, d] = fill
        x0, x1 = max(0, -o), min(w, w - o)
        if x1 > x0:
            out[x0:x1, d] = vol[x0 + o:x1 + o, d]
    return out


def derive_right_wdh(vol: torch.Tensor, d_real: int, w: int, d_min: int,
                     stride: int = 1, fill: float = 1.0) -> torch.Tensor:
    """K6 wrapper: see :func:`derive_right_wdh_plain` for the semantics."""
    if vol.dim() != 3:
        raise ValueError(f"derive_right_wdh: expected (Wp, Dp, Hp), got "
                         f"{tuple(vol.shape)}")
    wp, dp, hp = vol.shape
    if not (1 <= d_real <= dp and 1 <= w <= wp):
        raise ValueError(f"derive_right_wdh: d_real={d_real}, w={w} outside "
                         f"the padded volume {tuple(vol.shape)}")
    if not _on_cuda("derive_right_wdh", vol):
        return derive_right_wdh_plain(vol, d_real, w, d_min, stride, fill)
    from pcmi_tpu_torch.ops.stereo._build import load

    lib = load()
    out = torch.empty_like(vol)
    rc = lib.pcmi_derive_right_wdh(vol.data_ptr(), out.data_ptr(), wp, dp, hp,
                                   int(d_real), int(w), int(d_min),
                                   int(stride), float(fill),
                                   int(vol.dtype == torch.bfloat16),
                                   _stream())
    _check("derive_right_wdh", rc)
    LAUNCHES["derive_right_wdh"] += 1
    return out


# ---------------------------------------------------------------------------
# K7 cost_volume and the census transform
# ---------------------------------------------------------------------------


def _popcount24(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int32 values below 2**24 (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x + (x >> 8) + (x >> 16)) & 0xFF


def _edge_pad(x: torch.Tensor, r: int, axis: int) -> torch.Tensor:
    """Edge-replicate ``r`` elements on both ends of ``axis`` (-1 or -2) of
    an (..., H, W) tensor."""
    shape = x.shape
    x3 = x.reshape(-1, shape[-2], shape[-1])
    widths = (r, r, 0, 0) if axis == -1 else (0, 0, r, r)
    out = F.pad(x3, widths, mode="replicate")
    return out.reshape(*shape[:-2], *out.shape[-2:])


def census_plain(img: torch.Tensor, window: int = 7):
    """Census transform into two int32 planes of 24 neighbour bits each
    (the reference's uint32 planes, same bit order): bit ``idx`` is
    ``neighbour < centre`` for the window's neighbours in row-major order
    without the centre, at edge-replicated coordinates; bits 0-23 in the
    first plane, the rest in the second."""
    h, w = img.shape
    r = window // 2
    padded = _edge_pad(_edge_pad(img, r, -1), r, -2)
    bits0 = torch.zeros((h, w), dtype=torch.int32, device=img.device)
    bits1 = torch.zeros_like(bits0)
    idx = 0
    for dy in range(window):
        for dx in range(window):
            if dy == r and dx == r:
                continue
            bit = (padded[dy:dy + h, dx:dx + w] < img).to(torch.int32)
            if idx < 24:
                bits0 = bits0 | (bit << idx)
            else:
                bits1 = bits1 | (bit << (idx - 24))
            idx += 1
    return bits0, bits1


def _sliding_sum(padded: torch.Tensor, k: int, axis: int,
                 out_len: int) -> torch.Tensor:
    """Length-``k`` sliding sum along ``axis`` by log-doubling, with the
    reference's add order: ``out[i] = sum_{j<k} padded[i+j]``."""
    sums = {1: padded}
    w = 1
    while 2 * w <= k:
        a = sums[w]
        n = a.shape[axis]
        sums[2 * w] = a.narrow(axis, 0, n - w) + a.narrow(axis, w, n - w)
        w *= 2
    acc = None
    off = 0
    for w in sorted(sums, reverse=True):
        while off + w <= k:
            sl = sums[w].narrow(axis, off, out_len)
            acc = sl if acc is None else acc + sl
            off += w
    return acc


def _check_census_window(window: int) -> None:
    if window > 7 or window < 3 or window % 2 == 0:
        raise ValueError(
            f"census_window must be an odd value in [3, 7] (got {window}): "
            f"two 24-bit planes hold at most 48 neighbour bits")


def census(img: torch.Tensor, window: int = 7):
    """Census wrapper: see :func:`census_plain` for the semantics. On the
    card ``img`` must be float32: one launch of ``census_kernel``."""
    _check_census_window(window)
    if img.dim() != 2:
        raise ValueError(f"census: expected (H, W), got {tuple(img.shape)}")
    if img.device.type == "cpu":
        return census_plain(img, window)
    img = img.contiguous()
    _on_cuda("census", img, dtypes=(torch.float32,))
    from pcmi_tpu_torch.ops.stereo._build import load

    lib = load()
    h, w = img.shape
    bits0 = torch.empty((h, w), dtype=torch.int32, device=img.device)
    bits1 = torch.empty_like(bits0)
    rc = lib.pcmi_census(img.data_ptr(), bits0.data_ptr(), bits1.data_ptr(),
                         h, w, int(window), _stream())
    _check("census", rc)
    LAUNCHES["census"] += 1
    return bits0, bits1


def _box_edge(img: torch.Tensor, block: int) -> torch.Tensor:
    """Edge-padded mean filter over the last two axes (rows, then
    columns)."""
    r = block // 2
    out = img
    for axis in (-2, -1):
        padded = _edge_pad(out, r, axis)
        out = _sliding_sum(padded, block, axis, out.shape[axis]) / block
    return out


_COST_CHUNK = 16


def cost_volume_plain(left: torch.Tensor, census_l, valid_l: torch.Tensor,
                      right: torch.Tensor, census_r, valid_r: torch.Tensor,
                      d_min: int, planes: int, stride: int, block: int,
                      census_window: int, ad_weight: float,
                      dtype: torch.dtype) -> torch.Tensor:
    """(D, H, W) box-aggregated census+AD matching cost of ``planes``
    disparities ``d_min + i * stride``, computed in float32 and stored in
    ``dtype`` (one rounding per chunk): the ``block`` x ``block``
    edge-padded mean (:func:`_box_edge`) of
    ``(1 - ad_weight) * hamming / n_census + ad_weight * min(|l - r|, 0.5)
    / 0.5``, 1.0 where ``valid_l`` or the right pixel's ``valid_r`` is
    false or the right pixel ``x - d`` lies outside the image.
    ``census_l`` and ``census_r`` are :func:`census` planes. Disparities
    are processed ``_COST_CHUNK`` at a time into a preallocated volume,
    which bounds the temporaries to a few chunk-sized tensors."""
    h, w = left.shape
    dev = left.device
    n_census = census_window ** 2 - 1
    cl0, cl1 = census_l
    cr0, cr1 = census_r
    # the matcher's signed range [-D*s/2, D*s/2): max_disp // 2 + 1
    pad = max(abs(d_min), abs(d_min + (planes - 1) * stride)) + 1

    def windows(plane):
        """(H, 2*pad+1, W) view: window j is plane shifted by pad - j."""
        return F.pad(plane, (pad, pad)).unfold(1, w, 1)

    rp, vp = windows(right), windows(valid_r.to(torch.uint8))
    c0p, c1p = windows(cr0), windows(cr1)
    valid_l = valid_l.bool()
    ds = torch.arange(0, planes * stride, stride, device=dev) + d_min
    vol = torch.empty((len(ds), h, w), dtype=dtype, device=dev)
    for i0 in range(0, len(ds), _COST_CHUNK):
        starts = pad - ds[i0:i0 + _COST_CHUNK]

        def take(p):
            return p[:, starts].transpose(0, 1)   # (k, H, W)

        ham = (_popcount24(cl0 ^ take(c0p))
               + _popcount24(cl1 ^ take(c1p))).float()
        census_cost = ham / n_census
        ad = torch.clamp((left - take(rp)).abs(), max=0.5) / 0.5
        cost = (1.0 - ad_weight) * census_cost + ad_weight * ad
        cost = torch.where(valid_l & take(vp).bool(), cost,
                           torch.ones_like(cost))
        vol[i0:i0 + len(starts)] = _box_edge(cost, block)
    return vol


_CV_THREADS_X = 32             # csrc/cost_volume.cu: kTx
_CV_TABLE_PAD = 64             # csrc/cost_volume.cu: kTablePad
_CV_GROUP = 16                 # disparities per block
_CV_TWO_BLOCKS = SMEM_BLOCK_MAX // 2 - 1024   # two blocks on one SM
# csrc/cost_volume.cu: the block sizes of the box form and its tile
CV_BOX_SIZES = (1, 3, 5, 7, 9, 11, 13, 15)
CV_BOX_TILE = (32, 128)
_CV_BOX_PLANES = 2             # csrc/cost_volume.cu: kNB


class CostVolumePlan(NamedTuple):
    """K7's launch plan: tiles of ``tile_h`` x ``tile_w`` output pixels,
    ``group`` disparities per block, ``smem`` bytes of shared memory per
    block, a grid of ``grid`` (x, y, z) blocks; ``box`` for the form of
    the odd block sizes up to 15 (means in registers), else the generic
    form (levels in shared memory)."""
    box: bool
    tile_h: int
    tile_w: int
    group: int
    smem: int
    grid: tuple


def cost_volume_smem(block: int, tile_h: int, tile_w: int,
                     box: bool = False) -> int:
    """Shared memory of one K7 block (``pcmi_cost_volume``): the census
    table, then in the box form the haloed tile's raw costs of two
    disparities (each (tile_h + block - 1) x (tile_w + block - 1) floats)
    and the rows' means (tile_h rows of an odd pitch); in the generic form ``floor(log2(block)) + 1``
    levels of the haloed tile and the rows' means (tile_h x (tile_w +
    block - 1))."""
    ew = tile_w + block - 1
    if box:
        return 4 * (_CV_TABLE_PAD + _CV_BOX_PLANES * (tile_h + block - 1) * ew
                    + tile_h * (ew | 1))
    return 4 * (_CV_TABLE_PAD + block.bit_length() * (tile_h + block - 1) * ew
                + tile_h * ew)


def cost_volume_plan(D: int, H: int, W: int, block: int) -> CostVolumePlan:
    """K7's launch plan for a (D, H, W) volume and a ``block`` x ``block``
    box. The box form (:data:`CV_BOX_SIZES`) takes tiles of 32 x 128. The
    generic form takes haloed tiles whose rows are whole warps
    (``tile_w + block - 1`` the least multiple of 32 that leaves at least 64
    output columns), and the most rows (32, 16, ... 1) whose shared memory
    lets two blocks share an SM, else the most that fit one block."""
    if D < 1 or H < 1 or W < 1 or block < 1:
        raise ValueError(f"cost_volume: no plan for D={D}, H={H}, W={W}, "
                         f"block={block}")

    def plan(box, th, tw, smem):
        return CostVolumePlan(box, th, tw, _CV_GROUP, smem,
                              (-(-W // tw), -(-H // th), -(-D // _CV_GROUP)))

    if block in CV_BOX_SIZES:
        th, tw = CV_BOX_TILE
        return plan(True, th, tw, cost_volume_smem(block, th, tw, box=True))
    ew = -(-(64 + block - 1) // _CV_THREADS_X) * _CV_THREADS_X
    tw = ew - (block - 1)
    for limit in (_CV_TWO_BLOCKS, SMEM_BLOCK_MAX):
        for th in (32, 16, 8, 4, 2, 1):
            smem = cost_volume_smem(block, th, tw)
            if smem <= limit:
                return plan(False, th, tw, smem)
    raise ValueError(f"cost_volume: no launch plan fits block={block}")


_CENSUS_TABLES: dict = {}


def _census_table(device: torch.device, census_window: int,
                  ad_weight: float) -> torch.Tensor:
    """``(1 - ad_weight) * (h / n_census)`` for h = 0..48, made on
    ``device`` with :func:`cost_volume_plain`'s own two operations (so
    with that device's rounding), once per device and weights."""
    key = (device, census_window, float(ad_weight))
    table = _CENSUS_TABLES.get(key)
    if table is None:
        n_census = census_window ** 2 - 1
        ham = torch.arange(49, dtype=torch.float32, device=device)
        table = (1.0 - ad_weight) * (ham / n_census)
        _CENSUS_TABLES[key] = table
    return table


def cost_volume(left: torch.Tensor, census_l, valid_l: torch.Tensor,
                right: torch.Tensor, census_r, valid_r: torch.Tensor, *,
                d_min: int, planes: int, stride: int, block: int,
                census_window: int, ad_weight: float,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K7 wrapper: see :func:`cost_volume_plain` for the semantics. On the
    card the images are float32 and the census planes int32 (``dtype``
    float32 or bfloat16): one launch, which writes the volume once."""
    _check_census_window(census_window)
    if left.dim() != 2 or any(t.shape != left.shape for t in (
            right, valid_l, valid_r, *census_l, *census_r)):
        raise ValueError("cost_volume: expected (H, W) images, census planes "
                         "and masks of one shape")
    if planes < 1:
        raise ValueError(f"cost_volume: planes={planes}")
    ts = (left, right, valid_l, valid_r, *census_l, *census_r)
    if all(t.device.type == "cpu" for t in ts):
        return cost_volume_plain(left, census_l, valid_l, right, census_r,
                                 valid_r, d_min, planes, stride, block,
                                 census_window, ad_weight, dtype)
    if len({t.device for t in ts}) != 1:
        raise ValueError("cost_volume: tensors on several devices")
    left, right = left.contiguous(), right.contiguous()
    census_l = tuple(t.contiguous() for t in census_l)
    census_r = tuple(t.contiguous() for t in census_r)
    _on_cuda("cost_volume", left, right, dtypes=(torch.float32,))
    _on_cuda("cost_volume", *census_l, *census_r, dtypes=(torch.int32,))
    if dtype not in VOLUME_DTYPES:
        raise TypeError(f"cost_volume: cannot store a volume in {dtype}")
    from pcmi_tpu_torch.ops.stereo._build import load

    lib = load()
    h, w = left.shape
    plan = cost_volume_plan(planes, h, w, block)
    vl = valid_l.bool().contiguous().view(torch.uint8)
    vr = (valid_r if valid_r.dtype == torch.bool
          else valid_r.to(torch.uint8)).contiguous().view(torch.uint8)
    table = _census_table(left.device, census_window, ad_weight)
    vol = torch.empty((planes, h, w), dtype=dtype, device=left.device)
    (l0, l1), (r0, r1) = census_l, census_r
    rc = lib.pcmi_cost_volume(
        left.data_ptr(), l0.data_ptr(), l1.data_ptr(), vl.data_ptr(),
        right.data_ptr(), r0.data_ptr(), r1.data_ptr(), vr.data_ptr(),
        table.data_ptr(), vol.data_ptr(), planes, h, w, int(d_min),
        int(stride), int(block), float(ad_weight), plan.tile_h, plan.tile_w,
        plan.group, int(dtype == torch.bfloat16), _stream())
    _check("cost_volume", rc)
    LAUNCHES["cost_volume"] += 1
    return vol
