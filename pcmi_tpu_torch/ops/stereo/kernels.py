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

Each wrapper takes contiguous float32 or bfloat16 tensors (all tensors of
one call the same; K4 float32 only, as its TPU kernel), on any device, and
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
K1-K3 run on the matcher's main path; K4-K6 behind the alternative-layout
entry points of :mod:`pcmi_tpu_torch.ops.stereo.layouts`. K1 and K5 are one
tile kernel (``csrc/sgm_tile.cuh``) under two sets of strides, and K4 uses
its scan step; each has a launch plan here (:func:`sgm_dir_plan`,
:func:`sgm_blocked_plan`, :func:`sgm_hwd_plan`) that the CPU tests check
against the card's shared memory.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pcmi_tpu_torch.ops.stereo._build import KernelError

BIG = 1e9  # the reference's "no neighbour" / "never wins" value

LAUNCHES = {"sgm_dir": 0, "wta": 0, "derive_right": 0, "sgm_hwd": 0,
            "sgm_blocked": 0, "derive_right_wdh": 0}


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
