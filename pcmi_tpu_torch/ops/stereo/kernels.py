"""The matcher's three hand-written Hopper kernels, their plain versions and
their wrappers.

=================  ==========================================================
K1 ``sgm_dir``     one SGM direction; replaces ``_dir_call_sub`` /
                   ``_make_dir_kernel_sub`` (``pcmi_tpu/ops/stereo/
                   pallas_kernels.py``). Source ``csrc/sgm_dir.cu``.
K2 ``wta``         combine + winner-takes-all; replaces
                   ``sgm4_wta_fused_pallas`` / ``_make_wta3_kernel``,
                   ``right_disparity_fused_pallas`` / ``_make_wta2_kernel``
                   and ``wta_fused_pallas`` / ``_make_wta_kernel``. Source
                   ``csrc/wta.cu``.
K3 ``derive_right`` right-view volume; replaces ``derive_right_pallas`` /
                   ``_make_derive_kernel``. Source ``csrc/derive_right.cu``.
=================  ==========================================================

Each wrapper takes float32, contiguous tensors. A tensor on the CPU goes
through the kernel's plain PyTorch version; a CUDA tensor launches the
kernel on the current stream, or raises (wrong dtype, shape, layout, a
failed build or a refused launch). There is no fallback from the card to
the plain version. :data:`LAUNCHES` counts kernel launches per kernel; only
a launch adds to it.

Volumes are float32 on every device: ``StereoConfig.cost_dtype`` and
``sgm_backend`` select TPU paths and are not read here. Each source file
notes what bounds its kernel on the card and what its design does about it.
"""

from __future__ import annotations

import torch

BIG = 1e9  # the reference's "no neighbour" / "never wins" value

LAUNCHES = {"sgm_dir": 0, "wta": 0, "derive_right": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(name: str, *tensors: torch.Tensor | None) -> bool:
    """True for CUDA tensors (after checking them), False for CPU ones."""
    ts = [t for t in tensors if t is not None]
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return True


def _check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed, cudaError_t {rc}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# K1 sgm_dir
# ---------------------------------------------------------------------------


def sgm_dir_plain(cost: torch.Tensor, p1: float, p2: float, horizontal: bool,
                  reverse: bool, out: torch.Tensor | None = None) -> torch.Tensor:
    """One SGM direction over a (D, H, W) volume (``matching._sgm_scan``).

    ``horizontal`` scans along W (state (D, H)), else along H (state
    (D, W)); ``reverse`` scans from the far end. With ``out`` given the
    direction is added into it (in place), else a new volume is returned.
    The output is preallocated and written step by step."""
    axis = 2 if horizontal else 1
    n = cost.shape[axis]
    acc = out is not None
    if out is None:
        out = torch.empty_like(cost)
    prev = torch.zeros_like(cost.select(axis, 0))
    big = torch.full_like(prev[:1], BIG)
    for t in range(n):
        s = n - 1 - t if reverse else t
        c = cost.select(axis, s)
        m = prev.amin(0, keepdim=True)
        up = torch.cat([big, prev[:-1]], 0)
        dn = torch.cat([prev[1:], big], 0)
        best = torch.minimum(torch.minimum(prev, m + p2),
                             torch.minimum(up + p1, dn + p1))
        prev = c + best - m
        if acc:
            out.select(axis, s).add_(prev)
        else:
            out.select(axis, s).copy_(prev)
    return out


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
    if D > lib.pcmi_sgm_dir_max_disp():
        raise ValueError(f"sgm_dir: D={D} above the kernel's "
                         f"{lib.pcmi_sgm_dir_max_disp()}")
    acc = out is not None
    if out is None:
        out = torch.empty_like(cost)
    rc = lib.pcmi_sgm_dir(cost.data_ptr(), out.data_ptr(), D, H, W,
                          int(horizontal), int(reverse), int(acc),
                          float(p1), float(p2), _stream())
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
              with_margin: bool = True):
    """Combine ``s = (a + b) * scale`` (or ``a * scale``) and take the WTA
    in the XLA form of ``matching.wta_disparity``.

    Returns ``(disp, best, margin)``; ``margin`` is None without
    ``with_margin``."""
    vol = (a + b) * scale if b is not None else a * scale
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
    if not with_margin:
        return disp, best, None
    ds = torch.arange(D, device=vol.device).view(D, 1, 1)
    away = (ds - best_d[None]).abs() > 1
    second = torch.where(away, vol, torch.full_like(vol, BIG)).amin(0)
    return disp, best, second - best


def wta(a: torch.Tensor, b: torch.Tensor | None, scale: float, d_min: int,
        stride: int = 1, subpixel: bool = True, with_margin: bool = True):
    """K2 wrapper: see :func:`wta_plain` for the semantics."""
    if a.dim() != 3 or (b is not None and b.shape != a.shape):
        raise ValueError("wta: expected one or two (D, H, W) volumes")
    if not _on_cuda("wta", a, b):
        return wta_plain(a, b, scale, d_min, stride, subpixel, with_margin)
    from pcmi_tpu_torch.ops.stereo._build import load

    lib = load()
    D, H, W = a.shape
    disp = torch.empty((H, W), dtype=torch.float32, device=a.device)
    best = torch.empty_like(disp)
    margin = torch.empty_like(disp) if with_margin else None
    rc = lib.pcmi_wta(a.data_ptr(), b.data_ptr() if b is not None else None,
                      D, H, W, float(scale), float(d_min), float(stride),
                      int(subpixel), disp.data_ptr(), best.data_ptr(),
                      margin.data_ptr() if margin is not None else None,
                      _stream())
    _check("wta", rc)
    LAUNCHES["wta"] += 1
    return disp, best, margin


# ---------------------------------------------------------------------------
# K3 derive_right
# ---------------------------------------------------------------------------


def derive_right_plain(vol: torch.Tensor, d_min: int, fill: float = 1.0,
                       stride: int = 1) -> torch.Tensor:
    """``out[i, y, x] = vol[i, y, x + d_min + i*stride]``, ``fill`` outside
    (``matching.derive_right_volume``)."""
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
                               int(d_min), int(stride), float(fill), _stream())
    _check("derive_right", rc)
    LAUNCHES["derive_right"] += 1
    return out
