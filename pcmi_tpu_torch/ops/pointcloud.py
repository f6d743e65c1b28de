"""Point-cloud ops: plane fit, K-means, kNN filtering, gridding, ICP (port
of ``pcmi_tpu/ops/pointcloud.py``).

Invalid points are carried as ``weight=0`` rows, never dropped, as in the
reference. The kNN is brute force. The outlier mask's selection (each
point's k + 1 nearest) is K8 ``knn_select`` on the card, one launch that
keeps each point's list in registers and holds ~12 MB (N x (k + 1)
floats) at the fuse request's 327,680 points; on the CPU, and in ICP's
``nearest_neighbor``, chunks of query rows go against every point, one
distance product (``|a|^2 - 2ab + |b|^2``, in full float32: TF32 is off
in this package) and ``torch.topk`` or ``argmin`` per chunk, so peak
memory is ``chunk x N`` floats (2.68 GB a 2,048-row chunk there).
Medians and quantiles follow ``jnp.nanmedian`` (mean of the two middle
values) and ``jnp.quantile`` (linear interpolation, infinities kept)
exactly, where ``torch.nanmedian`` and ``torch.quantile`` give other
values. The random draw of K-means' first seed comes from a
``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from pcmi_tpu_torch.ops.segmented import (
    grid_segment_sums, segment_totals_at_points, sort_by_segment)
from pcmi_tpu_torch.ops.stereo import kernels as K


# ---------------------------------------------------------------------------
# plane fit
# ---------------------------------------------------------------------------


class Plane(NamedTuple):
    normal: torch.Tensor    # (3,) unit normal, oriented +z
    centroid: torch.Tensor  # (3,)


def fit_plane(xyz: torch.Tensor, weights: torch.Tensor) -> Plane:
    """Weighted least-squares plane through ``xyz`` ((N, 3) or (H, W, 3)):
    the smallest-eigenvalue eigenvector of the 3x3 weighted scatter
    matrix, oriented +z. The product runs in full float32 (no TF32)."""
    pts = xyz.reshape(-1, 3).float()
    w = weights.reshape(-1).float()
    wsum = torch.clamp(w.sum(), min=1e-6)
    mu = (pts * w[:, None]).sum(0) / wsum
    centred = (pts - mu) * torch.sqrt(w)[:, None]
    cov = (centred.T @ centred) / wsum
    _, vecs = torch.linalg.eigh(cov)
    n = vecs[:, 0]
    n = torch.where(n[2] < 0, -n, n)
    return Plane(normal=n, centroid=mu)


def plane_relative_height(xyz: torch.Tensor, plane: Plane) -> torch.Tensor:
    """Signed distance of each point to the plane along its normal."""
    return (xyz - plane.centroid) @ plane.normal


# ---------------------------------------------------------------------------
# medians, quantiles and top-k as jax computes them
# ---------------------------------------------------------------------------


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of a 1-D tensor: NaNs ignored, the mean of the two
    middle values for an even count, NaN when nothing is left. No host
    synchronisation."""
    s = torch.sort(torch.where(torch.isnan(x), float("inf"), x)).values
    n = (~torch.isnan(x)).sum()
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    med = (s[lo] + s[hi]) * 0.5
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def quantile(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``jnp.quantile(x, q)`` (linear method) of a 1-D tensor without NaNs:
    ``low * (1 - f) + high * f`` at position ``q * (n - 1)``, so an
    interpolation into ``+inf`` gives ``inf`` (``torch.quantile`` gives
    NaN there)."""
    s = torch.sort(x).values
    n = x.numel()
    pos = q * (n - 1)
    low = torch.floor(pos)
    high_w = pos - low
    lo = torch.clamp(low, 0, n - 1).long()
    hi = torch.clamp(torch.ceil(pos), 0, n - 1).long()
    return s[lo] * (1.0 - high_w) + s[hi] * high_w


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the ``k`` largest values and their
    indices, the lower index first among equal values (a stable descending
    sort; ``torch.topk`` promises no order on ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---------------------------------------------------------------------------
# K-means
# ---------------------------------------------------------------------------


class KMeansResult(NamedTuple):
    centroids: torch.Tensor   # (K, D)
    assignment: torch.Tensor  # (N,) int32
    inertia: torch.Tensor     # () weighted sum of squared distances


def _pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, K) squared distances through ``(|a|^2 - 2ab) + |b|^2``, in the
    reference's order, clamped at 0. Built in place in the product's
    buffer, so a chunk costs one (N, K) allocation."""
    an = (a * a).sum(1, keepdim=True)
    bn = (b * b).sum(1)
    return (a @ b.T).mul_(-2.0).add_(an).add_(bn).clamp_(min=0.0)


def gumbel_noise(n: int, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, ``u`` uniform in
    [tiny, 1) (``jax.random.gumbel``'s form). Without a ``generator`` the
    draw comes from a fresh one seeded with 0 on ``device``, the
    counterpart of the reference's default ``jax.random.PRNGKey(0)``:
    repeated calls draw the same noise, and torch's global generator is
    never touched."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    u = torch.rand(n, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def kmeans(points: torch.Tensor, weights: torch.Tensor, k: int,
           iters: int = 20,
           generator: Optional[torch.Generator] = None) -> KMeansResult:
    """Weighted Lloyd's K-means with a fixed iteration count.

    Init is farthest-point sampling: after a weighted-random first pick
    (Gumbel arg-max of ``log w`` drawn from ``generator``, by default one
    seeded with 0, as the reference's ``jax.random.PRNGKey(0)``), each
    next centroid is the valid point farthest from the current set.
    ``weights`` zero-masks invalid points."""
    pts = points.float()
    w = weights.float()
    logw = torch.where(w > 0, torch.log(torch.clamp(w, min=1e-12)),
                       float("-inf"))
    first = torch.argmax(logw + gumbel_noise(pts.shape[0], generator, pts.device))
    return _kmeans_from(pts, w, k, iters, first)


def _kmeans_from(pts: torch.Tensor, w: torch.Tensor, k: int, iters: int,
                 first: torch.Tensor) -> KMeansResult:
    """K-means from a given first seed index (farthest-point init, then
    ``iters`` Lloyd steps). Ties in ``argmax``/``argmin`` go to the first
    index, as in the reference."""
    invalid_penalty = torch.where(w > 0, 0.0, float("-inf"))
    cents = torch.zeros((k, pts.shape[1]), dtype=torch.float32,
                        device=pts.device)
    cents[0] = pts[first]
    mind = torch.full((pts.shape[0],), float("inf"), device=pts.device)
    for i in range(1, k):
        mind = torch.minimum(mind, ((pts - cents[i - 1]) ** 2).sum(1))
        cents[i] = pts[torch.argmax(mind + invalid_penalty)]
    for _ in range(iters):
        d2 = _pairwise_sqdist(pts, cents)
        onehot = F.one_hot(torch.argmin(d2, 1), k).float() * w[:, None]
        counts = onehot.sum(0)
        sums = onehot.T @ pts
        cents = torch.where(counts[:, None] > 0,
                            sums / torch.clamp(counts, min=1e-12)[:, None],
                            cents)
    d2 = _pairwise_sqdist(pts, cents)
    best, assign = d2.min(1).values, torch.argmin(d2, 1)
    return KMeansResult(centroids=cents, assignment=assign.int(),
                        inertia=(best * w).sum())


# ---------------------------------------------------------------------------
# brute-force kNN
# ---------------------------------------------------------------------------


def _cand_mask(valid: torch.Tensor) -> torch.Tensor:
    """Additive candidate mask: 0 for valid points, +inf otherwise."""
    return torch.where(valid, 0.0, float("inf"))


def _check_knn(points: torch.Tensor, valid: torch.Tensor, k: int) -> None:
    if points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"knn_select: expected (N, 3) points, got "
                         f"{tuple(points.shape)}")
    if valid.shape != points.shape[:1]:
        raise ValueError(f"knn_select: valid must be (N,), got "
                         f"{tuple(valid.shape)}")
    if k < 0 or k + 1 > points.shape[0]:
        raise ValueError(f"knn_select: k + 1 = {k + 1} nearest of "
                         f"{points.shape[0]} points")


def knn_select_plain(points: torch.Tensor, valid: torch.Tensor, k: int,
                     chunk: int = 1024) -> torch.Tensor:
    """(N, k + 1) ascending: for each point the ``k + 1`` smallest squared
    distances (:func:`_pairwise_sqdist`, +inf or NaN to invalid
    candidates) to all points, itself included; ties and NaN as
    ``torch.topk`` orders them (finite, +inf, NaN). Chunked over query rows:
    peak memory ``chunk x N`` floats."""
    _check_knn(points, valid, k)
    pts = points.float()
    mask = _cand_mask(valid)
    out = torch.empty((pts.shape[0], k + 1), device=pts.device)
    for s in range(0, pts.shape[0], chunk):
        d2 = _pairwise_sqdist(pts[s:s + chunk], pts).add_(mask)
        out[s:s + chunk] = torch.topk(d2, k + 1, dim=1, largest=False).values
        del d2
    return out


def knn_select(points: torch.Tensor, valid: torch.Tensor, k: int,
               chunk: int = 1024) -> torch.Tensor:
    """:func:`knn_select_plain`'s values: on the CPU that function, on the
    card K8 (``kernels.knn_select``, one launch; ``chunk`` is the plain
    version's alone) on the points packed with the same norms and the
    mask, which gives the plain version's bits wherever cuBLAS computes
    its products with the tiled GEMM (a chunk of one row goes to a gemv,
    and tiny products to other kernels, which round the dot product in
    another order); ``k + 1`` is at most ``kernels.KNN_MAX_K1`` there,
    else ``ValueError``."""
    _check_knn(points, valid, k)
    if points.device.type == "cpu" and valid.device.type == "cpu":
        return knn_select_plain(points, valid, k, chunk)
    if points.device != valid.device:
        raise ValueError("knn_select: tensors on several devices")
    pts = points.float().contiguous()
    norms = (pts * pts).sum(1)
    cands = torch.cat([pts * -2.0, (norms + _cand_mask(valid.bool()))[:, None]],
                      1)
    return K.knn_select(pts, norms, cands, k)


def knn_mean_distance(points: torch.Tensor, valid: torch.Tensor, k: int = 8,
                      chunk: int = 1024) -> torch.Tensor:
    """Mean distance of each point to its ``k`` nearest valid neighbours
    (the nearest hit, the point itself, excluded); +inf for invalid
    points. The selection is :func:`knn_select`: K8 on the card, its
    plain version ``chunk`` rows at a time on the CPU."""
    near = knn_select(points, valid, k, chunk=chunk)
    out = torch.sqrt(near[:, 1:]).mean(1)
    return torch.where(valid, out, float("inf"))


def knn_outlier_mask(points: torch.Tensor, valid: torch.Tensor, k: int = 8,
                     sigma: float = 3.0, chunk: int = 1024) -> torch.Tensor:
    """Statistical outlier removal: keep valid points whose mean kNN
    distance is at most ``median + sigma * 1.4826 * MAD`` over the valid
    population (medians as ``jnp.nanmedian`` computes them)."""
    d = knn_mean_distance(points, valid, k=k, chunk=chunk)
    finite = valid & torch.isfinite(d)
    dv = torch.where(finite, d, float("nan"))
    med = nanmedian(dv)
    mad = nanmedian((dv - med).abs()) + 1e-9
    return finite & (d <= med + sigma * 1.4826 * mad)


def nearest_neighbor(query: torch.Tensor, ref: torch.Tensor,
                     ref_valid: torch.Tensor,
                     chunk: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index (int32; the first on ties) and distance of the nearest valid
    ``ref`` point per query row."""
    q = query.float()
    r = ref.float()
    mask = _cand_mask(ref_valid)
    idx = torch.empty(q.shape[0], dtype=torch.int64, device=q.device)
    dist = torch.empty(q.shape[0], device=q.device)
    for s in range(0, q.shape[0], chunk):
        d2 = _pairwise_sqdist(q[s:s + chunk], r).add_(mask)
        i = torch.argmin(d2, 1)
        idx[s:s + chunk] = i
        dist[s:s + chunk] = torch.sqrt(d2.gather(1, i[:, None])[:, 0])
    return idx.int(), dist


# ---------------------------------------------------------------------------
# DSM gridding
# ---------------------------------------------------------------------------


class GridSpec2D(NamedTuple):
    origin: Tuple[float, float]  # (x0, y0) of cell (0, 0)
    cell: float                  # cell size
    shape: Tuple[int, int]       # (rows=ny, cols=nx)


def cell_ids(xy: torch.Tensor, weights: torch.Tensor, origin, cell: float,
             shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat cell id (``gy * nx + gx``, 0 out of bounds) and weight (0 out
    of bounds) of each point."""
    ny, nx = shape
    gx = torch.floor((xy[..., 0] - float(origin[0])) / float(cell)).int()
    gy = torch.floor((xy[..., 1] - float(origin[1])) / float(cell)).int()
    inb = (gx >= 0) & (gx < nx) & (gy >= 0) & (gy < ny)
    w = torch.where(inb, weights.float(), 0.0).reshape(-1)
    ids = torch.where(inb, gy * nx + gx, 0).reshape(-1)
    return ids, w


def grid_fuse(xy: torch.Tensor, values: torch.Tensor, weights: torch.Tensor,
              origin: Tuple[float, float], cell: float,
              shape: Tuple[int, int], robust_sigma: float = 3.0):
    """Rasterise scattered (x, y, value) samples onto a regular grid.

    Two-pass robust mean per cell: the weighted mean, then the mean of the
    samples within ``robust_sigma`` cell-stds (+1e-6) of it. Returns
    ``(dsm, count)`` with NaN where a cell received no samples."""
    ny, nx = shape
    ids, w = cell_ids(xy, weights, origin, cell, shape)
    v = values.reshape(-1).float()
    v = torch.where(w > 0, v, 0.0)
    ids, v, w, boundary = sort_by_segment(ids, v, w)
    ws_p, vs_p, vq_p = segment_totals_at_points(boundary, w, w * v, w * v * v)
    ws_p = torch.clamp(ws_p, min=1e-12)
    mean_p = vs_p / ws_p
    std_p = torch.sqrt(torch.clamp(vq_p / ws_p - mean_p ** 2, min=0.0))
    keep = w * ((v - mean_p).abs() <= robust_sigma * std_p + 1e-6)
    packed = grid_segment_sums(ids, boundary, (w, w * v, keep, keep * v),
                               ny * nx)
    wsum, vsum, wsum2, vsum2 = packed.unbind(1)
    mean = vsum / torch.clamp(wsum, min=1e-12)
    fused = torch.where(wsum2 > 0, vsum2 / torch.clamp(wsum2, min=1e-12),
                        mean)
    fused = torch.where(wsum > 0, fused, float("nan"))
    return fused.reshape(ny, nx), wsum.reshape(ny, nx)


# ---------------------------------------------------------------------------
# ICP cross-date registration
# ---------------------------------------------------------------------------


class ICPResult(NamedTuple):
    R: torch.Tensor      # (3, 3)
    t: torch.Tensor      # (3,)
    rmse: torch.Tensor   # () final inlier RMSE


def icp(src: torch.Tensor, src_valid: torch.Tensor, dst: torch.Tensor,
        dst_valid: torch.Tensor, iters: int = 10, chunk: int = 1024,
        mode: str = "rigid", trim_quantile: float = 0.8) -> ICPResult:
    """Point-to-point ICP aligning ``src`` onto ``dst``.

    Per iteration: nearest-neighbour correspondences, a trim to the best
    ``trim_quantile`` fraction of the valid distances, capped at 4x their
    median (both quantiles as ``jnp.quantile`` computes them over the
    distances with +inf for invalid sources), then a closed-form update:
    Kabsch (3x3 SVD) for ``mode="rigid"``, the centroid shift for
    ``mode="translation"``."""
    s = src.float()
    d = dst.float()
    sw = src_valid.float()
    frac = sw.mean()
    dev = s.device
    R = torch.eye(3, device=dev)
    t = torch.zeros(3, device=dev)
    rmse = torch.zeros((), device=dev)
    for _ in range(iters):
        moved = s @ R.T + t
        idx, dist = nearest_neighbor(moved, d, dst_valid, chunk=chunk)
        matched = d[idx.long()]
        dist_inf = torch.where(src_valid, dist, float("inf"))
        thresh = quantile(dist_inf, trim_quantile * frac)
        med = quantile(dist_inf, 0.5 * frac)
        thresh = torch.minimum(thresh, 4.0 * med + 1e-6)
        w = sw * (dist <= thresh)
        wsum = torch.clamp(w.sum(), min=1e-6)
        mu_s = (moved * w[:, None]).sum(0) / wsum
        mu_d = (matched * w[:, None]).sum(0) / wsum
        if mode == "rigid":
            H = ((moved - mu_s) * w[:, None]).T @ (matched - mu_d)
            U, _, Vt = torch.linalg.svd(H)
            det = torch.linalg.det(Vt.T @ U.T)
            S = torch.diag(torch.stack([torch.ones_like(det),
                                        torch.ones_like(det), det]))
            dR = Vt.T @ S @ U.T
        else:
            dR = torch.eye(3, device=dev)
        dt = mu_d - dR @ mu_s
        R = dR @ R
        t = dR @ t + dt
        rmse = torch.sqrt((w * dist ** 2).sum() / wsum)
    return ICPResult(R=R, t=t, rmse=rmse)


def apply_rigid(points: torch.Tensor, R: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
    return points @ R.T + t
