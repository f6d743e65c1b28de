"""Point-cloud ops: plane fit, K-means, kNN filtering, gridding, ICP (a frozen copy of the port's
``ops/pointcloud.py``).

Invalid points are carried as ``weight=0`` rows, never dropped, as in the
reference. The kNN is brute force: chunks of query rows against every
point, one distance product (``|a|^2 - 2ab + |b|^2``, in full float32:
TF32 is off in this package) and ``torch.topk`` per chunk, so peak memory
is ``chunk x N`` floats. Medians and quantiles follow ``jnp.nanmedian``
(mean of the two middle values) and ``jnp.quantile`` (linear
interpolation, infinities kept) exactly, where ``torch.nanmedian`` and
``torch.quantile`` give other values. The random draw of K-means' first
seed comes from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


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


def knn_mean_distance(points: torch.Tensor, valid: torch.Tensor, k: int = 8,
                      chunk: int = 1024) -> torch.Tensor:
    """Mean distance of each point to its ``k`` nearest valid neighbours
    (the nearest hit, the point itself, excluded); +inf for invalid
    points. Chunked over query rows: peak memory ``chunk x N``."""
    pts = points.float()
    mask = _cand_mask(valid)
    out = torch.empty(pts.shape[0], device=pts.device)
    for s in range(0, pts.shape[0], chunk):
        d2 = _pairwise_sqdist(pts[s:s + chunk], pts).add_(mask)
        near = torch.topk(d2, k + 1, dim=1, largest=False).values
        del d2
        out[s:s + chunk] = torch.sqrt(near[:, 1:]).mean(1)
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
