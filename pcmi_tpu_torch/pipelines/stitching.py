"""Feature-based image stitching (port of
``pcmi_tpu/pipelines/stitching.py``).

The front end replaces SIFT; the geometric estimation is that of
``cv2.findHomography`` + a seam composition:

1. **Phase correlation** (FFT) for a global translation prior.
2. **Harris corners**: the corner response is separable filters; the
   top-K corners come from a stable descending sort (ties in index order,
   as ``lax.top_k``).
3. **Patch NCC matching**: unit-norm zero-mean patches around each corner
   correlated against a search window in the other image, centred by the
   phase prior, as one grouped float32 convolution.
4. **RANSAC**: 256 homographies from random 4-subsets (Gumbel top-4 of
   ``log p``, the reference's own sampler) solved by one batched SVD of
   the 8x9 DLT systems and scored together; a weighted refit on the
   inliers at the end.
5. **DP seam** through the overlap difference: a forward pass over rows
   on the device, the backtrack on the host.

Canvas bounds and the affine fallback are host float64 numpy, as in the
reference.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pcmi_tpu_torch.interface import Layer, SatellitePlugin
from pcmi_tpu_torch.ops.filters import gaussian_filter
from pcmi_tpu_torch.ops.pointcloud import gumbel_noise, top_k
from pcmi_tpu_torch.ops.warp import homography_warp


# ---------------------------------------------------------------------------
# 1. phase correlation
# ---------------------------------------------------------------------------


def phase_correlation(a: torch.Tensor, b: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Translation (dy, dx) aligning ``b`` to ``a`` via the cross-power FFT.

    Inputs are zero-padded to 2x before the FFT so large shifts (side-by-side
    mosaics routinely exceed half the frame) don't alias circularly.
    """
    h, w = a.shape
    am = a.float() - a.float().mean()
    bm = b.float() - b.float().mean()
    Fa = torch.fft.fft2(F.pad(am, (0, w, 0, h)))
    Fb = torch.fft.fft2(F.pad(bm, (0, w, 0, h)))
    cross = Fa * torch.conj(Fb)
    cross = cross / torch.clamp(cross.abs(), min=1e-9)
    corr = torch.fft.ifft2(cross).abs()
    idx = torch.argmax(corr)
    H, W = 2 * h, 2 * w
    dy = idx // W
    dx = idx % W
    dy = torch.where(dy > h, dy - H, dy).float()
    dx = torch.where(dx > w, dx - W, dx).float()
    return dy, dx


# ---------------------------------------------------------------------------
# 2. Harris corners
# ---------------------------------------------------------------------------


def harris_corners(img: torch.Tensor, n_corners: int = 256, k: float = 0.04,
                   border: int = 16):
    """Top-K Harris corner (y, x) positions (int64) + responses."""
    x = img.float()
    dy = (torch.roll(x, -1, 0) - torch.roll(x, 1, 0)) * 0.5
    dx = (torch.roll(x, -1, 1) - torch.roll(x, 1, 1)) * 0.5
    Ixx = gaussian_filter(dx * dx, 1.5)
    Iyy = gaussian_filter(dy * dy, 1.5)
    Ixy = gaussian_filter(dx * dy, 1.5)
    resp = Ixx * Iyy - Ixy ** 2 - k * (Ixx + Iyy) ** 2
    # non-max suppression over 5x5 ("SAME": 2 before, 2 after) + border
    nms = F.max_pool2d(F.pad(resp[None, None], (2, 2, 2, 2),
                             value=float("-inf")), 5, stride=1)[0, 0]
    h, w = resp.shape
    ys = torch.arange(h, device=x.device)[:, None]
    xs = torch.arange(w, device=x.device)[None, :]
    ok = (resp == nms) & (ys >= border) & (ys < h - border) \
        & (xs >= border) & (xs < w - border)
    flat = torch.where(ok, resp, float("-inf")).reshape(-1)
    vals, idx = top_k(flat, n_corners)
    return torch.stack([idx // w, idx % w], dim=1), vals


# ---------------------------------------------------------------------------
# 3. patch NCC matching around the phase prior
# ---------------------------------------------------------------------------


def _windows(img: torch.Tensor, starts: torch.Tensor, size: int):
    """(N, size, size) windows of ``img`` at (N, 2) integer origins, each
    clamped to lie inside ``img`` (``lax.dynamic_slice``'s rule)."""
    h, w = img.shape
    ar = torch.arange(size, device=img.device)
    y0 = torch.clamp(starts[:, 0].long(), 0, h - size)
    x0 = torch.clamp(starts[:, 1].long(), 0, w - size)
    return img[(y0[:, None] + ar)[:, :, None], (x0[:, None] + ar)[:, None, :]]


def _extract_patches(img: torch.Tensor, pts: torch.Tensor, size: int):
    """(N, size, size) patches centred at integer points, edge-padded."""
    r = size // 2
    padded = F.pad(img[None, None], (r, r, r, r), mode="replicate")[0, 0]
    return _windows(padded, pts, size)


def ncc_match(
    img1: torch.Tensor, img2: torch.Tensor, pts1: torch.Tensor,
    prior_dy: torch.Tensor, prior_dx: torch.Tensor,
    patch: int = 11, search: int = 24,
):
    """For each corner in img1, the best NCC match in img2 within ±search
    of the phase-prior location. Returns (pts2, score)."""
    img1 = img1.float()
    img2 = img2.float()
    h, w = img2.shape
    p1 = _extract_patches(img1, pts1, patch)
    p1 = p1 - p1.mean(dim=(1, 2), keepdim=True)
    p1 = p1 / torch.clamp(torch.sqrt((p1 * p1).sum(dim=(1, 2), keepdim=True)),
                          min=1e-6)

    win = 2 * search + patch
    pdy = torch.round(torch.as_tensor(prior_dy, device=img1.device)).long()
    pdx = torch.round(torch.as_tensor(prior_dx, device=img1.device)).long()
    centers = torch.stack([
        torch.clamp(pts1[:, 0].long() - pdy - win // 2, 0, h - 1),
        torch.clamp(pts1[:, 1].long() - pdx - win // 2, 0, w - 1),
    ], dim=1)
    padded2 = F.pad(img2[None, None], (win, win, win, win),
                    mode="replicate")[0, 0]
    wins = _windows(padded2, centers + win, win)

    # NCC as a grouped convolution: each corner's unit-norm zero-mean patch
    # filters its own search window; the window's normaliser comes from two
    # box sums. The template is zero-mean, so correlating the raw window
    # equals correlating the mean-subtracted one.
    S = 2 * search + 1
    n = p1.shape[0]
    lhs = wins[None]                                    # (1, N, win, win)

    def gconv(x, rhs):
        return F.conv2d(x, rhs, groups=n)[0]            # (N, S, S)

    raw = gconv(lhs, p1[:, None])
    ones = torch.ones((n, 1, patch, patch), dtype=torch.float32,
                      device=img1.device)
    s1 = gconv(lhs, ones)
    s2 = gconv(lhs * lhs, ones)
    var = torch.clamp(s2 - s1 * s1 / (patch * patch), min=0.0)
    scores = raw / torch.clamp(torch.sqrt(var), min=1e-6)
    flat = scores.reshape(n, -1)
    sc = flat.amax(dim=1)
    best = torch.argmax(flat, dim=1)
    by = best // S
    bx = best % S
    pts2 = torch.stack([
        centers[:, 0] + by + patch // 2,
        centers[:, 1] + bx + patch // 2,
    ], dim=1)
    return pts2, sc


# ---------------------------------------------------------------------------
# 3b. GMS-style spatial-consistency match prefilter
# ---------------------------------------------------------------------------


def _norm_last(d: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((d * d).sum(-1))


def spatial_consistency_filter(
    pts1: torch.Tensor, pts2: torch.Tensor, weights: torch.Tensor,
    radius: float = 100.0, disp_tol: float = 10.0, min_support: int = 6,
):
    """Zero the weight of matches without local motion support.

    Correct matches on a rigid scene move like their neighbours, while the
    structured outliers of repetitive texture (lattice-aliased matches one
    period off) do not, yet pass any NCC score threshold. Match i survives
    only if ≥ ``min_support`` *other* live matches within ``radius`` px
    (image-1 frame) displace within ``disp_tol`` px of it: one dense
    O(N²) mask.
    """
    p1 = pts1.float()
    v = pts2.float() - p1
    d1 = _norm_last(p1[:, None, :] - p1[None, :, :])
    dv = _norm_last(v[:, None, :] - v[None, :, :])
    live = weights > 0
    eye = torch.eye(d1.shape[0], dtype=torch.bool, device=d1.device)
    near = (d1 <= radius) & ~eye & live[None, :]
    support = (near & (dv <= disp_tol)).sum(dim=1)
    return torch.where(support >= min_support, weights, 0.0)


# ---------------------------------------------------------------------------
# 4. RANSAC homography
# ---------------------------------------------------------------------------


def _norm_transform(pts: torch.Tensor, weights: torch.Tensor | None = None):
    """Hartley normalisation: similarity T mapping points to mean 0 /
    RMS sqrt(2). Raw-pixel DLT mixes O(1) and O(coord^2) terms and loses
    most float32 significant digits on large frames. ``pts`` is (..., N, 2)
    (y, x); T (..., 3, 3) acts on homogeneous (x, y, 1)."""
    w = torch.ones(pts.shape[:-1], dtype=torch.float32, device=pts.device) \
        if weights is None else weights.float()
    wsum = torch.clamp(w.sum(-1), min=1e-6)
    mu = (pts * w[..., None]).sum(-2) / wsum[..., None]
    rms = torch.sqrt((w * ((pts - mu[..., None, :]) ** 2).sum(-1)).sum(-1)
                     / wsum)
    s = np.float32(np.sqrt(2.0)) / torch.clamp(rms, min=1e-6)
    T = torch.zeros(pts.shape[:-2] + (3, 3), dtype=torch.float32,
                    device=pts.device)
    T[..., 0, 0] = s
    T[..., 1, 1] = s
    T[..., 0, 2] = -s * mu[..., 1]
    T[..., 1, 2] = -s * mu[..., 0]
    T[..., 2, 2] = 1.0
    return T, mu, s


def _apply_norm(pts: torch.Tensor, mu: torch.Tensor, s: torch.Tensor):
    return (pts - mu[..., None, :]) * s[..., None, None]


def _dlt(p1: torch.Tensor, p2: torch.Tensor,
         weights: torch.Tensor | None = None) -> torch.Tensor:
    """Homography p1 -> p2 from N >= 4 correspondences ((y, x) order in,
    (x, y) math inside) via SVD of the 2N x 9 DLT system, Hartley-normalised.
    Leading batch axes of ``p1``, ``p2`` (and ``weights``) give a batch of
    homographies from one batched SVD."""
    p1 = p1.float()
    p2 = p2.float()
    T1, mu1, s1 = _norm_transform(p1, weights)
    T2, mu2, s2 = _norm_transform(p2, weights)
    p1n = _apply_norm(p1, mu1, s1)
    p2n = _apply_norm(p2, mu2, s2)
    x1, y1 = p1n[..., 1], p1n[..., 0]
    x2, y2 = p2n[..., 1], p2n[..., 0]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    r2 = torch.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], dim=-1)
    if weights is not None:
        r1 = r1 * weights.float()[..., None]
        r2 = r2 * weights.float()[..., None]
    A = torch.cat([r1, r2], dim=-2)
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    Hn = vt[..., -1, :].reshape(vt.shape[:-2] + (3, 3))
    # denormalise: H = T2^-1 Hn T1 (T acts in (x, y) homogeneous coords)
    Hm = torch.linalg.inv(T2) @ Hn @ T1
    h22 = Hm[..., 2, 2]
    return Hm / torch.where(h22.abs() > 1e-12, h22, 1e-12)[..., None, None]


def _project(Hm: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a homography (or a batch, (..., 3, 3)) to (N, 2) (y, x)
    points."""
    x = pts[..., 1]
    y = pts[..., 0]

    def h(i, j):
        return Hm[..., i, j, None]

    d = h(2, 0) * x + h(2, 1) * y + h(2, 2)
    d = torch.where(d.abs() > 1e-9, d, 1e-9)
    xn = (h(0, 0) * x + h(0, 1) * y + h(0, 2)) / d
    yn = (h(1, 0) * x + h(1, 1) * y + h(1, 2)) / d
    return torch.stack([yn, xn], dim=-1)


def _draw_subsets(weights: torch.Tensor, n_hyp: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """(n_hyp, 4) index sets, each 4 distinct points drawn with
    probabilities ``p ∝ weights + 1e-9``: the top 4 of ``log p`` + Gumbel
    noise (sampling without replacement, ``jax.random.choice``'s method).
    The noise comes from ``generator`` on its own device (by default a CPU
    generator seeded with 0), so the draw is the same on every device."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    n = weights.shape[0]
    wp = weights.float() + 1e-9
    p = wp / wp.sum()
    g = gumbel_noise(n_hyp * n, generator, generator.device)
    g = g.to(weights.device).reshape(n_hyp, n) + torch.log(p)
    return top_k(g, 4)[1]


def _ransac_from(pts1: torch.Tensor, pts2: torch.Tensor,
                 weights: torch.Tensor, idx: torch.Tensor,
                 thresh: float = 5.0):
    """:func:`ransac_homography` from given (n_hyp, 4) index sets."""
    idx = idx.long().to(pts1.device)
    Hs = _dlt(pts1[idx], pts2[idx])                     # (n_hyp, 3, 3)
    err = _norm_last(_project(Hs, pts1) - pts2)         # (n_hyp, N)
    scores = ((err < thresh) & (weights > 0)).sum(dim=1)
    Hm = Hs[torch.argmax(scores)]
    err = _norm_last(_project(Hm, pts1) - pts2)
    inliers = (err < thresh) & (weights > 0)
    # final refit on all inliers (weighted, Hartley-normalised DLT)
    return _dlt(pts1, pts2, weights=inliers.float()), inliers


def ransac_homography(
    pts1: torch.Tensor, pts2: torch.Tensor, weights: torch.Tensor,
    generator: Optional[torch.Generator] = None, thresh: float = 5.0,
    n_hyp: int = 256,
):
    """Best homography pts1->pts2 under inlier count; weighted final refit.

    All ``n_hyp`` hypotheses (4-point DLTs) are solved and scored together;
    the first of the highest inlier count wins."""
    idx = _draw_subsets(weights, n_hyp, generator)
    return _ransac_from(pts1.float(), pts2.float(), weights, idx, thresh)


def affine_fit(p1: torch.Tensor, p2: torch.Tensor, weights: torch.Tensor):
    """Weighted 6-dof affine p1 -> p2 as a 3x3 homography (last row 0,0,1),
    the least-squares solution through the pseudo-inverse (SVD).

    The stable model for thin overlap strips, where a full homography's
    perspective terms are unconstrained and can go wild."""
    w = weights.float()[:, None]
    X = torch.cat([p1[:, 1:2], p1[:, 0:1], torch.ones_like(w)], dim=1)
    Y = torch.stack([p2[:, 1], p2[:, 0]], dim=1)
    sol = torch.linalg.pinv(X * w) @ (Y * w)
    Hm = torch.eye(3, dtype=torch.float32, device=p1.device)
    Hm[0] = sol[:, 0]
    Hm[1] = sol[:, 1]
    return Hm


# ---------------------------------------------------------------------------
# 5. DP seam + composition
# ---------------------------------------------------------------------------


def dp_seam(energy: torch.Tensor) -> torch.Tensor:
    """Min-energy vertical seam: a column index per row.

    The forward pass accumulates the DP table row by row on the energy's
    device, keeping each pixel's parent choice (left, middle, right; the
    first minimum on ties); the seam is read back on the host from the
    last row's first minimum."""
    h, w = energy.shape
    e = energy.float()
    big = torch.full((1,), 1e9, dtype=torch.float32, device=e.device)
    prev = torch.zeros(w, dtype=torch.float32, device=e.device)
    choices = torch.empty((h, w), dtype=torch.int64, device=e.device)
    for r in range(h):
        stacked = torch.stack([torch.cat([big, prev[:-1]]), prev,
                               torch.cat([prev[1:], big])])
        best, choices[r] = torch.min(stacked, dim=0)
        prev = e[r] + best
    ch = choices.cpu().numpy()
    seam = np.empty(h, np.int64)
    j = int(torch.argmin(prev))
    for r in range(h - 1, -1, -1):
        seam[r] = j
        j = min(max(j + int(ch[r, j]) - 1, 0), w - 1)
    return torch.from_numpy(seam).to(e.device)


class StitchResult(NamedTuple):
    mosaic: torch.Tensor
    homography: torch.Tensor
    n_inliers: torch.Tensor
    seam: torch.Tensor
    canvas_offset: Tuple[int, int]


class ImageStitcher:
    """stitch(img1, img2): estimate H (img2->img1 frame), compose with a DP
    seam through the overlap (feathered around the seam), on ``device``
    (default ``"cuda"``)."""

    def __init__(self, n_corners: int = 256, patch: int = 11, search: int = 24,
                 ransac_thresh: float = 5.0, blend_width: int = 16,
                 device="cuda"):
        self.n_corners = n_corners
        self.patch = patch
        self.search = search
        self.ransac_thresh = ransac_thresh
        self.blend_width = blend_width
        self.device = torch.device(device)

    def _tensor(self, img) -> torch.Tensor:
        if isinstance(img, torch.Tensor):
            return img.to(self.device, torch.float32)
        return torch.tensor(np.asarray(img, np.float32), device=self.device)

    def estimate(self, img1, img2, generator=None):
        img1 = self._tensor(img1)
        img2 = self._tensor(img2)
        # phase correlation needs a common shape: use the top-left overlap
        ch = min(img1.shape[0], img2.shape[0])
        cw = min(img1.shape[1], img2.shape[1])
        dy, dx = phase_correlation(img1[:ch, :cw], img2[:ch, :cw])
        pts1, _ = harris_corners(img1, self.n_corners)
        pts2, score = ncc_match(img1, img2, pts1, dy, dx,
                                patch=self.patch, search=self.search)
        wts = torch.where(score > 0.5, score, 0.0)
        # spatial-consistency prefilter: NCC score alone passes
        # lattice-aliased matches on repetitive texture
        p1f = pts1.float()
        p2f = pts2.float()
        wts = spatial_consistency_filter(p1f, p2f, wts)
        Hm, inl = ransac_homography(p1f, p2f, wts, generator,
                                    thresh=self.ransac_thresh)
        return Hm, inl, p1f, p2f

    def stitch(self, img1, img2, generator=None,
               min_inliers: int = 8) -> StitchResult:
        img1 = self._tensor(img1)
        img2 = self._tensor(img2)
        Hm, inl, p1f, p2f = self.estimate(img1, img2, generator)

        # match-quality guard (cv2.findHomography returns None in the same
        # situation): without enough inliers the homography is garbage and
        # the canvas below can explode
        n_inl = int(inl.sum())
        if n_inl < min_inliers:
            raise ValueError(
                f"stitching failed: only {n_inl} consistent matches "
                f"(need >= {min_inliers}) — do the images overlap?"
            )

        h1, w1 = img1.shape
        h2, w2 = img2.shape

        def canvas_of(Hn):
            if not np.isfinite(Hn).all() or abs(np.linalg.det(Hn)) < 1e-9:
                return None
            Hinv = np.linalg.inv(Hn)
            corners = np.array(
                [[0, 0], [0, w2 - 1], [h2 - 1, 0], [h2 - 1, w2 - 1]],
                np.float32)
            proj = _project(torch.from_numpy(Hinv.astype(np.float32)),
                            torch.from_numpy(corners)).numpy()
            y0 = int(np.floor(min(0.0, proj[:, 0].min())))
            x0 = int(np.floor(min(0.0, proj[:, 1].min())))
            y1 = int(np.ceil(max(h1 - 1.0, proj[:, 0].max()))) + 1
            x1 = int(np.ceil(max(w1 - 1.0, proj[:, 1].max()))) + 1
            ch, cw = y1 - y0, x1 - x0
            if ch * cw > 16 * (h1 * w1 + h2 * w2):
                return None  # wild perspective -> multi-GB canvas
            return Hinv, y0, x0, ch, cw

        # canvas bounds: img2's corners projected into the img1 frame (host
        # math). Thin overlap strips underconstrain the perspective terms;
        # fall back to the 6-dof affine fit when the full homography goes
        # wild.
        bounds = canvas_of(Hm.cpu().numpy())
        if bounds is None:
            Hm = affine_fit(p1f, p2f, inl.float())
            bounds = canvas_of(Hm.cpu().numpy())
        if bounds is None:
            raise ValueError("stitching failed: degenerate geometry even "
                             "under the affine fallback")
        Hinv, y0, x0, ch, cw = bounds
        Hn = Hm.cpu().numpy()

        # warp both onto the canvas (translation for img1; H∘T for img2)
        T = np.array([[1.0, 0, y0], [0, 1, x0], [0, 0, 1]])  # canvas->img1 (y,x)

        # homography_warp takes the pixel transform in (x, y)
        def yx_to_xy(M):
            P = np.array([[0, 1, 0], [1, 0, 0], [0, 0, 1.0]])
            return P @ M @ P

        dev = self.device
        H1c = torch.tensor(yx_to_xy(T), dtype=torch.float32, device=dev)
        H2c = torch.tensor(yx_to_xy(Hn @ T), dtype=torch.float32, device=dev)
        warp1 = homography_warp(img1, H1c, (ch, cw), fill=float("nan"))
        warp2 = homography_warp(img2, H2c, (ch, cw), fill=float("nan"))

        m1 = torch.isfinite(warp1)
        m2 = torch.isfinite(warp2)
        overlap = m1 & m2
        diff = torch.where(overlap, (warp1 - warp2).abs(), 0.0)
        # energy outside the overlap is high so the seam stays inside it
        energy = torch.where(overlap, diff, 1e3)
        seam = dp_seam(energy)

        xs = torch.arange(cw, device=dev)[None, :]
        # feathered alpha around the seam
        dist = (xs - seam[:, None]).float()
        alpha = torch.clamp(0.5 - dist / (2 * self.blend_width), 0.0, 1.0)
        w1_ = torch.where(m1, torch.where(m2, alpha, 1.0), 0.0)
        w2_ = torch.where(m2, torch.where(m1, 1.0 - alpha, 1.0), 0.0)
        total = torch.clamp(w1_ + w2_, min=1e-6)
        mosaic = (torch.nan_to_num(warp1) * w1_
                  + torch.nan_to_num(warp2) * w2_) / total
        mosaic = torch.where(m1 | m2, mosaic, float("nan"))
        return StitchResult(
            mosaic=mosaic, homography=Hm,
            n_inliers=inl.sum(), seam=seam, canvas_offset=(y0, x0),
        )


class ImageStitchingPlugin(SatellitePlugin):
    """Two-image plugin: the host introspects the ``image2`` keyword to
    show a second picker. Runs on ``device`` (default ``"cuda"``)."""

    def __init__(self, stitcher: ImageStitcher | None = None, device="cuda"):
        self.stitcher = stitcher or ImageStitcher(device=device)

    @property
    def name(self) -> str:
        return "Image Stitching"

    def run(self, image: np.ndarray, viewer=None, image2: np.ndarray = None) -> List[Layer]:
        if image2 is None:
            raise ValueError("stitching needs image2")
        a = np.asarray(image, np.float32)
        b = np.asarray(image2, np.float32)
        if a.ndim == 3:
            a = a.mean(-1)
        if b.ndim == 3:
            b = b.mean(-1)
        res = self.stitcher.stitch(a, b)
        return [
            (image, {"name": "image 1"}, "image"),
            (image2, {"name": "image 2"}, "image"),
            (res.mosaic.cpu().numpy(), {"name": "mosaic"}, "image"),
        ]
