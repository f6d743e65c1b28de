"""OBIA land-use classification: superpixels -> features -> K-means (port
of ``pcmi_tpu/pipelines/landuse.py``).

SLIC superpixels (n ≈ 1500, compactness 20), a 20-dim per-pixel feature
stack (LAB colour, a 16-filter Gabor bank each blurred 15x15, local
entropy), per-superpixel means, StandardScaler + K-means (k = 5) on the
object features, and the label-map reconstruction with boundary and PCA
visualisations.

SLIC is K-means over (colour, compact·y, compact·x) features: each Lloyd
step's distances are chunked ``|q|² - 2 q·c + |c|²`` products (the
reference's form, whose rounding decides the argmin). Per-superpixel sums
are one ``index_add_`` each, accumulated in float64 and cast back, so the
card's sums do not depend on the order of its atomic adds. The PCA's
eigenvectors come from LAPACK's ``ssyevd`` on the CPU, as the reference's
do, signs included.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from pcmi_tpu_torch.interface import Layer, SatellitePlugin
from pcmi_tpu_torch.ops.filters import (
    box_filter,
    filter_bank_2d,
    gabor_bank,
    local_entropy,
)
from pcmi_tpu_torch.ops.pointcloud import _kmeans_from, gumbel_noise

_RGB_TO_XYZ = torch.tensor([
    [0.4124564, 0.3575761, 0.1804375],
    [0.2126729, 0.7151522, 0.0721750],
    [0.0193339, 0.1191920, 0.9503041],
], dtype=torch.float32)
_WHITE = torch.tensor([0.95047, 1.0, 1.08883], dtype=torch.float32)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB [0, 1] -> CIELAB (D65), vectorised over leading axes."""
    rgb = torch.clamp(rgb.float(), 0.0, 1.0)
    lin = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                      rgb / 12.92)
    xyz = lin @ _RGB_TO_XYZ.to(rgb.device).T
    t = xyz / _WHITE.to(rgb.device)
    # t >= 0 here (lin >= 0, M >= 0), so the real cube root is t ** (1/3)
    f = torch.where(t > (6 / 29) ** 3, t ** (1.0 / 3.0),
                    t / (3 * (6 / 29) ** 2) + 4 / 29)
    L = 116 * f[..., 1] - 16
    a = 500 * (f[..., 0] - f[..., 1])
    b = 200 * (f[..., 1] - f[..., 2])
    return torch.stack([L, a, b], dim=-1)


class SlicResult(NamedTuple):
    labels: torch.Tensor     # (H, W) int32 superpixel ids
    centers: torch.Tensor    # (K, D) final cluster features
    n_segments: int


def _segment_sum(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``segment_sum`` of the rows of ``x`` by ``ids`` into ``n`` segments,
    accumulated in float64 and returned in float32."""
    out = torch.zeros((n,) + x.shape[1:], dtype=torch.float64, device=x.device)
    return out.index_add_(0, ids.long(), x.double()).float()


def _eigh_vectors(cov: torch.Tensor) -> torch.Tensor:
    """Eigenvectors (ascending eigenvalues) of the symmetrised ``cov``, as
    ``jnp.linalg.eigh`` gives them. On the CPU that is LAPACK's ``ssyevd``
    on the lower triangle, the routine the reference calls there: the same
    vectors, signs included (``torch.linalg.eigh`` fixes no sign)."""
    sym = (cov + cov.T) / 2.0
    if sym.device.type != "cpu":
        return torch.linalg.eigh(sym)[1]
    from scipy.linalg import lapack

    _, vecs, _ = lapack.ssyevd(sym.numpy(), compute_v=1, lower=1)
    return torch.from_numpy(np.ascontiguousarray(vecs, np.float32))


def slic(
    image: torch.Tensor,
    n_segments: int = 256,
    compactness: float = 20.0,
    iters: int = 8,
    chunk: int = 16384,
) -> SlicResult:
    """SLIC superpixels as grid-seeded K-means over (lab, s·y, s·x).

    ``compactness`` weights the spatial terms as skimage does: spatial
    features are scaled by ``compactness / S`` with grid step ``S``.
    Distances are evaluated ``chunk`` pixels at a time, each chunk one
    (chunk x K) product.
    """
    img = image.float()
    if img.dim() == 2:
        feats = img[..., None] * 100.0  # grayscale pseudo-L
    else:
        feats = rgb_to_lab(img)
    h, w = feats.shape[:2]
    dev = img.device
    S = float(np.sqrt(h * w / n_segments))
    ratio = np.float32(compactness / S)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    X = torch.cat([feats, (ys * ratio)[..., None], (xs * ratio)[..., None]],
                  dim=-1)
    X = X.reshape(-1, X.shape[-1])
    n = X.shape[0]

    # grid seeding (host)
    gh = int(np.round(np.sqrt(n_segments * h / w)))
    gw = int(np.ceil(n_segments / max(gh, 1)))
    cy = (np.arange(gh) + 0.5) * h / gh
    cx = (np.arange(gw) + 0.5) * w / gw
    grid = np.stack(np.meshgrid(cy, cx, indexing="ij"), -1).reshape(-1, 2)
    grid = grid[:n_segments] if len(grid) >= n_segments else np.pad(
        grid, ((0, n_segments - len(grid)), (0, 0)), mode="edge")
    seed_idx = torch.from_numpy(
        np.clip(grid[:, 0].astype(int), 0, h - 1) * w
        + np.clip(grid[:, 1].astype(int), 0, w - 1)
    ).to(dev)
    centers = X[seed_idx]
    qn_all = (X * X).sum(dim=1, keepdim=True)

    def assign(centers):
        cn = (centers * centers).sum(dim=1)
        out = []
        for start in range(0, n, chunk):
            q = X[start:start + chunk]
            d2 = (qn_all[start:start + chunk] - 2.0 * (q @ centers.T)) \
                + cn[None, :]
            out.append(torch.argmin(d2, dim=1))
        return torch.cat(out).int()

    ones = torch.ones((n, 1), dtype=torch.float32, device=dev)
    for _ in range(iters):
        a = assign(centers)
        sums = _segment_sum(X, a, n_segments)
        cnts = _segment_sum(ones, a, n_segments)[:, 0]
        centers = torch.where(cnts[:, None] > 0,
                              sums / torch.clamp(cnts, min=1.0)[:, None],
                              centers)
    labels = assign(centers).reshape(h, w)
    return SlicResult(labels=labels, centers=centers, n_segments=n_segments)


def obia_features(image: torch.Tensor, entropy_radius: int = 5) -> torch.Tensor:
    """20-dim per-pixel stack: LAB(3) + 16 blurred Gabor responses +
    entropy."""
    img = image.float()
    gray = img if img.dim() == 2 else img.mean(-1)
    lab = (
        torch.stack([gray * 100.0, torch.zeros_like(gray),
                     torch.zeros_like(gray)], -1)
        if img.dim() == 2 else rgb_to_lab(img)
    )
    bank = gabor_bank()  # 16 kernels, ksize 31
    gab = filter_bank_2d(gray, bank)                          # (16, H, W)
    gab = box_filter(gab.abs().permute(1, 2, 0), 7)            # blur 15x15
    ent = local_entropy(torch.clamp(gray, 0.0, 1.0), radius=entropy_radius)
    return torch.cat([lab, gab, ent[..., None]], dim=-1)


class OBIAResult(NamedTuple):
    superpixels: torch.Tensor   # (H, W) int32
    classes: torch.Tensor       # (H, W) int32 in [0, k)
    pca_rgb: torch.Tensor       # (H, W, 3) visualisation
    boundaries: torch.Tensor    # (H, W) bool


def _obia_core(image: torch.Tensor, n_segments: int, k: int,
               generator: Optional[torch.Generator] = None,
               first: Optional[torch.Tensor] = None) -> OBIAResult:
    """The OBIA pipeline. K-means starts from segment ``first`` when it is
    given, else from the Gumbel arg-max of ``log present`` drawn from
    ``generator`` on its own device (by default a CPU generator seeded with
    0), so the same generator gives the same start on every device."""
    feats = obia_features(image)
    sp = slic(image, n_segments=n_segments)
    flat = feats.reshape(-1, feats.shape[-1])
    lab = sp.labels.reshape(-1)

    # per-superpixel means
    sums = _segment_sum(flat, lab, n_segments)
    cnts = _segment_sum(torch.ones_like(flat[:, :1]), lab, n_segments)[:, 0]
    seg_feats = sums / torch.clamp(cnts, min=1.0)[:, None]
    present = cnts > 0

    # StandardScaler over present segments
    npres = torch.clamp(present.sum(), min=1)
    mu = (seg_feats * present[:, None]).sum(0) / npres
    var = (((seg_feats - mu) ** 2) * present[:, None]).sum(0) / npres
    z = (seg_feats - mu) / torch.sqrt(var + 1e-8)

    w = present.float()
    if first is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        logw = torch.where(w > 0, torch.log(torch.clamp(w, min=1e-12)),
                           float("-inf"))
        g = gumbel_noise(n_segments, generator, generator.device)
        first = torch.argmax(logw + g.to(z.device))
    km = _kmeans_from(z, w, k, 25, first)
    classes = km.assignment[lab].reshape(sp.labels.shape)

    # 3-component PCA visualisation of the z features
    zp = z * present[:, None]
    cov = (zp.T @ zp) / npres
    vecs = _eigh_vectors(cov)
    proj = z @ vecs[:, -3:]
    lo = proj.amin(0)
    pca_seg = (proj - lo) / torch.clamp(proj.amax(0) - lo, min=1e-6)
    pca_rgb = pca_seg[lab].reshape(*sp.labels.shape, 3)

    lbl = sp.labels
    boundaries = (lbl != torch.roll(lbl, 1, 0)) | (lbl != torch.roll(lbl, 1, 1))
    return OBIAResult(superpixels=sp.labels, classes=classes,
                      pca_rgb=pca_rgb, boundaries=boundaries)


class OBIAClassifier:
    """SLIC + features + K-means on ``device`` (default ``"cuda"``); the
    K-means start is drawn from a generator seeded with ``seed``."""

    def __init__(self, n_segments: int = 1500, k: int = 5, seed: int = 0,
                 device="cuda"):
        self.n_segments = n_segments
        self.k = k
        self.seed = seed
        self.device = torch.device(device)

    def run_obia_pipeline(self, image) -> OBIAResult:
        img = torch.as_tensor(np.asarray(image, np.float32)
                              if not isinstance(image, torch.Tensor)
                              else image, device=self.device)
        return _obia_core(img, self.n_segments, self.k,
                          torch.Generator().manual_seed(self.seed))


class LandUseClassificationPlugin(SatellitePlugin):
    """Layers input / superpixel boundaries / PCA / classification labels;
    runs its default :class:`OBIAClassifier` on ``device`` (default
    ``"cuda"``)."""

    def __init__(self, classifier: OBIAClassifier | None = None,
                 device="cuda"):
        self.classifier = classifier or OBIAClassifier(device=device)

    @property
    def name(self) -> str:
        return "Land Use Classification"

    def run(self, image: np.ndarray, viewer=None) -> List[Layer]:
        img = np.asarray(image, np.float32)
        scale = img.max() if img.max() > 1.5 else 1.0
        res = self.classifier.run_obia_pipeline(img / scale)
        return [
            (image, {"name": "input"}, "image"),
            (res.boundaries.cpu().numpy().astype(np.uint8),
             {"name": "superpixels", "opacity": 0.5}, "image"),
            (res.pca_rgb.cpu().numpy(), {"name": "pca"}, "image"),
            (res.classes.cpu().numpy().astype(np.int32),
             {"name": "classification"}, "labels"),
        ]
