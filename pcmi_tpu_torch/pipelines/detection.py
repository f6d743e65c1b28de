"""Sliced-tile object detection with a pluggable detector head (port of
``pcmi_tpu/pipelines/detection.py``).

Large scenes are cut into overlapping slices (640 px, 20 % overlap), a
detector runs on the whole ``(N, tile, tile)`` batch of slices at once,
slice detections are shifted back to scene coordinates and fused with
class-aware NMS, and results become a shapes layer with
``{class}: {confidence:.2f}`` labels.

The detector is any callable ``(N, tile, tile) -> (N, K, 6)`` of rows
``(y0, x0, y1, x1, score, class)``; the training-free default is the
spectral-residual blob detector. Orders follow the reference exactly:
the NMS visits boxes by descending score with ties in index order
(a stable sort), and every top-k takes the lower index first on ties.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch

from pcmi_tpu_torch.interface import Layer, SatellitePlugin
from pcmi_tpu_torch.ops.pointcloud import top_k


class SliceGrid(NamedTuple):
    offsets: np.ndarray   # (N, 2) int (y, x) slice origins
    tile: int


def slice_offsets(shape: Tuple[int, int], tile: int = 640,
                  overlap: float = 0.2) -> SliceGrid:
    """SAHI-style slice origins covering ``shape``."""
    h, w = shape
    step = max(1, int(tile * (1.0 - overlap)))

    def starts(total):
        if total <= tile:
            return [0]
        s = list(range(0, total - tile, step))
        s.append(total - tile)
        return s

    offs = [(y, x) for y in starts(h) for x in starts(w)]
    return SliceGrid(offsets=np.asarray(offs, np.int32), tile=tile)


def extract_slices(img: torch.Tensor, offsets, tile: int) -> torch.Tensor:
    """(N, tile, tile) batch of slices at the (y, x) ``offsets``; an origin
    is clamped so that its slice lies inside the image."""
    h, w = img.shape
    offs = np.asarray(offsets.cpu() if isinstance(offsets, torch.Tensor)
                      else offsets).reshape(-1, 2)
    return torch.stack([
        img[y:y + tile, x:x + tile]
        for y, x in ((min(max(int(y), 0), h - tile),
                      min(max(int(x), 0), w - tile)) for y, x in offs)])


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float = 0.5,
        max_out: int = 256, classes: torch.Tensor | None = None) -> torch.Tensor:
    """Greedy NMS over an O(K²) IoU matrix: indices of kept boxes, highest
    score first, padded with -1.

    Boxes are (K, 4) ``(y0, x0, y1, x1)``. Boxes are visited in descending
    score (ties in index order); a box is dropped when a kept box of higher
    score overlaps it by more than ``iou_thresh``. When ``classes`` is
    given, boxes of different classes never suppress each other.
    """
    boxes = boxes.float()
    scores = scores.float()
    y0, x0, y1, x1 = boxes.unbind(1)
    area = torch.clamp(y1 - y0, min=0) * torch.clamp(x1 - x0, min=0)
    iy0 = torch.maximum(y0[:, None], y0[None, :])
    ix0 = torch.maximum(x0[:, None], x0[None, :])
    iy1 = torch.minimum(y1[:, None], y1[None, :])
    ix1 = torch.minimum(x1[:, None], x1[None, :])
    inter = torch.clamp(iy1 - iy0, min=0) * torch.clamp(ix1 - ix0, min=0)
    iou = inter / torch.clamp(area[:, None] + area[None, :] - inter, min=1e-9)
    if classes is not None:
        same = classes[:, None] == classes[None, :]
        iou = torch.where(same, iou, 0.0)

    order = torch.sort(-scores, stable=True).indices.tolist()
    k = boxes.shape[0]
    ar = torch.arange(k, device=boxes.device)
    over = (iou > iou_thresh) & (ar[:, None] != ar[None, :])
    keep = scores > 0
    for idx in order:  # sequential by definition
        higher = keep & (scores > scores[idx])
        keep[idx] = keep[idx] & ~(higher & over[idx]).any()
    kept_scores = torch.where(keep, scores, float("-inf"))
    _, top = top_k(kept_scores, min(max_out, k))
    return torch.where(keep[top], top, -1)


def default_blob_detector(max_boxes: int = 16, thresh_scale: float = 3.0):
    """Training-free per-slice detector: spectral-residual saliency blobs.

    Returns a callable ``(N, T, T) -> (N, max_boxes, 6)`` of rows
    ``(y0, x0, y1, x1, score, class=0)``: per slice, the ``max_boxes``
    largest label buckets (labels modulo 512; lower bucket first on equal
    counts), each as the box and mean saliency of its pixels.
    """
    from pcmi_tpu_torch.pipelines.saliency import (
        label_components, spectral_residual_tile)

    table = 512

    def detect(batch: torch.Tensor) -> torch.Tensor:
        sal = spectral_residual_tile(batch.float())             # (N, T, T)
        n, h, w = sal.shape
        dev = sal.device
        mean = sal.mean(dim=(1, 2), keepdim=True)
        peak = sal.amax(dim=(1, 2), keepdim=True)
        mask = sal >= torch.minimum(thresh_scale * mean, peak)
        labels = label_components(mask, max_iters=64)
        ids = torch.where(labels >= 0, labels % table, table).long()
        # per-slice bucket statistics: one scatter over N * (table + 1)
        seg = (ids + (table + 1) * torch.arange(
            n, device=dev)[:, None, None]).reshape(-1)
        nseg = n * (table + 1)
        cnt = torch.zeros(nseg, dtype=torch.int64, device=dev).index_add_(
            0, seg, torch.ones_like(seg)).reshape(n, table + 1)
        ssum = torch.zeros(nseg, dtype=torch.float64, device=dev).index_add_(
            0, seg, sal.reshape(-1).double()).float().reshape(n, table + 1)
        ys = torch.arange(h, device=dev)[:, None].expand(h, w)
        xs = torch.arange(w, device=dev)[None, :].expand(h, w)

        def reduce(vals, how, init):
            out = torch.full((nseg,), init, dtype=torch.int64, device=dev)
            src = vals.expand(n, h, w).reshape(-1)
            return out.scatter_reduce_(0, seg, src, how).reshape(
                n, table + 1)

        big = 1 << 20
        y0 = reduce(ys, "amin", big)
        x0 = reduce(xs, "amin", big)
        y1 = reduce(ys, "amax", -1) + 1
        x1 = reduce(xs, "amax", -1) + 1
        counts = cnt.float()
        counts[:, table] = 0.0
        _, top = top_k(counts, max_boxes)                      # (N, K)

        def at(t):
            return torch.gather(t, 1, top)

        c = at(cnt)
        score = torch.where(c > 0, at(ssum) / torch.clamp(c, min=1).float(),
                            0.0)
        return torch.stack([at(y0).float(), at(x0).float(), at(y1).float(),
                            at(x1).float(), score, torch.zeros_like(score)],
                           dim=-1)

    return detect


class Detection(NamedTuple):
    boxes: np.ndarray     # (M, 4) scene-frame (y0, x0, y1, x1)
    scores: np.ndarray    # (M,)
    classes: np.ndarray   # (M,) int


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


class ObjectDetector:
    """Sliced inference on ``device`` (default ``"cuda"``)."""

    def __init__(
        self,
        detector: Callable | None = None,
        tile: int = 640,
        overlap: float = 0.2,
        score_thresh: float = 0.1,
        iou_thresh: float = 0.5,
        device="cuda",
    ):
        self.detector = detector or default_blob_detector()
        self.tile = tile
        self.overlap = overlap
        self.score_thresh = score_thresh
        self.iou_thresh = iou_thresh
        self.device = torch.device(device)

    def detect(self, image) -> Detection:
        img = np.asarray(_host(image), np.float32)
        if img.ndim == 3:
            img = img.mean(-1)
        h, w = img.shape
        tile = min(self.tile, h, w)
        grid = slice_offsets((h, w), tile, self.overlap)
        batch = extract_slices(torch.from_numpy(img).to(self.device),
                               grid.offsets, tile)
        det = _host(self.detector(batch))                   # (N, K, 6)

        boxes = det[..., :4] + np.concatenate(
            [grid.offsets, grid.offsets], axis=1
        )[:, None, :]
        boxes = boxes.reshape(-1, 4)
        scores = det[..., 4].reshape(-1)
        classes = det[..., 5].reshape(-1).astype(np.int32)
        ok = scores > self.score_thresh
        boxes, scores, classes = boxes[ok], scores[ok], classes[ok]
        if len(boxes) == 0:
            return Detection(boxes=np.zeros((0, 4)), scores=np.zeros(0),
                             classes=np.zeros(0, np.int32))
        dev = self.device
        keep = nms(torch.tensor(boxes, dtype=torch.float32, device=dev),
                   torch.tensor(scores, dtype=torch.float32, device=dev),
                   self.iou_thresh,
                   classes=torch.from_numpy(classes).to(dev)).cpu().numpy()
        keep = keep[keep >= 0]
        return Detection(boxes=boxes[keep], scores=scores[keep],
                         classes=classes[keep])

    @staticmethod
    def to_coco(det: Detection, image_id: int = 0) -> list:
        """COCO-style dicts (``bbox`` is ``[x, y, width, height]``)."""
        out = []
        for (y0, x0, y1, x1), s, c in zip(det.boxes, det.scores, det.classes):
            out.append({
                "image_id": image_id,
                "category_id": int(c),
                "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                "score": float(s),
            })
        return out


class ObjectAnnotationPlugin(SatellitePlugin):
    """Shapes layer of labelled detection boxes; runs its default
    :class:`ObjectDetector` on ``device`` (default ``"cuda"``)."""

    def __init__(self, detector: ObjectDetector | None = None,
                 class_names: List[str] | None = None, device="cuda"):
        self.detector = detector or ObjectDetector(device=device)
        self.class_names = class_names or ["object"]

    @property
    def name(self) -> str:
        return "Object Detection"

    def run(self, image: np.ndarray, viewer=None) -> List[Layer]:
        det = self.detector.detect(image)
        layers: List[Layer] = [(image, {"name": "input"}, "image")]
        if len(det.boxes):
            rects = np.stack([
                np.array([[y0, x0], [y0, x1], [y1, x1], [y1, x0]], np.float32)
                for (y0, x0, y1, x1) in det.boxes
            ])
            labels = [
                f"{self.class_names[min(c, len(self.class_names) - 1)]}: {s:.2f}"
                for c, s in zip(det.classes, det.scores)
            ]
            layers.append((
                rects,
                {"name": "detections", "edge_color": "lime",
                 "face_color": "transparent", "shape_type": "rectangle",
                 "properties": {"label": labels},
                 "text": {"string": "{label}", "color": "lime"}},
                "shapes",
            ))
        return layers
