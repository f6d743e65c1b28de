"""Oriented-box detection evaluation: rotated IoU + mAP50 (port of
``pcmi_tpu/models/detector_eval.py``, host numpy, the same arithmetic).

Exact rotated-rectangle IoU via polygon clipping (Sutherland–Hodgman)
and all-point-interpolated average precision at a fixed IoU threshold.
An oriented box (OBB) is ``(cy, cx, h, w, theta)`` with ``theta`` the
rotation of the box's h-axis from the image y-axis, radians.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def obb_corners(obb: np.ndarray) -> np.ndarray:
    """(..., 5) OBBs -> (..., 4, 2) corner polygons in (y, x) order."""
    obb = np.asarray(obb, np.float64)
    cy, cx, h, w, th = (obb[..., k] for k in range(5))
    cos, sin = np.cos(th), np.sin(th)
    # local corners (dy, dx) before rotation
    dy = np.stack([-h / 2, -h / 2, h / 2, h / 2], axis=-1)
    dx = np.stack([-w / 2, w / 2, w / 2, -w / 2], axis=-1)
    y = cy[..., None] + dy * cos[..., None] - dx * sin[..., None]
    x = cx[..., None] + dy * sin[..., None] + dx * cos[..., None]
    return np.stack([y, x], axis=-1)


def _polygon_area(poly: np.ndarray) -> float:
    y = poly[:, 0]
    x = poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _clip_polygon(subject: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Clip ``subject`` by the half-plane left of directed edge a->b."""
    out: List[np.ndarray] = []
    n = len(subject)
    if n == 0:
        return subject
    d = b - a

    def side(p):
        return d[1] * (p[0] - a[0]) - d[0] * (p[1] - a[1])

    for i in range(n):
        p, q = subject[i], subject[(i + 1) % n]
        sp, sq = side(p), side(q)
        if sp >= 0:
            out.append(p)
        if (sp >= 0) != (sq >= 0):
            t = sp / (sp - sq)
            out.append(p + t * (q - p))
    return np.asarray(out) if out else np.zeros((0, 2))


def rotated_iou(obb1: np.ndarray, obb2: np.ndarray) -> float:
    """Exact IoU of two oriented rectangles (polygon clipping)."""
    p1 = obb_corners(np.asarray(obb1)[None])[0]
    p2 = obb_corners(np.asarray(obb2)[None])[0]
    inter = p1
    for i in range(4):
        inter = _clip_polygon(inter, p2[i], p2[(i + 1) % 4])
        if len(inter) == 0:
            return 0.0
    ai = _polygon_area(inter)
    a1 = _polygon_area(p1)
    a2 = _polygon_area(p2)
    union = a1 + a2 - ai
    return float(ai / union) if union > 0 else 0.0


def average_precision(recalls: np.ndarray, precisions: np.ndarray) -> float:
    """All-point interpolated AP (area under the P-R envelope)."""
    r = np.concatenate([[0.0], recalls, [1.0]])
    p = np.concatenate([[0.0], precisions, [0.0]])
    # precision envelope
    for i in range(len(p) - 2, -1, -1):
        p[i] = max(p[i], p[i + 1])
    idx = np.where(r[1:] != r[:-1])[0]
    return float(np.sum((r[idx + 1] - r[idx]) * p[idx + 1]))


def map50(
    detections: Sequence[np.ndarray],
    ground_truths: Sequence[np.ndarray],
    iou_thresh: float = 0.5,
) -> Tuple[float, dict]:
    """mAP at a fixed rotated-IoU threshold, single-class.

    ``detections[i]`` is (Di, 6): (cy, cx, h, w, theta, score) for image i;
    ``ground_truths[i]`` is (Gi, 5) OBBs. Returns ``(ap, stats)``.
    """
    records = []  # (score, is_tp)
    n_gt = 0
    for det, gt in zip(detections, ground_truths):
        det = np.asarray(det, np.float64).reshape(-1, 6)
        gt = np.asarray(gt, np.float64).reshape(-1, 5)
        n_gt += len(gt)
        taken = np.zeros(len(gt), bool)
        order = np.argsort(-det[:, 5])
        for di in order:
            box = det[di, :5]
            best_iou, best_j = 0.0, -1
            for j in range(len(gt)):
                if taken[j]:
                    continue
                iou = rotated_iou(box, gt[j])
                if iou > best_iou:
                    best_iou, best_j = iou, j
            if best_iou >= iou_thresh and best_j >= 0:
                taken[best_j] = True
                records.append((det[di, 5], True))
            else:
                records.append((det[di, 5], False))
    if n_gt == 0:
        return float("nan"), {"n_gt": 0, "n_det": len(records)}
    records.sort(key=lambda r: -r[0])
    tps = np.cumsum([r[1] for r in records]) if records else np.zeros(0)
    fps = np.cumsum([not r[1] for r in records]) if records else np.zeros(0)
    recalls = tps / n_gt
    precisions = tps / np.maximum(tps + fps, 1e-9)
    ap = average_precision(recalls, precisions) if records else 0.0
    # PR curve samples: best precision at/above fixed recall levels
    pr_curve = {}
    for r in (0.5, 0.7, 0.8, 0.9, 0.95):
        m = recalls >= r
        pr_curve[f"p_at_r{r:g}"] = float(precisions[m].max()) if m.any() else 0.0
    return ap, {
        "n_gt": n_gt,
        "n_det": len(records),
        "recall": float(recalls[-1]) if len(recalls) else 0.0,
        "precision": float(precisions[-1]) if len(precisions) else 0.0,
        "pr_curve": pr_curve,
    }
