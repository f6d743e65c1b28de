"""The port's sliced detection (``pcmi_tpu_torch.pipelines.detection``)
against ``pcmi_tpu.pipelines.detection`` on the CPU.

Inputs are numpy draws from a seed fed to both packages. Tolerances: slice
grids, slices, NMS indices and blob boxes bit-exact; blob scores (mean
saliency of a blob) within 1e-5. The reference's cases
(``tests/test_components2.py``) are mirrored at the port's surface.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pcmi_tpu.pipelines import detection as jd
from pcmi_tpu_torch.pipelines import detection as td

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _blobs(rng, size=256):
    img = rng.uniform(0, 0.05, (size, size)).astype(np.float32)
    img[60:76, 60:76] = 1.0
    img[180:200, 150:170] = 1.0
    return img


@pytest.mark.parametrize("shape,tile,overlap", [
    ((1000, 1400), 640, 0.2), ((300, 200), 128, 0.5), ((100, 90), 128, 0.2)])
def test_slice_offsets_and_slices(rng, shape, tile, overlap):
    ref = jd.slice_offsets(shape, tile, overlap)
    got = td.slice_offsets(shape, tile, overlap)
    np.testing.assert_array_equal(got.offsets, ref.offsets)
    assert got.tile == ref.tile
    tile = min(tile, *shape)
    grid = td.slice_offsets(shape, tile, overlap)
    img = rng.uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(jd.extract_slices(jnp.asarray(img),
                                        jnp.asarray(grid.offsets), tile))
    np.testing.assert_array_equal(
        td.extract_slices(_t(img), grid.offsets, tile).numpy(), want)
    np.testing.assert_array_equal(
        td.extract_slices(_t(img), _t(grid.offsets), tile).numpy(), want)


def test_slice_offsets_cover_and_overlap():
    grid = td.slice_offsets((1000, 1400), tile=640, overlap=0.2)
    offs = grid.offsets
    assert offs[:, 0].max() + 640 == 1000
    assert offs[:, 1].max() + 640 == 1400
    assert (offs >= 0).all()
    batch = td.extract_slices(torch.zeros((1000, 1400)), offs, 640)
    assert batch.shape == (len(offs), 640, 640)


def test_nms_suppresses_overlaps():
    boxes = torch.tensor([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]],
                         dtype=torch.float32)
    scores = torch.tensor([0.9, 0.8, 0.7])
    keep = td.nms(boxes, scores, iou_thresh=0.5, max_out=3).numpy()
    kept = set(keep[keep >= 0].tolist())
    assert 0 in kept and 2 in kept and 1 not in kept


@pytest.mark.parametrize("classes", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_nms_bit_exact(rng, classes, ties):
    """Clustered random boxes; with ``ties`` the scores take 4 values, so
    the visiting order and the final top-k depend on the tie order."""
    k = 60
    c = rng.uniform(0, 100, (k, 2))
    size = rng.uniform(5, 25, (k, 2))
    boxes = np.concatenate([c, c + size], 1).astype(np.float32)
    scores = (rng.integers(0, 4, k) * 0.25 if ties
              else rng.uniform(0, 1, k)).astype(np.float32)
    cls = rng.integers(0, 3, k).astype(np.int32) if classes else None
    ref = np.asarray(jd.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.4,
                            max_out=48,
                            classes=None if cls is None else jnp.asarray(cls)))
    got = td.nms(_t(boxes), _t(scores), 0.4, max_out=48,
                 classes=None if cls is None else _t(cls)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_default_blob_detector(rng):
    """Per slice: the same boxes (bit-exact) and scores within 1e-5; the
    empty buckets' rows (zero counts, tied) in the same order."""
    img = _blobs(rng)
    batch = np.stack([img[:128, :128], img[128:, 128:], img[64:192, 96:224]])
    ref = np.asarray(jd.default_blob_detector()(jnp.asarray(batch)))
    got = td.default_blob_detector()(_t(batch)).numpy()
    assert got.shape == ref.shape == (3, 16, 6)
    np.testing.assert_array_equal(got[..., :4], ref[..., :4])
    np.testing.assert_array_equal(got[..., 5], ref[..., 5])
    np.testing.assert_allclose(got[..., 4], ref[..., 4], atol=1e-5, rtol=0)


def test_detector_finds_planted_blobs(rng):
    """``test_components2.py``'s case at the port's surface, and the
    detection against the reference's: the same boxes and classes, scores
    within 1e-5."""
    img = _blobs(rng)
    det = td.ObjectDetector(tile=256, score_thresh=0.05,
                            device="cpu").detect(img)
    assert len(det.boxes) >= 2
    centers = det.boxes[:, :2] + (det.boxes[:, 2:] - det.boxes[:, :2]) / 2
    d1 = np.abs(centers - [68, 68]).sum(1).min()
    d2 = np.abs(centers - [190, 160]).sum(1).min()
    assert d1 < 12 and d2 < 12
    coco = td.ObjectDetector.to_coco(det)
    assert coco and {"image_id", "category_id", "bbox", "score"} <= set(coco[0])

    ref = jd.ObjectDetector(tile=256, score_thresh=0.05).detect(img)
    np.testing.assert_array_equal(det.boxes, ref.boxes)
    np.testing.assert_array_equal(det.classes, ref.classes)
    np.testing.assert_allclose(det.scores, ref.scores, atol=1e-5, rtol=0)
    assert [{k: v for k, v in d.items() if k != "score"} for d in coco] == [
        {k: v for k, v in d.items() if k != "score"}
        for d in jd.ObjectDetector.to_coco(ref)]


def test_detect_sliced_scene(rng):
    """Overlapping slices of a larger RGB scene: NMS across slices."""
    img = rng.uniform(0, 0.05, (300, 360)).astype(np.float32)
    for y, x in ((40, 50), (120, 200), (230, 90), (150, 300)):
        img[y:y + 14, x:x + 18] = 1.0
    rgb = np.repeat(img[..., None], 3, -1)
    kw = dict(tile=128, overlap=0.25, score_thresh=0.05)
    got = td.ObjectDetector(device="cpu", **kw).detect(rgb)
    ref = jd.ObjectDetector(**kw).detect(rgb)
    np.testing.assert_array_equal(got.boxes, ref.boxes)
    np.testing.assert_allclose(got.scores, ref.scores, atol=1e-5, rtol=0)
    assert len(got.boxes) >= 4


def test_detect_nothing():
    """No score above the threshold: an empty detection, as the
    reference's."""
    img = np.zeros((64, 64), np.float32)
    got = td.ObjectDetector(tile=64, score_thresh=2.0,
                            device="cpu").detect(img)
    ref = jd.ObjectDetector(tile=64, score_thresh=2.0).detect(img)
    assert got.boxes.shape == ref.boxes.shape == (0, 4)
    assert td.ObjectDetector.to_coco(got) == []


def test_annotation_plugin_layers(rng):
    """Layers against the reference's plugin; a custom ``detector``
    callable on the (N, T, T) tensor batch and class names."""
    img = _blobs(rng)
    got = td.ObjectAnnotationPlugin(
        td.ObjectDetector(tile=256, score_thresh=0.05, device="cpu")).run(img)
    ref = jd.ObjectAnnotationPlugin(
        jd.ObjectDetector(tile=256, score_thresh=0.05)).run(img)
    assert [k for _, _, k in got] == [k for _, _, k in ref] == [
        "image", "shapes"]
    np.testing.assert_array_equal(got[1][0], ref[1][0])
    assert got[1][1]["properties"] == ref[1][1]["properties"]
    assert td.ObjectAnnotationPlugin(device="cpu").detector.device == \
        torch.device("cpu")

    def fixed(batch):
        assert isinstance(batch, torch.Tensor) and batch.dim() == 3
        out = torch.zeros((batch.shape[0], 1, 6))
        out[:, 0] = torch.tensor([2.0, 3.0, 12.0, 13.0, 0.9, 1.0])
        return out

    layers = td.ObjectAnnotationPlugin(
        td.ObjectDetector(fixed, tile=64, device="cpu"),
        class_names=["car", "ship"]).run(np.zeros((64, 64), np.float32))
    assert layers[1][1]["properties"]["label"] == ["ship: 0.90"]
