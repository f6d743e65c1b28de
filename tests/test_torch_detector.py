"""The port's detector (``pcmi_tpu_torch.models.detector``,
``detector_eval``) against ``pcmi_tpu.models.detector`` and
``detector_eval`` on the CPU.

Heads start from the reference's Flax parameter tree (names and shapes
from ``jax.eval_shape``) filled with seeded numpy draws, carried across by
``convert.centernet_state_dict``; batches are the reference's synthetic
scenes. Tolerances: the head's outputs within 1e-5; heatmaps within
1e-6, the focal loss within 1e-6 and its gradient within 1e-5; after one
and three Adam steps at least 99.9 % of the parameters within 1e-5 and
all within 2 x lr per step, the first step's losses within 1e-5 and a
later step's within 1e-5 + 2 x lr per step before it. Adam scales a
gradient that rounding dominates to a full step (see
``tests/test_torch_training.py``): an L1 term's gradient, a sum of
+-1/n, can cancel to exactly 0 in one package and to an ulp in the
other, and that parameter then moves by 0.75 lr in one package only;
the L1 losses are 1-Lipschitz in it. Decoded boxes within 1e-4 with the
same indices (ties among zero scores: the lower index first); the scene
renderers, fed the reference's own draws, within 1e-6 and their boxes
bit-exact; ``detector_eval`` bit-exact. The reference's cases
(``tests/test_detector.py``) are mirrored at the port's surface.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pcmi_tpu.models import detector as jd
from pcmi_tpu.models import detector_eval as jev
from pcmi_tpu_torch import convert
from pcmi_tpu_torch.models import detector as td
from pcmi_tpu_torch.models import detector_eval as tev
from pcmi_tpu_torch.pipelines.detection import ObjectDetector

from _torch_draws import obb_draws

torch.set_num_threads(1)

TOL = 1e-5
SMALL = (8, 16, 32)


def _params(flax_model, x, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(flax_model.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))

    def draw(s):
        scale = np.sqrt(1.0 / np.prod(s.shape[:-1])) if len(s.shape) == 4 \
            else 0.05
        return jnp.asarray(rng.normal(0, scale, s.shape).astype(np.float32))

    return jax.tree_util.tree_map(draw, shapes)


def _heads(with_angle, seed=0, x=None, in_channels=1):
    ref = jd.CenterNetHead(widths=SMALL, with_angle=with_angle)
    port = td.CenterNetHead(widths=SMALL, with_angle=with_angle,
                            in_channels=in_channels)
    x = np.zeros((1, 32, 32, in_channels), np.float32) if x is None else x
    params = _params(ref, x, seed)
    port.load_state_dict(convert.centernet_state_dict(params, port))
    return ref, port, params


@pytest.mark.parametrize("with_angle,c", [(False, 1), (True, 1), (False, 3)])
def test_head_forward_matches_reference(rng, with_angle, c):
    x = rng.uniform(0, 1, (2, 40, 36, c)).astype(np.float32)
    ref, port, params = _heads(with_angle, 1, x, c)
    want = ref.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == (4 if with_angle else 3)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[1:3] == (10, 9)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)


def test_head_init_and_state_dict_errors():
    """The port's draw: the heat bias at -2.19, the other biases 0; a
    tree of another head raises."""
    head = td.CenterNetHead(widths=SMALL, with_angle=True,
                            generator=torch.Generator().manual_seed(3))
    assert torch.all(head.heat.bias == np.float32(-2.19))
    assert float(head.size.bias.detach().abs().max()) == 0.0
    params = _params(jd.CenterNetHead(widths=SMALL),
                     np.zeros((1, 16, 16, 1), np.float32), 0)
    with pytest.raises(KeyError):   # no angle head in the tree
        convert.centernet_state_dict(params, head)
    with pytest.raises(ValueError, match="shape"):
        convert.centernet_state_dict(params, td.CenterNetHead(widths=(8, 16, 64)))
    with pytest.raises(ValueError):
        td.OBBDetectorTrainer(model=td.CenterNetHead(), device="cpu")


def test_gaussian_heatmap_and_focal_match_reference(rng):
    centers = rng.uniform(0, 24, (2, 5, 2)).astype(np.float32)
    centers[0, 0] = [7.5, 8.5]   # a half-way center: round half to even
    valid = rng.uniform(0, 1, (2, 5)) > 0.3
    sigma = rng.uniform(0.8, 3, (2, 5)).astype(np.float32)
    want = jax.vmap(lambda c, v, s: jd.gaussian_heatmap(c, v, (24, 28), s))(
        jnp.asarray(centers), jnp.asarray(valid), jnp.asarray(sigma))
    got = td.gaussian_heatmap(torch.from_numpy(centers),
                              torch.from_numpy(valid), (24, 28),
                              torch.from_numpy(sigma))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    logits = rng.normal(0, 2, (2, 24, 28)).astype(np.float32)
    ref, ref_g = jax.value_and_grad(jd.focal_loss)(jnp.asarray(logits), want)
    lg = torch.tensor(logits, requires_grad=True)
    loss = td.focal_loss(lg, got)
    (g,) = torch.autograd.grad(loss, lg)
    assert abs(float(loss.detach()) - float(ref)) <= 1e-6 * max(1, abs(float(ref)))
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), atol=TOL, rtol=0)


def test_gaussian_heatmap_and_focal():
    """``test_detector.py``'s case at the port's surface."""
    heat = td.gaussian_heatmap(torch.tensor([[8.0, 8.0], [20.0, 25.0]]),
                               torch.tensor([True, False]), (32, 32),
                               torch.tensor([2.0, 2.0]))
    assert abs(float(heat[8, 8]) - 1.0) < 1e-5
    assert float(heat[20, 25]) < 1e-3
    logits = torch.where(heat >= 0.999, 10.0, -10.0)
    assert float(td.focal_loss(logits, heat)) < 0.01


def _assert_params(params, net, steps, lr):
    want = convert.centernet_state_dict(params, net)
    close = total = 0
    for k, v in net.state_dict().items():
        d = np.abs(v.numpy() - want[k].numpy())
        assert d.max() <= 2 * lr * steps + TOL, (k, float(d.max()))
        close += int((d <= TOL).sum())
        total += d.size
    assert close >= 0.999 * total, (total - close, total)


def _assert_metrics(pm, rm, tol=TOL):
    assert set(pm) == set(rm)
    for k in rm:
        assert abs(float(pm[k]) - float(rm[k])) <= tol, (
            k, float(pm[k]), float(rm[k]))


def _trainers(obb):
    cfg = dict(lr=1e-3)
    if obb:
        ref = jd.OBBDetectorTrainer(jd.DetectorTrainConfig(**cfg),
                                    jd.CenterNetHead(SMALL, with_angle=True))
        port = td.OBBDetectorTrainer(
            td.DetectorTrainConfig(**cfg),
            td.CenterNetHead(SMALL, with_angle=True), device="cpu")
    else:
        ref = jd.DetectorTrainer(jd.DetectorTrainConfig(**cfg),
                                 jd.CenterNetHead(SMALL))
        port = td.DetectorTrainer(td.DetectorTrainConfig(**cfg),
                                  td.CenterNetHead(SMALL), device="cpu")
    return ref, port


def _batch(obb, key, batch=2, size=48):
    if obb:
        out = jd.synthesize_obb_batch(jax.random.PRNGKey(key), batch, size,
                                      hard=True)
    else:
        out = jd.synthesize_detection_batch(jax.random.PRNGKey(key), batch,
                                            size)
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("obb", [False, True])
@pytest.mark.parametrize("steps", [1, 3])
def test_trainer_steps_match_reference(obb, steps):
    ref, port = _trainers(obb)
    x = _batch(obb, 0)[0]
    params = _params(ref.model, x, 4)
    opt = ref.tx.init(params)
    net, popt = convert.detector_state_from_reference(params, opt, port)
    for i in range(steps):
        imgs, tgt, valid = _batch(obb, 10 + i)
        params, opt, rm = ref.train_step(params, opt, jnp.asarray(imgs),
                                         jnp.asarray(tgt), jnp.asarray(valid))
        net, popt, pm = port.train_step(net, popt, imgs, tgt, valid)
        _assert_metrics(pm, rm, TOL + 2 * 1e-3 * i)
    _assert_params(params, net, steps, 1e-3)


def test_resume_from_reference_state():
    """The reference trains two OBB steps; its parameters and Adam moments
    resume in the port and both take one more step."""
    ref, port = _trainers(True)
    params = _params(ref.model, _batch(True, 0)[0], 6)
    opt = ref.tx.init(params)
    for i in range(2):
        params, opt, _ = ref.train_step(params, opt,
                                        *map(jnp.asarray, _batch(True, 20 + i)))
    net, popt = convert.detector_state_from_reference(params, opt, port)
    assert {float(s["step"]) for s in popt.state.values()} == {2.0}
    _assert_params(params, net, 0, 1e-3)
    imgs, tgt, valid = _batch(True, 30)
    params, opt, rm = ref.train_step(params, opt, jnp.asarray(imgs),
                                     jnp.asarray(tgt), jnp.asarray(valid))
    net, popt, pm = port.train_step(net, popt, imgs, tgt, valid)
    _assert_metrics(pm, rm)   # the same parameters in: the first step's bound
    _assert_params(params, net, 1, 1e-3)


@pytest.mark.parametrize("obb", [False, True])
def test_decode_matches_reference(obb, rng):
    """Peaks, the stable top-k and the box decode, on the same head. A
    high threshold leaves most of the ``max_boxes`` at score 0: their
    indices are the lowest ones, as ``lax.top_k`` gives them."""
    ref, port, params = _heads(obb, 8, np.zeros((1, 64, 64, 1), np.float32))
    imgs = _batch(obb, 3, batch=3, size=64)[0]
    if obb:
        rt, pt = jd.OBBDetectorTrainer(model=ref), td.OBBDetectorTrainer(
            model=port, device="cpu")
    else:
        rt, pt = jd.DetectorTrainer(model=ref), td.DetectorTrainer(
            model=port, device="cpu")
    score = 5 if obb else 4
    thresh = 0.0
    for _ in range(2):
        if obb:
            want = rt.make_obb_detector(params, 12, thresh)(jnp.asarray(imgs))
            got = pt.make_obb_detector(port, 12, thresh)(imgs)
        else:
            want = rt.make_tile_detector(params, 12, thresh)(
                jnp.asarray(imgs[..., 0]))
            got = pt.make_tile_detector(port, 12, thresh)(imgs[..., 0])
        want = np.asarray(want)
        assert got.shape == want.shape == (3, 12, 6)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
        # then a threshold between the 4th and 5th peaks of the first tile
        thresh = float(want[0, 3:5, score].mean())
    assert (want[..., score] == 0).any()


@pytest.mark.parametrize("hard", [False, True])
def test_render_obb_batch_matches_reference(hard):
    key = jax.random.PRNGKey(5)
    want = jd.synthesize_obb_batch(key, 3, 64, hard=hard)
    got = td.render_obb_batch(64, obb_draws(key, 3, 64, hard=hard), hard)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_render_detection_batch_matches_reference():
    key = jax.random.PRNGKey(6)
    want = jd.synthesize_detection_batch(key, 3, 48)
    r = jax.random
    kb, kn, kc, ks = r.split(key, 4)
    draws = [0.1 * r.uniform(kn, (3, 48, 48, 1)),
             r.randint(kb, (3,), 1, 7),
             r.uniform(kc, (3, 6), minval=0.15, maxval=0.85) * 48,
             r.uniform(r.fold_in(kc, 1), (3, 6), minval=0.15,
                       maxval=0.85) * 48,
             r.uniform(ks, (3, 6, 2), minval=8.0, maxval=24.0)]
    got = td.render_detection_batch(
        48, *(torch.from_numpy(np.array(a)) for a in draws))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_synthesize_batch_shapes():
    """``test_detector.py``'s case with the port's draws; one generator
    seed gives one batch."""
    imgs, boxes, valid = td.synthesize_detection_batch(
        torch.Generator().manual_seed(0), batch=4, size=96, device="cpu")
    assert imgs.shape == (4, 96, 96, 1)
    assert boxes.shape == (4, 6, 4) and valid.shape == (4, 6)
    assert bool(valid.any())
    a = td.synthesize_obb_batch(torch.Generator().manual_seed(2), 3, 64,
                                hard=True, device="cpu")
    b = td.synthesize_obb_batch(torch.Generator().manual_seed(2), 3, 64,
                                hard=True, device="cpu")
    assert a[0].shape == (3, 64, 64, 1) and a[1].shape == (3, 5, 5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert float(a[0].min()) >= 0 and float(a[0].max()) <= 1


def test_tile_detector_drives_object_detector():
    """The trained-detector adapter feeds the port's sliced driver: fixed
    (N, K, 6) tiles, boxes in the scene's frame."""
    trainer = td.DetectorTrainer(model=td.CenterNetHead(SMALL), device="cpu")
    net, _ = trainer.init(None, torch.Generator().manual_seed(1))
    det_fn = trainer.make_tile_detector(net, max_boxes=8, score_thresh=0.0)
    out = det_fn(torch.zeros((2, 64, 64)))
    assert out.shape == (2, 8, 6)
    scene = np.random.default_rng(0).uniform(0, 1, (160, 200)).astype(np.float32)
    det = ObjectDetector(detector=det_fn, tile=64, score_thresh=0.05,
                         device="cpu").detect(scene)
    assert len(det.boxes) == len(det.scores) == len(det.classes) > 0
    assert np.isfinite(det.boxes).all()


def test_rotated_iou_known_values():
    """``test_detector.py``'s values, each bit-equal to the reference's."""
    a = np.array([10.0, 10.0, 4.0, 8.0, 0.0])
    b = a.copy()
    b[4] = np.pi
    c = np.array([10.0, 14.0, 4.0, 8.0, 0.0])
    d = np.array([40.0, 40.0, 4.0, 8.0, 0.3])
    sq = np.array([0.0, 0.0, 2.0, 2.0, 0.0])
    sq45 = np.array([0.0, 0.0, 2.0, 2.0, np.pi / 4])
    assert abs(tev.rotated_iou(a, a) - 1.0) < 1e-6
    assert abs(tev.rotated_iou(a, b) - 1.0) < 1e-5
    assert abs(tev.rotated_iou(a, c) - 16.0 / 48.0) < 1e-6
    assert tev.rotated_iou(a, d) == 0.0
    assert abs(tev.rotated_iou(sq, sq45) - 1 / np.sqrt(2)) < 1e-3
    for p, q in ((a, a), (a, b), (a, c), (a, d), (sq, sq45)):
        assert tev.rotated_iou(p, q) == jev.rotated_iou(p, q)
    obbs = np.random.default_rng(1).uniform(1, 9, (6, 5))
    np.testing.assert_array_equal(tev.obb_corners(obbs), jev.obb_corners(obbs))


def test_map50_matches_reference():
    gt = [np.array([[10.0, 10.0, 6.0, 12.0, 0.3]])]
    hit = [np.array([[10.0, 10.0, 6.0, 12.0, 0.3, 0.9]])]
    ap, stats = tev.map50(hit, gt)
    assert ap == 1.0 and stats["n_gt"] == 1
    miss = [np.array([[40.0, 40.0, 6.0, 12.0, 0.3, 0.9]])]
    assert tev.map50(miss, gt)[0] == 0.0
    rng = np.random.default_rng(2)
    dets, gts = [], []
    for _ in range(6):
        g = np.column_stack([rng.uniform(10, 90, (4, 2)),
                             rng.uniform(8, 20, (4, 2)),
                             rng.uniform(-1.5, 1.5, 4)])
        d = np.column_stack([g + rng.normal(0, [2, 2, 2, 2, 0.2], g.shape),
                             rng.uniform(0, 1, 4)])
        dets.append(np.vstack([d, [[50, 50, 10, 10, 0, 0.3]]]))
        gts.append(g)
    for args in ((dets, gts), (dets, gts, 0.7), ([], [])):
        got, want = tev.map50(*args), jev.map50(*args)
        assert got[0] == want[0] or (np.isnan(got[0]) and np.isnan(want[0]))
        assert got[1] == want[1]
    r = np.array([0.1, 0.4, 0.4, 0.8])
    p = np.array([1.0, 0.7, 0.9, 0.5])
    assert tev.average_precision(r, p) == jev.average_precision(r, p)


@pytest.mark.slow
def test_detector_trains_and_detects():
    """``test_detector.py``'s slow case with the port's draws: 150 steps,
    then the trained tile detector inside the sliced-inference driver."""
    trainer = td.DetectorTrainer(td.DetectorTrainConfig(lr=2e-3),
                                 model=td.CenterNetHead(SMALL), device="cpu")
    batch = td.synthesize_detection_batch(torch.Generator().manual_seed(0),
                                          8, 128, device="cpu")
    net, opt = trainer.init(batch[0], torch.Generator().manual_seed(1))
    losses = []
    for i in range(150):
        if i % 10 == 0:
            batch = td.synthesize_detection_batch(
                torch.Generator().manual_seed(i), 8, 128, device="cpu")
        net, opt, m = trainer.train_step(net, opt, *batch)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < 0.5 * np.mean(losses[:10])
    det_fn = trainer.make_tile_detector(net, score_thresh=0.2)
    driver = ObjectDetector(detector=det_fn, tile=128, score_thresh=0.2,
                            device="cpu")
    timgs, tboxes, tvalid = td.synthesize_detection_batch(
        torch.Generator().manual_seed(99), 1, 128, device="cpu")
    det = driver.detect(timgs[0, :, :, 0].numpy())
    gt = tboxes[0][tvalid[0]].numpy()
    assert len(det.boxes) >= 1
    gt_c = (gt[:, :2] + gt[:, 2:]) / 2
    got_c = (det.boxes[:, :2] + det.boxes[:, 2:]) / 2
    d = np.abs(gt_c[:, None] - got_c[None]).sum(-1).min(1)
    assert (d < 12).mean() >= 0.65
