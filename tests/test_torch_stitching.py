"""The port's stitching (``pcmi_tpu_torch.pipelines.stitching``) against
``pcmi_tpu.pipelines.stitching`` on the CPU.

Inputs are numpy draws from a seed fed to both packages; RANSAC is fed
the reference's own 4-point subsets (its ``jax.random.choice`` draws)
through ``_ransac_from``. Tolerances: phase-correlation shifts, corner
positions, patches, spatial-filter weights, seams and inlier masks
bit-exact; NCC scores and Harris responses within 1e-5 (relative for the
responses); homographies within 1e-4 (relative, and absolute for entries
near 0); mosaics within 1e-4. The reference's cases
(``tests/test_components2.py``, ``run stitching --input2`` of
``tests/test_cli.py`` and the ``image2`` introspection of
``tests/test_viewer_host.py``) are mirrored at the port's surface.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pcmi_tpu.ops.warp import map_coordinates as jmap
from pcmi_tpu.pipelines import stitching as js
from pcmi_tpu_torch import cli, registry
from pcmi_tpu_torch.io.raster import read_tiff, write_tiff
from pcmi_tpu_torch.pipelines import stitching as ts
from pcmi_tpu_torch.viewer import PluginRunner

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _texture(rng, h, w):
    t = rng.uniform(0, 1, (h, w)).astype(np.float32)
    for _ in range(2):
        t = 0.5 * t + 0.25 * np.roll(t, 1, 0) + 0.25 * np.roll(t, 1, 1)
    return t


def _H_close(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shift", [(7, -11), (-20, 33), (0, 0)])
def test_phase_correlation(rng, shift):
    img = _texture(rng, 128, 96)
    shifted = np.roll(np.roll(img, shift[0], 0), shift[1], 1)
    ref = js.phase_correlation(jnp.asarray(img), jnp.asarray(shifted))
    got = ts.phase_correlation(_t(img), _t(shifted))
    assert [float(v) for v in got] == [float(v) for v in ref]
    assert int(got[0]) == -shift[0] and int(got[1]) == -shift[1]


def test_harris_corners_bit_exact(rng):
    img = _texture(rng, 96, 120)
    pr, vr = js.harris_corners(jnp.asarray(img), n_corners=64)
    pg, vg = ts.harris_corners(_t(img), n_corners=64)
    np.testing.assert_array_equal(pg.numpy(), np.asarray(pr))
    np.testing.assert_allclose(vg.numpy(), np.asarray(vr), rtol=1e-5, atol=0)


def test_harris_corners_on_checkerboard():
    """The reference's checkerboard (responses tie exactly there): the
    same corners in the same order, and on the grid."""
    ii, jj = np.indices((96, 96))
    img = ((ii // 16 + jj // 16) % 2).astype(np.float32)
    pts, _ = ts.harris_corners(_t(img), n_corners=32)
    pts = pts.numpy()
    ref, _ = js.harris_corners(jnp.asarray(img), n_corners=32)
    np.testing.assert_array_equal(pts, np.asarray(ref))

    def near(v):
        m = v % 16
        return np.minimum(m, 16 - m) <= 3

    assert (near(pts[:, 0]) & near(pts[:, 1])).mean() > 0.8


def test_extract_patches(rng):
    img = rng.uniform(0, 1, (30, 40)).astype(np.float32)
    pts = np.array([[0, 0], [29, 39], [15, 3], [2, 37]], np.int32)
    ref = np.asarray(js._extract_patches(jnp.asarray(img), jnp.asarray(pts),
                                         7))
    got = ts._extract_patches(_t(img), _t(pts), 7).numpy()
    np.testing.assert_array_equal(got, ref)


def test_ncc_match(rng):
    """Matches of shifted texture: the same positions and scores within
    1e-5 (the grouped convolution sums in another order)."""
    base = _texture(rng, 140, 180)
    img1 = base[:120, :150]
    img2 = base[9:129, 23:173] + 0.01 * rng.normal(
        size=(120, 150)).astype(np.float32)
    pts1, _ = js.harris_corners(jnp.asarray(img1), 48)
    prior = (jnp.float32(-8.6), jnp.float32(-22.4))
    p_ref, s_ref = js.ncc_match(jnp.asarray(img1), jnp.asarray(img2), pts1,
                                *prior, patch=11, search=12)
    p_got, s_got = ts.ncc_match(_t(img1), _t(img2), _t(np.asarray(pts1)),
                                torch.tensor(-8.6), torch.tensor(-22.4),
                                patch=11, search=12)
    np.testing.assert_array_equal(p_got.numpy(), np.asarray(p_ref))
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_ref), atol=1e-5,
                               rtol=0)


def test_spatial_consistency_filter_bit_exact(rng):
    n = 120
    p1 = rng.uniform(0, 300, (n, 2)).astype(np.float32)
    p2 = p1 + np.float32([4.0, -9.0])
    out = rng.uniform(size=n) < 0.3
    p2[out] += rng.uniform(-40, 40, (out.sum(), 2)).astype(np.float32)
    w = rng.uniform(0, 1, n).astype(np.float32) * (rng.uniform(size=n) > 0.1)
    ref = np.asarray(js.spatial_consistency_filter(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w)))
    got = ts.spatial_consistency_filter(_t(p1), _t(p2), _t(w)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_spatial_consistency_filter_kills_lattice_outliers(rng):
    n = 240
    p1 = rng.uniform(0, 420, (n, 2)).astype(np.float32)
    p2 = p1 + np.float32([7.0, -12.0])
    out = rng.uniform(size=n) < 0.3
    axis = rng.integers(0, 2, size=n)
    sign = rng.choice([-1.0, 1.0], size=n)
    shift = np.zeros((n, 2), np.float32)
    shift[np.arange(n), axis] = 40.0 * sign
    shift[~out] = 0.0
    kept = ts.spatial_consistency_filter(
        _t(p1), _t(p2 + shift), torch.ones(n)).numpy() > 0
    assert kept[~out].mean() > 0.95
    assert kept[out].mean() < 0.1


def _correspondences(rng, n=64, outliers=True):
    pts1 = rng.uniform(20, 200, (n, 2)).astype(np.float32)
    H_true = np.array([[1.02, 0.03, 5.0], [-0.02, 0.99, -3.0],
                       [1e-5, -1e-5, 1.0]], np.float32)
    pts2 = np.array(js._project(jnp.asarray(H_true), jnp.asarray(pts1)))
    pts2 = pts2 + rng.normal(0, 0.3, pts2.shape).astype(np.float32)
    k = n // 5 if outliers else 0
    pts2[:k] += rng.uniform(40, 80, (k, 2)).astype(np.float32)
    return pts1, pts2, k


@pytest.mark.parametrize("weighted", [False, True])
def test_norm_transform_and_dlt(rng, weighted):
    pts1, pts2, _ = _correspondences(rng, 16, outliers=False)
    w = rng.uniform(0.2, 1, 16).astype(np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else _t(w)
    T_r, mu_r, s_r = js._norm_transform(jnp.asarray(pts1), jw)
    T_g, mu_g, s_g = ts._norm_transform(_t(pts1), tw)
    np.testing.assert_allclose(T_g.numpy(), np.asarray(T_r), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(mu_g.numpy(), np.asarray(mu_r), rtol=1e-6)
    np.testing.assert_allclose(
        ts._apply_norm(_t(pts1), mu_g, s_g).numpy(),
        np.asarray(js._apply_norm(jnp.asarray(pts1), mu_r, s_r)),
        atol=1e-5, rtol=0)
    H_r = jax.jit(js._dlt)(jnp.asarray(pts1), jnp.asarray(pts2), jw)
    H_g = ts._dlt(_t(pts1), _t(pts2), tw)
    _H_close(H_g.numpy(), H_r)
    np.testing.assert_allclose(
        ts._project(H_g, _t(pts1)).numpy(),
        np.asarray(js._project(H_r, jnp.asarray(pts1))), atol=1e-3, rtol=0)
    # a batch of 4-point DLTs from one batched SVD equals the DLTs one by
    # one; against the reference, well-spread subsets (one point per
    # quadrant): a near-collinear 4-point subset amplifies float32
    # rounding past 1e-4 in both packages alike
    idx = np.array([rng.permutation(16)[:4] for _ in range(5)])
    Hb = ts._dlt(_t(pts1[idx]), _t(pts2[idx])).numpy()
    for b in range(5):
        np.testing.assert_allclose(
            Hb[b], ts._dlt(_t(pts1[idx[b]]), _t(pts2[idx[b]])).numpy(),
            rtol=1e-5, atol=1e-5)
    halves = np.argsort(pts1[:, 0]).reshape(2, 8)
    quads = [h[np.argsort(pts1[h, 1])].reshape(2, 4) for h in halves]
    for b in range(3):
        sub = [q[b] for half in quads for q in half]
        _H_close(ts._dlt(_t(pts1[sub]), _t(pts2[sub])).numpy(),
                 jax.jit(js._dlt)(jnp.asarray(pts1[sub]),
                                  jnp.asarray(pts2[sub])))


def _reference_draw(w, key, n_hyp=256):
    """The reference's (n_hyp, 4) subsets, drawn as ``ransac_homography``
    draws them."""
    n = len(w)
    p = (jnp.asarray(w) + 1e-9) / jnp.sum(jnp.asarray(w) + 1e-9)
    return np.asarray(jax.vmap(
        lambda k: jax.random.choice(k, n, shape=(4,), replace=False, p=p))(
            jax.random.split(key, n_hyp)))


@pytest.mark.parametrize("thresh", [5.0, 1.0])
def test_ransac_from_reference_draws(rng, thresh):
    pts1, pts2, k = _correspondences(rng)
    w = np.ones(len(pts1), np.float32)
    w[5] = 0.0
    key = jax.random.PRNGKey(0)
    H_r, inl_r = js.ransac_homography(jnp.asarray(pts1), jnp.asarray(pts2),
                                      jnp.asarray(w), key, thresh=thresh)
    idx = _reference_draw(w, key)
    H_g, inl_g = ts._ransac_from(_t(pts1), _t(pts2), _t(w), _t(idx), thresh)
    np.testing.assert_array_equal(inl_g.numpy(), np.asarray(inl_r))
    _H_close(H_g.numpy(), H_r)


def test_ransac_recovers_known_homography(rng):
    """``test_components2.py``'s case with the port's own draw."""
    pts1, pts2, k = _correspondences(rng)
    Hm, inl = ts.ransac_homography(_t(pts1), _t(pts2), torch.ones(64))
    proj = ts._project(Hm, _t(pts1)).numpy()
    err = np.linalg.norm(proj[k:] - pts2[k:], axis=1)
    assert np.median(err) < 1.5
    assert int(inl.sum()) >= 0.6 * (64 - k)
    # the draw: 4 distinct indices per hypothesis, the same from the same
    # seed, and never a zero-weight point while others have weight
    w = torch.ones(64)
    w[:32] = 0.0
    d = ts._draw_subsets(w, 256, torch.Generator().manual_seed(3))
    assert all(len(set(r)) == 4 for r in d.tolist())
    assert (d >= 32).all()
    np.testing.assert_array_equal(
        d.numpy(), ts._draw_subsets(w, 256,
                                    torch.Generator().manual_seed(3)).numpy())


def test_affine_fit(rng):
    p1 = rng.uniform(0, 100, (30, 2)).astype(np.float32)
    A = np.array([[0.98, 0.05], [-0.04, 1.01]], np.float32)
    p2 = (p1 @ A.T + np.float32([3.0, -7.0])
          + rng.normal(0, 0.2, p1.shape).astype(np.float32))
    w = (rng.uniform(size=30) > 0.2).astype(np.float32)
    ref = js.affine_fit(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w))
    got = ts.affine_fit(_t(p1), _t(p2), _t(w))
    _H_close(got.numpy(), ref)


@pytest.mark.parametrize("kind", ["column", "random", "ties"])
def test_dp_seam_bit_exact(rng, kind):
    energy = {"column": np.ones((40, 30), np.float32),
              "random": rng.uniform(0, 1, (50, 37)).astype(np.float32),
              "ties": rng.integers(0, 3, (45, 33)).astype(np.float32)}[kind]
    if kind == "column":
        energy[:, 17] = 0.0
    ref = np.asarray(js.dp_seam(jnp.asarray(energy)))
    got = ts.dp_seam(_t(energy)).numpy()
    np.testing.assert_array_equal(got, ref)
    if kind == "column":
        assert (got == 17).mean() > 0.9


def _split(rng):
    """The reference's synthetic split: overlapping strips of one texture,
    the second rotated by 2 degrees and shifted."""
    base = _texture(rng, 160, 280)
    left = base[:, :170]
    ang = np.radians(2.0)
    c, s = np.cos(ang), np.sin(ang)
    A = np.array([[c, -s, 4.0], [s, c, -2.0], [0, 0, 1.0]], np.float32)
    ys, xs = np.meshgrid(np.arange(160), np.arange(160), indexing="ij")
    src_y = A[0, 0] * ys + A[0, 1] * xs + A[0, 2]
    src_x = A[1, 0] * ys + A[1, 1] * xs + A[1, 2]
    right = np.asarray(jmap(jnp.asarray(base[:, 120:]), jnp.asarray(src_y),
                            jnp.asarray(src_x)))
    return left, right


def test_stitch_recovers_synthetic_split(rng):
    """``test_components2.py``'s case at the port's surface, and the
    result against the reference's with the reference's draw: the same
    inlier count, canvas and seam; homography and mosaic within 1e-4."""
    left, right = _split(rng)
    st = ts.ImageStitcher(n_corners=128, search=16, device="cpu")
    res = st.stitch(left, right)
    assert int(res.n_inliers) > 20
    mosaic = res.mosaic.numpy()
    y0, x0 = res.canvas_offset
    region = mosaic[-y0:-y0 + 160, -x0:-x0 + 170]
    m = np.isfinite(region)
    assert np.median(np.abs(region[m] - left[m])) < 0.05
    assert mosaic.shape[1] > 170 + x0 * -1 - 5

    ref = js.ImageStitcher(n_corners=128, search=16).stitch(
        jnp.asarray(left), jnp.asarray(right))
    # the port's stitch fed the reference's subsets
    orig = ts._draw_subsets
    try:
        ts._draw_subsets = lambda w, n_hyp, g: _t(_reference_draw(
            w.numpy(), jax.random.PRNGKey(0), n_hyp))
        got = st.stitch(left, right)
    finally:
        ts._draw_subsets = orig
    assert int(got.n_inliers) == int(ref.n_inliers)
    assert got.canvas_offset == ref.canvas_offset
    assert got.mosaic.shape == ref.mosaic.shape
    _H_close(got.homography.numpy(), ref.homography)
    np.testing.assert_array_equal(got.seam.numpy(), np.asarray(ref.seam))
    a, b = got.mosaic.numpy(), np.asarray(ref.mosaic)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    np.testing.assert_allclose(a[np.isfinite(a)], b[np.isfinite(b)],
                               atol=1e-4, rtol=0)


def test_stitch_refuses_unrelated_images(rng):
    st = ts.ImageStitcher(n_corners=64, device="cpu")
    with pytest.raises(ValueError, match="consistent matches"):
        st.stitch(rng.uniform(0, 1, (96, 96)).astype(np.float32),
                  rng.uniform(0, 1, (96, 96)).astype(np.float32))


def test_stitch_on_repetitive_texture(rng):
    """``test_components2.py``'s periodic texture: the spatial filter
    raises the share of true-offset matches and RANSAC finds the
    x-translation, through the port."""
    h, w, period = 180, 300, 24
    ys, xs = np.meshgrid(np.arange(h), np.arange(w + 60), indexing="ij")
    base = (0.5 + 0.25 * np.sin(2 * np.pi * xs / period)
            + 0.25 * np.sin(2 * np.pi * ys / period)).astype(np.float32)
    base += 0.1 * _texture(rng, h, w + 60)
    true_dx = 20
    img1 = _t(base[:, :w] + 0.03 * rng.normal(size=(h, w)).astype(np.float32))
    img2 = _t(base[:, true_dx:true_dx + w]
              + 0.03 * rng.normal(size=(h, w)).astype(np.float32))
    pts1, _ = ts.harris_corners(img1, 192)
    zero = torch.zeros(())
    pts2, score = ts.ncc_match(img1, img2, pts1, zero, zero, patch=11,
                               search=56)
    wts = torch.where(score > 0.5, score, 0.0)
    w_f = ts.spatial_consistency_filter(pts1.float(), pts2.float(), wts)
    v = (pts2 - pts1).numpy().astype(np.float32)
    correct = np.abs(v[:, 1] - (-true_dx)) <= 2.0
    live0 = wts.numpy() > 0
    live1 = w_f.numpy() > 0
    rate0 = correct[live0].mean() if live0.any() else 0.0
    rate1 = correct[live1].mean() if live1.any() else 0.0
    assert live1.sum() >= 30
    assert rate1 > rate0 + 0.15, (rate0, rate1)
    assert rate1 > 0.9
    Hm, _ = ts.ransac_homography(pts1.float(), pts2.float(), w_f,
                                 thresh=3.0)
    Hn = Hm.numpy() / Hm.numpy()[2, 2]
    assert abs(Hn[0, 2] - (-true_dx)) < 2.0 or abs(Hn[1, 2] - (-true_dx)) < 2.0


def test_stitching_plugin(rng):
    """The plugin's layers, ``image2`` required."""
    left, right = _split(rng)
    plugin = ts.ImageStitchingPlugin(
        ts.ImageStitcher(n_corners=128, search=16, device="cpu"))
    layers = plugin.run(np.repeat(left[..., None], 3, -1), image2=right)
    assert [p["name"] for _, p, _ in layers] == ["image 1", "image 2",
                                                 "mosaic"]
    assert isinstance(layers[2][0], np.ndarray)
    with pytest.raises(ValueError, match="image2"):
        plugin.run(left)
    assert ts.ImageStitchingPlugin(device="cpu").stitcher.device == \
        torch.device("cpu")


def test_cli_stitching_two_inputs(tmp_path, rng, capsys):
    """``run stitching --input A --input2 B --device cpu`` writes the
    mosaic (on these thin strips the homography is loose in both
    packages, so only the product is checked, as the reference's test
    does)."""
    base = rng.uniform(0, 1, (96, 160)).astype(np.float32)
    for _ in range(2):
        base = 0.5 * base + 0.25 * np.roll(base, 1, 0) + 0.25 * np.roll(
            base, 1, 1)
    a = str(tmp_path / "a.tif")
    b = str(tmp_path / "b.tif")
    write_tiff(a, base[:, :100])
    write_tiff(b, base[:, 60:])
    out = str(tmp_path / "out")
    assert cli.main(["run", "stitching", "--input", a, "--input2", b,
                     "--output", out, "--device", "cpu"]) == 0
    mosaic = read_tiff(os.path.join(out, "mosaic.tif"))
    assert mosaic.ndim == 2 and np.isfinite(mosaic).any()


class _MockViewer:
    def __init__(self):
        self.layers = []

    def add_image(self, data, **params):
        self.layers.append(("image", np.asarray(data), params))


def test_stitching_introspection_and_run():
    """The host sees that the plugin wants ``image2`` and runs it
    (``tests/test_viewer_host.py``'s case)."""
    plugin = registry.create("stitching", device="cpu")
    runner = PluginRunner(plugin)
    assert runner.needs_image2()

    base = np.zeros((96, 128), np.float32)
    ys, xs = np.mgrid[0:96, 0:128]
    base += (np.sin(xs * 0.35) + np.cos(ys * 0.23) + 2.0) / 4.0
    base += np.random.default_rng(0).uniform(0, 0.3, base.shape).astype(
        np.float32)
    viewer = _MockViewer()
    runner.run(image=base[:, :88], image2=base[:, 40:],
               on_done=lambda ls: [viewer.add_image(d, **p)
                                   for d, p, _ in ls])
    assert runner.last_error is None
    assert [p["name"] for _, _, p in viewer.layers] == [
        "image 1", "image 2", "mosaic"]
