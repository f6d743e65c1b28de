"""The port's OBIA land-use classification (``pcmi_tpu_torch.pipelines.
landuse``) against ``pcmi_tpu.pipelines.landuse`` on the CPU.

Inputs are numpy draws from a seed fed to both packages; K-means is fed
the reference's first centre (its Gumbel draw from ``PRNGKey(seed)``)
through ``_obia_core(..., first=...)``. Tolerances: LAB within 1e-4,
features within 1e-4 (relative 1e-5); SLIC labels, superpixels, classes
and boundaries identical; SLIC centres within relative 2e-6 (the port
sums each segment in float64, the reference in float32); PCA colours
within 1e-5, with the reference's eigenvector signs (LAPACK's ``ssyevd``
on both sides). The reference's cases
(``tests/test_components2.py``) are mirrored at the port's surface.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pcmi_tpu.pipelines import landuse as jl
from pcmi_tpu_torch.pipelines import landuse as tl

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _texture(rng, h, w):
    t = rng.uniform(0, 1, (h, w)).astype(np.float32)
    for _ in range(2):
        t = 0.5 * t + 0.25 * np.roll(t, 1, 0) + 0.25 * np.roll(t, 1, 1)
    return t


def _rgb(rng, h=64, w=72):
    """Three smooth regions of different colour and texture."""
    img = np.stack([_texture(rng, h, w) for _ in range(3)], -1) * 0.3
    img[: h // 2, : w // 2] += [0.5, 0.2, 0.1]
    img[h // 2:, :] += [0.1, 0.4, 0.3]
    img[: h // 2, w // 2:] += [0.2, 0.2, 0.6]
    return np.clip(img, 0, 1).astype(np.float32)


def _agree(a, b):
    frac = float((np.asarray(a) == np.asarray(b)).mean())
    assert frac == 1.0, f"labels agree on {frac:.6f} of the pixels"
    return frac


def test_rgb_to_lab(rng):
    rgb = rng.uniform(-0.1, 1.1, (32, 24, 3)).astype(np.float32)
    rgb[0, :3] = [[1, 1, 1], [0, 0, 0], [0.02, 0.03, 0.01]]
    ref = np.asarray(jl.rgb_to_lab(jnp.asarray(rgb)))
    got = tl.rgb_to_lab(_t(rgb)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_rgb_to_lab_known_values():
    lab = tl.rgb_to_lab(torch.tensor([[[1.0, 1.0, 1.0]],
                                      [[0.0, 0.0, 0.0]]])).numpy()
    np.testing.assert_allclose(lab[0, 0], [100.0, 0.0, 0.0], atol=0.1)
    np.testing.assert_allclose(lab[1, 0], [0.0, 0.0, 0.0], atol=0.1)


@pytest.mark.parametrize("rgb", [False, True])
def test_slic(rng, rgb):
    img = _rgb(rng) if rgb else _texture(rng, 64, 72)
    kw = dict(n_segments=48, iters=6, chunk=1000)
    ref = jl.slic(jnp.asarray(img), **kw)
    got = tl.slic(_t(img), **kw)
    assert got.n_segments == ref.n_segments
    _agree(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(ref.centers),
                               atol=0, rtol=2e-6)
    # the chunk size changes nothing
    np.testing.assert_array_equal(
        tl.slic(_t(img), n_segments=48, iters=6).labels.numpy(),
        got.labels.numpy())


def test_slic_segments_are_compact_and_cover(rng):
    img = _texture(rng, 96, 96)
    labels = tl.slic(_t(img), n_segments=64, iters=6).labels.numpy()
    assert labels.min() >= 0 and labels.max() < 64
    assert len(np.unique(labels)) > 32
    sizes = np.bincount(labels.reshape(-1), minlength=64)
    assert sizes[sizes > 0].mean() > 40


@pytest.mark.parametrize("rgb", [False, True])
def test_obia_features(rng, rgb):
    img = _rgb(rng, 48, 40) if rgb else _texture(rng, 48, 40)
    ref = np.asarray(jl.obia_features(jnp.asarray(img)))
    got = tl.obia_features(_t(img)).numpy()
    assert got.shape == ref.shape == (48, 40, 20)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


def _reference_first(n_segments, present, seed=0):
    w = jnp.asarray(present, jnp.float32)
    logw = jnp.where(w > 0, jnp.log(jnp.maximum(w, 1e-12)), -jnp.inf)
    return int(jnp.argmax(logw + jax.random.gumbel(
        jax.random.PRNGKey(seed), (n_segments,))))


def _pca_close(got, ref):
    """Every channel within 1e-5, no eigenvector flipped."""
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("rgb", [False, True])
def test_obia_core_with_reference_first(rng, rgb):
    img = _rgb(rng) if rgb else _texture(rng, 64, 72)
    n_seg, k = 40, 3
    ref = jl._obia_core(jnp.asarray(img), n_seg, k, jax.random.PRNGKey(0))
    sp = np.asarray(ref.superpixels)
    present = np.bincount(sp.reshape(-1), minlength=n_seg) > 0
    first = _reference_first(n_seg, present)
    got = tl._obia_core(_t(img), n_seg, k, first=torch.tensor(first))
    _agree(got.superpixels.numpy(), sp)
    _agree(got.classes.numpy(), np.asarray(ref.classes))
    _agree(got.boundaries.numpy(), np.asarray(ref.boundaries))
    _pca_close(got.pca_rgb.numpy(), np.asarray(ref.pca_rgb))


def test_obia_classes_separate_regions(rng):
    """``test_components2.py``'s two-texture case with the port's draw."""
    img = np.zeros((96, 96), np.float32)
    img[:, :48] = 0.3
    img[:, 48:] = rng.uniform(0, 1, (96, 48))
    res = tl.OBIAClassifier(n_segments=64, k=2,
                            device="cpu").run_obia_pipeline(img)
    classes = res.classes.numpy()
    left_mode = np.bincount(classes[:, :40].reshape(-1)).argmax()
    right_mode = np.bincount(classes[:, 56:].reshape(-1)).argmax()
    assert left_mode != right_mode
    assert (classes[:, :40] == left_mode).mean() > 0.8
    assert (classes[:, 56:] == right_mode).mean() > 0.65


def test_obia_seed_draw(rng):
    """``seed`` picks the K-means start from a CPU generator: the same seed
    gives the same classes; the start is a present segment."""
    img = _rgb(rng, 48, 48)
    a = tl.OBIAClassifier(36, 3, seed=5, device="cpu").run_obia_pipeline(img)
    b = tl._obia_core(_t(img), 36, 3, torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(a.classes.numpy(), b.classes.numpy())
    c = tl.OBIAClassifier(36, 3, seed=5,
                          device="cpu").run_obia_pipeline(_t(img))
    np.testing.assert_array_equal(a.classes.numpy(), c.classes.numpy())


def test_landuse_plugin_layers(rng):
    """Layers of the plugin against the reference's (0-255 input), with
    the reference's K-means start fed to the port's classifier."""
    img = (_rgb(rng, 48, 56) * 255).astype(np.float32)
    ref = jl.LandUseClassificationPlugin(
        jl.OBIAClassifier(n_segments=30, k=3)).run(img)
    got = tl.LandUseClassificationPlugin(
        tl.OBIAClassifier(n_segments=30, k=3, device="cpu")).run(img)
    assert [(p, k) for _, p, k in got] == [(p, k) for _, p, k in ref]
    assert [a.dtype for a, _, _ in got] == [np.asarray(a).dtype
                                           for a, _, _ in ref]
    _agree(got[1][0], np.asarray(ref[1][0]))
    assert got[2][0].shape == (48, 56, 3) and got[3][0].shape == (48, 56)
    assert tl.LandUseClassificationPlugin(
        device="cpu").classifier.device == torch.device("cpu")
