"""The port's spectral-residual saliency (``pcmi_tpu_torch.pipelines.
saliency``) against ``pcmi_tpu.pipelines.saliency`` on the CPU.

Inputs are numpy draws from a seed fed to both packages. Tolerances:
resize, FFT and filter outputs within 1e-5 (the two FFT libraries round
differently in the last bits); labels and boxes bit-exact on the same
mask. The reference's own cases (``tests/test_components.py``, and
``run saliency`` of ``tests/test_cli.py``) are mirrored at the port's
surface.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pcmi_tpu.cli import main as jmain
from pcmi_tpu.pipelines import saliency as js
from pcmi_tpu_torch import cli
from pcmi_tpu_torch.io.raster import read_tiff, write_tiff
from pcmi_tpu_torch.pipelines import saliency as ts

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _textured_scene(rng, h=256, w=256):
    """Low-frequency background + one small bright salient blob (the
    reference's ``tests/test_components.py`` scene)."""
    base = rng.normal(0, 0.02, (h // 16 + 2, w // 16 + 2))
    ys = np.linspace(0, base.shape[0] - 2, h)
    xs = np.linspace(0, base.shape[1] - 2, w)
    img = base[np.round(ys).astype(int)][:, np.round(xs).astype(int)]
    img = img - img.min() + 0.2
    img[120:136, 60:76] += 0.8  # salient object
    return img.astype(np.float32)


@pytest.mark.parametrize("shape,out", [((40, 56), (72, 72)),
                                       ((9, 13), (30, 7))])
def test_resize(rng, shape, out):
    img = rng.uniform(0, 1, shape).astype(np.float32)
    ref = np.asarray(js._resize(jnp.asarray(img), out))
    got = ts._resize(_t(img), out).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_spectral_residual_tile(rng):
    tile = rng.uniform(0, 1, (96, 96)).astype(np.float32)
    ref = np.asarray(js.spectral_residual_tile(jnp.asarray(tile)))
    got = ts.spectral_residual_tile(_t(tile)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    # a stack of tiles gives each tile's map
    stack = np.stack([tile, tile[::-1].copy()])
    both = ts.spectral_residual_tile(_t(stack)).numpy()
    np.testing.assert_array_equal(both[0], got)
    np.testing.assert_allclose(
        both[1], np.asarray(js.spectral_residual_tile(jnp.asarray(stack[1]))),
        atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape,tile,pad", [((150, 200), 64, 16),
                                            ((100, 70), 128, 32)])
def test_spectral_residual_map(rng, shape, tile, pad):
    """Ragged tilings, and pads longer than the image (reflected again)."""
    img = rng.uniform(0, 1, shape).astype(np.float32)
    ref = np.asarray(js.spectral_residual_map(jnp.asarray(img), tile=tile,
                                              pad=pad))
    got = ts.spectral_residual_map(_t(img), tile=tile, pad=pad).numpy()
    assert got.shape == ref.shape == shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_saliency_highlights_object(rng):
    """``test_components.py``'s bound, at the port's surface."""
    img = _textured_scene(rng)
    sal = ts.spectral_residual_map(_t(img), tile=256, pad=32).numpy()
    assert sal.shape == img.shape
    inside = sal[118:138, 58:78].mean()
    outside = np.delete(sal.reshape(-1), 0).mean()
    assert inside > 3 * outside


@pytest.mark.parametrize("max_iters", [128, 5, 16])
def test_label_components_bit_exact(rng, max_iters):
    """Random masks, propagation cut at ``max_iters`` or run to its
    fixpoint: the labels equal the reference's bit for bit."""
    mask = rng.uniform(0, 1, (48, 64)) > 0.45
    ref = np.asarray(js.label_components(jnp.asarray(mask), max_iters))
    got = ts.label_components(_t(mask), max_iters).numpy()
    np.testing.assert_array_equal(got, ref)
    # a stack labels each plane on its own
    stack = ts.label_components(_t(np.stack([mask, ~mask])), max_iters)
    np.testing.assert_array_equal(stack[0].numpy(), ref)
    np.testing.assert_array_equal(
        stack[1].numpy(),
        np.asarray(js.label_components(jnp.asarray(~mask), max_iters)))


def test_label_components_and_boxes():
    mask = np.zeros((64, 64), bool)
    mask[5:15, 5:15] = True
    mask[40:44, 50:60] = True
    labels = ts.label_components(_t(mask)).numpy()
    ids = np.unique(labels[labels >= 0])
    assert len(ids) == 2
    boxes = ts.extract_boxes(labels, min_size=10)
    assert sorted(boxes) == [(5, 5, 15, 15), (40, 50, 44, 60)]


@pytest.mark.parametrize("min_size", [1, 20, 60])
def test_extract_boxes_bit_exact(rng, min_size):
    mask = rng.uniform(0, 1, (40, 40)) > 0.6
    labels = np.asarray(js.label_components(jnp.asarray(mask)))
    assert ts.extract_boxes(labels, min_size) == js.extract_boxes(
        labels, min_size)
    assert ts.extract_boxes(_t(labels), min_size) == js.extract_boxes(
        labels, min_size)
    assert ts.extract_boxes(np.full((4, 4), -1)) == []


def test_saliency_plugin_layers(rng):
    """The reference's plugin case at the port's surface, and the port's
    layers against the reference's: saliency within 1e-5, the same
    rectangles."""
    img = _textured_scene(rng)
    layers = ts.SaliencyDetector(tile=256, pad=32, device="cpu").run(img)
    kinds = [k for _, _, k in layers]
    assert kinds[0] == "image" and kinds[1] == "image"
    assert "shapes" in kinds  # the blob must be detected
    rects = layers[-1][0]
    centers = rects.mean(axis=1)
    assert any(abs(cy - 128) < 16 and abs(cx - 68) < 16 for cy, cx in centers)

    ref = js.SaliencyDetector(tile=256, pad=32).run(img)
    assert [(p, k) for _, p, k in layers] == [(p, k) for _, p, k in ref]
    np.testing.assert_allclose(layers[1][0], np.asarray(ref[1][0]),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(layers[2][0], ref[2][0])


def test_saliency_plugin_rgb_scale(rng):
    """An RGB uint8-scaled input: channel mean, scale by the max."""
    img = np.repeat(_textured_scene(rng, 128, 128)[..., None] * 200.0, 3, -1)
    got = ts.SaliencyDetector(tile=128, pad=16, device="cpu").run(img)
    ref = js.SaliencyDetector(tile=128, pad=16).run(img)
    np.testing.assert_allclose(got[1][0], np.asarray(ref[1][0]), atol=1e-5,
                               rtol=0)
    assert len(got) == len(ref)
    if len(ref) == 3:
        np.testing.assert_array_equal(got[2][0], ref[2][0])


def test_cli_run_saliency(tmp_path, rng, capsys):
    """``python -m pcmi_tpu_torch run saliency --device cpu`` writes the
    saliency layer, within 1e-5 of the reference CLI's."""
    img = rng.uniform(0, 1, (128, 128)).astype(np.float32)
    img[60:70, 60:70] += 2.0
    src = str(tmp_path / "in.tif")
    write_tiff(src, img)
    out = str(tmp_path / "out")
    assert cli.main(["run", "saliency", "--input", src, "--output", out,
                     "--device", "cpu"]) == 0
    files = capsys.readouterr().out.splitlines()
    assert any(f.endswith("saliency.tif") for f in files)
    sal = read_tiff(os.path.join(out, "saliency.tif"))
    assert sal.shape == img.shape
    ref_out = str(tmp_path / "ref")
    assert jmain(["run", "saliency", "--input", src, "--output",
                  ref_out]) == 0
    np.testing.assert_allclose(
        sal, read_tiff(os.path.join(ref_out, "saliency.tif")), atol=1e-5,
        rtol=0)
