"""The port's super-resolution and inpainting plugins (``pcmi_tpu_torch.
pipelines.superres``) against ``pcmi_tpu.pipelines.superres`` on the CPU.

Both plugins get the same weights: seeded numpy draws in the reference's
parameter tree, set as the reference plugin's ``params`` and carried into
the port's network by ``convert.unet_state_dict``. Tolerances: padding
and hole masks bit-exact; the bicubic layer within 1e-5 and the networks'
layers within 1e-4 of the image scale.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pcmi_tpu.models import unet as ju
from pcmi_tpu.pipelines import superres as jsr
from pcmi_tpu_torch import convert
from pcmi_tpu_torch.pipelines import superres as tsr

torch.set_num_threads(1)


def _params(flax_model, x, seed=0):
    """Seeded numpy draws in the reference network's parameter tree."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(flax_model.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))

    def draw(s):
        scale = np.sqrt(1.0 / np.prod(s.shape[:-1])) if len(s.shape) == 4 \
            else 0.05
        return rng.normal(0, scale, s.shape).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def _same_weights(ref_plugin, port_plugin, x):
    params = _params(ref_plugin.model, x)
    ref_plugin.params = params
    port_plugin.model.load_state_dict(
        convert.unet_state_dict(params, port_plugin.model))


@pytest.mark.parametrize("shape,m", [((5, 7), 2), ((9, 6, 3), 8),
                                     ((8, 16), 8)])
def test_pad_to_multiple(rng, shape, m):
    a = rng.uniform(0, 1, shape).astype(np.float32)
    got, hw = tsr._pad_to_multiple(a, m)
    ref, hw_ref = jsr._pad_to_multiple(a, m)
    np.testing.assert_array_equal(got, ref)
    assert hw == hw_ref


@pytest.mark.parametrize("rgb", [False, True])
def test_create_inpaint_mask(rng, rgb):
    img = rng.uniform(0.1, 1, (40, 36, 3) if rgb else (40, 36))
    img = (img * 255).astype(np.float32)
    img[10:16, 5:12] = 0.0
    img[30, 30] = 0.5
    got = tsr.create_inpaint_mask(img, device="cpu")
    ref = jsr.create_inpaint_mask(img)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert got[12, 8] and not got[0, 0]


@pytest.mark.parametrize("rgb", [False, True])
def test_super_resolution_plugin(rng, rgb):
    """Odd LR sizes (padded to even, cropped back), 0-255 scale."""
    lr = (rng.uniform(0, 1, (11, 9, 3) if rgb else (11, 9)) * 255).astype(
        np.float32)
    ref_p = jsr.SuperResolutionPlugin()
    got_p = tsr.SuperResolutionPlugin(device="cpu")
    _same_weights(ref_p, got_p, np.zeros((1, 48, 40, 3), np.float32))
    ref = ref_p.run(lr)
    got = got_p.run(lr)
    assert [p for _, p, _ in got] == [p for _, p, _ in ref]
    assert got[1][0].shape == got[2][0].shape == (44, 36, 3)
    np.testing.assert_allclose(got[1][0], np.asarray(ref[1][0]),
                               atol=255e-5, rtol=0)
    np.testing.assert_allclose(got[2][0], np.asarray(ref[2][0]),
                               atol=255e-4, rtol=0)


def test_inpainting_plugin(rng):
    """A near-black hole found by the mask, the Jacobi prefill, the U-Net's
    residual inside the hole only; sizes not multiples of 8."""
    img = rng.uniform(0.2, 1, (26, 21, 3)).astype(np.float32)
    img[8:14, 6:12] = 0.0
    ref_p = jsr.InpaintingPlugin()
    got_p = tsr.InpaintingPlugin(device="cpu")
    _same_weights(ref_p, got_p, np.zeros((1, 32, 24, 4), np.float32))
    ref = ref_p.run(img)
    got = got_p.run(img)
    assert [p for _, p, _ in got] == [p for _, p, _ in ref]
    np.testing.assert_array_equal(got[1][0], np.asarray(ref[1][0]))
    np.testing.assert_allclose(got[2][0], np.asarray(ref[2][0]), atol=1e-4,
                               rtol=0)
    hole = got[1][0].astype(bool)
    np.testing.assert_allclose(got[2][0][~hole], img[~hole], atol=1e-6)
    assert np.abs(got[2][0][hole]).max() > 0.0


def test_inpainting_plugin_given_mask(rng):
    img = (rng.uniform(0, 1, (26, 21)) * 255).astype(np.float32)
    mask = np.zeros((26, 21), bool)
    mask[4:9, 3:7] = True
    ref_p = jsr.InpaintingPlugin()
    got_p = tsr.InpaintingPlugin(device="cpu")
    _same_weights(ref_p, got_p, np.zeros((1, 32, 24, 4), np.float32))
    ref = ref_p.run(img, mask=mask)
    got = got_p.run(img, mask=mask)
    np.testing.assert_allclose(got[2][0], np.asarray(ref[2][0]),
                               atol=255e-4, rtol=0)


def test_checkpoint_is_a_state_dict(rng, tmp_path):
    """A ``state_dict`` file is loaded at the first run; without one the
    plugin runs on its own seeded draw, the same every time."""
    lr = rng.uniform(0, 1, (6, 6, 3)).astype(np.float32)
    a = tsr.SuperResolutionPlugin(device="cpu")
    b = tsr.SuperResolutionPlugin(device="cpu")
    np.testing.assert_array_equal(a.run(lr)[2][0], b.run(lr)[2][0])

    with torch.no_grad():
        for p in a.model.parameters():
            p.mul_(0.5)
    path = str(tmp_path / "sr.pt")
    torch.save(a.model.state_dict(), path)
    c = tsr.SuperResolutionPlugin(checkpoint=path, device="cpu")
    np.testing.assert_array_equal(c.run(lr)[2][0], a.run(lr)[2][0])
    assert not np.array_equal(c.run(lr)[2][0], b.run(lr)[2][0])
    missing = tsr.SuperResolutionPlugin(
        checkpoint=str(tmp_path / "none.pt"), device="cpu")
    np.testing.assert_array_equal(missing.run(lr)[2][0], b.run(lr)[2][0])
