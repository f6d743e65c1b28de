"""The port's Deep Image Prior engine, generative processors and plugin
(``pcmi_tpu_torch.models.dip``, ``pipelines.generative``) against
``pcmi_tpu.models.dip`` and ``pipelines.generative`` on the CPU.

DIP runs from the reference's own draws for a seed (its noise input, its
``model.init`` weights carried across by ``convert.unet_state_dict``,
its per-step jitter) through ``DIPEngine._fit``; the processors and the
plugin get an engine whose output is a fixed function of its input, the
same in both packages. Tolerances: the DIP losses within 1e-5 over a
few Adam steps, its output within 1e-5, or within 1e-4 after one step
where a hole makes the fit as sensitive to rounding as the reference is
to its own compiler (``test_dip_steps_match_reference``); ``_prep``'s antialiased downscale within
1e-6 and its mask identical; known pixels kept exactly; ``feather_blend``
and ``nan_mask`` bit-exact; processors within 1e-6. The reference's
cases (``tests/test_generative.py``, DIP and the processors) are
mirrored at the port's surface.
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pcmi_tpu.models import dip as jdip
from pcmi_tpu.models import unet as ju
from pcmi_tpu.pipelines import generative as jg
from pcmi_tpu_torch import convert, registry
from pcmi_tpu_torch.models import dip as tdip
from pcmi_tpu_torch.models import unet as tu
from pcmi_tpu_torch.pipelines import generative as tg

torch.set_num_threads(1)

TINY = dict(widths=(8, 16, 16))


def _engines(iters, max_size=512):
    cfg = dict(iters=iters, noise_channels=8, max_size=max_size)
    ref = jdip.DIPEngine(jdip.DIPConfig(**cfg))
    ref.model = ju.DIPUNet(**TINY)
    port = tdip.DIPEngine(tdip.DIPConfig(**cfg), device="cpu",
                          model=tu.DIPUNet(**TINY, in_channels=8))
    return ref, port


@pytest.mark.parametrize("c,known_all,iters,out_tol", [(3, False, 1, 1e-4),
                                                       (1, True, 3, 1e-5)])
def test_dip_steps_match_reference(rng, c, known_all, iters, out_tol):
    """Adam steps at lr 1e-2 from the reference's draws of seed 3: the
    loss curve within 1e-5, the fitted output within ``out_tol``. A grey
    image goes through the 3-channel head, broadcast as the reference
    does. With a hole, one step moves a weight whose gradient rounding
    dominates by ~0.1 lr (Adam divides it by its own size): the output
    then parts by 3e-5 after one step and by 4e-3 after two, and the
    reference's own eager and compiled runs part by as much (5e-5, then
    4e-3), so one step is compared there."""
    ref, port = _engines(iters)
    img = rng.uniform(0, 1, (16, 20, c)).astype(np.float32)
    known = np.ones((16, 20), bool)
    if not known_all:
        known[5:11, 6:13] = False
    key = jax.random.PRNGKey(3)
    want_out, want_losses = ref._run(jnp.asarray(img), jnp.asarray(known), key)
    kz, kp, kn = jax.random.split(key, 3)
    z0 = 0.1 * jax.random.normal(kz, (1, 16, 20, 8))
    params = ref.model.init(kp, z0)
    jitter = [torch.from_numpy(np.array(jax.random.normal(k, z0.shape)))
              for k in jax.random.split(kn, iters)]
    net = tu.DIPUNet(**TINY, in_channels=8)
    net.load_state_dict(convert.unet_state_dict(params, net))
    out, losses = port._fit(torch.from_numpy(img), torch.from_numpy(known),
                            torch.from_numpy(np.array(z0)), net, jitter)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               atol=out_tol, rtol=0)
    with pytest.raises(ValueError, match="draws"):
        port._fit(torch.from_numpy(img), torch.from_numpy(known),
                  torch.from_numpy(np.array(z0)), net, jitter[:iters - 1])


@pytest.mark.parametrize("shape", [(96, 80), (70, 96, 3), (40, 33)])
def test_prep_matches_reference(rng, shape):
    """Downscale to ``max_size`` (antialiased linear), pad to the stride."""
    ref, port = _engines(1, max_size=32)
    img = rng.uniform(0, 1, shape).astype(np.float32)
    mask = np.zeros(shape[:2], np.float32)
    mask[shape[0] // 3: shape[0] // 2, shape[1] // 4: shape[1] // 2] = 1.0
    want = ref._prep(img, mask)
    got = port._prep(img, mask)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2:] == want[2:]


def test_restore_and_enhance_keep_known_pixels(rng):
    """``test_generative.py``'s odd-size and downscale cases at the port's
    surface: the output at the input's size, the known pixels exact."""
    _, port = _engines(6, max_size=32)
    img = np.tile(np.linspace(0.2, 0.8, 50, dtype=np.float32)[None, :],
                  (50, 1))
    mask = np.zeros((50, 50), np.float32)
    mask[20:26, 20:26] = 1.0
    res = port.restore(img, mask, seed=1)
    out = res.output.numpy()
    assert out.shape == (50, 50) and res.losses.shape == (6,)
    np.testing.assert_array_equal(out[mask < 0.5], img[mask < 0.5])
    assert np.isfinite(out).all()
    rgb = rng.uniform(0, 1, (20, 28, 3)).astype(np.float32)
    enh = port.enhance(rgb, seed=2).output
    assert enh.shape == (20, 28, 3) and torch.isfinite(enh).all()
    again = port.enhance(rgb, seed=2).output
    assert torch.equal(enh, again)  # one seed, one draw
    assert tdip.DIPEngine().device == torch.device("cuda")


class _Res(NamedTuple):
    output: object


class _FixedEngine:
    """An engine whose output is ``0.5 * x + 0.2 * x[::-1]`` (a fixed
    function of its input), in either package's arrays."""

    def __init__(self, xp):
        self.xp = xp

    def _f(self, x):
        return _Res(0.5 * x + 0.2 * self.xp.flip(x, 0))

    def restore(self, image, mask, seed=0):
        return self._f(image)

    stitch = restore

    def enhance(self, image, mask=None, seed=0):
        return self._f(image)


def _torch_flip(x, axis):
    return torch.flip(x, (axis,))


class _TorchXP:
    flip = staticmethod(_torch_flip)


REF_ENGINE = _FixedEngine(jnp)
PORT_ENGINE = _FixedEngine(_TorchXP)


def test_feather_blend_and_nan_mask_bit_exact(rng):
    orig = rng.uniform(0, 1, (40, 36, 3)).astype(np.float32)
    gen = rng.uniform(0, 1, (40, 36, 3)).astype(np.float32)
    mask = np.zeros((40, 36), np.float32)
    mask[8:30, 5:20] = 1.0
    for o, g in ((orig, gen), (orig[..., 0], gen[..., 0])):
        want = jg.feather_blend(jnp.asarray(o), jnp.asarray(g),
                                jnp.asarray(mask), 6)
        got = tg.feather_blend(torch.from_numpy(o), torch.from_numpy(g),
                               torch.from_numpy(mask), 6)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    img = orig.copy()
    img[10:14, 3:9, 1] = np.nan
    img[30, 30] = np.inf
    for a in (img, img[..., 1]):
        np.testing.assert_array_equal(tg.nan_mask(a, 3, device="cpu"),
                                      np.asarray(jg.nan_mask(a, 3)))


def test_feather_blend_edges():
    """``test_generative.py``'s case at the port's surface."""
    mask = torch.zeros((32, 32))
    mask[8:24, 8:24] = 1.0
    out = tg.feather_blend(torch.zeros((32, 32)), torch.ones((32, 32)), mask,
                           blend_width=4).numpy()
    assert out[0, 0] == 0.0 and out[16, 16] == 1.0
    assert 0.0 < out[9, 16] < 1.0


@pytest.mark.parametrize("c", [None, 3])
def test_processors_match_reference(rng, c):
    shape = (32, 40) if c is None else (32, 40, c)
    img = rng.uniform(0.2, 0.8, shape).astype(np.float32)
    img[10:16, 12:20] = np.nan
    want = jg.ImageRestorationProcessor(REF_ENGINE, margin=2).process(img)
    got = tg.ImageRestorationProcessor(PORT_ENGINE, margin=2,
                                       device="cpu").process(img)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)

    left = rng.uniform(0.3, 0.5, (32, 24) if c is None else (32, 24, c))
    right = rng.uniform(0.3, 0.5, (30, 20) if c is None else (30, 20, c))
    jp = jg.StitchingProcessor(REF_ENGINE, overlap=12)
    tp = tg.StitchingProcessor(PORT_ENGINE, overlap=12, device="cpu")
    for a, b in zip(tp.compose(left, right), jp.compose(left, right)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tp.process(left, right),
                               np.asarray(jp.process(left, right)),
                               atol=1e-6, rtol=0)

    clean = np.nan_to_num(img)
    want = jg.EnhancementProcessor(REF_ENGINE, hf_weight=0.8).process(clean)
    got = tg.EnhancementProcessor(PORT_ENGINE, hf_weight=0.8,
                                  device="cpu").process(clean)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("scale", [1.0, 255.0])
def test_plugin_matches_reference(rng, scale):
    """Layers of the plugin against the reference's, both on the fixed
    engine: a [0, 1] image with a NaN hole, and one at 0-255 without."""
    img = (rng.uniform(0.1, 0.9, (24, 32, 3)) * scale).astype(np.float32)
    if scale == 1.0:
        img[6:12, 10:18] = np.nan
    want = jg.RestorationGenerativePlugin(REF_ENGINE).run(img)
    plugin = tg.RestorationGenerativePlugin(PORT_ENGINE, device="cpu")
    got = plugin.run(img)
    assert plugin.name == "Generative Restoration"
    assert [p for _, p, _ in got] == [p for _, p, _ in want]
    np.testing.assert_array_equal(got[0][0], want[0][0])
    np.testing.assert_allclose(got[1][0], np.asarray(want[1][0]),
                               atol=1e-6 * scale, rtol=0)


def test_plugin_copies_the_reference_scale_fault(rng):
    """A 0-255 image with a NaN hole: the reference scales by
    ``img.max()``, which is NaN there, so every output pixel is NaN
    (a fault of the reference, ROADMAP Queue 3); the port does the same."""
    img = (rng.uniform(0.1, 0.9, (24, 32, 3)) * 255).astype(np.float32)
    img[5:8, 5:8] = np.nan
    want = np.asarray(jg.RestorationGenerativePlugin(REF_ENGINE).run(img)[1][0])
    got = tg.RestorationGenerativePlugin(PORT_ENGINE, device="cpu").run(img)
    assert np.isnan(want).all() and np.isnan(got[1][0]).all()


def test_registry_plugin_runs_on_the_cpu(rng):
    """The registry's ninth plugin with its default engine (DIP, 300
    steps) on a small image: finite, the pixels outside the hole and its
    10 px margin kept."""
    plugin = registry.create("generative-restoration", device="cpu")
    assert isinstance(plugin, tg.RestorationGenerativePlugin)
    assert plugin.processor.engine.device == torch.device("cpu")
    assert registry.create("generative-restoration").processor.device == \
        torch.device("cuda")
    img = rng.uniform(0.2, 0.8, (12, 12)).astype(np.float32)
    img[0, 0] = np.nan
    layers = plugin.run(img)
    out = layers[1][0]
    assert out.shape == (12, 12) and np.isfinite(out).all()
    far = np.ones((12, 12), bool)
    far[:11, :11] = False   # the hole and its margin
    np.testing.assert_array_equal(out[far], img[far])


def test_available_engines():
    from pcmi_tpu_torch.models.diffusion import TiledDiffusionEngine

    engines = tg.available_engines()
    assert engines == {"Deep Image Prior": tdip.DIPEngine,
                       "Diffusion": TiledDiffusionEngine}
    assert set(engines) == set(jg.available_engines())


def _tiny_dip(iters=60):
    return tdip.DIPEngine(tdip.DIPConfig(iters=iters, noise_channels=8),
                          device="cpu",
                          model=tu.DIPUNet(**TINY, in_channels=8))


def test_restoration_processor_fills_nans():
    """``test_generative.py``'s case with the port's draws."""
    ramp = np.tile(np.linspace(0.2, 0.8, 48, dtype=np.float32)[None, :],
                   (48, 1))
    img = ramp.copy()
    img[20:26, 20:26] = np.nan
    out = tg.ImageRestorationProcessor(_tiny_dip(), margin=2,
                                       device="cpu").process(img)
    assert np.isfinite(out).all()
    assert np.abs(out[20:26, 20:26] - ramp[20:26, 20:26]).mean() < 0.3


def test_enhancement_processor_keeps_high_freq(rng):
    """``test_generative.py``'s case with the port's draws."""
    img = rng.uniform(0.2, 0.8, (32, 32)).astype(np.float32)
    out = tg.EnhancementProcessor(_tiny_dip(), hf_weight=1.0,
                                  device="cpu").process(img)
    assert out.shape == img.shape
    hf_in, hf_out = img - img.mean(), out - out.mean()
    corr = (hf_in * hf_out).sum() / (np.linalg.norm(hf_in)
                                     * np.linalg.norm(hf_out) + 1e-9)
    assert corr > 0.3


@pytest.mark.slow
def test_dip_fills_hole_on_smooth_image():
    """``test_models.py``'s slow case with the port's draws."""
    engine = _tiny_dip(150)
    img = np.tile(np.linspace(0.2, 0.8, 48, dtype=np.float32)[None, :],
                  (48, 1))
    mask = np.zeros((48, 48), np.float32)
    mask[20:28, 20:28] = 1.0
    res = engine.restore(img, mask)
    out = res.output.numpy()
    np.testing.assert_allclose(out[mask < 0.5], img[mask < 0.5], atol=1e-6)
    assert np.abs(out[20:28, 20:28] - img[20:28, 20:28]).mean() < 0.15
    losses = res.losses.numpy()
    assert losses[-10:].mean() < 0.5 * losses[:10].mean()
