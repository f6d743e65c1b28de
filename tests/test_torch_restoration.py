"""The port's classical restoration (``pcmi_tpu_torch.pipelines.
restoration``) against ``pcmi_tpu.pipelines.restoration`` on the CPU.

Inputs are numpy draws from a seed fed to both packages; the degradation
is fed the reference's own ``jax.random`` draws through ``_degrade``.
Tolerances: NLM, dehaze and unsharp outputs within 1e-5 (the reference's
compiler may fuse multiply-adds the port rounds twice). The reference's
cases (``tests/test_components.py``) are mirrored at the port's surface.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pcmi_tpu.pipelines import restoration as jr
from pcmi_tpu_torch.pipelines import restoration as tr

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _scene(rng, h=48, w=40, c=None):
    shape = (h, w) if c is None else (h, w, c)
    base = np.linspace(0.2, 0.8, w, dtype=np.float32)[None, :]
    img = np.broadcast_to(base if c is None else base[..., None],
                          shape).copy()
    img[h // 4:h // 2, w // 4:w // 2] = 0.1
    return (img + rng.normal(0, 0.05, shape)).astype(np.float32)


@pytest.mark.parametrize("c", [None, 3])
def test_nlm_denoise(rng, c):
    img = np.clip(_scene(rng, c=c), 0, 1)
    ref = np.asarray(jr.nlm_denoise(jnp.asarray(img), h=0.08, template=5,
                                    search=9))
    got = tr.nlm_denoise(_t(img), h=0.08, template=5, search=9).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_nlm_denoise_defaults(rng):
    """The plugin's settings: search 21, template 7."""
    img = np.clip(_scene(rng, 40, 36), 0, 1)
    ref = np.asarray(jr.nlm_denoise(jnp.asarray(img)))
    got = tr.nlm_denoise(_t(img)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_nlm_denoise_reduces_noise(rng):
    clean = np.tile(np.linspace(0.2, 0.8, 64), (64, 1)).astype(np.float32)
    noisy = clean + rng.normal(0, 0.05, clean.shape).astype(np.float32)
    den = tr.nlm_denoise(_t(noisy), h=0.08, template=5, search=9).numpy()
    assert np.abs(den - clean).mean() < 0.55 * np.abs(noisy - clean).mean()


@pytest.mark.parametrize("c", [None, 3])
def test_dark_channel_dehaze(rng, c):
    img = np.clip(_scene(rng, 64, 56, c) * 0.6 + 0.35, 0, 1)
    ref = jr.dark_channel_dehaze(jnp.asarray(img), erosion=9)
    got = tr.dark_channel_dehaze(_t(img), erosion=9)
    for f in ("radiance", "transmission", "atmosphere"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), atol=1e-5,
                                   rtol=0, err_msg=f)


@pytest.mark.parametrize("shape,haze,sigma", [
    ((96, 96), 0.7, 0.0), ((70, 50, 3), 0.6, 0.02)])
def test_add_degradation_with_reference_draws(rng, shape, haze, sigma):
    """``_degrade`` fed the reference's two draws gives its result."""
    img = rng.uniform(0, 1, shape).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref, t_ref = jr.add_degradation(jnp.asarray(img), key,
                                    haze_strength=haze, noise_sigma=sigma)
    k1, k2 = jax.random.split(key)
    h, w = shape[:2]
    low = np.asarray(jax.random.uniform(k1, (h // 32 + 2, w // 32 + 2)))
    noise = np.asarray(jax.random.normal(k2, shape))
    got, t_got = tr._degrade(_t(img), _t(low), _t(noise), haze, sigma)
    np.testing.assert_allclose(t_got.numpy(), np.asarray(t_ref), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


def test_add_degradation_own_draws(rng):
    """The port's own draw: a generator seeded with 0 by default, the same
    result from the same seed, the transmission in [1 - haze, 1]."""
    img = rng.uniform(0, 1, (64, 80)).astype(np.float32)
    a, ta = tr.add_degradation(_t(img))
    b, tb = tr.add_degradation(_t(img), torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    c, _ = tr.add_degradation(_t(img), torch.Generator().manual_seed(1))
    assert not np.array_equal(a.numpy(), c.numpy())
    assert 0.4 - 1e-6 <= float(ta.min()) and float(ta.max()) <= 1.0
    assert a.shape == (64, 80) and 0.0 <= float(a.min()) <= float(a.max()) <= 1.0


def test_dehaze_recovers_contrast():
    clean = np.zeros((96, 96), np.float32)
    clean[:] = np.linspace(0.1, 0.7, 96)[None, :]
    clean[30:60, 30:60] = 0.05
    hazy, _ = tr.add_degradation(_t(clean), haze_strength=0.7,
                                 noise_sigma=0.0)
    res = tr.dark_channel_dehaze(hazy, erosion=15)
    assert float(res.radiance.std()) > 1.2 * float(hazy.std())
    assert float(res.transmission.min()) >= 0.1
    assert float(res.transmission.max()) <= 1.0


def test_restoration_engine_layers(rng):
    """Each of the engine's four outputs against the reference's."""
    img = np.clip(_scene(rng, 48, 40, 3) * 0.7 + 0.25, 0, 1)
    ref = jr.RestorationEngine(erosion=9).restore(jnp.asarray(img))
    got = tr.RestorationEngine(erosion=9).restore(_t(img))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_restoration_plugin_layer_contract(rng):
    """``test_components.py``'s contract at the port's surface, and the
    layers against the reference's (0-255 input: within 255 * 1e-5)."""
    img = (np.clip(_scene(rng, 40, 40), 0, 1) * 255).astype(np.float32)
    layers = tr.RestorationPlugin(device="cpu").run(img)
    names = [p["name"] for _, p, _ in layers]
    assert names == ["input", "denoised", "dehazed", "restored", "transmission"]
    assert all(k == "image" for _, _, k in layers)
    assert layers[3][0].max() > 1.5
    ref = jr.RestorationPlugin().run(img)
    assert [p for _, p, _ in layers] == [p for _, p, _ in ref]
    for (a, _, _), (b, _, _), tol in zip(layers, ref,
                                         (0, 255e-5, 255e-5, 255e-5, 1e-5)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                                   rtol=0)
