"""The port's U-Nets and image metrics (``pcmi_tpu_torch.models``) against
``pcmi_tpu.models`` on the CPU, forward passes only.

Parameters are numpy draws from a seed in the reference's own parameter
tree (Flax names and shapes), carried across by
``convert.unet_state_dict``; inputs are numpy draws from a seed. Tolerances: network outputs within 1e-4, ``instance_norm``,
``bicubic_upsample`` and the metrics within 1e-5. The reference's cases
(``tests/test_models.py``, forward only) are mirrored at the port's
surface.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as fnn

from pcmi_tpu.models import metrics as jmet
from pcmi_tpu.models import unet as ju
from pcmi_tpu_torch import convert
from pcmi_tpu_torch.models import metrics as tmet
from pcmi_tpu_torch.models import unet as tu

torch.set_num_threads(1)

SMALL = dict(widths=(8, 16, 32))


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _carried(flax_model, port_model, x, seed=0):
    """The reference network's parameter tree (names and shapes from its
    ``init``, traced only) filled with seeded numpy draws — kernels of
    variance ``1 / fan_in``, biases N(0, 0.1²) so that each bias lands in
    its place — and carried into the port model."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(flax_model.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))

    def draw(s):
        scale = np.sqrt(1.0 / np.prod(s.shape[:-1])) if len(s.shape) == 4 \
            else 0.1
        return rng.normal(0, scale, s.shape).astype(np.float32)

    params = jax.tree_util.tree_map(draw, shapes)
    port_model.load_state_dict(convert.unet_state_dict(params, port_model))
    return params


def _forward(flax_model, port_model, x):
    params = _carried(flax_model, port_model, x)
    ref = np.asarray(flax_model.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port_model(_t(x)).numpy()
    return got, ref


def test_instance_norm(rng):
    x = rng.normal(1.0, 3.0, (2, 9, 7, 5)).astype(np.float32)
    ref = np.asarray(ju.instance_norm(jnp.asarray(x)))
    np.testing.assert_allclose(tu.instance_norm(_t(x)).numpy(), ref,
                               atol=1e-5, rtol=0)
    nchw = tu.instance_norm(_t(x).permute(0, 3, 1, 2), (2, 3))
    np.testing.assert_allclose(nchw.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,k,s", [(9, 4, 1), (8, 4, 2), (9, 4, 2),
                                   (7, 3, 1), (5, 1, 1)])
def test_same_pads(rng, n, k, s):
    """Flax's "SAME" padding, held by a one-conv network of each shape."""
    x = rng.uniform(0, 1, (1, n, n + 1, 2)).astype(np.float32)
    conv = fnn.Conv(3, (k, k), strides=(s, s), padding="SAME")
    params = conv.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    ref = np.asarray(conv.apply({"params": params}, jnp.asarray(x)))
    mine = tu.SameConv2d(2, 3, k, s)
    mine.weight.data = _t(np.asarray(params["kernel"]).transpose(3, 2, 0, 1))
    mine.bias.data = _t(params["bias"])
    with torch.no_grad():
        got = mine(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_conv_block_down_up(rng):
    """``ConvBlock`` with and without norm, ``_down`` and ``_up`` inside a
    Flax wrapper of the reference's functions."""

    class Ref(fnn.Module):
        norm: bool

        @fnn.compact
        def __call__(self, x):
            h = ju.ConvBlock(6, norm=self.norm)(x)
            return ju._up(ju._down(h), 4)

    x = rng.uniform(0, 1, (2, 8, 10, 3)).astype(np.float32)
    for norm in (True, False):
        ref_m = Ref(norm)
        params = ref_m.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
        blk = tu.ConvBlock(6, norm, in_features=3)
        conv = tu.SameConv2d(6, 4, 3)
        for name, mod in (("conv0", blk.conv0), ("conv1", blk.conv1)):
            leaf = params["ConvBlock_0"]["Conv_" + name[-1]]
            mod.weight.data = _t(np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1))
            mod.bias.data = _t(leaf["bias"])
        conv.weight.data = _t(np.asarray(params["Conv_0"]["kernel"]).transpose(
            3, 2, 0, 1))
        conv.bias.data = _t(params["Conv_0"]["bias"])
        with torch.no_grad():
            h = blk(_t(x).permute(0, 3, 1, 2))
            got = tu._up(tu._down(h), conv).permute(0, 2, 3, 1).numpy()
        ref = np.asarray(ref_m.apply({"params": params}, jnp.asarray(x)))
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_inpaint_unet_forward(rng):
    x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    mask = np.zeros((2, 32, 32, 1), np.float32)
    mask[:, 8:20, 6:18] = 1.0
    inp = np.concatenate([x, mask], -1)
    got, ref = _forward(ju.InpaintUNet(**SMALL), tu.InpaintUNet(**SMALL), inp)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_inpaint_unet_default_widths(rng):
    inp = rng.uniform(0, 1, (1, 32, 24, 4)).astype(np.float32)
    inp[..., 3] = inp[..., 3] > 0.5
    got, ref = _forward(ju.InpaintUNet(), tu.InpaintUNet(), inp)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_inpaint_unet_residual_semantics(rng):
    """``test_models.py``'s case at the port's surface (the port's own
    draw of weights)."""
    model = tu.InpaintUNet(**SMALL)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
    mask = torch.zeros((2, 32, 32, 1))
    with torch.no_grad():
        out = model(torch.cat([x, mask], -1))
        np.testing.assert_allclose(out.numpy(), x.numpy(), atol=1e-6)
        mask2 = mask.clone()
        mask2[:, 8:16, 8:16] = 1.0
        out2 = model(torch.cat([x, mask2], -1))
    diff = (out2 - x).abs().numpy()
    assert diff[:, :8].max() < 1e-6
    assert diff[:, 8:16, 8:16].max() > 1e-3


def test_patch_discriminator_forward(rng):
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    kw = dict(widths=(8, 16, 32, 32))
    got, ref = _forward(ju.PatchDiscriminator(**kw),
                        tu.PatchDiscriminator(**kw), x)
    assert got.shape == ref.shape
    assert got.shape[0] == 2 and got.shape[-1] == 1 and got.shape[1] < 64
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_patch_discriminator_odd_size(rng):
    """Odd sizes at stride 2 pad lo 1 / hi 2."""
    x = rng.uniform(0, 1, (1, 37, 29, 3)).astype(np.float32)
    got, ref = _forward(ju.PatchDiscriminator(widths=(8, 16, 16)),
                        tu.PatchDiscriminator(widths=(8, 16, 16)), x)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape,factor", [((1, 16, 16, 3), 4),
                                          ((2, 5, 7, 2), 3),
                                          ((1, 6, 4, 1), 2)])
def test_bicubic_upsample(rng, shape, factor):
    lr = rng.uniform(0, 1, shape).astype(np.float32)
    ref = np.asarray(ju.bicubic_upsample(jnp.asarray(lr), factor))
    got = tu.bicubic_upsample(_t(lr), factor).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_sr_unet_forward(rng):
    lr = rng.uniform(0, 1, (1, 16, 16, 3)).astype(np.float32)
    up = np.asarray(ju.bicubic_upsample(jnp.asarray(lr), 4))
    got, ref = _forward(ju.SRUNet(**SMALL), tu.SRUNet(**SMALL), up)
    assert got.shape == up.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_sr_unet_factor_and_residual(rng):
    """``test_models.py``'s case at the port's surface."""
    m = tu.SRUNet(widths=(8, 16, 32))
    lr = torch.from_numpy(rng.uniform(0, 1, (1, 16, 16, 3)).astype(np.float32))
    up = tu.bicubic_upsample(lr, 4)
    assert up.shape == (1, 64, 64, 3)
    with torch.no_grad():
        assert m(up).shape == up.shape


def test_dip_unet_forward(rng):
    z = rng.uniform(0, 0.1, (1, 16, 16, 32)).astype(np.float32)
    kw = dict(widths=(8, 16, 16))
    got, ref = _forward(ju.DIPUNet(**kw), tu.DIPUNet(**kw), z)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    assert 0.0 < got.min() and got.max() < 1.0


def test_unet_state_dict_raises_on_mismatch(rng):
    x = rng.uniform(0, 1, (1, 16, 16, 4)).astype(np.float32)
    model = tu.InpaintUNet(**SMALL)
    params = _carried(ju.InpaintUNet(**SMALL), model, x)
    sd = convert.unet_state_dict(params["params"], model)   # no "params"
    for k, v in sd.items():
        assert torch.equal(v, model.state_dict()[k]), k
    assert set(sd) == set(model.state_dict())
    extra = {"params": dict(params["params"], Conv_9={})}
    with pytest.raises(KeyError, match="left over"):
        convert.unet_state_dict(extra, model)
    missing = {"params": {k: v for k, v in params["params"].items()
                          if k != "ConvBlock_4"}}
    with pytest.raises(KeyError, match="ConvBlock_4"):
        convert.unet_state_dict(missing, model)
    with pytest.raises(KeyError):  # a deeper port network: keys missing
        convert.unet_state_dict(params, tu.InpaintUNet())
    with pytest.raises(ValueError, match="shape"):  # another width
        convert.unet_state_dict(params, tu.InpaintUNet(widths=(8, 16, 64)))


def test_port_weights_are_seeded():
    """No generator: the same draw (a CPU generator seeded with 0) every
    time; biases zero, kernels within 2 sigma of Flax's scale."""
    a, b = tu.SRUNet(**SMALL), tu.SRUNet(**SMALL)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.enc[0].conv0.weight
    sigma = np.sqrt(1.0 / w[0].numel()) / .87962566103423978
    assert float(w.detach().abs().max()) <= 2 * sigma + 1e-6
    assert float(a.enc[0].conv0.bias.abs().max()) == 0.0
    c = tu.SRUNet(**SMALL, generator=torch.Generator().manual_seed(1))
    assert not torch.equal(c.head.weight, a.head.weight)


def test_psnr_ssim(rng):
    pred = rng.uniform(0, 1, (2, 24, 20, 3)).astype(np.float32)
    target = np.clip(pred + rng.normal(0, 0.05, pred.shape), 0,
                     1).astype(np.float32)
    mask = (rng.uniform(0, 1, (2, 24, 20, 1)) > 0.5).astype(np.float32)
    for args in ((), (mask,)):
        ref = float(jmet.psnr(jnp.asarray(pred), jnp.asarray(target),
                              *[jnp.asarray(a) for a in args]))
        got = float(tmet.psnr(_t(pred), _t(target), *[_t(a) for a in args]))
        assert abs(got - ref) <= 1e-4 * abs(ref)
    for p, t in ((pred, target), (pred[0], target[0]),
                 (pred[0, ..., 0], target[0, ..., 0])):
        ref = float(jmet.ssim(jnp.asarray(p), jnp.asarray(t)))
        got = float(tmet.ssim(_t(p), _t(t)))
        assert abs(got - ref) <= 1e-5, (p.shape, got, ref)
    assert float(tmet.ssim(_t(pred), _t(pred))) == pytest.approx(1.0,
                                                                 abs=1e-5)
