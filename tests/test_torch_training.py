"""The port's GAN trainers and checkpoints (``pcmi_tpu_torch.models.
training``) against ``pcmi_tpu.models.training`` on the CPU.

Both packages start from one state: the reference's Flax parameter trees
(names and shapes from ``jax.eval_shape``) filled with seeded numpy
draws, with fresh optax Adam states, carried into the port by
``convert.gan_state_from_reference``. Each step gets the same batch and,
for the inpainting trainer, the reference's own hole masks (its draws
from the step's key) through ``InpaintGANTrainer._step``.

Tolerances, after one step and after three: every loss within 1e-5; at
least 99.9 % of each network's parameters within 1e-5, and all of them
and the networks' outputs on the batch within 2 x lr per step; a
checkpoint round trip bit-exact. Adam divides each gradient by its own
running size, so a weight whose gradient the rounding dominates (a sum
that cancels to ~1e-9; the biases of the convolutions that an instance
norm follows, whose gradient is zero in exact arithmetic and on which no
output depends) steps by up to the learning rate in a direction of its
own in each package, and the outputs move with it. Those biases are left
out of the 99.9 %. The
reference's cases (``tests/test_models.py``, ``tests/test_dp_training.py``)
are mirrored at the port's surface.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pcmi_tpu.models import losses as jlo
from pcmi_tpu.models import training as jt
from pcmi_tpu.models import unet as ju
from pcmi_tpu_torch import convert
from pcmi_tpu_torch.models import training as tt
from pcmi_tpu_torch.models import unet as tu

torch.set_num_threads(1)

TOL = 1e-5
G_SMALL = dict(widths=(8, 16, 32))
D_INPAINT = dict(widths=(8, 16, 32, 32))
D_SR = dict(widths=(8, 16, 32))


def _params(flax_model, x, seed):
    """The reference network's parameter tree filled with seeded draws:
    kernels of variance ``1 / fan_in``, biases N(0, 0.05²)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(flax_model.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))

    def draw(s):
        scale = np.sqrt(1.0 / np.prod(s.shape[:-1])) if len(s.shape) == 4 \
            else 0.05
        return jnp.asarray(rng.normal(0, scale, s.shape).astype(np.float32))

    return jax.tree_util.tree_map(draw, shapes)


def _ref_state(trainer, g_in, d_in, seed=0):
    g = _params(trainer.gen, g_in, seed)
    d = _params(trainer.disc, d_in, seed + 1)
    return jt.GANState(g_params=g, d_params=d, g_opt=trainer.g_tx.init(g),
                       d_opt=trainer.d_tx.init(d), step=jnp.int32(0))


def norm_biases(net) -> set:
    """Names of the biases that an instance norm follows (the outputs
    do not depend on them)."""
    out = set()
    for name, m in net.named_modules():
        if isinstance(m, tu.ConvBlock) and m.norm:
            out |= {f"{name}.conv0.bias", f"{name}.conv1.bias"}
        if isinstance(m, tu.PatchDiscriminator):
            out |= {f"{name}.convs.{i}.bias".lstrip(".")
                    for i in range(1, len(m.convs))}
    return out


def assert_params_close(want: dict, net, bound: float, tag: str):
    """``net``'s parameters against ``want`` (a state_dict): all within
    ``bound``, and at least 99.9 % of those outside :func:`norm_biases`
    within 1e-5."""
    null = norm_biases(net)
    close = total = 0
    for k, v in net.state_dict().items():
        d = np.abs(v.numpy() - want[k].numpy())
        assert d.max() <= bound, (tag, k, float(d.max()), bound)
        if k not in null:
            close += int((d <= TOL).sum())
            total += d.size
    assert close >= 0.999 * total, (tag, total - close, total)


def _assert_same(ref_state, port_state, ref_metrics=None, port_metrics=None,
                 outputs=None):
    """Parameters as :func:`assert_params_close`, and ``outputs``
    (reference apply, port call, input) within the same bound, 2 x lr per
    step (the larger of the two networks' rates)."""
    steps = int(ref_state.step)
    lr = max(opt.param_groups[0].get("initial_lr", opt.param_groups[0]["lr"])
             for opt in (port_state.g_opt, port_state.d_opt))
    bound = 2 * lr * steps + TOL
    for name, params, net in (("g", ref_state.g_params, port_state.g),
                              ("d", ref_state.d_params, port_state.d)):
        assert_params_close(convert.unet_state_dict(params, net), net,
                            bound, name)
    for ref_fn, port_fn, x in outputs or ():
        with torch.no_grad():
            got = port_fn(torch.from_numpy(np.asarray(x))).numpy()
        np.testing.assert_allclose(got, np.asarray(ref_fn(jnp.asarray(x))),
                                   atol=bound, rtol=0)
    assert port_state.step == steps
    if ref_metrics is not None:
        assert set(port_metrics) == set(ref_metrics)
        for k in ref_metrics:
            assert abs(float(port_metrics[k]) - float(ref_metrics[k])) <= TOL, (
                k, float(port_metrics[k]), float(ref_metrics[k]))


def _inpaint_pair(compute_dtype, total_steps, **kw):
    cfg = dict(compute_dtype=compute_dtype, total_steps=total_steps, **kw)
    ref = jt.InpaintGANTrainer(jt.InpaintTrainConfig(**cfg),
                               generator=ju.InpaintUNet(**G_SMALL),
                               discriminator=ju.PatchDiscriminator(**D_INPAINT))
    port = tt.InpaintGANTrainer(tt.InpaintTrainConfig(**cfg),
                                generator=tu.InpaintUNet(**G_SMALL),
                                discriminator=tu.PatchDiscriminator(**D_INPAINT),
                                device="cpu")
    return ref, port


def _ref_mask(trainer, images, key):
    """The hole masks the reference's ``train_step`` draws from ``key``."""
    km, _ = jax.random.split(key)
    b, h, w, _ = images.shape
    return jlo.random_hole_masks(km, (b, h, w), trainer.cfg.mask_seeds,
                                 trainer.cfg.mask_steps)


def _outputs(ref, ref_state, port_state, g_in, d_in):
    """The two networks' outputs, reference and port, on given inputs."""
    return [(lambda x: ref.gen.apply(ref_state.g_params, x), port_state.g,
             g_in),
            (lambda x: ref.disc.apply(ref_state.d_params, x), port_state.d,
             d_in)]


def _inpaint_steps(ref, port, ref_state, port_state, images, steps, key0):
    for i in range(steps):
        key = jax.random.PRNGKey(key0 + i)
        ref_state, rm = ref.train_step(ref_state, jnp.asarray(images), key)
        mask = torch.from_numpy(np.array(_ref_mask(ref, images, key)))
        port_state, pm = port._step(port_state, torch.from_numpy(images), mask)
    return ref_state, rm, port_state, pm


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("steps", [1, 3])
def test_inpaint_gan_steps_match_reference(rng, compute_dtype, steps):
    """Cosine decay over 4 steps (read before each update), prefill
    conditioning, the reference's hole masks."""
    ref, port = _inpaint_pair(compute_dtype, 4, mask_seeds=3, mask_steps=6)
    images = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    x4 = np.concatenate([images, images[..., :1]], -1)
    ref_state = _ref_state(ref, x4, images)
    port_state = convert.gan_state_from_reference(ref_state, port)
    _assert_same(ref_state, port_state)
    r, rm, p, pm = _inpaint_steps(ref, port, ref_state, port_state, images,
                                  steps, 10)
    _assert_same(r, p, rm, pm, _outputs(ref, r, p, x4, images))
    lrs = [g["lr"] for g in p.g_opt.param_groups]
    assert lrs == pytest.approx([2e-4 * tt.cosine_decay(4, 0.02)(steps)])


def test_inpaint_zero_fill_condition_matches_reference(rng):
    """``prefill_condition=False`` (the zero-filled hole), constant lr."""
    ref, port = _inpaint_pair("float32", 0, prefill_condition=False,
                              mask_seeds=3, mask_steps=6)
    images = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    x4 = np.concatenate([images, images[..., :1]], -1)
    ref_state = _ref_state(ref, x4, images, seed=5)
    port_state = convert.gan_state_from_reference(ref_state, port)
    assert port_state.g_sched is None
    r, rm, p, pm = _inpaint_steps(ref, port, ref_state, port_state, images,
                                  1, 20)
    _assert_same(r, p, rm, pm, _outputs(ref, r, p, x4, images))


def test_inpaint_condition_and_infer_match_reference(rng):
    """``_condition`` batches the Jacobi prefill with each image's own
    known mean; ``infer`` with and without the flip ensemble."""
    ref, port = _inpaint_pair("float32", 0)
    images = rng.uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
    images[1] *= 0.3  # the means differ per image
    mask = np.asarray(jlo.random_hole_masks(jax.random.PRNGKey(4),
                                            (3, 32, 32), 4, 6))
    got = port._condition(torch.from_numpy(images), torch.tensor(mask))
    want = ref._condition(jnp.asarray(images), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    x4 = np.concatenate([images, mask], -1)
    ref_state = _ref_state(ref, x4, images, seed=7)
    port_state = convert.gan_state_from_reference(ref_state, port)
    for ensemble in (False, True):
        want = ref.infer(ref_state, jnp.asarray(images), jnp.asarray(mask),
                         ensemble=ensemble)
        got = port.infer(port_state, images, mask, ensemble=ensemble)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


def _sr_pair(compute_dtype, warmup):
    cfg = dict(compute_dtype=compute_dtype, warmup_steps=warmup)
    ref = jt.SRGANTrainer(jt.SRTrainConfig(**cfg),
                          generator=ju.SRUNet(**G_SMALL),
                          discriminator=ju.PatchDiscriminator(**D_SR))
    port = tt.SRGANTrainer(tt.SRTrainConfig(**cfg),
                           generator=tu.SRUNet(**G_SMALL),
                           discriminator=tu.PatchDiscriminator(**D_SR),
                           device="cpu")
    return ref, port


@pytest.mark.parametrize("compute_dtype,warmup,steps", [
    ("bfloat16", 1000, 1),   # inside the warm-up
    ("bfloat16", 2, 3),      # two steps inside, one after
    ("float32", 1, 3),       # one inside, two after
])
def test_sr_gan_steps_match_reference(rng, compute_dtype, warmup, steps):
    """D steps every time (zero gradients in the warm-up, its moments and
    count still advancing), so its updates after the warm-up agree."""
    ref, port = _sr_pair(compute_dtype, warmup)
    lr = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    hr = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    up = np.asarray(ju.bicubic_upsample(jnp.asarray(lr), 4))
    ref_state = _ref_state(ref, up, up, seed=3)
    port_state = convert.gan_state_from_reference(ref_state, port)
    for _ in range(steps):
        ref_state, rm = ref.train_step(ref_state, jnp.asarray(lr),
                                       jnp.asarray(hr))
        port_state, pm = port.train_step(port_state, lr, hr)
    _assert_same(ref_state, port_state, rm, pm,
                 _outputs(ref, ref_state, port_state, up, hr))
    d_steps = {float(s["step"]) for s in port_state.d_opt.state.values()}
    assert d_steps == {float(steps)}
    if steps == 1:
        assert float(pm["d_loss"]) == 0.0  # the GAN is off in the warm-up
    up_t = port.infer(port_state, lr)
    np.testing.assert_allclose(
        up_t.numpy(), np.asarray(ref.infer(ref_state, jnp.asarray(lr))),
        atol=TOL, rtol=0)


def test_resume_from_reference_state(rng):
    """The reference trains two steps; its state (parameters, Adam
    moments and counts, step 2 of a cosine schedule) resumes in the port
    and both take one more step."""
    ref, port = _inpaint_pair("float32", 6, mask_seeds=3, mask_steps=6)
    images = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    x4 = np.concatenate([images, images[..., :1]], -1)
    state = _ref_state(ref, x4, images, seed=11)
    for i in range(2):
        state, _ = ref.train_step(state, jnp.asarray(images),
                                  jax.random.PRNGKey(30 + i))
    port_state = convert.gan_state_from_reference(state, port)
    assert port_state.step == 2
    for opt in (port_state.g_opt, port_state.d_opt):
        assert opt.param_groups[0]["lr"] == pytest.approx(
            2e-4 * tt.cosine_decay(6, 0.02)(2))
        assert {float(s["step"]) for s in opt.state.values()} == {2.0}
    r, rm, p, pm = _inpaint_steps(ref, port, state, port_state, images, 1, 40)
    _assert_same(r, p, rm, pm, _outputs(ref, r, p, x4, images))


def _leaves(state):
    out = [v for net in (state.g, state.d) for v in net.state_dict().values()]
    for opt in (state.g_opt, state.d_opt):
        for s in opt.state_dict()["state"].values():
            out += [s[k] for k in sorted(s)]
    return out


@pytest.mark.parametrize("total_steps", [0, 10])
def test_checkpoint_roundtrip(tmp_path, rng, total_steps):
    """``test_dp_training.py``'s round trip as a ``torch.save`` file: the
    networks, both optimisers' moments and counts and the step bit-exact,
    the template untouched, and training resumes from the restored
    state as from the saved one."""
    port = tt.InpaintGANTrainer(
        tt.InpaintTrainConfig(compute_dtype="float32",
                              total_steps=total_steps),
        generator=tu.InpaintUNet(**G_SMALL),
        discriminator=tu.PatchDiscriminator(**D_INPAINT), device="cpu")
    img = torch.from_numpy(rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32))
    state = port.init(img, torch.Generator().manual_seed(0))
    template = port.init(img, torch.Generator().manual_seed(9))
    before = [t.clone() for t in _leaves(template)]
    state, _ = port.train_step(state, img, torch.Generator().manual_seed(1))
    path = str(tmp_path / "ckpt.pt")
    tt.save_checkpoint(path, state)
    back = tt.restore_checkpoint(path, template)
    assert back.step == state.step == 1
    for a, b in zip(_leaves(state), _leaves(back)):
        assert torch.equal(a, b)
    for a, b in zip(before, _leaves(template)):
        assert torch.equal(a, b)
    if total_steps:
        assert back.g_opt.param_groups[0]["lr"] == \
            state.g_opt.param_groups[0]["lr"]
    s1, m1 = port.train_step(state, img, torch.Generator().manual_seed(2))
    s2, m2 = port.train_step(back, img, torch.Generator().manual_seed(2))
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    assert np.isfinite(float(m2["g_loss"]))


def test_make_sr_pairs_matches_reference(rng):
    images = rng.uniform(0, 1, (2, 30, 27, 3)).astype(np.float32)
    lr, hr = tt.make_sr_pairs(torch.from_numpy(images), 4)
    jlr, jhr = jt.make_sr_pairs(jnp.asarray(images), 4)
    assert lr.shape == jlr.shape == (2, 7, 6, 3)
    np.testing.assert_array_equal(hr.numpy(), np.asarray(jhr))
    np.testing.assert_allclose(lr.numpy(), np.asarray(jlr), atol=1e-6, rtol=0)


def test_init_draws_and_devices():
    """``init`` draws each network anew from the generator (biases 0);
    the trainers default to the card; a bad ``compute_dtype`` raises."""
    port = tt.SRGANTrainer(generator=tu.SRUNet(**G_SMALL),
                           discriminator=tu.PatchDiscriminator(**D_SR),
                           device="cpu")
    a = port.init(None, torch.Generator().manual_seed(3))
    b = port.init(None, torch.Generator().manual_seed(3))
    c = port.init(None, torch.Generator().manual_seed(4))
    assert torch.equal(a.g.head.weight, b.g.head.weight)
    assert not torch.equal(a.g.head.weight, c.g.head.weight)
    assert a.g is not port.gen
    assert float(a.g.head.bias.detach().abs().max()) == 0.0
    assert tt.SRGANTrainer().device == torch.device("cuda")
    assert tt.InpaintGANTrainer().device == torch.device("cuda")
    with pytest.raises(ValueError):
        tt.SRGANTrainer(tt.SRTrainConfig(compute_dtype="float16"))
