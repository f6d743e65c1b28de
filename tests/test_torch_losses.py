"""The port's training losses (``pcmi_tpu_torch.models.losses``) against
``pcmi_tpu.models.losses`` on the CPU.

Inputs are numpy draws from a seed. Tolerances: every loss within 1e-6
of the reference's, its gradient with respect to the prediction within
1e-5; the ring and hole masks bit-exact (the hole masks from the
reference's own ``jax.random`` draws, fed to ``grow_hole_masks``). The
reference's cases (``tests/test_models.py``) are mirrored at the port's
surface.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pcmi_tpu.models import losses as jl
from pcmi_tpu_torch.models import losses as tl

torch.set_num_threads(1)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _inputs(rng, b=2, h=20, w=24, c=3):
    pred = rng.uniform(0, 1, (b, h, w, c)).astype(np.float32)
    target = rng.uniform(0, 1, (b, h, w, c)).astype(np.float32)
    mask = np.zeros((b, h, w, 1), np.float32)
    mask[0, 4:11, 6:15] = 1.0
    mask[1, 12:18, 2:9] = 1.0
    return pred, target, mask


def _check(ref_fn, port_fn, pred, *rest):
    """Value within 1e-6 and d/d(pred) within 1e-5 of the reference's."""
    ref, ref_g = jax.value_and_grad(
        lambda p: ref_fn(p, *map(jnp.asarray, rest)))(jnp.asarray(pred))
    p = _t(pred, True)
    got = port_fn(p, *map(_t, rest))
    (g,) = torch.autograd.grad(got, p)
    got = float(got.detach())
    assert abs(got - float(ref)) <= 1e-6, (got, float(ref))
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("name", ["masked_l1", "gradient_l1", "mixge_loss",
                                  "residual_inpaint_loss"])
def test_reconstruction_losses(rng, name):
    pred, target, mask = _inputs(rng)
    if name == "masked_l1":
        _check(jl.masked_l1, tl.masked_l1, pred, target, mask)
        # a 3-channel mask counts each channel once
        m3 = np.repeat(mask, 3, -1)
        _check(jl.masked_l1, tl.masked_l1, pred, target, m3)
    elif name == "gradient_l1":
        _check(jl.gradient_l1, tl.gradient_l1, pred, target)
    elif name == "mixge_loss":
        _check(jl.mixge_loss, tl.mixge_loss, pred, target)
    else:
        _check(lambda *a: jl.residual_inpaint_loss(*a)[0],
               lambda *a: tl.residual_inpaint_loss(*a)[0],
               pred, target, mask)
        ref = jl.residual_inpaint_loss(*map(jnp.asarray, (pred, target, mask)),
                                       0.3, 0.7, 2)[1]
        got = tl.residual_inpaint_loss(*map(_t, (pred, target, mask)),
                                       0.3, 0.7, 2)[1]
        assert set(got) == set(ref) == {"hole_l1", "grad", "ring"}
        for k in ref:
            assert abs(float(got[k]) - float(ref[k])) <= 1e-6, k


def test_hinge_losses(rng):
    real = rng.normal(0, 1.5, (2, 5, 6, 1)).astype(np.float32)
    fake = rng.normal(0, 1.5, (2, 5, 6, 1)).astype(np.float32)
    _check(lambda f, r: jl.hinge_d_loss(r, f),
           lambda f, r: tl.hinge_d_loss(r, f), fake, real)
    _check(lambda r, f: jl.hinge_d_loss(r, f),
           lambda r, f: tl.hinge_d_loss(r, f), real, fake)
    _check(jl.hinge_g_loss, tl.hinge_g_loss, fake)


@pytest.mark.parametrize("width", [1, 2, 4])
def test_boundary_ring_mask(rng, width):
    mask = (rng.uniform(0, 1, (2, 17, 23, 1)) > 0.93).astype(np.float32)
    mask[:, :3, :3] = 1.0  # a hole at the corner: the window's -inf pad
    for m in (mask, mask[..., 0]):
        ref = np.asarray(jl.boundary_ring_mask(jnp.asarray(m), width))
        got = tl.boundary_ring_mask(_t(m), width).numpy()
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        tl.boundary_ring_mask(_t(mask[0, ..., 0]), width)


def _reference_draws(key, shape, n_seeds, steps, p_grow):
    """``random_hole_masks``' own draws from ``key``."""
    b, h, w = shape
    k1, k2 = jax.random.split(key)
    sy = jax.random.randint(k1, (b, n_seeds), h // 8, 7 * h // 8)
    sx = jax.random.randint(k2, (b, n_seeds), w // 8, 7 * w // 8)
    keys = jax.random.split(jax.random.fold_in(key, 7), steps)
    keeps = [np.asarray(jax.random.uniform(k, (b, h, w)) < p_grow)
             for k in keys]
    return (torch.from_numpy(np.array(sy)), torch.from_numpy(np.array(sx)),
            [torch.from_numpy(k) for k in keeps])


@pytest.mark.parametrize("shape,n_seeds,steps", [((2, 64, 64), 4, 8),
                                                 ((3, 40, 56), 6, 10)])
def test_grow_hole_masks_matches_reference(shape, n_seeds, steps):
    key = jax.random.PRNGKey(sum(shape))
    ref = np.asarray(jl.random_hole_masks(key, shape, n_seeds, steps))
    got = tl.grow_hole_masks(shape, *_reference_draws(key, shape, n_seeds,
                                                      steps, 0.7))
    assert got.shape == ref.shape == shape + (1,)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_random_hole_masks_connected_and_seeded():
    """``test_models.py``'s case with the port's draw; the same generator
    seed gives the same masks."""
    m = tl.random_hole_masks(torch.Generator().manual_seed(1), (2, 64, 64),
                             n_seeds=4, steps=8, device="cpu")
    assert m.shape == (2, 64, 64, 1)
    frac = m.numpy().mean(axis=(1, 2, 3))
    assert (frac > 0.002).all() and (frac < 0.5).all()
    again = tl.random_hole_masks(torch.Generator().manual_seed(1),
                                 (2, 64, 64), n_seeds=4, steps=8,
                                 device="cpu")
    assert torch.equal(m, again)
    assert set(np.unique(m.numpy())) <= {0.0, 1.0}


def test_losses_behave(rng):
    """``test_models.py``'s case at the port's surface."""
    pred = torch.from_numpy(rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32))
    target = pred + 0.1
    mask = torch.zeros((2, 16, 16, 1))
    mask[:, 4:8, 4:8] = 1.0
    assert abs(float(tl.masked_l1(pred, target, mask)) - 0.1) < 1e-5
    total, parts = tl.residual_inpaint_loss(pred, target, mask)
    assert float(total) > 0 and set(parts) == {"hole_l1", "grad", "ring"}
    ring = tl.boundary_ring_mask(mask, width=2)
    assert float((ring * mask).sum()) == 0 and float(ring.sum()) > 0
    assert float(tl.mixge_loss(pred, target)) > 0
    assert float(tl.hinge_d_loss(torch.full((4,), 2.0),
                                 torch.full((4,), -2.0))) == 0
    assert float(tl.hinge_g_loss(torch.full((4,), 3.0))) == -3.0
