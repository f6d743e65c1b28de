"""``reference_draws.npz`` (``python3 train_probe.py export``) against the
reference benches' own draws on the CPU.

``chip_smoke.py`` trains on ``bench_generative``'s pool and scores the
port on the benches' held-out sets through this file: the scene seeds
must be the ones ``bench_generative._batch`` draws (the scenes are then
the same numpy draws, bit for bit), the hole masks those of
``random_hole_masks`` at the bench's keys (exact), the Jacobi prefill's
in-hole PSNR on each set the reference's within 1e-4 dB (the seed mean
sums in another order), and ``bench_detector``'s 64 held-out scenes,
rendered by the port from the stored draws, the reference's own (images
within 1e-6, boxes and their validity exact); and ``bench_diffusion``'s
pool and held-out scene seeds for its seeds 0-2, whose styled scenes the
port draws bit for bit as the reference does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from bench_generative import _batch
from pcmi_tpu.models.detector import synthesize_obb_batch
from pcmi_tpu.models.losses import random_hole_masks
from pcmi_tpu.models.metrics import psnr as jpsnr
from pcmi_tpu.pipelines.generative import diffusion_prefill
from pcmi_tpu_torch.models.metrics import psnr
from pcmi_tpu_torch.models.scenes import scene_batch
from pcmi_tpu_torch.ops.filters import masked_jacobi_fill_batch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def draws():
    return cs.reference_draws()


def _seeds(key, n):
    return [int(jax.random.randint(k, (), 0, 2**31 - 1))
            for k in jax.random.split(key, n)]


def test_pool_and_sr_seeds_match_reference(draws):
    assert draws["inpaint_pool_seeds"].tolist() == _seeds(
        jax.random.PRNGKey(0), 48)
    assert draws["sr_eval_seeds"].tolist() == _seeds(
        jax.random.PRNGKey(50_000), 8)
    np.testing.assert_array_equal(
        scene_batch(draws["sr_eval_seeds"][:2], 96, "cpu").numpy(),
        np.asarray(_batch(jax.random.PRNGKey(50_000), 8, 96))[:2])


@pytest.mark.parametrize("es", [0, 1, 2])
def test_inpaint_eval_set_matches_reference(draws, es):
    imgs, mask = cs.inpaint_eval_sets(draws, "cpu")[es]
    want = _batch(jax.random.PRNGKey(60_000 + 97 * es), 8, 96)
    want_mask = random_hole_masks(jax.random.PRNGKey(61_000 + 97 * es),
                                  (8, 96, 96), 6, 10)
    np.testing.assert_array_equal(imgs.numpy(), np.asarray(want))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    pre = masked_jacobi_fill_batch(imgs, mask[..., 0], 128)
    want_pre = jnp.stack([diffusion_prefill(want[i], want_mask[i, ..., 0] > 0.5)
                          for i in range(8)])
    assert abs(float(psnr(pre, imgs, mask=mask))
               - float(jpsnr(want_pre, want, mask=want_mask))) <= 1e-4


@pytest.mark.parametrize("batch", [0, 7])
def test_obb_bench_scenes_match_reference(draws, batch):
    key = jax.random.PRNGKey(10_000)
    for _ in range(batch + 1):
        key, sub = jax.random.split(key)
    want = synthesize_obb_batch(sub, 8, 128, hard=True)
    got = list(cs.obb_bench_scenes(draws, "cpu"))[batch]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_diffusion_bench_seeds_match_reference(draws, seed):
    from bench_generative import STYLE_CAPTIONS as REF_CAPTIONS
    from bench_generative import make_styled_scene as ref_styled
    from pcmi_tpu_torch.models.scenes import (
        STYLE_CAPTIONS, make_styled_scene)

    assert STYLE_CAPTIONS == REF_CAPTIONS
    kf, ku = jax.random.split(jax.random.PRNGKey(seed))
    pool = draws["diffusion_pool_seeds"][seed]
    held = draws["diffusion_eval_seeds"][seed]
    assert pool[0].tolist() == _seeds(kf, 24)
    assert pool[1].tolist() == _seeds(ku, 24)
    keys = [jax.random.PRNGKey(90_000 + seed + i) for i in range(2)]
    assert held.tolist() == [int(jax.random.randint(k, (), 0, 2**31 - 1))
                             for k in keys]
    for got_seed, key, style in (
            (pool[0][0], jax.random.split(kf, 24)[0], "fields"),
            (pool[1][23], jax.random.split(ku, 24)[23], "urban"),
            (held[0], keys[0], "fields"), (held[1], keys[1], "urban")):
        np.testing.assert_array_equal(make_styled_scene(int(got_seed), style),
                                      np.asarray(ref_styled(key, style)))
