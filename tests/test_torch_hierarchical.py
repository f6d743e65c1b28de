"""The port's coarse-to-fine matcher against pcmi_tpu on the CPU: the
resampling primitives, ``compute_disparity_hierarchical`` and ``pair_core``
with ``hierarchical=True``.

Inputs are made with numpy from a seed and fed to both packages. The
reference's ``jax.image.resize`` and its shift scans run as fused
multiply-adds on the CPU and its 2x2 mean as a row-major sum; the port
computes them the same way on the CPU (``mul_add``, ``cell_sum``), so the
primitives agree bit for bit here (measured); the tests hold the
multiply-add forms to 1e-6, in case another CPU's compiler fuses
otherwise.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pcmi_tpu.config import StereoConfig
from pcmi_tpu.ops.stereo import hierarchical as jhh
from pcmi_tpu_torch import config as tconfig
from pcmi_tpu_torch.convert import config_from_reference as _c
from pcmi_tpu_torch.geometry.synthetic import (
    aoi_lonlat_ranges, make_stereo_scene)
from pcmi_tpu_torch.ops.stereo import hierarchical as th
from pcmi_tpu_torch.ops.stereo import kernels as K
from pcmi_tpu_torch.pipelines.height_map import HeightMapPipeline

from test_torch_banded import compare_pair_core, shifted_pair

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(31, 45), (32, 48), (30, 44)])
def test_down2_up2(rng, shape):
    img = rng.uniform(0, 1, shape).astype(np.float32)
    np.testing.assert_array_equal(th._down2(_t(img)).numpy(),
                                  np.asarray(jhh._down2(jnp.asarray(img))))
    small = rng.uniform(-5, 5, (shape[0] // 2, shape[1] // 2)).astype(
        np.float32)
    ref = np.asarray(jhh._up2(jnp.asarray(small), shape))
    got = th._up2(_t(small), shape).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_warp_right_by(rng):
    right = rng.uniform(0, 1, (20, 64)).astype(np.float32)
    base = rng.uniform(-20, 20, (20, 64)).astype(np.float32)
    ref = jhh._warp_right_by(jnp.asarray(right), jnp.asarray(base), -24, 23)
    got = th._warp_right_by(_t(right), _t(base), -24, 23)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)
    # the reference test's case: a constant shift of 5
    img = rng.uniform(0, 1, (32, 64)).astype(np.float32)
    out = th._warp_right_by(_t(img), torch.full((32, 64), 5.0), -16, 16)
    np.testing.assert_allclose(out.numpy()[:, 8:56], img[:, 3:51], atol=1e-5)


@pytest.mark.parametrize("spread", [3.0, 10.0])
def test_resample_right_disp_exact(rng, spread):
    disp = rng.uniform(-spread, spread, (20, 64)).astype(np.float32)
    disp[3, 5] = np.nan
    ref = jhh._resample_right_disp(jnp.asarray(disp), -12, 11)
    got = th._resample_right_disp(_t(disp), -12, 11)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # the reference test's case
    dr, hit = th._resample_right_disp(torch.full((16, 64), 6.0), -16, 16)
    assert hit[:, 8:50].all() and (dr[:, 8:50] == 6.0).all()


@pytest.fixture(scope="module")
def pair():
    """The reference test's pair: background -6 px, a block at +10 px."""
    h, w = 192, 224
    disp = np.full((h, w), -6.0, np.float32)
    disp[60:130, 70:170] = 10.0
    left, right = shifted_pair(7, disp, pad=48)
    return left, right, disp


def test_compute_disparity_hierarchical(pair):
    """Both levels against the reference on the reference test's pair
    (max_disp 48, local window 16): valid masks identical, disparities
    within 1e-4 px (measured max |diff| 9.5e-6 px), right-view disparities
    and margins within 1e-4; and the reference test's accuracy gates."""
    left, right, gt = pair
    cfg = StereoConfig(max_disp=48, block_size=9, census_window=5,
                       speckle_median_size=9, edge_dilation=4)
    v = np.ones(left.shape, bool)
    ref = jhh.compute_disparity_hierarchical(
        *[jnp.asarray(a) for a in (left, right, v, v)], cfg, local_disp=16)
    got = th.compute_disparity_hierarchical(
        *[_t(a) for a in (left, right, v, v)], _c(cfg), local_disp=16)
    jax.block_until_ready(ref.disparity)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    for f in ("disparity", "disparity_right", "margin", "check_disparity",
              "cost"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), atol=1e-4,
                                   rtol=0, err_msg=f)
    assert got.check_margin is None
    d, ok = got.disparity.numpy(), got.valid.numpy()
    assert ok.mean() > 0.5
    interior = np.zeros_like(gt, bool)
    interior[8:-8, 24:-8] = True
    err = np.abs(d - gt)[interior & ok]
    assert np.median(err) < 0.35 and (err < 1.0).mean() > 0.9


def test_compute_disparity_reads_no_dispatch_flag(pair):
    """compute_disparity ignores adapt_band_rows and hierarchical (only
    pair_core dispatches on them, as in the reference): the results equal
    those of the plain config."""
    from pcmi_tpu_torch.ops.stereo.matching import compute_disparity

    left, right, _ = pair
    v = torch.ones(left.shape, dtype=torch.bool)
    args = (_t(left[:64, :96]), _t(right[:64, :96]), v[:64, :96],
            v[:64, :96])
    base = StereoConfig(max_disp=32, block_size=5, census_window=5)
    plain = compute_disparity(*args, _c(base))
    for kw in (dict(hierarchical=True),
               dict(adapt_band_rows=32, adapt_local_disp=32)):
        res = compute_disparity(*args, _c(StereoConfig(
            max_disp=32, block_size=5, census_window=5, **kw)))
        for f, a in plain._asdict().items():
            b = getattr(res, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert torch.equal(a, b), f


def test_pair_core_hierarchical():
    """pair_core with hierarchical=True (strict gates) against the
    reference on the banded tests' rectified pair: valid masks identical,
    disparities and heights within 1e-4 on the valid pixels."""
    cfg = StereoConfig(max_disp=64, block_size=9, census_window=5,
                       hierarchical=True)
    ref, got = compare_pair_core(cfg)
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    v = got["valid"]
    assert v.mean() > 0.2
    for f in ("disparity", "height"):
        np.testing.assert_allclose(got[f][v], ref[f][v], atol=1e-4, rtol=0,
                                   err_msg=f)


@pytest.mark.parametrize("mode", ["hierarchical", "banded"])
def test_process_pair_runs_both_matchers(mode):
    """HeightMapPipeline.process_pair on the port's own small scene with
    each matcher that pair_core dispatches on: a finite product of the
    canvas' shape, some valid pixels, and no kernel launch on the CPU."""
    kw = (dict(hierarchical=True) if mode == "hierarchical" else
          dict(adapt_band_rows=32, adapt_band_cols=64, adapt_local_disp=48))
    cfg = tconfig.PipelineConfig(
        stereo=tconfig.StereoConfig(block_size=9, census_window=5,
                                    margin_undefined=8, **kw),
        rectify=tconfig.RectifyConfig(height_range=(0.0, 40.0)))
    scene = make_stereo_scene(seed=1, out_shape=(96, 96),
                              ground_shape=(128, 128), h_range=(0.0, 40.0),
                              views=((10.0, 80.0), (20.0, 250.0)))
    pipe = HeightMapPipeline(cfg, device="cpu")
    geom = pipe.build_geometry(scene.rpcs[0], scene.rpcs[1],
                               *aoi_lonlat_ranges(scene),
                               tuple(scene.images[0].shape),
                               tuple(scene.images[1].shape))
    K.reset_launches()
    prod = pipe.process_pair(scene.images[0], scene.images[1], geom)
    assert prod.disparity.shape == tuple(geom.out_shape)
    assert torch.isfinite(prod.xyz).all()
    assert 0.02 < prod.valid.float().mean() < 1.0
    assert not any(K.LAUNCHES.values())
