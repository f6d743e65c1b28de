"""The port's matcher (pcmi_tpu_torch.ops.stereo) against pcmi_tpu on the CPU.

Inputs are made with numpy from a seed and fed to both packages. Pallas
kernels run in interpret mode, as tests/test_pallas_kernels.py runs them.
On the CPU the port's kernel wrappers run their plain versions.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pcmi_tpu.config import StereoConfig
from pcmi_tpu.ops.stereo import matching as jm
from pcmi_tpu.ops.stereo import pallas_kernels as jpk
from pcmi_tpu_torch.convert import config_from_reference as _c
from pcmi_tpu_torch.ops.stereo import kernels as K
from pcmi_tpu_torch.ops.stereo import matching as tm

torch.set_num_threads(1)

# WTA tolerances: argmin indices exact, disparity 1e-5 px, costs 1e-6
DISP_TOL, COST_TOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _np(t):
    return t.numpy()


@pytest.mark.parametrize("window", [3, 5, 7])
def test_census_planes_exact(rng, window):
    # quantised values make many equal neighbours (the strict < matters)
    img = (rng.integers(0, 8, (24, 40)) / 8.0).astype(np.float32)
    ref = jm.census_transform(jnp.asarray(img), window)
    got = tm.census_transform(_t(img), window)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(_np(g).astype(np.int64),
                                      np.asarray(r).astype(np.int64))


@pytest.mark.parametrize("k", [1, 3, 9, 15])
def test_sliding_sum_and_box_edge(rng, k):
    img = rng.uniform(0, 1, (21, 34)).astype(np.float32)
    padded = rng.uniform(0, 1, (21 + k - 1, 34)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tm._sliding_sum(_t(padded), k, 0, 21)),
        np.asarray(jm._sliding_sum(jnp.asarray(padded), k, 0, 21)),
        atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(tm._box_edge(_t(img), k)),
                               np.asarray(jm._box_edge(jnp.asarray(img), k)),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("stride", [1, 2])
def test_build_cost_volume(rng, stride):
    left = rng.uniform(0, 1, (24, 40)).astype(np.float32)
    right = np.roll(left, 3, axis=1) + rng.normal(0, 0.02, left.shape)
    right = right.astype(np.float32)
    vl = rng.uniform(0, 1, left.shape) > 0.1
    vr = rng.uniform(0, 1, left.shape) > 0.1
    # D = 48 / stride: the port's 16-disparity chunks end mid-volume at
    # stride 2 and on a chunk boundary at stride 1
    cfg = StereoConfig(max_disp=48, block_size=9, census_window=5,
                       disp_stride=stride, cost_dtype="float32")
    ref = jm.build_cost_volume(jnp.asarray(left), jnp.asarray(right),
                               jnp.asarray(vl), jnp.asarray(vr), cfg)
    got = tm.build_cost_volume(_t(left), _t(right), _t(vl), _t(vr), _c(cfg))
    assert got.shape == ref.shape
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("dirs", ["4", "h", "v"])
def test_sgm_plain_matches_xla_scan(rng, dirs):
    """Plain sgm_dir pairs vs the XLA scan: <= 1e-4 (measured bit-exact)."""
    vol = rng.uniform(0, 1, (20, 19, 33)).astype(np.float32)
    cfg = StereoConfig(max_disp=32, sgm_backend="xla")
    ref = np.asarray(jm.sgm_aggregate(jnp.asarray(vol), cfg, dirs=dirs))
    got = _np(tm.sgm_aggregate(_t(vol), _c(cfg), dirs=dirs))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_sgm_plain_matches_pallas_sub(rng):
    vol = rng.uniform(0, 1, (16, 24, 40)).astype(np.float32)
    cfg = StereoConfig(max_disp=16)
    ref = np.asarray(jpk.sgm_aggregate_pallas_sub(
        jnp.asarray(vol), cfg.sgm_p1, cfg.sgm_p2, band=8, chunk=8))
    got = _np(tm.sgm_aggregate(_t(vol), _c(cfg)))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def _wta_volume(rng):
    vol = rng.uniform(0.2, 1.0, (24, 40, 128)).astype(np.float32)
    vol[0, :8] = 0.01          # argmin on the lower boundary
    vol[23, 8:16] = 0.01       # argmin on the upper boundary
    vol[5, 20:] = vol[9, 20:]  # ties across disparities
    return vol


@pytest.mark.parametrize("stride", [1, 2])
def test_wta_plain_matches_xla_and_pallas(rng, stride):
    vol = _wta_volume(rng)
    v = jnp.asarray(vol)
    for sub in (True, False):
        d0, b0, m0 = jm.wta_disparity(v, -12, with_margin=True, subpixel=sub,
                                      stride=stride, backend="xla")
        d1, b1, m1 = jpk.wta_fused_pallas(v, -12, stride=stride,
                                          subpixel=sub)
        got = tm.wta_disparity(_t(vol), -12, with_margin=True, subpixel=sub,
                               stride=stride)
        for ref in ((d0, b0, m0), (d1, b1, m1)):
            if not sub:  # integer disparities: the argmin indices, exact
                np.testing.assert_array_equal(_np(got[0]), np.asarray(ref[0]))
            np.testing.assert_allclose(_np(got[0]), np.asarray(ref[0]),
                                       atol=DISP_TOL, rtol=0)
            np.testing.assert_allclose(_np(got[1]), np.asarray(ref[1]),
                                       atol=COST_TOL, rtol=0)
            np.testing.assert_allclose(_np(got[2]), np.asarray(ref[2]),
                                       atol=COST_TOL, rtol=0)


@pytest.mark.parametrize("stride,d_min", [(1, -8)])
def test_fused_left_matches_sgm4_wta_pallas(rng, stride, d_min):
    """4 sgm_dir launches + wta((h + v) * 0.25) vs sgm4_wta_fused_pallas."""
    vol = rng.uniform(0, 1, (16, 24, 40)).astype(np.float32)
    cfg = StereoConfig(max_disp=16)
    ref = jpk.sgm4_wta_fused_pallas(jnp.asarray(vol), cfg.sgm_p1, cfg.sgm_p2,
                                    d_min, stride=stride, band=8, chunk=8)
    t = _t(vol)
    h = K.sgm_pair(t, cfg.sgm_p1, cfg.sgm_p2, horizontal=True)
    v = K.sgm_pair(t, cfg.sgm_p1, cfg.sgm_p2, horizontal=False)
    got = K.wta(h, v, 0.25, d_min, stride, subpixel=True, with_margin=True)
    np.testing.assert_allclose(_np(got[0]), np.asarray(ref[0]),
                               atol=DISP_TOL, rtol=0)
    np.testing.assert_allclose(_np(got[1]), np.asarray(ref[1]),
                               atol=COST_TOL, rtol=0)
    np.testing.assert_allclose(_np(got[2]), np.asarray(ref[2]),
                               atol=COST_TOL, rtol=0)
    # integer argmin == the reference's argmin of the combined aggregate
    idx = K.wta(h, v, 0.25, d_min, stride, subpixel=False)[0]
    agg = jm.sgm_aggregate(jnp.asarray(vol),
                           StereoConfig(max_disp=16, sgm_backend="xla"))
    np.testing.assert_array_equal(
        _np(idx), d_min + stride * np.asarray(jnp.argmin(agg, axis=0),
                                              np.float32))


@pytest.mark.parametrize("shape,stride,d_min", [((16, 24, 40), 1, 0),
                                                ((16, 19, 33), 2, -4)])
def test_wta_with_aggregate_matches_pallas(rng, shape, stride, d_min):
    """K2's fourth output S against sgm4_wta_fused_pallas(with_aggregate=
    True), cropped and moved to (D, H, W): <= 1e-4 (sums of four SGM
    directions); disp, best and margin are unchanged by the flag, exact."""
    d, h, w = shape
    vol = rng.uniform(0, 1, shape).astype(np.float32)
    cfg = StereoConfig(max_disp=16)
    ref = jpk.sgm4_wta_fused_pallas(
        jnp.asarray(vol), cfg.sgm_p1, cfg.sgm_p2, d_min, stride=stride,
        band=8, chunk=8, with_aggregate=True)
    assert len(ref) == 4
    s_ref = np.transpose(np.asarray(ref[3])[:w, :d, :h], (1, 2, 0))
    t = _t(vol)
    hz = K.sgm_pair(t, cfg.sgm_p1, cfg.sgm_p2, horizontal=True)
    vt = K.sgm_pair(t, cfg.sgm_p1, cfg.sgm_p2, horizontal=False)
    got = K.wta(hz, vt, 0.25, d_min, stride, with_aggregate=True)
    assert len(got) == 4 and got[3].shape == t.shape
    np.testing.assert_allclose(_np(got[3]), s_ref, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(_np(got[3]), _np((hz + vt) * 0.25))
    base = K.wta(hz, vt, 0.25, d_min, stride)
    assert len(base) == 3
    for g, r in zip(got[:3], base):
        np.testing.assert_array_equal(_np(g), _np(r))
    np.testing.assert_allclose(_np(got[0]), np.asarray(ref[0]),
                               atol=DISP_TOL, rtol=0)
    with pytest.raises(ValueError, match="with_aggregate"):
        K.wta(hz, None, 0.5, d_min, stride, with_aggregate=True)


@pytest.mark.parametrize("d_min,stride", [(-6, 1), (3, 1), (-8, 2), (2, 2),
                                          (9, 1), (-14, 2), (12, 1),
                                          (-40, 2)])
def test_diag_right_disparity_exact(rng, d_min, stride):
    """The diagonal argmin against diag_right_disparity_wdh on the same S,
    exact: d_min of both signs, stride 1 and 2, ranges that exclude every
    candidate of some pixels (9, -14) and of every pixel (12, -40)."""
    d, h, w = 6, 5, 12
    s = rng.uniform(0, 1, (d, h, w)).astype(np.float32)
    s[2, :, 3:6] = s[4, :, 3:6] = 0.0     # ties: the lowest i wins
    ref = np.asarray(jm.diag_right_disparity_wdh(
        jnp.asarray(np.transpose(s, (2, 0, 1))), d_min, d, h, w,
        stride=stride))
    got = _np(tm.diag_right_disparity(_t(s), d_min, stride))
    np.testing.assert_array_equal(got, ref)
    if d_min in (9, -14, 12, -40):
        xs = np.arange(w)[None, :] + d_min + stride * np.arange(d)[:, None]
        dead = ~((xs >= 0) & (xs < w)).any(0)
        assert dead.any() and (got[:, dead] == d_min).all()
        assert dead.all() == (d_min in (12, -40))


def test_diagonal_equals_derived(rng):
    """right_sgm="diagonal" (K2's aggregate + the diagonal argmin) gives
    the fields of "derived" (combine pass + derive + second WTA), exact."""
    left, right, vl, vr = _small_pair(rng)
    args = [_t(a) for a in (left, right, vl, vr)]
    res = {}
    for mode in ("derived", "diagonal"):
        cfg = StereoConfig(max_disp=16, block_size=5, census_window=5,
                           cost_dtype="float32", right_sgm=mode)
        res[mode] = tm.compute_disparity(*args, _c(cfg))
    for f, a in res["derived"]._asdict().items():
        b = getattr(res["diagonal"], f)
        if a is None:
            assert b is None, f
        else:
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=f)


@pytest.mark.parametrize("shape,stride", [((16, 19, 33), 2)])
def test_fused_right_matches_pallas(rng, shape, stride):
    """derive -> 2 horizontal sgm_dir -> argmin vs
    right_disparity_fused_pallas: exact."""
    vol = rng.uniform(0, 1, shape).astype(np.float32)
    cfg = StereoConfig(max_disp=16)
    d_min = cfg.min_disparity
    ref = jpk.right_disparity_fused_pallas(
        jnp.asarray(vol), cfg.sgm_p1, cfg.sgm_p2, d_min, stride=stride,
        band=8, chunk=8)
    vr = K.derive_right(_t(vol), d_min, fill=1.0, stride=stride)
    hr = K.sgm_pair(vr, cfg.sgm_p1, cfg.sgm_p2, horizontal=True)
    got = K.wta(hr, None, 0.5, d_min, stride, subpixel=False,
                with_margin=False)[0]
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


@pytest.mark.parametrize("d_min,stride,fill", [(-4, 1, 1.0), (-8, 2, 1e4),
                                               (0, 1, 1.0)])
def test_derive_right_exact(rng, d_min, stride, fill):
    vol = rng.uniform(0, 1, (8, 20, 140)).astype(np.float32)
    got = _np(tm.derive_right_volume(_t(vol), d_min, fill=fill,
                                     stride=stride))
    np.testing.assert_array_equal(got, np.asarray(jm.derive_right_volume(
        jnp.asarray(vol), d_min, fill=fill, stride=stride)))
    np.testing.assert_array_equal(got, np.asarray(jpk.derive_right_pallas(
        jnp.asarray(vol), d_min, fill=fill, stride=stride)))


@pytest.mark.parametrize("stride", [1, 2])
def test_lr_consistency_exact(rng, stride):
    h, w = 20, 64
    dl = rng.uniform(-14, 14, (h, w)).astype(np.float32)
    dl[0, :5] = [-40.0, 40.0, -8.5, 7.5, 0.5]   # out of range, ties at .5
    dr = (np.round(dl) + rng.normal(0, 1.0, (h, w))).astype(np.float32)
    args = dict(thresh=1.5, d_min=-16, d_max=15, stride=stride)
    ref = np.asarray(jm.lr_consistency(jnp.asarray(dl), jnp.asarray(dr),
                                       **args))
    got = _np(tm.lr_consistency(_t(dl), _t(dr), **args))
    np.testing.assert_array_equal(got, ref)
    assert 0.05 < got.mean() < 0.95


def _small_pair(rng):
    """A small textured pair at disparity +4 with noise and a masked left
    border, as numpy arrays."""
    from pcmi_tpu.ops.filters import gaussian_filter

    h, w = 48, 96
    tex = np.asarray(gaussian_filter(
        jnp.asarray(rng.uniform(0, 1, (h, w + 16)).astype(np.float32)), 1.0))
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    left = tex[:, 8:8 + w].astype(np.float32)
    right = tex[:, 4:4 + w].astype(np.float32)        # disparity +4
    right = right + rng.normal(0, 0.01, right.shape).astype(np.float32)
    vl = np.ones((h, w), bool)
    vl[:, :3] = False
    vr = np.ones((h, w), bool)
    return left, right, vl, vr


def _assert_results_agree(got, ref, right_tol=0.0):
    np.testing.assert_array_equal(_np(got.valid), np.asarray(ref.valid))
    for f in ("disparity", "check_disparity"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(ref, f)), atol=1e-4,
                                   rtol=0, err_msg=f)
    np.testing.assert_allclose(_np(got.disparity_right),
                               np.asarray(ref.disparity_right),
                               atol=right_tol, rtol=0)
    for f in ("cost", "margin", "check_margin"):
        if getattr(ref, f) is None:
            assert getattr(got, f) is None, f
            continue
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(ref, f)), atol=1e-5,
                                   rtol=0, err_msg=f)


def test_compute_disparity_small_pair(rng):
    """The whole matcher on a small textured pair (census checker on, noise
    adaptation on): disparities, costs and masks against pcmi_tpu."""
    left, right, vl, vr = _small_pair(rng)
    cfg = StereoConfig(max_disp=16, block_size=5, census_window=5,
                       cost_dtype="float32", sgm_backend="xla")
    ref = jm.compute_disparity(jnp.asarray(left), jnp.asarray(right),
                               jnp.asarray(vl), jnp.asarray(vr), cfg)
    got = tm.compute_disparity(_t(left), _t(right), _t(vl), _t(vr), _c(cfg))
    _assert_results_agree(got, ref)
    assert got.valid.float().mean() > 0.5
    refined = tm.refine_disparity(got, _t(left), _c(cfg))
    ref_refined = jm.refine_disparity(ref, jnp.asarray(left), cfg)
    np.testing.assert_array_equal(_np(refined.valid),
                                  np.asarray(ref_refined.valid))
    np.testing.assert_allclose(_np(refined.disparity),
                               np.asarray(ref_refined.disparity), atol=1e-4,
                               rtol=0)


_VARIANTS = {
    "derived": (dict(right_sgm="derived"), "sgm"),
    "diagonal": (dict(right_sgm="diagonal"), "sgm"),
    "full": (dict(right_sgm="full"), "sgm"),
    "right_subpixel": (dict(right_subpixel=True), "sgm"),
    "box": ({}, "box"),
    "vertical": (dict(band_check_mode="vertical"), "sgm"),
}


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_compute_disparity_variants(rng, variant):
    """Each ported matcher variant against pcmi_tpu's scan backend on the
    small pair, with test_compute_disparity_small_pair's tolerances (the
    right view's parabola within 1e-4 px)."""
    kw, aggregation = _VARIANTS[variant]
    left, right, vl, vr = _small_pair(rng)
    cfg = StereoConfig(max_disp=16, block_size=5, census_window=5,
                       cost_dtype="float32", sgm_backend="xla", **kw)
    ref = jm.compute_disparity(jnp.asarray(left), jnp.asarray(right),
                               jnp.asarray(vl), jnp.asarray(vr), cfg,
                               aggregation=aggregation)
    got = tm.compute_disparity(_t(left), _t(right), _t(vl), _t(vr), _c(cfg),
                               aggregation=aggregation)
    _assert_results_agree(got, ref,
                          right_tol=1e-4 if cfg.right_subpixel else 0.0)
    assert got.valid.float().mean() > 0.5


def test_cost_dtype_bfloat16_refused(rng):
    """The reference stores the aggregated volume and runs the WTA in
    bfloat16 under cost_dtype="bfloat16" on every backend, which changes its
    disparities on the small pair; the port's kernels are float32-only, so
    it refuses that config. "float32" and "auto" run and equal the
    reference's float32 result."""
    left, right, vl, vr = _small_pair(rng)
    args = [jnp.asarray(a) for a in (left, right, vl, vr)]
    base = StereoConfig(max_disp=16, block_size=5, census_window=5,
                        sgm_backend="xla")
    cfg = {d: dataclasses.replace(base, cost_dtype=d)
           for d in ("float32", "bfloat16", "auto")}
    r32 = jm.compute_disparity(*args, cfg["float32"])
    r16 = jm.compute_disparity(*args, cfg["bfloat16"])
    # measured: 43 pixels move by more than 0.01 px, the largest by 5.6 px
    diff = np.abs(np.asarray(r32.disparity) - np.asarray(r16.disparity))
    assert (diff > 0.01).sum() >= 10 and diff.max() > 1.0
    targs = [_t(a) for a in (left, right, vl, vr)]
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tm.compute_disparity(*targs, _c(cfg["bfloat16"]))
    for d in ("float32", "auto"):
        _assert_results_agree(tm.compute_disparity(*targs, _c(cfg[d])), r32)


def test_compute_disparity_rejects_unported_variants():
    z = torch.zeros(8, 8)
    v = torch.ones(8, 8, dtype=torch.bool)
    for kw in (dict(hierarchical=True), dict(adapt_band_rows=64)):
        with pytest.raises(NotImplementedError):
            tm.compute_disparity(z, z, v, v,
                                 _c(StereoConfig(max_disp=96, **kw)))
