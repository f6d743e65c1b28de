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
from pcmi_tpu_torch import convert
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
        _np(K._sliding_sum(_t(padded), k, 0, 21)),
        np.asarray(jm._sliding_sum(jnp.asarray(padded), k, 0, 21)),
        atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(K._box_edge(_t(img), k)),
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


@pytest.mark.parametrize("cost_dtype", ["float32", "bfloat16"])
def test_build_cost_volume_cell_widths(rng, cost_dtype):
    """The benchmark cells' widths (census 7, block 15, D = 288 at stride 1,
    the signed search from -144) on a small canvas: the CPU volume, K7's
    plain version, against the reference's. float32 within 1e-6; bfloat16
    within one step, at most 0.1% of the elements a step away (see
    test_bf16_build_cost_volume)."""
    left = rng.uniform(0, 1, (22, 64)).astype(np.float32)
    right = (np.roll(left, -9, axis=1)
             + rng.normal(0, 0.02, left.shape)).astype(np.float32)
    vl = rng.uniform(0, 1, left.shape) > 0.1
    vr = rng.uniform(0, 1, left.shape) > 0.1
    cfg = StereoConfig(max_disp=288, block_size=15, census_window=7,
                       disp_stride=1, cost_dtype=cost_dtype)
    assert _c(cfg).min_disparity == -144
    ref = jm.build_cost_volume(*[jnp.asarray(a) for a in
                                 (left, right, vl, vr)], cfg)
    got = tm.build_cost_volume(*[_t(a) for a in (left, right, vl, vr)],
                               _c(cfg))
    assert tuple(got.shape) == ref.shape == (288, 22, 64)
    if cost_dtype == "float32":
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-6,
                                   rtol=0)
    else:
        r, g = _f32(ref), _f32(got)
        assert (r != g).mean() <= 1e-3
        assert (np.abs(r - g) <= _bf16_step(r)).all()


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


def _small_d_volume(rng, D):
    """A (D, 6, 16) volume with minima on both boundaries and next to one,
    a column of ties across every slice and ties on every other pixel of
    another; at D <= 3 some pixels have no slice more than one away from
    their best."""
    vol = rng.uniform(0.2, 1.0, (D, 6, 16)).astype(np.float32)
    vol[0, 0] = 0.01
    vol[D - 1, 1] = 0.01
    vol[min(1, D - 1), 2] = 0.01
    vol[:, 3] = vol[0, 3]
    vol[:, 4, ::2] = vol[D // 2, 4, ::2]
    return vol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [2, 3, 5])
def test_wta_plain_small_d_matches_references(rng, D, dtype):
    """K2's plain version, the card's oracle, at D in {2, 3, 5} (shorter
    than the kernel's 8-slice chunks) against wta_fused_pallas (interpret
    mode) and wta_disparity(backend="xla"), one volume, with and without
    the parabola: integer disparities exact, sub-pixel ones within
    DISP_TOL, best and margin within COST_TOL in float32 and exact in
    bfloat16. Where no slice lies more than one away (every pixel at D = 2)
    the margin is BIG - best with BIG in the volume's dtype (998244352 in
    bfloat16), as in both references."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jv = jnp.asarray(_small_d_volume(rng, D)).astype(jdt)
    tv = convert.tensor_from_reference(jv)
    big = float(jnp.asarray(1e9, jdt).astype(jnp.float32))
    for sub in (True, False):
        got = K.wta(tv, None, 1.0, -3, 2, subpixel=sub, with_margin=True)
        refs = (jm.wta_disparity(jv, -3, with_margin=True, subpixel=sub,
                                 stride=2, backend="xla"),
                jpk.wta_fused_pallas(jv, -3, stride=2, subpixel=sub))
        for ref in refs:
            ref = [np.asarray(r, np.float32) for r in ref]
            if sub:
                np.testing.assert_allclose(_np(got[0]), ref[0],
                                           atol=DISP_TOL, rtol=0)
            else:
                np.testing.assert_array_equal(_np(got[0]), ref[0])
            for g, r in zip(got[1:], ref[1:]):
                if dtype == "bfloat16":
                    np.testing.assert_array_equal(_np(g), r)
                else:
                    np.testing.assert_allclose(_np(g), r, atol=COST_TOL,
                                               rtol=0)
        if D == 2:
            np.testing.assert_array_equal(_np(got[2]), big - _np(got[1]))


def _wta_walk(s, d_min, stride, subpixel, big):
    """csrc/wta.cu's walk over one pixel's combined costs ``s`` (float32):
    one pass keeping the first minimum, its index and neighbours, the
    minimum of s_0..s_{d-2} one step behind and ``far``, the margin's
    candidate minimum (everything left of the best's left neighbour when
    a new best arrives, then every slice but its right neighbour); no
    sorted top-4. Returns (disp, best, margin) as float32."""
    f32 = np.float32
    v1, i1 = f32(np.inf), 0
    prev = nxt = far = lag = last = last2 = f32(big)
    fresh = False
    for d, val in enumerate(s):
        nb = val < v1
        lag = min(lag, last2)
        far = lag if nb else (far if fresh else min(far, val))
        prev = last if nb else prev
        nxt = val if fresh else nxt
        fresh = nb
        v1, i1 = (val, d) if nb else (v1, i1)
        last2, last = last, val
    off = f32(0)
    if subpixel:
        denom = (prev - f32(2) * v1) + nxt
        if denom > f32(1e-9) and 0 < i1 < len(s) - 1:
            off = f32(0.5) * (prev - nxt) / max(denom, f32(1e-9))
        off = min(max(off, f32(-1)), f32(1))
    return f32(d_min) + f32(stride) * (f32(i1) + off), v1, far - v1


@pytest.mark.parametrize("D", [1, 2, 3, 4, 7, 8, 9, 17])
def test_wta_streaming_margin_rule(rng, D):
    """The kernel's one-pass margin rule (``_wta_walk``, as csrc/wta.cu
    walks d) against the plain version's argmin / gather / masked-min form,
    on quantised costs (many ties) and uniform ones, with and without the
    parabola: every output bit-exact."""
    for vol in (rng.integers(0, 4, (D, 2, 24)).astype(np.float32) / 4,
                rng.uniform(0, 1, (D, 2, 24)).astype(np.float32)):
        for sub in (True, False):
            ref = K.wta_plain(_t(vol), None, 1.0, -5, 2, subpixel=sub)
            walked = np.array([_wta_walk(vol[:, y, x], -5, 2, sub, 1e9)
                               for y in range(2) for x in range(24)],
                              np.float32).T.reshape(3, 2, 24)
            for w, r in zip(walked, ref):
                np.testing.assert_array_equal(w, _np(r))


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


# --- cost_dtype="bfloat16": the TPU kernels' stored-dtype mode ---------------
#
# Inputs are rounded once to bfloat16 and the same values go into both
# packages. Stored volumes and argmin indices must be bit-exact; disparity
# within 1e-5 px; best cost and margin within one bfloat16 step of the cost
# (measured: 0 everywhere).


def _bf(rng, shape, lo=0.0, hi=1.0):
    """A seeded volume rounded once to bfloat16, as a JAX array and as the
    port's tensor (the same values)."""
    j = jnp.asarray(rng.uniform(lo, hi, shape).astype(np.float32)).astype(
        jnp.bfloat16)
    return j, convert.tensor_from_reference(j)


def _f32(a):
    """Any array or tensor, bfloat16 ones included, as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_step(x):
    """One bfloat16 step at the magnitude of ``x`` (float32 numpy)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _assert_wta_bf16(got, ref):
    np.testing.assert_allclose(_f32(got[0]), _f32(ref[0]), atol=DISP_TOL,
                               rtol=0)
    for g, r in zip(got[1:3], ref[1:3]):
        assert (np.abs(_f32(g) - _f32(r)) <= _bf16_step(_f32(ref[1]))).all()


@pytest.mark.parametrize("shape", [(16, 24, 40), (20, 19, 33)])
@pytest.mark.parametrize("dirs", ["4", "h", "v"])
def test_bf16_sgm_plain_matches_pallas_sub(rng, dirs, shape):
    """K1's plain version on a bfloat16 volume, forward and accumulate
    (`lr + rl`, `tb + bt`: bfloat16 adds of two stored volumes), and the
    matcher's bfloat16 means around it, against sgm_aggregate_pallas_sub:
    bit-exact, stored as bfloat16."""
    jv, tv = _bf(rng, shape)
    cfg = StereoConfig(max_disp=32, cost_dtype="bfloat16")
    ref = jpk.sgm_aggregate_pallas_sub(jv, cfg.sgm_p1, cfg.sgm_p2, band=8,
                                       chunk=8, dirs=dirs)
    got = tm.sgm_aggregate(tv, _c(cfg), dirs=dirs)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(ref))


@pytest.mark.parametrize("shape,stride,d_min", [((16, 24, 40), 1, -8),
                                                ((16, 19, 33), 2, -4)])
@pytest.mark.parametrize("with_aggregate", [False, True])
def test_bf16_fused_left_matches_sgm4_wta_pallas(rng, with_aggregate, shape,
                                                 stride, d_min):
    """4 sgm_dir + wta((h + v) * 0.25) on a bfloat16 volume against
    sgm4_wta_fused_pallas: `hsum = lr + rl` and `(vert + hsum) * 0.25` in
    bfloat16, WTA in float32. S (bfloat16) bit-exact, the rest as stated
    above."""
    d, h, w = shape
    jv, tv = _bf(rng, shape)
    cfg = StereoConfig(max_disp=16)
    ref = jpk.sgm4_wta_fused_pallas(jv, cfg.sgm_p1, cfg.sgm_p2, d_min,
                                    stride=stride, band=8, chunk=8,
                                    with_aggregate=with_aggregate)
    hz = K.sgm_pair(tv, cfg.sgm_p1, cfg.sgm_p2, horizontal=True)
    vt = K.sgm_pair(tv, cfg.sgm_p1, cfg.sgm_p2, horizontal=False)
    got = K.wta(hz, vt, 0.25, d_min, stride, with_aggregate=with_aggregate)
    assert all(g.dtype == torch.float32 for g in got[:3])
    _assert_wta_bf16(got, ref)
    idx = K.wta(hz, vt, 0.25, d_min, stride, subpixel=False)[0]
    ref_idx = jpk.sgm4_wta_fused_pallas(jv, cfg.sgm_p1, cfg.sgm_p2, d_min,
                                        stride=stride, band=8, chunk=8,
                                        subpixel=False)[0]
    np.testing.assert_array_equal(_f32(idx), _f32(ref_idx))
    if with_aggregate:
        assert got[3].dtype == torch.bfloat16 and ref[3].dtype == jnp.bfloat16
        s_ref = np.transpose(_f32(ref[3])[:w, :d, :h], (1, 2, 0))
        np.testing.assert_array_equal(_f32(got[3]), s_ref)


@pytest.mark.parametrize("stride", [1, 2])
def test_bf16_wta_plain_matches_pallas(rng, stride):
    """K2 on one bfloat16 volume (the checker's form) against
    wta_fused_pallas, ties and boundary minima included."""
    vol = jnp.asarray(_wta_volume(rng)).astype(jnp.bfloat16)
    tv = convert.tensor_from_reference(vol)
    for sub in (True, False):
        ref = jpk.wta_fused_pallas(vol, -12, stride=stride, subpixel=sub)
        got = K.wta(tv, None, 1.0, -12, stride, subpixel=sub)
        if not sub:
            np.testing.assert_array_equal(_f32(got[0]), _f32(ref[0]))
        _assert_wta_bf16(got, ref)


@pytest.mark.parametrize("shape,stride", [((16, 24, 40), 2),
                                          ((16, 19, 33), 2),
                                          ((16, 24, 40), 1)])
def test_bf16_fused_right_matches_pallas(rng, shape, stride):
    """derive -> 2 horizontal sgm_dir -> argmin of `lr + rl` in bfloat16.

    Exact against the reference's unfused chain (derive_right_pallas,
    sgm_aggregate_pallas_sub(dirs="h"), argmin), which
    right_disparity_fused_pallas states bit parity with. Against that
    kernel itself in interpret mode a few pixels differ (measured 4 of 960,
    0 of 627 and 2 of 960 on the three cases): XLA's CPU compiler keeps the
    kernel's `(a + b).astype(float32)` in float32 without rounding the sum
    to bfloat16, which breaks ties of the bfloat16 sum differently. Every
    such pixel must be a tie: the reference's index is also a minimum of
    the bfloat16 sum, and the port's is the lowest."""
    jv, tv = _bf(rng, shape)
    cfg = StereoConfig(max_disp=16)
    d_min = cfg.min_disparity
    vr = K.derive_right(tv, d_min, fill=1.0, stride=stride)
    hr = K.sgm_pair(vr, cfg.sgm_p1, cfg.sgm_p2, horizontal=True)
    got = _f32(K.wta(hr, None, 0.5, d_min, stride, subpixel=False,
                     with_margin=False)[0])
    chain = jpk.sgm_aggregate_pallas_sub(
        jpk.derive_right_pallas(jv, d_min, fill=1.0, stride=stride),
        cfg.sgm_p1, cfg.sgm_p2, band=8, chunk=8, dirs="h")
    np.testing.assert_array_equal(_f32(hr * 0.5), _f32(chain))
    np.testing.assert_array_equal(
        got, d_min + stride * np.asarray(jnp.argmin(chain, axis=0),
                                         np.float32))
    ref = _f32(jpk.right_disparity_fused_pallas(
        jv, cfg.sgm_p1, cfg.sgm_p2, d_min, stride=stride, band=8, chunk=8))
    differ = got != ref
    assert differ.mean() <= 0.01
    col = _f32(hr)
    ref_i = ((ref - d_min) / stride).astype(np.int64)
    at_ref = np.take_along_axis(col, ref_i[None], 0)[0]
    np.testing.assert_array_equal(at_ref, col.min(0))
    assert (got <= ref).all()


@pytest.mark.parametrize("d_min,stride,fill", [(-4, 1, 1.0), (-8, 2, 1e4),
                                               (0, 1, 1.0), (3, 1, 1e4)])
def test_bf16_derive_right_exact(rng, d_min, stride, fill):
    """K3 on a bfloat16 volume: a copy, `fill` cast to bfloat16 (1e4
    becomes 9984), against both reference forms: bit-exact."""
    jv, tv = _bf(rng, (8, 20, 141))
    got = tm.derive_right_volume(tv, d_min, fill=fill, stride=stride)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(jm.derive_right_volume(
        jv, d_min, fill=fill, stride=stride)))
    np.testing.assert_array_equal(_f32(got), _f32(jpk.derive_right_pallas(
        jv, d_min, fill=fill, stride=stride)))
    assert float(got.float().max()) == (9984.0 if fill == 1e4 else 1.0)


def test_bf16_accumulate_rules_differ(rng):
    """The two rules for a second bfloat16 input: K1 adds two STORED
    volumes (the direction is rounded, then the sum), K5's `prev` form adds
    the float32 state and rounds once. On the same volume the two differ
    (measured: 10,602 of 61,440 elements, each by one bfloat16 step), and each
    plain version follows its own reference kernel bit for bit."""
    d, s, lanes = 16, 30, 128
    jv, tv = _bf(rng, (d, s, lanes))
    cfg = StereoConfig(max_disp=16)
    p1, p2 = cfg.sgm_p1, cfg.sgm_p2
    # K1: tb + bt over the (D, H, W) volume
    k1 = K.sgm_pair(tv, p1, p2, horizontal=False)
    ref1 = jpk.sgm_aggregate_pallas_sub(jv, p1, p2, band=8, chunk=8,
                                        dirs="v")
    np.testing.assert_array_equal(_f32(k1 * 0.5), _f32(ref1))
    # K5: the same volume as one band (1, S, D, 128), forward then
    # backward + forward
    jb = jnp.transpose(jv, (1, 0, 2))[None]
    tb = tv.permute(1, 0, 2)[None].contiguous()
    fwd = K.sgm_blocked(tb, p1, p2, reverse=False)
    k5 = K.sgm_blocked(tb, p1, p2, reverse=True, prev=fwd)
    ref5 = jpk._blocked_dir_sum(jb, s // 6, 6, p1, p2)
    assert k5.dtype == torch.bfloat16 and ref5.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_f32(k5), _f32(ref5))
    a, b = _f32(k1), _f32(k5[0].permute(1, 0, 2))
    differ = a != b
    assert differ.mean() >= 0.05
    assert (np.abs(a - b) <= _bf16_step(a)).all()
    # in float32 the two rules are one
    f = tv.float()
    f1 = K.sgm_pair(f, p1, p2, horizontal=False)
    fb = f.permute(1, 0, 2)[None].contiguous()
    f5 = K.sgm_blocked(fb, p1, p2, True,
                       prev=K.sgm_blocked(fb, p1, p2, False))
    np.testing.assert_array_equal(_f32(f1), _f32(f5[0].permute(1, 0, 2)))


def test_bf16_wrappers_dtypes():
    """A wrapper takes float32 or bfloat16, all tensors of one call the
    same, and raises TypeError for anything else and for bfloat16 into K4,
    before anything runs."""
    b = torch.zeros(4, 5, 6, dtype=torch.bfloat16)
    f = torch.zeros(4, 5, 6)
    K.reset_launches()
    for call in (lambda: K.sgm_dir(b, 0.03, 0.48, True, False, out=f),
                 lambda: K.wta(b, f, 1.0, 0),
                 lambda: K.wta(b.half(), None, 1.0, 0),
                 lambda: K.derive_right(b.double(), 0),
                 lambda: K.sgm_hwd(b, 0.03, 0.48, 0, False),
                 lambda: K.sgm_blocked(torch.zeros(1, 4, 8, 128), 0.03, 0.48,
                                       True, prev=torch.zeros(
                                           1, 4, 8, 128,
                                           dtype=torch.bfloat16))):
        with pytest.raises(TypeError):
            call()
    assert K.sgm_dir(b, 0.03, 0.48, True, False).dtype == torch.bfloat16
    assert K.derive_right(b, 1).dtype == torch.bfloat16
    assert not any(K.LAUNCHES.values())


@pytest.mark.parametrize("stride", [1, 2])
def test_bf16_build_cost_volume(rng, stride):
    """The cost volume under cost_dtype="bfloat16": float32 arithmetic,
    one rounding. The port's float32 costs match the reference's within
    1e-6, not bit for bit, so a value next to a rounding midpoint may land
    one bfloat16 step away: at most 0.1% of the elements (measured: 2 of
    73,728 on the small pair), none further."""
    left, right, vl, vr = _small_pair(rng)
    cfg = StereoConfig(max_disp=16, block_size=5, census_window=5,
                       disp_stride=stride, cost_dtype="bfloat16")
    ref = jm.build_cost_volume(*[jnp.asarray(a) for a in
                                 (left, right, vl, vr)], cfg)
    got = tm.build_cost_volume(*[_t(a) for a in (left, right, vl, vr)],
                               _c(cfg))
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert tuple(got.shape) == ref.shape
    r, g = _f32(ref), _f32(got)
    assert (r != g).mean() <= 1e-3
    assert (np.abs(r - g) <= _bf16_step(r)).all()


def _reference_volumes(monkeypatch):
    """Make the port's matcher build its cost volumes with the reference's
    build_cost_volume (carried over exactly), so that a comparison of
    compute_disparity holds everything after the cost volume to bit
    parity."""
    def build(left, right, valid_l, valid_r, cfg, row_shift=None, **kw):
        rcfg = StereoConfig(**dataclasses.asdict(cfg))
        if row_shift is not None:
            kw["row_shift"] = jnp.asarray(row_shift.numpy())
        return convert.tensor_from_reference(jm.build_cost_volume(
            jnp.asarray(left.numpy()), jnp.asarray(right.numpy()),
            jnp.asarray(valid_l.numpy()), jnp.asarray(valid_r.numpy()), rcfg,
            **kw))

    monkeypatch.setattr(tm, "build_cost_volume", build)


def _compare_bf16(rng, monkeypatch, kw, aggregation):
    """compute_disparity under cost_dtype="bfloat16" against the
    reference's TPU branch (sgm_backend="pallas", kernels in interpret
    mode) on the small pair.

    From the images: the two cost volumes differ at a few elements by one
    bfloat16 step (test_bf16_build_cost_volume), so every field must agree
    within _assert_results_agree's tolerances on >= 99% of the pixels
    (measured: all, but for the right view below). From the reference's
    own volumes: every field exact, except the right disparity of the
    fused right view (right_sgm="horizontal" without right_subpixel), where
    the reference's kernel in interpret mode breaks bfloat16 ties
    differently (test_bf16_fused_right_matches_pallas): there <= 0.5% of
    the pixels may differ (measured: 4 of 4,608), and `valid` still
    agrees."""
    left, right, vl, vr = _small_pair(rng)
    cfg = StereoConfig(max_disp=16, block_size=5, census_window=5,
                       cost_dtype="bfloat16", sgm_backend="pallas", **kw)
    ref = jm.compute_disparity(*[jnp.asarray(a) for a in
                                 (left, right, vl, vr)], cfg,
                               aggregation=aggregation)
    targs = [_t(a) for a in (left, right, vl, vr)]
    got = tm.compute_disparity(*targs, _c(cfg), aggregation=aggregation)
    tols = dict(disparity=1e-4, check_disparity=1e-4, disparity_right=1e-4,
                cost=1e-5, margin=1e-5, check_margin=1e-5)
    for f, tol in tols.items():
        r, g = getattr(ref, f), getattr(got, f)
        if r is None:
            assert g is None, f
            continue
        assert g.dtype == torch.float32, f
        assert (np.abs(_f32(g) - _f32(r)) <= tol).mean() >= 0.99, f
    assert (np.asarray(ref.valid) == got.valid.numpy()).mean() >= 0.99
    assert got.valid.float().mean() > 0.5

    _reference_volumes(monkeypatch)
    exact = tm.compute_disparity(*targs, _c(cfg), aggregation=aggregation)
    fused_right = (aggregation == "sgm" and cfg.right_sgm == "horizontal"
                   and not cfg.right_subpixel)
    for f in tols:
        r, g = getattr(ref, f), getattr(exact, f)
        if r is None:
            continue
        if f == "disparity_right" and fused_right:
            assert (_f32(g) != _f32(r)).mean() <= 0.005
        elif f in ("disparity", "disparity_right", "check_disparity"):
            np.testing.assert_allclose(_f32(g), _f32(r), atol=DISP_TOL,
                                       rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(_f32(g), _f32(r), err_msg=f)
    np.testing.assert_array_equal(exact.valid.numpy(), np.asarray(ref.valid))


def test_cost_dtype_bfloat16(rng, monkeypatch):
    """cost_dtype="bfloat16" is a mode with results of its own: on the
    small pair the reference's bfloat16 disparities differ from its
    float32 ones (measured: 43 pixels by more than 0.01 px, the largest by
    5.6 px), and the port follows each: "float32" and "auto" equal the
    reference's float32 result, "bfloat16" its bfloat16 one
    (_compare_bf16)."""
    left, right, vl, vr = _small_pair(rng)
    args = [jnp.asarray(a) for a in (left, right, vl, vr)]
    base = StereoConfig(max_disp=16, block_size=5, census_window=5,
                        sgm_backend="xla")
    cfg = {d: dataclasses.replace(base, cost_dtype=d)
           for d in ("float32", "bfloat16", "auto")}
    r32 = jm.compute_disparity(*args, cfg["float32"])
    r16 = jm.compute_disparity(*args, cfg["bfloat16"])
    diff = np.abs(np.asarray(r32.disparity) - np.asarray(r16.disparity))
    assert (diff > 0.01).sum() >= 10 and diff.max() > 1.0
    targs = [_t(a) for a in (left, right, vl, vr)]
    for d in ("float32", "auto"):
        _assert_results_agree(tm.compute_disparity(*targs, _c(cfg[d])), r32)
    t16 = tm.compute_disparity(*targs, _c(cfg["bfloat16"]))
    tdiff = np.abs(_f32(t16.disparity) - np.asarray(r32.disparity))
    assert (tdiff > 0.01).sum() >= 10
    _compare_bf16(rng, monkeypatch, {}, "sgm")


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_compute_disparity_bf16_variants(rng, monkeypatch, variant):
    """Each ported matcher variant under cost_dtype="bfloat16" against the
    reference's TPU branch: see _compare_bf16."""
    kw, aggregation = _VARIANTS[variant]
    _compare_bf16(rng, monkeypatch, kw, aggregation)


def test_compute_disparity_rejects_unported_variants(rng):
    """The flags that once made compute_disparity refuse a config
    (hierarchical, adapt_band_rows > 0) select matchers in pair_core only:
    compute_disparity runs under each and equals the reference's, which
    ignores them too."""
    left, right, vl, vr = _small_pair(rng)
    for kw in (dict(hierarchical=True),
               dict(adapt_band_rows=32, adapt_local_disp=16)):
        cfg = StereoConfig(max_disp=16, block_size=5, census_window=5,
                           cost_dtype="float32", sgm_backend="xla", **kw)
        ref = jm.compute_disparity(jnp.asarray(left), jnp.asarray(right),
                                   jnp.asarray(vl), jnp.asarray(vr), cfg)
        got = tm.compute_disparity(_t(left), _t(right), _t(vl), _t(vr),
                                   _c(cfg))
        _assert_results_agree(got, ref)
