"""The fusion stages of pcmi_tpu_torch against pcmi_tpu on the CPU: pair
selection, segmented ops, point-cloud ops, the streaming DSM accumulator
and its finalisation.

Inputs are numpy arrays from seeded generators, handed to both packages.
Each tolerance is stated where it is checked, with what was measured.
Where the reference draws from ``jax.random``, the port's stage is given
the reference's draw (indices or a first seed) so the two compute on
identical inputs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pcmi_tpu.geometry import pairs as jpairs
from pcmi_tpu.ops import pointcloud as jpc
from pcmi_tpu.ops import segmented as jseg
from pcmi_tpu.pipelines import streaming as jst
from pcmi_tpu_torch import convert
from pcmi_tpu_torch.geometry import pairs as tpairs
from pcmi_tpu_torch.ops import pointcloud as tpc
from pcmi_tpu_torch.ops import segmented as tseg
from pcmi_tpu_torch.pipelines import streaming as tst

torch.set_num_threads(1)

VIEWS8 = ((12.0, 90.0), (22.0, 260.0), (16.0, 175.0), (26.0, 15.0),
          (19.0, 305.0), (11.0, 215.0), (24.0, 130.0), (14.0, 40.0))
METAS4 = ((0, 10.0, 80.0, 0.0), (1, 20.0, 250.0, 30.0),
          (2, 45.0, 170.0, 60.0), (3, 10.5, 82.0, 90.0))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ---------------------------------------------------------------------------
# pair selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["views8", "metas4"])
def test_select_and_take_pairs_identical(case):
    if case == "views8":
        jm = [jpairs.ImageMeta(i, inc, az, date=20.0 * i)
              for i, (inc, az) in enumerate(VIEWS8)]
    else:
        jm = [jpairs.ImageMeta(i, inc, az, date=d) for i, inc, az, d in METAS4]
    tm = convert.metas_from_reference(jm)
    ref = jpairs.select_pairs(jm)
    got = tpairs.select_pairs(tm)
    assert [vars(p) for p in got] == [vars(p) for p in ref]
    for n in (1, 2, 16, 40):
        assert [vars(p) for p in tpairs.take_pairs(got, n)] == \
            [vars(p) for p in jpairs.take_pairs(ref, n)]
    assert [vars(p) for p in tpairs.take_pairs(got, 40, valid_only=False)] \
        == [vars(p) for p in jpairs.take_pairs(ref, 40, valid_only=False)]


# ---------------------------------------------------------------------------
# segmented ops
# ---------------------------------------------------------------------------


def _segment_draw(n=20_000, num=1024, seed=7):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, num, n).astype(np.int32)
    v = rng.normal(10.0, 30.0, n).astype(np.float32)
    w = (rng.uniform(size=n) > 0.3).astype(np.float32)
    return ids, v, w, num


def test_sort_by_segment_identical():
    """Stable sort by id with payloads carried: identical to lax.sort
    (stable) on many ties."""
    ids, v, w, _ = _segment_draw()
    ref = jseg.sort_by_segment(jnp.asarray(ids), jnp.asarray(v),
                               jnp.asarray(w))
    got = tseg.sort_by_segment(_t(ids), _t(v), _t(w))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_np(g), np.asarray(r))


def test_segment_totals_and_grid_sums():
    """Per-point totals from the blocked float32 scans, on the reference's
    own test draw: each package within 4 float32 ulps of the payload's
    grand total of the exact float64 totals (no running sum of a block
    exceeds it), so within 8 of each other (measured: port 1.9e-3,
    reference 3.9e-3, bound 9.8e-3 on w * v). Per-cell sums within 1e-4
    relative of the reference; empty cells exactly 0."""
    rng = np.random.default_rng(0)
    n, num = 4096, 300
    ids = rng.integers(0, num, n).astype(np.int32)
    v = rng.normal(10, 3, n).astype(np.float32)
    w = rng.uniform(0, 1, n).astype(np.float32)
    jids, jv, jw, jb = jseg.sort_by_segment(jnp.asarray(ids), jnp.asarray(v),
                                            jnp.asarray(w))
    tids, tv, tw, tb = tseg.sort_by_segment(_t(ids), _t(v), _t(w))
    ref = jseg.segment_totals_at_points(jb, jw, jw * jv)
    got = tseg.segment_totals_at_points(tb, tw, tw * tv)
    sid = _np(tids)
    for g, r, x in zip(got, ref, (tw, tw * tv)):
        x = _np(x).astype(np.float64)
        exact = np.bincount(sid, x, minlength=num)[sid]
        ulp = 2.0 ** -23 * x.sum()
        np.testing.assert_allclose(_np(g), exact, rtol=0, atol=4 * ulp)
        np.testing.assert_allclose(np.asarray(r), exact, rtol=0, atol=4 * ulp)
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=0,
                                   atol=8 * ulp)
    payload_j = (jw, jw * jv, jw * jv * jv)
    payload_t = (tw, tw * tv, tw * tv * tv)
    ref = np.asarray(jseg.grid_segment_sums(jids, jb, payload_j, num + 5))
    got = _np(tseg.grid_segment_sums(tids, tb, payload_t, num + 5))
    assert got.shape == ref.shape == (num + 5, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    np.testing.assert_array_equal(got[num:], 0.0)
    np.testing.assert_array_equal(ref[num:], 0.0)


def test_grid_sums_signed_payloads():
    """Signed payloads over 20k points: the port's float64-accumulated
    sums are within 1e-6 relative of a float64 numpy sum. The reference's
    blocked scans (payloads shifted by their global minimum) carry an
    error of about 2 float32 ulps of the in-block running sum, ~3e-7 x
    16384 x the shifted mean (+1e-3); measured 0.29 on a cell sum here,
    above the 1.5e-7 its own test allows."""
    ids, v, w, num = _segment_draw()
    jids, jv, jw, jb = jseg.sort_by_segment(jnp.asarray(ids), jnp.asarray(v),
                                            jnp.asarray(w))
    tids, tv, tw, tb = tseg.sort_by_segment(_t(ids), _t(v), _t(w))
    payload_t = (tw, tw * tv, tw * tv * tv)
    got = _np(tseg.grid_segment_sums(tids, tb, payload_t, num))
    ref = np.asarray(jseg.grid_segment_sums(
        jids, jb, (jw, jw * jv, jw * jv * jv), num))
    for col, data in enumerate(payload_t):
        d = _np(data).astype(np.float64)
        exact = np.zeros(num)
        np.add.at(exact, _np(tids).astype(int), d)
        np.testing.assert_allclose(got[:, col], exact, rtol=1e-6, atol=1e-6)
        bound = 3e-7 * 16384 * (d - min(d.min(), 0.0)).mean() + 1e-3
        np.testing.assert_allclose(ref[:, col], got[:, col], atol=bound,
                                   rtol=1e-4)


def test_grid_segment_sums_more_cells_than_points():
    ids = np.array([5, 5, 900, 2], np.int32)
    v = np.array([1.0, 2.0, 4.0, 8.0], np.float32)
    ids_s, v_s, w_s, bnd = tseg.sort_by_segment(_t(ids), _t(v),
                                                torch.ones(4))
    out = _np(tseg.grid_segment_sums(ids_s, bnd, (w_s, w_s * v_s), 1024))
    assert out[5, 0] == 2.0 and out[5, 1] == 3.0
    assert out[900, 1] == 4.0 and out[2, 1] == 8.0
    assert out.sum() == 4.0 + 15.0


def _gate_draw(signed: bool, seed=3, n=20_000, num=500):
    """Cells of ~40 samples, 2% planted gross outliers and 10% zero-weight
    points carrying NaN. ``signed``: heights around 0-50 m with outliers
    of either sign; else heights of 5-9 m with outliers above them."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, num, n).astype(np.int32)
    out = rng.uniform(size=n) < 0.02
    mag = rng.uniform(20, 60, out.sum())
    if signed:
        v = rng.normal(0, 0.5, n) + ids * 0.1
        v[out] += rng.choice([-1, 1], out.sum()) * mag
    else:
        v = rng.normal(5, 0.5, n) + ids * (4.0 / num)
        v[out] += mag
    w = np.where(rng.uniform(size=n) < 0.1, 0.0, 1.0).astype(np.float32)
    v = v.astype(np.float32)
    v[w == 0] = np.nan
    return ids, v, w, out & (w > 0)


def _np_sigma_gate(ids_s, v_s, w_s, sigma, rounds=3):
    """The sigma gate in float64 numpy (sorted domain)."""
    v = v_s.astype(np.float64)
    w0 = w_s.astype(np.float64)
    valid = w0 > 0
    vsh = np.where(valid, v - min(np.where(valid, v, np.inf).min(), 0.0), 0.0)
    w = w0
    for _ in range(rounds):
        tot = [np.bincount(ids_s, x, minlength=ids_s.max() + 1)[ids_s]
               for x in (w, w * vsh, w * vsh * vsh)]
        ws = np.maximum(tot[0], 1e-12)
        mean = tot[1] / ws
        std = np.sqrt(np.maximum(tot[2] / ws - mean ** 2, 0.0))
        w = w0 * (np.abs(vsh - mean) <= sigma * std + 1e-6)
    return w


@pytest.mark.parametrize("signed", [False, True])
def test_robust_sigma_gate_masks(signed):
    """3-round keep masks. At heights of 5-9 m the blocked float32 totals
    are accurate: the masks agree with the reference's and with a float64
    gate's on >= 99.9% of points (measured 100%), and the good points are
    kept. At 0-50 m, in both packages, the totals' error (about one float32
    ulp of a block's running sum of squares) exceeds the cells' variance
    and the gate drops members at random: the kept share is within 0.05
    of the reference's, and both lie more than 0.05 below the float64
    gate's (measured 0.753, 0.727 and 0.877; the masks agree on 82%).
    Every planted outlier is dropped in both."""
    ids, v, w, planted = _gate_draw(signed)
    order = np.argsort(ids, kind="stable")
    tids, tv, tw, tb = tseg.sort_by_segment(_t(ids), _t(v), _t(w))
    got = _np(tseg.robust_sigma_gate(tb, tv, tw, 3.0, rounds=3)) > 0
    exact = _np_sigma_gate(ids[order], v[order], w[order], 3.0) > 0
    jids, jv, jw, jb = jseg.sort_by_segment(jnp.asarray(ids), jnp.asarray(v),
                                            jnp.asarray(w))
    ref = np.asarray(jseg.robust_sigma_gate(jb, jv, jw, 3.0, rounds=3)) > 0
    planted = planted[order]
    assert planted.sum() > 100
    assert not got[planted].any() and not ref[planted].any()
    if not signed:
        assert (got == ref).mean() >= 0.999 and (got == exact).mean() >= 0.999
        assert got[(w > 0)[order] & ~planted].mean() > 0.95
    else:
        assert abs(got.mean() - ref.mean()) < 0.05
        assert max(got.mean(), ref.mean()) < exact.mean() - 0.05


# ---------------------------------------------------------------------------
# point-cloud ops
# ---------------------------------------------------------------------------


def _cloud(n=1500, seed=0, n_out=30, invalid=0.1):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 20, (n, 3)).astype(np.float32)
    pts[:n_out] = rng.uniform(200, 300, (n_out, 3))
    valid = rng.uniform(size=n) > invalid
    return pts, valid


def test_pairwise_sqdist_expansion():
    """The |a|^2 - 2ab + |b|^2 expansion, clamped at 0; measured max
    |diff| 1.5e-5 at magnitudes up to ~3e5 (float32 product order)."""
    a, _ = _cloud(300, seed=1)
    b, _ = _cloud(200, seed=2)
    ref = np.asarray(jpc._pairwise_sqdist(jnp.asarray(a), jnp.asarray(b)))
    got = _np(tpc._pairwise_sqdist(_t(a), _t(b)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-2)
    assert (got >= 0).all()


@pytest.mark.parametrize("chunk", [256, 2048])
def test_knn_mean_distance(chunk):
    """Within 1e-4 (relative and absolute); invalid points +inf in both."""
    pts, valid = _cloud()
    ref = np.asarray(jpc.knn_mean_distance(jnp.asarray(pts),
                                           jnp.asarray(valid), k=8,
                                           chunk=chunk))
    got = _np(tpc.knn_mean_distance(_t(pts), _t(valid), k=8, chunk=chunk))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_valid_parity", ["odd", "even"])
def test_knn_outlier_mask(n_valid_parity):
    """Masks agree on >= 99.9% of points (measured: identical), planted
    outliers dropped. With an even valid count the median is the mean of
    the two middle values, where torch.nanmedian takes the lower one."""
    pts, valid = _cloud(1200, seed=4)
    if (valid.sum() % 2 == 0) != (n_valid_parity == "even"):
        valid[-1] = not valid[-1]
    assert (valid.sum() % 2 == 0) == (n_valid_parity == "even")
    ref = np.asarray(jpc.knn_outlier_mask(jnp.asarray(pts),
                                          jnp.asarray(valid), k=8,
                                          sigma=3.0, chunk=512))
    got = _np(tpc.knn_outlier_mask(_t(pts), _t(valid), k=8, sigma=3.0,
                                   chunk=512))
    assert (got == ref).mean() >= 0.999
    assert not got[:30].any() and got[30:][valid[30:]].mean() > 0.95


@pytest.mark.parametrize("x", [[1.0, 2.0, 3.0, 4.0, np.nan],
                               [5.0, np.nan, 1.0, 3.0],
                               [np.nan, np.nan], [7.0]])
def test_nanmedian_is_jnp_nanmedian(x):
    x = np.asarray(x, np.float32)
    ref = np.asarray(jnp.nanmedian(jnp.asarray(x)))
    got = _np(tpc.nanmedian(_t(x)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("q", [0.0, 0.3, 0.5, 0.7, 1.0])
def test_quantile_is_jnp_quantile_with_inf(q):
    """Interpolating into +inf gives inf (torch.quantile gives NaN)."""
    x = np.array([0.5, 1.0, np.inf, np.inf, 0.25], np.float32)
    qq = np.float32(q)
    ref = np.asarray(jnp.quantile(jnp.asarray(x), jnp.asarray(qq)))
    got = _np(tpc.quantile(_t(x), _t(qq)))
    np.testing.assert_array_equal(got, ref)


def test_nearest_neighbor_identical_indices():
    rng = np.random.default_rng(5)
    ref_pts = rng.uniform(0, 20, (900, 3)).astype(np.float32)
    q = rng.uniform(0, 20, (700, 3)).astype(np.float32)
    rv = rng.uniform(size=900) > 0.2
    ri, rd = jpc.nearest_neighbor(jnp.asarray(q), jnp.asarray(ref_pts),
                                  jnp.asarray(rv), chunk=256)
    gi, gd = tpc.nearest_neighbor(_t(q), _t(ref_pts), _t(rv), chunk=256)
    np.testing.assert_array_equal(_np(gi), np.asarray(ri))
    assert gi.dtype == torch.int32
    # distances: the expansion cancels at |a|^2 ~ 1e3 (float32 ulp 6e-5 on
    # d^2); measured max |diff| 1.3e-4
    np.testing.assert_allclose(_np(gd), np.asarray(rd), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("sigma", [3.0, 1e9])
def test_grid_fuse(sigma):
    """Within 1e-4 with the same NaN pattern (measured 8.3e-5 at sigma 3,
    where no sample sits at the threshold); counts exact."""
    rng = np.random.default_rng(6)
    n = 4000
    xy = rng.uniform(-1, 21, (n, 2)).astype(np.float32)
    v = (rng.normal(5, 1, n) + xy[:, 0] * 0.2).astype(np.float32)
    v[rng.uniform(size=n) < 0.03] += 50.0
    w = (rng.uniform(size=n) > 0.2).astype(np.float32)
    args = dict(origin=(0.0, 0.0), cell=1.0, shape=(20, 20),
                robust_sigma=sigma)
    rd, rc = jpc.grid_fuse(jnp.asarray(xy), jnp.asarray(v), jnp.asarray(w),
                           **args)
    gd, gc = tpc.grid_fuse(_t(xy), _t(v), _t(w), **args)
    rd, gd = np.asarray(rd), _np(gd)
    np.testing.assert_array_equal(np.isnan(gd), np.isnan(rd))
    np.testing.assert_allclose(gd, rd, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(_np(gc), np.asarray(rc))


def test_grid_fuse_robust_pass_rejects_outlier():
    xy = np.array([[0.5, 0.5], [0.6, 0.4], [1.5, 0.5],
                   [2.5, 1.5], [2.4, 1.6], [2.6, 1.5]], np.float32)
    v = np.array([1.0, 3.0, 5.0, 10.0, 10.0, 400.0], np.float32)
    dsm, cnt = tpc.grid_fuse(_t(xy), _t(v), torch.ones(6), origin=(0.0, 0.0),
                             cell=1.0, shape=(2, 3), robust_sigma=1.0)
    dsm, cnt = _np(dsm), _np(cnt)
    assert abs(dsm[0, 0] - 2.0) < 1e-5 and abs(dsm[0, 1] - 5.0) < 1e-5
    assert abs(dsm[1, 2] - 10.0) < 1e-5
    assert np.isnan(dsm[1, 0]) and np.isnan(dsm[0, 2]) and np.isnan(dsm[1, 1])
    assert cnt[0, 0] == 2 and cnt[1, 2] == 3


def _rigid_setup(mode):
    """The reference tests' ICP setups (tests/test_pointcloud.py)."""
    rng = np.random.default_rng(0)
    if mode == "translation":
        pts = rng.uniform(0, 50, (1500, 3)).astype(np.float32)
        src = pts + np.array([2.5, -1.25, 0.75], np.float32)
        return src, pts, 12
    pts = rng.uniform(-25, 25, (2000, 3)).astype(np.float32)
    ang = np.radians(4.0)
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    src = pts @ R.T + np.array([1.0, -2.0, 0.5], np.float32)
    return src, pts, 15


@pytest.mark.parametrize("mode", ["rigid", "translation"])
def test_icp_matches_reference(mode):
    """R and t within 1e-4 of the reference's (measured 1.5e-6), RMSE
    within 1e-4; the registration itself recovers the planted motion."""
    src, dst, iters = _rigid_setup(mode)
    valid = np.ones(len(src), bool)
    ref = jpc.icp(jnp.asarray(src), jnp.asarray(valid), jnp.asarray(dst),
                  jnp.asarray(valid), iters=iters, chunk=512, mode=mode)
    got = tpc.icp(_t(src), _t(valid), _t(dst), _t(valid), iters=iters,
                  chunk=512, mode=mode)
    np.testing.assert_allclose(_np(got.R), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(_np(got.t), np.asarray(ref.t), atol=1e-4)
    np.testing.assert_allclose(float(got.rmse), float(ref.rmse), atol=1e-4)
    moved = _np(tpc.apply_rigid(_t(src), got.R, got.t))
    assert np.median(np.linalg.norm(moved - dst, axis=1)) < 0.2


@pytest.mark.parametrize("n_valid", [3, 7])
def test_icp_few_valid_points(n_valid):
    """Few valid sources among 400: with 3, the trim quantile interpolates
    into the +inf distances of invalid points and is +inf in both packages
    (torch.quantile gives NaN there, which would zero every weight). R, t
    and the RMSE within 1e-4 (measured 3e-6)."""
    rng = np.random.default_rng(8)
    dst = rng.uniform(0, 10, (400, 3)).astype(np.float32)
    src = (dst + np.array([0.3, -0.2, 0.1], np.float32)
           + rng.normal(0, 0.05, dst.shape).astype(np.float32))
    sv = np.zeros(len(src), bool)
    sv[rng.choice(len(src), n_valid, replace=False)] = True
    dv = np.ones(len(dst), bool)
    ref = jpc.icp(jnp.asarray(src), jnp.asarray(sv), jnp.asarray(dst),
                  jnp.asarray(dv), iters=5, chunk=128, mode="rigid")
    got = tpc.icp(_t(src), _t(sv), _t(dst), _t(dv), iters=5, chunk=128,
                  mode="rigid")
    for f in ("R", "t", "rmse"):
        a, b = _np(getattr(got, f)), np.asarray(getattr(ref, f))
        assert np.isfinite(a).all() and np.isfinite(b).all()
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=f)
    assert float(got.rmse) > 0.01


def test_kmeans_lloyd_from_one_init():
    """From the reference's own first seed (its Gumbel draw with the same
    key): centroids within 1e-5, identical assignments, inertia within
    1e-4 relative; the separated blobs are recovered."""
    rng = np.random.default_rng(0)
    centers = np.array([[0, 0], [30, 0], [0, 30], [30, 30]], np.float32)
    pts = np.concatenate([c + rng.normal(0, 1.0, (200, 2))
                          for c in centers]).astype(np.float32)
    w = np.ones(len(pts), np.float32)
    w[::17] = 0.0
    key = jax.random.PRNGKey(1)
    ref = jpc.kmeans(jnp.asarray(pts), jnp.asarray(w), k=4, iters=25, key=key)
    logw = jnp.where(jnp.asarray(w) > 0, 0.0, -jnp.inf)
    first = int(jnp.argmax(logw + jax.random.gumbel(key, (len(pts),))))
    got = tpc._kmeans_from(_t(pts), _t(w), 4, 25, torch.tensor(first))
    np.testing.assert_allclose(_np(got.centroids), np.asarray(ref.centroids),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(_np(got.assignment),
                                  np.asarray(ref.assignment))
    np.testing.assert_allclose(float(got.inertia), float(ref.inertia),
                               rtol=1e-4)
    # with the port's own draw the blobs are recovered as well
    own = tpc.kmeans(_t(pts), _t(w), k=4, iters=25,
                     generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(np.sort(_np(own.centroids), axis=0),
                               np.sort(centers, axis=0), atol=1.0)


# ---------------------------------------------------------------------------
# streaming DSM accumulator
# ---------------------------------------------------------------------------


def _bench_draw(seed=9, n=20_000):
    """A bench-like tile: heights on a 64x64 grid of 0.6 m cells, 2% gross
    outliers, 15% invalid points and a margin out of bounds."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2.0, 40.4, (n, 2)).astype(np.float32)
    z = (10 + 5 * np.sin(xy[:, 0] / 6.0) + (xy[:, 1] > 20) * 8.0
         + rng.normal(0, 0.3, n)).astype(np.float32)
    out = rng.uniform(size=n) < 0.02
    z[out] += rng.uniform(-30, 30, out.sum()).astype(np.float32)
    w = (rng.uniform(size=n) > 0.15).astype(np.float32)
    return xy, z, w


def _np_dsm_update(xy, z, w, origin, cell, shape, robust_sigma):
    """``dsm_update`` of one tile into an empty grid, in float64 numpy
    (cell ids in float32, as both packages compute them)."""
    ny, nx = shape
    gx = np.floor((xy[:, 0] - np.float32(origin[0])) / np.float32(cell))
    gy = np.floor((xy[:, 1] - np.float32(origin[1])) / np.float32(cell))
    inb = (gx >= 0) & (gx < nx) & (gy >= 0) & (gy < ny)
    w = np.where(inb, w, 0.0)
    ids = np.where(inb, gy * nx + gx, 0).astype(np.int64)
    order = np.argsort(ids, kind="stable")
    ids, z, w = ids[order], z[order], w[order]
    if robust_sigma > 0:
        w = _np_sigma_gate(ids, z, w, robust_sigma)
    z = np.where(w > 0, z, 0.0).astype(np.float64)
    return [np.bincount(ids, x, minlength=ny * nx).reshape(ny, nx)
            for x in (w, w * z, w * z * z)]


@pytest.mark.parametrize("robust_sigma", [0.0, 3.0])
def test_dsm_update_sums(robust_sigma):
    """Two bench-like tiles accumulated. Without the gate the port's sums
    are within 1e-4 relative of the float64 computation (+1e-3 absolute;
    measured 2e-7) and the reference's within its block-sum error bound
    (3e-7 x 16384 x the mean payload, +1e-3) of the port's. With the gate
    both packages thin the samples at random (test_robust_sigma_gate_masks
    at 0-50 m): the kept weight is within 10% of the reference's and
    below the float64 gate's in both, and cells both fill agree at a
    median below 0.1 m (measured: kept 15,317 and 16,001 against 27,846
    after a float64 gate, median 0.040 m)."""
    grid = dict(origin=(0.0, 0.0), cell=0.6, shape=(64, 64),
                robust_sigma=robust_sigma)
    jacc = jst.StreamingDSM(*(jnp.zeros((64, 64)) for _ in range(3)))
    tacc = tst.empty_dsm((64, 64), device="cpu")
    exact = [np.zeros((64, 64)) for _ in range(3)]
    for seed in (9, 10):
        xy, z, w = _bench_draw(seed)
        jacc = jst.dsm_update(jacc, jnp.asarray(xy), jnp.asarray(z),
                              jnp.asarray(w), **grid)
        tacc = tst.dsm_update(tacc, _t(xy), _t(z), _t(w), **grid)
        exact = [e + x for e, x in zip(exact, _np_dsm_update(xy, z, w,
                                                             **grid))]
    if robust_sigma == 0:
        for g, e in zip(tacc, exact):
            np.testing.assert_allclose(_np(g), e, rtol=1e-4, atol=1e-3)
        for g, r in zip(tacc, jacc):
            bound = 3e-7 * 16384 * float(g.mean()) * 64 * 64 / 20_000 + 1e-3
            np.testing.assert_allclose(np.asarray(r), _np(g), rtol=1e-4,
                                       atol=bound)
        return
    kept, ref_kept = float(tacc.wsum.sum()), float(np.asarray(jacc.wsum).sum())
    assert abs(kept - ref_kept) <= 0.1 * ref_kept
    assert max(kept, ref_kept) < exact[0].sum()
    got, _ = tst.dsm_finalize(tacc)
    ref, _ = jst.dsm_finalize(jacc)
    both = np.isfinite(got) & np.isfinite(ref)
    assert both.sum() > 2000
    assert np.median(np.abs(got - ref)[both]) < 0.1


def _accs(rows, mod):
    out = []
    for vals in rows:
        v = np.asarray(vals, np.float32)
        w = np.where(np.isnan(v), 0.0, 1.0).astype(np.float32)
        v = np.nan_to_num(v)
        arrs = (w, v * w, v * v * w)
        if mod is jst:
            out.append(jst.StreamingDSM(*(jnp.asarray(a) for a in arrs)))
        else:
            out.append(tst.StreamingDSM(*(_t(a) for a in arrs)))
    return out


@pytest.mark.parametrize("kw", [dict(), dict(min_pairs=2, mad_max=1.0),
                                dict(min_pairs=3, accept2_delta=0.7),
                                dict(min_pairs=3, mad_max=1.2,
                                     accept2_delta=0.7)])
def test_dsm_finalize_multi_identical(kw):
    """Identical (the same host numpy finalisation) on a stack with
    consensus, 1-of-3 blunder, disagreement, agreeing and disagreeing
    two-pair cells, a single-pair cell and an empty cell; plus random
    stacks."""
    rows = [[[10.0, 5.0, 0.0, 7.0, 4.0, 2.0, np.nan]],
            [[10.2, 5.1, 8.0, 7.3, 9.0, np.nan, np.nan]],
            [[9.9, 25.0, 16.0, np.nan, np.nan, np.nan, np.nan]]]
    rng = np.random.default_rng(2)
    rand = rng.normal(5, 2, (5, 12, 12)).astype(np.float32)
    rand[rng.uniform(size=rand.shape) < 0.4] = np.nan
    for stack in (rows, list(rand[:, None])):
        ref = jst.dsm_finalize_multi(_accs(stack, jst), **kw)
        got = tst.dsm_finalize_multi(_accs(stack, tst), **kw)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


def test_finished_by_port_equals_reference():
    """A running DSM carried over from the reference and finished by the
    port finalises like the reference's own (and the sums carried are the
    reference's exactly)."""
    grid = dict(origin=(0.0, 0.0), cell=0.6, shape=(64, 64),
                robust_sigma=3.0)
    xy, z, w = _bench_draw(11)
    jacc = jst.dsm_update(
        jst.StreamingDSM(*(jnp.zeros((64, 64)) for _ in range(3))),
        jnp.asarray(xy), jnp.asarray(z), jnp.asarray(w), **grid)
    tacc = convert.streaming_dsm_from_reference(jacc, device="cpu")
    for g, r in zip(tacc, jacc):
        np.testing.assert_array_equal(_np(g), np.asarray(r))
    jdsm, jcnt = jst.dsm_finalize(jacc)
    tdsm, tcnt = tst.dsm_finalize(tacc)
    np.testing.assert_array_equal(tdsm, jdsm)
    np.testing.assert_array_equal(tcnt, jcnt)
