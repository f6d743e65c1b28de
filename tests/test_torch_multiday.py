"""The fusion slice as a whole: pcmi_tpu_torch's streaming, consistency
and multi-day pipelines against pcmi_tpu on the CPU.

Scenes are the reference's (``make_stereo_scene`` / ``make_family_scene``
at 128x128 images), carried into the port through
``pcmi_tpu_torch.convert``. Bounds are stated at each check with what was
measured. ``MultiDayFusion.run`` draws its point subsets from
``torch.Generator``s where the reference draws from ``jax.random``, so it
is held to statistical bounds; every stage behind those draws is compared
on identical inputs in ``tests/test_torch_fusion.py`` and below.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pcmi_tpu.config import PipelineConfig, RectifyConfig, StereoConfig
from pcmi_tpu.geometry.pairs import ImageMeta
from pcmi_tpu.geometry.rectify import triangulation_operator
from pcmi_tpu.geometry.synthetic import (
    aoi_lonlat_ranges, make_family_scene, make_stereo_scene)
from pcmi_tpu.ops.normalize import normalise_image
from pcmi_tpu.parallel.stereo_sharded import default_halo
from pcmi_tpu.pipelines import height_map as jh
from pcmi_tpu.pipelines import multiday as jmd
from pcmi_tpu.pipelines import streaming as jst
from pcmi_tpu_torch import convert
from pcmi_tpu_torch.geometry.synthetic import aoi_lonlat_ranges as port_aoi
from pcmi_tpu_torch.ops import pointcloud as tpc
from pcmi_tpu_torch.ops.stereo._build import KernelError
from pcmi_tpu_torch.parallel.stereo_sharded import (
    default_halo as port_default_halo)
from pcmi_tpu_torch.pipelines import height_map as th
from pcmi_tpu_torch.pipelines import multiday as tmd
from pcmi_tpu_torch.pipelines import streaming as tst
from pcmi_tpu_torch.pipelines.evaluation import pair_observability
from pcmi_tpu_torch.utils.cache import StageCache
from pcmi_tpu_torch.utils.profiling import recording

torch.set_num_threads(1)

VIEWS3 = ((10.0, 80.0), (20.0, 250.0), (16.0, 170.0))
VIEWS8 = ((12.0, 90.0), (22.0, 260.0), (16.0, 175.0), (26.0, 15.0),
          (19.0, 305.0), (11.0, 215.0), (24.0, 130.0), (14.0, 40.0))
H_RANGE = (0.0, 40.0)
CFG = PipelineConfig(
    stereo=StereoConfig(block_size=9, census_window=5, margin_undefined=8),
    rectify=RectifyConfig(height_range=H_RANGE))
TCFG = convert.config_from_reference(CFG)  # the port's own copy


def _port_scene(scene):
    return convert.scene_from_arrays(
        [np.asarray(im) for im in scene.images], np.asarray(scene.terrain),
        scene.ground_origin, scene.ground_gsd,
        (float(scene.frame.lon0), float(scene.frame.lat0)),
        [r._f64 for r in scene.rpcs], scene.h_range)


def _metas(views):
    return [ImageMeta(i, inc, az, date=30.0 * i)
            for i, (inc, az) in enumerate(views)]


@pytest.fixture(scope="module")
def scenes():
    scene = make_stereo_scene(seed=1, out_shape=(128, 128),
                              ground_shape=(192, 192), h_range=H_RANGE,
                              views=VIEWS3)
    return scene, _port_scene(scene)


@pytest.fixture(scope="module")
def bands(scenes):
    """Pair (0, 1) as the streaming pipeline cuts it: the canvas
    normalised once by the reference, padded by the halo, 64-row bands."""
    scene, _ = scenes
    pipe = jh.HeightMapPipeline(CFG)
    geom = pipe.build_geometry(scene.rpcs[0], scene.rpcs[1],
                               *aoi_lonlat_ranges(scene),
                               scene.images[0].shape, scene.images[1].shape)
    cfg_s = pipe.stereo_cfg_for([geom])
    halo = default_halo(cfg_s)
    r1, r2 = jh._rectify_pair(scene.images[0], scene.images[1],
                              jnp.asarray(geom.H1, jnp.float32),
                              jnp.asarray(geom.H2, jnp.float32),
                              geom.out_shape)
    band = 64
    H = geom.out_shape[0]
    padded = []
    for r in (r1, r2):
        m = r >= 0
        r = jnp.where(m, normalise_image(r, m, subsample=cfg_s.norm_subsample)
                      [0], -1.0)
        padded.append(np.asarray(jnp.pad(r, ((halo, halo + (-H) % band),
                                             (0, 0)), constant_values=-1.0)))
    M, b = (np.asarray(a) for a in triangulation_operator(geom))
    tiles = [(y0, padded[0][y0:y0 + band + 2 * halo],
              padded[1][y0:y0 + band + 2 * halo]) for y0 in range(0, H, band)]
    return dict(cfg=cfg_s, halo=halo, band=band, M=M, b=b, tiles=tiles)


def _ref_band(bands, k):
    y0, b1, b2 = bands["tiles"][k]
    return jh.pair_core(jnp.asarray(b1), jnp.asarray(b2),
                        jnp.asarray(bands["M"]), jnp.asarray(bands["b"]),
                        bands["cfg"], with_plane=False,
                        row0=jnp.float32(y0 - bands["halo"]),
                        pre_normalised=True)


def _port_band(bands, k):
    y0, b1, b2 = bands["tiles"][k]
    return th.pair_core(torch.tensor(b1), torch.tensor(b2),
                        torch.tensor(bands["M"]),
                        torch.tensor(bands["b"]),
                        convert.config_from_reference(bands["cfg"]),
                        with_plane=False, row0=float(y0 - bands["halo"]),
                        pre_normalised=True)


def test_default_halo_matches():
    for cfg in (CFG.stereo, dataclasses.replace(CFG.stereo, hierarchical=True),
                StereoConfig(census_window=7, block_size=5, wls_passes=2)):
        assert port_default_halo(convert.config_from_reference(cfg)) == \
            default_halo(cfg)


def test_pair_core_band_row0_pre_normalised(bands):
    """One interior band: valid masks identical, disparities within 1e-4 px
    and xyz within 1e-3 m in the canvas frame (measured: identical masks,
    5.3e-6 px, 3.1e-5 m)."""
    k = 1
    ref = _ref_band(bands, k)
    got = _port_band(bands, k)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert got.valid.float().mean() > 0.02
    np.testing.assert_allclose(got.disparity.numpy(),
                               np.asarray(ref.disparity), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(ref.xyz),
                               atol=1e-3, rtol=0)
    assert torch.isnan(got.rel_height).all()


@pytest.mark.parametrize("robust_sigma", [0.0, 3.0])
def test_stream_handed_over_from_reference(bands, robust_sigma):
    """The reference accumulates the first half of the bands, the
    accumulator is carried over by ``convert``, the port adds the rest:
    without the gate, the sums equal a run made wholly in the reference
    within the reference's own float32 scan error, four float32 ulps of
    the grid's total (no running sum of its scans exceeds the total;
    measured 0.49 on a square-sum total of 5.3e6, bound 2.5). With the
    3-sigma gate both packages thin the samples at random through their
    float32 block totals (tests/test_torch_fusion.py), so the bounds are
    statistical: kept weight within 10% of the reference's, the port
    fills at least 80% of the cells the reference fills, and cells both
    fill agree within 0.05 m on 97% (measured 2,942 against 3,009, 333 of
    378 cells, 98.8% within 0.05 m)."""
    half = len(bands["tiles"]) // 2
    grid = dict(origin=(-50.0, -50.0), cell=2.0, shape=(50, 50),
                robust_sigma=robust_sigma)

    def ref_update(acc, prod):
        core = slice(bands["halo"], bands["halo"] + bands["band"])
        xyz = prod.xyz[core]
        return jst.dsm_update(acc, xyz[..., :2], xyz[..., 2],
                              prod.valid[core].astype(jnp.float32), **grid)

    acc = jst.StreamingDSM(*(jnp.zeros((50, 50)) for _ in range(3)))
    for k in range(half):
        acc = ref_update(acc, _ref_band(bands, k))
    whole = acc
    for k in range(half, len(bands["tiles"])):
        whole = ref_update(whole, _ref_band(bands, k))

    tacc = convert.streaming_dsm_from_reference(acc, device="cpu")
    core = slice(bands["halo"], bands["halo"] + bands["band"])
    for k in range(half, len(bands["tiles"])):
        prod = _port_band(bands, k)
        xyz = prod.xyz[core]
        tacc = tst.dsm_update(tacc, xyz[..., :2], xyz[..., 2],
                              prod.valid[core].float(), **grid)
    assert float(tacc.wsum.sum()) > float(acc.wsum.sum()) > 0
    if robust_sigma == 0:
        for g, r in zip(tacc, whole):
            bound = 4 * 2.0 ** -23 * float(g.sum()) + 1e-3
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                       atol=bound)
        return
    kept, ref_kept = float(tacc.wsum.sum()), float(whole.wsum.sum())
    assert abs(kept - ref_kept) <= 0.1 * ref_kept
    got, _ = tst.dsm_finalize(tacc)
    ref, _ = jst.dsm_finalize(whole)
    both = np.isfinite(got) & np.isfinite(ref)
    assert both.sum() > 100 and both.sum() >= 0.8 * np.isfinite(ref).sum()
    assert (np.abs(got - ref)[both] < 0.05).mean() >= 0.97


def test_streaming_matches_reference(scenes):
    """StreamingAOIPipeline on pair (0, 1) at band_rows=64: the same tile
    count, grid, pair count and stereo config as the reference. Both
    packages' band gates thin the samples at random
    (tests/test_torch_fusion.py), so the bounds are statistical: the port
    fills at least 70% of the cells the reference fills, and cells both
    fill agree at a median below 0.01 m, within 0.05 m on 90% and
    everywhere within 0.25 m (measured 307 of 388 cells, 4.6e-3 m, 94%,
    0.12 m). Against the port's own monolithic DSM on the same grid, the
    reference test's bounds (tests/test_streaming.py): median below
    0.05 m, 90% within 0.5 m (measured 4.1e-3 m, 100%; the reference's
    stream against the same monolithic DSM 4.0e-3 m, 100%)."""
    scene, tscene = scenes
    metas = _metas(VIEWS3[:2])
    ref = jst.StreamingAOIPipeline(CFG, band_rows=64).run(
        scene.images, scene.rpcs, metas, *aoi_lonlat_ranges(scene),
        grid_cell=2.0, n_pairs=1)
    got = tst.StreamingAOIPipeline(TCFG, band_rows=64, device="cpu").run(
        tscene.images, tscene.rpcs, convert.metas_from_reference(metas),
        *port_aoi(tscene), grid_cell=2.0, n_pairs=1)
    assert got["tiles"] == ref["tiles"] >= 3
    assert got["pairs"] == ref["pairs"] == 1
    assert got["origin"] == ref["origin"] and got["dsm"].shape == ref["dsm"].shape
    assert got["stereo_cfg"] == ref["stereo_cfg"]
    both = np.isfinite(got["dsm"]) & np.isfinite(ref["dsm"])
    assert both.sum() > 200 and both.sum() >= 0.7 * np.isfinite(ref["dsm"]).sum()
    diff = np.abs(got["dsm"] - ref["dsm"])[both]
    assert np.median(diff) < 0.01 and (diff < 0.05).mean() >= 0.9
    assert diff.max() < 0.25

    # against the port's own monolithic product on the same grid
    pipe = th.HeightMapPipeline(TCFG, device="cpu")
    geom = pipe.build_geometry(tscene.rpcs[0], tscene.rpcs[1],
                               *port_aoi(tscene),
                               tuple(tscene.images[0].shape),
                               tuple(tscene.images[1].shape))
    prod = pipe.process_pair(tscene.images[0], tscene.images[1], geom)
    mono, _ = tpc.grid_fuse(prod.xyz[..., :2].reshape(-1, 2),
                            prod.xyz[..., 2].reshape(-1),
                            prod.valid.reshape(-1).float(), got["origin"],
                            got["cell"], got["dsm"].shape, robust_sigma=1e9)
    mono = mono.numpy()
    both = np.isfinite(got["dsm"]) & np.isfinite(mono)
    diff = np.abs(got["dsm"] - mono)[both]
    assert both.sum() > 200
    assert np.median(diff) < 0.05 and (diff < 0.5).mean() > 0.9


def test_fused_consistency_dsm_lowtex():
    """The low-texture recipe (gate_profile "lr", presmoothing) on a
    128x128 lowtex scene, 4 pairs, min_pairs 2: no random draw, but both
    packages' tile gates thin the samples at random
    (tests/test_torch_fusion.py), so the bounds are statistical: the port
    fills at least 90% of the cells the reference fills, cells both fill
    agree at a median below 0.05 m and within 0.5 m on 95%, and against
    the truth completeness is within 0.02 and RMSE within 0.1 m of the
    reference's (measured: 429 of 459 cells, 0.034 m, 97.2%; completeness
    0.444 against 0.448, RMSE 1.048 m against 1.034 m)."""
    scene = make_family_scene("lowtex", seed=11, out_shape=(128, 128),
                              ground_shape=(128, 128), h_range=H_RANGE,
                              views=VIEWS8)
    tscene = _port_scene(scene)
    cfg = PipelineConfig(
        stereo=StereoConfig(block_size=9, census_window=5,
                            margin_undefined=8, gate_profile="lr",
                            presmooth_sigma=1.5),
        rectify=RectifyConfig(height_range=H_RANGE))
    metas = [ImageMeta(i, inc, az, date=20.0 * i)
             for i, (inc, az) in enumerate(VIEWS8)]
    cell = 2.0
    shape = (int(128 * scene.ground_gsd / cell),) * 2
    args = (cfg, scene.ground_origin, shape, cell)
    kw = dict(n_pairs=4, min_pairs=2, mad_max=0.7)
    ref = jmd.fused_consistency_dsm(scene.images, scene.rpcs, metas,
                                    *aoi_lonlat_ranges(scene), *args, **kw)
    got = tmd.fused_consistency_dsm(
        tscene.images, tscene.rpcs, convert.metas_from_reference(metas),
        *port_aoi(tscene), convert.config_from_reference(cfg), *args[1:],
        **kw, device="cpu")
    rd, gd = np.asarray(ref[0]), got[0]
    assert gd.shape == rd.shape == shape
    both = np.isfinite(gd) & np.isfinite(rd)
    assert both.sum() > 50 and both.sum() >= 0.9 * np.isfinite(rd).sum()
    diff = np.abs(gd - rd)[both]
    assert np.median(diff) < 0.05 and (diff < 0.5).mean() >= 0.95

    terr = np.asarray(scene.terrain)
    gc = (np.arange(shape[0]) + 0.5) * cell / scene.ground_gsd
    gxm, gym = np.meshgrid(gc, gc)
    inb = (gxm < terr.shape[1] - 1) & (gym < terr.shape[0] - 1)
    truth = terr[gym.astype(int), gxm.astype(int)]

    def score(dsm):
        filled = np.isfinite(dsm) & inb
        err = dsm[filled] - truth[filled]
        return filled.sum() / inb.sum(), np.sqrt(np.mean(err ** 2))

    (g_comp, g_rmse), (r_comp, r_rmse) = score(gd), score(rd)
    assert abs(g_comp - r_comp) <= 0.02 and abs(g_rmse - r_rmse) <= 0.1


def _dsm_scores(scene, dsm, x0, y0, cell):
    """The reference's fused-DSM scores (tests/test_pipeline.py): filled
    share of the truth-covered cells, the distance of each filled cell to
    its truth interval (min..max of the true surface over the cell) as an
    RMSE, a median and the share within 1 m, and the RMSE against
    cell-centre truth on flat cells."""
    from pcmi_tpu.pipelines.evaluation import truth_on_grid

    ny, nx = dsm.shape
    cx, cy = np.meshgrid(x0 + (np.arange(nx) + 0.5) * cell,
                         y0 + (np.arange(ny) + 0.5) * cell)
    truth, inb = truth_on_grid(scene, np.stack([cx, cy, 0 * cx], -1))
    m = np.isfinite(dsm) & inb
    terr = np.asarray(scene.terrain)
    ox, oy = scene.ground_origin
    ty, tx = np.mgrid[0:terr.shape[0], 0:terr.shape[1]]
    cgx = np.floor((ox + tx * scene.ground_gsd - x0) / cell).astype(int)
    cgy = np.floor((oy + ty * scene.ground_gsd - y0) / cell).astype(int)
    ok = (cgx >= 0) & (cgx < nx) & (cgy >= 0) & (cgy < ny)
    tmin = np.full(dsm.shape, np.inf)
    tmax = np.full(dsm.shape, -np.inf)
    np.minimum.at(tmin, (cgy[ok], cgx[ok]), terr[ok])
    np.maximum.at(tmax, (cgy[ok], cgx[ok]), terr[ok])
    mi = m & np.isfinite(tmin)
    dist = np.where(dsm < tmin, tmin - dsm,
                    np.where(dsm > tmax, dsm - tmax, 0.0))[mi]
    gyt, gxt = np.gradient(truth)
    flat = m & (np.hypot(gyt, gxt) <= 2.0)
    return dict(filled=float(m.sum() / max(inb.sum(), 1)),
                interval_rmse=float(np.sqrt(np.mean(dist ** 2))),
                within_1m=float((dist <= 1.0).mean()),
                interval_median=float(np.median(dist)),
                flat_rmse=float(np.sqrt(np.mean((dsm[flat] - truth[flat])
                                                ** 2))))


def test_multiday_fusion_statistical(scenes):
    """MultiDayFusion.run on VIEWS3 (3 pairs), 4096 points per pair, with
    K-means. The point subsets are drawn from torch Generators, so the
    port is held to bounds: the same pairs, every ICP residual below 2 m
    (the reference test's bound), filled cells above 0.3 of the
    truth-covered ones, and robust scores of the distance of each filled
    cell to its truth interval (tests/test_pipeline.py): >= 98% within
    1 m and a median below 0.2 m, in both packages, and a filled share
    within 0.08 of the reference's. Measured over three port draws:
    residuals 0.35-0.36 / 0.38-0.39 m (reference 0.36 / 0.40), filled
    0.487-0.508 (0.531), within 1 m 0.996-0.998 (0.994), median
    0.080-0.081 m (0.083). The interval RMSE is no bound at 4096 points
    per pair: one single-pair margin cell 29 m off decides it (port
    1.35 / 0.39 / 0.31 m, reference 0.49 m)."""
    scene, tscene = scenes
    metas = _metas(VIEWS3)
    cfg = CFG.replace(pairs=dataclasses.replace(CFG.pairs, n_pairs=3))
    run = dict(points_per_pair=1 << 12, with_kmeans=True, grid_cell=2.0)
    ref = jmd.MultiDayFusion(cfg).run(scene.images, scene.rpcs, metas,
                                      *aoi_lonlat_ranges(scene), **run)
    fusion = tmd.MultiDayFusion(convert.config_from_reference(cfg),
                                device="cpu")
    with recording():
        got = fusion.run(tscene.images, tscene.rpcs,
                         convert.metas_from_reference(metas),
                         *port_aoi(tscene), **run)
    assert got.icp_rmse.shape == (3,) and float(got.icp_rmse[0]) == 0.0
    assert float(got.icp_rmse.max()) < 2.0
    assert got.kmeans_centroids.shape == (64, 3)
    assert torch.isfinite(got.kmeans_centroids).all()
    assert got.points.shape == (3 << 12, 3) and got.weights.sum() > 3000
    assert set(fusion.stage_ms) == {"stereo", "icp", "knn_mask", "dsm",
                                    "kmeans"}
    gd, rd = got.dsm.numpy(), np.asarray(ref.dsm)
    gs = _dsm_scores(scene, gd, *got.grid_origin, got.grid_cell)
    rs = _dsm_scores(scene, rd, *ref.grid_origin, ref.grid_cell)
    assert gs["filled"] > 0.3  # the reference test's bound
    assert abs(gs["filled"] - rs["filled"]) < 0.08
    assert gs["within_1m"] >= 0.98 and rs["within_1m"] >= 0.98
    assert gs["interval_median"] < 0.2 and rs["interval_median"] < 0.2
    if gd.shape == rd.shape and got.grid_origin == ref.grid_origin:
        both = np.isfinite(gd) & np.isfinite(rd)
        assert (np.abs(gd - rd)[both] < 0.5).mean() > 0.9


def test_multiday_registration_on_identical_subsets(scenes):
    """register_clouds on the reference's own ICP subsets (its
    jax.random.choice draws with keys 101 and 102 + k) and the same
    clouds: R and t within 1e-3 of the reference's ICP on those subsets."""
    rng = np.random.default_rng(4)
    base = rng.uniform(-20, 20, (3000, 3)).astype(np.float32)
    ang = np.radians(1.5)
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    clouds = [base, base @ R.T + np.float32([0.8, -0.4, 0.3]),
              base + np.float32([-0.5, 0.2, 0.1])]
    clouds = [c + rng.normal(0, 0.05, c.shape).astype(np.float32)
              for c in clouds]
    weights = [(rng.uniform(size=3000) > 0.1).astype(np.float32)
               for _ in clouds]
    fus = dataclasses.replace(TCFG.fusion, icp_subsample=1024)
    keys = [101] + [102 + k for k in range(len(clouds) - 1)]
    subsets = [np.asarray(jax.random.choice(jax.random.PRNGKey(key), 3000,
                                            (1024,), replace=False))
               for key in keys]
    reg, rmses = tmd.register_clouds(
        [torch.from_numpy(c) for c in clouds],
        [torch.from_numpy(w) for w in weights], fus,
        [torch.tensor(s) for s in subsets])
    from pcmi_tpu.ops import pointcloud as jpc

    ref_s, ref_w = clouds[0][subsets[0]], weights[0][subsets[0]]
    for k in (1, 2):
        s = subsets[k]
        res = jpc.icp(jnp.asarray(clouds[k][s]),
                      jnp.asarray(weights[k][s] > 0), jnp.asarray(ref_s),
                      jnp.asarray(ref_w > 0), iters=fus.icp_iters,
                      chunk=2048, mode="rigid")
        want = np.asarray(jpc.apply_rigid(jnp.asarray(clouds[k]), res.R,
                                          res.t))
        np.testing.assert_allclose(reg[k].numpy(), want, atol=1e-3)
        np.testing.assert_allclose(float(rmses[k]), float(res.rmse),
                                   atol=1e-4)
    np.testing.assert_array_equal(reg[0].numpy(), clouds[0])


def test_product_point_cloud_on_the_reference_draw():
    """The Gumbel top-k given the reference's noise (jax.random.gumbel with
    its key) keeps the reference's points, in its order."""
    rng = np.random.default_rng(5)
    h, w = 40, 50
    xyz = rng.normal(size=(h, w, 3)).astype(np.float32)
    valid = rng.uniform(size=(h, w)) > 0.4
    jprod = jh.PairProduct(*(jnp.asarray(a) for a in (
        np.zeros((h, w), np.float32), valid, np.zeros((h, w), np.float32),
        xyz, xyz[..., 2], xyz[..., 2], xyz[..., 2], xyz[..., 2])))
    key = jax.random.PRNGKey(3)
    rp, rw = jh.product_point_cloud(jprod, max_points=500, key=key)
    tprod = th.PairProduct(*(torch.from_numpy(np.asarray(a)) for a in jprod))
    noise = torch.from_numpy(np.asarray(jax.random.gumbel(key, (h * w,))))
    gp, gw = th._gumbel_top_k(tprod, 500, noise)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(rw))
    # the port's own draw: a uniform subset of the valid pixels
    own, ow = th.product_point_cloud(tprod, 500,
                                     generator=torch.Generator().manual_seed(3))
    assert own.shape == (500, 3) and bool((ow == 1).all())
    full, fw = th.product_point_cloud(tprod, h * w)
    assert full.shape == (h * w, 3) and float(fw.sum()) == valid.sum()


def test_run_skips_failed_pairs_but_not_kernel_errors(scenes, monkeypatch):
    """A pair whose stereo raises is skipped (the reference's semantics);
    a KernelError is never swallowed."""
    _, tscene = scenes
    cfg = TCFG.replace(pairs=dataclasses.replace(TCFG.pairs, n_pairs=3))
    fusion = tmd.MultiDayFusion(cfg, device="cpu")
    metas = convert.metas_from_reference(_metas(VIEWS3))
    calls = []

    def fail(*a, **k):
        calls.append(1)
        raise KernelError("sgm_dir: CUDA launch failed, cudaError_t 700")

    monkeypatch.setattr(fusion.pipeline, "process_pair", fail)
    with pytest.raises(KernelError):
        fusion.run(tscene.images, tscene.rpcs, metas, *port_aoi(tscene))
    assert len(calls) == 1

    def bad_pair(*a, **k):
        raise ValueError("degenerate pair")

    monkeypatch.setattr(fusion.pipeline, "process_pair", bad_pair)
    with pytest.raises(ValueError, match="every selected pair failed"):
        fusion.run(tscene.images, tscene.rpcs, metas, *port_aoi(tscene))


def test_process_pair_stage_cache(scenes, tmp_path):
    """process_pair(cache=...) stores the product and returns it on a hit."""
    _, tscene = scenes
    pipe = th.HeightMapPipeline(TCFG, device="cpu")
    geom = pipe.build_geometry(tscene.rpcs[0], tscene.rpcs[2],
                               *port_aoi(tscene),
                               tuple(tscene.images[0].shape),
                               tuple(tscene.images[2].shape))
    cache = StageCache(str(tmp_path))
    a = pipe.process_pair(tscene.images[0], tscene.images[2], geom,
                          cache=cache, with_plane=False)
    b = pipe.process_pair(tscene.images[0], tscene.images[2], geom,
                          cache=cache, with_plane=False)
    assert (cache.misses, cache.hits) == (1, 1)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_pair_observability(scenes):
    """Geometric observability against the reference's on the same scene:
    identical counts (the float32 frame transform, as the reference)."""
    from pcmi_tpu.pipelines.evaluation import (
        pair_observability as ref_observability)

    scene, tscene = scenes
    pairs = [(0, 1), (0, 2), (1, 2)]
    args = (pairs, 1.0, (96, 96))
    np.testing.assert_array_equal(pair_observability(tscene, *args),
                                  ref_observability(scene, *args))
