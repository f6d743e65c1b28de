"""The port's geometry (pcmi_tpu_torch.geometry) against pcmi_tpu.

The host fits are float64 numpy in both packages, so fed the same RPC dicts
they agree to 1e-9; the float32 device steps (triangulation, rendering)
are held to float32 tolerances.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pcmi_tpu.geometry import affine as ja
from pcmi_tpu.geometry import rectify as jr
from pcmi_tpu.geometry import synthetic as js
from pcmi_tpu_torch import convert
from pcmi_tpu_torch.geometry import affine as ta
from pcmi_tpu_torch.geometry import rectify as tr
from pcmi_tpu_torch.geometry import synthetic as ts

torch.set_num_threads(1)

LON, LAT = (-58.5855, -58.5835), (-34.4912, -34.4893)


def _cams(views=((10.0, 80.0), (20.0, 250.0))):
    """The reference's exact RPC wrappers of two satellite cameras."""
    frame = ja.LocalFrame(lon0=jnp.float32(js.TARGET_LON),
                          lat0=jnp.float32(js.TARGET_LAT))
    return [js.rpc_from_affine_camera(
        js.make_satellite_camera(inc, az, 0.5, offset=(64.0, 64.0)),
        frame, (128, 128), (0.0, 40.0)) for inc, az in views]


def test_rpc_project_np_exact():
    jrpc = _cams()[0]
    trpc = convert.rpc_from_reference(jrpc._f64)
    lon = np.linspace(*LON, 7)
    lat = np.linspace(*LAT, 7)
    h = np.linspace(0.0, 40.0, 7)
    for a, b in zip(trpc.project_np(lon, lat, h), jrpc.project_np(lon, lat, h)):
        np.testing.assert_array_equal(a, b)
    # the float32 device projection, within float32 resolution of pixels
    tcol, trow = trpc.project(torch.tensor(lon, dtype=torch.float32),
                              torch.tensor(lat, dtype=torch.float32),
                              torch.tensor(h, dtype=torch.float32))
    jcol, jrow = jrpc.project(jnp.asarray(lon, jnp.float32),
                              jnp.asarray(lat, jnp.float32),
                              jnp.asarray(h, jnp.float32))
    np.testing.assert_allclose(tcol.numpy(), np.asarray(jcol), atol=1e-3)
    np.testing.assert_allclose(trow.numpy(), np.asarray(jrow), atol=1e-3)


def test_fit_affine_camera_matches():
    jrpc = _cams()[1]
    trpc = convert.rpc_from_reference(jrpc._f64)
    llh = ja.probe_grid(LON, LAT, (0.0, 40.0))
    np.testing.assert_array_equal(ta.probe_grid(LON, LAT, (0.0, 40.0)), llh)
    jcam = ja.fit_affine_camera(
        jrpc, ja.LocalFrame(jnp.float32(np.mean(LON)),
                            jnp.float32(np.mean(LAT))), llh)
    tcam = ta.fit_affine_camera(
        trpc, ta.LocalFrame(np.mean(LON), np.mean(LAT)), llh)
    np.testing.assert_array_equal(tcam.A.numpy(), np.asarray(jcam.A))
    np.testing.assert_array_equal(tcam.b.numpy(), np.asarray(jcam.b))


def test_build_geometry_and_triangulation(rng):
    jrpcs = _cams()
    trpcs = [convert.rpc_from_reference(r._f64) for r in jrpcs]
    jg = jr.build_geometry_from_rpcs(*jrpcs, LON, LAT, (0.0, 40.0),
                                     (128, 128), (128, 128))
    tg = tr.build_geometry_from_rpcs(*trpcs, LON, LAT, (0.0, 40.0),
                                     (128, 128), (128, 128))
    np.testing.assert_allclose(tg.H1, jg.H1, atol=1e-9, rtol=0)
    np.testing.assert_allclose(tg.H2, jg.H2, atol=1e-9, rtol=0)
    assert tg.out_shape == jg.out_shape
    assert abs(tg.disp_gain - jg.disp_gain) < 1e-9
    assert tg.h_mid == jg.h_mid
    jM, jb = jr.triangulation_operator(jg)
    tM, tb = tr.triangulation_operator(tg)
    np.testing.assert_array_equal(tM.numpy(), np.asarray(jM))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    disp = rng.uniform(-20, 20, (24, 36)).astype(np.float32)
    ref = np.asarray(jr.triangulate_from_operator(jnp.asarray(disp), jM, jb,
                                                  row0=8.0))
    got = tr.triangulate_from_operator(torch.from_numpy(disp), tM, tb,
                                       row0=8.0).numpy()
    # metres at ~1e2 magnitude: float32 resolution is ~1e-5
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_rectify_arrays(rng):
    img1 = rng.uniform(0, 1, (40, 48)).astype(np.float32)
    img2 = rng.uniform(0, 1, (40, 48)).astype(np.float32)
    H1 = np.array([[0.98, 0.2, 3.0], [-0.2, 0.98, 1.0]], np.float32)
    H2 = np.array([[1.01, 0.1, -2.0], [-0.1, 1.0, 4.0]], np.float32)
    ref = jr.rectify_arrays(jnp.asarray(img1), jnp.asarray(img2),
                            jnp.asarray(H1), jnp.asarray(H2), (44, 52))
    got = tr.rectify_arrays(torch.from_numpy(img1), torch.from_numpy(img2),
                            torch.from_numpy(H1), torch.from_numpy(H2),
                            (44, 52))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_render_view_on_reference_terrain():
    """The port's renderer on the reference scene's own terrain/texture."""
    scene = js.make_stereo_scene(seed=3, out_shape=(64, 64),
                                 ground_shape=(96, 96), h_range=(0.0, 30.0))
    jcam = scene.cameras[0]
    tcam = ta.AffineCamera(A=torch.from_numpy(np.array(jcam.A)),
                           b=torch.from_numpy(np.array(jcam.b)))
    ref_img, ref_z = js.render_view(jcam, scene.terrain, scene.texture,
                                    scene.ground_origin, scene.ground_gsd,
                                    (64, 64))
    img, z = ts.render_view(tcam, torch.from_numpy(np.array(scene.terrain)),
                            torch.from_numpy(np.array(scene.texture)),
                            scene.ground_origin, scene.ground_gsd, (64, 64))
    ref_img, ref_z = np.asarray(ref_img), np.asarray(ref_z)
    same = np.isfinite(ref_z) == np.isfinite(z.numpy())
    assert same.mean() == 1.0
    # the fixed point is iterated 12 times through bilinear lookups; pixels
    # on building walls (occlusion edges) may settle on another branch
    close = np.abs(img.numpy() - ref_img) <= 1e-4
    assert close.mean() >= 0.99
    fin = np.isfinite(ref_z)
    assert (np.abs(z.numpy()[fin] - ref_z[fin]) <= 1e-3).mean() >= 0.99


def test_port_scene_deterministic_and_consistent():
    kw = dict(seed=5, out_shape=(64, 64), ground_shape=(96, 96),
              h_range=(0.0, 30.0))
    a = ts.make_stereo_scene(**kw)
    b = ts.make_stereo_scene(**kw)
    for x, y in zip(a.images + [a.terrain], b.images + [b.terrain]):
        assert torch.equal(x, y)
    c = ts.make_stereo_scene(**{**kw, "seed": 6})
    assert not torch.equal(a.terrain, c.terrain)
    # the RPC wrapper reproduces its affine camera exactly (to float32)
    lon_r, lat_r = ts.aoi_lonlat_ranges(a)
    llh = ta.probe_grid(lon_r, lat_r, (0.0, 30.0), (3, 3, 3))
    col, row = a.rpcs[0].project_np(llh[:, 0], llh[:, 1], llh[:, 2])
    x, y, z = a.frame.to_local_np(llh[:, 0], llh[:, 1], llh[:, 2])
    pix = np.stack([x, y, z], 1) @ a.cameras[0].A.double().numpy().T \
        + a.cameras[0].b.double().numpy()
    np.testing.assert_allclose(np.stack([col, row], 1), pix, atol=1e-6)
    assert a.images[0].shape == (64, 64)
    assert ((a.images[0] >= 0) | (a.images[0] == -1)).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_aoi_ranges_match_reference(seed):
    """aoi_lonlat_ranges through convert.scene_from_arrays == pcmi_tpu's."""
    scene = js.make_stereo_scene(seed=seed, out_shape=(32, 32),
                                 ground_shape=(48, 48))
    port = convert.scene_from_arrays(
        [np.asarray(i) for i in scene.images], np.asarray(scene.terrain),
        scene.ground_origin, scene.ground_gsd,
        (float(scene.frame.lon0), float(scene.frame.lat0)),
        [r._f64 for r in scene.rpcs], scene.h_range)
    assert ts.aoi_lonlat_ranges(port) == js.aoi_lonlat_ranges(scene)


def test_rpc_localize_inverts_project():
    """The Newton inverse (10 float32 steps, Jacobian by forward-mode
    differentiation in both packages) against the reference's: lon/lat
    within 2e-6 degrees (~0.2 m; float32 holds these degrees to ~4e-6),
    and back through the float64 projection within 1 px (the float32
    degrees alone are ~0.4 px of this camera's 0.5 m pixels)."""
    jrpc = _cams()[0]
    trpc = convert.rpc_from_reference(jrpc._f64)
    rng = np.random.default_rng(4)
    col = rng.uniform(10, 118, 40).astype(np.float32)
    row = rng.uniform(10, 118, 40).astype(np.float32)
    h = rng.uniform(0, 40, 40).astype(np.float32)
    jlon, jlat = jrpc.localize(jnp.asarray(col), jnp.asarray(row),
                               jnp.asarray(h))
    tlon, tlat = trpc.localize(torch.from_numpy(col), torch.from_numpy(row),
                               torch.from_numpy(h))
    np.testing.assert_allclose(tlon.numpy(), np.asarray(jlon), atol=2e-6,
                               rtol=0)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), atol=2e-6,
                               rtol=0)
    c2, r2 = trpc.project_np(tlon.numpy(), tlat.numpy(), h)
    assert np.abs(c2 - col).max() < 1.0 and np.abs(r2 - row).max() < 1.0


def test_affine_camera_frame_and_residual(rng):
    """to_local (float32), project, view_direction and the fit residual
    against the reference."""
    jrpc = _cams()[1]
    trpc = convert.rpc_from_reference(jrpc._f64)
    llh = ja.probe_grid(LON, LAT, (0.0, 40.0))
    jframe = ja.LocalFrame(jnp.float32(np.mean(LON)),
                           jnp.float32(np.mean(LAT)))
    tframe = ta.LocalFrame(np.mean(LON), np.mean(LAT))
    jcam = ja.fit_affine_camera(jrpc, jframe, llh)
    tcam = ta.fit_affine_camera(trpc, tframe, llh)
    lon = rng.uniform(*LON, 30).astype(np.float32)
    lat = rng.uniform(*LAT, 30).astype(np.float32)
    h = rng.uniform(0, 40, 30).astype(np.float32)
    jx = jframe.to_local(jnp.asarray(lon), jnp.asarray(lat), jnp.asarray(h))
    tx = tframe.to_local(torch.from_numpy(lon), torch.from_numpy(lat),
                         torch.from_numpy(h))
    for a, b in zip(tx, jx):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    xyz = np.stack([np.asarray(v) for v in jx], -1).astype(np.float32)
    np.testing.assert_allclose(tcam.project(torch.from_numpy(xyz)).numpy(),
                               np.asarray(jcam.project(jnp.asarray(xyz))),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(tcam.view_direction().numpy(),
                               np.asarray(jcam.view_direction()), atol=1e-6,
                               rtol=0)
    assert tcam.view_direction()[2] > 0
    res = ta.affine_fit_residual(trpc, tframe, tcam, llh)
    assert res == ja.affine_fit_residual(jrpc, jframe, jcam, llh) and res < 0.5


def test_rectify_images_and_triangulate_disparity(rng):
    jrpcs = _cams()
    trpcs = [convert.rpc_from_reference(r._f64) for r in jrpcs]
    jg = jr.build_geometry_from_rpcs(*jrpcs, LON, LAT, (0.0, 40.0),
                                     (128, 128), (128, 128))
    tg = tr.build_geometry_from_rpcs(*trpcs, LON, LAT, (0.0, 40.0),
                                     (128, 128), (128, 128))
    img1 = rng.uniform(0, 1, (128, 128)).astype(np.float32)
    img2 = rng.uniform(0, 1, (128, 128)).astype(np.float32)
    ref = jr.rectify_images(jg, jnp.asarray(img1), jnp.asarray(img2))
    got = tr.rectify_images(tg, torch.from_numpy(img1),
                            torch.from_numpy(img2))
    # sample coordinates of ~600 px carry ~6e-5 px of float32 rounding
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    h, w = tg.out_shape
    disp = rng.uniform(-10, 10, (h, w)).astype(np.float32)
    valid = rng.uniform(0, 1, (h, w)) > 0.3
    jxyz, jh = jr.triangulate_disparity(jg, jnp.asarray(disp),
                                        jnp.asarray(valid))
    txyz, th = tr.triangulate_disparity(tg, torch.from_numpy(disp),
                                        torch.from_numpy(valid))
    np.testing.assert_allclose(txyz.numpy(), np.asarray(jxyz), atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(np.isnan(th.numpy()), ~valid)
    np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid],
                               atol=1e-4, rtol=0)
