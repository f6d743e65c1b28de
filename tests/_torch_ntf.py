"""Shared inputs of the port's host-side tests: a directory of NITF
acquisitions (the reference's 256x256 seed-3 scene of
``tests/test_ingest.py``, written by the reference's NITF writer, so both
packages read the same files), its config, and the RPC comparison."""

import numpy as np

from pcmi_tpu.config import PipelineConfig, RectifyConfig, StereoConfig
from pcmi_tpu.geometry.synthetic import aoi_lonlat_ranges, make_stereo_scene
from pcmi_tpu.io.nitf import csexra_tre, rpc00b_tre, use00a_tre, write_nitf
from pcmi_tpu_torch import convert

VIEWS = ((10.0, 80.0), (20.0, 250.0))
# RPC00B carries offsets at fixed ASCII precision: a representable anchor
ORIGIN = (-58.58, -34.49)
H_RANGE = (0.0, 30.0)
# the reference CLI test's overrides (tests/test_ingest.py), and the
# reference config they give
OVERRIDES = ["stereo.block_size=7", "stereo.census_window=5",
             "stereo.margin_undefined=6", "stereo.edge_dilation=4",
             "rectify.height_range=[0.0,30.0]"]
CFG = PipelineConfig(
    stereo=StereoConfig(block_size=7, census_window=5, margin_undefined=6,
                        edge_dilation=4),
    rectify=RectifyConfig(height_range=H_RANGE))

RPC_FIELDS = ("line_off", "samp_off", "lat_off", "long_off", "height_off",
              "line_scale", "samp_scale", "lat_scale", "long_scale",
              "height_scale", "line_num", "line_den", "samp_num", "samp_den")


def assert_same_rpc(jcam, tcam):
    """The port's float32 RPC fields bit-equal to the reference's, and the
    float64 originals equal."""
    for f in RPC_FIELDS:
        np.testing.assert_array_equal(getattr(tcam, f).numpy(),
                                      np.asarray(getattr(jcam, f)), err_msg=f)
    assert set(tcam.f64) == set(jcam._f64)
    for k, v in jcam._f64.items():
        np.testing.assert_array_equal(tcam.f64[k], v, err_msg=k)


def write_ntf_dir(d):
    """Write the acquisitions and ``aoi.kml`` (the scene's extent shrunk
    to 40% about its centre) into ``d``; returns ``(scene, port_scene)``,
    the reference's scene and the port's copy of it."""
    scene = make_stereo_scene(
        seed=3, out_shape=(256, 256), ground_shape=(384, 384),
        h_range=H_RANGE, views=VIEWS, origin_lonlat=ORIGIN)
    for i, (inc, az) in enumerate(VIEWS):
        tres = (rpc00b_tre(scene.rpcs[i]) + use00a_tre(inc)
                + csexra_tre(inc, az))
        write_nitf(str(d / f"acq_{i}.ntf"),
                   np.asarray(scene.images[i], np.float32), tres=tres,
                   idatim=f"2019{4 + i:02d}02110000")
    lon_r, lat_r = aoi_lonlat_ranges(scene)
    lon_mid = 0.5 * (lon_r[0] + lon_r[1])
    lat_mid = 0.5 * (lat_r[0] + lat_r[1])
    lon_r = tuple(lon_mid + 0.4 * (v - lon_mid) for v in lon_r)
    lat_r = tuple(lat_mid + 0.4 * (v - lat_mid) for v in lat_r)
    (d / "aoi.kml").write_text(
        '<?xml version="1.0"?><kml xmlns="http://www.opengis.net/kml/2.2">'
        "<Placemark><Polygon><outerBoundaryIs><LinearRing><coordinates>"
        f"{lon_r[0]},{lat_r[0]},0 {lon_r[1]},{lat_r[0]},0 "
        f"{lon_r[1]},{lat_r[1]},0 {lon_r[0]},{lat_r[1]},0 "
        f"{lon_r[0]},{lat_r[0]},0"
        "</coordinates></LinearRing></outerBoundaryIs></Polygon>"
        "</Placemark></kml>")
    port_scene = convert.scene_from_arrays(
        [np.asarray(im) for im in scene.images], np.asarray(scene.terrain),
        scene.ground_origin, scene.ground_gsd,
        (float(scene.frame.lon0), float(scene.frame.lat0)),
        [r._f64 for r in scene.rpcs], scene.h_range)
    return scene, port_scene


def dsm_errors(dsm, x0, ytop, sx, sy, scene):
    """A north-up DSM (row 0 northernmost, cells ``sx`` by ``sy`` from
    the corner ``(x0, ytop)``) against the scene's terrain: the errors of
    the filled in-bounds cells (``tests/test_ingest.py``'s computation)."""
    ny, nx = dsm.shape
    cx, cy = np.meshgrid(x0 + (np.arange(nx) + 0.5) * sx,
                         ytop - (np.arange(ny) + 0.5) * sy)
    ox, oy = scene.ground_origin
    terr = np.asarray(scene.terrain)
    gx = (cx - ox) / scene.ground_gsd
    gy = (cy - oy) / scene.ground_gsd
    inb = ((gx >= 0) & (gx < terr.shape[1] - 1) & (gy >= 0)
           & (gy < terr.shape[0] - 1))
    tt = terr[np.clip(gy.astype(int), 0, terr.shape[0] - 1),
              np.clip(gx.astype(int), 0, terr.shape[1] - 1)]
    m = np.isfinite(dsm) & inb
    return dsm[m] - tt[m]
