"""The port's command line (``python -m pcmi_tpu_torch``) and registry on
the CPU, from NITF files on disk (``tests/_torch_ntf.py``), against the
reference's ``pcmi_tpu.cli``."""

import io
import json
import os
import runpy
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from _torch_ntf import OVERRIDES, dsm_errors, write_ntf_dir
from pcmi_tpu.cli import main as jmain
from pcmi_tpu_torch import cli, registry
from pcmi_tpu_torch.io.raster import read_geo, read_ply, read_tiff, write_tiff

torch.set_num_threads(1)

PORTED = ["detection", "generative-restoration", "height-map", "inpainting",
          "land-use", "restoration", "saliency", "stitching",
          "super-resolution"]


@pytest.fixture(scope="module")
def ntf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("wv3")
    scene, port_scene = write_ntf_dir(d)
    return d, scene, port_scene


def _args(cmd, d, out, *extra):
    args = [cmd, "--images", str(d), "--kml", str(d / "aoi.kml"),
            "--output", str(out)]
    for o in OVERRIDES:
        args += ["--set", o]
    return args + list(extra)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _gates(path, scene, cell_count=200):
    """A written north-up DSM against the terrain: the gates of
    ``tests/test_ingest.py`` (median |error| < 1 m, RMSE < 2.5 m)."""
    dsm = read_tiff(path)
    geo = read_geo(path)
    sx, sy = geo["scale"]
    assert sx > 0 and sy > 0  # north-up
    err = dsm_errors(dsm, *geo["origin"], sx, sy, scene)
    assert err.size > cell_count
    assert np.median(np.abs(err)) < 1.0
    assert float(np.sqrt(np.mean(err ** 2))) < 2.5


@pytest.fixture(scope="module")
def height_maps(ntf_dir, tmp_path_factory):
    """``height-map`` of both packages over the directory, the port's on
    ``--device cpu``: their summary lines and output directories."""
    d, _, _ = ntf_dir
    out = {}
    for name, main, extra in (("ref", jmain, ()),
                              ("port", cli.main, ("--device", "cpu"))):
        o = tmp_path_factory.mktemp(f"hm_{name}")
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = main(_args("height-map", d, o, *extra))
        assert rc == 0
        out[name] = (json.loads(buf.getvalue().strip().splitlines()[-1]), o)
    return out


def test_height_map_summary_matches_reference(height_maps):
    (js, _), (ts, _) = height_maps["ref"], height_maps["port"]
    for key in ("pair", "canvas", "valid_fraction", "points",
                "convergence_deg", "dsm_shape"):
        assert ts[key] == js[key], key
    assert ts["pair"] == ["acq_0.ntf", "acq_1.ntf"]
    # below max_points (1 << 18): every pixel is kept, no subset is drawn
    assert ts["canvas"][0] * ts["canvas"][1] < 1 << 18
    assert ts["points"] > 500 and ts["valid_fraction"] > 0.05


def test_height_map_rasters_match_reference(height_maps):
    (_, jo), (ts, to) = height_maps["ref"], height_maps["port"]
    jd, td = read_tiff(str(jo / "disparity.tif")), read_tiff(str(to / "disparity.tif"))
    jh, th = read_tiff(str(jo / "height.tif")), read_tiff(str(to / "height.tif"))
    assert td.shape == tuple(ts["canvas"])
    valid = np.isfinite(th)
    np.testing.assert_array_equal(valid, np.isfinite(jh))
    assert valid.mean() == ts["valid_fraction"]
    # measured: identical masks; the rectified and normalised inputs
    # bit-equal to the reference's (its compiler's multiply-adds, LAPACK's
    # inverse and the reciprocal of a constant divisor, copied), the
    # disparity within 3.9e-6 px and the heights within 1.8e-5 m on every
    # valid pixel (the matcher's float32 sums in another order)
    diff = np.abs(td - jd)[valid]
    assert diff.max() <= 1e-5
    assert np.abs(th - jh)[valid].max() <= 1e-4


def test_height_map_cloud_and_dsm(height_maps, ntf_dir):
    (js, jo), (ts, to) = height_maps["ref"], height_maps["port"]
    pts, vals = read_ply(str(to / "cloud.ply"))
    assert len(pts) == ts["points"]
    np.testing.assert_array_equal(vals, pts[:, 2])
    jpts, _ = read_ply(str(jo / "cloud.ply"))
    np.testing.assert_allclose(pts, jpts, atol=1e-2, rtol=0)
    assert list(read_tiff(str(to / "dsm.tif")).shape) == ts["dsm_shape"]
    _gates(str(to / "dsm.tif"), ntf_dir[1])


def test_fuse_from_disk(ntf_dir, tmp_path, capsys):
    d, scene, _ = ntf_dir
    assert cli.main(_args("fuse", d, tmp_path, "--device", "cpu")) == 0
    s = _last_json(capsys)
    assert s["points"] > 1000 and len(s["icp_rmse"]) == 1
    pts, vals = read_ply(str(tmp_path / "fused_cloud.ply"))
    assert len(pts) == s["points"] and np.isfinite(pts).all()
    assert list(read_tiff(str(tmp_path / "dsm.tif")).shape) == s["dsm_shape"]
    _gates(str(tmp_path / "dsm.tif"), scene)


def test_stream_from_disk(ntf_dir, tmp_path, capsys):
    d, scene, _ = ntf_dir
    assert cli.main(_args("stream", d, tmp_path, "--device", "cpu")) == 0
    s = _last_json(capsys)
    assert s["pairs"] == 1 and s["tiles"] >= 1 and s["filled"] > 0.05
    n_pairs = read_tiff(str(tmp_path / "n_pairs.tif"))
    assert list(n_pairs.shape) == s["dsm_shape"]
    assert set(np.unique(n_pairs)) <= {0.0, 1.0}
    assert os.path.exists(tmp_path / "hillshade.png") or \
        os.path.exists(tmp_path / "hillshade.png.npy")
    _gates(str(tmp_path / "dsm.tif"), scene)


def test_height_range_override_as_a_list_of_ints(ntf_dir):
    """``--set rectify.height_range=[0,30]`` parses to a list of ints;
    the geometry and the search range it gives are the tuple's."""
    from pcmi_tpu_torch.pipelines.height_map import HeightMapPipeline
    from pcmi_tpu_torch.pipelines.ingest import (
        discover_acquisitions, prepare_aoi_stack)

    d, _, _ = ntf_dir
    args = cli.build_parser().parse_args(
        ["height-map", "--set", "rectify.height_range=[0,30]"])
    listed = cli._config(args)
    assert listed.rectify.height_range == [0, 30]
    tupled = listed.replace(rectify=listed.rectify.__class__(
        height_range=(0.0, 30.0)))
    imgs, rpcs, _, lon, lat = prepare_aoi_stack(
        discover_acquisitions(str(d)), kml_path=str(d / "aoi.kml"))
    geoms = []
    for cfg in (listed, tupled):
        pipe = HeightMapPipeline(cfg, device="cpu")
        g = pipe.build_geometry(rpcs[0], rpcs[1], lon, lat, imgs[0].shape,
                                imgs[1].shape)
        geoms.append((g, pipe.stereo_cfg_for([g])))
    np.testing.assert_array_equal(geoms[0][0].H1, geoms[1][0].H1)
    assert geoms[0][1] == geoms[1][1]


def test_device_defaults_to_cuda():
    for cmd in ("height-map", "fuse", "stream"):
        assert cli.build_parser().parse_args([cmd]).device == "cuda"
        assert cli.build_parser().parse_args(
            [cmd, "--device", "cpu"]).device == "cpu"


@pytest.mark.parametrize("argv,message", [
    (["height-map"], "need --demo or --images"),
    (["fuse", "--images", "."], "--images requires --kml"),
    (["stream", "--images", "{empty}", "--kml", "x.kml"],
     "no usable acquisitions"),
])
def test_source_errors_exit_2(tmp_path, capsys, argv, message):
    argv = [a.replace("{empty}", str(tmp_path)) for a in argv]
    assert cli.main(argv + ["--device", "cpu"]) == 2
    assert message in capsys.readouterr().err


def test_list_and_registry(capsys):
    """All nine of the reference's plugins are available in the port,
    ``generative-restoration`` (under its member's tab) among them, and
    none is listed as unavailable."""
    assert registry.available() == PORTED
    assert registry.failures() == {}
    assert registry.groups() == {
        "jasraj": ["detection", "land-use", "restoration", "stitching"],
        "marcin": ["generative-restoration"],
        "rafael": ["height-map", "saliency"],
        "stan": ["inpainting", "super-resolution"]}
    assert cli.main(["list"]) == 0
    out = capsys.readouterr()
    assert out.out.split() == PORTED
    assert "unavailable:" not in out.err


def test_registry_create():
    from pcmi_tpu_torch.pipelines.height_map import HeightMapExtractor

    plugin = registry.create("height-map")
    assert isinstance(plugin, HeightMapExtractor)
    assert plugin.pipeline.device == torch.device("cuda")
    assert plugin.name == "Multi-day 3D Point Cloud"
    from pcmi_tpu_torch.pipelines.saliency import SaliencyDetector

    sal = registry.create("saliency")
    assert isinstance(sal, SaliencyDetector)
    assert sal.device == torch.device("cuda")
    assert registry.create("saliency", device="cpu").device == \
        torch.device("cpu")
    assert registry.create("height-map", device="cpu").pipeline.device == \
        torch.device("cpu")
    with pytest.raises(KeyError):
        registry.create("nope")


def test_run_unknown_plugin_exits_2(tmp_path, capsys):
    p = str(tmp_path / "in.tif")
    write_tiff(p, np.zeros((8, 8), np.float32))
    assert cli.main(["run", "nope", "--input", p]) == 2
    assert "unknown plugin 'nope'" in capsys.readouterr().err


def test_run_generative_restoration_on_the_cpu(tmp_path, capsys):
    """``run generative-restoration`` loads the ninth plugin and restores
    an 8x8 image with a NaN hole on the CPU: exit 0, its two layers
    written, the restored one finite."""
    p = str(tmp_path / "in.tif")
    img = np.full((8, 8), 0.5, np.float32)
    img[3:5, 3:5] = np.nan
    write_tiff(p, img)
    out = tmp_path / "out"
    assert cli.main(["run", "generative-restoration", "--input", p,
                     "--output", str(out), "--device", "cpu"]) == 0
    written = capsys.readouterr().out.split()
    assert [os.path.basename(w) for w in written] == ["input.tif",
                                                      "restored.tif"]
    restored = read_tiff(written[1])
    assert restored.shape == (8, 8) and np.isfinite(restored).all()


def test_run_height_map_without_sources_writes_an_error_layer(tmp_path,
                                                              capsys):
    """A plugin that fails gives the reference host's error layer and
    exit code 1, never 0."""
    p = str(tmp_path / "in.tif")
    write_tiff(p, np.ones((8, 8), np.float32))
    out = tmp_path / "out"
    assert cli.main(["run", "height-map", "--input", p, "--output",
                     str(out)]) == 1
    cap = capsys.readouterr()
    assert "set_sources" in cap.err
    (written,) = cap.out.split()
    assert os.path.basename(written).startswith("ERROR_")
    assert "/" not in os.path.basename(written)
    np.testing.assert_array_equal(read_tiff(written), np.zeros((8, 8)))


def test_save_layers_writes_points_as_json(tmp_path):
    layers = [(torch.arange(6.0).reshape(2, 3), {"name": "a/b"}, "image"),
              (np.ones((4, 3)), {"name": "pts"}, "points")]
    paths = cli._save_layers(layers, str(tmp_path))
    assert [os.path.basename(p) for p in paths] == ["a_b.tif", "pts.json"]
    np.testing.assert_array_equal(read_tiff(paths[0]),
                                  np.arange(6.0).reshape(2, 3))
    with open(paths[1]) as fh:
        assert json.load(fh) == np.ones((4, 3)).tolist()


def test_north_up_geotiff(tmp_path):
    ny, nx, cell = 5, 4, 2.0
    dsm = np.arange(ny * nx, dtype=np.float32).reshape(ny, nx)
    p = str(tmp_path / "dsm.tif")
    cli._write_north_up(p, dsm, origin_min_xy=(100.0, 200.0), cell=cell)
    g = read_geo(p)
    assert g["scale"] == (cell, cell)
    assert g["origin"] == (100.0, 200.0 + ny * cell)
    img = read_tiff(p)
    np.testing.assert_array_equal(img[0], dsm[-1])
    np.testing.assert_array_equal(img[-1], dsm[0])


def test_python_m_help(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["pcmi_tpu_torch", "--help"])
    with pytest.raises(SystemExit) as exc:
        runpy.run_module("pcmi_tpu_torch", run_name="__main__")
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert "{list,run,height-map,fuse,stream}" in out
