"""The port's headless viewer host (``pcmi_tpu_torch.viewer``) and its
height-map plugin on the CPU: ``PluginRunner`` against a mock viewer,
``main()`` under stub ``napari`` / ``magicgui`` modules and without them
(as ``tests/test_viewer_host.py`` and ``tests/test_viewer_main.py`` hold
the reference's), and ``HeightMapExtractor``'s layers against the
reference's on the same pair of NITF acquisitions."""

import inspect
import sys
import time
import types
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_ntf import CFG, write_ntf_dir
from pcmi_tpu import viewer as jviewer
from pcmi_tpu.pipelines import height_map as jh
from pcmi_tpu.pipelines import ingest as jing
from pcmi_tpu_torch import convert, registry
from pcmi_tpu_torch import viewer as tviewer
from pcmi_tpu_torch.geometry.pairs import ImageMeta
from pcmi_tpu_torch.interface import SatellitePlugin, as_numpy_layers
from pcmi_tpu_torch.io.raster import write_tiff
from pcmi_tpu_torch.pipelines import height_map as th
from pcmi_tpu_torch.pipelines import ingest as ting
from pcmi_tpu_torch.viewer import (
    PluginRunner, add_layers, coerce_extras, demo_layers, list_samples,
    load_image, widget_spec)

torch.set_num_threads(1)


class MockViewer:
    def __init__(self):
        self.layers = []

    def add_image(self, data, **params):
        self.layers.append(("image", np.asarray(data), params))

    def add_points(self, data, **params):
        self.layers.append(("points", np.asarray(data), params))

    def add_shapes(self, data, **params):
        self.layers.append(("shapes", np.asarray(data), params))

    def add_labels(self, data, **params):
        self.layers.append(("labels", np.asarray(data), params))


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    """The ingested acquisitions of both packages."""
    d = tmp_path_factory.mktemp("wv3")
    write_ntf_dir(d)
    kml = str(d / "aoi.kml")
    return (jing.prepare_aoi_stack(jing.discover_acquisitions(str(d)),
                                   kml_path=kml),
            ting.prepare_aoi_stack(ting.discover_acquisitions(str(d)),
                                   kml_path=kml))


def _extractor(stack):
    images, rpcs, _, lon, lat = stack
    plugin = th.HeightMapExtractor(th.HeightMapPipeline(
        convert.config_from_reference(CFG), device="cpu"))
    plugin.set_sources(images, rpcs, lon, lat)
    return plugin


@pytest.fixture(scope="module")
def layers(stacks):
    jstack, tstack = stacks
    images, rpcs, _, lon, lat = jstack
    jplugin = jh.HeightMapExtractor(jh.HeightMapPipeline(CFG))
    jplugin.set_sources(images, rpcs, lon, lat)
    return (jviewer.as_numpy_layers(jplugin.run(pair=(0, 1))),
            _extractor(tstack).run(pair=(0, 1)))


def test_extractor_layers_match_reference(layers):
    jl, tl = layers
    assert [(p["name"], k) for _, p, k in tl] == \
        [(p["name"], k) for _, p, k in jl] == [
            ("disparity [0-1]", "image"), ("photoconsistency [0-1]", "image"),
            ("invalid mask [0-1]", "image"), ("point cloud [0-1]", "points")]
    for (jd, jp, _), (td, tp, _) in zip(jl, tl):
        assert set(tp) == set(jp) and td.shape == jd.shape
        assert td.dtype == jd.dtype
    invalid = tl[2][0].astype(bool)
    np.testing.assert_array_equal(tl[2][0], jl[2][0])
    assert np.isnan(tl[0][0][invalid]).all()
    # the CLI's pair (tests/test_torch_cli.py): disparity within 1e-5 px on
    # every valid pixel
    diff = np.abs(tl[0][0] - jl[0][0])[~invalid]
    assert diff.max() <= 1e-5
    # the points: the same pixels [z, y, x], heights within 1e-4 m
    (jpts, jpar, _), (tpts, tpar, _) = jl[3], tl[3]
    np.testing.assert_array_equal(tpts[:, 1:], jpts[:, 1:])
    assert np.abs(tpts[:, 0] - jpts[:, 0]).max() <= 1e-4
    np.testing.assert_array_equal(tpar["features"]["height"], tpts[:, 0])
    assert tpar["size"] == jpar["size"] == 1


@pytest.mark.parametrize("mode,kw,tags", [
    ("first", dict(with_metas=True, n=3), ["0-1"]),
    ("random", dict(with_metas=True, seed=7), ["0-1"]),
    ("first", dict(n=1), ["0-1"]),
])
def test_extractor_through_the_runner(stacks, mode, kw, tags):
    """The plugin runs from the host through ``PluginRunner`` (its extra
    parameters coerced from strings), on its pipeline's device."""
    _, tstack = stacks
    plugin = _extractor(tstack)
    runner = PluginRunner(plugin)
    extras = {"mode": mode}
    if kw.get("with_metas"):
        extras["metas"] = tstack[2]
    extras.update(coerce_extras(runner, {
        k: str(v) for k, v in kw.items() if k in ("n", "seed")}))
    viewer = MockViewer()
    runner.run(on_done=lambda ls: add_layers(viewer, ls), **extras)
    assert runner.last_error is None
    names = [p["name"] for _, _, p in viewer.layers]
    assert names == [f"{n} [{t}]" for t in tags for n in (
        "disparity", "photoconsistency", "invalid mask", "point cloud")]


def test_extractor_refusals(stacks):
    plugin = th.HeightMapExtractor(th.HeightMapPipeline(device="cpu"))
    with pytest.raises(RuntimeError, match="set_sources"):
        plugin.run()
    _, tstack = stacks
    plugin = _extractor(tstack)
    far = [ImageMeta(0, 5.0, 0.0), ImageMeta(1, 5.5, 0.0)]  # too close
    with pytest.raises(ValueError, match="no stereo pairs"):
        plugin.run(metas=far)
    assert th.HeightMapExtractor().pipeline.device == torch.device("cuda")


def test_as_numpy_layers_takes_tensors():
    t = torch.arange(4.0, requires_grad=True)
    (data, params, kind), = as_numpy_layers([(t * 2, {"name": "x"}, "image")])
    assert isinstance(data, np.ndarray)
    np.testing.assert_array_equal(data, [0.0, 2.0, 4.0, 6.0])


def test_widget_spec_and_coerce_extras_match_reference():
    trunner = PluginRunner(th.HeightMapExtractor(
        th.HeightMapPipeline(device="cpu")))
    jrunner = jviewer.PluginRunner(jh.HeightMapExtractor(
        jh.HeightMapPipeline()))
    spec = widget_spec(trunner)
    assert spec == jviewer.widget_spec(jrunner)
    assert [f["name"] for f in spec["fields"]] == [
        "image", "pair", "metas", "mode", "n", "seed"]
    assert not trunner.needs_image2() and trunner.file_params() == []
    values = {"n": "2", "mode": "random", "seed": "3", "pair": "",
              "unknown": "1"}
    assert coerce_extras(trunner, values) == \
        jviewer.coerce_extras(jrunner, values) == \
        {"n": 2, "mode": "random", "seed": 3}


def test_busy_guard_blocks_reentry():
    class Slow(SatellitePlugin):
        @property
        def name(self):
            return "slow"

        def run(self, image, viewer=None):
            time.sleep(0.4)
            return [(torch.zeros(4, 4), {"name": "ok"}, "image")]

    runner = PluginRunner(Slow())
    done = []
    worker = runner.run(image=np.zeros((4, 4), np.float32),
                        on_done=done.append, block=False)
    assert runner.busy
    with pytest.raises(RuntimeError):
        runner.run(image=np.zeros((4, 4), np.float32))
    worker.join(timeout=30)
    assert not worker.is_alive()
    assert not runner.busy and len(done) == 1
    assert isinstance(done[0][0][0], np.ndarray)  # tensors leave as numpy
    runner.run(image=np.zeros((4, 4), np.float32), on_done=done.append)
    assert len(done) == 2


def test_error_becomes_error_layer():
    class Boom(SatellitePlugin):
        @property
        def name(self):
            return "boom"

        def run(self, image, viewer=None):
            raise ValueError("intentional")

    viewer = MockViewer()
    runner = PluginRunner(Boom())
    runner.run(image=np.zeros((6, 6), np.float32),
               on_done=lambda ls: add_layers(viewer, ls))
    assert runner.last_error == "ValueError: intentional"
    (kind, data, params), = viewer.layers
    assert kind == "image" and params["name"] == "ERROR boom: intentional"
    assert data.shape == (6, 6) and not runner.busy


def test_requires_viewer_receives_handle():
    seen = {}

    class NeedsViewer(SatellitePlugin):
        @property
        def name(self):
            return "needs-viewer"

        @property
        def requires_viewer(self):
            return True

        def run(self, image, viewer=None):
            seen["viewer"] = viewer
            return []

    runner = PluginRunner(NeedsViewer())
    runner.run(image=np.zeros((4, 4), np.float32))
    assert "viewer" in seen and seen["viewer"] is None
    viewer = MockViewer()
    PluginRunner(NeedsViewer(), viewer=viewer).run(
        image=np.zeros((4, 4), np.float32))
    assert seen["viewer"] is viewer


def test_dataset_loader_lists_and_loads(tmp_path):
    d = tmp_path / "data" / "samples"
    d.mkdir(parents=True)
    img = np.arange(64, dtype=np.float32).reshape(8, 8)
    write_tiff(str(d / "sample.tif"), img)
    np.save(str(tmp_path / "a.npy"), img.astype(np.int16))
    found = list_samples(str(tmp_path))
    assert found == jviewer.list_samples(str(tmp_path))
    assert len(found) == 1
    np.testing.assert_array_equal(load_image(found[0]), img)
    loaded = load_image(str(tmp_path / "a.npy"))
    assert loaded.dtype == np.float32
    np.testing.assert_array_equal(loaded, img)
    assert load_image(img) is img
    np.testing.assert_array_equal(load_image(SimpleNamespace(data=img)), img)
    with pytest.raises(ValueError):
        load_image(str(tmp_path / "x.png"))


def test_demo_layers_shapes():
    layers = demo_layers(seed=1)
    assert [(p["name"], k) for _, p, k in layers] == [
        ("demo view 0", "image"), ("demo view 1", "image"),
        ("demo truth height", "image")]
    assert [d.shape for d, _, _ in layers] == [(512, 512), (512, 512),
                                              (640, 640)]
    assert all(isinstance(d, np.ndarray) for d, _, _ in layers)


# ---------------------------------------------------------------------------
# main() under stub napari / magicgui modules (tests/test_viewer_main.py)
# ---------------------------------------------------------------------------

class FakeQtWindow:
    def __init__(self):
        self.tabified = []

    def tabifyDockWidget(self, a, b):
        self.tabified.append((a, b))


class FakeWindow:
    def __init__(self):
        self.docks = {}
        self._qt_window = FakeQtWindow()

    def add_dock_widget(self, widget, name=None, area=None):
        dock = SimpleNamespace(widget=widget, name=name, area=area)
        self.docks[name] = dock
        return dock


class _LayerList(list):
    def __init__(self):
        super().__init__()
        self.selection = SimpleNamespace(active=None)


class FakeViewer:
    def __init__(self, title=""):
        self.title = title
        self.window = FakeWindow()
        self.layers = _LayerList()

    def _add(self, kind, data, **params):
        self.layers.append(SimpleNamespace(
            kind=kind, data=np.asarray(data), params=params,
            name=params.get("name", "")))

    def add_image(self, data, **params):
        self._add("image", data, **params)

    def add_points(self, data, **params):
        self._add("points", data, **params)


@pytest.fixture
def stub_host(monkeypatch):
    created = []
    napari = types.ModuleType("napari")

    def viewer_factory(*args, **kwargs):
        created.append(FakeViewer(*args, **kwargs))
        return created[-1]

    napari.Viewer = viewer_factory
    napari.run = lambda: None
    magicgui_mod = types.ModuleType("magicgui")

    def magicgui(call_button=None, **field_options):
        def deco(fn):
            fn._magicgui = {"call_button": call_button,
                            "fields": field_options}
            return fn

        return deco

    magicgui_mod.magicgui = magicgui
    monkeypatch.setitem(sys.modules, "napari", napari)
    monkeypatch.setitem(sys.modules, "magicgui", magicgui_mod)
    return created


def test_main_builds_the_host(stub_host):
    assert tviewer.main() == 0
    (v,) = stub_host
    assert v.title == "pcmi_tpu_torch"
    assert set(v.window.docks) == {
        "dataset", "rafael: Multi-day 3D Point Cloud",
        "rafael: Saliency Detection", "jasraj: Image Restoration",
        "jasraj: Image Stitching", "jasraj: Land Use Classification",
        "jasraj: Object Detection", "stan: Super Resolution",
        "stan: Inpainting", "marcin: Generative Restoration"}
    # each member's plugins tab together: 3 + 1 + 1 tabify calls (the
    # one plugin of marcin's tab needs none)
    assert len(v.window._qt_window.tabified) == 5
    widget = v.window.docks["rafael: Multi-day 3D Point Cloud"].widget
    assert widget._magicgui["call_button"] == "Run Multi-day 3D Point Cloud"
    assert list(inspect.signature(widget).parameters) == [
        "pair", "metas", "mode", "n", "seed"]


def test_main_dataset_loader_demo_scene(stub_host):
    assert tviewer.main() == 0
    load_dataset = stub_host[0].window.docks["dataset"].widget
    assert load_dataset._magicgui["fields"]["path"]["choices"][0] == \
        "<demo scene>"
    load_dataset()
    assert [l.name for l in stub_host[0].layers] == [
        "demo view 0", "demo view 1", "demo truth height"]


def test_main_run_widget_round_trip(stub_host):
    """Pressing the height-map plugin's Run button without sources gives
    the error layer through the worker thread, not a crash."""
    assert tviewer.main() == 0
    v = stub_host[0]
    v.layers.selection.active = SimpleNamespace(
        data=np.zeros((12, 10), np.float32))
    v.window.docks["rafael: Multi-day 3D Point Cloud"].widget(n="1")
    deadline = time.time() + 60.0
    while not v.layers and time.time() < deadline:
        time.sleep(0.02)
    (layer,) = v.layers
    assert layer.name.startswith("ERROR Multi-day 3D Point Cloud")
    assert "set_sources" in layer.name and layer.data.shape == (12, 10)


def test_main_degrades_headless(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "napari", None)
    assert tviewer.main() == 1
    assert "python -m pcmi_tpu_torch --help" in capsys.readouterr().out
    assert registry.available() == [
        "detection", "generative-restoration", "height-map", "inpainting",
        "land-use", "restoration", "saliency", "stitching",
        "super-resolution"]
