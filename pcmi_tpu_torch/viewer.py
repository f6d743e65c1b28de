"""Optional napari host over the plugin registry (port of
``pcmi_tpu/viewer.py``).

The reference host's generic plugin widget introspects each plugin's
``run()`` signature for a second image and extra parameters, offers
file/layer pickers, runs the plugin on a background worker with a busy
guard, turns errors into an error-named layer and adds the returned layer
tuples via ``viewer.add_<layer_type>``; a dataset loader lists sample
rasters.

All of that lives here in :class:`PluginRunner`, a Qt-free core that a
mock viewer drives in tests; ``main()`` is a thin napari/magicgui shell
over it and imports both lazily. Without them it says so and points to
the headless command line, ``python -m pcmi_tpu_torch``. A plugin runs on
the device of its own pipeline, from the runner's worker thread.
"""

from __future__ import annotations

import glob
import inspect
import os
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from pcmi_tpu_torch import registry
from pcmi_tpu_torch.interface import Layer, as_numpy_layers


def add_layers(viewer, layers: List[Layer]) -> None:
    """Add layer tuples to a napari viewer."""
    for data, params, kind in as_numpy_layers(layers):
        getattr(viewer, f"add_{kind}")(data, **params)


def load_image(source) -> np.ndarray:
    """Load an image from a path / array / napari layer.

    TIFF goes through the in-repo reader (no GDAL); ``.npy`` via numpy;
    arrays and layer objects pass through.
    """
    if isinstance(source, np.ndarray):
        return source
    if hasattr(source, "data"):          # napari layer duck-type
        return np.asarray(source.data)
    path = os.fspath(source)
    ext = os.path.splitext(path)[1].lower()
    if ext in (".tif", ".tiff"):
        from pcmi_tpu_torch.io.raster import read_tiff

        return np.asarray(read_tiff(path), np.float32)
    if ext == ".npy":
        return np.asarray(np.load(path), np.float32)
    raise ValueError(f"unsupported image source {path!r} (use .tif/.tiff/.npy)")


class PluginRunner:
    """The reference host's ``PluginWidget`` semantics, Qt-free and
    test-drivable.

    One runner wraps one plugin instance. The GUI shell (or a test's mock
    viewer) asks it what inputs the plugin wants (:meth:`needs_image2`,
    :meth:`extra_params`), then calls :meth:`run` — which enforces the
    busy-guard, executes on a worker thread, converts exceptions into the
    reference's error layer, and hands finished layers to ``on_done``.
    """

    def __init__(self, plugin, viewer=None):
        self.plugin = plugin
        self.viewer = viewer
        self._busy = threading.Lock()
        self.last_error: Optional[str] = None

    # -- signature introspection ------------------------------------------
    def _signature(self):
        return inspect.signature(self.plugin.run)

    def needs_image2(self) -> bool:
        """True if ``run()`` takes a second image."""
        return "image2" in self._signature().parameters

    def extra_params(self) -> Dict[str, inspect.Parameter]:
        """run() parameters beyond (image, image2, viewer): the host
        renders these as extra widget fields."""
        skip = {"self", "image", "image2", "viewer"}
        return {
            n: p for n, p in self._signature().parameters.items()
            if n not in skip and p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
        }

    def file_params(self) -> List[str]:
        """Extra params that look like file paths (get file pickers in the
        shell)."""
        return [n for n in self.extra_params()
                if n.endswith("_path") or n.endswith("_file") or n == "kml"]

    # -- execution ----------------------------------------------------------
    @property
    def busy(self) -> bool:
        return self._busy.locked()

    def run(
        self,
        image=None,
        image2=None,
        on_done: Optional[Callable[[List[Layer]], None]] = None,
        block: bool = True,
        **extra: Any,
    ):
        """Run the plugin; returns the worker thread (joined when ``block``).

        Busy guard: a second ``run`` while one is in flight raises
        ``RuntimeError`` (the reference host disables its run button
        instead). Errors never propagate: they become an ``ERROR ...``-named
        layer, and :attr:`last_error` holds them.
        """
        if not self._busy.acquire(blocking=False):
            raise RuntimeError(f"{self.plugin.name} is already running")

        img = load_image(image) if image is not None else None
        kwargs: Dict[str, Any] = dict(extra)
        if image2 is not None:
            kwargs["image2"] = load_image(image2)
        # honour requires_viewer: such plugins get the live viewer handle;
        # plain plugins still accept viewer=None
        if self.plugin.requires_viewer or self.viewer is not None:
            kwargs["viewer"] = self.viewer

        result: List[Layer] = []

        def work():
            try:
                try:
                    layers = self.plugin.run(img, **kwargs)
                except TypeError:
                    # plugins with non-image leading signatures (e.g. the
                    # height-map extractor runs from attached sources)
                    kwargs.pop("viewer", None)
                    layers = self.plugin.run(**kwargs)
                self.last_error = None
                result.extend(as_numpy_layers(layers))
            except Exception as exc:  # error layer, not a crash
                self.last_error = f"{type(exc).__name__}: {exc}"
                shape = img.shape[:2] if img is not None else (8, 8)
                result.append((
                    np.zeros(shape, np.float32),
                    {"name": f"ERROR {self.plugin.name}: {exc}"},
                    "image",
                ))
            finally:
                try:
                    if on_done is not None:
                        on_done(list(result))
                finally:
                    self._busy.release()

        worker = threading.Thread(target=work, daemon=True)
        worker.start()
        if block:
            worker.join()
        return worker


# -- dataset loader -------------------------------------------------------

SAMPLE_DIRS = ("data/samples", "data")


def list_samples(root: str = ".") -> List[str]:
    """Sample rasters the dataset loader offers."""
    out: List[str] = []
    for d in SAMPLE_DIRS:
        out += sorted(glob.glob(os.path.join(root, d, "*.tif")))
        out += sorted(glob.glob(os.path.join(root, d, "*.tiff")))
    return out


def demo_layers(seed: int = 0) -> List[Layer]:
    """Synthetic ground-truth scene as loadable layers (the in-repo
    stand-in for sample images)."""
    from pcmi_tpu_torch.geometry.synthetic import make_stereo_scene

    scene = make_stereo_scene(seed=seed, out_shape=(512, 512),
                              ground_shape=(640, 640))
    layers: List[Layer] = [
        (img.numpy(), {"name": f"demo view {i}"}, "image")
        for i, img in enumerate(scene.images)
    ]
    layers.append((scene.terrain.numpy(),
                   {"name": "demo truth height", "colormap": "turbo"}, "image"))
    return layers


def widget_spec(runner: PluginRunner) -> Dict[str, Any]:
    """Declarative description of the controls a GUI shell should render
    for this plugin (the testable core of the dynamic widget
    construction)."""
    fields: List[Dict[str, Any]] = [
        {"name": "image", "kind": "layer_or_file"}]
    if runner.needs_image2():
        fields.append({"name": "image2", "kind": "layer_or_file"})
    file_params = set(runner.file_params())
    for pname, p in runner.extra_params().items():
        default = None if p.default is inspect.Parameter.empty else p.default
        kind = "file" if pname in file_params else (
            type(default).__name__ if default is not None else "str")
        fields.append({"name": pname, "kind": kind, "default": default})
    return {"title": runner.plugin.name, "fields": fields}


def coerce_extras(runner: PluginRunner, values: Dict[str, str]) -> Dict[str, Any]:
    """Convert GUI string inputs to the types of the run() defaults."""
    out: Dict[str, Any] = {}
    params = runner.extra_params()
    for name, raw in values.items():
        if raw is None or raw == "" or name not in params:
            continue
        default = params[name].default
        if isinstance(default, bool):
            out[name] = str(raw).lower() in ("1", "true", "yes", "on")
        elif isinstance(default, int) and not isinstance(default, bool):
            out[name] = int(raw)
        elif isinstance(default, float):
            out[name] = float(raw)
        else:
            out[name] = raw
    return out


def main() -> int:
    try:
        import napari
        from magicgui import magicgui
    except Exception as exc:  # headless image: degrade with instructions
        print(f"napari unavailable ({exc}); use the headless CLI: "
              f"python -m pcmi_tpu_torch --help")
        return 1

    viewer = napari.Viewer(title="pcmi_tpu_torch")

    # dataset loader dock
    samples = list_samples()
    choices = ["<demo scene>"] + samples

    @magicgui(call_button="Load", path={"choices": choices})
    def load_dataset(path=choices[0]):
        if path == "<demo scene>":
            add_layers(viewer, demo_layers())
        else:
            viewer.add_image(load_image(path), name=os.path.basename(path))

    viewer.window.add_dock_widget(load_dataset, name="dataset")

    # per-member tab grouping: dock widgets of one member tabify together
    member_of = {n: g for g, names in registry.groups().items()
                 for n in names}
    first_in_group: Dict[str, Any] = {}
    for name in registry.available():
        plugin = registry.create(name)
        runner = PluginRunner(plugin, viewer=viewer)
        spec = widget_spec(runner)

        # Build a function whose *signature* magicgui renders: one text
        # field per extra run() parameter, a path field for the second
        # image when the plugin wants one.
        extra_names = [f["name"] for f in spec["fields"][1:]
                       if f["kind"] != "layer_or_file"]
        needs2 = any(f["name"] == "image2" for f in spec["fields"])

        def make_run(r: PluginRunner, extra_names=tuple(extra_names),
                     needs2=needs2):
            def run_widget(image2_path: str = "", **extras):
                src = viewer.layers.selection.active
                try:
                    r.run(
                        image=src,
                        image2=image2_path or None,
                        on_done=lambda ls: add_layers(viewer, ls),
                        block=False,
                        **coerce_extras(r, extras),
                    )
                except RuntimeError as exc:   # busy guard
                    print(exc)

            # materialise an explicit signature for magicgui
            params = []
            if needs2:
                params.append(inspect.Parameter(
                    "image2_path", inspect.Parameter.POSITIONAL_OR_KEYWORD,
                    default="", annotation=str))
            for n in extra_names:
                params.append(inspect.Parameter(
                    n, inspect.Parameter.POSITIONAL_OR_KEYWORD,
                    default="", annotation=str))

            def bound(*args, **kwargs):
                ba = inspect.Signature(params).bind(*args, **kwargs)
                ba.apply_defaults()
                vals = dict(ba.arguments)
                return run_widget(vals.pop("image2_path", ""), **vals)

            bound.__signature__ = inspect.Signature(params)
            bound.__name__ = f"run_{r.plugin.name}"
            return bound

        widget = magicgui(call_button=f"Run {plugin.name}")(make_run(runner))
        group = member_of.get(name, "other")
        dock = viewer.window.add_dock_widget(
            widget, name=f"{group}: {plugin.name}", area="right")
        if group in first_in_group:
            try:  # tab this member's widgets together
                viewer.window._qt_window.tabifyDockWidget(
                    first_in_group[group], dock)
            except Exception:
                pass  # non-Qt/mock hosts: grouping is cosmetic
        else:
            first_in_group[group] = dock

    napari.run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
