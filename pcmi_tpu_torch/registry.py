"""Plugin registry with import-time graceful degradation (port of
``pcmi_tpu/registry.py``).

Every built-in plugin is imported by name; one whose module or class is
missing degrades to an entry of :func:`failures` (the import's last
traceback line) instead of killing the host. The port keeps the
reference's nine built-in names and groups, and has all nine modules.
:func:`create` passes keyword arguments to the plugin's class: every
built-in plugin takes ``device="cuda"`` by default.
"""

from __future__ import annotations

import importlib
import traceback
from typing import Callable, Dict, List

from pcmi_tpu_torch.interface import SatellitePlugin

_FACTORIES: Dict[str, Callable[[], SatellitePlugin]] = {}
_FAILURES: Dict[str, str] = {}


def register(name: str, factory: Callable[[], SatellitePlugin]) -> None:
    _FACTORIES[name] = factory


def available() -> List[str]:
    _ensure_builtin()
    return sorted(_FACTORIES)


def failures() -> Dict[str, str]:
    _ensure_builtin()
    return dict(_FAILURES)


def create(name: str, **kwargs) -> SatellitePlugin:
    """A new plugin ``name``, its factory called with ``kwargs`` (for the
    built-in plugins, e.g. ``device="cpu"``)."""
    _ensure_builtin()
    if name not in _FACTORIES:
        raise KeyError(
            f"unknown plugin {name!r}; available: {', '.join(sorted(_FACTORIES))}"
        )
    return _FACTORIES[name](**kwargs)


def groups() -> Dict[str, List[str]]:
    """Registered (non-degraded) plugins by the member tab the reference
    host puts them under; plugins without a group land under "other"."""
    _ensure_builtin()
    out: Dict[str, List[str]] = {}
    for name in sorted(_FACTORIES):
        out.setdefault(_GROUPS.get(name, "other"), []).append(name)
    return out


_BUILTIN_SPECS = [
    # (registry name, module, attribute)
    ("height-map", "pcmi_tpu_torch.pipelines.height_map", "HeightMapExtractor"),
    ("saliency", "pcmi_tpu_torch.pipelines.saliency", "SaliencyDetector"),
    ("restoration", "pcmi_tpu_torch.pipelines.restoration",
     "RestorationPlugin"),
    ("stitching", "pcmi_tpu_torch.pipelines.stitching",
     "ImageStitchingPlugin"),
    ("land-use", "pcmi_tpu_torch.pipelines.landuse",
     "LandUseClassificationPlugin"),
    ("detection", "pcmi_tpu_torch.pipelines.detection",
     "ObjectAnnotationPlugin"),
    ("super-resolution", "pcmi_tpu_torch.pipelines.superres",
     "SuperResolutionPlugin"),
    ("inpainting", "pcmi_tpu_torch.pipelines.superres", "InpaintingPlugin"),
    ("generative-restoration", "pcmi_tpu_torch.pipelines.generative",
     "RestorationGenerativePlugin"),
]

# member tabs of the reference host
_GROUPS = {
    "restoration": "jasraj",
    "stitching": "jasraj",
    "land-use": "jasraj",
    "detection": "jasraj",
    "generative-restoration": "marcin",
    "height-map": "rafael",
    "saliency": "rafael",
    "super-resolution": "stan",
    "inpainting": "stan",
}

_loaded = False


def _ensure_builtin() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    for name, module, attr in _BUILTIN_SPECS:
        try:
            register(name, getattr(importlib.import_module(module), attr))
        except Exception:  # degrade, don't crash
            _FAILURES[name] = traceback.format_exc(limit=1)
