"""Plugin contract (port of ``pcmi_tpu/interface.py``).

A :class:`SatellitePlugin` has a ``name`` and a ``run(image, viewer=None)``
that returns napari-style layer tuples ``(data, params, layer_type)``, so
a viewer host consumes the port's components unchanged. The framework
never needs a GUI: every component is also a plain callable over arrays
or tensors, and the plugin class is a thin adapter.

``run`` may return tensors (on any device); :func:`as_numpy_layers` turns
them into host numpy arrays at the boundary.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, List, Literal, Tuple

import numpy as np
import torch

LayerType = Literal["image", "labels", "points", "shapes"]
LayerParams = Dict[str, Any]
Layer = Tuple[np.ndarray, LayerParams, LayerType]


class SatellitePlugin(ABC):
    """Abstract component contract."""

    @property
    @abstractmethod
    def name(self) -> str:
        """Display name of the component."""

    @property
    def requires_viewer(self) -> bool:
        """Whether ``run`` needs access to the full viewer (default False)."""
        return False

    @abstractmethod
    def run(self, image: np.ndarray, viewer=None) -> List[Layer]:
        """Run the component on ``image`` and return napari-style layers.

        Returns a list of ``(data, params, layer_type)`` tuples where
        ``layer_type`` is one of ``image | labels | points | shapes`` and
        ``params`` carries display hints (``name``, ``colormap``, ...).
        """


def as_numpy_layers(layers: List[Layer]) -> List[Layer]:
    """Every layer's data as a host numpy array (tensors are detached and
    copied from their device)."""
    out: List[Layer] = []
    for data, params, kind in layers:
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()
        out.append((np.asarray(data), dict(params), kind))
    return out
