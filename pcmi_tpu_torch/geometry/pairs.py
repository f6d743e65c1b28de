"""View vectors (the part of ``pcmi_tpu/geometry/pairs.py`` the synthetic
scenes use; pair selection itself is not ported yet)."""

from __future__ import annotations

import numpy as np


def view_vector_np(incidence_deg: float, azimuth_deg: float) -> np.ndarray:
    """ENU unit vector to the satellite."""
    inc = np.radians(incidence_deg)
    az = np.radians(azimuth_deg)
    return np.array(
        [np.sin(inc) * np.sin(az), np.sin(inc) * np.cos(az), np.cos(inc)])
