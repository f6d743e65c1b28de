"""Multi-date stereo pair selection (a frozen copy of the port's
``geometry/pairs.py``; host numpy, as in the reference).

All C(n, 2) pairs are scored by the convergence angle between the views;
a pair is valid when its convergence lies in
``[min_convergence_deg, max_convergence_deg]`` and both incidences are at
most ``max_incidence_deg``. Valid pairs come first, each group ordered by
closeness to an ideal convergence angle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from perfbench.reference.config import PairSelectionConfig


def view_vector_np(incidence_deg: float, azimuth_deg: float) -> np.ndarray:
    """ENU unit vector to the satellite."""
    inc = np.radians(incidence_deg)
    az = np.radians(azimuth_deg)
    return np.array(
        [np.sin(inc) * np.sin(az), np.sin(inc) * np.cos(az), np.cos(inc)])


@dataclass(frozen=True)
class ImageMeta:
    """Per-acquisition metadata."""

    index: int                    # position in the image list
    incidence_deg: float
    azimuth_deg: float
    date: float = 0.0             # days since an arbitrary epoch
    name: str = ""

    @property
    def view(self) -> np.ndarray:
        return view_vector_np(self.incidence_deg, self.azimuth_deg)


@dataclass(frozen=True)
class PairCandidate:
    """A scored stereo pair."""

    i: int
    j: int
    convergence_deg: float
    time_diff_days: float
    valid: bool
    score: float                  # lower is better among valid pairs


def convergence_angle_deg(a: ImageMeta, b: ImageMeta) -> float:
    d = float(np.clip(np.dot(a.view, b.view), -1.0, 1.0))
    return float(np.degrees(np.arccos(d)))


def select_pairs(metas: Sequence[ImageMeta],
                 cfg: PairSelectionConfig = PairSelectionConfig(),
                 ideal_convergence_deg: float = 20.0) -> List[PairCandidate]:
    """All C(n, 2) pairs, valid ones first, each group ranked by
    ``|convergence - ideal_convergence_deg|`` (a stable sort, so equal
    scores keep enumeration order). Roles follow the list order."""
    out: List[PairCandidate] = []
    n = len(metas)
    for i in range(n):
        for j in range(i + 1, n):
            a, b = metas[i], metas[j]
            conv = convergence_angle_deg(a, b)
            valid = (cfg.min_convergence_deg <= conv <= cfg.max_convergence_deg
                     and a.incidence_deg <= cfg.max_incidence_deg
                     and b.incidence_deg <= cfg.max_incidence_deg)
            out.append(PairCandidate(
                i=a.index, j=b.index, convergence_deg=conv,
                time_diff_days=abs(a.date - b.date), valid=valid,
                score=abs(conv - ideal_convergence_deg)))
    out.sort(key=lambda p: (not p.valid, p.score))
    return out


def take_pairs(pairs: Sequence[PairCandidate], n: int,
               valid_only: bool = True) -> List[PairCandidate]:
    """The first ``n`` pairs (valid ones only unless ``valid_only=False``)."""
    usable = [p for p in pairs if p.valid] if valid_only else list(pairs)
    return usable[:n]
