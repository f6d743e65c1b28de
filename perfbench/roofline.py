"""The chip's peaks and the least time of the matcher's work (a copy of
``chip_smoke.bound``'s arithmetic).

A unit of work on a (D, H, W) volume moves some whole volumes and some
(H, W) float32 planes, each input read once and each output written once,
and does some float32 operations per volume element. Its least time is
the larger of its bytes over the memory bandwidth and its operations over
the float32 rate outside the tensor cores.
"""

from __future__ import annotations

# NVIDIA H100 SXM, the data sheet's dense rates at 700 W
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# (volumes moved, (H, W) planes moved, operations per volume element)
WORK = {
    "sgm_forward": (2, 0, 8.5),     # one SGM direction into a new volume
    "sgm_accumulate": (3, 0, 8.5),  # one SGM direction added into a volume
    "wta_left": (2, 3, 6),          # combine two volumes, WTA + parabola + margin
    "wta_right": (1, 2, 3),         # integer argmin of one volume
    "wta_checker": (1, 3, 5),       # WTA + parabola + margin of one volume
    "derive_right": (2, 0, 0),      # the right view's volume
}


def least_seconds(unit: str, shape, esize: int = 4) -> float:
    """The least time of one unit of work on a (D, H, W) volume of
    ``esize``-byte elements."""
    D, H, W = shape
    vols, planes, ops = WORK[unit]
    nbytes = vols * D * H * W * esize + planes * H * W * 4
    return max(nbytes / HBM_BYTES_PER_S, ops * D * H * W / FP32_OPS_PER_S)


def pair_units(cfg) -> dict:
    """Units of work of one pair on the matcher's main path under the
    stereo config ``cfg`` (the program's ``StereoConfig`` as a run sizes
    it): the left view's SGM directions (each axis one forward and one
    accumulating direction), the right view's derive, directions and
    argmin, the left WTA and, with band recovery's census cross-checker,
    its WTA. A config whose matcher takes another path raises."""
    other = [k for k, v in (("hierarchical", cfg.hierarchical),
                            ("adapt_band_rows", cfg.adapt_band_rows),
                            ("right_subpixel", cfg.right_subpixel)) if v]
    if cfg.right_sgm not in ("horizontal", "full") or other:
        raise ValueError(f"no count of the matcher's work for right_sgm="
                         f"{cfg.right_sgm!r} with {other}")
    right_paths = 2 if cfg.right_sgm == "horizontal" else cfg.sgm_paths
    paths = cfg.sgm_paths + right_paths
    units = {"sgm_forward": paths // 2, "sgm_accumulate": paths // 2,
             "wta_left": 1, "wta_right": 1, "derive_right": 1}
    if cfg.band_recover and cfg.band_check_mode == "census":
        units["wta_checker"] = 1
    return units


def element_size(cfg) -> int:
    """Bytes of a stored volume element under ``cfg.cost_dtype``."""
    return 2 if cfg.cost_dtype == "bfloat16" else 4


def pair_least_seconds(shape, cfg) -> float:
    """The least time of one pair's matcher work on a (D, H, W) volume."""
    return sum(n * least_seconds(u, shape, element_size(cfg))
               for u, n in pair_units(cfg).items())
