"""Row-band halo sizing (the part of ``pcmi_tpu/parallel/stereo_sharded.py``
that the streaming pipeline uses; the sharded matchers are not ported)."""

from __future__ import annotations

from pcmi_tpu_torch.config import StereoConfig


def default_halo(cfg: StereoConfig) -> int:
    """Influence radius of the windowed ops (census window, block
    aggregation, guided filter, speckle median and the decaying vertical
    SGM recurrence), rounded up to 8 rows."""
    r = (cfg.census_window // 2
         + cfg.block_size
         + 2 * cfg.gf_radius * cfg.wls_passes
         + cfg.speckle_median_size
         + 16)  # vertical SGM decay allowance
    if cfg.hierarchical:
        # the coarse half-resolution pass doubles every footprint
        r *= 2
    return ((r + 7) // 8) * 8
