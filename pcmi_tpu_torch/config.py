"""Typed configuration: ``pcmi_tpu/config.py``'s frozen dataclasses, reused
as they are (that module is plain dataclasses and imports no JAX). The
port reads them through this module, the one place where it depends on
the reference package."""

from pcmi_tpu.config import (  # noqa: F401
    FusionConfig,
    PairSelectionConfig,
    PipelineConfig,
    RectifyConfig,
    StereoConfig,
)
