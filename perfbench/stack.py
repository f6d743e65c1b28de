"""What the drivers share: a configuration's ``pipeline`` section as a
config object of either side (the program's ``pcmi_tpu_torch.config`` or
the reference's copy; both have the same dataclasses), the scene as either
side's inputs, and the comparison of two answers."""

from __future__ import annotations

import dataclasses

import numpy as np


def pipeline_config(config_module, spec: dict):
    """``config_module.PipelineConfig`` with each section of ``spec``
    (``{"stereo": {...}, "rectify": {...}, ...}``) replacing the fields it
    names; lists become tuples."""
    def value(v):
        return tuple(v) if isinstance(v, list) else v

    base = config_module.PipelineConfig()
    updates = {}
    for section, fields in spec.items():
        current = getattr(base, section)
        if isinstance(fields, dict):
            updates[section] = dataclasses.replace(
                current, **{k: value(v) for k, v in fields.items()})
        else:
            updates[section] = value(fields)
    return dataclasses.replace(base, **updates)


def side_inputs(scene, rpc_class, meta_class):
    """``(rpcs, metas)`` of the scene as one side's objects."""
    rpcs = [rpc_class.from_dict(d) for d in scene.rpcs]
    metas = [meta_class(i, inc, az, date=scene.dates[i])
             for i, (inc, az) in enumerate(scene.views)]
    return rpcs, metas


def max_gap(a, b, where=None) -> float:
    """Largest ``|a - b|`` (over ``where``); 0 over nothing, inf where the
    shapes differ or a value compared is not finite."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    if where is not None:
        a, b = a[where], b[where]
    if a.size == 0:
        return 0.0
    d = np.abs(a - b)
    return float(d.max()) if np.isfinite(d).all() else float("inf")


def mismatch_share(a, b) -> float:
    """Share of elements where two boolean (or exact) arrays differ; 1 where
    the shapes differ."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return 1.0
    return float((a != b).mean()) if a.size else 0.0


def dsm_numbers(got: dict, ref: dict) -> dict:
    """Two DSMs compared: the share of cells empty (NaN) in one and not the
    other, and the largest height gap over the cells both fill; a grid of
    another origin or shape reads as wholly different."""
    if got["origin"] != ref["origin"] or got["dsm"].shape != ref["dsm"].shape:
        return {"dsm_empty_mismatch": 1.0, "dsm_gap_m": float("inf")}
    fin_g, fin_r = np.isfinite(got["dsm"]), np.isfinite(ref["dsm"])
    return {"dsm_empty_mismatch": mismatch_share(fin_g, fin_r),
            "dsm_gap_m": max_gap(got["dsm"], ref["dsm"], fin_g & fin_r)}
