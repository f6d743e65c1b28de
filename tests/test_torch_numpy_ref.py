"""The port's numpy oracle (pcmi_tpu_torch.ops.stereo.numpy_ref) and the
port's box matcher held against it, as tests/test_stereo.py holds the
reference's matcher against the reference's oracle; and the package
exports mirrored from pcmi_tpu."""

import importlib

import numpy as np
import pytest
import torch

from pcmi_tpu.ops.stereo import numpy_ref as jref
from pcmi_tpu_torch.config import StereoConfig
from pcmi_tpu_torch.ops.stereo import numpy_ref as nref
from pcmi_tpu_torch.ops.stereo.matching import (
    build_cost_volume, census_transform, compute_disparity)

torch.set_num_threads(1)

CFG = StereoConfig(max_disp=32, block_size=7, census_window=5)


@pytest.fixture(scope="module")
def pair():
    """tests/test_stereo.py's pair: a smoothed texture, background at 2 px,
    a raised block at 8 px."""
    rng = np.random.default_rng(3)
    h, w = 96, 128
    tex = rng.uniform(0, 1, (h, w + 64)).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25], np.float32)
    for ax in (0, 1):
        n = tex.shape[ax]
        tex = (np.take(tex, np.clip(np.arange(n) - 1, 0, None), axis=ax) * k[0]
               + tex * k[1]
               + np.take(tex, np.clip(np.arange(n) + 1, None, n - 1),
                         axis=ax) * k[2])
    disp = np.full((h, w), 2.0, np.float32)
    disp[30:60, 40:90] = 8.0
    left = tex[:, 32:32 + w]
    xs = np.arange(w)[None, :] + disp + 32.0
    x0 = np.floor(xs).astype(int)
    t = xs - x0
    rows = np.arange(h)[:, None]
    right = (tex[rows, np.clip(x0, 0, tex.shape[1] - 1)] * (1 - t)
             + tex[rows, np.clip(x0 + 1, 0, tex.shape[1] - 1)] * t)
    return left, right.astype(np.float32), disp


def test_copy_matches_reference_oracle(pair):
    """The port's copy computes what the reference's oracle computes."""
    left, right, _ = pair
    v = np.ones_like(left, bool)
    for a, b in zip(nref.census_transform_np(left, 5),
                    jref.census_transform_np(left, 5)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(nref.stereo_pipeline_np(left, right, v, v, 32, 7),
                    jref.stereo_pipeline_np(left, right, v, v, 32, 7)):
        np.testing.assert_array_equal(a, b)
    vol = np.random.default_rng(0).uniform(0, 1, (6, 9, 11)).astype(
        np.float32)
    np.testing.assert_array_equal(nref.sgm_aggregate_np(vol),
                                  jref.sgm_aggregate_np(vol))


def test_census_and_cost_volume_parity(pair):
    left, right, _ = pair
    v = np.ones_like(left, bool)
    b0, b1 = census_transform(torch.from_numpy(left), 5)
    n0, n1 = nref.census_transform_np(left, 5)
    np.testing.assert_array_equal(b0.numpy().astype(np.uint32), n0)
    np.testing.assert_array_equal(b1.numpy().astype(np.uint32), n1)
    vol = build_cost_volume(torch.from_numpy(left), torch.from_numpy(right),
                            torch.from_numpy(v), torch.from_numpy(v),
                            CFG).numpy()
    cr = nref.census_transform_np(right, 5)
    for di in (0, 7, 16, 31):
        c = nref.matching_cost_np(left, right, v, v, CFG.min_disparity + di,
                                  (n0, n1), cr, CFG.ad_weight, 5)
        np.testing.assert_allclose(vol[di], nref.box_aggregate_np(c, 7),
                                   atol=2e-3)


def test_box_matcher_matches_numpy_and_truth(pair):
    """tests/test_stereo.py's gates: disparities within 0.26 px of the
    oracle on > 97% of the pixels both call valid, median error < 0.35 px
    in the background band."""
    left, right, gt = pair
    v = torch.ones(left.shape, dtype=torch.bool)
    res = compute_disparity(torch.from_numpy(left), torch.from_numpy(right),
                            v, v, CFG, aggregation="box")
    dl_np, _, mask_np = nref.stereo_pipeline_np(
        left, right, v.numpy(), v.numpy(), CFG.max_disp, CFG.block_size,
        CFG.lr_threshold)
    dj, vj = res.disparity.numpy(), res.valid.numpy()
    assert (np.abs(dj - dl_np) <= 0.26)[vj & mask_np].mean() > 0.97
    interior = np.zeros_like(gt, bool)
    interior[8:24, 8:120] = True
    assert np.median(np.abs(dj - gt)[interior & vj]) < 0.35


# the port's tracer (span, recording, spans, profiler_offset_ns) takes
# the place of the reference's timed scopes and their statistics
TRACER = {"profiler_offset_ns", "recording", "span", "spans"}
SCOPES = {"dump_stats", "reset_stats", "scope", "stats"}


@pytest.mark.parametrize("package", ["ops", "ops.stereo", "utils"])
def test_exports_mirror_reference(package):
    ref = importlib.import_module(f"pcmi_tpu.{package}")
    port = importlib.import_module(f"pcmi_tpu_torch.{package}")
    want = set(ref.__all__)
    if package == "utils":
        assert SCOPES <= want
        want = (want - SCOPES) | TRACER
    assert sorted(port.__all__) == sorted(want)
    for name in port.__all__:
        assert callable(getattr(port, name)), name
