"""The roofline's count of the matcher's work against hand-worked bytes,
with the path counts and the element size taken from the stereo config."""

import dataclasses

import pytest

from pcmi_tpu_torch.config import StereoConfig
from perfbench import roofline

BW = 3.35e12


def _by_hand(D, H, W, esize=4, right_paths=2, checker=True):
    n = D * H * W
    paths = 4 + right_paths
    # SGM: half the directions forward (2 volumes), half accumulating (3);
    # WTA left (2 volumes in, 3 float32 planes out), right (1, 2), checker
    # (1, 3); the right view's derive (2 volumes)
    vols = (paths // 2) * 2 + (paths // 2) * 3 + 2 + 1 + 2 + int(checker)
    planes = 3 + 2 + 3 * int(checker)
    return (vols * n * esize + planes * H * W * 4) / BW


def test_pair_least_time_at_the_pair_cells_canvas():
    D, H, W = 288, 1280, 1280
    cfg = StereoConfig()
    assert roofline.pair_least_seconds((D, H, W), cfg) == pytest.approx(
        _by_hand(D, H, W), rel=1e-12)
    # every unit is bound by its bytes here, not by its operations
    n = D * H * W
    for unit, (vols, planes, _) in roofline.WORK.items():
        t_bytes = (vols * n * 4 + planes * H * W * 4) / BW
        assert roofline.least_seconds(unit, (D, H, W)) == t_bytes


@pytest.mark.parametrize("change,kw", [
    (dict(right_sgm="full"), dict(right_paths=4)),
    (dict(band_recover=False), dict(checker=False)),
    (dict(band_check_mode="vertical"), dict(checker=False)),
    (dict(cost_dtype="bfloat16"), dict(esize=2)),
])
def test_the_count_follows_the_config(change, kw):
    cfg = dataclasses.replace(StereoConfig(), **change)
    shape = (144, 1152, 1152)
    assert roofline.pair_least_seconds(shape, cfg) == pytest.approx(
        _by_hand(*shape, **kw), rel=1e-12)


@pytest.mark.parametrize("change", [
    dict(right_sgm="derived"), dict(right_sgm="diagonal"),
    dict(hierarchical=True), dict(adapt_band_rows=64),
    dict(right_subpixel=True)])
def test_another_matcher_path_is_not_miscounted(change):
    cfg = dataclasses.replace(StereoConfig(), **change)
    with pytest.raises(ValueError):
        roofline.pair_units(cfg)


def test_operations_bound_when_few_bytes():
    # one plane of a huge operation count per byte is bound by its ops
    roofline.WORK["_probe"] = (0, 0, 1e6)
    try:
        assert roofline.least_seconds("_probe", (1, 1, 1)) == 1e6 / 67e12
    finally:
        del roofline.WORK["_probe"]
