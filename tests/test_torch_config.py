"""The port's own configuration classes against ``pcmi_tpu.config``, the
conversion of a reference config, and the entry points' default device."""

import dataclasses
import inspect

import pytest

from pcmi_tpu import config as jc
from pcmi_tpu_torch import config as tc
from pcmi_tpu_torch import convert
from pcmi_tpu_torch.pipelines import evaluation, height_map, multiday, streaming

CLASSES = ["StereoConfig", "RectifyConfig", "PairSelectionConfig",
           "FusionConfig", "TilingConfig", "MeshConfig", "PipelineConfig"]


def _configs():
    """The test configs of the port's slice tests, and a few more."""
    h = (0.0, 40.0)
    return {
        "height_map": jc.PipelineConfig(
            stereo=jc.StereoConfig(block_size=9, census_window=5,
                                   margin_undefined=8),
            rectify=jc.RectifyConfig(height_range=h)),
        "lowtex": jc.PipelineConfig(
            stereo=jc.StereoConfig(block_size=9, census_window=5,
                                   margin_undefined=8, gate_profile="lr",
                                   presmooth_sigma=1.5),
            rectify=jc.RectifyConfig(height_range=h)),
        "d288": jc.PipelineConfig(
            stereo=jc.StereoConfig(block_size=9, census_window=5,
                                   margin_undefined=8, disp_stride=2),
            rectify=jc.RectifyConfig(height_range=(0.0, 48.0)),
            pairs=jc.PairSelectionConfig(n_pairs=3, max_convergence_deg=90.0),
            fusion=jc.FusionConfig(icp_subsample=1024)),
        "stereo_small": jc.StereoConfig(max_disp=33, sgm_backend="xla"),
        "stereo_vertical": jc.StereoConfig(max_disp=16, block_size=5,
                                           census_window=5,
                                           band_check_mode="vertical",
                                           band_check_margin=0.05),
        "tiling": jc.TilingConfig(tile=512, halo=96),
        "mesh": jc.MeshConfig(data=2, tile=4),
    }


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_match_reference(name):
    ref, port = getattr(jc, name), getattr(tc, name)
    assert port.__module__ == "pcmi_tpu_torch.config"
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(port()) == dataclasses.asdict(ref())
    assert port.__dataclass_params__.frozen
    assert hash(port()) == hash(port())


STEREO_CASES = {
    "default": {},
    "test_config": dict(block_size=9, census_window=5, margin_undefined=8),
    "stride2_rounded": dict(max_disp=281, disp_stride=2),
    "stride4": dict(max_disp=96, disp_stride=4, lr_threshold=2.0,
                    band_agree_threshold=0.75),
    "adaptive": dict(adapt_band_rows=64, adapt_local_disp=96),
    "bad_census": dict(census_window=4),
    "big_census": dict(census_window=9),
    "bad_paths": dict(sgm_paths=8),
    "bad_cost": dict(cost_type="sad"),
    "bad_right_sgm": dict(right_sgm="horiz"),
    "bad_backend": dict(sgm_backend="cuda"),
    "bad_dtype": dict(cost_dtype="float16"),
    "bad_stride": dict(disp_stride=3),
    "adaptive_and_hierarchical": dict(adapt_band_rows=64, hierarchical=True),
    "adaptive_local_not_16": dict(adapt_band_rows=64, adapt_local_disp=40),
    "adaptive_local_too_wide": dict(max_disp=64, adapt_band_rows=64,
                                    adapt_local_disp=96),
    "adaptive_scale": dict(adapt_band_rows=64, adapt_coarse_scale=3),
    "adaptive_rows": dict(adapt_band_rows=66),
    "adaptive_cols": dict(adapt_band_rows=64, adapt_band_cols=66),
    "adaptive_chunk": dict(adapt_band_rows=64, adapt_warp_chunk=0),
    "bad_check_mode": dict(band_check_mode="box"),
    "bad_profile": dict(gate_profile="loose"),
}
DERIVED = ("max_disp", "min_disparity", "num_disparities", "lr_threshold_eff",
           "lr_threshold_final_eff", "band_agree_threshold_eff")


def _build(cls, kw):
    try:
        cfg = cls(**kw)
    except ValueError as exc:
        return "error", str(exc)
    return "ok", tuple(getattr(cfg, k) for k in DERIVED)


@pytest.mark.parametrize("case", sorted(STEREO_CASES))
def test_stereo_derived_values_and_validation(case):
    kw = STEREO_CASES[case]
    ref = _build(jc.StereoConfig, kw)
    got = _build(tc.StereoConfig, kw)
    assert got == ref
    assert got[0] == ("error" if case.startswith(("bad", "big", "adaptive_"))
                      else "ok")


def test_rectify_validation_and_replace():
    with pytest.raises(ValueError, match="bilinear"):
        tc.RectifyConfig(interp_order=3)
    cfg = tc.PipelineConfig()
    new = cfg.replace(ground_percentile=5.0)
    assert isinstance(new, tc.PipelineConfig) and new.ground_percentile == 5.0
    assert new == convert.config_from_reference(
        jc.PipelineConfig().replace(ground_percentile=5.0))


@pytest.mark.parametrize("name", sorted(_configs()))
def test_config_from_reference_round_trips(name):
    ref = _configs()[name]
    got = convert.config_from_reference(ref)
    assert type(got) is getattr(tc, type(ref).__name__)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    for f in dataclasses.fields(got):
        v = getattr(got, f.name)
        if dataclasses.is_dataclass(v):
            assert type(v).__module__ == "pcmi_tpu_torch.config", f.name
    # idempotent on a port config, and equal to the one built directly
    assert convert.config_from_reference(got) == got
    if isinstance(ref, jc.StereoConfig):
        kw = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
        assert got == tc.StereoConfig(**kw)
        assert got.lr_threshold_eff == ref.lr_threshold_eff


def test_config_from_reference_refuses_other_objects():
    with pytest.raises(TypeError):
        convert.config_from_reference(object())


ENTRY_POINTS = {
    "HeightMapPipeline": height_map.HeightMapPipeline.__init__,
    "MultiDayFusion": multiday.MultiDayFusion.__init__,
    "fused_consistency_dsm": multiday.fused_consistency_dsm,
    "StreamingAOIPipeline": streaming.StreamingAOIPipeline.__init__,
    "empty_dsm": streaming.empty_dsm,
    "evaluate_pair_accuracy": evaluation.evaluate_pair_accuracy,
    "evaluate_fused_dsm": evaluation.evaluate_fused_dsm,
    "streaming_dsm_from_reference": convert.streaming_dsm_from_reference,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    sig = inspect.signature(ENTRY_POINTS[name])
    assert sig.parameters["device"].default == "cuda"


def test_pipelines_built_without_a_device_hold_cuda():
    """Constructing does not touch the card: the objects only hold the
    device their compute will run on."""
    assert height_map.HeightMapPipeline().device.type == "cuda"
    assert multiday.MultiDayFusion().device.type == "cuda"
    pipe = streaming.StreamingAOIPipeline(band_rows=64)
    assert pipe.pipeline.device.type == "cuda"
    assert isinstance(pipe.cfg, tc.PipelineConfig)


def test_from_flat_overrides_matches_reference():
    """The CLI's dotted overrides: nested fields, a plain top-level field,
    and the checks of the replaced config."""
    base = _configs()["d288"]
    overrides = {"stereo.max_disp": 192, "stereo.block_size": 7,
                 "rectify.height_range": (0.0, 30.0),
                 "ground_percentile": 5.0, "fusion.knn_k": 12}
    ref = jc.from_flat_overrides(base, overrides)
    got = tc.from_flat_overrides(convert.config_from_reference(base),
                                 overrides)
    assert got == convert.config_from_reference(ref)
    assert got.stereo.max_disp == 192 and got.stereo.disp_stride == 2
    with pytest.raises(ValueError):
        tc.from_flat_overrides(got, {"stereo.disp_stride": 3})
