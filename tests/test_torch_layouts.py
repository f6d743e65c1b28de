"""The port's alternative-layout entry points (pcmi_tpu_torch.ops.stereo.
layouts, kernels K4-K6) against pcmi_tpu on the CPU.

Inputs are made with numpy from a seed and fed to both packages. Pallas
kernels run in interpret mode, as tests/test_pallas_kernels.py runs them.
On the CPU the port's kernel wrappers run their plain versions.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pcmi_tpu.config import StereoConfig
from pcmi_tpu.ops.stereo import pallas_kernels as jpk
from pcmi_tpu_torch import convert
from pcmi_tpu_torch.convert import config_from_reference as _c
from pcmi_tpu_torch.ops.stereo import kernels as K
from pcmi_tpu_torch.ops.stereo import layouts as L
from pcmi_tpu_torch.ops.stereo import matching as tm

torch.set_num_threads(1)

CFG = StereoConfig(max_disp=32)
SHAPES = [(16, 24, 40), (20, 19, 33)]


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.mark.parametrize("shape", SHAPES)
def test_sgm_aggregate_hwd_matches_pallas(rng, shape):
    """K4's entry point vs sgm_aggregate_pallas: <= 1e-4 asked; measured
    bit-exact, also against the port's K1 sgm_aggregate."""
    vol = rng.uniform(0, 1, shape).astype(np.float32)
    vol_hwd = np.ascontiguousarray(np.moveaxis(vol, 0, -1))
    ref = np.asarray(jpk.sgm_aggregate_pallas(
        jnp.asarray(vol_hwd), CFG.sgm_p1, CFG.sgm_p2, band=8, chunk=8))
    got = L.sgm_aggregate_hwd(_t(vol_hwd), CFG.sgm_p1, CFG.sgm_p2).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(got, ref)
    k1 = tm.sgm_aggregate(_t(vol), _c(CFG)).permute(1, 2, 0).numpy()
    np.testing.assert_array_equal(got, k1)


@pytest.mark.parametrize("shape", SHAPES)
def test_sgm_aggregate_blocked_matches_pallas(rng, shape):
    """K5's entry point vs sgm_aggregate_pallas_blocked(chunk=8): <= 1e-4
    asked; measured bit-exact, also against the port's K1 sgm_aggregate."""
    vol = rng.uniform(0, 1, shape).astype(np.float32)
    ref = np.asarray(jpk.sgm_aggregate_pallas_blocked(
        jnp.asarray(vol), CFG.sgm_p1, CFG.sgm_p2, chunk=8))
    got = L.sgm_aggregate_blocked(_t(vol), CFG.sgm_p1, CFG.sgm_p2,
                                  chunk=8).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, tm.sgm_aggregate(_t(vol), _c(CFG)).numpy())


@pytest.mark.parametrize("d_min,stride,fill", [(0, 1, 1.0), (-4, 2, 1.0),
                                               (-12, 1, 1e4)])
def test_derive_right_wdh_exact(rng, d_min, stride, fill):
    """K6 on a padded (Wp, Dp, Hp) volume (Wp > w, Dp > d_real) vs
    derive_right_wdh_pallas: bit-exact, padding rules included."""
    d_real, w = 13, 37
    vol_h = rng.uniform(0, 1, (48, 16, 20)).astype(np.float32)
    ref = np.asarray(jpk.derive_right_wdh_pallas(
        jnp.asarray(vol_h), d_real, w, d_min, stride=stride, fill=fill))
    got = K.derive_right_wdh(_t(vol_h), d_real, w, d_min, stride, fill)
    np.testing.assert_array_equal(got.numpy(), ref)


# K6's edges that the card's kernel decides per row or per launch:
# ((Wp, Dp, Hp), d_real, w, d_min, stride, fill); rows of 80, 48, 80 and
# 84 bytes in float32 (40, 24, 40 and 42 in bfloat16: none a multiple of 16)
_WDH_EDGES = {
    "dp_is_d_real": ((24, 8, 20), 8, 21, -3, 1, 1.0),
    "w_is_wp": ((24, 16, 12), 11, 24, -5, 2, 1e4),
    "all_fill_right": ((24, 16, 20), 13, 20, 23, 1, 1e4),
    "all_fill_left": ((20, 8, 21), 8, 20, -40, 2, 1.0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_WDH_EDGES))
def test_derive_right_wdh_edges_match_pallas(rng, case, dtype):
    """K6's plain version, the card's oracle, against
    derive_right_wdh_pallas on the edges the card's kernel decides per row
    or per launch: no BIG rows (Dp == d_real), no zero rows (w == Wp),
    every source column outside [0, w) (all `fill`, both signs of d_min),
    rows whose bytes are not a multiple of 16: bit-exact in both types."""
    shape, d_real, w, d_min, stride, fill = _WDH_EDGES[case]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jv = jnp.asarray(rng.uniform(0, 1, shape).astype(np.float32)).astype(jdt)
    ref = jpk.derive_right_wdh_pallas(jv, d_real, w, d_min, stride=stride,
                                      fill=fill)
    got = K.derive_right_wdh(convert.tensor_from_reference(jv), d_real, w,
                             d_min, stride, fill)
    np.testing.assert_array_equal(_f32(got), _f32(ref))
    if case.startswith("all_fill"):
        fill_t = float(jnp.asarray(fill, jdt).astype(jnp.float32))
        assert (_f32(got)[:w, :d_real] == fill_t).all()


@pytest.mark.parametrize("shape,stride,d_min", [((16, 24, 40), 1, 0),
                                                ((16, 19, 33), 2, -4)])
def test_right_disparity_fused_wdh_matches_pallas(rng, shape, stride, d_min):
    """The (W, Dp, H)-derive right view vs right_disparity_fused_pallas(
    use_wdh_derive=True) and vs the port's default chain: exact."""
    vol = rng.uniform(0, 1, shape).astype(np.float32)
    args = (CFG.sgm_p1, CFG.sgm_p2, d_min)
    ref = np.asarray(jpk.right_disparity_fused_pallas(
        jnp.asarray(vol), *args, stride=stride, band=8, chunk=8,
        use_wdh_derive=True))
    got = L.right_disparity_fused(_t(vol), *args, stride=stride, band=8,
                                  chunk=8, use_wdh_derive=True)
    np.testing.assert_array_equal(got.numpy(), ref)
    default = L.right_disparity_fused(_t(vol), *args, stride=stride)
    np.testing.assert_array_equal(got.numpy(), default.numpy())


# --- bfloat16 volumes (cost_dtype="bfloat16"): stored volumes bit-exact ------


def _bf(rng, shape):
    """A seeded volume rounded once to bfloat16, as a JAX array and as the
    port's tensor (the same values)."""
    j = jnp.asarray(rng.uniform(0, 1, shape).astype(np.float32)).astype(
        jnp.bfloat16)
    return j, convert.tensor_from_reference(j)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_sgm_aggregate_blocked_matches_pallas(rng, shape):
    """K5's entry point on a bfloat16 volume vs
    sgm_aggregate_pallas_blocked(chunk=8): bit-exact (the float32 state
    plus `prev`, rounded once; `(vert + horiz) * 0.25` in bfloat16). The
    reference pads D to 16 here, the port to 8: cropped, no result depends
    on it. Against the port's K1 sgm_aggregate, which adds two stored
    volumes per axis, elements differ by up to a few bfloat16 steps
    (asserted: some differ, none by more than 4 steps of its value)."""
    jv, tv = _bf(rng, shape)
    ref = jpk.sgm_aggregate_pallas_blocked(jv, CFG.sgm_p1, CFG.sgm_p2,
                                           chunk=8)
    got = L.sgm_aggregate_blocked(tv, CFG.sgm_p1, CFG.sgm_p2, chunk=8)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(ref))
    k1 = _f32(tm.sgm_aggregate(tv, _c(CFG)))
    assert (np.abs(_f32(got) - k1) <= 4 * k1 / 128).all()
    assert (_f32(got) != k1).any()


@pytest.mark.parametrize("d_min,stride,fill", [(0, 1, 1.0), (-4, 2, 1.0),
                                               (-12, 1, 1e4)])
def test_bf16_derive_right_wdh_exact(rng, d_min, stride, fill):
    """K6 on a padded bfloat16 (Wp, Dp, Hp) volume vs
    derive_right_wdh_pallas: bit-exact, with `fill`, BIG and 0 in bfloat16
    (1e4 -> 9984, 1e9 -> 998244352)."""
    d_real, w = 13, 37
    jv, tv = _bf(rng, (48, 16, 20))
    ref = jpk.derive_right_wdh_pallas(jv, d_real, w, d_min, stride=stride,
                                      fill=fill)
    got = K.derive_right_wdh(tv, d_real, w, d_min, stride, fill)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(ref))
    assert float(got.float().max()) == 998244352.0


@pytest.mark.parametrize("shape,stride,d_min", [((16, 24, 40), 1, 0),
                                                ((16, 19, 33), 2, -4)])
def test_bf16_right_disparity_fused_wdh(rng, shape, stride, d_min):
    """The (W, Dp, H)-derive right view on a bfloat16 volume equals the
    port's default chain exactly, and right_disparity_fused_pallas(
    use_wdh_derive=True) but for tie pixels (<= 1%; see
    test_bf16_fused_right_matches_pallas in test_torch_stereo.py)."""
    jv, tv = _bf(rng, shape)
    args = (CFG.sgm_p1, CFG.sgm_p2, d_min)
    got = L.right_disparity_fused(tv, *args, stride=stride, band=8, chunk=8,
                                  use_wdh_derive=True)
    default = L.right_disparity_fused(tv, *args, stride=stride)
    np.testing.assert_array_equal(got.numpy(), default.numpy())
    ref = np.asarray(jpk.right_disparity_fused_pallas(
        jv, *args, stride=stride, band=8, chunk=8, use_wdh_derive=True))
    assert (got.numpy() != ref).mean() <= 0.01
    assert (got.numpy() <= ref).all()


def test_bf16_sgm_aggregate_hwd_refused(rng):
    """K4 is float32 only, as the TPU kernel it replaces: the reference's
    sgm_aggregate_pallas raises for a bfloat16 volume, and so do K4's
    wrapper and its entry point (TypeError), before anything runs."""
    jv, tv = _bf(rng, (8, 8, 16))
    with pytest.raises(Exception):
        jpk.sgm_aggregate_pallas(jv, CFG.sgm_p1, CFG.sgm_p2, band=8, chunk=8)
    with pytest.raises(TypeError, match="float32"):
        L.sgm_aggregate_hwd(tv, CFG.sgm_p1, CFG.sgm_p2)
    with pytest.raises(TypeError, match="float32"):
        K.sgm_hwd(tv, CFG.sgm_p1, CFG.sgm_p2, 1, True, out=tv.clone())


_BAD = {
    "sgm_hwd dims": (ValueError, lambda: K.sgm_hwd(
        torch.zeros(4, 5), 0.03, 0.48, 0, False)),
    "sgm_hwd axis": (ValueError, lambda: K.sgm_hwd(
        torch.zeros(4, 5, 6), 0.03, 0.48, 2, False)),
    "sgm_hwd dtype": (TypeError, lambda: K.sgm_hwd(
        torch.zeros(4, 5, 6, dtype=torch.float64), 0.03, 0.48, 0, False)),
    "sgm_hwd layout": (ValueError, lambda: K.sgm_hwd(
        torch.zeros(6, 5, 4).permute(2, 1, 0), 0.03, 0.48, 1, True)),
    "sgm_blocked band": (ValueError, lambda: K.sgm_blocked(
        torch.zeros(1, 4, 8, 64), 0.03, 0.48, False)),
    "sgm_blocked prev": (ValueError, lambda: K.sgm_blocked(
        torch.zeros(1, 4, 8, 128), 0.03, 0.48, True,
        prev=torch.zeros(1, 4, 16, 128))),
    "sgm_blocked dtype": (TypeError, lambda: K.sgm_blocked(
        torch.zeros(1, 4, 8, 128, dtype=torch.float16), 0.03, 0.48, False)),
    "sgm_blocked Dp": (ValueError, lambda: K.sgm_blocked_plan(1025, 1, False)),
    "sgm_hwd D": (ValueError, lambda: K.sgm_hwd_plan(1025, True)),
    "wta aggregate of one": (ValueError, lambda: K.wta(
        torch.zeros(4, 5, 6), None, 1.0, 0, with_aggregate=True)),
    "wdh d_real": (ValueError, lambda: K.derive_right_wdh(
        torch.zeros(8, 4, 6), 5, 8, 0)),
    "wdh dtype": (TypeError, lambda: K.derive_right_wdh(
        torch.zeros(8, 4, 6, dtype=torch.int32), 4, 8, 0)),
    "blocked dims": (ValueError, lambda: L.sgm_aggregate_blocked(
        torch.zeros(4, 5), 0.03, 0.48)),
    "fused dims": (ValueError, lambda: L.right_disparity_fused(
        torch.zeros(4, 5), 0.03, 0.48, 0)),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_wrappers_reject_bad_inputs_on_cpu(case):
    """A wrong shape, layout or dtype raises before any plain version runs:
    no silent conversion, no fallback."""
    exc, call = _BAD[case]
    K.reset_launches()
    with pytest.raises(exc):
        call()
    assert not any(K.LAUNCHES.values())
