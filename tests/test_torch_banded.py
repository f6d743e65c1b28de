"""The port's banded (tile-adaptive range) matcher against pcmi_tpu on the
CPU: ``shift_rows``, the row-shifted cost volume, the coarse-pass
statistics, ``banded_disparity`` and ``pair_core`` with
``adapt_band_rows > 0``.

Inputs are made with numpy from a seed and fed to both packages. The
reference's XLA scans fuse ``acc + w * v`` into one multiply-add on the
CPU and reduce a pooling cell in row-major order; the port computes both
the same way, so every primitive here is bit-exact (measured) unless a
test says otherwise.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pcmi_tpu.config import StereoConfig
from pcmi_tpu.ops.stereo import banded as jb
from pcmi_tpu.ops.stereo import matching as jm
from pcmi_tpu.pipelines import height_map as jh
from pcmi_tpu_torch.convert import config_from_reference as _c
from pcmi_tpu_torch.ops.stereo import banded as tb
from pcmi_tpu_torch.ops.stereo import matching as tm
from pcmi_tpu_torch.pipelines import height_map as th

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.float().numpy() if torch.is_tensor(a) else np.asarray(
        a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def shifted_pair(seed: int, disp: np.ndarray, pad: int = 64):
    """A textured left view and the right view ``right(x) = left(x + d)``
    (linear interpolation) for the per-pixel disparity ``disp``."""
    rng = np.random.default_rng(seed)
    h, w = disp.shape
    tex = rng.uniform(0, 1, (h, w + 2 * pad)).astype(np.float32)
    for ax in (0, 1):
        tex = (0.5 * tex + 0.25 * np.roll(tex, 1, ax)
               + 0.25 * np.roll(tex, -1, ax))
    xs = np.arange(w)[None, :] + disp + pad
    x0 = np.floor(xs).astype(int)
    t = xs - x0
    rows = np.arange(h)[:, None]
    right = (tex[rows, np.clip(x0, 0, tex.shape[1] - 1)] * (1 - t)
             + tex[rows, np.clip(x0 + 1, 0, tex.shape[1] - 1)] * t)
    return tex[:, pad:pad + w].copy(), right.astype(np.float32)


def _scene(seed=5, h=128, w=192):
    """A ramp across x (-20 .. +18 px) with a raised block: offsets differ
    across tiles."""
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    disp = (-20.0 + 0.2 * xx).astype(np.float32)
    disp[40:90, 60:120] += 8.0
    left, right = shifted_pair(seed, disp)
    vl = np.ones((h, w), bool)
    vl[:, :6] = False
    return left, right, vl, np.ones((h, w), bool), disp


CFG = StereoConfig(max_disp=64, block_size=9, census_window=5,
                   adapt_band_rows=32, adapt_band_cols=64,
                   adapt_local_disp=32)


@pytest.mark.parametrize("form", ["row", "pixel", "chunk"])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bool"])
def test_shift_rows_exact(rng, form, dtype):
    img = rng.uniform(0, 1, (12, 64))
    img = {"float32": img.astype(np.float32),
           "int32": (img * 2 ** 24).astype(np.int32),
           "bool": img > 0.5}[dtype]
    fill = {"float32": 0.0, "int32": 0, "bool": False}[dtype]
    shape = {"row": (12,), "pixel": (12, 64), "chunk": (12, 8)}[form]
    shifts = rng.integers(-9, 10, shape).astype(np.int32)
    chunk = 8 if form == "chunk" else 1
    ref = jm.shift_rows(jnp.asarray(img), jnp.asarray(shifts), 9, fill,
                        chunk=chunk)
    got = tm.shift_rows(_t(img), _t(shifts), 9, fill, chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_shift_rows_matches_per_row_roll(rng):
    """The reference test's case: out(y, x) = img(y, x - s), 0 outside."""
    img = rng.uniform(0, 1, (8, 32)).astype(np.float32)
    shifts = np.array([-3, -1, 0, 1, 2, 5, -5, 4], np.int32)
    out = tm.shift_rows(_t(img), _t(shifts), pad=8, fill=0.0).numpy()
    for y, s in enumerate(shifts):
        xs = np.arange(32) - s
        ok = (xs >= 0) & (xs < 32)
        np.testing.assert_array_equal(out[y, ok], img[y, xs[ok]])
        assert (out[y, ~ok] == 0).all()
    with pytest.raises(ValueError):
        tm.shift_rows(_t(img), _t(np.zeros((8, 5), np.int32)), 8, 0.0,
                      chunk=8)


@pytest.mark.parametrize("shape", [(64, 68), (50, 67)])
def test_pool_masked_exact(rng, shape):
    img = rng.uniform(0, 1, shape).astype(np.float32)
    mask = rng.uniform(0, 1, shape) > 0.3
    ref = jb.pool_masked(jnp.asarray(img), jnp.asarray(mask), 4)
    got = tb.pool_masked(_t(img), _t(mask), 4)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _band_cases():
    rng = np.random.default_rng(0)
    disp = np.full((16, 64), 10.0, np.float32)
    disp[rng.uniform(size=(16, 64)) < 0.10] = 40.0
    disp2 = np.full((16, 64), -20.0, np.float32)
    disp2[rng.uniform(size=(16, 64)) < 0.10] = 100.0
    both = np.concatenate([disp, disp2], axis=0)
    tiles = np.zeros((16, 16), np.float32)
    tiles[:8, :8], tiles[:8, 8:] = -30, 42
    tiles[8:, :8], tiles[8:, 8:] = 10, -5
    empty = np.ones((32, 32), bool)
    empty[16:] = False
    noisy = rng.normal(0, 30, (72, 72)).astype(np.float32)
    return {  # the reference test's cases, and a noisy 4x3 tiling
        "bimodal": (both, np.ones_like(both, bool), dict(
            n_tiles_y=2, d_min=-144.0, d_max=144.0, half=40.0)),
        "narrow": (both, np.ones_like(both, bool), dict(
            n_tiles_y=2, d_min=-144.0, d_max=144.0, half=16.0)),
        "2d": (tiles, np.ones((16, 16), bool), dict(
            n_tiles_y=2, d_min=-64.0, d_max=64.0, half=20.0, n_tiles_x=2,
            min_count=16)),
        "empty": (np.full((32, 32), 12.0, np.float32), empty, dict(
            n_tiles_y=2, d_min=-64.0, d_max=64.0, half=24.0)),
        "noisy": (noisy, rng.uniform(0, 1, noisy.shape) > 0.2, dict(
            n_tiles_y=4, d_min=-144.0, d_max=143.0, half=48.0,
            n_tiles_x=3)),
    }


@pytest.mark.parametrize("case", list(_band_cases()))
def test_band_centers_exact(case):
    disp, valid, kw = _band_cases()[case]
    ref = jb.band_centers(jnp.asarray(disp), jnp.asarray(valid), **kw)
    got = tb.band_centers(_t(disp), _t(valid), **kw)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("tx", [1, 2, 3])
def test_field_offsets_exact(rng, tx):
    centers = rng.normal(0, 30, (4, tx)).astype(np.float32)
    xs = (np.arange(10, dtype=np.float32) + 0.5) * 8
    for x_coords, width in ((None, 80), (xs, 10)):
        kw = dict(tile_rows=16, tile_cols=24, height=70, width=width,
                  o_min=-40.0, o_max=36.0)
        ref = jb.field_offsets(jnp.asarray(centers), **kw, x_coords=(
            None if x_coords is None else jnp.asarray(x_coords)))
        got = tb.field_offsets(_t(centers), **kw, x_coords=(
            None if x_coords is None else _t(x_coords)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the reference test's case
    o = tb.field_offsets(_t(np.array([[0.0, 8.0], [32.0, 40.0]], np.float32)),
                         8, 8, 16, 16, -100.0, 36.0).numpy()
    assert o[0, 0] == 0 and o[8, 4] == 16 and o[4, 8] == 4 and o[12, 12] == 36


@pytest.mark.parametrize("form", ["chunk", "pixel", "row"])
@pytest.mark.parametrize("stride", [1, 2])
def test_compose_global(rng, form, stride):
    """Exact where the reference's scan is (measured bit-exact on every
    case here); held to 1e-6 px."""
    dl = rng.uniform(-24, 23, (12, 64)).astype(np.float32)
    o, chunk = {"chunk": (rng.integers(-9, 10, (12, 8)), 8),
                "pixel": (rng.integers(-9, 10, (12, 64)), 1),
                "row": (rng.integers(-9, 10, (12, 1)), 64)}[form]
    o = o.astype(np.int32)
    ref = jb.compose_global(jnp.asarray(dl), jnp.asarray(o), chunk, -24, 23,
                            stride=stride)
    got = tb.compose_global(_t(dl), _t(o), chunk, -24, 23, stride=stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)
    # the reference test's ramp: o(y, x) = x, dl = 2 -> global = x
    ramp = np.tile(np.arange(16, dtype=np.int32)[None, :], (4, 1))
    g = tb.compose_global(torch.full((4, 16), 2.0), _t(ramp), 1, -4, 4)
    np.testing.assert_allclose(g.numpy()[:, 2:], ramp[:, 2:], atol=1e-5)


@pytest.mark.parametrize("form", ["row", "pixel", "chunk"])
@pytest.mark.parametrize("cost_dtype", ["float32", "bfloat16"])
def test_build_cost_volume_row_shift(rng, form, cost_dtype):
    """The row-shifted cost volume against the reference at the full
    search's tolerances (the port's float32 costs lie within 1e-6 of the
    reference's, not bit for bit, test_torch_stereo.py::
    test_build_cost_volume; in bfloat16 at most 0.1% of the elements one
    step away), and under one constant shift bit-exact against the port's
    own full-search volume at the composed disparity (the reference's
    claim for its own)."""
    left, right, vl, vr, _ = _scene(h=48, w=64)
    cfg = StereoConfig(max_disp=16, block_size=5, census_window=5,
                       cost_dtype=cost_dtype)
    shape = {"row": (48,), "pixel": (48, 64), "chunk": (48, 4)}[form]
    shifts = rng.integers(-12, 13, shape).astype(np.int32)
    chunk = 16 if form == "chunk" else 1
    kw = dict(row_shift_pad=13, row_shift_chunk=chunk)
    ref = jm.build_cost_volume(*[jnp.asarray(a) for a in (left, right, vl,
                                                         vr)], cfg,
                               row_shift=jnp.asarray(shifts), **kw)
    got = tm.build_cost_volume(*[_t(a) for a in (left, right, vl, vr)],
                               _c(cfg), row_shift=_t(shifts), **kw)
    assert tuple(got.shape) == ref.shape
    r, g = _np(ref), _np(got)
    if cost_dtype == "float32":
        np.testing.assert_allclose(g, r, atol=1e-6, rtol=0)
    else:
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(r), 1e-30))) - 7)
        assert (r != g).mean() <= 1e-3
        assert (np.abs(r - g) <= step).all()

    # one shift of 8 everywhere: slice j (local d = -8 + j) holds the
    # global d = j, slice j + 32 of a 64-wide search, wherever the warped
    # view still holds the sample (away from the right border, beyond the
    # box's reach)
    args = [_t(a) for a in (left, right, vl, vr)]
    const = tm.build_cost_volume(*args, _c(cfg),
                                 row_shift=torch.full((48,), 8), **kw)
    full = tm.build_cost_volume(*args, _c(dataclasses.replace(cfg,
                                                              max_disp=64)))
    np.testing.assert_array_equal(_np(const)[..., :48],
                                  _np(full[32:48])[..., :48])


def _run_banded(cfg, offsets=None, scene=None):
    left, right, vl, vr, _ = scene or _scene()
    ref = jb.banded_disparity(*[jnp.asarray(a) for a in (left, right, vl,
                                                        vr)], cfg,
                              offsets=(None if offsets is None
                                       else jnp.asarray(offsets)))
    got = tb.banded_disparity(*[_t(a) for a in (left, right, vl, vr)],
                              _c(cfg), offsets=(None if offsets is None
                                                else _t(offsets)))
    jax.block_until_ready(ref[1].disparity)
    return ref, got


def _assert_banded_agree(ref, got):
    """Identical offsets and valid masks; photoconsistency within 1e-5;
    margins, costs and the local disparities within 1e-4 px, recomposed:
    global disparities within 1e-4 px on >= 99.9% of the pixels and
    everywhere within 1e-4 px times (1 + the largest step of the offset
    field between two chunks), since a lookup that straddles a chunk
    boundary scales a local difference by that step (measured, caller's
    (H, W) field: 6 of 24,576 pixels above 1e-5 px, the largest 2.3e-4 px
    at a 21 px step)."""
    o = got[3].numpy()
    np.testing.assert_array_equal(o, np.asarray(ref[3]))
    step = np.abs(np.diff(o, axis=1)).max() if o.shape[1] > 1 else 0
    for r, g in zip(ref[:2], got[:2]):
        np.testing.assert_array_equal(g.valid.numpy(), np.asarray(r.valid))
        for f in ("margin", "cost"):
            np.testing.assert_allclose(getattr(g, f).numpy(),
                                       np.asarray(getattr(r, f)), atol=1e-4,
                                       rtol=0, err_msg=f)
        for f in ("disparity", "check_disparity"):
            diff = np.abs(getattr(g, f).numpy() - np.asarray(getattr(r, f)))
            assert (diff <= 1e-4).mean() >= 0.999, f
            assert diff.max() <= 1e-4 * (1 + step), (f, diff.max(), step)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("form", ["rows", "field"])
def test_banded_disparity_caller_offsets(form):
    """The fine pass alone, with the offsets a caller gives (clamped,
    rounded, sampled at the chunk centres): measured max |diff| of the
    global disparities 8e-6 px."""
    _, _, _, _, disp = _scene()
    offsets = (np.round(disp.mean(1)) if form == "rows"
               else disp + 0.3).astype(np.float32)
    ref, got = _run_banded(CFG, offsets)
    _assert_banded_agree(ref, got)
    assert got[1].valid.float().mean() > 0.5


def test_banded_disparity_coarse_pass():
    """With its own coarse pass (pool_masked and the coarse matcher on the
    1/4 canvas): offsets identical (pool_masked is bit-exact, so no
    coarse census bit can flip) and the rest as
    :func:`_assert_banded_agree` says."""
    ref, got = _run_banded(CFG)
    _assert_banded_agree(ref, got)
    assert got[1].valid.float().mean() > 0.5
    assert len(np.unique(got[3].numpy())) > 4   # the offsets vary by tile


def test_banded_window_coverage_and_config():
    left, right, vl, vr, _ = _scene()
    ref = jb.window_coverage(*[jnp.asarray(a) for a in (left, right, vl,
                                                       vr)], CFG)
    got = tb.window_coverage(*[_t(a) for a in (left, right, vl, vr)],
                             _c(CFG))
    assert float(got) == float(ref) and float(got) > 0.9
    assert tb.coarse_config(_c(CFG)) == _c(jb.coarse_config(CFG))
    for width in (192, 200, 64):
        assert tb._warp_chunk(_c(CFG), width) == jb._warp_chunk(CFG, width)


def _pair_core_inputs(seed=5):
    """A rectified pair as pair_core takes it: raw intensities, -1 outside
    the footprint, and a fixed triangulation operator."""
    left, right, _, _, _ = _scene(seed)
    rect1 = 40.0 + 200.0 * left
    rect2 = 40.0 + 200.0 * right
    rect1[:, :10] = -1.0
    rect2[:, -10:] = -1.0
    rect1[:6] = -1.0
    M = np.array([[0.5, 0.0, 0.0, 0.0], [0.0, 0.5, 0.0, 0.0],
                  [0.3, 0.0, -0.3, 0.0]], np.float32)
    b = np.zeros(4, np.float32)
    return rect1.astype(np.float32), rect2.astype(np.float32), M, b


def compare_pair_core(cfg, seed=5):
    """The port's pair_core against the reference's on one rectified pair:
    (reference product, port product) as numpy."""
    args = _pair_core_inputs(seed)
    ref = jh.pair_core(*[jnp.asarray(a) for a in args], cfg)
    got = th.pair_core(*[_t(a) for a in args], _c(cfg))
    jax.block_until_ready(ref.valid)
    return ({k: np.asarray(v) for k, v in ref._asdict().items()},
            {k: v.numpy() for k, v in got._asdict().items()})


def test_pair_core_banded():
    """pair_core with adapt_band_rows > 0 (strict gates, band recovery)
    against the reference: valid masks identical, disparities within 1e-4
    px and heights within 1e-4 on the valid pixels."""
    ref, got = compare_pair_core(CFG)
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    v = got["valid"]
    assert v.mean() > 0.3
    for f in ("disparity", "height"):
        np.testing.assert_allclose(got[f][v], ref[f][v], atol=1e-4, rtol=0,
                                   err_msg=f)
