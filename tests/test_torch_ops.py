"""The port's image ops (pcmi_tpu_torch.ops) against pcmi_tpu on the CPU.

Inputs are made with numpy from a seed and fed to both packages; each
check states its tolerance. Float32 filters may round differently in the
last bits (the reference's compiler may fuse multiply-adds), hence the
1e-5/1e-6 bounds where the arithmetic is not exactly the same.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pcmi_tpu.ops import filters as jf
from pcmi_tpu.ops import morphology as jmo
from pcmi_tpu.ops import normalize as jn
from pcmi_tpu.ops import pointcloud as jp
from pcmi_tpu.ops import warp as jw
from pcmi_tpu_torch.ops import filters as tf
from pcmi_tpu_torch.ops import morphology as tmo
from pcmi_tpu_torch.ops import normalize as tn
from pcmi_tpu_torch.ops import pointcloud as tp
from pcmi_tpu_torch.ops import warp as tw

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _image(rng, shape=(40, 56)):
    img = rng.uniform(0, 1, shape).astype(np.float32)
    mask = rng.uniform(0, 1, shape) > 0.2
    return img, mask


def test_normalise_image_grid_path(rng):
    img, mask = _image(rng)
    img = img * 3.0 + 0.5
    ref, _ = jn.normalise_image(jnp.asarray(img), jnp.asarray(mask),
                                subsample=2)
    got, _ = tn.normalise_image(_t(img), _t(mask), subsample=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("mask_kind", ["some", "all", "none"])
def test_masked_quantile_sort_path(rng, mask_kind):
    """The exact (one sort) quantile against the reference's, scalar and
    vector q: the same element of the same sorted array, exact; an empty
    mask reads +inf in both."""
    x, mask = _image(rng)
    x = x ** 2 * 5.0 - 1.0
    mask = {"some": mask, "all": np.ones_like(mask),
            "none": np.zeros_like(mask)}[mask_kind]
    for q in (0.5, 0.0, 1.0, [0.02, 0.98], [0.25, 0.5, 0.75]):
        ref = np.asarray(jn._masked_quantile(jnp.asarray(x), jnp.asarray(mask),
                                             jnp.asarray(q)))
        got = tn._masked_quantile(_t(x), _t(mask), q).numpy()
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        assert np.isinf(got).all() == (mask_kind == "none")


@pytest.mark.parametrize("with_mask", [True, False])
def test_normalise_image_default_path(rng, with_mask):
    """normalise_image with its own defaults (subsample=1: exact medians)
    and robust_bounds on a 3-D input, against the reference's: bounds
    within 1e-6, image within 1e-6."""
    img, mask = _image(rng)
    img = img * 3.0 + 0.5
    if not with_mask:
        img[~mask] = -1.0          # the sentinel convention: mask = img >= 0
    margs = (jnp.asarray(mask),) if with_mask else ()
    targs = (_t(mask),) if with_mask else ()
    ref, rmask = jn.normalise_image(jnp.asarray(img), *margs)
    got, gmask = tn.normalise_image(_t(img), *targs)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(rmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)
    cube = np.stack([img, img * 0.5, img + 1.0])
    cmask = np.stack([mask, mask, ~mask])
    for r, g in zip(jn.robust_bounds(jnp.asarray(cube), jnp.asarray(cmask),
                                     subsample=4),
                    tn.robust_bounds(_t(cube), _t(cmask), subsample=4)):
        np.testing.assert_allclose(float(g), float(r), atol=1e-6, rtol=0)


def test_normalise_image_empty_mask(rng):
    """No valid pixel: the reference's bounds are infinite and its image
    all zeros; so are the port's."""
    img, mask = _image(rng)
    none = np.zeros_like(mask)
    ref, _ = jn.normalise_image(jnp.asarray(img), jnp.asarray(none))
    got, _ = tn.normalise_image(_t(img), _t(none))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not got.any()


def test_percentile_stretch_and_to_uint8(rng):
    """percentile_stretch (with a mask, and on non-finite pixels without
    one) within 1e-6 of the reference's; to_uint8 exact on its output and
    on values outside [0, 1]."""
    img, mask = _image(rng)
    img = img * 40.0 - 3.0
    ref = jn.percentile_stretch(jnp.asarray(img), jnp.asarray(mask))
    got = tn.percentile_stretch(_t(img), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)
    holes = img.copy()
    holes[~mask] = np.nan
    ref2 = jn.percentile_stretch(jnp.asarray(holes), p_lo=5.0, p_hi=90.0)
    got2 = tn.percentile_stretch(_t(holes), p_lo=5.0, p_hi=90.0)
    np.testing.assert_allclose(got2.numpy(), np.asarray(ref2), atol=1e-6,
                               rtol=0)
    for x in (np.asarray(ref), np.linspace(-0.5, 1.5, 41, dtype=np.float32)):
        np.testing.assert_array_equal(tn.to_uint8(_t(x)).numpy(),
                                      np.asarray(jn.to_uint8(jnp.asarray(x))))
    assert tn.to_uint8(got).dtype == torch.uint8


@pytest.mark.parametrize("q,stages", [(0.5, 2), (0.02, 2), (0.98, 1)])
def test_masked_quantile_grid(rng, q, stages):
    x, mask = _image(rng)
    x = x ** 2 * 5.0 - 1.0
    args = (-1.0, 4.0, q)
    ref = jn.masked_quantile_grid(jnp.asarray(x), jnp.asarray(mask), *args,
                                  stages=stages)
    got = tn.masked_quantile_grid(_t(x), _t(mask), *args, stages=stages)
    np.testing.assert_allclose(float(got), float(ref), atol=1e-6, rtol=1e-6)
    # the grid's counts are exact: empty and all-masked inputs agree too
    none = np.zeros_like(mask)
    np.testing.assert_allclose(
        float(tn.masked_quantile_grid(_t(x), _t(none), *args)),
        float(jn.masked_quantile_grid(jnp.asarray(x), jnp.asarray(none),
                                      *args)), atol=1e-6)


@pytest.mark.parametrize("geometric", [True, False])
def test_masked_median_grid(rng, geometric):
    x, mask = _image(rng)
    x = x ** 3 * 2.0
    ref = jn.masked_median_grid(jnp.asarray(x), jnp.asarray(mask), 0.0, 2.0,
                                geometric=geometric)
    got = tn.masked_median_grid(_t(x), _t(mask), 0.0, 2.0,
                                geometric=geometric)
    np.testing.assert_allclose(float(got), float(ref), atol=1e-6, rtol=1e-5)


def test_snr_ratio(rng):
    img, mask = _image(rng, (48, 64))
    ref = jn.snr_ratio(jnp.asarray(img), jnp.asarray(mask))
    got = tn.snr_ratio(_t(img), _t(mask))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    # the reference's `subsample` argument is accepted (and, as there,
    # changes nothing)
    again = tn.snr_ratio(_t(img), _t(mask), subsample=4)
    assert float(again) == float(got)
    assert float(tn.snr_ratio(_t(img), _t(mask), 2)) == float(got)


@pytest.mark.parametrize("iterations", [1, 3, 8])
def test_binary_dilation_exact(rng, iterations):
    mask = rng.uniform(0, 1, (40, 56)) > 0.97
    ref = jmo.binary_dilation(jnp.asarray(mask), iterations=iterations)
    got = tmo.binary_dilation(_t(mask), iterations=iterations)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", ["gaussian", "box", "guided", "masked_guided",
                                  "median"])
def test_filters(rng, name):
    img, mask = _image(rng)
    src = rng.normal(0, 3, img.shape).astype(np.float32)
    j, t = jnp.asarray, _t
    ref, got, tol = {
        "gaussian": lambda: (jf.gaussian_filter(j(img), 2.0),
                             tf.gaussian_filter(t(img), 2.0), 1e-6),
        "box": lambda: (jf.box_filter(j(img), 4), tf.box_filter(t(img), 4),
                        1e-6),
        "guided": lambda: (jf.guided_filter(j(img), j(src), 4, 1e-3),
                           tf.guided_filter(t(img), t(src), 4, 1e-3), 1e-4),
        "masked_guided": lambda: (
            jf.masked_guided_filter(j(img), j(src), j(mask), 4, 1e-3),
            tf.masked_guided_filter(t(img), t(src), t(mask), 4, 1e-3), 1e-4),
        # min/max network: the same element, exactly
        "median": lambda: (jf.separable_median_filter(j(src), 13),
                           tf.separable_median_filter(t(src), 13), 0.0),
    }[name]()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol,
                               rtol=0)


def test_fit_plane_and_relative_height(rng):
    h, w = 30, 40
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    z = 0.05 * xs - 0.02 * ys + 3.0 + rng.normal(0, 0.1, (h, w))
    xyz = np.stack([xs, ys, z], -1).astype(np.float32)
    wts = (rng.uniform(0, 1, (h, w)) > 0.3).astype(np.float32)
    ref = jp.fit_plane(jnp.asarray(xyz), jnp.asarray(wts))
    got = tp.fit_plane(_t(xyz), _t(wts))
    np.testing.assert_allclose(got.normal.numpy(), np.asarray(ref.normal),
                               atol=1e-5)
    np.testing.assert_allclose(got.centroid.numpy(), np.asarray(ref.centroid),
                               atol=1e-5)
    assert got.normal[2] > 0
    rel_ref = jp.plane_relative_height(jnp.asarray(xyz), ref)
    rel = tp.plane_relative_height(_t(xyz), got)
    np.testing.assert_allclose(rel.numpy(), np.asarray(rel_ref), atol=1e-4)


def test_warps(rng):
    img = rng.uniform(0, 1, (30, 40)).astype(np.float32)
    ys = rng.uniform(-2, 32, (17, 23)).astype(np.float32)
    xs = rng.uniform(-2, 42, (17, 23)).astype(np.float32)
    np.testing.assert_allclose(
        tw.map_coordinates(_t(img), _t(ys), _t(xs), -1.0).numpy(),
        np.asarray(jw.map_coordinates(jnp.asarray(img), jnp.asarray(ys),
                                      jnp.asarray(xs), -1.0)), atol=1e-6)
    H = np.array([[0.9, 0.1, 2.5], [-0.15, 1.05, -1.25]], np.float32)
    inv_ref = np.asarray(jw.invert_affine(jnp.asarray(H)))
    inv = tw.invert_affine(_t(H))
    np.testing.assert_allclose(inv.numpy(), inv_ref, atol=1e-6)
    np.testing.assert_allclose(
        tw.affine_warp(_t(img), inv, (36, 44), fill=-1.0).numpy(),
        np.asarray(jw.affine_warp(jnp.asarray(img), jnp.asarray(inv_ref),
                                  (36, 44), fill=-1.0)), atol=1e-5)


@pytest.mark.parametrize("size", [3, 4, 5])
def test_morphology_exact(rng, size):
    """Erosion, closing, the grey filters and a one-step dilation, odd and
    even windows (the reference's "SAME" placement): bit-exact."""
    img, mask = _image(rng)
    jimg, jmask = jnp.asarray(img), jnp.asarray(mask)
    cases = [
        (tmo.binary_dilation(_t(mask), size=size),
         jmo.binary_dilation(jmask, size=size)),
        (tmo.binary_erosion(_t(mask), iterations=2, size=size),
         jmo.binary_erosion(jmask, iterations=2, size=size)),
        (tmo.binary_closing(_t(mask), size=size),
         jmo.binary_closing(jmask, size=size)),
        (tmo.grey_erosion(_t(img), size), jmo.grey_erosion(jimg, size)),
        (tmo.grey_dilation(_t(img), size), jmo.grey_dilation(jimg, size)),
    ]
    for got, ref in cases:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("max_dist", [1, 6, 32])
def test_distance_transform_exact(rng, max_dist):
    mask = np.ones((40, 56), bool)
    mask[rng.uniform(0, 1, mask.shape) < 0.01] = False
    mask[:, :3] = False
    got = tmo.distance_transform(_t(mask), max_dist)
    ref = jmo.distance_transform(jnp.asarray(mask), max_dist)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_gabor_bank_and_filter_bank(rng):
    """The bank bit-exact (both built in float64 numpy); the correlation
    (a float32 convolution in both, other summation orders) within 1e-5
    of values up to ~10."""
    bank = tf.gabor_bank(ksize=9)
    jbank = jf.gabor_bank(ksize=9)
    np.testing.assert_array_equal(bank.numpy(), np.asarray(jbank))
    assert tuple(tf.gabor_bank().shape) == (16, 31, 31)
    img, _ = _image(rng)
    got = tf.filter_bank_2d(_t(img), bank)
    ref = jf.filter_bank_2d(jnp.asarray(img), jbank)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("channels", [0, 3])
def test_masked_jacobi_fill(rng, channels):
    """(H, W) and (H, W, C) images: the known pixels exact, the holes
    within 1e-5 (the seed mean sums in another order)."""
    shape = (32, 40) + ((channels,) if channels else ())
    img = rng.uniform(0, 1, shape).astype(np.float32)
    hole = np.zeros((32, 40), np.float32)
    hole[10:20, 12:30] = 1.0
    got = tf.masked_jacobi_fill(_t(img), _t(hole), iters=24)
    ref = jf.masked_jacobi_fill(jnp.asarray(img), jnp.asarray(hole), iters=24)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    known = (hole == 0) if not channels else (hole == 0)[..., None].repeat(
        channels, -1)
    np.testing.assert_array_equal(got.numpy()[known], img[known])


def test_unsharp_mask_and_local_entropy(rng):
    img, _ = _image(rng)
    np.testing.assert_allclose(
        tf.unsharp_mask(_t(img)).numpy(),
        np.asarray(jf.unsharp_mask(jnp.asarray(img))), atol=1e-6, rtol=0)
    for radius in (5, 2):   # the reference's n_bins is its default only
        got = tf.local_entropy(_t(img), radius=radius)
        ref = jf.local_entropy(jnp.asarray(img), radius=radius)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)


def test_homography_warp_and_points(rng):
    img, _ = _image(rng)
    H = np.array([[1.02, 0.03, -2.5], [-0.02, 0.98, 1.5],
                  [1e-4, -2e-4, 1.0]], np.float32)
    got = tw.homography_warp(_t(img), _t(H), (36, 60), fill=-1.0)
    ref = jw.homography_warp(jnp.asarray(img), jnp.asarray(H), (36, 60),
                             fill=-1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    pts = rng.uniform(0, 100, (50, 2)).astype(np.float32)
    for m in (H[:2], H):
        np.testing.assert_allclose(
            tw.warp_points_affine(_t(m), _t(pts)).numpy(),
            np.asarray(jw.warp_points_affine(jnp.asarray(m),
                                             jnp.asarray(pts))),
            atol=1e-4, rtol=0)
