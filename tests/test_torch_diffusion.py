"""The port's tiled diffusion engine (``pcmi_tpu_torch.models.diffusion``)
against ``pcmi_tpu.models.diffusion`` on the CPU, at the reference tests'
small sizes (tile 16, stride 12, widths (8, 16, 16), 3-4 steps, 50
training timesteps).

The reference's parameter tree (names and shapes from ``jax.eval_shape``)
is filled with seeded numpy draws and carried into the port by
``convert.diffusion_state_dict``; the random draws of a training step and
of the samplers are the reference's own ``jax.random`` draws, split as its
code splits them, fed through the port's private ``_draws`` arguments.
Tolerances: the host-side grids, tokens and schedules equal; Sobel edges
and the tiler's slice and blend within 1e-6 (the blend also bit-equal to
a plain sequential loop over the tiles); network forwards within 1e-5;
the training loss within 1e-5 and each parameter leaf's gradient within
1e-4 of that leaf's norm (the biases in front of an instance norm, whose
gradient is 0 up to rounding, within 1e-6 of 0 in both); DDIM, DPM++
and img2img samples within 1e-4.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pcmi_tpu.models import diffusion as jd
from pcmi_tpu_torch import convert
from pcmi_tpu_torch.models import diffusion as td

torch.set_num_threads(1)

TINY = dict(steps=4, tile=16, stride=12, train_timesteps=50)
WIDTHS = (8, 16, 16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tok(prompt):
    return jd.tokenize_prompt(prompt)


def _pair(seed=0, channels=3, n_classes=0, text=False, edges=False, **kw):
    """The reference and port engines of one config, the reference's
    parameters (seeded numpy draws in its tree) and the port network
    carrying them."""
    cfg = dict(TINY, img_channels=channels, text_conditioning=text,
               edge_conditioning=edges,
               class_names=tuple(f"class{i}" for i in range(n_classes)), **kw)
    je = jd.TiledDiffusionEngine(jd.DiffusionConfig(**cfg), model=jd.CondUNet(
        widths=WIDTHS, out_channels=channels, n_classes=n_classes,
        text_conditioning=text))
    te = td.TiledDiffusionEngine(
        td.DiffusionConfig(**cfg), device="cpu", model=td.CondUNet(
            widths=WIDTHS, out_channels=channels, n_classes=n_classes,
            text_conditioning=text,
            in_channels=2 * channels + 1 + int(edges)))
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(je.init_params, jax.random.PRNGKey(0))

    def draw(s):
        scale = (np.sqrt(1.0 / np.prod(s.shape[:-1])) if len(s.shape) >= 2
                 else 0.1)
        return rng.normal(0, scale, s.shape).astype(np.float32)

    params = jax.tree_util.tree_map(draw, shapes)
    net = te.init_params()
    net.load_state_dict(convert.diffusion_state_dict(params, net))
    return je, te, params, net


def _sampler_draws(key, shape, steps):
    """``_sample``'s and ``_sample_dpmpp``'s draws of ``key``: the initial
    noise, then one locking draw per step."""
    k0, k = jax.random.split(key)
    x0 = _t(jax.random.normal(k0, shape))
    per_step = []
    for _ in range(steps):
        k, kn = jax.random.split(k)
        per_step.append(_t(jax.random.normal(kn, shape)))
    return x0, per_step


def test_tokens_schedules_and_grids():
    for p in ("Bright Urban buildings", "bright urban buildings", "",
              None, "a b c d e f g h i j", "dark farm fields"):
        np.testing.assert_array_equal(td.tokenize_prompt(p),
                                      jd.tokenize_prompt(p))
    assert td.MAX_PROMPT_TOKENS == jd.MAX_PROMPT_TOKENS
    assert td.TOKEN_HASH_BUCKETS == jd.TOKEN_HASH_BUCKETS
    for kw in (TINY, dict(train_timesteps=400, beta_end=0.15), {}):
        jc, tc = jd.DiffusionConfig(**kw), td.DiffusionConfig(**kw)
        np.testing.assert_array_equal(
            td.make_schedule(tc, "cpu").alphas_bar.numpy(),
            np.asarray(jd.make_schedule(jc).alphas_bar))
        for steps in (4, 12, 18, 27):
            s_ref, t_ref = jd.karras_sigmas(jc, steps)
            s, t = td.karras_sigmas(tc, steps)
            np.testing.assert_array_equal(s, np.asarray(s_ref))
            np.testing.assert_array_equal(t, np.asarray(t_ref))
    assert dataclass_fields(td.DiffusionConfig) == dataclass_fields(
        jd.DiffusionConfig)
    for tile in (16, 32, 64):
        np.testing.assert_array_equal(td.gaussian_weights(tile, "cpu").numpy(),
                                      np.asarray(jd.gaussian_weights(tile)))
    for size in (10, 16, 28, 41, 57, 1024):
        assert td.tile_origins(size, 16, 12) == jd.tile_origins(size, 16, 12)
        assert td.tile_origins(size, 32, 24) == jd.tile_origins(size, 32, 24)


def dataclass_fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("T", [50, 64, 100, 400, 1000])
def test_integer_step_grids_equal(T):
    """The DDIM timestep grids and img2img's start and step counts, built
    as the reference builds them (float32, then truncated)."""
    for steps in (2, 3, 4, 12, 18, 27, 50):
        want = np.asarray(jnp.linspace(T - 1, 0, steps).astype(jnp.int32))
        np.testing.assert_array_equal(
            td._linspace32(T - 1, 0, steps).astype(np.int32), want)
        for strength in (0.1, 0.3, 0.55, 0.9):
            t0 = int(T * strength)
            n = max(2, int(steps * strength))
            want = np.asarray(jnp.linspace(t0 - 1, 0, n).astype(jnp.int32))
            np.testing.assert_array_equal(
                td._linspace32(t0 - 1, 0, n).astype(np.int32), want)
    np.testing.assert_array_equal(td._linspace32(0.0, 6.0, 16),
                                  np.asarray(jnp.linspace(0.0, 6.0, 16)))


def test_sobel_edges_and_cond_stack(rng):
    img = rng.uniform(-1, 1, (3, 20, 23, 3)).astype(np.float32)
    mask = (rng.uniform(size=(3, 20, 23, 1)) < 0.3).astype(np.float32)
    want = jax.vmap(jd.sobel_edges)(jnp.asarray(img), jnp.asarray(mask))
    np.testing.assert_allclose(td.sobel_edges(_t(img), _t(mask)).numpy(),
                               np.asarray(want), atol=1e-6, rtol=0)
    gray = img[0, ..., 0]
    np.testing.assert_allclose(
        td.sobel_edges(_t(gray), _t(mask[0])).numpy(),
        np.asarray(jd.sobel_edges(jnp.asarray(gray), jnp.asarray(mask[0]))),
        atol=1e-6, rtol=0)
    cfg = dict(TINY, edge_conditioning=True)
    np.testing.assert_allclose(
        td._cond_stack(td.DiffusionConfig(**cfg), _t(img[0]),
                       _t(mask[0])).numpy(),
        np.asarray(jd._cond_stack(jd.DiffusionConfig(**cfg),
                                  jnp.asarray(img[0]), jnp.asarray(mask[0]))),
        atol=1e-6, rtol=0)


@pytest.mark.parametrize("canvas", [(16, 16), (28, 41), (57, 30)])
def test_tiler_slice_and_blend(rng, canvas):
    """One batched gather cuts the tiles; the blend sums each pixel's
    tiles in the reference's row-major order (bit-equal to a sequential
    loop of ``acc[tile] += tiles[i] * wts``) and divides by the same
    summed weights."""
    cfg = dict(TINY, img_channels=2)
    je = jd.TiledDiffusionEngine(jd.DiffusionConfig(**cfg))
    te = td.TiledDiffusionEngine(td.DiffusionConfig(**cfg), device="cpu")
    h, w = canvas
    full = rng.normal(size=(h, w, 2)).astype(np.float32)
    sl_j, bl_j = je._tiler(canvas)
    sl_t, bl_t = te._tiler(canvas)
    tiles = sl_t(_t(full))
    np.testing.assert_array_equal(tiles.numpy(),
                                  np.asarray(sl_j(jnp.asarray(full))))
    noisy = rng.normal(size=tiles.shape).astype(np.float32)
    got = bl_t(_t(noisy)).numpy()
    np.testing.assert_allclose(got, np.asarray(bl_j(jnp.asarray(noisy))),
                               atol=1e-6, rtol=0)
    # the plain sequential loop
    t = cfg["tile"]
    wts = td.gaussian_weights(t, "cpu")
    acc, norm = torch.zeros((h, w, 2)), torch.zeros((h, w, 1))
    origins = [(y, x) for y in td.tile_origins(h, t, 12)
               for x in td.tile_origins(w, t, 12)]
    for i, (y, x) in enumerate(origins):
        acc[y:y + t, x:x + t] += _t(noisy[i]) * wts
        norm[y:y + t, x:x + t] += wts
    np.testing.assert_array_equal(got, (acc / norm).numpy())


@pytest.mark.parametrize("n_classes,text,edges",
                         [(0, False, False), (2, True, False),
                          (0, True, True), (3, False, True)])
def test_cond_unet_forward(rng, n_classes, text, edges):
    je, te, params, net = _pair(n_classes=n_classes, text=text, edges=edges)
    x = rng.normal(size=(3, 16, 16, 3)).astype(np.float32)
    cond = rng.normal(size=(3, 16, 16, 4 + int(edges))).astype(np.float32)
    t = np.array([0.0, 0.37, 0.98], np.float32)
    cid = np.array([0, 1, n_classes - 1], np.int32) if n_classes else None
    tok = np.stack([_tok("bright urban blocks"), _tok(""),
                    _tok("a b c d e f g h i")]) if text else None
    for c_, k_ in ((cid, tok), (None, None)):
        want = np.asarray(je.model.apply(
            params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond),
            None if c_ is None else jnp.asarray(c_),
            None if k_ is None else jnp.asarray(k_)))
        with torch.no_grad():
            got = net(_t(x), _t(t), _t(cond),
                      None if c_ is None else _t(c_),
                      None if k_ is None else _t(k_)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_text_encoder_forward(rng):
    enc = jd.TextEncoder(dim=32)
    tok = np.stack([_tok("dense bright city"), _tok(""), _tok("x")])
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(tok))
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.3, a.shape).astype(np.float32), params)
    mine = td.TextEncoder(32)
    sd = convert._flax_state_dict(params, mine, [
        ("embed", "Embed_0", "embed"), ("conv", "Conv_0", "conv1d"),
        ("dense", "Dense_0", "dense")])
    mine.load_state_dict(sd)
    with torch.no_grad():
        got = mine(_t(tok)).numpy()
    np.testing.assert_allclose(got, np.asarray(enc.apply(params, tok)),
                               atol=1e-5, rtol=0)


def test_state_dict_refuses_mismatch():
    _, _, params, net = _pair(text=True)
    other = td.CondUNet(widths=WIDTHS, out_channels=3)
    with pytest.raises(KeyError):
        convert.diffusion_state_dict(params, other)
    wide = td.CondUNet(widths=(8, 16, 32), out_channels=3,
                       text_conditioning=True)
    with pytest.raises(ValueError):
        convert.diffusion_state_dict(params, wide)


@pytest.mark.parametrize("case", ["text", "classes", "edges"])
def test_train_step_loss_and_grads(rng, case):
    """Loss within 1e-5 and each leaf's gradient within 1e-4 of its norm,
    on the reference's draws (``kt, kn, kd = split(key, 3)``)."""
    kw = dict(text=dict(text=True, cfg_dropout=0.5),
              classes=dict(n_classes=2, cfg_dropout=0.5),
              edges=dict(edges=True))[case]
    je, te, params, net = _pair(seed=3, **kw)
    b = 4
    images = rng.uniform(-1, 1, (b, 16, 16, 3)).astype(np.float32)
    masks = np.zeros((b, 16, 16, 1), np.float32)
    masks[:, 4:11, 3:12] = 1.0
    cid = np.array([0, 1, 1, 0], np.int32) if case == "classes" else None
    tok = (np.stack([_tok("bright urban"), _tok("dark fields"),
                     _tok("urban"), _tok("fields flat")])
           if case == "text" else None)
    key = jax.random.PRNGKey(11)
    jcid = None if cid is None else jnp.asarray(cid)
    jtok = None if tok is None else jnp.asarray(tok)
    loss_ref, g_ref = jax.value_and_grad(je.train_step_loss)(
        params, jnp.asarray(images), jnp.asarray(masks), key, jcid, jtok)
    kt, kn, kd = jax.random.split(key, 3)
    draws = (_t(jax.random.randint(kt, (b,), 0, TINY["train_timesteps"])),
             _t(jax.random.normal(kn, images.shape)),
             _t(jax.random.bernoulli(kd, je.cfg.cfg_dropout, (b,))))
    if case != "edges":
        assert draws[2].any() and not draws[2].all()  # both branches run
    loss = te.train_step_loss(net, _t(images), _t(masks), None,
                              None if cid is None else _t(cid),
                              None if tok is None else _t(tok), _draws=draws)
    assert abs(loss.item() - float(loss_ref)) <= 1e-5
    net.zero_grad()
    loss.backward()
    want = convert.diffusion_state_dict(
        jax.tree_util.tree_map(np.asarray, g_ref), net)
    for name, p in net.named_parameters():
        ref = want[name].numpy()
        got = p.grad.numpy()
        if name.endswith((".conv0.bias", ".conv1.bias")):
            # a bias before an instance norm: its gradient is 0 up to
            # rounding in both packages
            assert np.abs(got).max() <= 1e-6 and np.abs(ref).max() <= 1e-6
            continue
        gap = np.abs(got - ref).max()
        assert gap <= 1e-4 * np.linalg.norm(ref), (name, gap)


@pytest.mark.parametrize("method", ["ddim", "dpmpp"])
@pytest.mark.parametrize("guidance,negative", [(1.0, None),
                                               (3.0, "dark fields")])
def test_samples_match_reference(rng, method, guidance, negative):
    """Tiled DDIM and DPM++(2M) fills with text conditioning, plain and
    with guidance 3 and a negative prompt, on a canvas of 2 x 3 tiles,
    from the reference's own draws."""
    je, te, params, net = _pair(seed=5, text=True)
    h, w = 28, 41
    img = rng.uniform(-1, 1, (h, w, 3)).astype(np.float32)
    mask = np.zeros((h, w, 1), np.float32)
    mask[6:20, 10:30] = 1.0
    key = jax.random.PRNGKey(7)
    tok = _tok("bright urban blocks")
    neg = None if negative is None else _tok(negative)
    fj = je._sample_dpmpp if method == "dpmpp" else je._sample
    ft = te._sample_dpmpp if method == "dpmpp" else te._sample
    want = np.asarray(fj(params, jnp.asarray(img), jnp.asarray(mask), key,
                         canvas=(h, w), tokens=jnp.asarray(tok),
                         neg_tokens=None if neg is None else jnp.asarray(neg),
                         guidance=guidance))
    got = ft(net, _t(img), _t(mask), None, (h, w), tokens=_t(tok),
             neg_tokens=None if neg is None else _t(neg), guidance=guidance,
             _draws=_sampler_draws(key, (h, w, 3), TINY["steps"])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    known = mask[..., 0] < 0.5
    np.testing.assert_array_equal(got[known], img[known])


def test_class_guided_sample_matches_reference(rng):
    """DDIM with class conditioning at guidance 2 (the class branch of
    the stacked CFG batch)."""
    je, te, params, net = _pair(seed=6, channels=1, n_classes=2)
    img = rng.uniform(-1, 1, (16, 16, 1)).astype(np.float32)
    hole = np.ones((16, 16, 1), np.float32)
    key = jax.random.PRNGKey(2)
    want = np.asarray(je._sample(params, jnp.asarray(img), jnp.asarray(hole),
                                 key, canvas=(16, 16),
                                 class_id=jnp.asarray(1, jnp.int32),
                                 guidance=2.0))
    got = te._sample(net, _t(img), _t(hole), None, (16, 16), class_id=1,
                     guidance=2.0,
                     _draws=_sampler_draws(key, (16, 16, 1), 4)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("canvas,strength", [((28, 41), 0.3), ((12, 14), 0.6)])
def test_img2img_matches_reference(rng, canvas, strength):
    je, te, params, net = _pair(seed=8, text=True)
    h, w = canvas
    img = rng.uniform(-1, 1, (h, w, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(je._img2img(params, jnp.asarray(img), key,
                                  canvas=canvas, strength=strength))
    hh, ww = max(h, 16), max(w, 16)
    k0, _ = jax.random.split(key)
    got = te._img2img(net, _t(img), None, canvas, strength=strength,
                      _draws=_t(jax.random.normal(k0, (hh, ww, 3)))).numpy()
    assert got.shape == (h, w, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_duck_surface_below_tile_size(rng):
    """``restore`` / ``enhance`` on a canvas smaller than a tile (the
    reference's duck-surface test), and the prompt maps of the class
    vocabulary."""
    from pcmi_tpu_torch.models.dip import DIPResult

    cfg = td.DiffusionConfig(steps=3, tile=16, stride=12, img_channels=1,
                             train_timesteps=50,
                             class_names=("dark fields", "bright urban"))
    eng = td.TiledDiffusionEngine(cfg, device="cpu", model=td.CondUNet(
        widths=WIDTHS, out_channels=1, n_classes=2))
    assert eng.class_for_prompt("a BRIGHT urban scene") == 1
    assert eng.class_for_prompt("dark fields at dusk") == 0
    assert eng.class_for_prompt(None) == 0 and eng.class_for_prompt(1) == 1
    img = rng.uniform(0.2, 0.8, (12, 14)).astype(np.float32)
    mask = np.zeros((12, 14), np.float32)
    mask[4:8, 4:8] = 1.0
    res = eng.restore(img, mask)
    assert isinstance(res, DIPResult)
    out = res.output.numpy()
    assert out.shape == (12, 14) and np.isfinite(out).all()
    np.testing.assert_allclose(out[mask < 0.5], img[mask < 0.5], atol=1e-6)
    enh = eng.enhance(img).output.numpy()
    assert enh.shape == (12, 14) and np.isfinite(enh).all()
    rgb = eng.stitch(np.repeat(img[..., None], 3, -1), mask).output
    assert tuple(rgb.shape) == (12, 14)   # the reference's channel rule


def test_engine_registry_and_processor():
    """"Diffusion" joins the engine registry, and the restoration
    processor runs the diffusion engine end to end."""
    from pcmi_tpu.pipelines.generative import available_engines as ref
    from pcmi_tpu_torch.pipelines.generative import (
        ImageRestorationProcessor, RestorationGenerativePlugin,
        available_engines)

    engines = available_engines()
    assert engines["Diffusion"] is td.TiledDiffusionEngine
    assert set(engines) == set(ref())
    cfg = td.DiffusionConfig(steps=3, tile=16, stride=12, img_channels=3,
                             train_timesteps=50)
    eng = td.TiledDiffusionEngine(cfg, device="cpu", model=td.CondUNet(
        widths=WIDTHS, out_channels=3))
    rng = np.random.default_rng(1)
    img = rng.uniform(0.2, 0.8, (20, 26, 3)).astype(np.float32)
    holes = img.copy()
    holes[8:11, 9:13] = np.nan
    res = ImageRestorationProcessor(eng, margin=1, device="cpu").process(holes)
    assert res.shape == img.shape and np.isfinite(res).all()
    far = np.ones((20, 26), bool)
    far[6:13, 7:15] = False
    np.testing.assert_allclose(res[far], img[far], atol=1e-6)
    layers = RestorationGenerativePlugin(engine=eng, device="cpu").run(holes)
    assert np.isfinite(layers[1][0]).all()


def test_text_conditioning_and_cfg_steer_generation():
    """The reference's trained steering test (``tests/test_generative.py``,
    text and guidance) on the port alone, with the port's draws: 600 Adam
    steps on two captioned pattern classes, then the prompt steers the
    DDIM fill's pattern coefficient, guidance 3 widens the gap and a
    negative prompt pushes away from the negated content (the reference's
    bounds)."""
    from pcmi_tpu_torch.models.training import adam, apply_gradients

    cfg = td.DiffusionConfig(steps=12, tile=16, stride=12, img_channels=1,
                             train_timesteps=64, beta_end=0.15,
                             text_conditioning=True, cfg_dropout=0.15)
    eng = td.TiledDiffusionEngine(cfg, device="cpu", model=td.CondUNet(
        widths=WIDTHS, out_channels=1, text_conditioning=True))
    net = eng.init_params(torch.Generator().manual_seed(0))
    caps = {-1: ["dark quiet fields", "flat dark farmland", "fields dark flat"],
            +1: ["bright dense urban", "urban bright blocks",
                 "dense bright city"]}
    tok = {s: _t(np.stack([_tok(c) for c in cs]).astype(np.int64))
           for s, cs in caps.items()}
    ys, xs = np.mgrid[0:16, 0:16]
    pat = _t(np.sign(np.sin(ys * 0.9) * np.sin(xs * 0.9))
             .astype(np.float32))[None, :, :, None]
    params = list(net.parameters())
    opt = adam(params, "cpu", lr=3e-3)
    g = torch.Generator().manual_seed(1)
    masks = torch.ones((16, 16, 16, 1))
    loss0 = None
    for _ in range(600):
        sign = torch.randint(0, 2, (16,), generator=g)
        variant = torch.randint(0, 3, (16,), generator=g)
        toks = torch.where(sign[:, None] > 0, tok[1][variant],
                           tok[-1][variant])
        sc = (torch.where(sign > 0, 0.45, -0.45)
              + 0.5 * torch.randn((16,), generator=g))
        imgs = (sc[:, None, None, None] * pat
                + 0.05 * torch.randn((16, 16, 16, 1), generator=g))
        loss = eng.train_step_loss(net, imgs, masks, g, None, toks)
        apply_gradients(opt, params, loss)
        if loss0 is None:
            loss0 = loss.item()
    assert loss.item() < 0.5 * loss0

    img, hole = torch.zeros((16, 16, 1)), torch.ones((16, 16, 1))

    def coeff(prompt, seed, guidance=1.0, negative=None):
        out = eng.inpaint(net, img, hole, seed=seed, prompt=prompt,
                          method="ddim", guidance=guidance,
                          negative_prompt=negative)
        return float((out * pat[0]).mean())

    seeds = (3, 4, 5)
    c_dark = np.mean([coeff("quiet dark fields", s) for s in seeds])
    c_bright = np.mean([coeff("bright urban blocks", s) for s in seeds])
    assert c_bright > c_dark + 0.05, (c_dark, c_bright)
    g_dark = np.mean([coeff("quiet dark fields", s, 3.0) for s in seeds])
    g_bright = np.mean([coeff("bright urban blocks", s, 3.0) for s in seeds])
    assert g_bright - g_dark > c_bright - c_dark, (g_dark, g_bright)
    n_bright = np.mean([coeff("bright urban blocks", s, 2.0, "dark fields")
                        for s in seeds])
    assert n_bright > c_dark + 0.05
