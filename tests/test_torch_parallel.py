"""The port's scale-out layer (``pcmi_tpu_torch.parallel``,
``models.training.data_parallel_step``) in a gloo world of 4 processes on
the CPU, against the reference's layer on its 8-device virtual CPU mesh
and against the port's single-device results.

One world runs every multi-rank case (``tests/_torch_parallel_worker.py``,
which imports only the port; a ``file://`` store in ``tmp_path``): the
2 x 2 (data, tile) mesh, the halo exchange, ``sharded_rows_map``,
``sharded_disparity``, ``batched_pair_step``, ``sharded_dsm_update``,
data-parallel GAN steps, an inpainting step with one hole pixel and one
step of each detector trainer on a 4 x 1 mesh (one image per rank; the
full scenes, two valid boxes, none), and a (dcn, data, tile) mesh of two
hosts of two ranks. The whole world is joined within one 120 s deadline
and every rank killed on expiry, so a hang fails these tests instead of
stalling the suite.

Tolerances: halo rows and the rows map equal the slices of the whole
array; ``sharded_disparity`` within the port's ``compute_disparity``
tolerances of the reference's ``sharded_disparity`` on the same 2 x 2
mesh shape (disparity within 1e-3 px and validity equal on 99.9 % of the
pixels; the reference's chain differs from the port's by rounding only),
and the reference's 0.51 px / 98 % check against the single-device
matcher; ``batched_pair_step`` equal to single-device ``pair_core``; the
sharded DSM within ``tests/test_fusion_sharded.py``'s tolerances of the
port's sequential loop and within ``tests/test_torch_fusion.py``'s
port-against-reference criteria of the reference's; the data-parallel
metrics (``_step`` on given masks, ``train_step`` drawing them) within
rtol 2e-4, atol 2e-5 of the single-rank step; the data-parallel detector
steps against the port's single-rank step and the reference's
single-device ``train_step`` from the same weights within
``tests/test_torch_detector.py``'s ``TOL`` (1e-5; a loss above 10 within
1e-6 of its size, that file's focal-loss bound) and its
``_assert_params`` rule, and the reference's own ``data_parallel_step``
of a detector step on 8 virtual devices against its single-device step
by the same rule.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcmi_tpu.config import StereoConfig as RefStereoConfig
from pcmi_tpu.parallel import make_mesh as ref_make_mesh
from pcmi_tpu.parallel import sharded_disparity as ref_sharded_disparity
from pcmi_tpu.pipelines.streaming import StreamingDSM as RefDSM
from pcmi_tpu.pipelines.streaming import dsm_update as ref_dsm_update
from pcmi_tpu.models.training import data_parallel_step as ref_dp_step
from pcmi_tpu_torch import convert
from pcmi_tpu_torch.config import StereoConfig
from pcmi_tpu_torch.ops.stereo.matching import (
    compute_disparity, refine_disparity)
from pcmi_tpu_torch.pipelines.height_map import pair_core
from pcmi_tpu_torch.pipelines.streaming import (
    dsm_finalize, dsm_update, empty_dsm)

from test_torch_detector import (
    SMALL, TOL, _assert_params, _params, _trainers)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_parallel_worker.py")
WORLD = 4
TIMEOUT_S = 120
CFG = dict(max_disp=16, block_size=5, census_window=5, gf_radius=4,
           speckle_median_size=5)
# data-parallel detector steps on the 4 x 1 mesh, one 48 px image per
# rank: the synthetic scenes, and the same cut to two valid boxes (fewer
# positive centres than ranks) and to none
DET_CASES = ("plain", "obb", "plain_two", "plain_none", "obb_two",
             "obb_none")


def _stereo_stack(h=128, w=160, b=2):
    """``tests/test_parallel.py``'s textured pairs at 128 rows."""
    rng = np.random.default_rng(5)
    lefts, rights = [], []
    for k in range(b):
        tex = rng.uniform(0, 1, (h, w + 32)).astype(np.float32)
        for ax in (0, 1):
            tex = (0.5 * tex + 0.25 * np.roll(tex, 1, ax)
                   + 0.25 * np.roll(tex, -1, ax))
        disp = np.full((h, w), 2.0 + k, np.float32)
        disp[40:80, 50:120] = 6.0
        left = tex[:, 16:16 + w]
        xs = np.arange(w)[None, :] + disp + 16
        x0 = np.floor(xs).astype(int)
        t = xs - x0
        right = (tex[np.arange(h)[:, None], np.clip(x0, 0, w + 31)] * (1 - t)
                 + tex[np.arange(h)[:, None], np.clip(x0 + 1, 0, w + 31)] * t)
        lefts.append(left)
        rights.append(right.astype(np.float32))
    return np.stack(lefts), np.stack(rights)


def _det_batch(case):
    """The case's batch of four 48 px scenes of its kind (the port's
    synthetic ones, whose renderers ``test_torch_detector.py`` holds to
    the reference's); ``_two`` keeps one valid box in images 0 and 2,
    ``_none`` none."""
    from pcmi_tpu_torch.models import detector as td

    obb = case.startswith("obb")
    gen = torch.Generator().manual_seed(40 + obb)
    batch = (td.synthesize_obb_batch(gen, 4, 48, hard=True, device="cpu")
             if obb else td.synthesize_detection_batch(gen, 4, 48,
                                                       device="cpu"))
    x, t, v = (a.numpy() for a in batch)
    if case.endswith(("_two", "_none")):
        v = np.zeros_like(v)
        v[[0, 2], 0] = case.endswith("_two")
    return x, t, v


def _det_weights(ref, port):
    """The reference head's starting parameters (seeded draws in its tree)
    and the port's state dict of them."""
    params = _params(ref.model, np.zeros((1, 48, 48, 1), np.float32), 7)
    return params, convert.centernet_state_dict(params, port.model)


def _inputs():
    rng = np.random.default_rng(0)
    lefts, rights = _stereo_stack()
    n_blocks, n_pts = 8, 4096
    xy = rng.uniform(-4.0, 68.0, (n_blocks, n_pts, 2)).astype(np.float32)
    values = rng.normal(20.0, 5.0, (n_blocks, n_pts)).astype(np.float32)
    blunder = rng.uniform(size=(n_blocks, n_pts)) < 0.03
    values = np.where(blunder, values + rng.normal(0, 60.0, values.shape),
                      values).astype(np.float32)
    weights = (rng.uniform(size=(n_blocks, n_pts)) > 0.1).astype(np.float32)
    masks = np.zeros((8, 32, 32, 1), np.float32)
    for i in range(8):
        y, x = rng.integers(4, 20, 2)
        hh, ww = rng.integers(4, 12, 2)
        masks[i, y:y + hh, x:x + ww] = 1.0
    tiny = np.zeros((4, 32, 32, 1), np.float32)
    tiny[1, 16, 16] = 1.0   # one hole pixel: 3 values for 4 ranks
    det = {}
    for obb in (False, True):
        _, sd = _det_weights(*_trainers(obb))
        kind = "obb" if obb else "plain"
        det.update({f"det_{kind}_w_{k}": v.numpy() for k, v in sd.items()})
    for case in DET_CASES:
        det.update(zip((f"det_{case}_{a}" for a in "xtv"), _det_batch(case)))
    return dict(
        halo_x=np.arange(16 * 16, dtype=np.float32).reshape(16, 16),
        rows_x=rng.normal(size=(2, 24, 10)).astype(np.float32),
        lefts=lefts, rights=rights,
        tri_M=np.tile(np.eye(3, 4, dtype=np.float32)[None], (2, 1, 1)),
        tri_b=np.zeros((2, 4), np.float32),
        dsm_xy=xy, dsm_values=values, dsm_weights=weights,
        gan_images=rng.uniform(0, 1, (8, 32, 32, 3)).astype(np.float32),
        gan_masks=masks, tiny_masks=tiny, **det)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the 4-rank world once: (inputs, rank 0's results, every rank's
    checks)."""
    tmp = tmp_path_factory.mktemp("torch_parallel")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
               LOCAL_WORLD_SIZE="2", OMP_NUM_THREADS="1")
    url = "file://" + str(tmp / "store")
    procs = [subprocess.Popen(
        [sys.executable, "-u", WORKER, str(r), str(WORLD), url,
         str(tmp / "inputs.npz"), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    deadline = time.monotonic() + TIMEOUT_S
    logs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(
                    timeout=max(deadline - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                out = f"the world ran past {TIMEOUT_S} s"
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, logs)):
        if p.returncode != 0 or f"RANK{r} OK" not in out:
            pytest.fail(f"rank {r} failed:\n{out[-4000:]}")
    with np.load(tmp / "results.npz") as z:
        res = {k: z[k] for k in z.files}
    checks = [json.loads((tmp / f"rank{r}.json").read_text())
              for r in range(WORLD)]
    return inputs, res, checks


def test_workers_import_only_the_port(world):
    _, _, checks = world
    for c in checks:
        assert c["no_reference"] == []
        assert c["no_launcher"] is True


def test_initialize_without_launcher_is_a_no_op(monkeypatch):
    import torch.distributed as dist

    from pcmi_tpu_torch.parallel import initialize_multihost

    for k in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_multihost() is False
    assert not dist.is_initialized()


def test_mesh_shape_and_errors(world):
    _, _, checks = world
    for c in checks:
        assert c["mesh"] == [["data", "tile"], [2, 2]]
        assert c["mesh_(3, None)"] == "ValueError"   # 4 not divisible by 3
        assert c["mesh_(3, 2)"] == "ValueError"      # needs 6 devices


def test_halo_rows_match_slices(world):
    inputs, res, checks = world
    xn = inputs["halo_x"]
    out = res["halo"]   # 2 bands of 8 rows, each became 2 + 8 + 2
    for band in range(2):
        got = out[band * 12:(band + 1) * 12]
        top = xn[band * 8 - 2: band * 8] if band else np.zeros((2, 16))
        bot = xn[(band + 1) * 8:(band + 1) * 8 + 2] if band == 0 \
            else np.zeros((2, 16))
        np.testing.assert_array_equal(
            got, np.concatenate([top, xn[band * 8:(band + 1) * 8], bot]))
    for c in checks:
        assert c["halo_too_big"] == "ValueError"
        assert c["halo_zero_same"] is True


def test_rows_map_matches_whole_array(world):
    inputs, res, _ = world
    x = inputs["rows_x"]
    p = np.pad(x, ((0, 0), (2, 2), (0, 0)))
    want = sum(p[:, i:i + x.shape[1]] for i in range(5))
    # the halo's zeros at the canvas edges are the whole array's padding
    np.testing.assert_allclose(res["rows_map"], want, atol=1e-5, rtol=0)


def _port_single(lefts, rights):
    cfg = StereoConfig(**CFG)
    out = []
    for left, right in zip(lefts, rights):
        lt, rt = torch.from_numpy(left), torch.from_numpy(right)
        v = torch.ones(left.shape, dtype=torch.bool)
        res = refine_disparity(compute_disparity(lt, rt, v, v, cfg, "sgm"),
                               lt, cfg)
        out.append(res.disparity.numpy())
    return np.stack(out)


def test_sharded_disparity_matches_reference_mesh(world):
    """Against the reference's ``sharded_disparity`` on a 2 x 2 mesh of
    its virtual devices, and the reference's own interior check against
    the single-device matcher."""
    inputs, res, _ = world
    lefts, rights = inputs["lefts"], inputs["rights"]
    b, h, w = lefts.shape
    mesh = ref_make_mesh(data=2, tile=2, devices=jax.devices()[:4])
    valid = jnp.ones((b, h, w), bool)
    d_ref, v_ref = ref_sharded_disparity(mesh, RefStereoConfig(**CFG))(
        jnp.asarray(lefts), jnp.asarray(rights), valid, valid)
    d_ref, v_ref = np.asarray(d_ref), np.asarray(v_ref)
    got, ok = res["sd_disp"], res["sd_valid"]
    assert got.shape == (b, h, w)
    assert (ok == v_ref).mean() >= 0.999
    both = ok & v_ref
    assert (np.abs(got - d_ref)[both] <= 1e-3).mean() >= 0.999
    single = _port_single(lefts, rights)
    interior = slice(16, h - 16)
    close = np.abs(got[:, interior] - single[:, interior]) <= 0.51
    assert close.mean() > 0.98


def test_batched_pair_step_equals_pair_core(world):
    inputs, res, _ = world
    cfg = StereoConfig(**CFG)
    for k in range(2):
        out = pair_core(torch.from_numpy(inputs["lefts"][k]),
                        torch.from_numpy(inputs["rights"][k]),
                        torch.from_numpy(inputs["tri_M"][k]),
                        torch.from_numpy(inputs["tri_b"][k]), cfg)
        np.testing.assert_array_equal(res["bp_disp"][k], out.disparity.numpy())
        np.testing.assert_array_equal(res["bp_valid"][k], out.valid.numpy())
        np.testing.assert_array_equal(res["bp_height"][k], out.height.numpy())
    hn, vn = res["bp_height"], res["bp_valid"]
    assert np.isnan(hn[~vn]).all()


@pytest.mark.parametrize("sigma", [0, 3])
def test_sharded_dsm_matches_both_sequential(world, sigma):
    """Within ``test_fusion_sharded.py``'s tolerances of the port's
    sequential loop. The reference's loop sums each block in float32 and
    its gate runs on that rounding (an inherited fault: the port sums in
    float64), so against it the criteria are ``test_torch_fusion.py``'s
    for ``dsm_update``: without the gate, within the reference's block-sum
    error (3e-7 of each payload's absolute total, + 1e-3); with it, the
    kept weight within 10 % and the DSMs' median gap below 0.1 m on the
    cells both fill."""
    inputs, res, checks = world
    xy, values, weights = (inputs[k] for k in
                           ("dsm_xy", "dsm_values", "dsm_weights"))
    shape = (64, 64)
    ref = RefDSM(wsum=jnp.zeros(shape), vsum=jnp.zeros(shape),
                 vsq=jnp.zeros(shape))
    port = empty_dsm(shape, "cpu")
    for k in range(len(xy)):
        ref = ref_dsm_update(ref, jnp.asarray(xy[k]), jnp.asarray(values[k]),
                             jnp.asarray(weights[k]), (0.0, 0.0), 1.0, shape,
                             robust_sigma=float(sigma))
        port = dsm_update(port, torch.from_numpy(xy[k]),
                          torch.from_numpy(values[k]),
                          torch.from_numpy(weights[k]), (0.0, 0.0), 1.0,
                          shape, robust_sigma=float(sigma))
    names = ("wsum", "vsum", "vsq")
    got = {k: res[f"dsm{sigma}_{k}"] for k in names}
    seq = {k: v.numpy() for k, v in port._asdict().items()}
    np.testing.assert_allclose(got["wsum"], seq["wsum"], atol=1e-4)
    np.testing.assert_allclose(got["vsum"], seq["vsum"], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got["vsq"], seq["vsq"], rtol=1e-5, atol=5e-2)
    dsm, _ = dsm_finalize(type(port)(*(torch.from_numpy(got[k])
                                       for k in names)))
    np.testing.assert_allclose(dsm, dsm_finalize(port)[0], atol=1e-4,
                               equal_nan=True)
    ref_np = {k: np.asarray(v) for k, v in ref._asdict().items()}
    if sigma == 0:
        w = weights.astype(np.float64)
        totals = dict(wsum=w.sum(), vsum=np.abs(w * values).sum(),
                      vsq=(w * values.astype(np.float64) ** 2).sum())
        for k in names:
            np.testing.assert_allclose(got[k], ref_np[k], rtol=1e-4,
                                       atol=3e-7 * totals[k] + 1e-3)
    else:
        kept, ref_kept = got["wsum"].sum(), ref_np["wsum"].sum()
        assert abs(kept - ref_kept) <= 0.1 * ref_kept
        ref_dsm = ref_np["vsum"] / np.maximum(ref_np["wsum"], 1e-12)
        both = (ref_np["wsum"] > 0) & np.isfinite(dsm)
        assert both.sum() > 2000
        assert np.median(np.abs(dsm - ref_dsm)[both]) < 0.1
    for c in checks:
        assert c["blocks_7"] == "ValueError"


def _inpaint_trainer():
    from pcmi_tpu_torch.models.training import (
        InpaintGANTrainer, InpaintTrainConfig)
    from pcmi_tpu_torch.models.unet import InpaintUNet, PatchDiscriminator

    return InpaintGANTrainer(
        InpaintTrainConfig(compute_dtype="float32"),
        generator=InpaintUNet(widths=(8, 16, 32)),
        discriminator=PatchDiscriminator(widths=(8, 16, 32, 32)),
        device="cpu")


def _assert_inpaint_step(res, prefix, images, masks):
    """Rank 0's data-parallel ``_step`` (``prefix``) against the
    single-rank step on the whole batch."""
    trainer = _inpaint_trainer()
    state = trainer.init(None, torch.Generator().manual_seed(0))
    state, m = trainer._step(state, torch.from_numpy(images),
                             torch.from_numpy(masks))
    for k, v in m.items():
        np.testing.assert_allclose(float(res[prefix + k]), float(v),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    flat = torch.cat([p.detach().reshape(-1) for p in state.g.parameters()])
    # Adam moves a weight whose gradient rounding dominates by up to lr
    gap = np.abs(res[prefix + "g_params"] - flat.numpy())
    assert (gap <= 1e-5).mean() >= 0.99 and gap.max() <= 2 * 2e-4


def test_data_parallel_step_matches_single_rank(world):
    inputs, res, checks = world
    _assert_inpaint_step(res, "dp_", inputs["gan_images"],
                         inputs["gan_masks"])
    for c in checks:
        assert c["dp_params_equal"] is True


def test_data_parallel_tiny_hole_matches_whole_batch(world):
    """One hole pixel in a batch of four over the 4 x 1 mesh: its three
    values are fewer than the ranks. The whole batch's count, clamped at 1
    and split over the ranks, gives the whole batch's hole loss; the
    ranks' mean count clamped at 1 would give 3/4 of it."""
    inputs, res, checks = world
    assert inputs["tiny_masks"].sum() * 3 < WORLD
    _assert_inpaint_step(res, "tiny_", inputs["gan_images"][:4],
                         inputs["tiny_masks"])
    for c in checks:
        assert c["tiny_params_equal"] is True


def test_data_parallel_train_step_draws_whole_batch_masks(world):
    """``train_step`` under ``data_parallel_step``: each rank draws the
    whole batch's hole masks from the shared generator and keeps its
    shard's, so the metrics are the single-rank step's."""
    inputs, res, _ = world
    trainer = _inpaint_trainer()
    state = trainer.init(None, torch.Generator().manual_seed(0))
    _, m = trainer.train_step(state, inputs["gan_images"],
                              torch.Generator().manual_seed(3))
    for k, v in m.items():
        np.testing.assert_allclose(float(res["dpt_" + k]), float(v),
                                   rtol=2e-4, atol=2e-5, err_msg=k)


def _init_step():
    from pcmi_tpu_torch.models.training import InpaintGANTrainer

    return InpaintGANTrainer(device="cpu").init


@pytest.mark.parametrize("make", [_init_step,
                                  lambda: (lambda state, x: (state, {}))])
def test_data_parallel_step_refuses_other_steps(make):
    """Only the port's trainer steps are taken: another callable could
    skip ``apply_gradients`` and not average its gradients."""
    from pcmi_tpu_torch.models.training import data_parallel_step

    with pytest.raises(TypeError, match="data_parallel_step takes"):
        data_parallel_step(make(), None)


def _dp_detector(inputs, res, case):
    """The case's port head after rank 0's data-parallel step, its metrics
    and its batch."""
    kind = case.split("_")[0]
    _, port = _trainers(kind == "obb")
    net = port.model
    pre = f"det_{kind}_w_"
    net.load_state_dict({k[len(pre):]: torch.from_numpy(v)
                         for k, v in inputs.items() if k.startswith(pre)})
    start = {k: v.clone() for k, v in net.state_dict().items()}
    net.load_state_dict({k: torch.from_numpy(res[f"det_{case}_p_{k}"])
                         for k in start})
    metrics = {k[len(f"det_{case}_m_"):]: v for k, v in res.items()
               if k.startswith(f"det_{case}_m_")}
    batch = [inputs[f"det_{case}_{a}"] for a in "xtv"]
    return port, start, net, metrics, batch


def _assert_metrics(pm, rm):
    """Each loss within ``test_torch_detector.py``'s ``TOL``, or within
    1e-6 of its size where that is larger (that file's bound on the focal
    loss): a batch with few or no positive centres divides its heat loss,
    a float32 sum over every cell, by 1, and it reaches ~100."""
    assert set(pm) == set(rm)
    for k in rm:
        want = float(rm[k])
        assert abs(float(pm[k]) - want) <= max(TOL, 1e-6 * abs(want)), (
            k, float(pm[k]), want)


@pytest.mark.parametrize("case", DET_CASES)
def test_data_parallel_detector_matches_single_rank(world, case):
    """``data_parallel_step`` of a detector step on four ranks against the
    port's step on the whole batch, from the same weights: the metrics
    within ``TOL`` and the parameters by ``_assert_params``' rule."""
    inputs, res, checks = world
    port, start, got, metrics, batch = _dp_detector(inputs, res, case)
    if case.endswith(("_two", "_none")):
        assert batch[2].sum() < WORLD
    net = type(got)(SMALL, with_angle=got.with_angle)
    net.load_state_dict(start)
    net, _, m = port.train_step(net, port.optimizer(net), *batch)
    _assert_metrics(metrics, m)
    want = net.state_dict()
    close = total = 0
    for k, v in got.state_dict().items():
        d = np.abs(v.numpy() - want[k].numpy())
        assert d.max() <= 2 * 1e-3 + TOL, (k, float(d.max()))
        close += int((d <= TOL).sum())
        total += d.size
    assert close >= 0.999 * total, (total - close, total)
    for c in checks:
        assert c[f"det_{case}_params_equal"] is True


@pytest.fixture(scope="module")
def det_ref():
    """The reference's trainers and starting parameters per kind, kept
    for the module so that each jitted step compiles once."""
    out = {}
    for kind in ("plain", "obb"):
        ref, port = _trainers(kind == "obb")
        out[kind] = ref, _det_weights(ref, port)[0]
    return out


@pytest.mark.parametrize("case", DET_CASES)
def test_data_parallel_detector_matches_reference(world, det_ref, case):
    """The same data-parallel step against the reference's single-device
    ``train_step`` from the same weights (``test_torch_detector.py``'s
    tolerances)."""
    inputs, res, _ = world
    ref, params = det_ref[case.split("_")[0]]
    _, _, got, metrics, batch = _dp_detector(inputs, res, case)
    p, _, rm = ref.train_step(params, ref.tx.init(params),
                              *map(jnp.asarray, batch))
    _assert_metrics(metrics, rm)
    _assert_params(p, got, 1, 1e-3)


@pytest.mark.parametrize("case", ["plain", "obb_two"])
def test_reference_data_parallel_detector_step(det_ref, case):
    """The reference's own ``data_parallel_step`` takes a detector step
    on a data 4 x tile 2 mesh of its 8 virtual devices and equals its
    single-device step."""
    ref, params = det_ref[case.split("_")[0]]
    batch = [jnp.asarray(a) for a in _det_batch(case)]
    p1, _, m1 = ref.train_step(params, ref.tx.init(params), *batch)
    mesh = ref_make_mesh(data=4, tile=2, devices=jax.devices()[:8])
    p8, _, m8 = ref_dp_step(ref.train_step, mesh)(
        params, ref.tx.init(params), *batch)
    _assert_metrics(m8, m1)
    _, port = _trainers(case.startswith("obb"))
    net = port.model
    net.load_state_dict(convert.centernet_state_dict(p8, net))
    _assert_params(p1, net, 1, 1e-3)


def test_multihost_mesh_two_hosts(world):
    """Two hosts of two ranks: the reference's (dcn, data, tile) shape of
    two processes with two local devices each, a sum over the whole mesh
    counting every rank, and the reference's errors."""
    _, _, checks = world
    for r, c in enumerate(checks):
        names, shape, count, host = c["multihost"]
        assert names == ["dcn", "data", "tile"] and shape == [2, 1, 2]
        assert count == 4.0 and host == r // 2
        assert c["multihost_data2"] == [2, 2, 1]
        assert c["multihost_data3"] == "ValueError"
