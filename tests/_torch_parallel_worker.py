"""One rank of the gloo world of ``tests/test_torch_parallel.py``.

    python tests/_torch_parallel_worker.py RANK WORLD INIT_URL INPUTS OUT

Imports only the port. Starts the world through
``parallel.initialize_multihost`` (a ``file://`` store), builds the 2 x 2
(data, tile) mesh and the 4 x 1 one (the data-parallel steps with one
image per rank) and runs every case of the layer on the inputs the test
wrote (``INPUTS``, an npz), each on the calling rank's blocks; rank 0
writes the gathered results to ``OUT/results.npz`` and every rank its
checks to ``OUT/rank<r>.json``.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist


def main() -> None:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    url, inputs, out_dir = sys.argv[3], sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)

    from torch.distributed.tensor import Replicate, Shard

    from pcmi_tpu_torch.config import StereoConfig
    from pcmi_tpu_torch.models.detector import (
        CenterNetHead, DetectorTrainer, OBBDetectorTrainer)
    from pcmi_tpu_torch.models.training import (
        InpaintGANTrainer, InpaintTrainConfig, data_parallel_step)
    from pcmi_tpu_torch.models.unet import InpaintUNet, PatchDiscriminator
    from pcmi_tpu_torch.parallel import (
        DCN_AXIS, batched_pair_step, halo_exchange_rows,
        initialize_multihost, make_mesh, make_multihost_mesh, pair_sharding,
        sharded_dsm_update, sharded_rows_map, sharded_disparity)
    from pcmi_tpu_torch.parallel.mesh import gather, place, shard_blocks

    checks = {"no_launcher": initialize_multihost(device_type="cpu") is False}
    assert initialize_multihost(url, world, rank, device_type="cpu")
    z = {k: torch.from_numpy(v) for k, v in np.load(inputs).items()}
    res = {}

    def same_on_every_rank(params) -> bool:
        flat = torch.cat([p.detach().reshape(-1) for p in params])
        every = [torch.empty_like(flat) for _ in range(world)]
        dist.all_gather(every, flat)
        return all(torch.equal(e, flat) for e in every)

    mesh = make_mesh(2, 2, device_type="cpu")
    checks["mesh"] = [list(mesh.mesh_dim_names), list(mesh.shape)]
    for bad in ((3, None), (3, 2)):
        try:
            make_mesh(*bad, device_type="cpu")
            checks[f"mesh_{bad}"] = "no error"
        except ValueError:
            checks[f"mesh_{bad}"] = "ValueError"
    rows = (Replicate(), Shard(0))

    # halo exchange: each tile band of (16, 16) gets 2 rows a side
    x = z["halo_x"]
    band = place(x, mesh, rows)
    ext = halo_exchange_rows(band, 2, mesh)
    res["halo"] = gather(ext, mesh, rows)
    try:
        halo_exchange_rows(band, band.shape[0] + 1, mesh)
        checks["halo_too_big"] = "no error"
    except ValueError:
        checks["halo_too_big"] = "ValueError"
    checks["halo_zero_same"] = halo_exchange_rows(band, 0, mesh) is band

    # a 5-row running sum through sharded_rows_map (stacks over data)
    def rowsum(a):
        p = torch.nn.functional.pad(a[None, None], (0, 0, 2, 2))[0, 0]
        return sum(p[i:i + a.shape[0]] for i in range(5))

    stack = z["rows_x"]
    fn = sharded_rows_map(rowsum, mesh, 2)
    res["rows_map"] = gather(fn(place(stack, mesh, pair_sharding(mesh))),
                             mesh, pair_sharding(mesh))

    # the sharded matchers
    cfg = StereoConfig(max_disp=16, block_size=5, census_window=5,
                       gf_radius=4, speckle_median_size=5)
    ps = pair_sharding(mesh)
    lefts, rights = z["lefts"], z["rights"]
    valid = torch.ones(lefts.shape, dtype=torch.bool)
    disp, ok = sharded_disparity(mesh, cfg)(
        *(place(a, mesh, ps) for a in (lefts, rights, valid, valid)))
    res["sd_disp"], res["sd_valid"] = (gather(a, mesh, ps) for a in (disp, ok))
    rects = torch.stack([lefts, rights], 1)
    step = batched_pair_step(mesh, cfg)
    outs = step(place(rects, mesh, (Shard(0), Shard(2))),
                place(z["tri_M"], mesh, (Shard(0), Replicate())),
                place(z["tri_b"], mesh, (Shard(0), Replicate())))
    for name, a in zip(("disp", "valid", "height"), outs):
        res["bp_" + name] = gather(a, mesh, ps)

    # sharded DSM fusion, robust sigma 0 and 3
    for sigma in (0.0, 3.0):
        fuse = sharded_dsm_update(mesh, (0.0, 0.0), 1.0, (64, 64),
                                  robust_sigma=sigma)
        acc = fuse(*(shard_blocks(z[k], mesh)
                     for k in ("dsm_xy", "dsm_values", "dsm_weights")))
        for k, v in acc._asdict().items():
            res[f"dsm{int(sigma)}_{k}"] = v
    try:
        shard_blocks(z["dsm_values"][:7], mesh)
        checks["blocks_7"] = "no error"
    except ValueError:
        checks["blocks_7"] = "ValueError"

    # one data-parallel inpainting GAN step, from the same state on every
    # rank, on the shard of the data axis
    trainer = InpaintGANTrainer(
        InpaintTrainConfig(compute_dtype="float32"),
        generator=InpaintUNet(widths=(8, 16, 32)),
        discriminator=PatchDiscriminator(widths=(8, 16, 32, 32)),
        device="cpu")
    state = trainer.init(None, torch.Generator().manual_seed(0))
    dp = data_parallel_step(trainer._step, mesh)
    state, metrics = dp(state, z["gan_images"], z["gan_masks"])
    res.update({"dp_" + k: v for k, v in metrics.items()})
    checks["dp_params_equal"] = same_on_every_rank(state.g.parameters())
    res["dp_g_params"] = torch.cat([p.detach().reshape(-1)
                                    for p in state.g.parameters()])
    # a batch of four with one hole pixel, one image per rank of the 4 x 1
    # mesh: fewer hole values than ranks
    mesh4 = make_mesh(4, 1, device_type="cpu")
    state = trainer.init(None, torch.Generator().manual_seed(0))
    state, metrics = data_parallel_step(trainer._step, mesh4)(
        state, z["gan_images"][:4], z["tiny_masks"])
    res.update({"tiny_" + k: v for k, v in metrics.items()})
    checks["tiny_params_equal"] = same_on_every_rank(state.g.parameters())
    res["tiny_g_params"] = torch.cat([p.detach().reshape(-1)
                                      for p in state.g.parameters()])
    # one data-parallel detector step per case on the 4 x 1 mesh, from the
    # reference head's weights the test wrote
    cases = [k[4:-2] for k in sorted(z) if k.startswith("det_")
             and k.endswith("_x")]
    for case in cases:
        kind = case.split("_")[0]
        pre = f"det_{kind}_w_"
        net = CenterNetHead((8, 16, 32), with_angle=kind == "obb")
        net.load_state_dict({k[len(pre):]: v for k, v in z.items()
                             if k.startswith(pre)})
        trainer_cls = OBBDetectorTrainer if kind == "obb" else DetectorTrainer
        det = trainer_cls(model=net, device="cpu")
        net, _, metrics = data_parallel_step(det.train_step, mesh4)(
            net, det.optimizer(net),
            *(z[f"det_{case}_{a}"] for a in "xtv"))
        res.update({f"det_{case}_m_{k}": v for k, v in metrics.items()})
        res.update({f"det_{case}_p_{k}": v
                    for k, v in net.state_dict().items()})
        checks[f"det_{case}_params_equal"] = same_on_every_rank(
            net.parameters())
    # train_step draws the hole masks: the whole batch's on every rank
    state = trainer.init(None, torch.Generator().manual_seed(0))
    _, metrics = data_parallel_step(trainer.train_step, mesh)(
        state, z["gan_images"], torch.Generator().manual_seed(3))
    res.update({"dpt_" + k: v for k, v in metrics.items()})

    # the multi-host mesh: two hosts of two ranks (LOCAL_WORLD_SIZE=2)
    mh = make_multihost_mesh(data=1, tile=2, device_type="cpu")
    count = torch.ones(1)
    from pcmi_tpu_torch.parallel.mesh import all_reduce_mesh

    all_reduce_mesh(count, mh)
    checks["multihost"] = [list(mh.mesh_dim_names), list(mh.shape),
                           float(count), mh.get_local_rank(DCN_AXIS)]
    checks["multihost_data2"] = list(make_multihost_mesh(
        data=2, device_type="cpu").shape)
    try:
        make_multihost_mesh(data=3, device_type="cpu")
        checks["multihost_data3"] = "no error"
    except ValueError:
        checks["multihost_data3"] = "ValueError"

    checks["no_reference"] = sorted(
        m for m in sys.modules
        if m == "jax" or m == "pcmi_tpu" or m.startswith(("jax.",
                                                          "pcmi_tpu.")))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(checks, f)
    if rank == 0:
        np.savez(os.path.join(out_dir, "results.npz"),
                 **{k: v.numpy() for k, v in res.items()})
    dist.barrier()
    dist.destroy_process_group()
    print(f"RANK{rank} OK", flush=True)


if __name__ == "__main__":
    main()
