"""Driver of a stream of single-pair height maps: the batch height-map job
over an AOI's pairs (``HeightMapPipeline.process_pair`` of the program).

Set-up makes the scene from the seed, builds every pair's geometry (as a
sweep caches it) and one stereo config over all of them, and warms up one
pass over the pairs. Each request is one pair, the images handed over as
host tensors; the pairs come in cycles, each cycle in an order drawn from
the seed. The answer kept for the check is the pair product (disparity,
validity, heights and points), recomputed by the reference from the same
images and RPCs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import harness, roofline, stack
from perfbench.scene import make_scene, truth_at


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from pcmi_tpu_torch import config as program_config
        from pcmi_tpu_torch.geometry.pairs import ImageMeta
        from pcmi_tpu_torch.geometry.rpc import RPCCamera
        from pcmi_tpu_torch.pipelines.height_map import HeightMapPipeline

        self.config, self.device = config, device
        t0 = time.perf_counter()
        self.scene = make_scene(config["scene"], seed, device)
        self.scene_s = time.perf_counter() - t0
        self.pairs = self.scene.pairs()
        rpcs, _ = stack.side_inputs(self.scene, RPCCamera, ImageMeta)
        cfg = stack.pipeline_config(program_config, config["pipeline"])
        self.pipe = HeightMapPipeline(cfg, device=device)
        sc = self.scene
        self.geoms = [self.pipe.build_geometry(
            rpcs[i], rpcs[j], sc.lon_range, sc.lat_range,
            tuple(sc.images[i].shape), tuple(sc.images[j].shape))
            for i, j in self.pairs]
        self.stereo_cfg = self.pipe.stereo_cfg_for(self.geoms)
        planes = len(range(0, self.stereo_cfg.max_disp,
                           self.stereo_cfg.disp_stride))
        self.shapes = [(planes, *g.out_shape) for g in self.geoms]
        self.least_s = [roofline.pair_least_seconds(s, self.stereo_cfg)
                        for s in self.shapes]
        self.order = np.random.default_rng([seed, 1])
        self.queue: list = []
        self._ref = None

    def _pair(self, k: int):
        i, j = self.pairs[k]
        return self.pipe.process_pair(self.scene.images[i],
                                      self.scene.images[j], self.geoms[k],
                                      self.stereo_cfg)

    def keys(self) -> list:
        """The keys of the distinct requests: the pairs' indices."""
        return list(range(len(self.pairs)))

    def warm_up(self) -> None:
        for k in self.keys():
            self._pair(k)

    def request(self) -> dict:
        if not self.queue:
            self.queue = list(self.order.permutation(len(self.pairs)))
        k = int(self.queue.pop(0))
        prod = self._pair(k)
        return {"units": 1, "info": {"pair": k, "shape": self.shapes[k],
                                     "least_s": self.least_s[k]},
                "answer": (k, prod)}

    @staticmethod
    def to_host(answer):
        k, prod = answer
        return k, {"disparity": prod.disparity.cpu().numpy(),
                   "valid": prod.valid.cpu().numpy(),
                   "xyz": prod.xyz.cpu().numpy(),
                   "observable": ((prod.rect_left >= 0)
                                  & (prod.rect_right >= 0)).cpu().numpy()}

    def release(self) -> None:
        del self.pipe, self.geoms

    # -- the reference ----------------------------------------------------

    def reference(self, k: int, mode: str = "float32") -> dict:
        """Pair ``k`` computed by the reference from the raw inputs, in
        ``mode``: ``"float32"`` (as the configuration states), ``"tf32"``
        (matrix products in TF32) or ``"bfloat16"`` (cost volumes stored
        in bfloat16)."""
        import dataclasses

        from perfbench.reference import config as ref_config
        from perfbench.reference.geometry.pairs import ImageMeta
        from perfbench.reference.geometry.rpc import RPCCamera
        from perfbench.reference.pipelines import height_map as hm

        sc = self.scene
        if self._ref is None:
            cfg = stack.pipeline_config(ref_config, self.config["pipeline"])
            rpcs, _ = stack.side_inputs(sc, RPCCamera, ImageMeta)
            geoms = [hm.build_geometry(
                cfg, rpcs[i], rpcs[j], sc.lon_range, sc.lat_range,
                tuple(sc.images[i].shape), tuple(sc.images[j].shape))
                for i, j in self.pairs]
            self._ref = (cfg, geoms, hm.stereo_cfg_for(cfg, geoms))
        cfg, geoms, scfg = self._ref
        if mode == "bfloat16":
            scfg = dataclasses.replace(scfg, cost_dtype="bfloat16")
        i, j = self.pairs[k]
        with torch.no_grad(), harness.precision(
                "tf32" if mode == "tf32" else "float32"):
            prod = hm.process_pair(cfg, sc.images[i], sc.images[j], geoms[k],
                                   scfg, self.device)
        out = self.to_host((k, prod))[1]
        del prod
        return out

    @staticmethod
    def compare(got: dict, ref: dict) -> dict:
        both = got["valid"] & ref["valid"] if (
            got["valid"].shape == ref["valid"].shape) else None
        return {
            "valid_mismatch": stack.mismatch_share(got["valid"], ref["valid"]),
            "disp_gap_px": stack.max_gap(got["disparity"], ref["disparity"],
                                         both),
            "xyz_gap_m": stack.max_gap(got["xyz"], ref["xyz"], both),
        }

    def truth(self, k: int, got: dict) -> str:
        valid = got["valid"]
        t, inb = truth_at(self.scene, got["xyz"])
        m = valid & inb
        rmse = float(np.sqrt(np.mean((got["xyz"][..., 2][m] - t[m]) ** 2))) \
            if m.any() else float("nan")
        share = float(valid.sum() / max(got["observable"].sum(), 1))
        return (f"truth pair {self.pairs[k]}: height rmse {rmse!r} m "
                f"(<= 1.0), valid share {share!r} (>= 0.5)")
