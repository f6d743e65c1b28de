"""Driver of whole-AOI multi-day fusion requests: the ``fuse`` command's
call (``MultiDayFusion.run``) from images, RPCs and acquisition metadata
to the fused DSM, the filtered cloud and its K-means centroids.

Set-up makes the scene from the seed and warms up one whole request (the
kNN's shapes depend on the data). Each request is one whole run over the
AOI, in a closed loop. The answer kept for the check is the fused DSM,
the cloud's weights after the kNN mask, the ICP residuals and the
centroids, recomputed by the reference from the same inputs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import harness, stack
from perfbench.scene import dsm_truth, make_scene


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from pcmi_tpu_torch import config as program_config
        from pcmi_tpu_torch.geometry.pairs import ImageMeta
        from pcmi_tpu_torch.geometry.rpc import RPCCamera
        from pcmi_tpu_torch.pipelines.multiday import MultiDayFusion

        self.config, self.traffic, self.device = config, traffic, device
        t0 = time.perf_counter()
        self.scene = make_scene(config["scene"], seed, device)
        self.scene_s = time.perf_counter() - t0
        self.rpcs, self.metas = stack.side_inputs(self.scene, RPCCamera,
                                                  ImageMeta)
        cfg = stack.pipeline_config(program_config, config["pipeline"])
        self.fusion = MultiDayFusion(cfg, device=device)
        self._ref = None

    def _run(self):
        sc, t = self.scene, self.traffic
        return self.fusion.run(
            sc.images, self.rpcs, self.metas, sc.lon_range, sc.lat_range,
            points_per_pair=t["points_per_pair"],
            with_kmeans=t["with_kmeans"], grid_cell=t["grid_cell"])

    @staticmethod
    def keys() -> list:
        """Every request is the same whole AOI: one key."""
        return [None]

    def warm_up(self) -> None:
        self._run()

    def request(self) -> dict:
        fused = self._run()
        return {"units": 1,
                "info": {"stage_ms": dict(self.fusion.stage_ms),
                         "pairs": int(fused.icp_rmse.shape[0])},
                "answer": (None, fused)}

    @staticmethod
    def to_host(answer):
        key, fused = answer
        return key, Driver._host(fused)

    @staticmethod
    def _host(fused) -> dict:
        def np_(x):
            return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

        return {"dsm": np_(fused.dsm), "origin": tuple(fused.grid_origin),
                "weights": np_(fused.weights), "icp_rmse": np_(fused.icp_rmse),
                "centroids": np_(fused.kmeans_centroids),
                "cell": float(fused.grid_cell)}

    def release(self) -> None:
        del self.fusion

    # -- the reference ----------------------------------------------------

    def reference(self, key=None, mode: str = "float32") -> dict:
        """The whole request (every request is the same: ``key`` is None)
        computed by the reference, in ``mode``
        (``"float32"``, ``"tf32"`` or ``"bfloat16"`` cost volumes)."""
        import dataclasses

        from perfbench.reference import config as ref_config
        from perfbench.reference.geometry.pairs import ImageMeta
        from perfbench.reference.geometry.rpc import RPCCamera
        from perfbench.reference.pipelines.multiday import fuse

        sc, t = self.scene, self.traffic
        cfg = stack.pipeline_config(ref_config, self.config["pipeline"])
        if mode == "bfloat16":
            cfg = cfg.replace(stereo=dataclasses.replace(
                cfg.stereo, cost_dtype="bfloat16"))
        rpcs, metas = stack.side_inputs(sc, RPCCamera, ImageMeta)
        with torch.no_grad(), harness.precision(
                "tf32" if mode == "tf32" else "float32"):
            fused = fuse(cfg, sc.images, rpcs, metas, sc.lon_range,
                         sc.lat_range, self.device,
                         points_per_pair=t["points_per_pair"],
                         with_kmeans=t["with_kmeans"],
                         grid_cell=t["grid_cell"])
            return self._host(fused)

    @staticmethod
    def compare(got: dict, ref: dict) -> dict:
        return {
            **stack.dsm_numbers(got, ref),
            "weight_mismatch": stack.mismatch_share(got["weights"] > 0,
                                                    ref["weights"] > 0),
            "icp_gap_m": stack.max_gap(got["icp_rmse"], ref["icp_rmse"]),
            "centroid_gap_m": stack.max_gap(got["centroids"],
                                            ref["centroids"]),
        }

    def truth(self, key, got: dict) -> str:
        return dsm_truth(self.scene, got, "fused DSM")
