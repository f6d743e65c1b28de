"""The kNN outlier mask's time per traced request: the program's
``MultiDayFusion.stage_ms["knn_mask"]`` (host clock, the device
synchronised at the stage's end)."""


def read(run):
    ms = [r["stage_ms"]["knn_mask"] for r in run.requests
          if "knn_mask" in r.get("stage_ms", {})]
    return sum(ms) / len(ms) if ms else None
