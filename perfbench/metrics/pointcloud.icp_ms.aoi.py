"""ICP registration's time per traced request: the program's
``MultiDayFusion.stage_ms["icp"]`` (host clock, the device
synchronised at the stage's end)."""


def read(run):
    ms = [r["stage_ms"]["icp"] for r in run.requests
          if "icp" in r.get("stage_ms", {})]
    return sum(ms) / len(ms) if ms else None
