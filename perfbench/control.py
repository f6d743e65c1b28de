#!/usr/bin/env python3
"""Readings of a cell's compared numbers, for setting and testing its limits
(not part of a benchmark run).

    python3 perfbench/control.py --workload d288_pair.strict \
        --seeds 11,12,13 --modes program,tf32,bfloat16 [--device cuda]

For each seed, the cell's driver makes the scene and the program's
objects; mode ``program`` runs one request of each of the driver's keys
through the program, the other modes put the reference in the program's
place, computed in a lower precision: ``tf32`` (matrix products in TF32;
the configurations state float32 with TF32 off) or ``bfloat16`` (cost
volumes stored in bfloat16, the program's own lower mode). Each set of
answers is compared with the reference in float32 exactly as a run
compares, and one JSON line per seed and mode gives every number beside
its limit.
"""

import argparse
import json
import os
import sys
import time


def readings(root, cell_name: str, seed: int, modes, device: str):
    """One dict per mode: the compared numbers, their limits, whether they
    hold, and the scene's truth lines."""
    from perfbench import harness

    cell = harness.Cell(harness.Path(root), cell_name)
    limits = cell.traffic["limits"]
    driver = harness.load_driver(cell).Driver(cell.config, cell.traffic,
                                              seed, device)
    refs: dict = {}
    for mode in modes:
        t0 = time.perf_counter()
        if mode == "program":
            driver.warm_up()
            answers = [driver.to_host(driver.request()["answer"])
                       for _ in driver.keys()]
            driver.release()
        else:
            answers = [(k, driver.reference(k, mode)) for k in driver.keys()]
        harness.synchronize(device)
        checks, notes = harness.check(driver, answers, refs=refs)
        yield {"workload": cell_name, "seed": seed, "mode": mode,
               "answers": len(answers), "seconds": time.perf_counter() - t0,
               "correct": harness.holds(checks, limits),
               "checks": {k: [v, limits[k]] for k, v in checks.items()},
               "truth": notes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program,tf32,bfloat16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    for seed in (int(s) for s in args.seeds.split(",")):
        for row in readings(os.getcwd(), args.workload, seed,
                            args.modes.split(","), args.device):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
