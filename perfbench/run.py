#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload d288_pair.strict --seed 7 \
        --seconds 45 --trace 0

Run from the root of a checkout that holds ``BENCHMARK.json``, the
``perfbench`` folder and the program (``pcmi_tpu_torch``). The cell names
its configuration and traffic mix in ``BENCHMARK.json``; the harness
finds their files, the traffic's driver and the metrics' readers by those
names (see ``perfbench/README.md``). ``--trace 0`` prints the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a profiled
stretch of requests. The last line of standard output is one JSON object;
the last lines of standard error list each number compared with its
limit. The exit code is 0 only when a result was printed.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    sys.path.insert(0, root)
    from perfbench import harness

    return harness.main(args.workload, args.seed, args.seconds,
                        bool(args.trace), root, PROCESS_START)


if __name__ == "__main__":
    sys.exit(main())
