#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process.

    python3 portbench/readings.py --workload <cell> --seeds 11,12,... \\
        [--control-seeds 21,22,23] [--seconds 5]

For each seed of ``--seeds`` it runs the cell as ``run.py`` does (a
window of ``--seconds``) and, for each of ``--control-seeds``, with the
control in the program's place (the cell's reference in float32, the
precision below the configuration's: ``reference/<name>.py``'s
``Control``, one call after the warm one).  One JSON line per run:
``{"seed", "control", "correct", "checks"}``; the benchmark's own runs
never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

_T0 = time.perf_counter()
_ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(_ROOT))
    from portbench.core import registry, runner

    cell = registry.find_cell(args.workload)
    control = registry.load_module("reference", cell.mix["reference"])
    runs = [(int(s), False) for s in args.seeds.split(",") if s]
    runs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, is_control in runs:
        t = time.perf_counter()
        result, checks = runner.run(
            args.workload, seed, 0.0 if is_control else args.seconds,
            hooks=control.Control if is_control else None)
        print(json.dumps({
            "seed": seed, "control": is_control,
            "correct": result["correct"], "failed": result["failed"],
            "attempted": result["attempted"],
            "seconds": time.perf_counter() - t,
            "checks": {n: v for n, v, _ in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
