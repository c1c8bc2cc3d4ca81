#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cells, configurations and metrics are
in ``BENCHMARK.json``; see ``portbench/README.md``.  The last line of
standard output is the result (JSON), the last lines of standard error
the numbers compared for ``correct``, each beside its limit.  Exits 2
without a result where there is no CUDA card, or too few for the cell,
and 3 where a module of JAX or of the JAX package got loaded.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parent.parent


def _cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's nvcc builds go to ``build/kernels`` by themselves)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(_ROOT / "build" / "portbench" / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    sys.path.insert(0, str(_ROOT))
    from portbench.core import runner

    try:
        result, checks = runner.run(args.workload, args.seed, args.seconds,
                                    trace=bool(args.trace), t0=_T0)
    except runner.BenchError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return e.code
    runner.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
