"""One run of one cell: set-up, the measured window, the traced slice,
the verdict and the result line.

The order of a run:

1. the card is checked (a run needs ``torch.cuda`` and the cell's chips);
2. set-up: the port is imported, the cell's instances are made on the
   device from the seed (``problems/<problem>.py``), and one warm call on
   instances outside the pool builds and loads every kernel and captures
   every graph the cell's calls use;
3. the window (``core/window.py``), with the per-layer metrics' program
   counters read before and after it in a traced run;
4. in a traced run, the bounded slice (``core/trace.py``): the mix's
   ``trace.calls`` calls after the window, whole or, with
   ``trace.replays``, the graph replays it names;
5. the peak of device memory is read, and the program's state freed;
6. the judge (``reference/<reference>.py``) compares every answer of the
   window and of the slice with the plain reference, each number against
   its limit (``limits/<cell>.json``);
7. no module of JAX or of the JAX package may be loaded;
8. the checks go to standard error, last, and the result line to standard
   output, last, its ``checks`` key last.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

from . import registry
from .trace import traced
from .window import run_window

# top-level module names the process must not hold (whole names: the port,
# ``accbpg_and_fw_tpu_torch``, begins with the JAX package's name)
FORBIDDEN = ("jax", "jaxlib", "flax", "accbpg_and_fw_tpu", "accbpg")


class BenchError(RuntimeError):
    """A run that cannot give a result: exit ``code`` 2 for no card or too
    few, 3 for a forbidden module."""

    def __init__(self, message, code=2):
        super().__init__(message)
        self.code = code


def forbidden_modules(modules=None):
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


class Context:
    """What the metric readers and the judge read: the cell, the pool, the
    window, the traced slice and the program counters' changes."""

    def __init__(self, cell, port, device, pool, seed):
        self.cell = cell
        self.seed = seed
        self.config = cell.config
        self.mix = cell.mix
        self.port = port
        self.device = device
        self.pool = pool
        self.window = None
        self.trace = None            # core.trace.Trace, traced runs only
        self.traced_answers = []
        self.counters = {}           # metric name -> {counter: change}

    def answers(self):
        return ([c.answer for c in self.window.calls]
                + list(self.traced_answers))


def _power_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run(cell_name, seed, seconds, trace=False, device="cuda", t0=None,
        spec_path=registry.SPEC, base=registry.BENCH_DIR, require_chips=True,
        hooks=None):
    """One run of the cell; returns ``(result, checks)``: the result line's
    object and the list of ``(name, value, limit)`` compared.  ``hooks``
    (the control and the fault tests) may replace the entry's calls:
    ``hooks(caller, cell, pool, device)`` returns the caller the run
    uses."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = registry.find_cell(cell_name, spec_path, base)
    import torch

    try:
        import accbpg_and_fw_tpu_torch as port
    except ImportError as e:
        raise BenchError(f"the port does not import: {e}") from e
    if registry.ROOT not in Path(port.__file__).resolve().parents:
        raise BenchError(f"the port was imported from {port.__file__}, not "
                         f"from the checkout at {registry.ROOT}")
    if require_chips:
        if not torch.cuda.is_available():
            raise BenchError("torch.cuda.is_available() is False: the "
                             "benchmark runs on a CUDA card")
        if torch.cuda.device_count() < cell.chips:
            raise BenchError(f"the cell needs {cell.chips} cards, "
                             f"{torch.cuda.device_count()} are visible")
    if trace and device != "cuda":
        raise BenchError("a traced run needs the card")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    problem = registry.load_module("problems", cell.config["problem"], base)
    entry = registry.load_module("entries", cell.mix["entry"], base)
    reference = registry.load_module("reference", cell.mix["reference"],
                                     base)
    K = int(cell.mix.get("batch", 1))
    P = int(cell.mix["pool"])
    if P % K:
        raise ValueError(f"pool {P} is not a multiple of the batch {K}")
    pool = problem.make(cell.config, P + K, seed, dev)
    ctx = Context(cell, port, dev, pool, seed)
    caller = entry.prepare(port, cell.config, cell.mix, pool, dev)
    if hooks is not None:
        caller = hooks(caller, cell, pool, dev)

    def instances_of(j):
        start = (j * K) % P
        return tuple(range(start, start + K))

    if hooks is None:
        # the warm call, on instances outside the pool
        caller.call(tuple(range(P, P + K)),
                    **cell.mix.get("warm", {}).get("kwargs", {}))
    sync()
    setup_s = time.perf_counter() - t0

    readers = {m["name"]: registry.load_module("metrics", m["name"], base)
               for m in (cell.per_layer if trace else [])}
    before = {name: r.snapshot(port) for name, r in readers.items()
              if hasattr(r, "snapshot")}
    ctx.window = run_window(caller.call, instances_of, seconds, sync)
    for name, snap in before.items():
        after = readers[name].snapshot(port)
        ctx.counters[name] = {k: after[k] - v for k, v in snap.items()}

    dev_info = {"platform": "gpu" if on_card else dev.type,
                "kind": (torch.cuda.get_device_name(dev) if on_card
                         else "cpu"),
                "count": cell.chips if on_card else 0}
    if trace:
        tr = cell.mix["trace"]
        first = len(ctx.window.calls)

        def slice_calls():
            out = []
            for i in range(int(tr["calls"])):
                out.append(caller.call(instances_of(first + i),
                                       **tr.get("kwargs", {})))
                sync()
            return out

        replays = tr.get("replays")
        ctx.traced_answers, ctx.trace = traced(
            slice_calls, replays and (replays["skip"], replays["record"]))
        dev_info["busy_s"] = ctx.trace.busy_s
        dev_info["window_s"] = ctx.trace.window_s
    if on_card:
        dev_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(
            dev))
        dev_info["power"] = _power_line()
    else:
        dev_info["memory_peak_bytes"] = 0

    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                value = setup_s
            else:
                value = registry.load_module("end_to_end", m["name"],
                                             base).read(ctx)
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the program's state is freed before the reference runs
    caller.close()
    del caller
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_judge = time.perf_counter()
    numbers, per_instance = reference.judge(ctx)
    print(f"portbench: the reference judged {len(per_instance)} answers in "
          f"{time.perf_counter() - t_judge:.1f} s", file=sys.stderr)
    missing = [name for name, _ in numbers if name not in cell.limits]
    if missing:
        raise KeyError(f"limits/{cell.name}.json has no limit for {missing}")
    checks = [(name, float(value), float(cell.limits[name]))
              for name, value in numbers]
    # NaN compares False: a number that is not a number fails
    correct = all(v <= lim for _, v, lim in checks)
    failed = sum(not all(v <= cell.limits[name] for name, v in p.items())
                 for p in per_instance)

    found = forbidden_modules()
    if found:
        raise BenchError(f"modules of JAX or the JAX package are loaded: "
                         f"{found}")

    result = {"correct": bool(correct),
              "attempted": ctx.window.instances + sum(
                  len(a.instances) for a in ctx.traced_answers),
              "failed": int(failed), "metrics": metrics, "device": dev_info}
    if trace:
        result["breakdown"] = {"device_ops": ctx.trace.device_ops,
                               "idle_gaps": ctx.trace.idle_gaps}
    # strict JSON has no NaN or infinity: such a reading goes as its name
    result["checks"] = {
        name: {"value": v if math.isfinite(v) else repr(v), "limit": lim}
        for name, v, lim in checks}
    return result, checks


def emit(result, checks, out=None, err=None):
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    out = out or sys.stdout
    err = err or sys.stderr
    for name, value, limit in checks:
        verdict = "ok" if value <= limit else "FAILED"
        print(f"check {name} {value!r} limit {limit!r} {verdict}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
