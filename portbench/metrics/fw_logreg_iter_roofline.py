"""fw_logreg_iter_roofline: the least time of the FW iterations in the
traced slice (``roofline/fw_logreg.py``: X once an iteration, the
gradient's two products and each trial that did work, at 3.35 TB/s and 67
TFLOP/s FP64) over the slice's span, in %.  The slice is the mix's
recorded replays, each of the graph's span of iterations; the trials an
iteration are the first and the window's live masked bodies of the
shortest step's line search an iteration (``_loops.live_counts()``).
Against a port without that counter the metric is left out."""

from portbench.core.registry import load_module

LOOP = "FW shortest trials"


def snapshot(port):
    counts = getattr(getattr(port, "_loops", None), "live_counts", None)
    if counts is None:
        return {}
    return {"live": counts().get(LOOP, (0, 0))[0]}


def read(ctx):
    got = ctx.counters.get("fw_logreg_iter_roofline", {})
    graphs = getattr(ctx.port.algorithms.driver, "_GRAPHS", {})
    replays = ctx.mix["trace"].get("replays")
    if "live" not in got or not graphs or not replays \
            or not ctx.window.iterations:
        return None
    span = list(graphs.values())[-1].span
    iters = int(replays["record"]) * span
    trials = 1.0 + got["live"] / ctx.window.iterations
    work = load_module("roofline", "fw_logreg")
    peaks = load_module("roofline", "peaks")
    nbytes, flops = work.iter_work(int(ctx.config["m"]),
                                   int(ctx.config["n"]), trials)
    return 100.0 * iters * peaks.least_seconds(nbytes, flops) \
        / ctx.trace.window_s
