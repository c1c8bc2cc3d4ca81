"""continuation_ms_per_kiter: ms of the graph chunks' eager continuations
(``graph.continuation`` spans: an iteration whose bounded loops
overflowed in a replay, run again in the loops' Python form) per 1000
iterations of the whole window (``core/spans.py``)."""

from portbench.core import spans


def snapshot(port):
    return spans.snapshot(port, "continuation_ms_per_kiter")


def read(ctx):
    got = spans.window(ctx, "continuation_ms_per_kiter")
    if got is None or not ctx.window.iterations:
        return None
    return 1e6 * spans.seconds(got, "graph.continuation") \
        / ctx.window.iterations
