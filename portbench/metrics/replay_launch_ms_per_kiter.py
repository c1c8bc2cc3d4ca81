"""replay_launch_ms_per_kiter: ms of the graph chunks' ``graph.replay``
spans (the host in a span's graph launch) per 1000 iterations of the
whole window (``core/spans.py``).  A graph of some 40k nodes fills the
launch queue, so its launch blocks while the card drains the queue: the
reading holds the card's time running the nodes as much as the host's,
and moves with the nodes' count and device time; the card idles through
little of it."""

from portbench.core import spans


def snapshot(port):
    return spans.snapshot(port, "replay_launch_ms_per_kiter")


def read(ctx):
    got = spans.window(ctx, "replay_launch_ms_per_kiter")
    if not got or not ctx.window.iterations:
        return None
    return 1e6 * spans.seconds(got, "graph.replay") / ctx.window.iterations
