"""continuations_per_kiter: the graph chunks' eager continuations
(``driver.GRAPH_STATS["continuations"]``: iterations whose bounded loops
overflowed in a replay and ran again eagerly) per 1000 iterations of the
whole window."""


def snapshot(port):
    return {"continuations": port.algorithms.driver.GRAPH_STATS[
        "continuations"]}


def read(ctx):
    n = ctx.counters["continuations_per_kiter"]["continuations"]
    return 1e3 * n / ctx.window.iterations
