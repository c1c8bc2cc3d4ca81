"""continuations_per_kiter.fw (and ``.fastgram``, which loads this file):
the graph chunks' eager continuations (``driver.GRAPH_STATS
["continuations"]``) per 1000 iterations of the whole window, read under
the part's own name."""


def snapshot(port):
    return {"continuations": port.algorithms.driver.GRAPH_STATS[
        "continuations"]}


def read(ctx):
    for name, got in ctx.counters.items():
        if name.startswith("continuations_per_kiter") and \
                "continuations" in got:
            return 1e3 * got["continuations"] / ctx.window.iterations
    return None
