"""ls_live_share (``.fw``, ``.fastgram``, ``.bregman``): the masked bodies
of the graph chunks' bounded loops that did work, over those run, in %,
over the whole window: ``_loops.live_counts()`` (the live bodies of the
iterations a chunk kept, counted on the card, and the bodies of the spans
launched), summed over the loops.  Against a port without the counter the
snapshots hold nothing, and the metric is left out."""


def snapshot(port):
    counts = getattr(getattr(port, "_loops", None), "live_counts", None)
    if counts is None:
        return {}
    pairs = counts().values()
    return {"live": sum(p[0] for p in pairs), "run": sum(p[1] for p in pairs)}


def read(ctx):
    for name, got in ctx.counters.items():
        if name.startswith("ls_live_share") and got.get("run"):
            return 100.0 * got["live"] / got["run"]
    return None
