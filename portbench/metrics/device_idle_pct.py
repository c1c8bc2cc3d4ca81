"""device_idle_pct (``.dopt``, ``.bregman``, ``.30x10000``: the parts
move their cells' end-to-end metrics): 1 - device busy / the traced
span, in %, over the trace's own span (``core/trace.py``)."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
