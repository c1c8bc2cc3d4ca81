"""call_p90_s: the 90th percentile of every call's wall in the window,
each call timed on the host from its start to its returned result."""

from portbench.core.window import call_p90_seconds


def read(ctx):
    return call_p90_seconds(ctx.window)
