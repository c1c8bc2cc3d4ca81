"""iter_ms: the whole window over every iteration completed in it."""

from portbench.core.window import iteration_ms


def read(ctx):
    return iteration_ms(ctx.window)
