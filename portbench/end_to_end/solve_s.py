"""solve_s: the whole window over the instances solved in it (a sweep
call counts its K instances)."""

from portbench.core.window import solve_seconds


def read(ctx):
    return solve_seconds(ctx.window)
