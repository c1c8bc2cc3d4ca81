"""prox_launches_per_iter: the multiplier kernel's launches as the card
counts them (``ops/simplex.device_launches()``, a graph's masked trials
included) per iteration of the whole window: the trials run against the
one accepted."""


def snapshot(port):
    return {"launches": port.ops.simplex.device_launches()}


def read(ctx):
    n = ctx.counters["prox_launches_per_iter"]["launches"]
    return n / ctx.window.iterations if n else None
