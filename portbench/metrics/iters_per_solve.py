"""iters_per_solve (``.dopt``, ``.30x10000``): the rows the returned histories hold up to each
instance's stop, over the instances of the window (the solver's
iterations to its certificate)."""


def read(ctx):
    return ctx.window.iterations / ctx.window.instances
