"""frozen_blocks_per_solve (``.dopt``, ``.30x10000``): the lazy engines'
blocks launched past the stop (``ops/dopt_lazy.FROZEN_BLOCKS``: enqueued
in a group, no instance recorded a row) per instance solved, the whole
window: the group's launches that did no work."""


def snapshot(port):
    lazy = getattr(getattr(port, "ops", None), "dopt_lazy", None)
    if not hasattr(lazy, "FROZEN_BLOCKS"):
        return {}
    return {"frozen": lazy.FROZEN_BLOCKS}


def read(ctx):
    for name, got in ctx.counters.items():
        if name.startswith("frozen_blocks_per_solve") and "frozen" in got:
            return got["frozen"] / ctx.window.instances
    return None
