"""host_serial_ms (``.dopt``, ``.30x10000``): ms per instance solved of
the block engines' host work done with no block in flight: the
``dopt.setup``, ``dopt.rows`` and ``dopt.refresh`` spans of each
``dopt.solve`` (the launch plan, the slots' buffers, the F rebuild, the
stop search, T), less the ``dopt.read`` spans inside them (the
factorizations' reads).  The card waits through all of it.  It leaves out
the blocks' enqueue (``dopt.block``), which the card paces while the
launch queue is full, and the group's read, so the kernel's time does not
enter it; the blocks launched past the stop are counted by
``frozen_blocks_per_solve``.  The whole window (``core/spans.py``)."""

from portbench.core import spans

SERIAL = ("dopt.setup", "dopt.rows", "dopt.refresh")


def snapshot(port):
    return spans.snapshot(port, "host_serial_ms")


def read(ctx):
    got = spans.window(ctx, "host_serial_ms")
    if not got or not ctx.window.instances:
        return None
    solves = {s[0] for s in got if s[3] == "dopt.solve"}
    names = {s[0]: s[3] for s in got}
    ns = 0
    for _, parent, solve, name, t0, t1, _ in got:
        if solve not in solves:
            continue
        if name in SERIAL and names.get(parent) not in SERIAL:
            ns += t1 - t0
        elif name == "dopt.read" and names.get(parent) in SERIAL:
            ns -= t1 - t0
    return 1e-6 * ns / ctx.window.instances
