"""simplex_mult_kernel_roofline: the least time of the multiplier
kernel's launches in the traced slice (``roofline/simplex_mult_kernel.py``
from n) over their device time by name, in %."""

from portbench.core.registry import load_module
from portbench.core.trace import device_seconds


def read(ctx):
    secs, launches = device_seconds(ctx.trace, "simplex_mult_kernel")
    if not launches:
        return None
    work = load_module("roofline", "simplex_mult_kernel")
    peaks = load_module("roofline", "peaks")
    nbytes, flops = work.solve_work(int(ctx.config["n"]))
    return 100.0 * launches * peaks.least_seconds(nbytes, flops) / secs
