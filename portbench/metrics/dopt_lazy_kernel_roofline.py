"""dopt_lazy_kernel_roofline: the least time of the lazy-H kernel's work
in the traced calls (``roofline/dopt_lazy_kernel.py``: inputs read once,
outputs written once, the operations of the iterations run; at 3.35 TB/s
and 67 TFLOP/s FP64, the tensor-core rate: the kernel issues no FP64 MMA)
over its device time by name, in %."""

from portbench.core.registry import load_module
from portbench.core.trace import device_seconds


def read(ctx):
    secs, launches = device_seconds(ctx.trace, "dopt_lazy_kernel")
    if not launches:
        return None
    work = load_module("roofline", "dopt_lazy_kernel")
    peaks = load_module("roofline", "peaks")
    m, n = int(ctx.config["m"]), int(ctx.config["n"])
    least = 0.0
    for a in ctx.traced_answers:
        nbytes, flops = work.solve_work(m, n, [max(0, int(r) - 1)
                                               for r in a.rows])
        least += peaks.least_seconds(nbytes, flops)
    return 100.0 * least / secs
