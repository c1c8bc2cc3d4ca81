"""setup_dev_ms (``.dopt``, ``.30x10000``): device time per call of the set-up's copies to the
card, Cholesky factorizations and triangular solves, in the traced slice:
the device operations named ``Memcpy HtoD``, cuSOLVER's Cholesky kernels
(``getrf_wo_pivot`` and ``xxtrf4_set_info_ker`` on an H100 with the
CUDA 12 cuSOLVER; ``potrf`` elsewhere) and cuBLAS's ``trsm``."""

PARTS = ("Memcpy HtoD", "potrf", "getrf_wo_pivot", "xxtrf4_set_info", "trsm")


def read(ctx):
    secs = sum((e - s) * 1e-6 for n, s, e in ctx.trace.kernels
               if any(p in n for p in PARTS))
    if not secs:
        return None
    return 1e3 * secs / len(ctx.traced_answers)
