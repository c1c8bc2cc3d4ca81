"""The work of ``dopt_lazy_kernel`` (``csrc/dopt_lazy.cu``), from the
shapes and the iterations each instance ran in a launch block.

A block of ``nrun`` iterations of one instance reads V^T (m n), H0 (m^2),
x and w once and writes x, w, the run rows of C and beta, misc and the
hist rows once; iteration k of the block does 2 m n (u = g^T V) + 2 m^2
(H0 v) + 4 k m (C v and g) + 8 n (w, x, pivots) FP64 operations.  An
instance that runs no iteration in a launch (it entered stopped) is
counted as no work."""

KR = 256  # iterations per launch block


def block_work(m, n, nrun_each):
    """``(bytes, flops)`` of one launch: ``nrun_each`` the iterations each
    instance ran in it."""
    nbytes = flops = 0
    for nrun in nrun_each:
        if nrun <= 0:
            continue
        nbytes += 8 * (m * n + m * m + 4 * n + nrun * (m + 1) + 4 + 5 * KR)
        flops += nrun * (2 * m * n + 2 * m * m + 8 * n) \
            + 4 * m * nrun * (nrun - 1) // 2
    return nbytes, flops


def solve_work(m, n, updates):
    """``(bytes, flops)`` of the blocks of one call: ``updates`` the
    iterations with an update each instance ran (its rows less the stop
    row), split into blocks of ``KR``."""
    nbytes = flops = 0
    blocks = max([-(-u // KR) for u in updates] + [0])
    for b in range(blocks):
        nb, fl = block_work(m, n, [min(KR, max(0, u - b * KR))
                                   for u in updates])
        nbytes += nb
        flops += fl
    return nbytes, flops
