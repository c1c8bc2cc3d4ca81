"""The work of one iteration of the (L0,L1) Frank-Wolfe rules on the mean
logistic loss of X (m x n), whatever implements it.

Bytes: X read once (it fits the 50 MB L2, so a pass a trial is no floor),
y read once, the iterate read and written.  Operations: 2 m n for each of
the gradient's two products (X x and w X) and for each trial's value
(X x+), the trials those of the line search that did work (the first and
the live masked bodies after it; a masked body that did no work is not
counted)."""


def iter_work(m, n, trials):
    """``(bytes, flops)`` of one iteration that ran ``trials`` trials (a
    mean may be fractional)."""
    return 8 * (m * n + m + 2 * n), 2 * m * n * (2 + trials)
