"""The work of ``simplex_mult_kernel`` (``csrc/simplex_mult.cu``), the
Burg-simplex multiplier of an n-vector, from n alone: the vector read
once and the multiplier written once, and one pass of 5 FP64 operations
an element (the passes beyond it depend on the input and are not
counted, so the bound is a lower one)."""


def solve_work(n):
    return 8 * (n + 1), 5 * n
