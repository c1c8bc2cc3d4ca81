"""The work of ``dopt_dense_kernel`` (``csrc/dopt_dense.cu``): one block
of B instances that ran ``iters`` iterations in all reads V^T, H, x and w
once and writes H, x, w and the ``kmax`` rows once; an iteration does
2 m n (u) + 4 m^2 (H v and the rank-1 update of H) + 8 n FP64
operations."""


def block_work(B, m, n, kmax, iters):
    nbytes = 8 * B * (m * n + 2 * m * m + 4 * n + 3 + 5 * kmax)
    return nbytes, iters * (2 * m * n + 4 * m * m + 8 * n)
