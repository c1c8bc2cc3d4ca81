"""Problem factories of the port (counterpart of
``accbpg_and_fw_tpu/apps/applications.py``).

Ported so far: ``D_opt_design`` and ``D_opt_KYinit``.  Both are numpy
driven by the global ``np.random`` state, as in the JAX package, so the same
seed gives the same instance and start bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import DTYPE, resolve_device
from ..ops.f_oracles import DOptimalObj
from ..ops.h_oracles import BurgEntropySimplex


def D_opt_design(m, n, randseed=-1, oracle=None, device=None):
    """Random D-optimal design instance: H ~ randn(m, n), Burg-simplex h,
    L = 1, x0 = center of simplex (reference: applications.py:36-56).
    Returns ``(f, h, L, x0)`` with H and x0 float64 on ``device`` (the CPU
    for None).

    ``oracle="mixed"`` (the JAX package's int8-digit oracle, a TPU
    workaround for slow f64) is accepted and gives the FP64
    ``DOptimalObj``."""
    if oracle not in (None, "mixed"):
        raise ValueError(f"unknown oracle={oracle!r} (None or 'mixed')")
    dev = resolve_device(device)
    if randseed > 0:
        np.random.seed(randseed)
    H = np.random.randn(m, n)
    x0 = torch.full((n,), 1.0 / n, dtype=DTYPE, device=dev)
    return DOptimalObj(H, device=dev), BurgEntropySimplex(), 1.0, x0


def D_opt_KYinit(V, device=None):
    """Kumar-Yildirim sparse initial point via Gram-Schmidt probe directions
    (JOTA 126(1):1-21, 2005; reference: applications.py:59-95).

    Draws ``m`` vectors from ``np.random.rand``, as the JAX function does.
    Returns a float64 tensor on ``device`` (the CPU for None)."""
    dev = resolve_device(device)
    V = np.asarray(V.cpu() if isinstance(V, torch.Tensor) else V)
    m, n = V.shape
    if n <= 2 * m:
        return torch.full((n,), 1.0 / n, dtype=DTYPE, device=dev)

    chosen = []
    Q = np.zeros((m, m))
    for i in range(m):
        b = np.random.rand(m)
        q = b - Q[:, :i] @ (Q[:, :i].T @ b)
        qV = q @ V
        kmax, kmin = int(np.argmax(qV)), int(np.argmin(qV))
        chosen += [kmax, kmin]
        v = V[:, kmin] - V[:, kmax]
        q = v - Q[:, :i] @ (Q[:, :i].T @ v)
        Q[:, i] = q / np.linalg.norm(q)

    x0 = np.zeros(n)
    x0[chosen] = 1.0 / len(chosen)
    x0 /= x0.sum()
    return torch.tensor(x0, dtype=DTYPE, device=dev)
