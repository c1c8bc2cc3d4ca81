"""Empirical triangle-scaling-exponent (TSE) estimation and plots
(reference: accbpg/trianglescaling.py:10-79; counterpart of
``accbpg_and_fw_tpu/viz/trianglescaling.py``).

The estimator is

    gamma_hat(theta) = log( D((1-t)x + t y, (1-t)x + t z) / D(y, z) ) / log t

evaluated on a theta grid.  ``tse_curve`` evaluates the whole grid with
``torch.func.vmap`` over the thetas, one batched call per (x, y, z)
triple; the plot functions wrap it with the reference's figure semantics
and import matplotlib only when called.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import as_f64, resolve_device


def tse_curve(h, x, y, z, thetas, device=None):
    """gamma_hat(theta) for one (x, y, z) triple on a theta grid (vmapped
    over the thetas), a float64 tensor on ``device`` (for None a tensor
    ``x``'s device, else CUDA; ``"cpu"`` asks for the CPU)."""
    dev = resolve_device(device, like=x)
    x, y, z = (as_f64(a, dev) for a in (x, y, z))
    thetas = as_f64(thetas, dev)
    dyz = h.divergence(y, z)

    def one(c):
        dtheta = h.divergence((1 - c) * x + c * y, (1 - c) * x + c * z)
        return torch.log(dtheta / dyz) / torch.log(c)

    return torch.func.vmap(one)(thetas)


def plotTSE(h, dim=10, nTriples=10, nThetas=100, R=1, onSimplex=True,
            randseed=-1, device=None):
    """Plot gamma_hat(theta) curves for random triples
    (reference: trianglescaling.py:10-46)."""
    import matplotlib.pyplot as plt

    if randseed >= 0:
        np.random.seed(randseed)

    plt.figure()
    thetas = np.arange(1.0 / nThetas, 1, 1.0 / nThetas)
    for _ in range(nTriples):
        x = R * np.random.rand(dim)
        y = R * np.random.rand(dim)
        z = R * np.random.rand(dim)
        if onSimplex:
            x, y, z = x / x.sum(), y / y.sum(), z / z.sum()
        plt.plot(thetas, tse_curve(h, x, y, z, thetas, device).cpu().numpy())

    plt.xlim([0, 1])
    plt.tight_layout()


def plotTSE0(h, dim=10, xscale=1, yscale=1, zscale=2, nThetas=1000,
             maxTheta=1, device=None):
    """Plot gamma_hat(theta) for the deterministic scaled-ones triple
    (reference: trianglescaling.py:49-79)."""
    import matplotlib.pyplot as plt

    plt.figure()
    x = xscale * np.ones(dim)
    y = yscale * np.ones(dim)
    z = zscale * np.ones(dim)
    thetas = np.arange(1.0 / nThetas, maxTheta, 1.0 / nThetas)
    plt.plot(thetas, tse_curve(h, x, y, z, thetas, device).cpu().numpy())
    plt.xlim([0, maxTheta])
    plt.tight_layout()
