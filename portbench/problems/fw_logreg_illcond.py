"""Ill-conditioned logistic regression instances for the (L0,L1)-smooth
Frank-Wolfe cells, drawn as users draw them: the port's
``hard_FW_log_reg_jax`` (the upstream's ``applications.py``
generator) with the configuration's arguments, instance i from its own
integer key derived from the run's seed, on the device.

``make`` returns the data alone (X, y, L0, L1, x0), so that the reference
computes nothing with the port.  L0 is floored as ``examples/ex_fw_l0l1.py``
floors it (``max(L0, L0_floor)``); L1 is the largest row norm of X.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Pool(NamedTuple):
    X: torch.Tensor    # (count, m, n) float64
    y: torch.Tensor    # (count, m) float64, labels in {-1, 1}
    L0: list           # count floats
    L1: list           # count floats
    x0: torch.Tensor   # (n,) the start
    count: int


def instance_key(seed, i):
    """Instance i's key: the seed's bits with the index below them."""
    return ((int(seed) << 20) + int(i)) % 2**63


def make(config, count, seed, device):
    import accbpg_and_fw_tpu_torch as port

    m, n = int(config["m"]), int(config["n"])
    args = {k: config[k] for k in ("domain", "radius", "rho", "col_scale",
                                   "flip_y", "noise", "margin", "k_sparse",
                                   "x0_mode")}
    X = torch.empty((count, m, n), dtype=torch.float64, device=device)
    y = torch.empty((count, m), dtype=torch.float64, device=device)
    L0, L1 = [], []
    for i in range(count):
        _, _, _, l0, l1, x0, Xi, yi = port.hard_FW_log_reg_jax(
            instance_key(seed, i), m, n, device=device, **args)
        X[i], y[i] = Xi, yi
        L0.append(max(float(l0), float(config["L0_floor"])))
        L1.append(float(l1))
    return Pool(X, y, L0, L1, x0, count)
