"""Sweeps: ``dopt_fw_batch(Vs, x0s, eps, maxitrs, away=True,
precision="auto")`` (the engine the port routes the shape to) on the next
``batch`` designs of the pool per call.

Mix parameter: ``batch`` (K).  Configuration: ``eps``, ``fw_maxitrs``.
An instance's rows run to its first row with both slacks at or below eps
(its later rows repeat it)."""

from __future__ import annotations

import numpy as np


def stop_rows(SP, SN, eps):
    """(K,) rows up to and including each instance's first stop row (all
    of them where it never stopped)."""
    hit = (SP <= eps) & (SN <= eps)
    first = np.argmax(hit, axis=1)
    return np.where(hit.any(axis=1), first + 1, SP.shape[1])


class Caller:
    def __init__(self, port, config, mix, pool, device):
        self.port, self.pool = port, pool
        self.eps = float(config["eps"])
        self.cap = int(config["fw_maxitrs"])
        self.K = int(mix["batch"])
        self.device = device
        self.x0s = pool.x0.expand(self.K, -1).contiguous()

    def call(self, idx):
        from portbench.core.window import Answer

        a = idx[0]
        if tuple(idx) != tuple(range(a, a + self.K)):
            raise ValueError(f"a sweep takes {self.K} consecutive designs")
        x, F, SP, SN = self.port.dopt_fw_batch(
            self.pool.V[a:a + self.K], self.x0s, self.eps, self.cap,
            away=True, precision="auto", device=self.device)
        return Answer(x, {"F": F, "SP": SP, "SN": SN},
                      stop_rows(SP, SN, self.eps), tuple(idx))

    def close(self):
        self.port.algorithms.driver.clear_graph_cache()


def prepare(port, config, mix, pool, device):
    return Caller(port, config, mix, pool, device)
