"""Single solves: ``D_opt_FW_away(V, x0, eps, maxitrs, verbose=False)``
(``u_mode="auto"``: the engine the port routes the shape to) on one
design of the pool per call.  Configuration: ``eps``, ``fw_maxitrs`` (a
cap that the solves do not reach)."""

from __future__ import annotations

import numpy as np


class Caller:
    def __init__(self, port, config, mix, pool, device):
        self.port, self.pool = port, pool
        self.eps = float(config["eps"])
        self.cap = int(config["fw_maxitrs"])
        self.device = device

    def call(self, idx):
        from portbench.core.window import Answer

        (i,) = idx
        x, F, SP, SN, _ = self.port.D_opt_FW_away(
            self.pool.V[i], self.pool.x0, self.eps, self.cap, verbose=False,
            device=self.device)
        hist = {"F": F[None], "SP": SP[None], "SN": SN[None]}
        return Answer(x[None], hist, np.array([len(F)]), tuple(idx))

    def close(self):
        self.port.algorithms.driver.clear_graph_cache()


def prepare(port, config, mix, pool, device):
    return Caller(port, config, mix, pool, device)
