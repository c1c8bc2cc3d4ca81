"""Frank-Wolfe solves by the (L0,L1) shortest-step rule:
``FW_alg_L0_L1_shortest_step(LogisticRegression(X, y), SquaredL2Norm(),
L0, L1, x0, maxitrs, gamma, lmo=lmo_l2_ball(radius), ls_ratio, epsilon,
verbose=False)`` on one instance of the pool per call (graph chunks of
``fw.GRAPH_SPAN`` iterations, with eager continuations), the budget run
to its end (or to the solver's own stop).

Configuration: ``radius``, ``gamma``, ``ls_ratio``, ``epsilon``,
``maxitrs``.  The warm call and the traced slice may pass a shorter
``maxitrs`` (the same graph replays: its key does not hold the
budget)."""

from __future__ import annotations

import numpy as np


class Caller:
    def __init__(self, port, config, mix, pool, device):
        self.port, self.pool = port, pool
        self.kw = dict(gamma=float(config["gamma"]),
                       ls_ratio=float(config["ls_ratio"]),
                       epsilon=float(config["epsilon"]), verbose=False)
        self.maxitrs = int(config["maxitrs"])
        self.h = port.SquaredL2Norm()
        # one LMO for every call: the graph's key holds it by identity
        self.lmo = port.lmo_l2_ball(float(config["radius"]))

    def call(self, idx, maxitrs=None):
        from portbench.core.window import Answer

        (i,) = idx
        p = self.pool
        f = self.port.LogisticRegression(p.X[i], p.y[i])
        x, F, Ls, _ = self.port.FW_alg_L0_L1_shortest_step(
            f, self.h, p.L0[i], p.L1[i], p.x0,
            self.maxitrs if maxitrs is None else int(maxitrs), lmo=self.lmo,
            **self.kw)
        return Answer(x[None], {"F": F[None], "Ls": Ls[None]},
                      np.array([len(F)]), tuple(idx))

    def close(self):
        self.port.algorithms.driver.clear_graph_cache()


def prepare(port, config, mix, pool, device):
    return Caller(port, config, mix, pool, device)
