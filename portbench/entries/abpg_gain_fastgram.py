"""Bregman solves on the linear-Gram fast path: ``ABPG_gain(DOptimalObj(V),
BurgEntropySimplex(use_pallas=True), 1.0, x0, gamma, maxitrs,
verbose=False, fast_gram=True)`` on one design of the pool per call (the
fast-Gram steps' graph chunks: the warm-started Newton prox, no kernel),
the budget run to its end (or to the solver's own stop).

Configuration: ``abpg_gain_gamma``, ``abpg_gain_maxitrs``.  The warm
call and the traced slice may pass a shorter ``maxitrs`` (the same graph
replays: its key does not hold the budget)."""

from __future__ import annotations

import numpy as np


class Caller:
    def __init__(self, port, config, mix, pool, device):
        self.port, self.pool = port, pool
        self.gamma = float(config["abpg_gain_gamma"])
        self.maxitrs = int(config["abpg_gain_maxitrs"])
        self.h = port.BurgEntropySimplex(use_pallas=True)

    def call(self, idx, maxitrs=None):
        from portbench.core.window import Answer

        (i,) = idx
        f = self.port.DOptimalObj(self.pool.V[i])
        x, F, Gain, _, _, _ = self.port.ABPG_gain(
            f, self.h, 1.0, self.pool.x0, gamma=self.gamma,
            maxitrs=self.maxitrs if maxitrs is None else int(maxitrs),
            verbose=False, fast_gram=True)
        hist = {"F": F[None], "Gain": Gain[None]}
        return Answer(x[None], hist, np.array([len(F)]), tuple(idx))

    def close(self):
        self.port.algorithms.driver.clear_graph_cache()


def prepare(port, config, mix, pool, device):
    return Caller(port, config, mix, pool, device)
