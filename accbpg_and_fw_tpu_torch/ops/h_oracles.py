"""Legendre kernels (h-oracles) of the port: the Burg-entropy family.

Port of ``accbpg_and_fw_tpu/ops/h_oracles.py:41-196`` (reference:
functions.py:238-356): ``BurgEntropy``, ``BurgEntropyL1``,
``BurgEntropyL2`` and ``BurgEntropySimplex``, float64 tensors in and out,
scalars (``L``, ``lamda``, a multiplier) as Python floats.  The other
h-oracles of the JAX package are not ported yet.

Out-of-domain inputs give NaN or inf instead of raising, as in JAX; the
drivers' line searches count a NaN trial as a failure.
"""

from __future__ import annotations

import torch

from .base import LegendreOracle
from .roots import simplex_inv_multiplier
from .simplex import simplex_inv_multiplier_pallas


class BurgEntropy(LegendreOracle):
    """h(x) = -sum_i log(x_i) on the positive orthant."""

    def value(self, x):
        return -torch.sum(torch.log(x))

    def grad(self, x):
        return torch.div(-1.0, x)

    def divergence(self, x, y):
        r = x / y
        t = r - torch.log(r) - 1.0
        # x == y == 0 coordinates are structurally absent (zero-padded
        # columns): their contribution is the limit 0, not 0/0 = NaN.  Other
        # domain violations still give inf or NaN.
        t = torch.where((x == 0) & (y == 0), torch.zeros_like(t), t)
        return torch.sum(t)

    def prox_map(self, g, L):
        # argmin_{x>0} <g,x> - L*sum log x  =>  x = L/g  (needs g > 0)
        return torch.div(L, g)

    def div_prox_map(self, y, g, L):
        return self.prox_map(g + torch.div(L, y), L)


class BurgEntropyL1(BurgEntropy):
    """Burg entropy with Psi(x) = lamda*||x||_1 (reference :274-298).  The
    prox may be unbounded when g approaches -lamda, as in the reference."""

    def __init__(self, lamda=0.0):
        self.lamda = float(lamda)

    def extra_psi(self, x):
        return self.lamda * torch.sum(x)

    def prox_map(self, g, L):
        return torch.div(L, self.lamda + g)


class BurgEntropyL2(BurgEntropy):
    """Burg entropy with Psi(x) = (lamda/2)||x||_2^2 (reference :301-323)."""

    def __init__(self, lamda=0.0):
        self.lamda = float(lamda)

    def extra_psi(self, x):
        return (self.lamda / 2.0) * torch.dot(x, x)

    def prox_map(self, g, L):
        # x solves lamda*x^2 + g*x - L = 0 per coordinate (positive root);
        # at lamda == 0 the closed form is 0/0, so take the linear limit
        # x = L/g (= 1/gg) instead
        gg = g / L
        lamda_L = self.lamda / L
        if lamda_L == 0:
            return torch.div(1.0, gg)
        return (torch.sqrt(gg * gg + 4.0 * lamda_L) - gg) / (2.0 * lamda_L)


class BurgEntropySimplex(BurgEntropy):
    """Burg entropy restricted to the unit simplex (reference :326-356).

    ``prox_map`` solves ``sum_i 1/(g_i/L + c) = 1`` for the multiplier c
    with ``roots.simplex_inv_multiplier`` (a warm-startable Newton whose
    scalar recurrence runs on the host: ``3 + (Newton steps)`` host syncs on
    CUDA).  ``use_pallas=True`` takes the one-kernel multiplier of
    ``ops/simplex.py`` instead: the Hopper kernel on CUDA (one launch, no
    host sync), its plain version on the CPU.  Opt-in, as in JAX.
    """

    def __init__(self, eps=1e-8, use_pallas=False):
        self.eps = float(eps)
        self.use_pallas = bool(use_pallas)

    def prox_map(self, g, L):
        gg = g / L
        if self.use_pallas:
            c = simplex_inv_multiplier_pallas(gg)
        else:
            c = simplex_inv_multiplier(gg, self.eps)
        return torch.div(1.0, gg + c)

    # -- warm-started variants for stateful drivers: any carried multiplier
    #    is safe (see roots.simplex_inv_multiplier); they return (x, c) --

    def prox_map_warm(self, g, L, c_prev):
        gg = g / L
        c = simplex_inv_multiplier(gg, self.eps, c_warm=c_prev)
        return torch.div(1.0, gg + c), c

    def div_prox_map_warm(self, y, g, L, c_prev):
        return self.prox_map_warm(g + torch.div(L, y), L, c_prev)
