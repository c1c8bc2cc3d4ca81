"""Oracle interfaces: relatively-smooth f-oracles and Legendre h-oracles.

Port of ``accbpg_and_fw_tpu/ops/base.py``.  The oracles are plain Python
classes over float64 tensors (PyTorch has no pytrees to thread through a
compiled loop).  The primary API is fused: ``value_and_grad`` shares the
expensive factorization between the value and the gradient.  The
reference's names are kept as aliases (``__call__``, ``gradient``,
``func_grad(x, flag)``, ``extra_Psi``, ``RSmoothFunction``,
``LegendreFunction``), so code written against the reference ports with an
import change.

Stochastic (inexact) oracles take an optional ``key``, a draw key of
``_rng``; the class attribute ``stochastic`` tells the drivers to pass a
fresh one per gradient evaluation.
"""

from __future__ import annotations

import torch


def vdot(a, b):
    """<a, b> over every entry (``jnp.vdot`` for real tensors of any
    shape; ``torch.dot`` takes 1-d tensors only)."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


def fnorm(a):
    """2-norm of a vector, Frobenius norm of a matrix (any rank)."""
    return torch.linalg.vector_norm(a)


class SmoothOracle:
    """f-oracle for min f(x) + Psi(x): query value / gradient / both."""

    #: drivers split and pass a key (``_rng``) per gradient when True
    stochastic: bool = False

    # --- primary API -----------------------------------------------------
    def value(self, x, key=None):
        raise NotImplementedError(type(self).__name__ + ".value")

    def grad(self, x, key=None):
        return self.value_and_grad(x, key=key)[1]

    def value_and_grad(self, x, key=None):
        """Fused (f(x), grad f(x)); override to share the heavy compute."""
        return self.value(x, key=key), self.grad(x, key=key)

    def span_attrs(self):
        """What a profile's ``driver.solve`` span names the problem by:
        the data matrix's ``m`` and ``n`` where the oracle holds one."""
        return {}

    # --- reference-compatible aliases -------------------------------------
    def __call__(self, x):
        return self.value(x)

    def gradient(self, x):
        return self.grad(x)

    def func_grad(self, x, flag=2):
        """Reference protocol: flag=0 value, 1 gradient, 2 both."""
        if flag == 0:
            return self.value(x)
        if flag == 1:
            return self.grad(x)
        return self.value_and_grad(x)


class LegendreOracle:
    """h-oracle: Legendre kernel h + simple convex regularizer Psi.

    Defines the Bregman divergence D(x,y) = h(x) - h(y) - <h'(y), x-y> and
    the two proximal maps

        prox_map(g, L)        = argmin_{x in C} { Psi(x) + <g,x> + L*h(x) }
        div_prox_map(y, g, L) = argmin_{x in C} { Psi(x) + <g,x> + L*D(x,y) }

    with the default reduction div_prox_map = prox_map(g - L*h'(y), L)
    (reference: functions.py:227-235).  ``L`` is a Python float.
    """

    # --- primary API -----------------------------------------------------
    def value(self, x):
        raise NotImplementedError(type(self).__name__ + ".value")

    def extra_psi(self, x):
        """Psi(x); zero by default (a Python float, so adding it to a host
        value costs no device work)."""
        return 0.0

    def grad(self, x):
        raise NotImplementedError(type(self).__name__ + ".grad")

    def divergence(self, x, y):
        gy = self.grad(y)
        return self.value(x) - self.value(y) - vdot(gy, x - y)

    def prox_map(self, g, L):
        raise NotImplementedError(type(self).__name__ + ".prox_map")

    def div_prox_map(self, y, g, L):
        return self.prox_map(g - L * self.grad(y), L)

    # --- reference-compatible aliases -------------------------------------
    def __call__(self, x):
        return self.value(x)

    def extra_Psi(self, x):
        return self.extra_psi(x)

    def gradient(self, x):
        return self.grad(x)


# Reference base-class names (functions.py:10 `RSmoothFunction`, :199
# `LegendreFunction`): user code subclasses these to define its own oracles.
RSmoothFunction = SmoothOracle
LegendreFunction = LegendreOracle
