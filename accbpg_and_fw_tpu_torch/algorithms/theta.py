"""Newton solve for the ABPG theta-sequence, on the host.

Port of ``accbpg_and_fw_tpu/algorithms/theta.py:75-111`` (reference:
accbpg/algorithms.py:75-91).  Solves (1-theta')/theta'^gamma =
gainratio / theta^gamma for theta', the root of
phi(t) = t^gamma - ckg*(1-t) with ckg = theta^gamma/gainratio, by Newton
from theta.  The port's drivers keep theta on the host, so this runs in
Python floats (IEEE doubles): the 12 guarded steps and the bounded
continuation of the JAX function cost no kernel launches.
"""

from __future__ import annotations

from .._scalar import div, power


def solve_theta(theta, gamma, gainratio=1.0, max_iters=64, unroll=12):
    """theta' as a Python float (see the module docstring).  Newton stops
    once ``|phi| <= 1e-6 * theta``, after at most ``max(unroll,
    max_iters)`` steps: the JAX function's ``unroll`` guarded steps and its
    while-loop, which counts on from ``unroll`` to ``max_iters``."""
    theta, gamma, gainratio = float(theta), float(gamma), float(gainratio)
    ckg = div(power(theta, gamma), gainratio)
    eps = 1e-6 * theta

    def phi(t):
        return power(t, gamma) - ckg * (1.0 - t)

    t, ph = theta, phi(theta)
    it, limit = 0, max(int(max_iters), int(unroll))
    while abs(ph) > eps and it < limit:
        t = t - div(ph, gamma * power(t, gamma - 1.0) + ckg)
        ph = phi(t)
        it += 1
    return t
