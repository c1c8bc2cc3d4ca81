"""Newton solve for the ABPG theta-sequence.

Port of ``accbpg_and_fw_tpu/algorithms/theta.py:75-111`` (reference:
accbpg/algorithms.py:75-91).  Solves (1-theta')/theta'^gamma =
gainratio / theta^gamma for theta', the root of
phi(t) = t^gamma - ckg*(1-t) with ckg = theta^gamma/gainratio, by Newton
from theta.

``solve_theta`` works on 0-d tensors on the solve's device, as the plain
Bregman steps carry theta: JAX's ``unroll`` guarded steps and its bounded
continuation to ``max_iters``, as one ``device_while`` (``_loops.py``).
A guarded step changes nothing once ``|phi| <= 1e-6 theta``, so the
unrolled steps and the continuation are one loop of at most
``max(unroll, max_iters)`` steps that stops at the first step whose
residual passes the test; in a graph chunk it is ``NEWTON_BODIES``
masked steps.
"""

from __future__ import annotations

import torch

from .._loops import device_while

# Masked Newton steps of ``solve_theta`` in a graph chunk (past them the
# iteration runs again in the loop's Python form).  ABPG_gain 30x10000
# (gamma 2, the kernel route) took at most 4, in 34 of 17991 solves over
# 9000 iterations under ``eager_chunks`` on the card (PERF.md).
NEWTON_BODIES = 4


def solve_theta(theta, gamma, gainratio=1.0, max_iters=64, unroll=12):
    """theta' as a 0-d float64 tensor on ``theta``'s device (see the module
    docstring); ``gamma`` and ``gainratio`` may be numbers or 0-d
    tensors.  No host read inside a graph chunk."""
    theta = torch.as_tensor(theta, dtype=torch.float64)
    ckg = theta ** gamma / gainratio
    eps = 1e-6 * theta
    gamma1 = gamma - 1.0

    def phi(t):
        return t ** gamma - ckg * (1.0 - t)

    def body(s):
        t, ph = s
        t = t - ph / (gamma * t ** gamma1 + ckg)
        return t, phi(t)

    t, _ = device_while(lambda s: torch.abs(s[1]) > eps, body,
                        (theta, phi(theta)), max(int(max_iters), int(unroll)),
                        NEWTON_BODIES, "theta Newton")
    return t
