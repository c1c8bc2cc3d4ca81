"""Root-finding for the Bregman prox maps.

Port of ``accbpg_and_fw_tpu/ops/roots.py``.  The JAX package wrote each
data-dependent loop as a bounded ``lax.while_loop``; here such a loop is a
``device_while`` (``_loops.py``) on 0-d tensors: a Python loop that reads
its exit test each turn outside a graph chunk (a host sync on CUDA), and
a fixed number of masked steps with an overflow flag inside one, so a
graph chunk captures the prox whole.  Fixed-count loops (``bisect_monotone``) never
read back.
"""

from __future__ import annotations

import torch

from .._device import replicate_like, replicated
from .._loops import device_while

# Masked Newton passes of ``simplex_inv_multiplier`` in a graph chunk (past
# them the iteration runs again in the loop's Python form).  BPG-LS 30x1000
# with the default h took 8 in 17276 of 17991 calls over 9000 iterations
# under ``eager_chunks`` on the card, never more (PERF.md).
NEWTON_BODIES = 8
# The same for a warm-started call (``c_warm``: the fast_gram steps carry
# the multiplier).  The warm start does not save passes: ABPG_gain
# 30x10000 with fast_gram took 7 in 10886 of 17993 calls over 9000
# iterations under ``eager_chunks`` on the card, 2 in 4758, more than 13
# in 26 and at most 19; as graphs 8 / 12 / 13 / 14 bodies took 77.6 /
# 22.6 / 18.0 / 20.5 s for 2000 iterations (PERF.md).
WARM_NEWTON_BODIES = 13


def _f64(a, like=None):
    """``a`` as a float64 tensor; a number on ``like``'s device (a fill on
    the device, so a capture may take it; replicated on its mesh when
    ``like`` is a DTensor, so the two can meet)."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float64)
    dev = like.device if isinstance(like, torch.Tensor) else None
    return replicate_like(torch.full((), a, dtype=torch.float64, device=dev),
                          like)


def _cbrt(a):
    return torch.sign(a) * a.abs().pow(1.0 / 3.0)


def solve_cubic(c, beta):
    """Unique real root of ``z**3 - beta*z**2 = c`` for ``c > 0``.

    Closed form (Cardano), elementwise (reference: functions.py:522-544).
    PyTorch has no ``cbrt``; ``sign(a) |a|^(1/3)`` stands in, and the two
    Newton polish steps take the root to machine accuracy either way.
    """
    c = replicated(_f64(c))  # a sharded sum, reduced once
    beta = _f64(beta, like=c)
    z = beta / 3.0
    beta3 = beta**3
    delta = c**2 + 4.0 * beta3 * c / 27.0
    sq_delta = torch.sqrt(delta)
    b = 0.5 * c + beta3 / 27.0
    z = z + _cbrt(b + 0.5 * sq_delta)
    z = z + _cbrt(b - 0.5 * sq_delta)
    # Cardano suffers cancellation when b ~ sq_delta/2; two Newton polish
    # steps restore near-machine accuracy.
    for _ in range(2):
        num = z * z * (z - beta) - c
        den = z * (3.0 * z - 2.0 * beta)
        z = z - num / torch.where(den == 0, torch.ones_like(den), den)
    return z


def simplex_inv_multiplier(gg, eps, max_newton=100, c_warm=None):
    """Solve ``sum_i 1/(gg_i + c) = 1`` for the unique ``c > -min(gg)``.

    The KKT multiplier of ``argmin_{x in simplex} <g,x> - L*sum log x``,
    whose solution is ``x = 1/(gg + c)`` with ``gg = g/L`` (Burg-entropy
    simplex prox; reference: functions.py:336-356).  The JAX function's
    structure (JAX ``roots.py:67-168``):

    * the certified from-below start ``max(cmin + 1, c_hm)`` with the AM-HM
      point ``c_hm = n - mean(gg)`` over the finite coordinates (a +inf
      coordinate contributes exactly 0);
    * an optional warm start ``c_warm``, taken by ``torch.where`` only when
      finite, inside the domain ``c > cmin`` and below the root bound
      ``cmin + n``;
    * Newton on the convex decreasing residual, one fused pass per step, as
      a ``device_while`` until ``|resid| <= eps`` or ``max_newton`` steps,
      with the domain safeguard (bisect back toward ``cmin``) and the
      freeze guard (an update that does not move c zeroes the residual);
    * two unconditional polish steps.

    Returns ``c`` as a 0-d tensor on ``gg``'s device, with no host read in
    a graph chunk (``NEWTON_BODIES`` masked passes there, or
    ``WARM_NEWTON_BODIES`` with ``c_warm``).
    """
    gg = _f64(gg)
    eps = float(eps)
    cmin = -gg.min()
    finite = torch.isfinite(gg)
    n_eff = finite.sum(dtype=torch.float64)
    gg_sum = torch.where(finite, gg, 0.0).sum()

    def resid_and_deriv(c):
        r = torch.div(1.0, gg + c)
        return r.sum() - 1.0, -(r * r).sum()

    c = torch.maximum(cmin + 1.0, n_eff - gg_sum / n_eff)
    if c_warm is not None:
        cw = _f64(c_warm, like=gg)
        ok = torch.isfinite(cw) & (cw > cmin) & (cw <= cmin + n_eff)
        c = torch.where(ok, torch.maximum(c, cw), c)

    def newton(s):
        c, fc, fpc = s
        c_new = c - fc / fpc
        # domain safeguard: never fires from a below-root start; a
        # from-above warm start that overshoots past cmin bisects back
        c_new = torch.where(c_new > cmin, c_new, 0.5 * (c + cmin))
        # an update that underflowed freezes (reference :348)
        fc_new, fpc_new = resid_and_deriv(c_new)
        return c_new, torch.where(c_new == c, 0.0, fc_new), fpc_new

    warm = c_warm is not None
    c, fc, fpc = device_while(
        lambda s: torch.abs(s[1]) > eps, newton, (c,) + resid_and_deriv(c),
        int(max_newton), WARM_NEWTON_BODIES if warm else NEWTON_BODIES,
        "warm multiplier Newton" if warm else "multiplier Newton")
    # two polish steps (the second one's residual is never used)
    c_new = c - fc / fpc
    fc_new, fpc = resid_and_deriv(c_new)
    fc = torch.where(c_new == c, 0.0, fc_new)
    return c_new - fc / fpc


def project_simplex_burg(y, eps=1e-8):
    """Map ``y`` to ``x = 1/(y + c)`` with ``sum(x) = 1`` (Burg-Newton map;
    reference: functions.py:590-614).  Shape-preserving."""
    y = _f64(y)
    y_flat = y.reshape(-1)
    c = simplex_inv_multiplier(y_flat, eps)
    return torch.div(1.0, y_flat + c).reshape(y.shape)


def bisect_monotone(fn, lo, hi, iters=64):
    """Scalar bisection for an increasing ``fn`` on [lo, hi], a fixed number
    of steps on the device (no host read).  Without a sign change the result
    clamps to an endpoint."""
    lo = _f64(lo)
    hi = _f64(hi, like=lo)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        go_right = fn(mid) < 0
        lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi, mid)
    return 0.5 * (lo + hi)


def newton_scalar(fn, dfn, x0, tol, max_iters=100):
    """Bounded scalar Newton iteration: stops once ``|fn(x)| <= tol``
    (JAX's ``newton_scalar``, a ``device_while``: one host read per step
    outside a graph chunk when ``fn`` returns a tensor)."""

    def body(s):
        x = s[0] - s[1] / dfn(s[0])
        return x, fn(x)

    x0 = _f64(x0)
    return device_while(lambda s: torch.abs(s[1]) > tol, body,
                        (x0, fn(x0)), int(max_iters), NEWTON_BODIES)[0]
