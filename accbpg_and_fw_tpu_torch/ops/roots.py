"""Root-finding for the Bregman prox maps.

Port of ``accbpg_and_fw_tpu/ops/roots.py``.  The JAX package wrote each
data-dependent loop as a bounded ``lax.while_loop``; here a loop whose exit
test depends on the data is a bounded Python loop, and each test reads one
value back from the device (a host sync on CUDA).  Fixed-count loops
(``bisect_monotone``) stay on the device and never read back.
"""

from __future__ import annotations

import math

import torch

from .._device import replicate_like, replicated
from .._scalar import div, read


def _f64(a, like=None):
    """``a`` as a float64 tensor; a number on ``like``'s device (replicated
    on its mesh when ``like`` is a DTensor, so the two can meet)."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float64)
    dev = like.device if isinstance(like, torch.Tensor) else None
    return replicate_like(torch.tensor(a, dtype=torch.float64, device=dev),
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
    simplex prox; reference: functions.py:336-356).  Same algorithm as the
    JAX function:

    * the certified from-below start ``max(cmin + 1, c_hm)`` with the AM-HM
      point ``c_hm = n - mean(gg)`` over the finite coordinates (a +inf
      coordinate contributes exactly 0);
    * an optional warm start ``c_warm``, taken only when finite, inside the
      domain ``c > cmin`` and below the root bound ``cmin + n``;
    * Newton on the convex decreasing residual, one fused pass per step,
      until ``|resid| <= eps`` or ``max_newton`` steps, with the domain
      safeguard (bisect back toward ``cmin``) and the freeze guard (an
      update that does not move c ends the loop);
    * two unconditional polish steps.

    The scalar recurrence runs on the host: one read for ``(min, n, sum)``,
    one per pass for the two sums, so a call costs ``3 + (Newton steps)``
    host syncs on CUDA (two fewer when the polish freezes).  Returns ``c``
    as a Python float.
    """
    gg = _f64(gg)
    finite = torch.isfinite(gg)
    cmin, n_eff, gg_sum = read(-gg.min(), finite.sum(dtype=torch.float64),
                               torch.where(finite, gg, 0.0).sum())
    eps = float(eps)

    def resid_and_deriv(c):
        r = torch.div(1.0, gg + c)
        s1, s2 = read(r.sum(), (r * r).sum())
        return s1 - 1.0, -s2

    c0 = cmin + 1.0
    c_hm = n_eff - div(gg_sum, n_eff)
    c = c_hm if (c_hm > c0 or math.isnan(c_hm)) else c0
    if c_warm is not None:
        (cw,) = read(c_warm)
        if math.isfinite(cw) and cw > cmin and cw <= cmin + n_eff and cw > c:
            c = cw

    fc, fpc = resid_and_deriv(c)
    it = 0
    while abs(fc) > eps and it < max_newton:
        c_new = c - div(fc, fpc)
        # domain safeguard: never fires from a below-root start; a
        # from-above warm start that overshoots past cmin bisects back
        if not c_new > cmin:
            c_new = 0.5 * (c + cmin)
        if c_new == c:  # the update underflowed: freeze (reference :348)
            fc = 0.0
        else:
            fc, fpc = resid_and_deriv(c_new)
        c = c_new
        it += 1
    # two polish steps (the second one's residual is never used)
    c_new = c - div(fc, fpc)
    if c_new == c:
        fc = 0.0
    else:
        fc, fpc = resid_and_deriv(c_new)
    c = c_new
    return c - div(fc, fpc)


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
    """Bounded scalar Newton iteration: stops once ``|fn(x)| <= tol`` (one
    host read per step when ``fn`` returns a tensor)."""
    x = x0
    fx = fn(x)
    it = 0
    while it < max_iters and abs(read(fx)[0]) > tol:
        x = x - fx / dfn(x)
        fx = fn(x)
        it += 1
    return x
