"""Inexact-oracle and constrained methods: AIBM, AdaptFGM, UniversalGM,
PrimalDualSwitchingGradientMethod.

Port of ``accbpg_and_fw_tpu/algorithms/extras.py`` (reference:
accbpg/algorithms.py:593-968): the same math, signatures, return tuples,
printed tables and checkpoints (the JAX fingerprints, carry keys and
history names).

The steps run on ``driver._host_chunk``, as the Bregman drivers of
``bpg.py`` do: the scalars (L, alpha, B, A, the sums of step sizes, the
noise draws) are Python floats on the host, the vectors stay on the
device, and each line-search trial ends in one ``_scalar.read`` of what the
host decides on, with the JAX expressions in the JAX order.

The inexact-oracle noise is drawn from the chain of keys of ``_rng``
seeded by ``seed``, one ``split`` per iteration as in JAX, as host floats
(no device work).  The primal-dual driver's inner dual ascent runs in
blocks of ``h_oracles.DUAL_BLOCK`` steps that freeze once its exit test
has fired, with one host read per block.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import _rng
from .._scalar import div, power, read
from ..ops.base import vdot
from ..ops.h_oracles import DUAL_BLOCK
from .bpg import _read, _start, _trial_draw
from .driver import run_driver

_LS_MAX = 64  # doubling line searches multiply L by 2^t; 2^64 is past overflow


def _row(k, r, t):
    print("{0:6d}  {1:10.3e}  {2:10.3e}  {3:6.1f}".format(k, r["F"], r["G"],
                                                          t))


def _run_from_k1(step, cfg, prob, carry, maxitrs, F0, G0, header, verbose,
                 verbskip, chunk, checkpoint):
    """The k=0 row (computed by the caller) and iterations 1 <= k <
    maxitrs: ``(x, F, G, T)`` with the k=0 row first."""
    if verbose:
        print(header)
        _row(0, {"F": F0, "G": G0}, 0.0)
    if maxitrs <= 1:
        return carry["x"], np.array([F0]), np.array([G0]), np.zeros(1)
    carry, hist, T = run_driver(
        step, carry, maxitrs, verbose=verbose, verbskip=verbskip,
        header=None, print_row=_row, chunk=chunk, checkpoint=checkpoint,
        problem=prob, cfg=cfg, k_start=1)
    return (carry["x"], np.concatenate([[F0], hist["F"]]),
            np.concatenate([[G0], hist["G"]]), np.concatenate([[0.0], T]))


# ---------------------------------------------------------------------------
# AIBM
# ---------------------------------------------------------------------------


class _AIBMCfg(NamedTuple):
    stochastic: bool = False


def _aibm_init(prob, c):
    """AIBM's k=0 row (reference: algorithms.py:608-624), outside the
    loop: ``(carry, F0, L0)`` with L0 the adapted L."""
    f, h = prob["f"], prob["h"]
    key, sub = _rng.split(c["key"])
    delta = prob["noise"] * _rng.uniform(sub)
    x = h.prox_map(torch.zeros_like(c["x"]), 1.0)
    fx_t, g = f.value_and_grad(x)
    y = h.prox_map(g, 1.0)
    s = _read(fx=fx_t, gd=vdot(g, y - x), fy=f.value(y),
              dv=h.divergence(y, x), psi=h.extra_psi(x))
    ref = s["fx"] + s["gd"] + prob["eps"] + delta
    Lc, t = c["L"], 0
    while not s["fy"] <= ref + Lc * s["dv"] and t < _LS_MAX:
        Lc, t = Lc * 2.0, t + 1
    alpha = 1.0 / Lc
    F0 = s["fx"] + s["psi"]
    return (dict(done=False, key=key, x=x, y=y, z=x, L=Lc, A=alpha,
                 xi=alpha * g, F_prev=F0), F0, Lc)


def _aibm_step(cfg, prob, c, k):
    f, h = prob["f"], prob["h"]
    gamma, p = prob["gamma"], 2.0
    key, sub = _rng.split(c["key"])
    delta = prob["noise"] * _rng.uniform(sub)
    y, z, xi, A = c["y"], c["z"], c["xi"], c["A"]
    grow = power(1.0 + float(k) / (2.0 * p), (p - 1.0) * (gamma - 1.0))

    def trial(Lt, tkey):
        alpha = (1.0 / Lt) * grow
        B = power(Lt * power(alpha, gamma), 1.0 / (gamma - 1.0))
        r = div(alpha, B)
        x_t = r * z + (1.0 - r) * y
        tkey, (fx_t, grad_x) = _trial_draw(cfg, f.value_and_grad, x_t, tkey)
        xi_t = xi + alpha * grad_x
        z_k = h.prox_map(xi_t, 1.0)
        w = r * z_k + (1.0 - r) * y
        s = _read(fx=fx_t, fw=f.value(w), gd=vdot(grad_x, w - x_t),
                  dv=h.divergence(w, x_t), psi=h.extra_psi(x_t))
        ok = s["fw"] <= s["fx"] + s["gd"] + Lt * s["dv"] + delta
        return dict(s, L=Lt, alpha=alpha, B=B, x=x_t, xi=xi_t, z_k=z_k, w=w,
                    ok=ok, key=tkey)

    s = trial(c["L"] / 2.0, key if cfg.stochastic else None)
    t = 0
    while not s["ok"] and t < _LS_MAX:
        t += 1
        s = trial(s["L"] * 2.0, s["key"])

    Fk = s["fx"] + s["psi"]
    A_new = A + s["alpha"]
    y_new = (s["B"] / A_new) * s["w"] + (1.0 - s["B"] / A_new) * y
    c2 = dict(done=c["done"], key=s["key"] if cfg.stochastic else key,
              x=s["x"], y=y_new, z=s["z_k"], L=s["L"], A=A_new, xi=s["xi"],
              F_prev=Fk)
    return c2, dict(F=Fk, G=0.0, _stop=abs(Fk - c["F_prev"]) < 1e-9)


def AIBM(f, h, L, x0, gamma, maxitrs, epsilon=1e-14, verbose=True, noise=0,
         verbskip=1, seed=0, chunk=None, checkpoint=None):
    """Adaptive Intermediate Bregman Method with inexact oracle noise delta:
    doubling-L inner loop with certificate
    f(w) <= f(x) + <grad f(x), w-x> + L D(w,x) + delta, interpolation p=2
    (reference: algorithms.py:593-658).  Returns ``(x, F, G, T)``; as in the
    reference G is zero except G[0] which records the initial adapted L.
    ``x`` is a float64 tensor on the f-oracle's device, the histories
    numpy arrays.  ``noise`` scales the uniform draws of delta, one per
    iteration from the chain seeded by ``seed``.
    """
    x0 = _start(f, x0)
    prob = dict(f=f, h=h, gamma=float(gamma), eps=float(epsilon),
                noise=float(noise))
    carry = dict(done=False, key=_rng.key(seed), x=x0, y=x0, z=x0,
                 L=float(L), A=0.0, xi=torch.zeros_like(x0),
                 F_prev=math.inf)
    carry, F0, G0 = _aibm_init(prob, carry)
    header = ("\nAIBM method for min_{x in C} F(x) = f(x) + Psi(x)\n"
              "     k      F(x)       L       time")
    cfg = _AIBMCfg(stochastic=bool(getattr(f, "stochastic", False)))
    return _run_from_k1(_aibm_step, cfg, prob, carry, maxitrs, F0, G0,
                        header, verbose, verbskip, chunk, checkpoint)


# ---------------------------------------------------------------------------
# AdaptFGM / UniversalGM
# ---------------------------------------------------------------------------


class _FGMCfg(NamedTuple):
    universal: bool
    stochastic: bool = False


def _fgm_step(cfg, prob, c, k):
    """Shared engine for AdaptFGM (reference: algorithms.py:661-714) and
    UniversalGM (:717-777).  They differ in where the noise enters (the
    certificate's slack, or g_y and f(y)) and in the acceptance test's left
    anchor (f(x_k) or f(y))."""
    f, h = prob["f"], prob["h"]
    key, sub = _rng.split(c["key"])
    nz = prob["noise"] * _rng.uniform(sub)
    x_k, u_k, A_k = c["x"], c["u"], c["A"]
    # AdaptFGM's anchor f(x_k) is the same in every trial: computed once
    fxk = None if cfg.universal else f.value(x_k)

    def trial(Lt, tkey):
        alpha = (1.0 + math.sqrt(1.0 + 4.0 * Lt * A_k)) / (2.0 * Lt)
        A = Lt * (alpha * alpha)
        y = (alpha * u_k + A_k * x_k) / A
        tkey, g_y = _trial_draw(cfg, f.grad, y, tkey)
        if cfg.universal:
            g_y = g_y + nz
        u = h.div_prox_map(u_k, g_y * alpha, 1.0)
        x = (alpha * u + A_k * x_k) / A
        q = dict(fx=f.value(x), gd=vdot(g_y, x - y), dv=h.divergence(x, y),
                 psi=h.extra_psi(x))
        q.update(fy=f.value(y)) if cfg.universal else q.update(fxk=fxk)
        s = _read(**q)
        if cfg.universal:
            anchor, slack = s["fy"] + nz, 0.0
        else:
            anchor, slack = s["fxk"], nz
        ok = s["fx"] <= anchor + s["gd"] + Lt * s["dv"] + slack
        return dict(s, L=Lt, A=A, u=u, x=x, ok=ok, key=tkey)

    s = trial(c["L"] / 2.0, key if cfg.stochastic else None)
    t = 0
    while not s["ok"] and t < _LS_MAX:
        t += 1
        s = trial(s["L"] * 2.0, s["key"])

    # f(x) of the accepted trial is the JAX step's f.value(s["x"])
    Fk = s["fx"] + s["psi"]
    c2 = dict(done=c["done"], key=s["key"] if cfg.stochastic else key,
              x=s["x"], u=s["u"], A=s["A"], L=s["L"], F_prev=Fk)
    return c2, dict(F=Fk, G=s["L"],
                    _stop=abs(Fk - c["F_prev"]) < prob["eps"])


def _fgm_like(f, h, L, x0, maxitrs, epsilon, verbose, noise, verbskip, seed,
              chunk, universal, header, checkpoint=None):
    x0 = _start(f, x0)
    ones = torch.ones_like(x0)
    prob = dict(f=f, h=h, eps=float(epsilon), noise=float(noise))
    x_init = x0 if universal else ones
    # the k=0 row (reference: algorithms.py:680-684) consumes one noise
    # draw that it does not use; so does the JAX driver, and so here
    key, _ = _rng.split(_rng.key(seed))
    (F0,) = read(f.value(x_init) + h.extra_psi(x_init))
    carry = dict(done=False, key=key, x=x_init, u=ones, A=0.0, L=float(L),
                 F_prev=F0)
    cfg = _FGMCfg(universal=bool(universal),
                  stochastic=bool(getattr(f, "stochastic", False)))
    return _run_from_k1(_fgm_step, cfg, prob, carry, maxitrs, F0, float(L),
                        header, verbose, verbskip, chunk, checkpoint)


def AdaptFGM(f, h, L, x0, maxitrs, epsilon=1e-14, verbose=True, noise=0,
             verbskip=1, seed=0, chunk=None, checkpoint=None):
    """Adaptive fast gradient method with halve-L-outer / double-L-inner
    adaptation and inexact-oracle slack (reference: algorithms.py:661-714).
    Every sequence starts at the all-ones vector.  Returns
    ``(x, F, G, T)``."""
    header = ("\nAdaptFGM method for min_{x in C} F(x) = f(x) + Psi(x)\n"
              "     k      F(x)       L       time")
    return _fgm_like(f, h, L, x0, maxitrs, epsilon, verbose, noise, verbskip,
                     seed, chunk, universal=False, header=header,
                     checkpoint=checkpoint)


def UniversalGM(f, h, L, x0, maxitrs, epsilon=1e-14, verbose=True,
                noise_level=0, verbskip=1, seed=0, chunk=None,
                checkpoint=None):
    """Universal gradient method: same alpha/A scheme with additive noise
    injected into g_y and f(y) (reference: algorithms.py:717-777).
    Returns ``(x, F, G, T)``."""
    header = ("\nUniversalGM method for min_{x in C} F(x) = f(x) + Psi(x)\n"
              "     k      F(x)       L       time")
    return _fgm_like(f, h, L, x0, maxitrs, epsilon, verbose, noise_level,
                     verbskip, seed, chunk, universal=True, header=header,
                     checkpoint=checkpoint)


# ---------------------------------------------------------------------------
# Primal-dual switching gradient method
# ---------------------------------------------------------------------------


class _PDCfg(NamedTuple):
    linesearch: bool
    dual_max_inner: int
    exact_dual_grad: bool = False


def _dual_value(cfg, prob, z, y0):
    """The duality gap's dual term: up to ``dual_max_inner`` projected
    ascent steps from ``y0`` while the step moves by at least ``dual_tol``
    (reference: algorithms.py:833-851), then -f(y) - z sum(g(y)); a host
    float.

    The ascent direction is the reference's arithmetic verbatim: for a
    vector constraint it broadcasts ``z_vec[:, None] * g.gradient(y)`` and
    sums over axis 0, which for an ``AX_b`` constraint (gradient the
    constant A) is ``len(g(y)) z A``, not the gradient of z sum(g).
    ``exact_dual_grad`` takes that gradient instead, by autograd.

    The steps run in blocks of ``DUAL_BLOCK``; once the exit test has
    fired, y freezes, so y is the iterate the JAX loop stops at."""
    f, g_fun = prob["f"], prob["cnstrnt"]
    dual_tol, dual_lr = prob["dual_tol"], prob["dual_lr"]
    scalar_cnstrnt = g_fun.value(y0).dim() == 0

    def ascent_dir(y):
        if cfg.exact_dual_grad and not scalar_cnstrnt:
            yy = y.detach().requires_grad_(True)
            with torch.enable_grad():
                (gs,) = torch.autograd.grad(torch.sum(g_fun.value(yy)), yy)
            return -f.grad(y) - z * gs
        gg = g_fun.grad(y)
        if scalar_cnstrnt:
            return -f.grad(y) - z * gg
        z_vec = z * torch.ones_like(g_fun.value(y))
        return -f.grad(y) - torch.sum(z_vec[:, None] * gg, dim=0)

    y = y0
    diff = torch.full((), math.inf, dtype=y0.dtype, device=y0.device)
    ran = 0
    while ran < cfg.dual_max_inner:
        steps = min(DUAL_BLOCK, cfg.dual_max_inner - ran)
        for _ in range(steps):
            live = diff >= dual_tol
            y_next = torch.clamp_min(y + dual_lr * ascent_dir(y), 1e-6)
            diff = torch.where(live, torch.linalg.vector_norm(y_next - y),
                               diff)
            y = torch.where(live, y_next, y)
        ran += steps
        if ran >= cfg.dual_max_inner or not bool(diff >= dual_tol):
            break
    (dual,) = read(-f.value(y) - z * torch.sum(g_fun.value(y)))
    return dual


def _pd_step(cfg, prob, c, k):
    f, h, g_fun = prob["f"], prob["h"], prob["cnstrnt"]
    x = c["x"]
    fx_t, grad_fx = f.value_and_grad(x)
    s = _read(fx=fx_t, psi=h.extra_psi(x),
              prod=torch.all(g_fun.value(x) <= prob["eps"]))
    fx, productive = s["fx"], bool(s["prod"])

    if productive:
        # only the branch taken runs (JAX computes both and selects: the
        # values are the same)
        if cfg.linesearch:
            def trial(Lt):
                x_new = h.div_prox_map(x, grad_fx, Lt)
                q = _read(f1=f.value(x_new), gd=vdot(grad_fx, x_new - x),
                          dv=h.divergence(x_new, x),
                          bad=~torch.all(torch.isfinite(x_new)))
                ok = q["f1"] <= fx + q["gd"] + Lt * q["dv"] and not q["bad"]
                return x_new, ok

            L_new, t = c["L"] / 2.0, 0
            x_new, ok = trial(L_new)
            while not ok and t < _LS_MAX:
                L_new, t = L_new * 2.0, t + 1
                x_new, ok = trial(L_new)
        else:
            L_new = c["L"]
            x_new = h.div_prox_map(x, grad_fx, L_new)
        Lk = 1.0 / L_new
        c2 = dict(done=c["done"], x=x_new, L=L_new,
                  prod_sum=c["prod_sum"] + Lk, unprod_sum=c["unprod_sum"])
    else:
        grad_g = g_fun.grad(x)
        sz = div(0.1, read(vdot(grad_g, grad_g))[0])
        c2 = dict(done=c["done"], x=torch.clamp_min(x - grad_g * sz, 1e-6),
                  L=c["L"], prod_sum=c["prod_sum"],
                  unprod_sum=c["unprod_sum"] + sz)
        Lk = 0.0

    lam = (c2["unprod_sum"] / c2["prod_sum"]
           if c2["prod_sum"] > 0 and c2["unprod_sum"] > 0 else 1.0)
    gap = fx + _dual_value(cfg, prob, lam, c2["x"])
    stop = k > 0 and abs(gap) < prob["gap_tol"]
    return c2, dict(F=fx + s["psi"], productive=productive, gap=gap, Ls=Lk,
                    _stop=stop)


def PrimalDualSwitchingGradientMethod(f, h, L_init, cnstrnt_fun, x0, maxitrs,
                                      epsilon=1e-14, linesearch=True,
                                      verbose=True, verbskip=100, chunk=None,
                                      dual_max_inner=100, dual_tol=1e-9,
                                      dual_lr=1e-3, gap_tol=1e-6,
                                      checkpoint=None, exact_dual_grad=False):
    """Constrained min f(x) s.t. cnstrnt_fun(x) <= epsilon via switching
    between productive (objective) and unproductive (constraint-gradient)
    steps, with a Lagrange-multiplier estimate and a duality gap from an
    inner gradient-ascent solve (reference: algorithms.py:780-968).

    Returns ``(F, duality_gaps, Ls)``, numpy arrays: F holds the objective
    values of the *productive* iterations only, the other two are
    per-iteration, all truncated at the |gap| < ``gap_tol`` stopping
    iteration (inclusive).  The inner ascent keeps the reference's
    arithmetic for vector constraints (see ``_dual_value``);
    ``exact_dual_grad=True`` takes the true gradient of z sum(g) instead.
    As in JAX, NaN iterates propagate to the gap history instead of
    raising.
    """
    x0 = _start(f, x0)
    prob = dict(f=f, h=h, cnstrnt=cnstrnt_fun, eps=float(epsilon),
                gap_tol=float(gap_tol), dual_tol=float(dual_tol),
                dual_lr=float(dual_lr))
    carry = dict(done=False, x=x0, L=float(L_init), prod_sum=0.0,
                 unprod_sum=0.0)
    header = ("\n Primal-Dual method\n"
              "     k       F(x)         L_k       duality_gap     time")

    def row(k, r, t):
        if not bool(r["productive"]):
            return
        print(f"{k:6d}  {r['F']:.3e}  {r['Ls']:.3e}  {r['gap']:.3e}  "
              f"{t:.2f}s")

    cfg = _PDCfg(linesearch=bool(linesearch),
                 dual_max_inner=int(dual_max_inner),
                 exact_dual_grad=bool(exact_dual_grad))
    carry, hist, T = run_driver(
        _pd_step, carry, maxitrs, verbose=verbose, verbskip=verbskip,
        header=header, print_row=row, chunk=chunk, checkpoint=checkpoint,
        problem=prob, cfg=cfg)
    F = hist["F"][hist["productive"].astype(bool)]
    return np.asarray(F), hist["gap"], hist["Ls"]
