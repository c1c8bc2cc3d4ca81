"""Inexact-oracle and constrained methods: AIBM, AdaptFGM, UniversalGM,
PrimalDualSwitchingGradientMethod.

Port of ``accbpg_and_fw_tpu/algorithms/extras.py`` (reference:
accbpg/algorithms.py:593-968): the same math, signatures, return tuples,
printed tables and checkpoints (the JAX fingerprints, carry keys and
history names).

Every step is JAX's device-scalar step, as ``bpg.py``'s and ``fw.py``'s
are: the carry is all tensors on the solve's device (``done`` a bool; L,
A, alpha, F_prev, the primal-dual sums 0-d float64; the noise key
``_rng``'s int64[2] words), the problem's numbers are 0-d float64 tensors
there too, and JAX's branches are ``torch.where`` selects of its
expressions in its order.  The doubling line searches are
``_loops.device_while`` loops with JAX's bound (``_LS_MAX``; the trial
kept at the bound is JAX's), and so is the primal-dual driver's inner
dual ascent (bound ``dual_max_inner``).  On the card a chunk is replays
of a CUDA graph (``driver.py``) whose loops run as a fixed number of
masked bodies (``AIBM_BODIES``, ``ADAPT_BODIES``, ``UNIVERSAL_BODIES``,
``PD_BODIES``, and the ascent's whole bound), with one read per chunk; an iteration whose line
search needs more bodies runs again eagerly.  Eagerly (the CPU,
``driver.eager_chunks``) each loop reads its exit test once per turn.

The inexact-oracle noise is JAX's: one ``_rng.split_uniform`` of the
carried key per iteration, scaled by the noise (one kernel launch on the
card), and a stochastic f-oracle's draw keys split per trial, as the JAX
drivers split theirs (each trial's split and noisy gradient one launch,
``bpg._keyed``).  The primal-dual driver computes both of JAX's branches
and selects leaf by leaf; its productive line search runs only while the
iterate is productive (the other branch's values are the ones kept).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _rng
from .._loops import device_while
from .._scalar import read
from ..ops.base import vdot
from .bpg import (_device_carry, _num, _past_first, _scalars, _start,
                  _trial_draw)
from .driver import _sharded_scope, run_driver

_LS_MAX = 64  # doubling line searches multiply L by 2^t; 2^64 is past overflow

# Masked bodies of the line searches in a graph chunk: the trials after the
# first (see ``bpg.py``).  An iteration that needs more runs again eagerly,
# and the rest of its span replays frozen, which costs more than a few
# masked trials save: AIBM's 500 Poisson iterations took 1.64 s at 3
# bodies (20 continuations) against 0.52 s at 5 (1).  Chosen from the
# bodies the extras of PERF.md took under ``eager_chunks`` on the card
# (``chip_smoke.py --bodies``): AIBM 0-5 trials after the first on the
# 2000x1000 Poisson problem and once 7, UniversalGM 0-6, AdaptFGM 0-5 but
# 19 in a third of its iterations (and once the bound), the primal-dual
# line search 0-4.
AIBM_BODIES = 5
ADAPT_BODIES = 19
UNIVERSAL_BODIES = 6
PD_BODIES = 4
# The inner dual ascent's masked bodies: None for its whole bound
# (``dual_max_inner``), which it nearly always runs to, so that it never
# overflows.
DUAL_BODIES = None
# Iterations a captured graph holds; a chunk replays it back to back.
GRAPH_SPAN = 32
PD_GRAPH_SPAN = 8


def _row(k, r, t):
    print("{0:6d}  {1:10.3e}  {2:10.3e}  {3:6.1f}".format(k, r["F"], r["G"],
                                                          t))


def _run_from_k1(step, cfg, prob, carry, maxitrs, F0, G0, header, verbose,
                 verbskip, chunk, checkpoint):
    """The k=0 row (``F0``, ``G0`` 0-d tensors computed by the caller, read
    here once) and iterations 1 <= k < maxitrs: ``(x, F, G, T)`` with the
    k=0 row first."""
    F0, G0 = read(F0, G0)
    if verbose:
        print(header)
        _row(0, {"F": F0, "G": G0}, 0.0)
    if maxitrs <= 1:
        return carry["x"], np.array([F0]), np.array([G0]), np.zeros(1)
    carry, hist, T = run_driver(
        step, carry, maxitrs, verbose=verbose, verbskip=verbskip,
        header=None, print_row=_row, chunk=chunk, checkpoint=checkpoint,
        problem=prob, cfg=cfg, k_start=1, graph_span=GRAPH_SPAN)
    return (carry["x"], np.concatenate([[F0], hist["F"]]),
            np.concatenate([[G0], hist["G"]]), np.concatenate([[0.0], T]))


def _k_float(k, like):
    """The iteration ``k`` as a 0-d float64 tensor: a graph chunk's int64
    tensor converted, an eager chunk's host int filled on the device."""
    if isinstance(k, torch.Tensor):
        return k.to(torch.float64)
    return _num(like, float(k))


def _noise_draw(prob, c):
    """The iteration's ``(next key, noise * uniform)``: JAX's split of the
    carried key, its uniform draw and the product, in one launch on the
    card."""
    key, _, delta = _rng.split_uniform(c["key"], scale=prob["noise"])
    return key, delta


# ---------------------------------------------------------------------------
# AIBM
# ---------------------------------------------------------------------------


class _AIBMCfg(NamedTuple):
    stochastic: bool = False


def _aibm_init(prob, c):
    """AIBM's k=0 row (reference: algorithms.py:608-624), run once outside
    the loop, eagerly, through the same ``device_while`` as the steps:
    ``(carry, F0, L0)`` with L0 the adapted L (0-d tensors)."""
    f, h = prob["f"], prob["h"]
    key, delta = _noise_draw(prob, c)
    x = h.prox_map(torch.zeros_like(c["x"]), 1.0)
    fx, g = f.value_and_grad(x)
    y = h.prox_map(g, 1.0)
    ref = fx + vdot(g, y - x) + prob["eps"] + delta
    fy, dv = f.value(y), h.divergence(y, x)
    (Lc,) = device_while(lambda s: ~(fy <= ref + s[0] * dv),
                         lambda s: (s[0] * 2.0,), (c["L"],), _LS_MAX,
                         AIBM_BODIES, "AIBM k=0 trials")
    alpha = 1.0 / Lc
    F0 = fx + h.extra_psi(x)
    return (dict(done=c["done"], key=key, x=x, y=y, z=x, L=Lc, A=alpha,
                 xi=alpha * g, F_prev=F0), F0, Lc)


def _aibm_step(cfg, prob, c, k):
    f, h = prob["f"], prob["h"]
    gamma, p = prob["gamma"], 2.0
    key, delta = _noise_draw(prob, c)
    y, z, xi, A = c["y"], c["z"], c["xi"], c["A"]
    kf = _k_float(k, A)
    grow = (1.0 + kf / (2.0 * p)) ** ((p - 1.0) * (gamma - 1.0))

    def trial(Lt, tkey):
        alpha = (1.0 / Lt) * grow
        B = (Lt * alpha ** gamma) ** (1.0 / (gamma - 1.0))
        r = alpha / B
        x_t = r * z + (1.0 - r) * y
        tkey, (fx_t, grad_x) = _trial_draw(cfg, f, x_t, tkey)
        xi_t = xi + alpha * grad_x
        z_k = h.prox_map(xi_t, 1.0)
        w = r * z_k + (1.0 - r) * y
        fail = ~(f.value(w) <= fx_t + vdot(grad_x, w - x_t)
                 + Lt * h.divergence(w, x_t) + delta)
        s = dict(L=Lt, alpha=alpha, B=B, x=x_t, fx=fx_t, xi=xi_t, z_k=z_k,
                 w=w, fail=fail)
        if cfg.stochastic:
            s["key"] = tkey
        return s

    s = trial(c["L"] / 2.0, key if cfg.stochastic else None)
    s = device_while(lambda s: s["fail"],
                     lambda s: trial(s["L"] * 2.0, s.get("key")), s,
                     _LS_MAX, AIBM_BODIES, "AIBM trials")

    Fk = s["fx"] + h.extra_psi(s["x"])
    A_new = A + s["alpha"]
    y_new = (s["B"] / A_new) * s["w"] + (1.0 - s["B"] / A_new) * y
    c2 = dict(done=c["done"], key=s.get("key", key), x=s["x"], y=y_new,
              z=s["z_k"], L=s["L"], A=A_new, xi=s["xi"], F_prev=Fk)
    return c2, dict(F=Fk, G=torch.zeros_like(Fk),
                    _stop=torch.abs(Fk - c["F_prev"]) < 1e-9)


def AIBM(f, h, L, x0, gamma, maxitrs, epsilon=1e-14, verbose=True, noise=0,
         verbskip=1, seed=0, chunk=None, checkpoint=None):
    """Adaptive Intermediate Bregman Method with inexact oracle noise delta:
    doubling-L inner loop with certificate
    f(w) <= f(x) + <grad f(x), w-x> + L D(w,x) + delta, interpolation p=2
    (reference: algorithms.py:593-658).  Returns ``(x, F, G, T)``; as in the
    reference G is zero except G[0] which records the initial adapted L.
    ``x`` is a float64 tensor on the f-oracle's device, the histories
    numpy arrays.  ``noise`` scales the uniform draws of delta, one per
    iteration from JAX's chain seeded by ``seed``.
    """
    x0 = _start(f, x0)
    prob = dict(f=f, h=h, **_scalars(x0, gamma=gamma, eps=epsilon,
                                     noise=noise))
    carry = _device_carry(x0, key=_rng.key(seed, x0.device), y=x0, z=x0,
                          L=L, A=0.0, xi=torch.zeros_like(x0),
                          F_prev=float("inf"))
    with _sharded_scope(carry):  # the steps' rule for a sharded carry
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
    key, nz = _noise_draw(prob, c)
    x_k, u_k, A_k = c["x"], c["u"], c["A"]
    # AdaptFGM's anchor f(x_k) is the same in every trial: computed once
    fxk = None if cfg.universal else f.value(x_k)
    zero = torch.zeros_like(A_k)

    def trial(Lt, tkey):
        alpha = (1.0 + torch.sqrt(1.0 + 4.0 * Lt * A_k)) / (2.0 * Lt)
        A = Lt * (alpha * alpha)
        y = (alpha * u_k + A_k * x_k) / A
        tkey, g_y = _trial_draw(cfg, f, y, tkey, value=False)
        if cfg.universal:
            g_y = g_y + nz
        u = h.div_prox_map(u_k, g_y * alpha, 1.0)
        x = (alpha * u + A_k * x_k) / A
        if cfg.universal:
            anchor, slack = f.value(y) + nz, zero
        else:
            anchor, slack = fxk, nz
        fx = f.value(x)
        fail = ~(fx <= anchor + vdot(g_y, x - y) + Lt * h.divergence(x, y)
                 + slack)
        s = dict(L=Lt, A=A, u=u, x=x, fx=fx, fail=fail)
        if cfg.stochastic:
            s["key"] = tkey
        return s

    s = trial(c["L"] / 2.0, key if cfg.stochastic else None)
    s = device_while(lambda s: s["fail"],
                     lambda s: trial(s["L"] * 2.0, s.get("key")), s, _LS_MAX,
                     UNIVERSAL_BODIES if cfg.universal else ADAPT_BODIES,
                     "FGM trials")

    # f(x) of the accepted trial is the JAX step's f.value(s["x"])
    Fk = s["fx"] + h.extra_psi(s["x"])
    c2 = dict(done=c["done"], key=s.get("key", key), x=s["x"], u=s["u"],
              A=s["A"], L=s["L"], F_prev=Fk)
    return c2, dict(F=Fk, G=s["L"],
                    _stop=torch.abs(Fk - c["F_prev"]) < prob["eps"])


def _fgm_like(f, h, L, x0, maxitrs, epsilon, verbose, noise, verbskip, seed,
              chunk, universal, header, checkpoint=None):
    x0 = _start(f, x0)
    ones = torch.ones_like(x0)
    prob = dict(f=f, h=h, **_scalars(x0, eps=epsilon, noise=noise))
    x_init = x0 if universal else ones
    # the k=0 row (reference: algorithms.py:680-684) consumes one noise
    # draw that it does not use; so does the JAX driver, and so here
    key, _ = _rng.split(_rng.key(seed, x0.device))
    with _sharded_scope(dict(x=x_init)):  # the steps' rule for a shard
        F0 = f.value(x_init) + h.extra_psi(x_init)
    carry = _device_carry(x_init, key=key, u=ones, A=0.0, L=L, F_prev=F0)
    cfg = _FGMCfg(universal=bool(universal),
                  stochastic=bool(getattr(f, "stochastic", False)))
    return _run_from_k1(_fgm_step, cfg, prob, carry, maxitrs, F0,
                        carry["L"], header, verbose, verbskip, chunk,
                        checkpoint)


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
    (reference: algorithms.py:833-851), then -f(y) - z sum(g(y)); a 0-d
    tensor.

    The ascent direction is the reference's arithmetic verbatim: for a
    vector constraint it broadcasts ``z_vec[:, None] * g.gradient(y)`` and
    sums over axis 0, which for an ``AX_b`` constraint (gradient the
    constant A) is ``len(g(y)) z A``, not the gradient of z sum(g).
    ``exact_dual_grad`` takes that gradient instead, by autograd."""
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

    def body(s):
        y, _ = s
        y_next = torch.clamp_min(y + dual_lr * ascent_dir(y), 1e-6)
        return y_next, torch.linalg.vector_norm(y_next - y)

    bodies = cfg.dual_max_inner if DUAL_BODIES is None else DUAL_BODIES
    y, _ = device_while(lambda s: s[1] >= dual_tol, body,
                        (y0, torch.full_like(dual_tol, torch.inf)),
                        cfg.dual_max_inner, bodies, "dual ascent")
    return -f.value(y) - z * torch.sum(g_fun.value(y))


def _pd_step(cfg, prob, c, k):
    f, h, g_fun = prob["f"], prob["h"], prob["cnstrnt"]
    x, L = c["x"], c["L"]
    fx, grad_fx = f.value_and_grad(x)
    productive = torch.all(g_fun.value(x) <= prob["eps"])

    # the productive branch (JAX computes both branches and selects; its
    # line search runs here only while productive: the values of a branch
    # that is not taken are never kept)
    if cfg.linesearch:
        def trial(Lt):
            x_new = h.div_prox_map(x, grad_fx, Lt)
            fail = ~(f.value(x_new) <= fx + vdot(grad_fx, x_new - x)
                     + Lt * h.divergence(x_new, x))
            bad = ~torch.all(torch.isfinite(x_new))
            return Lt, x_new, fail | bad

        L_new, x_prod, _ = device_while(
            lambda s: s[2] & productive, lambda s: trial(s[0] * 2.0),
            trial(L / 2.0), _LS_MAX, PD_BODIES, "primal-dual trials")
    else:
        L_new, x_prod = L, h.div_prox_map(x, grad_fx, L)
    step_size = 1.0 / L_new

    # the unproductive branch
    grad_g = g_fun.grad(x)
    gg = vdot(grad_g, grad_g)
    # a true division (a number over a tensor multiplies by its reciprocal)
    sz = torch.div(torch.full_like(gg, 0.1), gg)
    x_unprod = torch.clamp_min(x - grad_g * sz, 1e-6)

    def pick(a, b):
        return torch.where(productive, a, b)

    c2 = dict(done=c["done"], x=pick(x_prod, x_unprod),
              L=pick(L_new, L),
              prod_sum=pick(c["prod_sum"] + step_size, c["prod_sum"]),
              unprod_sum=pick(c["unprod_sum"], c["unprod_sum"] + sz))
    Lk = pick(step_size, torch.zeros_like(step_size))
    ps, us = c2["prod_sum"], c2["unprod_sum"]
    lam = torch.where((ps > 0) & (us > 0), us / ps, torch.ones_like(ps))
    gap = fx + _dual_value(cfg, prob, lam, c2["x"])
    stop = _past_first(k, torch.abs(gap) < prob["gap_tol"])
    return c2, dict(F=fx + h.extra_psi(x), productive=productive, gap=gap,
                    Ls=Lk, _stop=stop)


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
    prob = dict(f=f, h=h, cnstrnt=cnstrnt_fun,
                **_scalars(x0, eps=epsilon, gap_tol=gap_tol,
                           dual_tol=dual_tol, dual_lr=dual_lr))
    carry = _device_carry(x0, L=L_init, prod_sum=0.0, unprod_sum=0.0)
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
        problem=prob, cfg=cfg, graph_span=PD_GRAPH_SPAN)
    F = hist["F"][hist["productive"].astype(bool)]
    return np.asarray(F), hist["gap"], hist["Ls"]
