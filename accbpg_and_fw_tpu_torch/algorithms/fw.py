"""Frank-Wolfe family: Bregman-divergence steps and (L0,L1)-smooth step rules.

Port of ``accbpg_and_fw_tpu/algorithms/fw.py`` (reference:
accbpg/algorithms_fw.py): the same math, signatures, return tuples,
printed tables and checkpoints.  The LMO is a closure ``g -> s`` from
``ops/lmo.py``.

The four drivers with a line search (``FW_alg_div_step``,
``FW_alg_L0_L1_shortest_step``, ``FW_l0l1_log_and_linear_step`` and
``FW_l0l1_log_only``) keep their scalar recurrences on the host in Python
floats, as ``algorithms/bpg.py`` does; the vectors (x, g, s, d, the trial
iterate) stay on the device.  An iteration's first trial computes its step
on the device, from the device's <g, d>, D_h(s, x) and norms, and ends in
one read of everything the host decides on (f(x), Psi(x), <g, d>,
D_h(s, x), the norms, the step and f of the trial point).  Every later
trial computes its step on the host and reads f of its trial point back.
So an iteration costs one host sync per trial on the card, and the host
decides with the JAX expressions in the JAX order.

``FW_alg_descent_step`` has no line search: its stop test stays a device
flag, and a chunk of iterations reads nothing back; on the card the chunk
is a CUDA graph, its step 2/(k+2) computed on the card from the graph's
``k`` (the ``"graph"`` chunk mode of ``driver.py``).

Where the JAX drivers record a ``bad`` flag (the LMO returned a direction
with <g, d> > delta) and raise after the run, the port raises the same
``ValueError`` as soon as the host reads it, before any host step is
computed from it.  Checkpoints use the JAX fingerprints, carry keys and
history names, so a run saved by either package resumes in the other.
``FW_alg_div_step`` and ``FW_alg_descent_step`` give a stochastic
f-oracle a fresh draw key per gradient from their ``seed``, as the JAX
drivers do; the three (L0,L1) drivers pass none, as there.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import _scalar
from ..ops.base import fnorm, vdot
from .bpg import _accept_delta, _draw, _read, _start, _stoch_carry
from .driver import run_driver

_LS_MAX = 200
_LN2 = math.log(2.0)


class _OnHost:
    """The trial's scalar operations on Python floats (IEEE doubles, NaN
    and inf where JAX gives them)."""
    div = staticmethod(_scalar.div)
    power = staticmethod(_scalar.power)
    log = staticmethod(_scalar.log)
    minimum = staticmethod(_scalar.minimum)

    @staticmethod
    def where(cond, a, b):
        return a if cond else b


class _OnDevice:
    """The same operations on 0-d tensors (a number as the second operand
    of ``minimum``)."""
    div = staticmethod(torch.div)
    power = staticmethod(torch.pow)
    log = staticmethod(torch.log)
    minimum = staticmethod(torch.clamp_max)
    where = staticmethod(torch.where)


def _gdp_banded(g, d, delta):
    """<g,d> with the reference's band-zeroing: values in (0, delta] -> 0
    (a device scalar; the host reads it with the rest of the trial)."""
    gdp = vdot(g, d)
    return torch.where((gdp > 0) & (gdp <= delta), 0.0, gdp)


def _raise_if_bad(gdp):
    if gdp > 0:
        raise ValueError("grad_d_prod must be non-positive (LMO issue).")


def _direction(cfg, h, x, g, delta):
    """The LMO vertex s, d = s - x and the device scalars <g,d> (banded)
    and D_h(s, x) (0 replaced by ``delta``)."""
    s = cfg.lmo(g)
    d = s - x
    dv = h.divergence(s, x)
    return d, _gdp_banded(g, d, delta), torch.where(dv == 0, delta, dv)


def _run(step, cfg, prob, carry, maxitrs, header, row, verbose, verbskip,
         chunk, checkpoint):
    return run_driver(step, carry, maxitrs, verbose=verbose,
                      verbskip=verbskip, header=header, print_row=row,
                      chunk=chunk, checkpoint=checkpoint, problem=prob,
                      cfg=cfg)


# ---------------------------------------------------------------------------
# FW with Bregman divergence step
# ---------------------------------------------------------------------------


# The configs keep the JAX drivers' names and fields (their type names are
# the checkpoint fingerprints).
class _FWDivCfg(NamedTuple):
    lmo: Any
    linesearch: bool
    stochastic: bool = False


def _div_alpha(o, gdp, Lt, dv, gamma):
    return o.minimum(o.power(o.div(-gdp, 2.0 * Lt * dv),
                             1.0 / (gamma - 1.0)), 1.0)


def _fw_div_step(cfg, prob, c, k):
    f, h = prob["f"], prob["h"]
    gamma, ls_ratio = prob["gamma"], prob["ls_ratio"]
    x, Lk = c["x"], c["L"]
    kc, (fx_t, g) = _draw(cfg, c, f.value_and_grad, x)
    d, gdp_t, dv_t = _direction(cfg, h, x, g, prob["delta"])

    Lt = Lk / ls_ratio if cfg.linesearch else Lk
    a_t = _div_alpha(_OnDevice, gdp_t, Lt, dv_t, gamma)
    x_new = x + a_t * d
    q = dict(fx=fx_t, psi=h.extra_psi(x), gdp=gdp_t, dv=dv_t, a=a_t)
    if cfg.linesearch:
        q["f1"] = f.value(x_new)
    q = _read(**q)
    fx, gdp, dv, a = q["fx"], q["gdp"], q["dv"], q["a"]
    _raise_if_bad(gdp)

    if cfg.linesearch:
        delta = _accept_delta(f, fx)
        f1, t = q["f1"], 0
        # NaN-robust acceptance: a NaN trial fails and L backs off
        while (not f1 <= (fx + a * gdp + _scalar.power(a, gamma) * Lt * dv
                          + delta) and t < _LS_MAX):
            Lt = Lt * ls_ratio
            a = _div_alpha(_OnHost, gdp, Lt, dv, gamma)
            x_new = x + a * d
            (f1,) = _scalar.read(f.value(x_new))
            t += 1
        Lk = Lt

    Fk = fx + q["psi"]
    stop = k > 0 and abs(Fk - c["F_prev"]) < prob["eps"]
    return (dict(done=c["done"], x=x_new, L=Lk, F_prev=Fk, **kc),
            dict(F=Fk, Ls=Lk, bad=False, _stop=stop))


def FW_alg_div_step(f, h, L, x0, maxitrs, gamma, lmo, epsilon=1e-14,
                    linesearch=True, ls_ratio=2, verbose=True, verbskip=1,
                    chunk=None, checkpoint=None, seed=None):
    """Frank-Wolfe with Bregman divergence step size

        alpha_k = min( (-<g,d> / (2 L D_h(s,x)))^{1/(gamma-1)}, 1 )

    and backtracking on L with acceptance
    f(x+ad) <= f(x) + a<g,d> + a^gamma L D  (reference: algorithms_fw.py:6-75).
    Returns ``(x, F, Ls, T)``: ``x`` a float64 tensor on the f-oracle's
    device, the histories numpy arrays.  ``seed`` seeds a stochastic
    f-oracle's noise (None as 0).
    """
    if ls_ratio < 1:
        raise ValueError("ls_ratio must be >= 1")
    if L <= 0:
        raise ValueError("Initial L must be positive")
    if epsilon <= 0:
        raise ValueError("epsilon must be positive")

    prob = dict(f=f, h=h, gamma=float(gamma), eps=float(epsilon), delta=1e-6,
                ls_ratio=float(ls_ratio))
    carry = dict(done=False, x=_start(f, x0), L=float(L),
                 F_prev=float("inf"))
    stoch = _stoch_carry(f, carry, seed)
    header = "\nFW adaptive algorithm\n     k      F(x)         Lk       time"

    def row(k, r, t):
        print("{0:6d}  {1:10.3e}  {2:10.3e}  {3:6.1f}".format(
            k, r["F"], r["Ls"], t))

    carry, hist, T = _run(_fw_div_step,
                          _FWDivCfg(lmo=lmo, linesearch=bool(linesearch),
                                    stochastic=stoch),
                          prob, carry, maxitrs, header, row, verbose,
                          verbskip, chunk, checkpoint)
    return carry["x"], hist["F"], hist["Ls"], T


# ---------------------------------------------------------------------------
# Classic descent-step FW
# ---------------------------------------------------------------------------


class _FWDescentCfg(NamedTuple):
    lmo: Any
    stochastic: bool = False


def _fw_descent_step(cfg, prob, c, k):
    f, h, eps = prob["f"], prob["h"], prob["eps"]
    d = cfg.lmo(c["g"]) - c["x"]
    # k: a host int, or in a graph chunk an int64 tensor on the card (JAX
    # passes a traced int32); IEEE division gives the same step either way
    kf = k.to(c["x"].dtype) if isinstance(k, torch.Tensor) else k
    alpha = 2.0 / (kf + 2.0)
    x = c["x"] + alpha * d
    kc, (fx, g) = _draw(cfg, c, f.value_and_grad, x)
    Fk = fx + h.extra_psi(x)
    stop = (torch.abs(Fk - c["F_prev"]) < eps) | (fnorm(g) < eps)
    return (dict(done=c["done"], x=x, g=g, F_prev=Fk, **kc),
            dict(F=Fk, alpha=alpha, _stop=stop))


def FW_alg_descent_step(f, h, x0, maxitrs, lmo, epsilon=1e-14, verbose=True,
                        verbskip=1, chunk=None, checkpoint=None, seed=None):
    """Classic Frank-Wolfe with the parameter-free step alpha_k = 2/(k+2)
    (reference: algorithms_fw.py:210-247).  Returns ``(x, F, T, G)``, the
    reference's (unusual) return order, with G an all-zeros placeholder.
    The k = 0 evaluation runs once before the loop, without noise (as in
    JAX); a chunk reads nothing back until its end.  ``seed`` seeds a
    stochastic f-oracle's noise (None as 0).
    """
    x0 = _start(f, x0)
    fx, g = f.value_and_grad(x0)
    F0 = fx + h.extra_psi(x0)
    carry = dict(done=torch.tensor(False, device=x0.device), x=x0, g=g,
                 F_prev=F0)
    F0 = float(F0)
    header = ("\nFW descent step size algorithm\n"
              "     k      F(x)         alpha_k       time")

    def row(k, r, t):
        print("{0:6d}  {1:10.3e}  {2:10.3e}  {3:6.1f}".format(
            k, r["F"], r["alpha"], t))

    if verbose:
        print(header)  # the reference prints no k=0 row for this driver
    if maxitrs <= 1:
        return carry["x"], np.array([F0]), np.zeros(1), np.zeros(1)
    cfg = _FWDescentCfg(lmo=lmo, stochastic=_stoch_carry(f, carry, seed))
    prob = dict(f=f, h=h, eps=float(epsilon))
    carry, hist, T = run_driver(
        _fw_descent_step, carry, maxitrs, verbose=verbose, verbskip=verbskip,
        header=None, print_row=row, chunk=chunk, checkpoint=checkpoint,
        problem=prob, cfg=cfg, k_start=1)
    F = np.concatenate([[F0], hist["F"]])
    T = np.concatenate([[0.0], T])
    return carry["x"], F, T, np.zeros_like(F)


# ---------------------------------------------------------------------------
# (L0,L1)-smooth shortest-step FW
# ---------------------------------------------------------------------------


class _FWL0L1Cfg(NamedTuple):
    lmo: Any
    linesearch: bool


def _shortest_alpha(o, L0t, L1t, g_norm, gdp, dv, gamma, e):
    a_k = L0t + L1t * g_norm
    return a_k, o.minimum(o.power(o.div(-gdp, a_k * dv * e),
                                  1.0 / (gamma - 1.0)), 1.0)


def _fw_l0l1_shortest_step(cfg, prob, c, k):
    f, h = prob["f"], prob["h"]
    gamma, ls_ratio, e = prob["gamma"], prob["ls_ratio"], prob["e_const"]
    x, L0t, L1t, tog = c["x"], c["L0"], c["L1"], c["toggle"]
    fx_t, g = f.value_and_grad(x)
    d, gdp_t, dv_t = _direction(cfg, h, x, g, prob["delta"])
    gn_t = fnorm(g)

    if cfg.linesearch:
        a_k0 = L0t + L1t * gn_t
        L0t = L0t / (ls_ratio + L0t / a_k0)
        L1t = L1t / (ls_ratio + (L1t * gn_t) / a_k0)
    a_k, a = _shortest_alpha(_OnDevice, L0t, L1t, gn_t, gdp_t, dv_t, gamma, e)
    x_new = x + a * d
    q = dict(fx=fx_t, psi=h.extra_psi(x), gdp=gdp_t, dv=dv_t, gn=gn_t,
             L0=L0t, L1=L1t, a_k=a_k, a=a)
    if cfg.linesearch:
        q["f1"] = f.value(x_new)
    q = _read(**q)
    fx, gdp, dv, gn = q["fx"], q["gdp"], q["dv"], q["gn"]
    _raise_if_bad(gdp)
    L0t, L1t, a_k, a = q["L0"], q["L1"], q["a_k"], q["a"]

    if cfg.linesearch:
        delta = _accept_delta(f, fx)
        f1, t = q["f1"], 0
        while (not f1 <= (fx + a * gdp
                          + _scalar.power(a, gamma) * (a_k / 2.0) * e * dv
                          + delta) and t < _LS_MAX):
            # the reference's alternating toggle: back off L0, then L1
            a_b = L0t + L1t * gn
            if tog == 0:
                L0t = L0t * (ls_ratio - _scalar.div(L0t, a_b))
            else:
                L1t = L1t * (ls_ratio - _scalar.div(L1t * gn, a_b))
            tog = 1 - tog
            t += 1
            a_k, a = _shortest_alpha(_OnHost, L0t, L1t, gn, gdp, dv, gamma, e)
            x_new = x + a * d
            (f1,) = _scalar.read(f.value(x_new))

    Fk = fx + q["psi"]
    stop = k > 0 and abs(Fk - c["F_prev"]) < prob["eps"]
    return (dict(done=c["done"], x=x_new, L0=L0t, L1=L1t, toggle=tog,
                 F_prev=Fk),
            dict(F=Fk, Ls=a_k, L0=L0t, L1=L1t, alpha=a, bad=False,
                 _stop=stop))


def FW_alg_L0_L1_shortest_step(f, h, L0, L1, x0, maxitrs, gamma, lmo,
                               epsilon=1e-14, linesearch=True, ls_ratio=2,
                               verbose=True, verbskip=1, chunk=None,
                               checkpoint=None):
    """Frank-Wolfe for (L0,L1)-smooth f with the shortest-step rule

        a_k = L0 + L1 ||g||,
        alpha_k = min( (-<g,d> / (a_k D(s,x) e))^{1/(gamma-1)}, 1 )

    and the reference's alternating-toggle line search on (L0, L1)
    (reference: algorithms_fw.py:78-207).  Returns ``(x, F, Ls, T)``.
    """
    if ls_ratio < 1:
        raise ValueError("ls_ratio must be >= 1")
    if L0 < 0 or L1 < 0:
        raise ValueError("Initial L must be positive")
    if epsilon <= 0:
        raise ValueError("epsilon must be positive")

    prob = dict(f=f, h=h, gamma=float(gamma), eps=float(epsilon), delta=1e-8,
                ls_ratio=float(ls_ratio), e_const=math.e)
    carry = dict(done=False, x=_start(f, x0), L0=float(L0), L1=float(L1),
                 toggle=0, F_prev=float("inf"))
    header = ("\nFW (L0,L1)-smooth algorithm with shortest-step rule\n"
              "     k        F(x)          a_k           L0            L1"
              "        alpha        time")

    def row(k, r, t):
        print("{0:6d}   {1:10.3e}   {2:10.3e}   {3:10.3e}   {4:10.3e}   "
              "{5:10.3e}   {6:6.1f}".format(k, r["F"], r["Ls"], r["L0"],
                                            r["L1"], r["alpha"], t))

    carry, hist, T = _run(_fw_l0l1_shortest_step,
                          _FWL0L1Cfg(lmo=lmo, linesearch=bool(linesearch)),
                          prob, carry, maxitrs, header, row, verbose,
                          verbskip, chunk, checkpoint)
    return carry["x"], hist["F"], hist["Ls"], T


# ---------------------------------------------------------------------------
# (L0,L1)-smooth log / log+linear step FW
# ---------------------------------------------------------------------------


class _FWLogCfg(NamedTuple):
    lmo: Any
    linesearch: bool
    log_only: bool


def _log_alpha(o, cfg, L0t, L1t, gx_norm, d_norm, gdp):
    """(a_k, alpha, whether the log branch was taken)."""
    a_k = L0t + L1t * gx_norm
    z1 = L1t * d_norm
    alpha_log = o.div(1.0, z1) * o.log(1.0 - o.div(L1t * gdp, a_k * d_norm))
    alpha_lin = o.div(L1t * (-gdp), a_k * d_norm)
    if cfg.log_only:
        return a_k, alpha_log, True
    use_log = z1 >= _LN2
    return a_k, o.where(use_log, alpha_log, alpha_lin), use_log


def _fw_l0l1_log_step(cfg, prob, c, k):
    f, h = prob["f"], prob["h"]
    ls_ratio, L0cap, L1cap = prob["ls_ratio"], prob["L0cap"], prob["L1cap"]
    x, L0t, L1t, tog = c["x"], c["L0"], c["L1"], c["toggle"]
    fx_t, g = f.value_and_grad(x)
    gx_t = fnorm(g)
    d = cfg.lmo(g) - x
    dn_t = fnorm(d)
    gdp_t = _gdp_banded(g, d, prob["delta"])

    if cfg.linesearch:
        L0t = L0t / ls_ratio
        L1t = L1t / ls_ratio
    if cfg.log_only:
        L1t = torch.clamp_min(_LN2 / dn_t, L1t)  # propagates NaN
    a_k, a, use_log = _log_alpha(_OnDevice, cfg, L0t, L1t, gx_t, dn_t, gdp_t)
    x_new = x + a * d
    q = dict(fx=fx_t, psi=h.extra_psi(x), gdp=gdp_t, gx=gx_t, dn=dn_t,
             L0=L0t, L1=L1t, a_k=a_k, a=a, log=use_log)
    if cfg.linesearch:
        q["f1"] = f.value(x_new)
    q = _read(**q)
    fx, gdp, gx, dn = q["fx"], q["gdp"], q["gx"], q["dn"]
    _raise_if_bad(gdp)
    L0t, L1t, a_k, a = q["L0"], q["L1"], q["a_k"], q["a"]
    nlog = c["logsteps"] + int(q["log"])

    if cfg.linesearch:
        delta = _accept_delta(f, fx)
        f1, t = q["f1"], 0
        while True:
            z = L1t * a * dn
            exp_term = _scalar.expm1(z) - z if z < 50.0 else 0.5 * z * z
            rhs = fx + a * gdp + _scalar.div(a_k, L1t * L1t) * exp_term
            if f1 <= rhs + delta or t >= _LS_MAX:
                break
            if not cfg.log_only:
                L0t = _scalar.minimum(L0t * ls_ratio, L0cap)
                L1t = _scalar.minimum(L1t * ls_ratio, L1cap)
            elif tog == 0:  # alternate the back-off between L0 and L1
                L0t = _scalar.minimum(L0t * ls_ratio, L0cap)
            else:
                L1t = _scalar.minimum(L1t * ls_ratio, L1cap)
            if cfg.log_only:
                tog = 1 - tog
            t += 1
            a_k, a, use_log = _log_alpha(_OnHost, cfg, L0t, L1t, gx, dn, gdp)
            nlog += int(use_log)
            x_new = x + a * d
            (f1,) = _scalar.read(f.value(x_new))

    Fk = fx + q["psi"]
    stop = k > 0 and abs(Fk - c["F_prev"]) < prob["eps"]
    return (dict(done=c["done"], x=x_new, L0=L0t, L1=L1t, logsteps=nlog,
                 toggle=tog, F_prev=Fk),
            dict(F=Fk, Ls=a_k, L0=L0t, L1=L1t, LOG_STEPS=nlog, bad=False,
                 _stop=stop))


def _l0l1_log_driver(f, h, L0, L1, x0, maxitrs, lmo, ls_ratio, epsilon,
                     L0_max, L1_max, linesearch, verbose, verbskip, chunk,
                     checkpoint, log_only, header):
    """Shared wrapper for FW_l0l1_log_and_linear_step / FW_l0l1_log_only
    (reference: algorithms_fw.py:250-349 and :352-453)."""
    if ls_ratio < 1:
        raise ValueError("ls_ratio must be >= 1")
    if L0 <= 0 or L1 <= 0:
        raise ValueError("Initial L0 and L1 must be positive")
    if epsilon <= 0:
        raise ValueError("epsilon must be positive")

    prob = dict(f=f, h=h, eps=float(epsilon), delta=1e-8,
                ls_ratio=float(ls_ratio),
                L0cap=math.inf if L0_max is None else float(L0_max),
                L1cap=math.inf if L1_max is None else float(L1_max))
    carry = dict(done=False, x=_start(f, x0), L0=float(L0), L1=float(L1),
                 logsteps=0, toggle=0, F_prev=float("inf"))

    def row(k, r, t):
        print("{0:6d}   {1:10.3e}   {2:10.3e}   {3:10.3e}   {4:10.3e}   "
              "{5:6d}      {6:6.1f}".format(k, r["F"], r["Ls"], r["L0"],
                                            r["L1"], int(r["LOG_STEPS"]), t))

    cfg = _FWLogCfg(lmo=lmo, linesearch=bool(linesearch),
                    log_only=bool(log_only))
    carry, hist, T = _run(_fw_l0l1_log_step, cfg, prob, carry, maxitrs,
                          header, row, verbose, verbskip, chunk, checkpoint)
    return carry["x"], hist["F"], hist["Ls"], hist["LOG_STEPS"], T


def FW_l0l1_log_and_linear_step(f, h, L0, L1, x0, maxitrs, lmo, ls_ratio,
                                epsilon=1e-14, L0_max=None, L1_max=None,
                                linesearch=True, verbose=True, verbskip=50,
                                chunk=None, checkpoint=None):
    """(L0,L1)-smooth FW with a logarithmic step when L1||d|| >= ln 2 and a
    linear step otherwise; acceptance uses the expm1-guarded exponential
    bound (reference: algorithms_fw.py:250-349).  Returns
    ``(x, F, Ls, LOG_STEPS, T)`` with LOG_STEPS the cumulative count of
    log-branch step evaluations, recorded once per iteration.
    """
    header = ("\nFW L0,L1 smooth logarithmic algorithm\n"
              "     k      F(x)         L         L0         L1     log step "
              "count       time")
    return _l0l1_log_driver(f, h, L0, L1, x0, maxitrs, lmo, ls_ratio, epsilon,
                            L0_max, L1_max, linesearch, verbose, verbskip,
                            chunk, checkpoint, log_only=False, header=header)


def FW_l0l1_log_only(f, h, L0, L1, x0, maxitrs, lmo, ls_ratio, epsilon=1e-14,
                     L0_max=None, L1_max=None, linesearch=True, verbose=True,
                     verbskip=50, chunk=None, checkpoint=None):
    """(L0,L1)-smooth FW forcing the log step: L1 is floored at
    ln(2)/||d|| each iteration and (L0,L1) back off with an alternating
    toggle (reference: algorithms_fw.py:352-453).  Returns
    ``(x, F, Ls, LOG_STEPS, T)``.
    """
    header = ("\nFW L0,L1 smooth algorithm with fixed L1\n"
              "     k      F(x)         L         L0         L1     log step "
              "count       time")
    return _l0l1_log_driver(f, h, L0, L1, x0, maxitrs, lmo, ls_ratio, epsilon,
                            L0_max, L1_max, linesearch, verbose, verbskip,
                            chunk, checkpoint, log_only=True, header=header)
