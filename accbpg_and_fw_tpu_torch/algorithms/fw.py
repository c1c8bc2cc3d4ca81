"""Frank-Wolfe family: Bregman-divergence steps and (L0,L1)-smooth step rules.

Port of ``accbpg_and_fw_tpu/algorithms/fw.py`` (reference:
accbpg/algorithms_fw.py): the same math, signatures, return tuples,
printed tables and checkpoints.  The LMO is a closure ``g -> s`` from
``ops/lmo.py``.

Every step is JAX's device-scalar step: the carry is all tensors on the
solve's device (``done`` a bool, ``L``, ``L0``, ``L1`` and ``F_prev`` 0-d
float64, ``toggle`` and ``logsteps`` int32 as in JAX), the problem's
numbers are 0-d float64 tensors there too, and the alternating toggles,
the caps and the log/linear branch are ``torch.where`` selects of JAX's
expressions in JAX's order.  The line searches of ``FW_alg_div_step``,
``FW_alg_L0_L1_shortest_step``, ``FW_l0l1_log_and_linear_step`` and
``FW_l0l1_log_only`` are ``_loops.device_while`` loops with JAX's bound
(``_LS_MAX``; the trial kept at the bound is JAX's).  On the card a chunk
is replays of a CUDA graph of ``GRAPH_SPAN`` iterations (``driver.py``)
whose loops run as a fixed number of masked bodies (``DIV_BODIES``,
``SHORTEST_BODIES``, ``LOG_BODIES``, ``LOG_ONLY_BODIES``), with one read
per chunk; an iteration that needs more bodies runs again eagerly.
Eagerly (the CPU, ``driver.eager_chunks``, a user's LMO that declares
``host_reads``) each loop reads its exit test once per turn.
``FW_alg_descent_step`` has no loop: its step 2/(k+2) is computed from
the graph's ``k``.

Where the LMO returns a direction with <g, d> > delta, the step records a
``bad`` flag in the history that stops the run at that row, and the
driver raises JAX's ``ValueError`` after the run (JAX's
``_raise_if_bad``).  Checkpoints use the JAX fingerprints, carry keys and
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

from .._loops import device_while
from ..ops.base import fnorm, vdot
from .bpg import (_accept_delta, _device_carry, _draw, _num, _past_first,
                  _plus, _scalars, _start, _stoch_carry)
from .driver import run_driver

_LS_MAX = 200

# Masked bodies of the line searches in a graph chunk: the trials after the
# first.  An iteration that needs more runs again eagerly (a
# continuation, which also replays the rest of its chunk frozen: ~0.15 s
# at the shortest step's 750 nodes an iteration).  Chosen from the bodies
# the four drivers took under ``eager_chunks`` on the card over the 2000
# illcond iterations of PERF.md (``chip_smoke.py --bodies``): div 0-4
# trials, log 0-3, log-only 0-6 (its toggle backs off L0 and L1 in turn),
# shortest 0-13 but once 65; with these no continuation but the
# shortest step's 2.
DIV_BODIES = 4
SHORTEST_BODIES = 13
LOG_BODIES = 3
LOG_ONLY_BODIES = 6
# Iterations a captured graph holds; a chunk replays it back to back (32:
# a capture of 0.1-0.4 s against 0.7-2.6 s for 256, and no slower).
GRAPH_SPAN = 32


def _gdp_banded(g, d, delta):
    """<g,d> with the reference's band-zeroing: values in (0, delta] -> 0;
    and ``bad``, whether it is still positive."""
    gdp = vdot(g, d)
    gdp = torch.where((gdp > 0) & (gdp <= delta), 0.0, gdp)
    return gdp, gdp > 0


def _raise_if_bad(hist):
    if len(hist["bad"]) and bool(np.asarray(hist["bad"]).any()):
        raise ValueError("grad_d_prod must be non-positive (LMO issue).")


def _direction(cfg, h, x, g, delta):
    """The LMO's direction d = s - x, D_h(s, x) (0 replaced by ``delta``),
    <g,d> (banded) and ``bad``."""
    s = cfg.lmo(g)
    d = s - x
    div = h.divergence(s, x)
    div = torch.where(div == 0, delta, div)
    return (d, div) + _gdp_banded(g, d, delta)


def _stopped(prob, c, k, Fk, bad):
    return _past_first(k, torch.abs(Fk - c["F_prev"]) < prob["eps"]) | bad


def _run(step, cfg, prob, carry, maxitrs, header, row, verbose, verbskip,
         chunk, checkpoint):
    carry, hist, T = run_driver(step, carry, maxitrs, verbose=verbose,
                                verbskip=verbskip, header=header,
                                print_row=row, chunk=chunk,
                                checkpoint=checkpoint, problem=prob, cfg=cfg,
                                graph_span=GRAPH_SPAN)
    _raise_if_bad(hist)
    return carry, hist, T


# ---------------------------------------------------------------------------
# FW with Bregman divergence step
# ---------------------------------------------------------------------------


# The configs keep the JAX drivers' names and fields (their type names are
# the checkpoint fingerprints).
class _FWDivCfg(NamedTuple):
    lmo: Any
    linesearch: bool
    stochastic: bool = False


def _fw_div_step(cfg, prob, c, k):
    f, h = prob["f"], prob["h"]
    gamma, ls_ratio = prob["gamma"], prob["ls_ratio"]
    x, Lk = c["x"], c["L"]
    kc, (fx, g) = _draw(cfg, c, f, x)
    Fk = fx + h.extra_psi(x)
    d, div, gdp, bad = _direction(cfg, h, x, g, prob["delta"])

    def alpha_of(Lt):
        return torch.clamp_max(
            (-gdp / (2.0 * Lt * div)) ** (1.0 / (gamma - 1.0)), 1.0)

    if cfg.linesearch:
        delta = _accept_delta(f, fx)

        def trial(Lt):
            a = alpha_of(Lt)
            x1 = x + a * d
            # NaN-robust acceptance: a NaN trial fails and L backs off
            fail = ~(f.value(x1) <= _plus(fx + a * gdp
                                          + a ** gamma * Lt * div, delta))
            return Lt, x1, fail

        Lk, x_new, _ = device_while(lambda s: s[2],
                                    lambda s: trial(s[0] * ls_ratio),
                                    trial(Lk / ls_ratio), _LS_MAX,
                                    DIV_BODIES, "FW div trials")
    else:
        x_new = x + alpha_of(Lk) * d

    return (dict(done=c["done"], x=x_new, L=Lk, F_prev=Fk, **kc),
            dict(F=Fk, Ls=Lk, bad=bad, _stop=_stopped(prob, c, k, Fk, bad)))


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

    x0 = _start(f, x0)
    prob = dict(f=f, h=h, **_scalars(x0, gamma=gamma, eps=epsilon,
                                     delta=1e-6, ls_ratio=ls_ratio))
    carry = _device_carry(x0, L=L, F_prev=float("inf"))
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
    kc, (fx, g) = _draw(cfg, c, f, x)
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


def _fw_l0l1_shortest_step(cfg, prob, c, k):
    f, h = prob["f"], prob["h"]
    gamma, ls_ratio, e = prob["gamma"], prob["ls_ratio"], prob["e_const"]
    x, L0k, L1k = c["x"], c["L0"], c["L1"]
    fx, g = f.value_and_grad(x)
    Fk = fx + h.extra_psi(x)
    d, div, gdp, bad = _direction(cfg, h, x, g, prob["delta"])
    g_norm = fnorm(g)

    a_k0 = L0k + L1k * g_norm
    if cfg.linesearch:
        L0k = L0k / (ls_ratio + L0k / a_k0)
        L1k = L1k / (ls_ratio + (L1k * g_norm) / a_k0)
        delta = _accept_delta(f, fx)

    def trial(L0t, L1t, tog):
        a_k = L0t + L1t * g_norm
        alpha = torch.clamp_max(
            (-gdp / (a_k * div * e)) ** (1.0 / (gamma - 1.0)), 1.0)
        x1 = x + alpha * d
        st = dict(L0=L0t, L1=L1t, toggle=tog, a_k=a_k, alpha=alpha, x1=x1)
        if cfg.linesearch:
            st["fail"] = ~(f.value(x1) <= _plus(
                fx + alpha * gdp + alpha ** gamma * (a_k / 2.0) * e * div,
                delta))
        return st

    def body(st):
        # the reference's alternating toggle: back off L0, then L1
        a_k = st["L0"] + st["L1"] * g_norm
        first = st["toggle"] == 0
        L0t = torch.where(first, st["L0"] * (ls_ratio - st["L0"] / a_k),
                          st["L0"])
        L1t = torch.where(first, st["L1"],
                          st["L1"] * (ls_ratio - (st["L1"] * g_norm) / a_k))
        return trial(L0t, L1t, 1 - st["toggle"])

    st = trial(L0k, L1k, c["toggle"])
    if cfg.linesearch:
        st = device_while(lambda s: s["fail"], body, st, _LS_MAX,
                          SHORTEST_BODIES, "FW shortest trials")

    return (dict(done=c["done"], x=st["x1"], L0=st["L0"], L1=st["L1"],
                 toggle=st["toggle"], F_prev=Fk),
            dict(F=Fk, Ls=st["a_k"], L0=st["L0"], L1=st["L1"],
                 alpha=st["alpha"], bad=bad,
                 _stop=_stopped(prob, c, k, Fk, bad)))


def _l0l1_carry(x0, L0, L1, **ints):
    """The (L0,L1) drivers' initial carry in JAX's order, the counters
    int32 as there."""
    carry = _device_carry(x0, L0=L0, L1=L1)
    carry.update({k: _num(x0, v, torch.int32) for k, v in ints.items()})
    carry["F_prev"] = _num(x0, float("inf"))
    return carry


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

    x0 = _start(f, x0)
    prob = dict(f=f, h=h, **_scalars(x0, gamma=gamma, eps=epsilon,
                                     delta=1e-8, ls_ratio=ls_ratio,
                                     e_const=math.e))
    carry = _l0l1_carry(x0, L0, L1, toggle=0)
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


def _fw_l0l1_log_step(cfg, prob, c, k):
    f, h, ln2 = prob["f"], prob["h"], prob["ln2"]
    ls_ratio, L0cap, L1cap = prob["ls_ratio"], prob["L0cap"], prob["L1cap"]
    x, L0k, L1k = c["x"], c["L0"], c["L1"]
    fx, g = f.value_and_grad(x)
    gx_norm = fnorm(g)
    Fk = fx + h.extra_psi(x)
    d = cfg.lmo(g) - x
    d_norm = fnorm(d)
    gdp, bad = _gdp_banded(g, d, prob["delta"])

    if cfg.linesearch:
        L0k = L0k / ls_ratio
        L1k = L1k / ls_ratio
        delta = _accept_delta(f, fx)
    if cfg.log_only:
        L1k = torch.maximum(ln2 / d_norm, L1k)  # propagates NaN

    def trial(L0t, L1t, tog, nlog):
        a_k = L0t + L1t * gx_norm
        z1 = L1t * d_norm
        alpha_log = (1.0 / z1) * torch.log(1.0 - (L1t * gdp)
                                           / (a_k * d_norm))
        if cfg.log_only:
            alpha, nlog = alpha_log, nlog + 1
        else:
            use_log = z1 >= ln2
            alpha = torch.where(use_log, alpha_log,
                                L1t * (-gdp) / (a_k * d_norm))
            nlog = nlog + use_log.to(nlog.dtype)
        x1 = x + alpha * d
        st = dict(L0=L0t, L1=L1t, toggle=tog, a_k=a_k, alpha=alpha, x1=x1,
                  nlog=nlog)
        if cfg.linesearch:
            z = L1t * alpha * d_norm
            exp_term = torch.where(z < 50.0, torch.expm1(z) - z,
                                   0.5 * z * z)
            rhs = fx + alpha * gdp + (a_k / L1t ** 2) * exp_term
            st["fail"] = ~(f.value(x1) <= _plus(rhs, delta))
        return st

    def body(st):
        L0t = torch.minimum(st["L0"] * ls_ratio, L0cap)
        L1t = torch.minimum(st["L1"] * ls_ratio, L1cap)
        tog = st["toggle"]
        if cfg.log_only:  # alternate the back-off between L0 and L1
            first = tog == 0
            L0t = torch.where(first, L0t, st["L0"])
            L1t = torch.where(first, st["L1"], L1t)
            tog = 1 - tog
        return trial(L0t, L1t, tog, st["nlog"])

    st = trial(L0k, L1k, c["toggle"], c["logsteps"])
    if cfg.linesearch:
        st = device_while(lambda s: s["fail"], body, st, _LS_MAX,
                          LOG_ONLY_BODIES if cfg.log_only else LOG_BODIES,
                          "FW log-only trials" if cfg.log_only
                          else "FW log trials")

    return (dict(done=c["done"], x=st["x1"], L0=st["L0"], L1=st["L1"],
                 logsteps=st["nlog"], toggle=st["toggle"], F_prev=Fk),
            dict(F=Fk, Ls=st["a_k"], L0=st["L0"], L1=st["L1"],
                 LOG_STEPS=st["nlog"], bad=bad,
                 _stop=_stopped(prob, c, k, Fk, bad)))


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

    x0 = _start(f, x0)
    prob = dict(f=f, h=h, **_scalars(
        x0, eps=epsilon, delta=1e-8, ln2=math.log(2.0), ls_ratio=ls_ratio,
        L0cap=math.inf if L0_max is None else L0_max,
        L1cap=math.inf if L1_max is None else L1_max))
    carry = _l0l1_carry(x0, L0, L1, logsteps=0, toggle=0)

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
