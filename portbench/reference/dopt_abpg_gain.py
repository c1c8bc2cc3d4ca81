"""Plain reference of ABPG with gain adaption (ABPG-g, HRX2018 arXiv:
1808.03045, the upstream ``accbpg/algorithms.py`` ABPG_gain) on D-optimal
design with the Burg entropy on the simplex, and the judge of its cells.

    f(x) = -log det(V diag(x) V^T),  h(x) = -sum log x_i on the simplex

One iteration: the gain G of the last iteration divided by ``ls_dec``,
then multiplied by ``ls_inc`` until the trial passes; a trial takes theta
from (1 - theta')/theta'^gamma = (G/G_1)/theta^gamma by Newton (theta = 1
before the first accepted step), y = (1 - theta) x + theta z, the Bregman
prox z+ = argmin <g, u> + theta^(gamma-1) G L D_h(u, z) over the simplex
(the multiplier of sum 1/(gg + c) = 1 by bisection, then Newton), x+ =
(1 - theta) x + theta z+, and passes where f(x+) <= f(y) + <g, x+ - y> +
theta^gamma G L D_h(z+, z) (or D_h(z+, z) < 1e-14).  The row of iteration
k holds F(x_k) and the accepted gain.  Plain PyTorch in the caller's
precision; it takes nothing from the program.

The judge (``judge``) reads every answer of a run:

* ``x_sum_gap``: the largest |sum x - 1| of a returned iterate;
* ``fresh_sp``: the largest optimality slack of a returned iterate by a
  fresh float64 factorization, SP = max_i w_i / m - 1 with w_i = v_i^T
  (V diag(x) V^T)^-1 v_i (x normalized to the simplex): the certificate
  Frank-Wolfe stops on, which bounds F(x) - F* by m log(1 + SP).  It
  judges the iterate that the whole budget made, past any head: one
  frozen or cut short reads the slack of an earlier iterate;
* ``last_F_gap``: the largest gap between the last F row, F(x_{T-1}),
  and the fresh F of the returned x_T, over |F|: one step's change, which
  ties the returned iterate to the history's end;
* ``follow_gap``, on a sample of calls drawn from the seed: the reference
  run again from the same start over the first ``check.rows`` rows,
  taking the program's accepted gain each iteration (``follow``), the
  larger of the relative gap of those F rows and the breach of the line
  search's rule by the program's gains (the accepted trial must pass and
  the one before it fail, to rounding).  The program's own choices are
  followed, and only a head of the rows compared, because the iteration
  amplifies last-bit differences: on the CPU, where the port's rows equal
  this reference's bit for bit, a perturbation of 1e-15 in x0 moves F by
  more than 1e-10 from row 278 and by 3.7% near row 400 under the same
  gains.  Past the head the rows of two sound float64 runs part.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

LS_MAX = 200       # trials an iteration may take
DZZ_STOP = 1e-14   # ABPG_gain's epsilon: D_h(z+, z) below it stops
STALL = 1e-8       # the multiplier's Newton stops at |residual| <= STALL


def f_value(V, x):
    M = (V * x) @ V.T
    R, info = torch.linalg.cholesky_ex(M)
    if int(info) != 0:
        return None, float("nan")
    return R, float(-2.0 * torch.log(torch.diagonal(R)).sum())


def f_value_grad(V, x):
    R, fx = f_value(V, x)
    if R is None:
        return fx, None
    W = torch.linalg.solve_triangular(R, V, upper=False)
    return fx, -(W * W).sum(dim=0)


def certificate(V, x):
    """``(SP, F)``: the optimality slack of ``x`` normalized to the
    simplex, and F of ``x`` as it is, each by a fresh float64
    factorization (NaN off the domain)."""
    V = V.to(torch.float64)
    x = x.to(torch.float64)
    _, g = f_value_grad(V, x / x.sum())
    _, fx = f_value(V, x)
    if g is None:
        return float("nan"), fx
    return float((-g).max()) / V.shape[0] - 1.0, fx


def burg_divergence(x, y):
    r = x / y
    return float((r - torch.log(r) - 1.0).sum())


def multiplier(gg):
    """c with sum 1/(gg + c) = 1: from cmin + 1 (cmin = -min gg) halved
    toward cmin until the residual is >= 0, then Newton steps until the
    residual is at most ``STALL`` or the step stalls."""
    cmin = -float(gg.min())

    def resid(c):
        return float(torch.div(1.0, gg + c).sum()) - 1.0

    c = cmin + 1.0
    for _ in range(64):
        if resid(c) >= 0.0:
            break
        c = 0.5 * (cmin + c)
    fc = resid(c)
    for _ in range(24):
        if abs(fc) <= STALL:
            break
        c_new = c - fc / float(torch.div(-1.0, (gg + c) ** 2).sum())
        if c_new == c:
            break
        c, fc = c_new, resid(c_new)
    return c


def solve_theta(theta, gamma, ratio):
    ckg = theta ** gamma / ratio
    t = theta
    for _ in range(64):
        phi = t ** gamma - ckg * (1.0 - t)
        if abs(phi) <= 1e-6 * theta:
            break
        t = t - phi / (gamma * t ** (gamma - 1.0) + ckg)
    return t


class _Trial(NamedTuple):
    passes: bool
    margin: float   # bound - f(x+) over 1 + |f(y)| (NaN off the domain)
    x: object
    z: object
    theta: float
    fx: float
    dzz: float


def _trial(V, x, z, theta_1, G_1, G, started, gamma, L):
    """One line-search trial of ABPG-g at the gain G."""
    th = solve_theta(theta_1, gamma, G / G_1) if started else theta_1
    y = (1.0 - th) * x + th * z
    fy, g = f_value_grad(V, y)
    if g is None:
        return _Trial(False, float("nan"), None, None, th, float("nan"),
                      float("nan"))
    Lt = th ** (gamma - 1.0) * G * L
    gg = (g + torch.div(Lt, z)) / Lt
    zn = torch.div(1.0, gg + multiplier(gg))
    xn = (1.0 - th) * x + th * zn
    dzz = burg_divergence(zn, z)
    _, fxn = f_value(V, xn)
    bound = fy + float(g @ (xn - y)) + th ** gamma * G * L * dzz
    return _Trial(dzz < DZZ_STOP or fxn <= bound,
                  (bound - fxn) / (1.0 + abs(fy)), xn, zn, th, fxn, dzz)


def abpg_gain(V, x0, gamma, maxitrs, dtype=torch.float64, L=1.0, G0=1.0,
              ls_inc=1.2, ls_dec=1.2):
    """ABPG-g from ``x0`` in ``dtype``: ``(x, F, Gain)`` over at most
    ``maxitrs`` iterations."""
    V = V.to(dtype)
    x = z = x0.to(dtype).clone()
    theta, G_1, started = 1.0, float(G0), False
    fx, _ = f_value_grad(V, x)
    F, gains = [], []
    for _ in range(maxitrs):
        F.append(fx)
        G = G_1 / ls_dec
        for _ in range(LS_MAX):
            t = _trial(V, x, z, theta, G_1, G, started, gamma, L)
            if t.passes:
                break
            G *= ls_inc
        gains.append(G)
        x, z, theta, G_1, fx, started = t.x, t.z, t.theta, G, t.fx, True
        if t.dzz < DZZ_STOP:
            break
    return x, np.array(F), np.array(gains)


def follow(V, x0, gamma, gains, L=1.0, G0=1.0, ls_inc=1.2, ls_dec=1.2):
    """ABPG-g in float64 from ``x0`` taking the given accepted gains, one
    an iteration: ``(x, F, violation)``, the final iterate, the F rows,
    and the largest breach of the line search's rule by those gains: the
    accepted trial's ``-margin`` where it fails, and the trial before it
    (where one came before) its ``margin`` where it passes; a gain that
    the trials from the last one divided by ``ls_dec`` never reach is a
    breach of inf."""
    V = V.to(torch.float64)
    x = z = x0.to(torch.float64).clone()
    theta, G_1, started = 1.0, float(G0), False
    fx, _ = f_value_grad(V, x)
    F, worst = [], 0.0
    for G in gains:
        F.append(fx)
        G = float(G)
        tried = [G_1 / ls_dec]
        while tried[-1] < G and len(tried) < LS_MAX:
            tried.append(tried[-1] * ls_inc)
        if tried[-1] != G:
            return x, np.array(F), math.inf
        t = _trial(V, x, z, theta, G_1, G, started, gamma, L)
        if not t.passes:
            worst = max(worst, -t.margin if t.margin == t.margin
                        else math.inf)
        if len(tried) > 1:
            r = _trial(V, x, z, theta, G_1, tried[-2], started, gamma, L)
            if r.passes:
                worst = max(worst, r.margin)
        x, z, theta, G_1, fx, started = t.x, t.z, t.theta, G, t.fx, True
    return x, np.array(F), worst


class Control:
    """The control of ``correct``: this reference in the program's place,
    in float32, the precision below the configuration's float64."""

    def __init__(self, caller, cell, pool, device, dtype=torch.float32):
        self.pool, self.dtype = pool, dtype
        self.gamma = float(cell.config["abpg_gain_gamma"])
        self.maxitrs = int(cell.config["abpg_gain_maxitrs"])

    def call(self, idx, maxitrs=None):
        from portbench.core.window import Answer

        (i,) = idx
        x, F, Gain = abpg_gain(self.pool.V[i], self.pool.x0, self.gamma,
                               maxitrs or self.maxitrs, dtype=self.dtype)
        return Answer(x.to(torch.float64)[None],
                      {"F": F[None], "Gain": Gain[None]},
                      np.array([len(F)]), tuple(idx))

    def close(self):
        pass


def judge(ctx):
    """``(numbers, per_instance)`` as ``reference/dopt_fw.judge``."""
    from portbench.core.judging import sample, worst

    answers = ctx.answers()
    per = {}
    for a in answers:
        sp, fx = certificate(ctx.pool.V[a.instances[0]], a.x[0])
        last = float(a.hist["F"][0, int(a.rows[0]) - 1])
        per[id(a)] = {"x_sum_gap": abs(float(a.x[0].sum()) - 1.0),
                      "fresh_sp": sp,
                      "last_F_gap": abs(last - fx) / abs(fx)}
    gamma = float(ctx.config["abpg_gain_gamma"])
    for a, k in sample(answers, int(ctx.mix["check"]["sample"]), ctx.seed):
        head = min(int(ctx.mix["check"]["rows"]), int(a.rows[k]))
        _, F, breach = follow(ctx.pool.V[a.instances[k]], ctx.pool.x0, gamma,
                              a.hist["Gain"][k, :head])
        per[id(a)]["follow_gap"] = worst([
            breach, np.max(np.abs(a.hist["F"][k, :head] - F) / np.abs(F))])
    per = list(per.values())
    names = ("x_sum_gap", "fresh_sp", "last_F_gap", "follow_gap")
    return [(n, worst(p[n] for p in per if n in p)) for n in names], per
