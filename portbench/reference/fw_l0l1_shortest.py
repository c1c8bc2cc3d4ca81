"""Plain reference of Frank-Wolfe for (L0,L1)-smooth f with the
shortest-step rule (the upstream ``accbpg/algorithms_fw.py:78-207``,
``FW_alg_L0_L1_shortest_step``) on logistic regression over an l2 ball,
and the judge of its cell.

    f(x) = mean_i log(1 + exp(-y_i <X_i, x>)),  h(x) = ||x||^2 / 2,
    x in the ball ||x|| <= r

Iteration k, from x_k: g = grad f(x_k); the ball's vertex s = -r g/||g||
(the centre where ||g|| < 1e-10); d = s - x_k; D = D_h(s, x_k) = ||d||^2/2
(1e-8 where it is 0); <g, d> (a value in (0, 1e-8] taken as 0).  A trial
at (L0, L1) takes a_k = L0 + L1 ||g||, alpha = min((-<g,d> / (a_k D
e))^(1/(gamma-1)), 1), x+ = x_k + alpha d, and passes where f(x+) <=
f(x_k) + alpha <g,d> + alpha^gamma (a_k/2) e D.  The first trial of an
iteration is at L0 / (ratio + L0/a0), L1 / (ratio + L1 ||g|| / a0) (a0 at
the carried L0, L1); a trial that fails backs off L0 by (ratio - L0/a)
where the toggle is 0, else L1 by (ratio - L1 ||g|| / a), and flips the
toggle, which the next iteration takes over with the accepted L0 and L1;
at most 200 trials after the first (the last one is kept).  Row k holds
F(x_k) and the accepted a_k; the row where |F_k - F_{k-1}| < epsilon
(k > 0) is the last, its step still taken.

Departures from the upstream code, all of them the JAX package's and the
port's too: the value is ``logaddexp(0, -z)`` (softplus), which stays
exact where log(1 + exp(-z)) overflows; the step of the stopping row is
taken, so the iterate returned is the one after the last row; an LMO
direction with <g, d> > 1e-8 (the upstream's error) cannot occur on the
ball and is not checked.  Plain PyTorch for the vectors, in the caller's
precision, and Python floats (float64) for the scalars; it takes nothing
from the program.  The judge takes the instance's data X and y from the
pool and computes L0 and L1 itself (``constants``), as
``examples/ex_fw_l0l1.py`` sets them; the pool's L0 and L1 go to the
program alone.

The judge (``judge``) reads every answer of a run:

* ``ball_excess``: the largest (||x_T|| - r) / r of a returned iterate (a
  convex combination of points of the ball lies in it, to rounding);
* ``last_F_rise``: the largest rise of the fresh F of the returned x_T
  over the last F row, F(x_{T-1}), over |F(x_{T-1})|.  Every accepted
  trial lowers F: its bound lies below f(x_k) by <g,d>^2 / (2 a_k e D)
  where alpha < 1, and by at least -<g,d>/2 where alpha = 1 (gamma = 2),
  so a sound run reads below 0 by its last step, to rounding, and an
  iterate from an earlier row reads above 0 by the steps it misses;
* ``rows_gap``, on a sample of calls drawn from the seed: the reference run
  free from the same x0 over the first ``check.rows`` rows, the larger of
  the relative gaps of its F and a_k rows against the program's;
* ``rule_gap``, on the same sample: the reference over the first
  ``check.rule_rows`` rows (all of them by default) taking the program's
  accepted a_k each row (``follow``): the larger of the relative gap of
  its F rows against the program's, the gap between the program's a_k and
  the nearest trial of the rule's own sequence, and the breach of the rule
  by the program's a_k (the accepted trial must pass and the one before it
  fail, to rounding).  A run frozen or cut short past the free run's head
  keeps F rows that the rule does not give;
* ``x_gap``, on the same sample where ``rule_gap`` covers every row: the
  returned x_T against the iterate after the last row of that run, over
  its norm, which ties x_T to the rows of every row: a stale iterate, or
  one of another history, reads the steps between.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

LS_MAX = 200       # trials after the first an iteration may take
DELTA = 1e-8       # D_h's floor and the band of <g, d> taken as 0


class Logistic:
    """The mean logistic loss of the data ``X`` (m x n), ``y`` (m)."""

    def __init__(self, X, y):
        self.X, self.y, self.m = X, y, X.shape[0]

    def value(self, x):
        z = self.y * (self.X @ x)
        return float(torch.mean(torch.logaddexp(torch.zeros_like(z), -z)))

    def value_and_grad(self, x):
        z = self.y * (self.X @ x)
        w = torch.sigmoid(-z) * self.y
        return (float(torch.mean(torch.logaddexp(torch.zeros_like(z), -z))),
                -(w @ self.X) / self.m)


class _Trial(NamedTuple):
    passes: bool
    margin: float   # bound - f(x+) over 1 + |f(x)| (NaN off the domain)
    L0: float
    L1: float
    toggle: int
    a: float
    x: object


class _Step:
    """The quantities of iteration k that every trial shares."""

    def __init__(self, f, x, radius, delta=DELTA):
        self.f, self.x = f, x
        self.fx, g = f.value_and_grad(x)
        self.gn = float(torch.linalg.vector_norm(g))
        s = (torch.zeros_like(g) if self.gn < 1e-10
             else -(radius * g / max(self.gn, 1e-30)))
        self.d = s - x
        div = 0.5 * float(torch.dot(self.d, self.d))
        self.div = delta if div == 0 else div
        gdp = float(torch.dot(g, self.d))
        self.gdp = 0.0 if 0.0 < gdp <= delta else gdp

    def start(self, L0, L1, ratio):
        """The first trial's (L0, L1): the carried pair divided as the
        rule's first back-on."""
        a0 = L0 + L1 * self.gn
        return L0 / (ratio + L0 / a0), L1 / (ratio + (L1 * self.gn) / a0)

    def trial(self, L0, L1, toggle, gamma, a=None):
        """The trial at (L0, L1), or with its a_k given as ``a``."""
        a = L0 + L1 * self.gn if a is None else a
        alpha = min((-self.gdp / (a * self.div * math.e))
                    ** (1.0 / (gamma - 1.0)), 1.0)
        x1 = self.x + alpha * self.d
        bound = (self.fx + alpha * self.gdp
                 + alpha ** gamma * (a / 2.0) * math.e * self.div)
        f1 = self.f.value(x1)
        return _Trial(f1 <= bound, (bound - f1) / (1.0 + abs(self.fx)), L0,
                      L1, toggle, a, x1)

    def back_off(self, t, ratio, gamma):
        """The trial after ``t``: L0 backed off where its toggle is 0, else
        L1, the toggle flipped."""
        a = t.L0 + t.L1 * self.gn
        L0, L1 = t.L0, t.L1
        if t.toggle == 0:
            L0 = L0 * (ratio - L0 / a)
        else:
            L1 = L1 * (ratio - (L1 * self.gn) / a)
        return self.trial(L0, L1, 1 - t.toggle, gamma)


def shortest_step(X, y, L0, L1, x0, maxitrs, radius, gamma=2.0, ratio=2.0,
                  epsilon=1e-14, dtype=torch.float64):
    """The rule from ``x0`` in ``dtype`` over at most ``maxitrs`` rows:
    ``(x, F, Ls)``, the iterate after the last row and the F and a_k rows
    (float64 numpy)."""
    f = Logistic(X.to(dtype), y.to(dtype))
    x = x0.to(dtype).clone()
    L0, L1, toggle, F_prev = float(L0), float(L1), 0, math.inf
    F, Ls = [], []
    for k in range(maxitrs):
        st = _Step(f, x, radius)
        t = st.trial(*st.start(L0, L1, ratio), toggle, gamma)
        for _ in range(LS_MAX):
            if t.passes:
                break
            t = st.back_off(t, ratio, gamma)
        F.append(st.fx)
        Ls.append(t.a)
        x, L0, L1, toggle = t.x, t.L0, t.L1, t.toggle
        if k > 0 and abs(st.fx - F_prev) < epsilon:
            break
        F_prev = st.fx
    return x, np.array(F), np.array(Ls)


def constants(X, config):
    """``(L0, L1)`` of the instance with design ``X``: L1 the largest row
    norm of X, L0 the upstream generator's 1e-12 floored at the
    configuration's ``L0_floor`` (``examples/ex_fw_l0l1.py``)."""
    L1 = float(torch.linalg.vector_norm(X.to(torch.float64), dim=1).max())
    return max(1e-12, float(config["L0_floor"])), L1


def follow(X, y, L0, L1, x0, a_rows, radius, gamma=2.0, ratio=2.0):
    """The rule in float64 from ``x0`` taking the given accepted a_k, one a
    row: ``(x, F, a_gap, breach)``, the iterate after the last row, the F
    rows, the largest relative gap
    between a given a_k and the nearest trial of the rule's own sequence
    (from the carried L0, L1 and toggle, up to the first that passes and
    one more), and the largest breach of the rule by the given a_k: its
    trial's ``-margin`` where it fails, and the nearest trial's predecessor
    its ``margin`` where that passes.  The carried L0, L1 and toggle are
    the nearest trial's."""
    f = Logistic(X.to(torch.float64), y.to(torch.float64))
    x = x0.to(torch.float64).clone()
    L0, L1, toggle = float(L0), float(L1), 0
    F, a_gap, breach = [], 0.0, 0.0
    for a in a_rows:
        a = float(a)
        st = _Step(f, x, radius)
        seq = [st.trial(*st.start(L0, L1, ratio), toggle, gamma)]
        while len(seq) <= LS_MAX and not (len(seq) > 1 and seq[-2].passes):
            seq.append(st.back_off(seq[-1], ratio, gamma))
        j = min(range(len(seq)), key=lambda i: abs(seq[i].a - a))
        a_gap = max(a_gap, abs(seq[j].a - a) / abs(a))
        t = st.trial(seq[j].L0, seq[j].L1, seq[j].toggle, gamma, a=a)
        if not t.passes:
            breach = max(breach, -t.margin if t.margin == t.margin
                         else math.inf)
        if j > 0 and seq[j - 1].passes:
            breach = max(breach, seq[j - 1].margin)
        F.append(st.fx)
        x, L0, L1, toggle = t.x, seq[j].L0, seq[j].L1, seq[j].toggle
    return x, np.array(F), a_gap, breach


def _config(config):
    return dict(radius=float(config["radius"]), gamma=float(config["gamma"]),
                ratio=float(config["ls_ratio"]))


class Control:
    """The control of ``correct``: this reference in the program's place,
    in float32, the precision below the configuration's float64."""

    def __init__(self, caller, cell, pool, device, dtype=torch.float32):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.pool, self.dtype = pool, dtype
        self.kw = _config(cell.config)
        self.kw["epsilon"] = float(cell.config["epsilon"])
        self.maxitrs = int(cell.config["maxitrs"])

    def call(self, idx, maxitrs=None):
        from portbench.core.window import Answer

        (i,) = idx
        p = self.pool
        x, F, Ls = shortest_step(p.X[i], p.y[i], p.L0[i], p.L1[i], p.x0,
                                 maxitrs or self.maxitrs, dtype=self.dtype,
                                 **self.kw)
        return Answer(x.to(torch.float64)[None], {"F": F[None],
                                                  "Ls": Ls[None]},
                      np.array([len(F)]), tuple(idx))

    def close(self):
        pass


def judge(ctx):
    """``(numbers, per_instance)`` as ``reference/dopt_fw.judge``."""
    from portbench.core.judging import sample, worst

    p, kw = ctx.pool, _config(ctx.config)
    r = kw["radius"]
    answers = ctx.answers()
    per = {}
    for a in answers:
        i = a.instances[0]
        x = a.x[0].to(torch.float64)
        fx = Logistic(p.X[i], p.y[i]).value(x)
        last = float(a.hist["F"][0, int(a.rows[0]) - 1])
        per[id(a)] = {
            "ball_excess": (float(torch.linalg.vector_norm(x)) - r) / r,
            "last_F_rise": (fx - last) / abs(last)}
    chk = ctx.mix["check"]
    for a, k in sample(answers, int(chk["sample"]), ctx.seed):
        i, T = a.instances[k], int(a.rows[k])
        head = min(int(chk["rows"]), T)
        L0, L1 = constants(p.X[i], ctx.config)
        _, F, Ls = shortest_step(p.X[i], p.y[i], L0, L1, p.x0, head,
                                 epsilon=-1.0, **kw)
        per[id(a)]["rows_gap"] = worst([
            np.max(np.abs(a.hist["F"][k, :head] - F) / np.abs(F)),
            np.max(np.abs(a.hist["Ls"][k, :head] - Ls) / np.abs(Ls))])
        rule = min(int(chk.get("rule_rows", T)), T)
        xf, F, a_gap, breach = follow(p.X[i], p.y[i], L0, L1, p.x0,
                                      a.hist["Ls"][k, :rule], **kw)
        per[id(a)]["rule_gap"] = worst([
            np.max(np.abs(a.hist["F"][k, :rule] - F) / np.abs(F)), a_gap,
            breach])
        if rule == T:
            per[id(a)]["x_gap"] = float(
                torch.linalg.vector_norm(a.x[k].to(torch.float64) - xf)
                / torch.linalg.vector_norm(xf))
    per = list(per.values())
    names = ("ball_excess", "last_F_rise", "rows_gap", "rule_gap", "x_gap")
    return [(n, worst(p[n] for p in per if n in p)) for n in names], per
