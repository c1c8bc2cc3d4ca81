"""Plain reference of D-optimal design by Frank-Wolfe with away steps
(Wolfe-Atwood; the upstream ``accbpg/D_opt_alg.py`` FW-away), and the
judge of the FW-away cells.

    minimize  F(x) = -log det(V diag(x) V^T)   s.t.  x in the unit simplex

Plain PyTorch in the caller's precision, one iteration a loop turn with
Sherman-Morrison updates of H = (V diag(x) V^T)^-1 and w_i = v_i^T H v_i;
it takes nothing from the program.  ``certificate`` is the optimality
certificate of an iterate by a fresh factorization in float64.

The judge (``judge``) reads every answer of a run:

* ``fresh_slack_per_eps``: the largest fresh slack, max(SP, SN) of the
  returned iterate, over eps (a certified solve reads at most 1);
* ``stop_row_gap``: the largest gap between the slacks recorded at the
  stop row and the fresh ones;
* ``F_gap``: the largest gap between F recorded at the stop row and the
  fresh -log det, over |F|;
* ``x_sum_gap``: the largest |sum x - 1|;
* ``rows_gap``: on a sample of instances drawn from the seed (the one with
  the most rows among them), the largest gap between the recorded F
  (relative), SP and SN and the plain iteration's over the first rows.
"""

from __future__ import annotations

import numpy as np
import torch

XTOL = 1.0e-8   # the reference's support threshold of the away pivot


def certificate(V, x, xtol=XTOL):
    """``(SP, SN, F)`` of the iterate ``x`` (normalized to the simplex) by
    a fresh float64 factorization; inf where the information matrix is
    not positive definite."""
    V = V.to(torch.float64)
    x = x.to(torch.float64)
    xs = x / x.sum()
    R, info = torch.linalg.cholesky_ex((V * xs) @ V.T)
    if int(info) != 0:
        return float("inf"), float("inf"), float("inf")
    W = torch.linalg.solve_triangular(R, V, upper=False)
    w = (W * W).sum(dim=0)
    m = V.shape[0]
    sp = float(w.max()) / m - 1.0
    sn = 1.0 - float(w[xs > xtol].min()) / m
    return sp, sn, float(-2.0 * torch.log(torch.diagonal(R)).sum())


def fw_away(V, x0, eps, maxitrs, dtype=torch.float64, xtol=XTOL,
            check_every=256):
    """Wolfe-Atwood from ``x0`` in ``dtype`` for the designs ``V`` ((m, n),
    or (K, m, n) solved side by side): ``(x, F, SP, SN, rows)``, ``x``
    (K, n) and the rows (K, T) up to and including each design's first
    with SP <= eps and SN <= eps (where the reference breaks before the
    update; its later rows repeat it), at most ``maxitrs``."""
    V = V.to(dtype)
    if V.dim() == 2:
        V = V[None]
    K, m, n = V.shape
    ar = torch.arange(K, device=V.device)
    x = x0.to(dtype).expand(K, n).clone()
    R = torch.linalg.cholesky(torch.bmm(V * x[:, None, :],
                                        V.transpose(1, 2)))
    logdet = 2.0 * torch.log(torch.diagonal(R, dim1=1, dim2=2)).sum(dim=1)
    eye = torch.eye(m, dtype=dtype, device=V.device).expand(K, m, m)
    Rinv = torch.linalg.solve_triangular(R, eye, upper=False)
    H = Rinv.transpose(1, 2) @ Rinv
    W = Rinv @ V
    w = (W * W).sum(dim=1)
    done = torch.zeros(K, dtype=torch.bool, device=V.device)
    rows = []
    for k in range(maxitrs):
        i = torch.argmax(w, dim=1)
        wi = w[ar, i]
        sp = wi / m - 1.0
        j = torch.argmin(torch.where(x > xtol, w, torch.inf), dim=1)
        wj = w[ar, j]
        sn = 1.0 - wj / m
        rows.append(torch.stack([-logdet, sp, sn]))
        stop = (sp <= eps) & (sn <= eps)
        toward = sp >= sn
        t_tow = (wi / m - 1.0) / (wi - 1.0)
        xj = x[ar, j]
        t_aw = torch.minimum((1.0 - wj / m) / (wj - 1.0), xj / (1.0 - xj))
        sc = torch.where(toward, -t_tow / (1.0 - t_tow + t_tow * wi),
                         t_aw / (1.0 + t_aw - t_aw * wj))
        st = torch.where(toward, -t_tow, t_aw)
        inc = torch.where(
            toward,
            (m - 1.0) * torch.log1p(-t_tow) + torch.log1p(t_tow * (wi - 1.0)),
            (m - 1.0) * torch.log1p(t_aw) + torch.log1p(t_aw - t_aw * wj))
        v = torch.where(toward, i, j)
        g = torch.bmm(H, V[ar, :, v][:, :, None]).squeeze(2)
        u = torch.bmm(g[:, None, :], V).squeeze(1)
        u[ar, v] = torch.where(toward, wi, wj)
        keep = done | stop
        H = torch.where(keep[:, None, None], H,
                        (H + sc[:, None, None] * g[:, :, None] * g[:, None, :])
                        / (1.0 + st)[:, None, None])
        w = torch.where(keep[:, None], w,
                        (w + sc[:, None] * u * u) / (1.0 + st)[:, None])
        x_new = x * (1.0 + st)[:, None]
        x_new[ar, v] -= st
        x = torch.where(keep[:, None], x, x_new)
        logdet = torch.where(keep, logdet, logdet + inc)
        done = keep
        if (k + 1) % check_every == 0 and bool(done.all()):
            break
    hist = torch.stack(rows, dim=2).to(torch.float64).cpu().numpy()
    hit = (hist[1] <= eps) & (hist[2] <= eps)
    stops = np.where(hit.any(axis=1), np.argmax(hit, axis=1) + 1,
                     hist.shape[2])
    T = int(stops.max())
    return x, hist[0, :, :T], hist[1, :, :T], hist[2, :, :T], stops


class Control:
    """The control of ``correct``: this reference in the program's place,
    in float32, the precision below the configuration's float64."""

    def __init__(self, caller, cell, pool, device, dtype=torch.float32):
        self.pool, self.dtype = pool, dtype
        self.eps = float(cell.config["eps"])
        self.cap = int(cell.config["fw_maxitrs"])

    def call(self, idx, **_):
        from portbench.core.window import Answer

        x, F, SP, SN, rows = fw_away(self.pool.V[list(idx)], self.pool.x0,
                                     self.eps, self.cap, dtype=self.dtype)
        return Answer(x.to(torch.float64), {"F": F, "SP": SP, "SN": SN},
                      rows, tuple(idx))

    def close(self):
        pass


def judge(ctx):
    """``(numbers, per_instance)``: each number compared, as ``(name,
    value)``, and the numbers of each instance (for ``failed``)."""
    from portbench.core.judging import sample, worst

    eps = float(ctx.config["eps"])
    V = ctx.pool.V
    per = {}
    for a in ctx.answers():
        for k, i in enumerate(a.instances):
            sp, sn, F = certificate(V[i], a.x[k])
            s = int(a.rows[k]) - 1
            per[id(a), k] = {
                "fresh_slack_per_eps": max(sp, sn) / eps,
                "stop_row_gap": max(abs(a.hist["SP"][k, s] - sp),
                                    abs(a.hist["SN"][k, s] - sn)),
                "F_gap": abs(a.hist["F"][k, s] - F) / abs(F),
                "x_sum_gap": abs(float(a.x[k].sum()) - 1.0)}
    chk = ctx.mix["check"]
    for a, k in sample(ctx.answers(), int(chk["sample"]), ctx.seed):
        R = min(int(chk["rows"]), int(a.rows[k]))
        _, F, SP, SN, _ = fw_away(V[a.instances[k]], ctx.pool.x0, -1.0, R)
        per[id(a), k]["rows_gap"] = worst([
            np.max(np.abs(a.hist["F"][k, :R] - F[0]) / np.abs(F[0])),
            np.max(np.abs(a.hist["SP"][k, :R] - SP[0])),
            np.max(np.abs(a.hist["SN"][k, :R] - SN[0]))])
    per = list(per.values())
    names = ("fresh_slack_per_eps", "stop_row_gap", "F_gap", "x_sum_gap",
             "rows_gap")
    return [(n, worst(p[n] for p in per if n in p)) for n in names], per
