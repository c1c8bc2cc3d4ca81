"""The judge of ABPG-gain on the linear-Gram fast path (``fast_gram=True``):
the plain reference, control and numbers of ``reference/dopt_abpg_gain.py``
(the same iteration; nothing of the program), with one change:
``follow_gap`` takes the F rows' gap over 1 + |F| instead of |F|.

The fast path computes the same iteration in other arithmetic (the Grams
updated by rank-one terms, the multiplier by a Newton warm-started from the
last one, stopped at a residual of 1e-8), so its F rows leave those of the
reference, which takes its gains, by some 1e-8 of F's scale inside the
followed head.  F = -log det starts near 0 at the uniform start of a
30x10000 design and crosses 0 within the first rows, where a gap over |F|
grows without bound (up to 1.8e-4 on sound runs on an H100; 1.2e-6 at row
6 on the CPU, where the absolute gap is 6e-8).  Over 1 + |F| the gap keeps
the scale of F's rounding away from 0 and stays bounded at it.  The other
numbers are ``dopt_abpg_gain.judge``'s.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from portbench.core.registry import load_module

_BASE = load_module("reference", "dopt_abpg_gain",
                    Path(__file__).resolve().parent.parent)
Control = _BASE.Control


def judge(ctx):
    """``(numbers, per_instance)`` as ``reference/dopt_fw.judge``."""
    from portbench.core.judging import sample, worst

    answers = ctx.answers()
    per = {}
    for a in answers:
        sp, fx = _BASE.certificate(ctx.pool.V[a.instances[0]], a.x[0])
        last = float(a.hist["F"][0, int(a.rows[0]) - 1])
        per[id(a)] = {"x_sum_gap": abs(float(a.x[0].sum()) - 1.0),
                      "fresh_sp": sp,
                      "last_F_gap": abs(last - fx) / abs(fx)}
    gamma = float(ctx.config["abpg_gain_gamma"])
    for a, k in sample(answers, int(ctx.mix["check"]["sample"]), ctx.seed):
        head = min(int(ctx.mix["check"]["rows"]), int(a.rows[k]))
        _, F, breach = _BASE.follow(ctx.pool.V[a.instances[k]], ctx.pool.x0,
                                    gamma, a.hist["Gain"][k, :head])
        per[id(a)]["follow_gap"] = worst([
            breach,
            np.max(np.abs(a.hist["F"][k, :head] - F) / (1.0 + np.abs(F)))])
    per = list(per.values())
    names = ("x_sum_gap", "fresh_sp", "last_F_gap", "follow_gap")
    return [(n, worst(p[n] for p in per if n in p)) for n in names], per
