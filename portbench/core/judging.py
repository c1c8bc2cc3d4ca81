"""Helpers of the judges (``reference/<name>.py``)."""

from __future__ import annotations

import numpy as np


def worst(values):
    """The largest value, NaN where any is NaN (NaN fails every limit)."""
    vals = [float(v) for v in values]
    return float("nan") if any(v != v for v in vals) else max(vals)


def sample(answers, count, seed):
    """``count`` (answer, instance) pairs drawn from the seed, the one with
    the most rows among them."""
    pairs = [(a, k) for a in answers for k in range(len(a.instances))]
    longest = max(range(len(pairs)),
                  key=lambda p: pairs[p][0].rows[pairs[p][1]])
    rest = [p for p in range(len(pairs)) if p != longest]
    picks = []
    if count > 1 and rest:
        rng = np.random.default_rng(int(seed) % 2**63)
        picks = rng.choice(len(rest), size=min(count - 1, len(rest)),
                           replace=False)
    return [pairs[longest]] + [pairs[rest[p]] for p in picks]
