"""Convergence comparison plots (reference: accbpg/plotfigs.py:10-48).

The port's own copy of ``accbpg_and_fw_tpu/viz/plotfigs.py`` (the port
imports nothing of the JAX package): multi-curve plots with optional
``plotdiff`` (subtract the running global minimum so curves show F - F*),
log/linear scales and the reference's default line-style cycle.  Accepts
the drivers' numpy histories (or anything ``np.asarray`` takes).  It never
imports matplotlib itself: the caller passes the axis.
"""

from __future__ import annotations

import numpy as np

_DEFAULT_STYLES = ['k:', 'g-', 'b-.', 'k-', 'r--', 'k-', 'm-']
_DEFAULT_DASHES = [[1, 2], [], [4, 2, 1, 2], [], [4, 2], [], [], []]


def plot_comparisons(axis, y_vals, labels, x_vals=(), plotdiff=False,
                     yscale="linear", xscale="linear", xlim=(), ylim=(),
                     xlabel="", ylabel="", legendloc=0,
                     linestyles=None, linedash=None):
    """Plot convergence-history curves on ``axis`` for side-by-side method
    comparison; with ``plotdiff`` the global running minimum across all
    curves is subtracted (objective-gap view)."""
    linestyles = _DEFAULT_STYLES if linestyles is None else linestyles
    linedash = _DEFAULT_DASHES if linedash is None else linedash
    y_vals = [np.asarray(y) for y in y_vals]

    y_shift = 0.0
    if plotdiff:
        y_shift = min(y.min() for y in y_vals)

    for i, y in enumerate(y_vals):
        xi = x_vals[i] if len(x_vals) > 0 else np.arange(len(y)) + 1
        axis.plot(xi, y - y_shift, linestyles[i], label=labels[i],
                  dashes=linedash[i])

    axis.set_xscale(xscale)
    axis.set_yscale(yscale)
    axis.set_xlabel(xlabel)
    axis.set_ylabel(ylabel)
    if legendloc == "no":
        pass
    elif legendloc == "outside":
        axis.legend(bbox_to_anchor=(1.05, 1), loc="upper left", borderaxespad=0)
    else:
        axis.legend(loc=legendloc)

    if len(xlim) > 0:
        axis.set_xlim(xlim)
    if len(ylim) > 0:
        axis.set_ylim(ylim)
