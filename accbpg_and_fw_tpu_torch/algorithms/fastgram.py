"""Linear-Gram machinery of the ``fast_gram`` drivers, in FP64.

Port of ``accbpg_and_fw_tpu/algorithms/fastgram.py`` (:36-:127 and
:342-:373).  The D-opt Gram G(x) = V diag(x) V^T is linear in x, so a
driver whose iterates are convex combinations of carried points combines
carried m x m Grams instead of contracting V again, inverts them by a
warm-started Newton-Schulz polish instead of a factorization, and advances
log-determinants through the exact identity

    logdet G' = logdet G + logdet(M G') - logdet(M G)     (any M),

each term an 8-term trace series when ``||I - M G||_F <= 0.03``, the
oracle's full factorization otherwise.  Oracles opt in by exposing
``gram`` / ``logdet_full`` / ``inv_seed`` / ``grad_from_inv``
(``DOptimalObj``).  The JAX double-single engine (:144-:335) has no
counterpart: the port computes in FP64, and ``fast_gram="ds"`` runs this
engine.

**The gates.**  Two decisions choose a branch: ``inv_at`` warm-starts
Schulz from the carried inverse when ``||I - M_prev G||_F^2 <=
WARM_TAU2`` and reseeds it from ``f.inv_seed`` otherwise, and
``anchored_logdet_shift`` takes the series when ``||I - M G||_F^2 <=
SERIES_TAU2`` and ``f.logdet_full`` otherwise.  JAX decides with a
``lax.cond`` on the device; here both branches are computed on the
device and ``torch.where`` takes one on the same float64 sum against the
same threshold (a NaN sum takes the fallback, as there), so no gate reads
the host and a graph chunk captures it.  The branch not taken may hold a
NaN (``inv_seed`` of a Gram that is not positive definite) or an inf (the
series past its gate); the select drops it.

``TALLY`` counts, per gate, the decisions taken in the Python form (no
graph chunk being built), one read each, for the measurement scripts.
"""

from __future__ import annotations

import torch

from .. import _loops
from .._device import full

SERIES_TAU2 = 0.03 ** 2  # ||E||_F^2 gate for the 8-term logdet series
WARM_TAU2 = 0.05 ** 2    # gate for warm-starting Schulz from a carried M

_PROTOCOL = ("gram", "logdet_full", "inv_seed", "grad_from_inv")

#: set to a dict to tally, per gate, the decisions of the Python-form runs
#: (``{"warm start" | "series": {True: common, False: fallback}}``)
TALLY = [None]


def supports_fast_gram(f):
    return all(hasattr(f, a) for a in _PROTOCOL)


def require_fast_gram(f):
    if not supports_fast_gram(f):
        raise ValueError(
            "fast_gram=True needs a linear-Gram oracle exposing "
            "gram/logdet_full/inv_seed/grad_from_inv "
            "(DOptimalObj or DOptimalObjMixed)")


def _gate(name, q, tau):
    """Whether the gate with sum ``q`` takes its common branch, a 0-d bool
    tensor (a NaN sum takes the fallback, as in JAX)."""
    ok = q <= tau
    if TALLY[0] is not None and _loops.OVERFLOW[0] is None:
        counts = TALLY[0].setdefault(name, {})
        d = bool(full(ok))
        counts[d] = counts.get(d, 0) + 1
    return ok


def schulz(M, G, steps=4):
    """Newton-Schulz inverse polish: M <- 2M - M G M (matmul-only; the
    error ||I - G M|| squares per step, so 4 steps take a 5e-2 warm start
    to below 1e-12)."""
    for _ in range(steps):
        M = 2.0 * M - M @ (G @ M)
    return M


def _eye(G):
    return torch.eye(G.shape[0], dtype=G.dtype, device=G.device)


def comb(theta, A, B):
    """(1 - theta) A + theta B of two m x m Grams, the drivers' convex
    combination; a sharded solve's replicated theta enters as the value
    every rank holds."""
    theta = full(theta)
    return (1.0 - theta) * A + theta * B


def inv_at(f, G, M_prev):
    """Inverse of the m x m Gram G, warm-started from a carried inverse of
    a nearby Gram when quadratic Schulz convergence is certain, reseeded
    from the oracle's factorization otherwise: both seeds computed, the
    gate selecting one, and the Schulz polish run once on it."""
    E0 = _eye(G) - M_prev @ G
    warm = _gate("warm start", torch.sum(E0 * E0), WARM_TAU2)
    return schulz(torch.where(warm, M_prev, f.inv_seed(G)), G)


def series_logdet(E):
    """log det(I - E) via 8 trace terms and 3 m x m matmuls.

    tr(E^j) for j = 5..8 come free as elementwise contractions of the
    computed powers (tr(AB) = sum(A * B^T)).  Truncation error is
    <= m ||E||^9 / (9 (1 - ||E||)) ~ 6e-13 at the gate ||E||_F <= 0.03.
    """
    E2 = E @ E
    E3 = E @ E2
    E4 = E2 @ E2
    t1 = torch.trace(E)
    t2 = torch.trace(E2)
    t3 = torch.trace(E3)
    t4 = torch.trace(E4)
    t5 = torch.sum(E2 * E3.T)
    t6 = torch.sum(E3 * E3.T)
    t7 = torch.sum(E3 * E4.T)
    t8 = torch.sum(E4 * E4.T)
    return -(t1 + t2 / 2 + t3 / 3 + t4 / 4 + t5 / 5 + t6 / 6 + t7 / 7
             + t8 / 8)


def anchored_logdet_shift(f, ld_anchor, sign, M, G_series, G_target):
    """(logdet(G_target), shift) from a known anchor logdet.

    ``sign=+1``: target = the G entering the series, anchor = the point M
    inverts:      ld_target = ld_anchor + logdet(M G_series).
    ``sign=-1``: target = the point M inverts, anchor = the series G:
                  ld_target = ld_anchor - logdet(M G_series).
    Falls back to the oracle's full factorization of G_target when the
    series residual is too large (both computed, the gate selecting).  A
    sharded solve's replicated anchor enters as the value every rank holds,
    as the Grams are.

    The shift (ld_target - ld_anchor) is returned separately because it is
    the series value itself, absolutely accurate to ~1e-16 even when the
    logdets are O(1): descent acceptances test the shift, since comparing
    two separately computed O(1) values loses the difference to
    cancellation once the descent margin shrinks below their rounding.  In
    the fallback the shift is a difference, but there ||E|| > 0.03, so it
    is large and the cancellation harmless.
    """
    ld_anchor = full(ld_anchor)
    E = _eye(G_series) - M @ G_series
    ok = _gate("series", torch.sum(E * E), SERIES_TAU2)
    s = torch.where(ok, sign * series_logdet(E),
                    f.logdet_full(G_target) - ld_anchor)
    return ld_anchor + s, s


def anchored_logdet(f, ld_anchor, sign, M, G_series, G_target):
    """logdet(G_target) from a known anchor (see anchored_logdet_shift)."""
    return anchored_logdet_shift(f, ld_anchor, sign, M, G_series,
                                 G_target)[0]


def init_state(f, x0):
    """Gram, inverse and logdet at the starting point: ``{"G0", "M0",
    "ld0"}``, the logdet a 0-d tensor (no read)."""
    G0 = f.gram(x0)
    return dict(G0=G0, M0=schulz(f.inv_seed(G0), G0), ld0=f.logdet_full(G0))


def refresh_state(f, x, z, with_z=True):
    """Chunk-boundary recontraction of the carried Grams, inverse and
    logdet from the exact iterates, so combination and series rounding
    cannot accumulate past one chunk.  Returns the recomputed carry
    entries (``Gx``, ``Minv``, ``Gz`` with ``with_z``, and ``fx``), all
    tensors on the device, with no read."""
    Gx = f.gram(x)
    out = {"Gx": Gx, "fx": -f.logdet_full(Gx),
           "Minv": schulz(f.inv_seed(Gx), Gx)}
    if with_z:
        out["Gz"] = f.gram(z)
    return out
