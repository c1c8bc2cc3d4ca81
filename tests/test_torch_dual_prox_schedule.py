"""The dual prox kernel's schedule (``csrc/dual_prox.cu``) on the CPU: a
torch model of its step, three reductions with the two folds the kernel
makes, against the port's plain loop (``ops/dual_prox.dual_prox_reference``)
and the JAX oracle's ``div_prox_map``.

The folds: <X_mid, X_mid> is the sum of a^2 (a = X + eta gX) that
reduction A carries where the projection on a is inactive, and radius^2
where it is active; f(X_cand, lam_new) comes from sums that reduction D
carries beside f(X_new, lam_cand)'s, in the branch that the projection on
e = X_new + eta gX takes, with sum G y summed once before the loop.  The
model takes each branch by the norm, as every thread of the kernel does.

Cases at 12x5 and 60x10: the projection inactive throughout, active
throughout, and switching from inactive to active (a tolerance below any
gap keeps the loop running through the switch).  Bars: the same steps as
the plain loop, X within 1e-12 of its largest entry against both.  The
tolerances and radii keep the exit away from an exact tie: where the
projection is active in every step the gap is eta_base radius^2 / (it + 1)
in exact arithmetic, and at a tie the fold's radius^2 and the plain loop's
rounded sum of squares may exit a step apart.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu as acc
from accbpg_and_fw_tpu_torch.ops import dual_prox as dp

ALPHA, SIGMA, L, ETA_BASE, NUM_ITERS = 6.0, 3.0, 2.0, 1e-2, 300

# regime: (radius, tol) at each shape
CASES = {
    "inactive": {(12, 5): (15.0, 1e-4), (60, 10): (15.0, 1e-4)},
    "active": {(12, 5): (0.05, 3e-6), (60, 10): (0.13, 2.9e-6)},
    "switching": {(12, 5): (0.25, -1.0), (60, 10): (0.68, -100.0)},
}


def three_reductions(G, y, *, radius, tol):
    """The kernel's loop: ``(X, steps, active)``, ``active`` the steps in
    which the projection of a, of d = X + eta gXm and of e was active."""
    X, lam = torch.zeros_like(y), torch.zeros_like(y)
    it, gap, n2 = 0.0, math.inf, 0.0
    Gy = float((G * y).sum())  # the reduction before the loop
    r2 = radius * radius
    active = np.zeros(3, dtype=int)

    def quartic(n2):
        return L * (ALPHA / 4.0 * n2 * n2 + SIGMA / 2.0 * n2)

    while it < NUM_ITERS and (it <= 1 or gap >= tol):
        eta = ETA_BASE / (it + 1.0)
        gX = G - L * (ALPHA * n2 * X + SIGMA * X) - lam
        a = X + eta * gX
        ap = a.clamp_min(0.0)
        sa = torch.stack([(ap * ap).sum(), (a * a).sum()]).tolist()  # A
        norm_a = math.sqrt(sa[0])
        in_a = norm_a <= radius
        X_mid = a if in_a else (radius / norm_a) * ap
        n2m = sa[1] if in_a else r2  # fold: <X_mid, X_mid>
        lam_mid = (lam + eta * X).clamp_min(0.0)
        gXm = G - L * (ALPHA * n2m * X_mid + SIGMA * X_mid) - lam_mid
        d = X + eta * gXm
        dp_ = d.clamp_min(0.0)
        norm_d = math.sqrt(float((dp_ * dp_).sum()))  # C
        in_d = norm_d <= radius
        X_new = d if in_d else (radius / norm_d) * dp_
        lam_new = (lam + eta * X_mid).clamp_min(0.0)
        e = X_new + eta * gX
        lam_cand = (lam_new + eta * X).clamp_min(0.0)
        ep = e.clamp_min(0.0)
        sd = torch.stack([                                            # D
            (ep * ep).sum(), (G * (X_new - y)).sum(), (X_new * X_new).sum(),
            (lam_cand * X_new).sum(), (G * (e - y)).sum(), (e * e).sum(),
            (lam_new * e).sum(), (G * ep).sum(), (lam_new * ep).sum()]).tolist()
        f_new = sd[1] - quartic(sd[2]) - sd[3]
        norm_e = math.sqrt(sd[0])
        if norm_e <= radius:  # fold: f(X_cand, lam_new)
            f_cand = sd[4] - quartic(sd[5]) - sd[6]
        else:
            s = radius / norm_e
            f_cand = s * sd[7] - Gy - quartic(r2) - s * sd[8]
        active += [not in_a, not in_d, norm_e > radius]
        gap, it, n2 = f_cand - f_new, it + 1.0, sd[2]
        X, lam = X_new, lam_new
    return X, it, active


@functools.lru_cache(maxsize=None)
def _jax_prox():
    # one compile a shape: radius and tol are traced, num_iters is static
    def prox(y, g, radius, tol):
        h = acc.SumOf2nd4thPowersDualProxMap(
            alpha=ALPHA, sigma=SIGMA, num_iters=NUM_ITERS, eta_base=ETA_BASE,
            tolerance=tol, radius=radius)
        return h.div_prox_map(y, g, L)
    return jax.jit(prox)


@pytest.mark.parametrize("regime", list(CASES))
@pytest.mark.parametrize("shape", [(12, 5), (60, 10)])
def test_three_reduction_step_matches_plain_and_jax(shape, regime):
    radius, tol = CASES[regime][shape]
    rng = np.random.default_rng(4)
    y, G = rng.random(shape), torch.tensor(rng.standard_normal(shape))
    # JAX's oracle takes g and adds grad h(y) itself
    hj = acc.SumOf2nd4thPowersDualProxMap(alpha=ALPHA, sigma=SIGMA)
    g = G.numpy() - np.asarray(hj.grad(jnp.asarray(y)))
    X, steps, active = three_reductions(G, torch.tensor(y), radius=radius,
                                        tol=tol)
    if regime == "inactive":
        assert not active.any()
    elif regime == "active":
        assert (active == steps).all()
    else:
        assert ((active > 0) & (active < steps)).all()
    Xp, steps_p, _ = dp.dual_prox_reference(
        G, torch.tensor(y), L, alpha=ALPHA, sigma=SIGMA, num_iters=NUM_ITERS,
        eta_base=ETA_BASE, tol=tol, radius=radius)
    assert steps == float(steps_p)
    assert float((X - Xp).abs().max() / Xp.abs().max()) <= 1e-12
    Xj = np.asarray(_jax_prox()(jnp.asarray(y), jnp.asarray(g), radius, tol))
    assert np.abs(X.numpy() - Xj).max() / np.abs(Xj).max() <= 1e-12
