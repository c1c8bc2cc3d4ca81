"""Legendre kernels (h-oracles) of the port.

Port of ``accbpg_and_fw_tpu/ops/h_oracles.py`` (reference:
functions.py:238-905): float64 tensors in and out, the kernels' own
constants (``lamda``, ``alpha``, ``sigma``, a radius) as Python floats, and
``L`` a number or a 0-d tensor on the solve's device (the plain Bregman
steps keep their scalars there).  Every prox runs with no host read on
the card, so a graph chunk captures it, but
``SumOf2nd4thPowersWithFrankWolfe``'s, which reads as its LMO does.  Ported: the Burg-entropy family (``BurgEntropy``,
``BurgEntropyL1``, ``BurgEntropyL2``, ``BurgEntropySimplex``,
``BurgEntropyL2Ball``), the Shannon-entropy family, the 2nd+4th-power
kernels (``SumOf2nd4thPowersDualProxMap``'s prox runs its inner loop
in one kernel launch on the card, ``ops/dual_prox.py``), ``SquaredL2Norm``,
``PowerNeg1``, ``L2L1Linf`` and ``PolyDiv``.  ``SumOf2nd4thPowersPositiveOrthantDS`` (the
JAX package's double-single prox, a TPU workaround for slow f64) names the
FP64 class.  Inner products and norms run over every entry, so matrix
iterates (SymNMF's n x r factor) work as vectors do.

The JAX package's deviations from the reference stay: log-sum-exp in the
Shannon simplex proxes, ``PolyDiv``'s prox on the true KKT equation (64
bisection steps on the device) and its ``grad`` with lamda**2.

Out-of-domain inputs give NaN or inf instead of raising, as in JAX; the
drivers' line searches count a NaN trial as a failure.
"""

from __future__ import annotations

import torch

from .base import LegendreOracle, fnorm, vdot
from .dual_prox import dual_prox
from .roots import (bisect_monotone, project_simplex_burg,
                    simplex_inv_multiplier, solve_cubic)
from .simplex import simplex_inv_multiplier_pallas


class BurgEntropy(LegendreOracle):
    """h(x) = -sum_i log(x_i) on the positive orthant."""

    def value(self, x):
        return -torch.sum(torch.log(x))

    def grad(self, x):
        return torch.div(-1.0, x)

    def divergence(self, x, y):
        r = x / y
        t = r - torch.log(r) - 1.0
        # x == y == 0 coordinates are structurally absent (zero-padded
        # columns): their contribution is the limit 0, not 0/0 = NaN.  Other
        # domain violations still give inf or NaN.
        t = torch.where((x == 0) & (y == 0), 0.0, t)
        return torch.sum(t)

    def prox_map(self, g, L):
        # argmin_{x>0} <g,x> - L*sum log x  =>  x = L/g  (needs g > 0)
        return torch.div(L, g)

    def div_prox_map(self, y, g, L):
        return self.prox_map(g + torch.div(L, y), L)


class BurgEntropyL1(BurgEntropy):
    """Burg entropy with Psi(x) = lamda*||x||_1 (reference :274-298).  The
    prox may be unbounded when g approaches -lamda, as in the reference."""

    def __init__(self, lamda=0.0):
        self.lamda = float(lamda)

    def extra_psi(self, x):
        return self.lamda * torch.sum(x)

    def prox_map(self, g, L):
        return torch.div(L, self.lamda + g)


class BurgEntropyL2(BurgEntropy):
    """Burg entropy with Psi(x) = (lamda/2)||x||_2^2 (reference :301-323)."""

    def __init__(self, lamda=0.0):
        self.lamda = float(lamda)

    def extra_psi(self, x):
        return (self.lamda / 2.0) * vdot(x, x)

    def prox_map(self, g, L):
        # x solves lamda*x^2 + g*x - L = 0 per coordinate (positive root);
        # at lamda == 0 the closed form is 0/0, so take the linear limit
        # x = L/g (= 1/gg) instead
        gg = g / L
        lamda_L = self.lamda / L
        if not isinstance(lamda_L, torch.Tensor):
            lamda_L = torch.full((), lamda_L, dtype=gg.dtype, device=gg.device)
        safe = torch.where(lamda_L == 0, 1.0, lamda_L)
        root = (torch.sqrt(gg * gg + 4.0 * safe) - gg) / (2.0 * safe)
        return torch.where(lamda_L == 0, torch.div(1.0, gg), root)


class BurgEntropySimplex(BurgEntropy):
    """Burg entropy restricted to the unit simplex (reference :326-356).

    ``prox_map`` solves ``sum_i 1/(g_i/L + c) = 1`` for the multiplier c
    with ``roots.simplex_inv_multiplier`` (a warm-startable Newton on the
    device: a graph chunk captures it; eagerly it reads its exit test once
    per Newton step).  ``use_pallas=True`` takes the one-kernel multiplier
    of ``ops/simplex.py`` instead: the Hopper kernel on CUDA (one launch, no
    host sync), its plain version on the CPU.  Opt-in, as in JAX.  The
    warm-started pair returns the multiplier as a 0-d tensor, as JAX does,
    for the ``fast_gram`` steps that carry it (no read).
    """

    def __init__(self, eps=1e-8, use_pallas=False):
        self.eps = float(eps)
        self.use_pallas = bool(use_pallas)

    def prox_map(self, g, L):
        gg = g / L
        if self.use_pallas:
            c = simplex_inv_multiplier_pallas(gg)
        else:
            c = simplex_inv_multiplier(gg, self.eps)
        return torch.div(1.0, gg + c)

    # -- warm-started variants for stateful drivers: any carried multiplier
    #    is safe (see roots.simplex_inv_multiplier); they return (x, c) --

    def prox_map_warm(self, g, L, c_prev):
        gg = g / L
        c = simplex_inv_multiplier(gg, self.eps, c_warm=c_prev)
        return torch.div(1.0, gg + c), c

    def div_prox_map_warm(self, y, g, L, c_prev):
        return self.prox_map_warm(g + torch.div(L, y), L, c_prev)


class BurgEntropyL2Ball(BurgEntropy):
    """Burg entropy over an L2 ball on the positive side (reference
    :359-395): the Burg step, projected radially onto the ball, then
    floored at ``delta`` inside the domain."""

    def __init__(self, lamda=0.0, radius=1.0, center=None, delta=1e-30):
        self.lamda = float(lamda)
        self.radius = float(radius)
        self.center = center
        self.delta = float(delta)

    def _center(self, x):
        """The center on ``x``'s device, copied there once (a copy from the
        host cannot be captured)."""
        if self.center is None:
            return torch.zeros_like(x)
        if (not isinstance(self.center, torch.Tensor)
                or self.center.device != x.device
                or self.center.dtype != x.dtype):
            self.center = torch.as_tensor(self.center, dtype=x.dtype,
                                          device=x.device)
        return self.center.expand(x.shape)

    def div_prox_map(self, y, g, L):
        x = torch.div(L, g + torch.div(L, y))
        center = self._center(x)
        x = x - center
        x = x / torch.clamp_min(fnorm(x), self.radius)
        x = x * self.radius
        x = x + center
        return torch.where(x == 0, self.delta, x)


# ---------------------------------------------------------------------------
# Shannon entropy family: h(x) = sum x_i log x_i (reference :398-490)
# ---------------------------------------------------------------------------


class ShannonEntropy(LegendreOracle):
    """h(x) = sum_i x_i log(x_i), h(0) = 0 (reference :398-438)."""

    def __init__(self, delta=1e-20):
        self.delta = float(delta)

    def value(self, x):
        xx = torch.clamp_min(x, self.delta)
        return torch.sum(xx * torch.log(xx))

    def grad(self, x):
        return 1.0 + torch.log(torch.clamp_min(x, self.delta))

    def divergence(self, x, y):
        d = self.delta
        return (torch.sum(x * torch.log((x + d) / (y + d)))
                + (torch.sum(y) - torch.sum(x)))

    def prox_map(self, g, L):
        # argmin_{x>=0} <g,x> + L*h(x)  =>  x = exp(-g/L - 1)
        return torch.exp(-g / L - 1.0)

    def div_prox_map(self, y, g, L):
        # multiplicative / entropic mirror step
        return y * torch.exp(-g / L)


class ShannonEntropyL1(ShannonEntropy):
    """Shannon entropy with Psi(x) = lamda*||x||_1 (reference :441-466)."""

    def __init__(self, delta=1e-20, lamda=0.0):
        super().__init__(delta)
        self.lamda = float(lamda)

    def extra_psi(self, x):
        return self.lamda * torch.sum(x)

    def prox_map(self, g, L):
        return ShannonEntropy.prox_map(self, self.lamda + g, L)

    def div_prox_map(self, y, g, L):
        return ShannonEntropy.div_prox_map(self, y, self.lamda + g, L)


class ShannonEntropySimplex(ShannonEntropy):
    """Shannon entropy on the unit simplex (reference :469-490): both
    proxes are softmaxes over the last axis.  Exactly-zero coordinates of
    y stay zero in ``div_prox_map`` (their logit is -inf)."""

    def prox_map(self, g, L):
        return torch.softmax(-g / L, dim=-1)

    def div_prox_map(self, y, g, L):
        logits = torch.where(
            y > 0, torch.log(torch.clamp_min(y, self.delta)) - g / L,
            -torch.inf)
        return torch.softmax(logits, dim=-1)


# ---------------------------------------------------------------------------
# 2nd+4th power kernels: h(x) = (sigma/2)||x||^2 + (alpha/4)||x||^4
# (reference :493-735)
# ---------------------------------------------------------------------------


class SumOf2nd4thPowers(LegendreOracle):
    """h(x) = (sigma/2)||x||^2 + (alpha/4)||x||^4 (reference :493-555).
    The proxes solve grad h(x) = u: x = u / z with z the real root of the
    cubic z^3 - sigma z^2 = alpha ||u||^2 (``roots.solve_cubic``)."""

    def __init__(self, alpha=1.0, sigma=1.0):
        self.alpha = float(alpha)
        self.sigma = float(sigma)

    def value(self, x):
        n2 = vdot(x, x)
        return (self.alpha / 4.0) * n2 * n2 + (self.sigma / 2.0) * n2

    def grad(self, x):
        n2 = vdot(x, x)
        return (self.sigma + self.alpha * n2) * x

    def _mirror_point(self, y, g, L):
        """u = grad h(y) - g/L, the point whose grad-h-inverse is the prox."""
        z = self.alpha * vdot(y, y) + self.sigma
        return z * y - g / L

    def _grad_inverse(self, u):
        return u / solve_cubic(self.alpha * vdot(u, u), self.sigma)

    def prox_map(self, g, L):
        return self._grad_inverse(-g / L)

    def div_prox_map(self, y, g, L):
        return self._grad_inverse(self._mirror_point(y, g, L))


class SumOf2nd4thPowersPositiveOrthant(SumOf2nd4thPowers):
    """Same kernel, the mirror point clipped to [0, upper_bound] before the
    cubic solve (reference :558-577)."""

    def __init__(self, alpha=1.0, sigma=1.0, upper_bound=None):
        super().__init__(alpha, sigma)
        self.upper_bound = None if upper_bound is None else float(upper_bound)

    def _clip(self, u):
        return torch.clamp(u, 0.0, self.upper_bound)

    def prox_map(self, g, L):
        return self._grad_inverse(self._clip(-g / L))

    def div_prox_map(self, y, g, L):
        return self._grad_inverse(self._clip(self._mirror_point(y, g, L)))


# The JAX package's double-single prox existed because the TPU has no fast
# f64; on the card the FP64 class is that prox.
SumOf2nd4thPowersPositiveOrthantDS = SumOf2nd4thPowersPositiveOrthant


class SumOf2nd4thPowersOnSimplex(SumOf2nd4thPowers):
    """Same kernel on the simplex (reference :580-636): the unconstrained
    cubic prox, then the Burg-Newton map x = 1/(y + c) onto sum(x) = 1."""

    def __init__(self, alpha=1.0, sigma=1.0, radius=1.0, eps=1e-4):
        super().__init__(alpha, sigma)
        self.radius = float(radius)
        self.eps = float(eps)

    def div_prox_map(self, y, g, L):
        x = SumOf2nd4thPowers.div_prox_map(self, y, g, L)
        return project_simplex_burg(x, self.eps)


class SumOf2nd4thPowersDualProxMap(SumOf2nd4thPowers):
    """Same kernel; prox over {x >= 0, ||x|| <= radius} by a primal-dual
    extragradient inner solver (reference :639-698): up to ``num_iters``
    steps with a gap test after every one, and no exit on the first
    step's gap (the reference breaks at ``i > 0 and gap < tolerance``).

    The loop is ``ops/dual_prox.py``: on the card one launch of the kernel
    ``csrc/dual_prox.cu`` runs all of it with no host read (so a graph
    chunk captures the prox); on the CPU the plain version runs it in
    blocks of steps with one read of the exit flag per block."""

    def __init__(self, alpha=1.0, sigma=1.0, num_iters=7000, eta_base=1e-2,
                 tolerance=1e-4, radius=15.0):
        super().__init__(alpha, sigma)
        self.num_iters = int(num_iters)
        self.eta_base = float(eta_base)
        self.tolerance = float(tolerance)
        self.radius = float(radius)

    def div_prox_map(self, y, g, L):
        return self.dual_solve(y, g, L)[0]

    def dual_solve(self, y, g, L):
        """``(X, steps, reads)``: the prox, the extragradient steps the
        loop took (a 0-d tensor) and the host reads of its exit flag (0 on
        the card)."""
        return dual_prox(g + self.grad(y), y, L, alpha=self.alpha,
                         sigma=self.sigma, num_iters=self.num_iters,
                         eta_base=self.eta_base, tol=self.tolerance,
                         radius=self.radius)


class SumOf2nd4thPowersWithFrankWolfe(SumOf2nd4thPowers):
    """Same kernel; ``div_prox_map`` delegates to an LMO (reference
    :701-735)."""

    def __init__(self, alpha=1.0, sigma=1.0, lmo=None):
        super().__init__(alpha, sigma)
        self.lmo = lmo

    @property
    def host_reads(self):
        """Its LMO's: a user's LMO that reads the host (none of the
        port's LMOs does)."""
        return getattr(self.lmo, "host_reads", False)

    def div_prox_map(self, y, g, L):
        return self.lmo(g)


# ---------------------------------------------------------------------------
# Euclidean and other kernels (reference :738-905)
# ---------------------------------------------------------------------------


class SquaredL2Norm(LegendreOracle):
    """h(x) = (1/2)||x||^2, plain Euclidean geometry (reference :738-759)."""

    def value(self, x):
        return 0.5 * vdot(x, x)

    def grad(self, x):
        return x

    def divergence(self, x, y):
        xy = x - y
        return 0.5 * vdot(xy, xy)

    def prox_map(self, g, L):
        return -(1.0 / L) * g

    def div_prox_map(self, y, g, L):
        return y - (1.0 / L) * g


class PowerNeg1(LegendreOracle):
    """h(x) = sum_i 1/x_i on x > 0 (reference :762-779; the value is the
    sum, which the reference's own divergence integrates)."""

    def value(self, x):
        return torch.sum(torch.div(1.0, x))

    def grad(self, x):
        return torch.div(-1.0, x * x)

    def divergence(self, x, y):
        xy = x - y
        return torch.sum(xy * xy / (x * y * y))

    def prox_map(self, g, L):
        return torch.sqrt(torch.div(L, g))

    def div_prox_map(self, y, g, L):
        return self.prox_map(g + torch.div(L, y * y), L)


class L2L1Linf(LegendreOracle):
    """h = (1/2)||x||^2 with Psi = lamda*||x||_1 and the box
    ||x||_inf <= B (reference :782-835): soft-threshold, then clip."""

    def __init__(self, lamda=0.0, B=1.0):
        self.lamda = float(lamda)
        self.B = float(B)

    def value(self, x):
        return 0.5 * vdot(x, x)

    def extra_psi(self, x):
        return self.lamda * torch.sum(torch.abs(x))

    def grad(self, x):
        return x

    def divergence(self, x, y):
        xy = x - y
        return 0.5 * vdot(xy, xy)

    def prox_map(self, g, L):
        x = -(1.0 / L) * g
        thr = self.lamda / L
        x = torch.sign(x) * torch.clamp_min(torch.abs(x) - thr, 0.0)
        return torch.clamp(x, -self.B, self.B)

    def div_prox_map(self, y, g, L):
        return self.prox_map(g - L * y, L)


class PolyDiv(LegendreOracle):
    """Data-dependent polynomial kernel over an L2 ball (arXiv:1710.04718
    eq. 27; reference :838-905):

        h(x) = (lamda^2/4)||x||^4 + (2 lamda Dbar/3)||x||^3 + (Dbar2/2)||x||^2

    with Dbar, Dbar2 the mean row norm and mean squared row norm of the
    dataset.  The prox over the ball is radial, x = -t g/||g||, with t the
    root of L (lamda^2 t^3 + 2 lamda Dbar t^2 + Dbar2 t) = ||g|| clamped
    to [0, radius]: 64 bisection steps on the device (the JAX package's
    form; the reference rescales ||g|| first and calls a conic solver)."""

    def __init__(self, DS_mean=0.0, DS_mean_quad=0.0, lamda=0.0, radius=1.0):
        self.DS_mean = float(DS_mean)
        self.DS_mean_quad = float(DS_mean_quad)
        self.lamda = float(lamda)
        self.radius = float(radius)

    @classmethod
    def from_data(cls, DS, lamda=0.0, radius=1.0):
        DS = (DS.to(torch.float64) if isinstance(DS, torch.Tensor)
              else torch.as_tensor(DS, dtype=torch.float64))
        row_norms = torch.linalg.vector_norm(DS, dim=1)
        return cls(DS_mean=float(torch.mean(row_norms)),
                   DS_mean_quad=float(torch.mean(row_norms**2)),
                   lamda=lamda, radius=radius)

    def value(self, x):
        r = fnorm(x)
        return (self.lamda**2 * 0.25 * r**4
                + 2.0 * self.lamda * self.DS_mean / 3.0 * r**3
                + self.DS_mean_quad * 0.5 * r**2)

    def grad(self, x):
        r2 = vdot(x, x)
        r = torch.sqrt(r2)
        return (self.lamda**2 * r2 + 2.0 * self.lamda * self.DS_mean * r
                + self.DS_mean_quad) * x

    def prox_map(self, g, L):
        gnorm = torch.clamp_min(fnorm(g), 1e-12)
        lam, dbar, dbar2 = self.lamda, self.DS_mean, self.DS_mean_quad

        def phi_prime(t):
            return L * (lam**2 * t**3 + 2.0 * lam * dbar * t**2
                        + dbar2 * t) - gnorm

        t = bisect_monotone(phi_prime, torch.zeros((), dtype=g.dtype,
                                                   device=g.device),
                            self.radius)
        # an unconstrained root past the ball sits on the boundary
        radius = torch.full_like(t, self.radius)
        t = torch.where(phi_prime(radius) <= 0, radius, t)
        return -(t / gnorm) * g

    def div_prox_map(self, y, g, L):
        return self.prox_map(g - L * self.grad(y), L)
