"""Relatively-smooth f-oracles of the port.

Port of ``accbpg_and_fw_tpu/ops/f_oracles.py`` (reference:
functions.py:27-194, 908-1104): ``DOptimalObj``, ``PoissonRegression``,
``KLdivRegression``, ``SVM_fun``, ``FrobeniusSymLoss`` and
``LogisticRegression``.  Each holds its data as float64 tensors on
``device`` (for None a tensor's own device, else CUDA) and reports it as
``device``, where the drivers put their start.

The JAX package's ``*Mixed`` and ``*DS`` oracles (int8-digit and
double-single GEMVs, TPU workarounds for slow f64) name the FP64 classes
here; their ``from_data`` accepts ``levels`` and ignores it.  Also here:
``AX_b`` (the primal-dual driver's constraint) and
``calculate_tse_constant``.  A ``FrobeniusSymLoss`` with ``noise_level``
is stochastic: its gradient adds noise drawn from the key the driver
passes (``_rng``).  ``DOptimalObj`` carries the fast-Gram protocol of the
``fast_gram`` drivers (``gram``, ``logdet_full``, ``inv_seed``,
``grad_from_inv``), and ``DOptimalObjMixed``/``DOptimalObjDS`` name it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _rng
from .._device import as_f64, full, is_dtensor, replicate_like, resolve_device
from .base import SmoothOracle, fnorm, vdot


def _vm(v, A):
    """``v @ A`` for a vector ``v``.  With ``v`` and ``A`` sharded by
    samples, DTensor returns the product as a one-row matrix; this gives
    the vector back (a view of the same result otherwise)."""
    return (v @ A).reshape(A.shape[1:])


class _DataOracle(SmoothOracle):
    """An oracle over float64 data tensors on one device."""

    def _data(self, device, *arrays):
        self.device = resolve_device(device, like=arrays[0])
        self._mn = tuple(int(v) for v in arrays[0].shape)
        return [as_f64(a, self.device) for a in arrays]

    def span_attrs(self):
        return dict(zip("mn", self._mn)) if len(self._mn) == 2 else {}


class DOptimalObj(SmoothOracle):
    """f(x) = -log det(H diag(x) H^T), H is m-by-n with m < n.

    One Cholesky factorization of ``H diag(x) H^T`` serves the log-det and
    the gradient ``g_i = -||R^{-1} h_i||^2`` (one triangular solve).  A
    matrix that is not positive definite gives NaN, as JAX's Cholesky does
    (``cholesky_ex``, so no host sync on CUDA).  ``H`` is held as a float64
    tensor on ``device`` (for None a tensor's own device, else CUDA).

    ``n_valid``: when set (by ``parallel.shard_dopt_problem`` for a padded
    design), gradient entries past it report +1e30 instead of the 0 a
    zero-padded column gives, so every Burg/simplex prox sends padded
    coordinates to ~1e-30 mass.  ``H`` may be a column-sharded DTensor;
    the Gram contraction then sums over the mesh.
    """

    def __init__(self, H, n_valid=None, device=None):
        self.H = as_f64(H, resolve_device(device, like=H))
        self.n_valid = None if n_valid is None else int(n_valid)
        self._pads = None

    def span_attrs(self):
        return {"m": int(self.m), "n": int(self.n)}

    @classmethod
    def from_design(cls, H, levels=7, max_diag=6, device=None):
        """The JAX ``DOptimalObjMixed``/``DOptimalObjDS`` constructor;
        ``levels`` and ``max_diag`` (digit planes) have no meaning in
        FP64."""
        return cls(H, device=device)

    @property
    def device(self):
        return self.H.device

    @property
    def m(self):
        return self.H.shape[0]

    @property
    def n(self):
        return self.H.shape[1]

    def _mask_pads(self, g):
        if self.n_valid is None:
            return g
        if self._pads is None:
            # the pad lanes, placed as the gradient is (a sharded gradient
            # takes a mask sharded the same way)
            pads = torch.arange(g.shape[-1], device=g.device) >= self.n_valid
            if is_dtensor(g):
                from torch.distributed.tensor import distribute_tensor
                pads = distribute_tensor(pads, g.device_mesh, g.placements)
            self._pads = pads
        return torch.where(self._pads, 1e30, g)

    def _chol(self, x):
        HXHT = (self.H * x) @ self.H.T
        R, info = torch.linalg.cholesky_ex(HXHT)
        return R, info == 0

    def value(self, x, key=None):
        R, ok = self._chol(x)
        f = -2.0 * torch.sum(torch.log(torch.diagonal(R)))
        return torch.where(ok, f, torch.nan)

    def value_and_grad(self, x, key=None):
        R, ok = self._chol(x)  # lower triangular, HXHT = R R^T
        f = -2.0 * torch.sum(torch.log(torch.diagonal(R)))
        # g_i = -h_i^T (HXHT)^{-1} h_i = -||R^{-1} h_i||^2
        W = torch.linalg.solve_triangular(R, self.H, upper=False)
        g = -torch.sum(W * W, dim=0)
        return (torch.where(ok, f, torch.nan),
                self._mask_pads(torch.where(ok, g, torch.nan)))

    # -- fast-Gram protocol (the fast_gram drivers, algorithms/fastgram.py):
    #    the Gram H diag(x) H^T is linear in x, so drivers whose iterates
    #    are convex combinations of carried points combine carried m x m
    #    Grams instead of contracting H again.  With a sharded H the Gram
    #    is summed over the mesh once, here, and every m x m quantity after
    #    it is a plain tensor that each rank holds whole --

    def gram(self, x):
        return full((self.H * x) @ self.H.T)

    def logdet_full(self, G):
        R, info = torch.linalg.cholesky_ex(G)
        ld = 2.0 * torch.sum(torch.log(torch.diagonal(R)))
        return torch.where(info == 0, ld, torch.nan)

    def inv_seed(self, G):
        """The inverse of the m x m Gram by its Cholesky factor (two
        triangular solves against I), for the caller's Schulz polish;
        NaN where G is not positive definite."""
        R, info = torch.linalg.cholesky_ex(G)
        eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
        return torch.where(info == 0, torch.cholesky_solve(eye, R), torch.nan)

    def grad_from_inv(self, M):
        # the pad mask matters here too: ABDA with fast_gram on a padded
        # problem feeds this gradient into prox_map on accumulated duals
        M = replicate_like(M, self.H)
        return self._mask_pads(-torch.sum(self.H * (M @ self.H), dim=0))


class PoissonRegression(_DataOracle):
    """f(x) = D_KL(b, Ax) for the linear inverse problem Ax ~ b
    (reference: functions.py:85-120)."""

    def __init__(self, A, b, device=None):
        self.A, self.b = self._data(device, A, b)

    @classmethod
    def from_data(cls, A, b, levels=None, max_diag=None, device=None):
        """The JAX ``*Mixed``/``*DS`` constructor; ``levels`` and
        ``max_diag`` (digit planes) have no meaning in FP64."""
        return cls(A, b, device=device)

    def value(self, x, key=None):
        Ax = self.A @ x
        return torch.sum(self.b * torch.log(self.b / Ax) + Ax - self.b)

    def grad(self, x, key=None):
        return _vm(1.0 - self.b / (self.A @ x), self.A)

    def value_and_grad(self, x, key=None):
        Ax = self.A @ x
        f = torch.sum(self.b * torch.log(self.b / Ax) + Ax - self.b)
        return f, _vm(1.0 - self.b / Ax, self.A)


class KLdivRegression(PoissonRegression):
    """f(x) = D_KL(Ax, b) (reference: functions.py:123-158)."""

    def value(self, x, key=None):
        Ax = self.A @ x
        return torch.sum(Ax * torch.log(Ax / self.b) - Ax + self.b)

    def grad(self, x, key=None):
        return _vm(torch.log((self.A @ x) / self.b), self.A)

    def value_and_grad(self, x, key=None):
        Ax = self.A @ x
        r = torch.log(Ax / self.b)
        return torch.sum(Ax * r - Ax + self.b), _vm(r, self.A)


class SVM_fun(_DataOracle):
    """Mean hinge loss + (lamda/2)||x||^2 with its subgradient
    (reference: functions.py:161-194)."""

    def __init__(self, lamda=0.5, A=None, y=None, device=None):
        self.lamda = float(lamda)
        self.A, self.y = self._data(device, A, y)

    @classmethod
    def from_data(cls, A, y, lamda=0.5, levels=None, device=None):
        """The JAX ``SVMfunMixed`` constructor; ``levels`` is ignored."""
        return cls(lamda=lamda, A=A, y=y, device=device)

    def hinge_loss(self, x):
        return torch.mean(torch.clamp_min(1.0 - self.y * (self.A @ x), 0.0))

    def value(self, x, key=None):
        return self.hinge_loss(x) + (self.lamda / 2.0) * vdot(x, x)

    def subgradient_loss(self, x):
        active = (self.y * (self.A @ x) < 1.0).to(x.dtype)
        return _vm(active * self.y, self.A) / self.A.shape[0]

    def grad(self, x, key=None):
        return self.lamda * x - self.subgradient_loss(x)

    def value_and_grad(self, x, key=None):
        margin = self.y * (self.A @ x)
        f = (torch.mean(torch.clamp_min(1.0 - margin, 0.0))
             + (self.lamda / 2.0) * vdot(x, x))
        active = (margin < 1.0).to(x.dtype)
        g = self.lamda * x - _vm(active * self.y, self.A) / self.A.shape[0]
        return f, g


class FrobeniusSymLoss(_DataOracle):
    """SymNMF loss f(X) = 0.5*||M - X X^T||_F^2 (reference:
    functions.py:908-1034), in the expanded form
    0.5*(||M||^2 + ||X^T X||^2) - <X, M X>, so the large products are M X
    (n x n x r) and X^T X (r x r), never the n x n outer product.

    ``noise_level`` marks the oracle stochastic: a gradient evaluated with
    a draw key adds ``(normal - 0.5) * noise_level`` (``_rng.normal``, the
    JAX oracle's ``jax.random.normal`` draws, on x's device); without a key
    it is exact."""

    def __init__(self, M, M_norm=None, noise_level=None, device=None):
        (self.M,) = self._data(device, M)
        self.M_norm = (fnorm(self.M) if M_norm is None
                       else as_f64(M_norm, self.M.device))
        self.noise_level = noise_level
        self.stochastic = noise_level is not None

    @classmethod
    def create(cls, M, X_init=None, noise_level=None, device=None):
        """The reference's constructor (``X_init`` only sized its scratch
        buffers there)."""
        del X_init
        return cls(M, noise_level=noise_level, device=device)

    @classmethod
    def from_data(cls, M, levels=None, device=None):
        """The JAX ``FrobeniusSymLossMixed``/``DS`` constructor; ``levels``
        is ignored."""
        return cls(M, device=device)

    def value(self, x, key=None):
        XtX = x.T @ x
        nrm = torch.linalg.vector_norm(XtX)
        return (0.5 * (self.M_norm * self.M_norm + nrm * nrm)
                - vdot(x, self.M @ x))

    def _noise(self, x, key):
        if self.noise_level is None or key is None:
            return 0.0
        return ((_rng.normal(_rng.as_key(key, x.device), x.shape) - 0.5)
                * self.noise_level)

    def _exact_grad(self, x):
        return 2.0 * (x @ (x.T @ x) - self.M @ x)

    def _value_and_exact_grad(self, x):
        XtX = x.T @ x
        MX = self.M @ x
        nrm = torch.linalg.vector_norm(XtX)
        f = 0.5 * (self.M_norm * self.M_norm + nrm * nrm) - vdot(x, MX)
        return f, 2.0 * (x @ XtX - MX)

    def grad(self, x, key=None):
        return self._exact_grad(x) + self._noise(x, key)

    def value_and_grad(self, x, key=None):
        f, G = self._value_and_exact_grad(x)
        return f, G + self._noise(x, key)

    # The drivers' keyed form (``bpg._keyed``): ``(next key, grad(x,
    # key=sub))`` with ``(key, sub) = split(key)``, JAX's split and noisy
    # gradient as one fused expression: one launch on the card
    # (``_rng.split_noise``), the plain version on a CPU key, bit for bit
    # the unfused composition either way.
    def _with_noise(self, x, key, G):
        if self.noise_level is None:  # exact: the unfused composition
            key, sub = _rng.split(key)
            return key, G + self._noise(x, sub)
        key, _, g = _rng.split_noise(key, x.shape, 0.5, self.noise_level, G)
        return key, g

    def _grad_keyed(self, x, key):
        return self._with_noise(x, key, self._exact_grad(x))

    def _value_and_grad_keyed(self, x, key):
        f, G = self._value_and_exact_grad(x)
        key, g = self._with_noise(x, key, G)
        return key, (f, g)


class LogisticRegression(_DataOracle):
    """Mean logistic loss f(w) = mean_i log(1 + exp(-y_i x_i^T w))
    (reference: functions.py:1068-1104).

    The value is ``logaddexp(0, -z)``, which is ``jax.nn.softplus``;
    ``torch.nn.functional.softplus`` returns its input past its threshold
    of 20, which misses the log1p(exp(-z)) tail that ill-conditioned
    logits reach.  The gradient is -X^T (y sigmoid(-z)) / m."""

    def __init__(self, X, y, alpha=0.01, device=None):
        self.X, self.y = self._data(device, X, y)
        self.alpha = float(alpha)

    def _z(self, x):
        return self.y * (self.X @ x)

    @staticmethod
    def _softplus(a):
        return torch.logaddexp(torch.zeros_like(a), a)

    def value(self, x, key=None):
        return torch.mean(self._softplus(-self._z(x)))

    def f(self, x):  # reference alias
        return self.value(x)

    def grad(self, x, key=None):
        w = torch.sigmoid(-self._z(x)) * self.y
        return -_vm(w, self.X) / self.X.shape[0]

    def value_and_grad(self, x, key=None):
        z = self._z(x)
        w = torch.sigmoid(-z) * self.y
        return (torch.mean(self._softplus(-z)),
                -_vm(w, self.X) / self.X.shape[0])

    def hessian(self, x):
        s = torch.sigmoid(-self._z(x))
        d = s * (1.0 - s)  # y_i^2 = 1
        return (self.X.T * d) @ self.X / self.X.shape[0]


class AX_b(_DataOracle):
    """Affine map f(X) = X A - b, the constraint function of the
    primal-dual switching method (reference: functions.py:1037-1065).
    Its gradient is the constant A.  As in JAX, value and value_and_grad
    both compute X @ A - b (the reference's flag=0 orientation, the one the
    primal-dual driver uses)."""

    def __init__(self, A=None, b=None, device=None):
        self.A, self.b = self._data(device, A, b)

    def value(self, x, key=None):
        return x @ self.A - self.b

    def grad(self, x, key=None):
        return self.A

    def value_and_grad(self, x, key=None):
        return self.value(x), self.A


def calculate_tse_constant(h, x_next, y, z_next, z, alpha):
    """Empirical maximal triangle-scaling exponent gamma with
    D(x+, y) <= alpha^gamma * D(z+, z)  (reference: functions.py:1107-1152).

    The JAX function's vectorised scan of the reference's downward
    1e-5-step grid from 2.5: alpha in (0, 1) makes the feasible set a
    down-set, so the answer is its largest grid point (1.01 - 2e-5 when
    none is feasible, the reference's ``gamma < 1.01`` exit).  Returns a
    0-d tensor on the divergences' device."""
    if not (0 < alpha < 1):
        raise ValueError("Step size alpha must be in the interval (0, 1)")
    lhs = h.divergence(x_next, y)
    rhs = h.divergence(z_next, z)
    # numpy's grid is jnp.arange's, point for point
    gammas = torch.from_numpy(np.arange(2.5, 1.01 - 1e-5, -1e-5)).to(
        lhs.device)
    ok = lhs <= torch.pow(alpha, gammas) * rhs
    idx = torch.argmax(ok.to(torch.uint8))  # the first feasible point
    return torch.where(ok.any(), gammas[idx], gammas[-1] - 1e-5)


# The JAX package's int8-digit (Mixed) and double-single (DS) oracles are
# TPU workarounds for slow f64; on the card the FP64 classes are those
# oracles, exact (no ``accept_tol``).
DOptimalObjMixed = DOptimalObjDS = DOptimalObj
PoissonRegressionMixed = PoissonRegressionDS = PoissonRegression
KLdivRegressionMixed = KLdivRegressionDS = KLdivRegression
SVMfunMixed = SVM_fun
FrobeniusSymLossMixed = FrobeniusSymLossDS = FrobeniusSymLoss
