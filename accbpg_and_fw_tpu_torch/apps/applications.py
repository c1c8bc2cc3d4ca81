"""Problem factories of the port (counterpart of
``accbpg_and_fw_tpu/apps/applications.py``).

Each returns the JAX factory's tuple with the data as float64 tensors on
``device`` (CUDA for None; ``"cpu"`` asks for the CPU).  The factories
driven by the global ``np.random`` state (``D_opt_design``,
``D_opt_KYinit``, the Poisson/KL regressions, the SVM ball and the SymNMF
instances) make the JAX package's numpy calls in its order, so the same
seed gives the same arrays bit for bit.  ``svm_digits_ds_divs_ball``
draws its dataset from an unseeded generator, as there.

The logistic generators ``L0L1_FW_log_reg`` and ``hard_FW_log_reg_jax``
keep their names and signatures, with ``key`` an int seed, a
``torch.Generator`` or a JAX key array (``jax.random.PRNGKey(s)`` gives
the seed s), and an optional ``device``.  They make the same sequence of
draws with torch's generator on the target device, so their arrays are
not JAX's (nor the same on the CPU and the card): to run both packages on
one
instance, hand JAX's ``X`` and ``y`` to the port's
``LogisticRegression``.

``D_opt_libsvm`` and the a9a loaders read LIBSVM files with the port's
own parser (``utils.load_libsvm_file``); ``L0L1_FW_log_reg_a9a`` draws its
start from ``np.random``, as there.
"""

from __future__ import annotations

import numbers
import warnings

import numpy as np
import torch

from .._device import DTYPE, as_f64, resolve_device
from ..ops.f_oracles import (AX_b, DOptimalObj, FrobeniusSymLoss,
                             KLdivRegression, LogisticRegression,
                             PoissonRegression, SVM_fun)
from ..ops.h_oracles import (BurgEntropyL1, BurgEntropyL2,
                             BurgEntropySimplex, PolyDiv, ShannonEntropyL1,
                             SquaredL2Norm, SumOf2nd4thPowers,
                             SumOf2nd4thPowersPositiveOrthant)
from .utils import (edge_point_on_simplex, generate_dataset_for_svm,
                    load_libsvm_file, random_point_in_l2_ball,
                    random_point_on_simplex)


def _numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def D_opt_libsvm(filename, device=None):
    """D-optimal design from a LIBSVM dataset, transposed so m < n
    (reference: applications.py:17-33).  Returns ``(f, h, L, x0)`` with H
    and x0 float64 on ``device`` (CUDA for None)."""
    dev = resolve_device(device)
    X, _ = load_libsvm_file(filename)
    H = X.T.toarray("C") if X.shape[0] > X.shape[1] else X.toarray("C")
    n = H.shape[1]
    return (DOptimalObj(H, device=dev), BurgEntropySimplex(), 1.0,
            torch.full((n,), 1.0 / n, dtype=DTYPE, device=dev))


def D_opt_design(m, n, randseed=-1, oracle=None, device=None):
    """Random D-optimal design instance: H ~ randn(m, n), Burg-simplex h,
    L = 1, x0 = center of simplex (reference: applications.py:36-56).
    Returns ``(f, h, L, x0)`` with H and x0 float64 on ``device`` (CUDA
    for None; ``"cpu"`` asks for the CPU).

    ``oracle="mixed"`` (the JAX package's int8-digit oracle, a TPU
    workaround for slow f64) is accepted and gives the FP64
    ``DOptimalObj``."""
    if oracle not in (None, "mixed"):
        raise ValueError(f"unknown oracle={oracle!r} (None or 'mixed')")
    dev = resolve_device(device)
    if randseed > 0:
        np.random.seed(randseed)
    H = np.random.randn(m, n)
    x0 = torch.full((n,), 1.0 / n, dtype=DTYPE, device=dev)
    return DOptimalObj(H, device=dev), BurgEntropySimplex(), 1.0, x0


def D_opt_KYinit(V, device=None):
    """Kumar-Yildirim sparse initial point via Gram-Schmidt probe directions
    (JOTA 126(1):1-21, 2005; reference: applications.py:59-95).

    Draws ``m`` vectors from ``np.random.rand``, as the JAX function does.
    Returns a float64 tensor on ``device`` (for None: V's device where V
    is a tensor, else CUDA)."""
    dev = resolve_device(device, like=V)
    V = np.asarray(V.cpu() if isinstance(V, torch.Tensor) else V)
    m, n = V.shape
    if n <= 2 * m:
        return torch.full((n,), 1.0 / n, dtype=DTYPE, device=dev)

    chosen = []
    Q = np.zeros((m, m))
    for i in range(m):
        b = np.random.rand(m)
        q = b - Q[:, :i] @ (Q[:, :i].T @ b)
        qV = q @ V
        kmax, kmin = int(np.argmax(qV)), int(np.argmin(qV))
        chosen += [kmax, kmin]
        v = V[:, kmin] - V[:, kmax]
        q = v - Q[:, :i] @ (Q[:, :i].T @ v)
        Q[:, i] = q / np.linalg.norm(q)

    x0 = np.zeros(n)
    x0[chosen] = 1.0 / len(chosen)
    x0 /= x0.sum()
    return torch.tensor(x0, dtype=DTYPE, device=dev)


# ---------------------------------------------------------------------------
# Poisson / KL regression (reference: applications.py:98-295)
# ---------------------------------------------------------------------------


def _poisson_data(m, n, noise, randseed, normalizeA):
    if randseed > 0:
        np.random.seed(randseed)
    A = np.random.rand(m, n)
    if normalizeA:
        A = A / A.sum(axis=0)
    x = np.random.rand(n) / n
    x = np.maximum(x - x.sum() / x.size, 0) * 10
    b = A @ x + noise * (np.random.rand(m) - 0.5)
    assert b.min() > 0, "need b > 0 for nonnegative regression."
    return A, b


def _regression_oracle(kind, A, b, oracle, levels, device):
    """The f-oracle of a Poisson/KL regression factory.  Every ``oracle``
    of the JAX package (None, "mixed", "ds", "auto") gives the FP64
    oracle: its int8-digit and double-single engines were TPU workarounds
    for slow f64.  ``levels`` (their digit planes) has no meaning here."""
    if oracle not in (None, "mixed", "ds", "auto"):
        raise ValueError(f"unknown oracle {oracle!r}; expected None, "
                         "'mixed', 'ds' or 'auto'")
    if levels is not None:
        warnings.warn(f"levels={levels!r} is ignored: the port's regression "
                      "oracles are FP64 and have no digit planes",
                      stacklevel=3)
    cls = {"poisson": PoissonRegression, "kl": KLdivRegression}[kind]
    return cls(A, b, device=device)


def Poisson_regrL1(m, n, noise=0.01, lamda=0, randseed=-1, normalizeA=True,
                   oracle=None, levels=None, device=None):
    """L1-regularized Poisson regression: min_{x>=0} D_KL(b, Ax) + lamda|x|_1
    (reference: applications.py:98-134).  ``oracle``, ``levels``: see
    ``_regression_oracle``."""
    dev = resolve_device(device)
    A, b = _poisson_data(m, n, noise, randseed, normalizeA)
    f = _regression_oracle("poisson", A, b, oracle, levels, dev)
    return (f, BurgEntropyL1(lamda=lamda), float(b.sum()),
            torch.full((n,), 10.0 / n, dtype=DTYPE, device=dev))


def Poisson_regrL2(m, n, noise=0.01, lamda=0, randseed=-1, normalizeA=True,
                   oracle=None, levels=None, device=None):
    """L2-regularized Poisson regression (reference: applications.py:137-172).
    ``oracle``, ``levels``: see ``_regression_oracle``."""
    dev = resolve_device(device)
    A, b = _poisson_data(m, n, noise, randseed, normalizeA)
    f = _regression_oracle("poisson", A, b, oracle, levels, dev)
    return (f, BurgEntropyL2(lamda=lamda), float(b.sum()),
            torch.full((n,), 1.0 / n, dtype=DTYPE, device=dev))


def KL_nonneg_regr(m, n, noise=0.01, lamdaL1=0, randseed=-1, normalizeA=True,
                   oracle=None, levels=None, device=None):
    """L1-regularized KL regression: min_{x>=0} D_KL(Ax, b) + lamda|x|_1
    with the Shannon-entropy kernel, L = max column sum
    (reference: applications.py:175-206)."""
    dev = resolve_device(device)
    if randseed > 0:
        np.random.seed(randseed)
    A = np.random.rand(m, n)
    if normalizeA:
        A = A / A.sum(axis=0)
    x = np.random.rand(n)
    b = A @ x + noise * (np.random.rand(m) - 0.5)
    assert b.min() > 0, "need b > 0 for nonnegative regression."
    f = _regression_oracle("kl", A, b, oracle, levels, dev)
    return (f, ShannonEntropyL1(lamda=lamdaL1), float(A.sum(axis=0).max()),
            torch.full((n,), 0.5, dtype=DTYPE, device=dev))


def _simplex_regression(m, n, solution, noise, normalizeA, dev):
    A = np.random.rand(m, n)
    if normalizeA:
        A = A / A.sum(axis=0)
    b = A @ solution + noise * np.random.rand(m)
    assert b.min() > 0, "need b > 0 for nonnegative regression."
    return PoissonRegression(A, b, device=dev), b


def Poisson_regr_simplex_acc(m, n, noise=0.01, normalizeA=True, device=None):
    """Poisson regression on the simplex with a (Burg, Euclidean) kernel
    pair (reference: applications.py:209-224)."""
    dev = resolve_device(device)
    x0 = random_point_on_simplex(n, center=False)
    solution = random_point_on_simplex(n, center=False)
    f, b = _simplex_regression(m, n, solution, noise, normalizeA, dev)
    return (f, [BurgEntropySimplex(eps=1e-7), SquaredL2Norm()],
            float(np.abs(b).sum()), as_f64(x0, dev))


def Poisson_regr_simplex(m, n, noise=0.01, normalizeA=True, device=None):
    """Four x0/solution placement scenarios (center/edge cross product) of
    Poisson regression on the simplex (reference: applications.py:227-295).
    Returns ``(h, {scenario: (f, L, solution, x0)})``."""
    dev = resolve_device(device)

    def scenario(place):
        # x0 is drawn BEFORE the solution, the reference's order
        # (applications.py:262-285), so seeded instances match it
        if place == "x0_center_sol_center":
            x0 = random_point_on_simplex(n, center=True)
            solution = random_point_on_simplex(n)
        elif place == "x0_edge_sol_edge":
            x0 = edge_point_on_simplex(np.random.randint(n), n)
            solution = edge_point_on_simplex(np.random.randint(n), n)
        elif place == "x0_edge_sol_center":
            x0 = edge_point_on_simplex(np.random.randint(n), n)
            solution = random_point_on_simplex(n, center=True)
        else:  # x0_center_sol_edge
            x0 = random_point_on_simplex(n, center=True)
            solution = edge_point_on_simplex(np.random.randint(n), n)
        f, b = _simplex_regression(m, n, solution, noise, normalizeA, dev)
        return f, float(b.sum()), as_f64(solution, dev), as_f64(x0, dev)

    scenarios = {place: scenario(place) for place in (
        "x0_center_sol_center", "x0_edge_sol_edge",
        "x0_edge_sol_center", "x0_center_sol_edge")}
    return BurgEntropySimplex(), scenarios


# ---------------------------------------------------------------------------
# SVM on an L2 ball (reference: applications.py:298-327)
# ---------------------------------------------------------------------------


def svm_digits_ds_divs_ball(center=None, lamda=0.5, real_ds=False,
                            device=None):
    """SVM (hinge + L2) over an L2 ball with the (PolyDiv, SquaredL2Norm)
    kernel pair (reference: applications.py:298-327).  Returns
    ``(f, [poly_h, sq_h], L, x0, radius)``.  The synthetic dataset comes
    from an unseeded generator; x0 from ``np.random``."""
    dev = resolve_device(device)
    if real_ds:
        from sklearn.datasets import load_digits

        X, Y = load_digits(n_class=2, return_X_y=True)
        Y = (np.asarray(Y) > 0).astype(int) * 2 - 1
        X = np.asarray(X, dtype=float)
    else:
        X, Y = generate_dataset_for_svm(700, 2000)

    f = SVM_fun(lamda=lamda, A=X, y=Y, device=dev)
    n = X.shape[1]
    radius = min(
        np.sum(np.linalg.norm(X[:, :-1], axis=1)) / (n * lamda),
        (2.0 / lamda) ** 0.5,
    )
    if center is None:
        center = np.zeros(n)

    poly_h = PolyDiv.from_data(X, lamda=lamda, radius=radius)
    L = float(poly_h.DS_mean + min((2 * lamda) ** 0.5,
                                   poly_h.DS_mean_quad)) * 0.08
    x0 = random_point_in_l2_ball(center, radius, pos_dir=False)
    return f, [poly_h, SquaredL2Norm()], L, as_f64(x0, dev), radius


# ---------------------------------------------------------------------------
# SymNMF / Frobenius losses (reference: applications.py:330-429)
# ---------------------------------------------------------------------------


def _symnmf_instance(X, radius, dev):
    assert np.all(X >= 0), "X must be non-negative"
    n, r = X.shape
    M = X @ X.T
    X0 = np.ones((n, r)) * radius + 1e-5 * radius
    f = FrobeniusSymLoss.create(M, X0, device=dev)
    sigma = 2 * np.linalg.norm(M, 2)
    return (f, SumOf2nd4thPowers(alpha=6.0, sigma=sigma), 1.0,
            as_f64(X0, dev), f.M)


def FrobeniusSymLossExL2Ball(n, r, ball_center, radius=1.0, on_boundary=True,
                             device=None):
    """SymNMF with factor rows sampled on/in an L2 ball
    (reference: applications.py:330-366).  Returns ``(f, h, L, X0, M)``."""
    dev = resolve_device(device)
    X = np.random.randn(n, r)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    if on_boundary:
        X *= radius
    else:
        X *= radius * np.random.uniform(0, 1, size=(n, 1)) ** (1.0 / r)
    X += ball_center
    return _symnmf_instance(X, radius, dev)


def FrobeniusSymLossExLInfBall(n, r, ball_center, radius=1.0,
                               on_boundary=True, device=None):
    """SymNMF with factor rows sampled on/in an L-inf ball
    (reference: applications.py:369-401).  Returns ``(f, h, L, X0, M)``."""
    dev = resolve_device(device)
    X = np.random.randn(n, r)
    X /= np.max(np.abs(X))
    if on_boundary:
        X *= radius
    else:
        X *= radius * np.random.uniform(0, 1)
    X += ball_center
    return _symnmf_instance(X, radius, dev)


def FrobeniusSymLossResMeasEx(M, r, noise=0.0, oracle=None, device=None):
    """SymNMF of a given similarity matrix M with the positive-orthant
    2nd+4th-power kernel and a Euclidean comparison kernel (reference:
    applications.py:404-415).  Returns ``(f, [h, h_euclid], L, X0)``.

    Every ``oracle`` of the JAX package (None, "mixed", "ds", "auto")
    gives the FP64 ``FrobeniusSymLoss``; "mixed" and "ds" refuse a
    ``noise``, as there.  A ``noise`` makes the oracle stochastic: the
    drivers pass it a draw key per gradient."""
    if oracle not in (None, "mixed", "ds", "auto"):
        raise ValueError(f"unknown oracle={oracle!r} "
                         "(None, 'mixed', 'ds' or 'auto')")
    if oracle in ("mixed", "ds") and noise:
        raise ValueError(f"oracle={oracle!r} has no stochastic mode")
    dev = resolve_device(device)
    M = _numpy(M)
    X0 = np.random.rand(M.shape[0], r)
    f = FrobeniusSymLoss.create(M, X0, noise_level=noise if noise else None,
                                device=dev)
    h = SumOf2nd4thPowersPositiveOrthant(
        alpha=6.0, sigma=2 * np.linalg.norm(M, 2), upper_bound=None)
    return f, [h, SquaredL2Norm()], 1.0, as_f64(X0, dev)


def FrobeniusSymLossExWithLinearCnstrnts(M, r, noise=0, device=None):
    """SymNMF with a linear constraint function for the primal-dual method
    (reference: applications.py:418-429).  Returns ``(f, g, h, L, X0)``
    with g the ``AX_b`` constraint; the numpy draws (X0, then A and b) are
    the JAX factory's, in its order."""
    dev = resolve_device(device)
    M = _numpy(M)
    X0 = np.random.rand(M.shape[0], r)
    f = FrobeniusSymLoss.create(M, X0, noise_level=noise if noise else None,
                                device=dev)
    h = SumOf2nd4thPowersPositiveOrthant(alpha=6.0,
                                         sigma=2 * np.linalg.norm(M, 2))
    g = AX_b(A=np.random.rand(r), b=np.random.rand(M.shape[0]) + 0.5,
             device=dev)
    return f, g, h, 1.0, as_f64(X0, dev)


# ---------------------------------------------------------------------------
# Logistic regression generators for (L0,L1) Frank-Wolfe
# (reference: applications.py:432-701)
# ---------------------------------------------------------------------------


def _generator(key, device):
    """``(generator, device)`` from ``key``: a ``torch.Generator`` (its own
    device unless ``device`` is given), an int seed, or a JAX key array
    (its 32-bit words, read through numpy, make the seed, high word first:
    ``jax.random.PRNGKey(s)`` gives the seed s)."""
    if isinstance(key, torch.Generator):
        return key, (key.device if device is None
                     else resolve_device(device))
    dev = resolve_device(device)
    if isinstance(key, numbers.Integral):
        seed = int(key)
    else:
        words = np.asarray(key).astype(np.uint64).ravel()
        seed = 0
        for w in words:
            seed = (seed << 32) | int(w)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % 2**63)
    return gen, dev


def toeplitz_matrix(n_features, rho, device=None):
    """Toeplitz correlation matrix rho^|i-j| (reference:
    applications.py:432-434), float64 on ``device``."""
    idx = torch.arange(n_features, device=resolve_device(device))
    return torch.pow(rho, (idx[:, None] - idx[None, :]).abs().to(DTYPE))


def _correlated_design(gen, dev, n_samples, n_features, rho):
    chol = torch.linalg.cholesky(toeplitz_matrix(n_features, rho, dev))
    Z = torch.randn(n_samples, n_features, generator=gen, dtype=DTYPE,
                    device=dev)
    return Z @ chol.T


def _logistic_constants(X):
    row_norms = torch.linalg.vector_norm(X, dim=1)
    return torch.max(row_norms) ** 2, torch.max(row_norms)


def L0L1_FW_log_reg(key, n_samples, n_features, ball_constrnt_radius,
                    solution_spread_radius_btm=0.91,
                    solution_spread_radius_up=0.96, noise=0.0, rho=0.98,
                    device=None):
    """Legacy hard logistic-regression generator: Toeplitz-correlated design
    with 3^j column scaling (reference: applications.py:437-499).  Returns
    ``(f, h, L, L0, L1, x0)``.  Draws, in order, from torch's generator on
    the device (see the module docstring): the design, the ground truth's
    direction and radius, the label noise."""
    gen, dev = _generator(key, device)
    f64 = dict(dtype=DTYPE, device=dev)
    x0 = torch.zeros(n_features, **f64) + 1e-6
    X = (_correlated_design(gen, dev, n_samples, n_features, rho)
         * (3.0 ** torch.arange(n_features, **f64))[None, :])

    direction = torch.randn(n_features, generator=gen, **f64)
    direction = direction / torch.linalg.vector_norm(direction)
    lo = ball_constrnt_radius * solution_spread_radius_btm
    hi = ball_constrnt_radius * solution_spread_radius_up
    r = lo + (hi - lo) * torch.rand((), generator=gen, **f64)
    true_omega = r * direction

    logits = X @ true_omega + noise * torch.randn(n_samples, generator=gen,
                                                  **f64)
    y = torch.sign(logits)
    y = torch.where(y == 0, 1.0, y)
    L, L1 = _logistic_constants(X)
    return LogisticRegression(X, y), SquaredL2Norm(), L, 1e-9, L1, x0


def _ground_truth(gen, dev, domain, n_features, radius, k_sparse):
    """``hard_FW_log_reg_jax``'s ground truth on the domain: k-sparse on the
    l1 ball or the simplex, a vertex of the l-inf ball, a point of the l2
    sphere."""
    f64 = dict(dtype=DTYPE, device=dev)
    if domain in ("l1", "simplex"):
        k = min(k_sparse, n_features)
        supp = torch.randperm(n_features, generator=gen, device=dev)[:k]
        vals = 0.5 + 0.5 * torch.rand(k, generator=gen, **f64)
        vals = vals / torch.sum(torch.abs(vals)) * radius
        omega = torch.zeros(n_features, **f64).index_copy(0, supp, vals)
        if domain == "simplex":
            omega = torch.abs(omega)
            omega = omega / torch.sum(omega) * radius
        return omega
    if domain == "linf":
        signs = 2.0 * torch.randint(0, 2, (n_features,), generator=gen,
                                    device=dev).to(DTYPE) - 1.0
        return signs * radius
    v = torch.randn(n_features, generator=gen, **f64)  # l2
    return radius * v / (torch.linalg.vector_norm(v) + 1e-12)


def hard_FW_log_reg_jax(key, n_samples, n_features, radius=1.0, domain="l1",
                        k_sparse=5, rho=0.95, col_scale=10.0, flip_y=0.0,
                        margin=0.5, class_bias=0.0, x0_mode="center",
                        noise=0.01, device=None):
    """Fully parameterized hard logistic-regression generator for FW
    benchmarking: correlated Toeplitz design, domain-constrained k-sparse
    ground truth (l1/l2/linf/simplex), label flips, margin control
    (reference: applications.py:502-658).

    Returns ``(f, h, L, L0, L1, x0, X, y)``.  Draws, in order, from torch's
    generator on the device (see the module docstring): the design, the
    ground truth (support and values, signs, or a direction), the label
    noise, the flips (when ``flip_y > 0``) and the x0 vertex (for an l1 or
    simplex domain with ``x0_mode != "center"``).
    """
    gen, dev = _generator(key, device)
    f64 = dict(dtype=DTYPE, device=dev)
    X = _correlated_design(gen, dev, n_samples, n_features, rho)
    X = X * (col_scale ** torch.linspace(0, 1, n_features, **f64))[None, :]
    true_omega = _ground_truth(gen, dev, domain, n_features, radius,
                               k_sparse)

    logits = margin * (X @ true_omega) + class_bias
    y = torch.sign(logits + noise * torch.randn(n_samples, generator=gen,
                                                **f64))
    if flip_y > 0:
        flip = torch.rand(n_samples, generator=gen, **f64) < flip_y
        y = torch.where(flip, -y, y)
    y = torch.where(y == 0, 1.0, y)

    x0 = torch.zeros(n_features, **f64)
    if domain in ("l1", "simplex") and x0_mode != "center":
        idx = torch.randint(0, n_features, (1,), generator=gen, device=dev)
        x0 = x0.index_fill(0, idx, radius)
        if domain == "simplex":
            x0 = x0 / torch.sum(x0) * radius

    L, L1 = _logistic_constants(X)
    return LogisticRegression(X, y), SquaredL2Norm(), L, 1e-12, L1, x0, X, y


def load_a9a_data(path, bias=True):
    """Load the a9a LIBSVM dataset as dense numpy ``(X, y)`` with y in
    {-1, 1} (reference: applications.py:661-672)."""
    X, y = load_libsvm_file(path)
    X = X.toarray()
    if bias:
        X = np.hstack([X, np.ones((X.shape[0], 1))])
    y = np.where(y <= 0, -1, 1)
    return X, y


def L0L1_FW_log_reg_a9a(ball_constrnt_radius, path, device=None):
    """Real-data (L0,L1) logistic regression on a9a with standardized
    features (reference: applications.py:675-701).  Returns
    ``(f, h, L, L0, L1, x0)``: the data and x0 float64 on ``device`` (CUDA
    for None), the constants Python floats; x0 is drawn from
    ``np.random``, as in JAX."""
    dev = resolve_device(device)
    X, y = load_a9a_data(path=path)
    X = (X - X.mean(axis=0)) / np.maximum(X.std(axis=0), 1e-12)

    n_features = X.shape[1]
    x0 = np.random.uniform(-0.5, 0.5, size=n_features)
    x0 = x0 / max(np.linalg.norm(x0, 2) / ball_constrnt_radius,
                  np.linalg.norm(x0, np.inf) / ball_constrnt_radius, 1.0)

    f = LogisticRegression(X, y, device=dev)
    row_norms = np.linalg.norm(X, axis=1)
    L = float(np.max(row_norms) ** 2)
    return (f, SquaredL2Norm(), L, 1e-9, float(np.max(row_norms)),
            as_f64(x0, dev))
