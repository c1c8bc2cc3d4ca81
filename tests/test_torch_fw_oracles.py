"""The port's h- and f-oracles of the Frank-Wolfe slice (``ops/h_oracles.py``,
``ops/f_oracles.py``) and their ``interop.from_jax_oracle`` cases, against
the JAX package in float64 on the same numpy inputs.

Bar: rtol 1e-12, with an atol of 1e-12 times the array's largest entry (the
two packages sum in different orders, and a gradient entry that cancels to
near zero keeps the absolute error of its sum).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import accbpg_and_fw_tpu as acc
import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu_torch.interop import from_jax_oracle

torch.set_num_threads(1)

RTOL = 1e-12


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, ref):
    got = np.asarray(_np(got), np.float64)
    ref = np.asarray(ref, np.float64)
    scale = float(np.max(np.abs(ref))) if ref.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale)


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# h-oracles: (JAX instance, port instance, input domain, shape)
# ---------------------------------------------------------------------------

_DS = _rng(3).standard_normal((25, 9))


def _h_pairs():
    lmo_j, lmo_p = acc.lmo_linf_ball(1.0, 1.0), port.lmo_linf_ball(1.0, 1.0)
    poly = dict(lamda=0.5, radius=2.0)
    return {
        "BurgEntropyL2Ball": (acc.BurgEntropyL2Ball(radius=3.0),
                              port.BurgEntropyL2Ball(radius=3.0), "pos",
                              (12,)),
        "BurgEntropyL2Ball_center": (
            acc.BurgEntropyL2Ball(lamda=0.1, radius=0.5, center=0.2),
            port.BurgEntropyL2Ball(lamda=0.1, radius=0.5, center=0.2),
            "pos", (12,)),
        "ShannonEntropy": (acc.ShannonEntropy(), port.ShannonEntropy(),
                           "pos", (12,)),
        "ShannonEntropyL1": (acc.ShannonEntropyL1(lamda=0.4),
                             port.ShannonEntropyL1(lamda=0.4), "pos", (12,)),
        "ShannonEntropySimplex": (acc.ShannonEntropySimplex(),
                                  port.ShannonEntropySimplex(), "simplex",
                                  (12,)),
        "SumOf2nd4thPowers": (acc.SumOf2nd4thPowers(alpha=6.0, sigma=3.0),
                              port.SumOf2nd4thPowers(alpha=6.0, sigma=3.0),
                              "any", (8, 3)),
        "SumOf2nd4thPowersPositiveOrthant": (
            acc.SumOf2nd4thPowersPositiveOrthant(alpha=6.0, sigma=3.0),
            port.SumOf2nd4thPowersPositiveOrthant(alpha=6.0, sigma=3.0),
            "any", (8, 3)),
        "SumOf2nd4thPowersPositiveOrthant_ub": (
            acc.SumOf2nd4thPowersPositiveOrthant(alpha=2.0, sigma=1.0,
                                                 upper_bound=0.3),
            port.SumOf2nd4thPowersPositiveOrthant(alpha=2.0, sigma=1.0,
                                                  upper_bound=0.3),
            "any", (10,)),
        "SumOf2nd4thPowersOnSimplex": (
            acc.SumOf2nd4thPowersOnSimplex(alpha=1.0, sigma=2.0),
            port.SumOf2nd4thPowersOnSimplex(alpha=1.0, sigma=2.0),
            "simplex", (12,)),
        "SumOf2nd4thPowersWithFrankWolfe": (
            acc.SumOf2nd4thPowersWithFrankWolfe(alpha=6.0, sigma=3.0,
                                                lmo=lmo_j),
            port.SumOf2nd4thPowersWithFrankWolfe(alpha=6.0, sigma=3.0,
                                                 lmo=lmo_p), "any", (8, 3)),
        "SquaredL2Norm": (acc.SquaredL2Norm(), port.SquaredL2Norm(), "any",
                          (8, 3)),
        "PowerNeg1": (acc.PowerNeg1(), port.PowerNeg1(), "pos", (12,)),
        "L2L1Linf": (acc.L2L1Linf(lamda=0.3, B=0.8),
                     port.L2L1Linf(lamda=0.3, B=0.8), "any", (12,)),
        "PolyDiv": (acc.PolyDiv.from_data(jnp.asarray(_DS), **poly),
                    port.PolyDiv.from_data(_DS, **poly), "any", (9,)),
    }


H_CASES = sorted(_h_pairs())


def _inputs(domain, shape, seed=21):
    rng = _rng(seed)
    if domain == "any":
        x, y = rng.standard_normal(shape), rng.standard_normal(shape)
        g = rng.standard_normal(shape)
    else:
        x, y = rng.uniform(0.2, 1.5, shape), rng.uniform(0.2, 1.5, shape)
        g = rng.uniform(0.5, 3.0, shape)  # g > 0: L/g stays in the domain
        if domain == "simplex":
            x, y = x / x.sum(), y / y.sum()
    return x, y, g


@pytest.mark.parametrize("case", H_CASES)
def test_h_oracle_matches_jax(case):
    hj, hp, domain, shape = _h_pairs()[case]
    x, y, g = _inputs(domain, shape)
    xj, yj, gj = map(jnp.asarray, (x, y, g))
    xp, yp, gp = map(torch.tensor, (x, y, g))
    for L in (0.7, 2.5):
        _close(hp.div_prox_map(yp, gp, L), hj.div_prox_map(yj, gj, L))
        if case not in ("SumOf2nd4thPowersWithFrankWolfe",):
            _close(hp.prox_map(gp, L), hj.prox_map(gj, L))
    _close(hp.value(xp), hj.value(xj))
    _close(hp.grad(xp), hj.grad(xj))
    _close(hp.divergence(xp, yp), hj.divergence(xj, yj))
    _close(hp.extra_psi(xp), hj.extra_psi(xj))


def test_shannon_simplex_prox_keeps_zero_coordinates():
    hj, hp = acc.ShannonEntropySimplex(), port.ShannonEntropySimplex()
    y = np.array([0.0, 0.3, 0.0, 0.7])
    g = np.array([1.0, -2.0, 0.5, 0.25])
    got = hp.div_prox_map(torch.tensor(y), torch.tensor(g), 1.3)
    _close(got, hj.div_prox_map(jnp.asarray(y), jnp.asarray(g), 1.3))
    assert got[0] == 0.0 and got[2] == 0.0


def test_ds_prox_kernel_is_the_fp64_class():
    assert (port.SumOf2nd4thPowersPositiveOrthantDS
            is port.SumOf2nd4thPowersPositiveOrthant)


# ---------------------------------------------------------------------------
# f-oracles
# ---------------------------------------------------------------------------


def _f_pairs():
    rng = _rng(8)
    A = rng.uniform(0.1, 1.0, (30, 12))
    b = A @ rng.uniform(0.1, 1.0, 12) + 0.05
    S = rng.standard_normal((40, 10))
    ys = np.where(rng.standard_normal(40) > 0, 1.0, -1.0)
    # logits past softplus's usual threshold of 20 on some rows
    X = rng.standard_normal((50, 8)) * np.array([1, 1, 2, 4, 8, 16, 32, 64])
    yl = np.where(rng.standard_normal(50) > 0, 1.0, -1.0)
    P = rng.uniform(0.0, 1.0, (12, 3))
    M = P @ P.T + 0.01 * np.eye(12)
    return {
        "PoissonRegression": (
            acc.PoissonRegression(A=jnp.asarray(A), b=jnp.asarray(b)),
            port.PoissonRegression(A, b, device="cpu"), "pos", (12,)),
        "KLdivRegression": (
            acc.KLdivRegression(A=jnp.asarray(A), b=jnp.asarray(b)),
            port.KLdivRegression(A, b, device="cpu"), "pos", (12,)),
        "SVM_fun": (acc.SVM_fun(lamda=0.3, A=jnp.asarray(S),
                                y=jnp.asarray(ys)),
                    port.SVM_fun(lamda=0.3, A=S, y=ys, device="cpu"), "any",
                    (10,)),
        "LogisticRegression": (
            acc.LogisticRegression(X=jnp.asarray(X), y=jnp.asarray(yl)),
            port.LogisticRegression(X, yl, device="cpu"), "any", (8,)),
        "FrobeniusSymLoss": (acc.FrobeniusSymLoss.create(jnp.asarray(M)),
                             port.FrobeniusSymLoss.create(M, device="cpu"),
                             "pos", (12, 3)),
    }


F_CASES = sorted(_f_pairs())


@pytest.mark.parametrize("case", F_CASES)
def test_f_oracle_matches_jax(case):
    fj, fp, domain, shape = _f_pairs()[case]
    x, _, _ = _inputs(domain, shape, seed=33)
    xj, xp = jnp.asarray(x), torch.tensor(x)
    vj, gj = fj.value_and_grad(xj)
    vp, gp = fp.value_and_grad(xp)
    _close(vp, vj)
    _close(gp, gj)
    _close(fp.value(xp), fj.value(xj))
    _close(fp.grad(xp), fj.grad(xj))
    assert fp.device == torch.device("cpu")
    if case == "LogisticRegression":
        _close(fp.hessian(xp), fj.hessian(xj))
        _close(fp.f(xp), vj)
        z = np.abs(fp.y.numpy() * (fp.X.numpy() @ x))
        assert z.max() > 20.0  # the softplus tail is exercised


def test_logistic_softplus_tail_is_not_torch_softplus():
    """Past 20, ``torch.nn.functional.softplus`` returns its input and drops
    log1p(exp(-z)); the port's value keeps it, as ``jax.nn.softplus``."""
    X = np.array([[30.0], [-25.0]])
    y = np.array([-1.0, 1.0])
    fp = port.LogisticRegression(X, y, device="cpu")
    fj = acc.LogisticRegression(X=jnp.asarray(X), y=jnp.asarray(y))
    w = np.array([1.0])
    _close(fp.value(torch.tensor(w)), fj.value(jnp.asarray(w)))


@pytest.mark.parametrize("alias,target", [
    ("PoissonRegressionMixed", "PoissonRegression"),
    ("PoissonRegressionDS", "PoissonRegression"),
    ("KLdivRegressionMixed", "KLdivRegression"),
    ("KLdivRegressionDS", "KLdivRegression"),
    ("SVMfunMixed", "SVM_fun"),
    ("FrobeniusSymLossMixed", "FrobeniusSymLoss"),
    ("FrobeniusSymLossDS", "FrobeniusSymLoss")])
def test_mixed_and_ds_names_build_the_fp64_oracle(alias, target):
    cls = getattr(port, alias)
    assert cls is getattr(port, target)
    rng = _rng(2)
    A = rng.uniform(0.1, 1.0, (10, 4))
    if target == "FrobeniusSymLoss":
        f = cls.from_data(A @ A.T, levels=5, device="cpu")
    elif target == "SVM_fun":
        f = cls.from_data(A, np.sign(rng.standard_normal(10)), lamda=0.2,
                          levels=5, device="cpu")
        assert f.lamda == 0.2
    else:
        f = cls.from_data(A, A.sum(1), levels=5, device="cpu")
    assert type(f) is cls and not getattr(f, "accept_tol", 0.0)


def test_noisy_symnmf_oracle_is_stochastic():
    M = np.eye(4)
    assert port.FrobeniusSymLoss.create(M, noise_level=0.1,
                                        device="cpu").stochastic
    assert not port.FrobeniusSymLoss.create(M, device="cpu").stochastic


# ---------------------------------------------------------------------------
# interop.from_jax_oracle: one case per ported class
# ---------------------------------------------------------------------------


def _interop_cases():
    cases = {name: (hj, "h") for name, (hj, _, _, _) in _h_pairs().items()
             if name != "SumOf2nd4thPowersWithFrankWolfe"}
    cases["SumOf2nd4thPowersPositiveOrthantDS"] = (
        acc.SumOf2nd4thPowersPositiveOrthantDS(alpha=6.0, sigma=3.0), "h")
    cases.update({name: (fj, "f") for name, (fj, _, _, _) in
                  _f_pairs().items()})
    cases["FrobeniusSymLoss_noisy"] = (acc.FrobeniusSymLoss.create(
        jnp.eye(5), noise_level=0.2), "f")
    return cases


_H_FIELDS = ("lamda", "radius", "center", "delta", "eps", "alpha", "sigma",
             "upper_bound", "B", "DS_mean", "DS_mean_quad", "use_pallas")


@pytest.mark.parametrize("case", sorted(_interop_cases()))
def test_from_jax_oracle_case(case):
    obj, kind = _interop_cases()[case]
    got = from_jax_oracle(obj, device="cpu")
    base = type(obj).__name__.replace("PositiveOrthantDS", "PositiveOrthant")
    assert type(got).__name__ == base
    if kind == "h":
        for field in _H_FIELDS:
            if hasattr(obj, field):
                want = getattr(obj, field)
                have = getattr(got, field)
                if want is None:
                    assert have is None
                else:
                    _close(have, np.asarray(want, np.float64))
        return
    _, fp, domain, shape = _f_pairs().get(case, (None, None, "pos", (5, 2)))
    x, _, _ = _inputs(domain, shape, seed=34)
    vj, gj = obj.value_and_grad(jnp.asarray(x))
    vp, gp = got.value_and_grad(torch.tensor(x))
    _close(vp, vj)
    _close(gp, gj)
    assert got.device == torch.device("cpu")
    assert got.stochastic == bool(getattr(obj, "stochastic", False))


def test_from_jax_oracle_refuses_an_lmo_closure():
    h = acc.SumOf2nd4thPowersWithFrankWolfe(lmo=acc.lmo_simplex())
    with pytest.raises(TypeError, match="LMO closure"):
        from_jax_oracle(h, device="cpu")
