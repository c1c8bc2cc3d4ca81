"""The port's oracle layer (``ops/f_oracles.py``, ``ops/h_oracles.py``,
``ops/roots.py``, ``algorithms/theta.py``, ``interop.from_jax_oracle``)
against the JAX package in float64, on the same numpy inputs.

Bars: oracle values, gradients, divergences and proxes rtol 1e-12 (the two
packages sum in different orders; a Cholesky of a 40x40 Gram carries
~1e-14); the root finders and the theta Newton rtol 1e-13 (scalar
recurrences that end on polish or convergence tests, so only the sums'
last bits differ).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import accbpg_and_fw_tpu as acc
import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu.algorithms.theta import solve_theta as jax_solve_theta
from accbpg_and_fw_tpu.ops import roots as jax_roots
from accbpg_and_fw_tpu_torch.interop import from_jax_oracle
from accbpg_and_fw_tpu_torch.ops import roots

torch.set_num_threads(1)

ORACLE_RTOL, ROOT_RTOL = 1e-12, 1e-13


def _close(got, ref, rtol, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol)


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


@pytest.fixture(scope="module")
def design():
    H = np.random.default_rng(4).standard_normal((40, 120))
    x = np.random.default_rng(5).uniform(0.2, 1.0, 120)
    return H, x / x.sum()


@pytest.mark.parametrize("n_valid", [None, 100])
def test_dopt_value_and_grad(design, n_valid):
    H, x = design
    if n_valid is not None:
        H = H.copy()
        H[:, n_valid:] = 0.0  # padded columns
    fj = acc.DOptimalObj(H=jnp.asarray(H), n_valid=n_valid)
    fp = port.DOptimalObj(H, n_valid=n_valid, device="cpu")
    vj, gj = fj.value_and_grad(jnp.asarray(x))
    vp, gp = fp.value_and_grad(_t(x))
    _close(vp, vj, ORACLE_RTOL)
    _close(gp, gj, ORACLE_RTOL)
    _close(fp.value(_t(x)), fj.value(jnp.asarray(x)), ORACLE_RTOL)
    _close(fp.grad(_t(x)), gj, ORACLE_RTOL)
    if n_valid is not None:
        assert np.all(gp.numpy()[n_valid:] == 1e30)
    # the reference aliases
    _close(fp(_t(x)), vj, ORACLE_RTOL)
    _close(fp.func_grad(_t(x), flag=1), gj, ORACLE_RTOL)


def test_dopt_not_positive_definite_is_nan(design):
    """A singular Gram gives NaN (as JAX's Cholesky does), not an error."""
    H, _ = design
    x = np.zeros(120)
    x[:10] = 0.1  # rank 10 < m = 40
    fp = port.DOptimalObj(H, device="cpu")
    assert np.isnan(float(fp.value(_t(x))))
    v, g = fp.value_and_grad(_t(x))
    assert np.isnan(float(v)) and torch.isnan(g).all()
    assert np.isnan(float(acc.DOptimalObj(H=jnp.asarray(H)).value(
        jnp.asarray(x))))


def _burg_pair(kind):
    if kind == "plain":
        return acc.BurgEntropy(), port.BurgEntropy()
    if kind == "l1":
        return acc.BurgEntropyL1(lamda=0.3), port.BurgEntropyL1(lamda=0.3)
    if kind == "l2":
        return acc.BurgEntropyL2(lamda=0.7), port.BurgEntropyL2(lamda=0.7)
    if kind == "l2_zero":
        return acc.BurgEntropyL2(lamda=0.0), port.BurgEntropyL2(lamda=0.0)
    return acc.BurgEntropySimplex(), port.BurgEntropySimplex()


@pytest.mark.parametrize("kind", ["plain", "l1", "l2", "l2_zero", "simplex"])
def test_burg_oracles_match_jax(kind):
    hj, hp = _burg_pair(kind)
    rng = np.random.default_rng(7)
    x = rng.uniform(0.1, 2.0, 90)
    y = rng.uniform(0.1, 2.0, 90)
    g = rng.uniform(0.5, 3.0, 90)  # g > 0 keeps L/g in the domain
    L = 1.7
    xj, yj, gj = map(jnp.asarray, (x, y, g))
    xp, yp, gp = map(_t, (x, y, g))
    _close(hp.value(xp), hj.value(xj), ORACLE_RTOL)
    _close(hp.grad(xp), hj.grad(xj), ORACLE_RTOL)
    _close(hp.divergence(xp, yp), hj.divergence(xj, yj), ORACLE_RTOL)
    _close(hp.extra_psi(xp), hj.extra_psi(xj), ORACLE_RTOL)
    _close(hp.extra_Psi(xp), hj.extra_psi(xj), ORACLE_RTOL)
    _close(hp.prox_map(gp, L), hj.prox_map(gj, L), ORACLE_RTOL)
    _close(hp.div_prox_map(yp, gp, L), hj.div_prox_map(yj, gj, L),
           ORACLE_RTOL)


def test_burg_divergence_zero_over_zero():
    """x == y == 0 coordinates contribute 0; x == 0 < y gives inf."""
    hj, hp = acc.BurgEntropy(), port.BurgEntropy()
    x = np.array([0.0, 0.5, 1.0])
    y = np.array([0.0, 0.25, 1.0])
    _close(hp.divergence(_t(x), _t(y)),
           hj.divergence(jnp.asarray(x), jnp.asarray(y)), ORACLE_RTOL)
    bad = hp.divergence(_t([0.0, 1.0]), _t([0.5, 1.0]))
    assert not np.isfinite(float(bad))


def test_simplex_prox_on_the_simplex():
    hp = port.BurgEntropySimplex()
    g = _t(np.random.default_rng(8).standard_normal(300))
    x = hp.prox_map(g, 0.9)
    assert abs(float(x.sum()) - 1.0) < 1e-12 and float(x.min()) > 0


@pytest.mark.parametrize("case", ["cold", "warm_below", "stale_above",
                                  "nan", "inf", "out_of_domain",
                                  "past_bound", "inf_coords"])
def test_simplex_inv_multiplier_matches_jax(case):
    rng = np.random.default_rng(11)
    gg = rng.standard_normal(500) * 2.0 + 1.0
    if case == "inf_coords":
        gg[::9] = np.inf  # padded / fixed-at-zero coordinates
    c_star = float(jax_roots.simplex_inv_multiplier(jnp.asarray(gg), 1e-12))
    warm = {"cold": None, "inf_coords": None,
            "warm_below": c_star - 3.0,
            "stale_above": c_star + 40.0,
            "nan": np.nan, "inf": np.inf,
            "out_of_domain": -gg[np.isfinite(gg)].min() - 1.0,
            "past_bound": -gg.min() + 10.0 * gg.size}[case]
    cj = jax_roots.simplex_inv_multiplier(
        jnp.asarray(gg), 1e-8,
        c_warm=None if warm is None else jnp.asarray(warm))
    cp = roots.simplex_inv_multiplier(_t(gg), 1e-8, c_warm=warm)
    assert isinstance(cp, float)
    _close(cp, cj, ROOT_RTOL)
    x = 1.0 / (gg + cp)
    assert abs(x.sum() - 1.0) < 1e-12


def test_simplex_inv_multiplier_tensor_warm_start():
    gg = np.random.default_rng(12).standard_normal(200)
    cj = jax_roots.simplex_inv_multiplier(jnp.asarray(gg), 1e-8,
                                          c_warm=jnp.asarray(150.0))
    cp = roots.simplex_inv_multiplier(_t(gg), 1e-8,
                                      c_warm=torch.tensor(150.0,
                                                          dtype=torch.float64))
    _close(cp, cj, ROOT_RTOL)
    hp = port.BurgEntropySimplex()
    x, c = hp.prox_map_warm(_t(gg), 1.0, 150.0)
    _close(c, cj, ROOT_RTOL)
    _close(x, 1.0 / (gg + np.asarray(cj)), ROOT_RTOL)
    y = np.random.default_rng(13).uniform(0.5, 1.5, 200)
    xj, _ = acc.BurgEntropySimplex().div_prox_map_warm(
        jnp.asarray(y), jnp.asarray(gg), 2.0, jnp.asarray(150.0))
    xp, _ = hp.div_prox_map_warm(_t(y), _t(gg), 2.0, 150.0)
    _close(xp, xj, ROOT_RTOL)


def test_project_simplex_burg_and_cubic():
    rng = np.random.default_rng(14)
    y = rng.standard_normal((6, 7)) + 2.0
    _close(roots.project_simplex_burg(_t(y)),
           jax_roots.project_simplex_burg(jnp.asarray(y)), ROOT_RTOL)
    c = rng.uniform(0.01, 50.0, 64)
    for beta in (0.0, 1.5, -2.0):
        _close(roots.solve_cubic(_t(c), beta),
               jax_roots.solve_cubic(jnp.asarray(c), beta), ROOT_RTOL)
    # scalar arguments
    _close(roots.solve_cubic(3.0, 1.0), jax_roots.solve_cubic(3.0, 1.0),
           ROOT_RTOL)


def test_bisect_and_newton_scalar():
    fn = lambda t: t**3 - 2.0  # noqa: E731
    dfn = lambda t: 3.0 * t**2  # noqa: E731
    _close(roots.bisect_monotone(fn, 0.0, 4.0),
           jax_roots.bisect_monotone(fn, jnp.asarray(0.0), 4.0), ROOT_RTOL)
    xp = roots.newton_scalar(fn, dfn, torch.tensor(3.0, dtype=torch.float64),
                             1e-14)
    xj = jax_roots.newton_scalar(fn, dfn, jnp.asarray(3.0), 1e-14)
    _close(xp, xj, ROOT_RTOL)
    assert abs(float(xp) - 2.0 ** (1.0 / 3.0)) < 1e-14


@pytest.mark.parametrize("theta,gamma,ratio", [
    (1.0, 2.0, 1.0), (0.37, 2.0, 1.3), (0.05, 2.0, 0.8), (0.6, 3.0, 1.0),
    (0.2, 2.5, 2.0), (0.9, 1.5, 0.5)])
def test_solve_theta_matches_jax(theta, gamma, ratio):
    tp = port.solve_theta(theta, gamma, ratio)
    assert isinstance(tp, float)
    _close(tp, jax_solve_theta(jnp.asarray(theta), gamma, ratio), ROOT_RTOL)


def test_from_jax_oracle():
    fj, hj, L, x0 = acc.D_opt_design(40, 120, randseed=10)
    fp = from_jax_oracle(fj, device="cpu")
    assert isinstance(fp, port.DOptimalObj) and fp.H.dtype == torch.float64
    xj = jnp.asarray(np.random.default_rng(15).uniform(0.5, 1.5, 120) / 120)
    vj, gj = fj.value_and_grad(xj)
    vp, gp = fp.value_and_grad(_t(xj))
    _close(vp, vj, 1e-13)
    _close(gp, gj, 1e-13)
    hp = from_jax_oracle(acc.BurgEntropySimplex(eps=1e-9, use_pallas=True),
                         device="cpu")
    assert (type(hp) is port.BurgEntropySimplex and hp.eps == 1e-9
            and hp.use_pallas)
    assert from_jax_oracle(acc.BurgEntropyL1(lamda=0.25),
                           device="cpu").lamda == 0.25
    assert type(from_jax_oracle(acc.BurgEntropyL2(lamda=0.5),
                                device="cpu")) is \
        port.BurgEntropyL2
    assert type(from_jax_oracle(acc.BurgEntropy(),
                                device="cpu")) is port.BurgEntropy
    with pytest.raises(TypeError, match="no port"):
        from_jax_oracle(acc.SquaredL2Norm(), device="cpu")


def test_d_opt_design_is_the_jax_instance():
    fj, _, Lj, x0j = acc.D_opt_design(30, 80, randseed=10)
    fp, hp, Lp, x0p = port.D_opt_design(30, 80, randseed=10, oracle="mixed",
                                        device="cpu")
    np.testing.assert_array_equal(fp.H.numpy(), np.asarray(fj.H))
    np.testing.assert_array_equal(x0p.numpy(), np.asarray(x0j))
    assert Lp == Lj == 1.0 and type(hp) is port.BurgEntropySimplex
    assert not hp.use_pallas
    with pytest.raises(ValueError, match="oracle"):
        port.D_opt_design(3, 5, oracle="other", device="cpu")
