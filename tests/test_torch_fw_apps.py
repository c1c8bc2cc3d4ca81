"""The port's problem factories and numpy helpers of the Frank-Wolfe slice
(``apps/applications.py``, ``apps/utils.py``) against the JAX package.

* The factories driven by ``np.random`` give the JAX package's arrays bit
  for bit from the same seed (data, starts, constants).
* ``svm_digits_ds_divs_ball`` draws its dataset from an unseeded
  generator, as the JAX factory does: it is checked for its structure.
* The torch-seeded logistic generators are checked for what they promise:
  a feasible ground truth on each domain, labels in {-1, +1}, L = the
  largest squared row norm, the same arrays from the same seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import accbpg_and_fw_tpu as acc
import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu.apps import utils as jax_utils
from accbpg_and_fw_tpu_torch.apps import applications as papps

torch.set_num_threads(1)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same(got, ref):
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


def _both(seed, fn_j, fn_p):
    np.random.seed(seed)
    rj = fn_j()
    np.random.seed(seed)
    return rj, fn_p()


# ---------------------------------------------------------------------------
# numpy-seeded factories, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("Poisson_regrL1", dict(lamda=0.1)), ("Poisson_regrL2", dict(lamda=0.2)),
    ("KL_nonneg_regr", dict(lamdaL1=0.3))])
def test_regression_factories_are_the_jax_instances(name, kw):
    fj, hj, Lj, x0j = getattr(acc, name)(200, 100, randseed=7, **kw)
    fp, hp, Lp, x0p = getattr(port, name)(200, 100, randseed=7,
                                          device="cpu", **kw)
    _same(fp.A, fj.A)
    _same(fp.b, fj.b)
    _same(x0p, x0j)
    assert Lp == Lj and type(hp).__name__ == type(hj).__name__
    assert hp.lamda == float(hj.lamda)


def test_regression_oracle_choices():
    for oracle in (None, "mixed", "ds", "auto"):
        f = port.Poisson_regrL1(30, 10, randseed=3, oracle=oracle,
                                device="cpu")[0]
        assert type(f) is port.PoissonRegression
    with pytest.warns(UserWarning, match="levels"):
        port.KL_nonneg_regr(30, 10, randseed=3, oracle="ds", levels=5,
                            device="cpu")
    with pytest.raises(ValueError, match="unknown oracle"):
        port.Poisson_regrL2(30, 10, oracle="int8", device="cpu")


def test_poisson_simplex_acc_is_the_jax_instance():
    rj, rp = _both(5, lambda: acc.Poisson_regr_simplex_acc(60, 30),
                   lambda: port.Poisson_regr_simplex_acc(60, 30,
                                                         device="cpu"))
    _same(rp[0].A, rj[0].A)
    _same(rp[0].b, rj[0].b)
    _same(rp[3], rj[3])
    assert rp[2] == rj[2]
    assert [type(h).__name__ for h in rp[1]] == \
        ["BurgEntropySimplex", "SquaredL2Norm"]
    assert rp[1][0].eps == 1e-7


def test_poisson_simplex_scenarios_are_the_jax_instances():
    (hj, sj), (hp, sp) = _both(
        1, lambda: acc.Poisson_regr_simplex(200, 100),
        lambda: port.Poisson_regr_simplex(200, 100, device="cpu"))
    assert list(sp) == list(sj)
    for place in sj:
        fj, Lj, solj, x0j = sj[place]
        fp, Lp, solp, x0p = sp[place]
        _same(fp.A, fj.A)
        _same(fp.b, fj.b)
        _same(solp, solj)
        _same(x0p, x0j)
        assert Lp == Lj


@pytest.mark.parametrize("name,kw", [
    ("FrobeniusSymLossExL2Ball", dict(on_boundary=True)),
    ("FrobeniusSymLossExL2Ball", dict(on_boundary=False)),
    ("FrobeniusSymLossExLInfBall", dict(on_boundary=True)),
    ("FrobeniusSymLossExLInfBall", dict(on_boundary=False))])
def test_symnmf_ball_factories_are_the_jax_instances(name, kw):
    rj, rp = _both(4, lambda: getattr(acc, name)(40, 5, 2.0, **kw),
                   lambda: getattr(port, name)(40, 5, 2.0, device="cpu",
                                               **kw))
    _same(rp[0].M, rj[0].M)
    _same(rp[3], rj[3])
    _same(rp[4], rj[4])
    assert rp[1].alpha == 6.0 and rp[1].sigma == float(rj[1].sigma)
    assert rp[2] == rj[2]


@pytest.mark.parametrize("oracle", [None, "mixed", "ds", "auto"])
def test_symnmf_res_meas_is_the_jax_instance(oracle):
    M = np.random.default_rng(2).uniform(0.0, 1.0, (40, 40))
    M = M + M.T
    rj, rp = _both(6, lambda: acc.FrobeniusSymLossResMeasEx(M, 5),
                   lambda: port.FrobeniusSymLossResMeasEx(
                       M, 5, oracle=oracle, device="cpu"))
    _same(rp[0].M, rj[0].M)
    _same(rp[3], rj[3])
    assert type(rp[0]) is port.FrobeniusSymLoss
    assert type(rp[1][0]) is port.SumOf2nd4thPowersPositiveOrthant
    assert rp[1][0].sigma == float(rj[1][0].sigma)
    assert rp[1][0].upper_bound is None
    if oracle in ("mixed", "ds"):
        with pytest.raises(ValueError, match="stochastic"):
            port.FrobeniusSymLossResMeasEx(M, 5, noise=0.1, oracle=oracle,
                                           device="cpu")


def test_svm_ball_structure():
    np.random.seed(3)
    f, (poly, sq), L, x0, radius = port.svm_digits_ds_divs_ball(
        device="cpu")
    A = f.A.numpy()
    assert A.shape == (700, 2000) and set(np.unique(f.y.numpy())) <= {-1, 1}
    norms = np.linalg.norm(A, axis=1)
    np.testing.assert_allclose(poly.DS_mean, norms.mean(), rtol=1e-14)
    np.testing.assert_allclose(poly.DS_mean_quad, (norms ** 2).mean(),
                               rtol=1e-14)
    assert radius == min(np.sum(np.linalg.norm(A[:, :-1], axis=1))
                         / (2000 * 0.5), (2.0 / 0.5) ** 0.5)
    assert poly.radius == radius and poly.lamda == 0.5
    np.testing.assert_allclose(
        L, (poly.DS_mean + min(1.0, poly.DS_mean_quad)) * 0.08, rtol=1e-15)
    assert float(torch.linalg.vector_norm(x0)) <= radius
    assert type(sq) is port.SquaredL2Norm
    # x0 is the JAX helper's draw for this radius and seed state
    np.random.seed(3)
    ref = jax_utils.random_point_in_l2_ball(np.zeros(2000), radius)
    np.random.seed(3)
    _same(port.random_point_in_l2_ball(np.zeros(2000), radius), ref)


# ---------------------------------------------------------------------------
# numpy helpers, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("random_point_on_simplex", (12,)),
    ("random_point_on_simplex", (12, 2.0, True)),
    ("edge_point_on_simplex", (3, 12)),
    ("random_point_in_l2_ball", (np.ones(6), 2.0, 0.2, 0.9, True)),
    ("get_random_float", (3.0,)), ("get_random_float", (0,)),
    ("get_random_vector", (5, 2.0)), ("get_random_vector", (5, 0))])
def test_sampling_helpers_match_jax(name, args):
    rj, rp = _both(9, lambda: getattr(jax_utils, name)(*args),
                   lambda: getattr(port, name)(*args))
    _same(rp, rj)


def test_data_helpers_match_jax():
    rng = np.random.default_rng(4)
    X = rng.standard_normal((30, 4))
    y = rng.integers(0, 4, 30)
    for name, args in (("shuffle_data", (X, y)),
                       ("mnist_2digits", (X, y, 1, 2))):
        rj, rp = _both(2, lambda: getattr(jax_utils, name)(*args),
                       lambda: getattr(port, name)(*args))
        for a, b in zip(rp, rj):
            _same(a, b)
    w = rng.standard_normal(4)
    ys = np.sign(rng.standard_normal(30))
    assert port.binary_error_rate(X, ys, w, 0.1) == \
        jax_utils.binary_error_rate(X, ys, w, 0.1)
    assert port.rmse(X, ys, w) == jax_utils.rmse(X, ys, w)


# ---------------------------------------------------------------------------
# torch-seeded logistic generators
# ---------------------------------------------------------------------------


def test_toeplitz_matrix_matches_jax():
    got = port.toeplitz_matrix(9, 0.95, device="cpu")
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(acc.toeplitz_matrix(9, 0.95)),
                               rtol=1e-15)


@pytest.mark.parametrize("domain", ["l1", "l2", "linf", "simplex"])
def test_ground_truth_is_feasible(domain):
    gen = torch.Generator().manual_seed(5)
    omega = papps._ground_truth(gen, torch.device("cpu"), domain, 40, 3.0,
                                5).numpy()
    if domain in ("l1", "simplex"):
        assert np.count_nonzero(omega) == 5
        np.testing.assert_allclose(np.abs(omega).sum(), 3.0, rtol=1e-14)
        if domain == "simplex":
            assert omega.min() >= 0
    elif domain == "linf":
        np.testing.assert_array_equal(np.abs(omega), np.full(40, 3.0))
    else:
        np.testing.assert_allclose(np.linalg.norm(omega), 3.0, rtol=1e-12)


@pytest.mark.parametrize("domain,x0_mode", [
    ("l1", "center"), ("l1", "vertex"), ("l2", "center"),
    ("linf", "center"), ("simplex", "vertex")])
def test_hard_logistic_generator(domain, x0_mode):
    out = port.hard_FW_log_reg_jax(11, 120, 40, radius=2.0, domain=domain,
                                   flip_y=0.1, x0_mode=x0_mode,
                                   device="cpu")
    f, h, L, L0, L1, x0, X, y = out
    assert type(f) is port.LogisticRegression and type(h) is \
        port.SquaredL2Norm
    assert X.shape == (120, 40) and f.X is X and f.y is y
    assert set(np.unique(y.numpy())) <= {-1.0, 1.0}
    rows = np.linalg.norm(X.numpy(), axis=1)
    np.testing.assert_allclose(float(L), rows.max() ** 2, rtol=1e-14)
    np.testing.assert_allclose(float(L1), rows.max(), rtol=1e-14)
    assert L0 == 1e-12
    x0 = x0.numpy()
    if domain in ("l1", "simplex") and x0_mode != "center":
        assert np.count_nonzero(x0) == 1 and x0.sum() == 2.0
    else:
        np.testing.assert_array_equal(x0, np.zeros(40))
    # the same seed, a generator seeded alike, or a JAX key array give the
    # same arrays
    again = port.hard_FW_log_reg_jax(
        torch.Generator().manual_seed(11), 120, 40, radius=2.0,
        domain=domain, flip_y=0.1, x0_mode=x0_mode)
    _same(again[6], X)
    _same(again[7], y)
    assert not np.array_equal(port.hard_FW_log_reg_jax(
        12, 120, 40, domain=domain, device="cpu")[6].numpy(), X.numpy())
    keyed = port.hard_FW_log_reg_jax(jax.random.PRNGKey(11), 120, 40,
                                     radius=2.0, domain=domain, flip_y=0.1,
                                     x0_mode=x0_mode, device="cpu")
    _same(keyed[6], X)


def test_legacy_logistic_generator():
    f, h, L, L0, L1, x0 = port.L0L1_FW_log_reg(3, 80, 6, 2.0, noise=0.1,
                                               device="cpu")
    X = f.X.numpy()
    assert X.shape == (80, 6) and set(np.unique(f.y.numpy())) <= {-1, 1}
    rows = np.linalg.norm(X, axis=1)
    np.testing.assert_allclose(float(L), rows.max() ** 2, rtol=1e-14)
    np.testing.assert_allclose(float(L1), rows.max(), rtol=1e-14)
    assert L0 == 1e-9
    np.testing.assert_array_equal(x0.numpy(), np.full(6, 1e-6))


def test_the_port_solves_the_jax_logistic_arrays():
    """The parity route the module docstring names: JAX's X, y in the
    port's oracle give JAX's values."""
    fj, *_, X, y = acc.hard_FW_log_reg_jax(jax.random.PRNGKey(2), 60, 12)
    fp = port.LogisticRegression(np.asarray(X), np.asarray(y), device="cpu")
    w = np.random.default_rng(1).standard_normal(12)
    vj, gj = fj.value_and_grad(jnp.asarray(w))
    vp, gp = fp.value_and_grad(torch.tensor(w))
    np.testing.assert_allclose(float(vp), float(vj), rtol=1e-13)
    np.testing.assert_allclose(gp.numpy(), np.asarray(gj), rtol=1e-12,
                               atol=1e-15)
