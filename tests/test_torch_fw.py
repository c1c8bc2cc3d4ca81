"""The port's Frank-Wolfe drivers (``algorithms/fw.py``) against the JAX
drivers on the same oracles (built in JAX, handed over by
``interop.from_jax_oracle``), in float64.

Problems: hard logistic regression 150x30 (the ``"illcond"`` regime of
``examples/ex_fw_l0l1.py``: rho 0.99, 20% flipped labels, radius 25, an l2
ball), D-optimal design 40x120 and Poisson regression 200x100 on the
simplex (``examples/ex_fw_rs.py``), SymNMF 40x5 with an l-inf box
(``examples/ex_params_free_symnmf.py``).

Bars: F and Ls rtol 1e-11 with the same number of rows, x atol 1e-12.
The two (L0,L1) log-step drivers are held to those bars over their first
60 iterations.  Their recurrence multiplies L0 and L1 by the
line-search ratio and takes log and expm1 of the products, and each
accepted step is set by a gradient that nearly cancels (||g|| enters a_k
and L1 ||d|| the log), so the last-bit difference of the two packages'
sums (XLA's and PyTorch's GEMVs and norms add in different orders)
grows from row to row on this problem; 60 rows stay within the bar.
"""

import numpy as np
import pytest
import torch

import jax

import accbpg_and_fw_tpu as acc
import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu_torch.interop import from_jax_oracle

from test_torch_lazy import keep_jax_exec_cache  # noqa: F401 (autouse)

torch.set_num_threads(1)

F_RTOL, X_ATOL = 1e-11, 1e-12
ITERS, LOG_ITERS = 200, 60

# one JAX LMO instance per geometry, so each JAX driver compiles once
LMO = {"l2": (acc.lmo_l2_ball(25.0), port.lmo_l2_ball(25.0)),
       "simplex": (acc.lmo_simplex(), port.lmo_simplex()),
       "box": (acc.lmo_linf_ball(1.0, 1.0), port.lmo_linf_ball(1.0, 1.0))}


class Problem:
    """One instance in both packages: ``j`` and ``p`` are (f, h, x0)."""

    def __init__(self, fj, hj, x0, lmo, **consts):
        self.j = (fj, hj, jax.numpy.asarray(x0))
        self.p = (from_jax_oracle(fj, device="cpu"),
                  from_jax_oracle(hj, device="cpu"),
                  torch.tensor(np.asarray(x0, np.float64)))
        self.lmo = LMO[lmo]
        self.__dict__.update(consts)

    def run(self, name, *args, **kw):
        """``(jax_result, port_result)`` of driver ``name`` called as
        ``name(f, h, *args_before_x0, x0, *rest, lmo=...)``; ``args`` holds
        ``"x0"`` where the start goes."""
        out = []
        for pkg, (f, h, x0), lmo in ((acc, self.j, self.lmo[0]),
                                     (port, self.p, self.lmo[1])):
            a = [x0 if v == "x0" else v for v in args]
            out.append(getattr(pkg, name)(f, h, *a, lmo=lmo, verbose=False,
                                          **kw))
        return out


@pytest.fixture(scope="module")
def logistic():
    fj, hj, L, L0, L1, x0, _, _ = acc.hard_FW_log_reg_jax(
        jax.random.PRNGKey(63), 150, 30, radius=25.0, domain="l2", rho=0.99,
        col_scale=1.0, flip_y=0.2, noise=0.1)
    return Problem(fj, hj, x0, "l2", L=float(L), L0=max(float(L0), 1e-9),
                   L1=float(L1))


@pytest.fixture(scope="module")
def dopt():
    fj, hj, L, x0 = acc.D_opt_design(40, 120, randseed=10)
    return Problem(fj, hj, x0, "simplex", L=L)


@pytest.fixture(scope="module")
def poisson():
    np.random.seed(1)
    hj, scenarios = acc.Poisson_regr_simplex(200, 100)
    fj, L, _, x0 = scenarios["x0_center_sol_center"]
    return Problem(fj, hj, x0, "simplex", L=L)


@pytest.fixture(scope="module")
def symnmf():
    rng = np.random.default_rng(0)
    pts = np.concatenate([c + 0.3 * rng.standard_normal((10, 8))
                          for c in rng.standard_normal((4, 8)) * 2.0])
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.random.seed(0)
    fj, (hj, hj_euk), _, X0 = acc.FrobeniusSymLossResMeasEx(
        np.exp(-d2 / d2.mean()), 5)
    return (Problem(fj, hj, X0, "box"), Problem(fj, hj_euk, X0, "box"))


def assert_rows(got, ref, rtol=F_RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert len(got) == len(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)


def assert_x(xp, xj, atol=X_ATOL):
    assert isinstance(xp, torch.Tensor) and xp.dtype == torch.float64
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# the five drivers against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,ls_ratio", [("logistic", 2.2),
                                           ("logistic", 2.0),
                                           ("dopt", 2.0), ("poisson", 2.0)])
def test_div_step_matches_jax(name, ls_ratio, request):
    prob = request.getfixturevalue(name)
    rj, rp = prob.run("FW_alg_div_step", prob.L, "x0", ITERS, 2.0,
                      ls_ratio=ls_ratio)
    assert len(rp) == len(rj) == 4
    assert_rows(rp[1], rj[1])
    assert_rows(rp[2], rj[2])
    assert np.unique(np.asarray(rj[2])).size > 1  # the line search moved L
    assert_x(rp[0], rj[0])
    assert len(rp[3]) == len(rp[1]) and np.all(np.diff(rp[3]) >= 0)


def test_div_step_without_linesearch(dopt):
    rj, rp = dopt.run("FW_alg_div_step", 3.0, "x0", 100, 2.0,
                      linesearch=False)
    assert_rows(rp[1], rj[1])
    assert np.all(rp[2] == 3.0)
    assert_x(rp[0], rj[0])


@pytest.mark.parametrize("case", ["logistic", "symnmf_burg", "symnmf_euk"])
def test_descent_step_matches_jax(case, request):
    if case == "logistic":
        prob = request.getfixturevalue("logistic")
    else:
        prob = request.getfixturevalue("symnmf")[case != "symnmf_burg"]
    rj, rp = prob.run("FW_alg_descent_step", "x0", ITERS)
    assert len(rp) == len(rj) == 4
    assert_rows(rp[1], rj[1])
    assert_x(rp[0], rj[0])
    assert rp[2][0] == 0.0 and len(rp[2]) == len(rp[1])
    np.testing.assert_array_equal(rp[3], np.zeros(len(rp[1])))


@pytest.mark.parametrize("linesearch", [True, False])
def test_shortest_step_matches_jax(logistic, linesearch):
    rj, rp = logistic.run("FW_alg_L0_L1_shortest_step", logistic.L0,
                          logistic.L1, "x0", ITERS, 2.0,
                          linesearch=linesearch)
    assert len(rp) == len(rj) == 4
    assert_rows(rp[1], rj[1])
    assert_rows(rp[2], rj[2])
    assert_x(rp[0], rj[0])


@pytest.mark.parametrize("name", ["FW_l0l1_log_and_linear_step",
                                  "FW_l0l1_log_only"])
@pytest.mark.parametrize("linesearch", [True, False])
def test_log_step_drivers_match_jax(logistic, name, linesearch):
    rj, rp = logistic.run(name, 1e-3, logistic.L1, "x0", LOG_ITERS,
                          ls_ratio=2.2, linesearch=linesearch)
    assert len(rp) == len(rj) == 5
    assert_rows(rp[1], rj[1])
    assert_rows(rp[2], rj[2])
    np.testing.assert_array_equal(rp[3], np.asarray(rj[3]))
    assert np.all(np.diff(rp[3]) >= 0) and rp[3][-1] >= 1
    assert_x(rp[0], rj[0])


def test_log_step_caps(logistic):
    """L0_max / L1_max cap the back-off (the NaN-propagating minimum)."""
    rj, rp = logistic.run("FW_l0l1_log_and_linear_step", 1e-3, logistic.L1,
                          "x0", 30, ls_ratio=2.2, L0_max=5e-3,
                          L1_max=2.0 * logistic.L1)
    assert_rows(rp[1], rj[1])
    assert_rows(rp[2], rj[2])
    np.testing.assert_array_equal(rp[3], np.asarray(rj[3]))


# ---------------------------------------------------------------------------
# errors, truncation, tables, checkpoints
# ---------------------------------------------------------------------------


def _ascent_lmo(pkg):
    """An LMO that returns the ascent vertex: <g, s - x> > 0."""
    inner = pkg.lmo_l2_ball(25.0)
    return lambda g: inner(-g)


@pytest.mark.parametrize("name,args", [
    ("FW_alg_div_step", ("L", "x0", 50, 2.0)),
    ("FW_alg_L0_L1_shortest_step", ("L0", "L1", "x0", 50, 2.0)),
    ("FW_l0l1_log_and_linear_step", ("L0", "L1", "x0", 50)),
    ("FW_l0l1_log_only", ("L0", "L1", "x0", 50))])
def test_bad_lmo_raises_like_jax(logistic, name, args):
    kw = {} if "log" not in name else dict(ls_ratio=2.0)
    for pkg, (f, h, x0) in ((acc, logistic.j), (port, logistic.p)):
        a = [x0 if v == "x0" else getattr(logistic, v) if isinstance(v, str)
             else v for v in args]
        with pytest.raises(ValueError, match="grad_d_prod must be "
                                             "non-positive"):
            getattr(pkg, name)(f, h, *a, lmo=_ascent_lmo(pkg),
                               verbose=False, **kw)


@pytest.mark.parametrize("driver", ["div", "descent"])
def test_epsilon_truncates_like_jax(dopt, driver):
    if driver == "div":
        rj, rp = dopt.run("FW_alg_div_step", dopt.L, "x0", 3000, 2.0,
                          epsilon=1e-3, chunk=64)
    else:
        rj, rp = dopt.run("FW_alg_descent_step", "x0", 3000, epsilon=1e-5,
                          chunk=64)
    assert 1 < len(rp[1]) == len(rj[1]) < 3000
    assert_rows(rp[1], rj[1])
    assert_x(rp[0], rj[0])


def test_argument_checks_match_jax(logistic):
    f, h, x0 = logistic.p
    lmo = logistic.lmo[1]
    for call, msg in [
            (lambda: port.FW_alg_div_step(f, h, 1.0, x0, 5, 2.0, lmo,
                                          ls_ratio=0.5), "ls_ratio"),
            (lambda: port.FW_alg_div_step(f, h, 0.0, x0, 5, 2.0, lmo),
             "Initial L"),
            (lambda: port.FW_alg_L0_L1_shortest_step(f, h, -1.0, 1.0, x0, 5,
                                                     2.0, lmo), "Initial L"),
            (lambda: port.FW_l0l1_log_only(f, h, 0.0, 1.0, x0, 5, lmo, 2.0),
             "Initial L0 and L1"),
            (lambda: port.FW_l0l1_log_and_linear_step(
                f, h, 1.0, 1.0, x0, 5, lmo, 2.0, epsilon=0.0), "epsilon")]:
        with pytest.raises(ValueError, match=msg):
            call()


def test_stochastic_oracle_is_refused(symnmf):
    """No longer refused: both FW drivers that thread a key in JAX draw the
    oracle's noise from their ``seed``; the same seed gives the same run,
    and the noise reaches it."""
    f, h, X0 = symnmf[0].p
    # noise this large flips the signs the box LMO reads (0.1 does not)
    noisy = port.FrobeniusSymLoss.create(f.M, noise_level=1e3, device="cpu")
    lmo = port.lmo_linf_ball(1.0, 1.0)
    runs = {
        "descent": lambda g, seed: port.FW_alg_descent_step(
            g, h, X0, 5, lmo, verbose=False, seed=seed)[1],
        "div": lambda g, seed: port.FW_alg_div_step(
            g, h, 1.0, X0, 5, 2.0, lmo, verbose=False, seed=seed)[1]}
    for run in runs.values():
        F = run(noisy, 0)
        assert np.all(np.isfinite(F))
        np.testing.assert_array_equal(run(noisy, 0), F)
        clean = run(f, 0)
        assert len(clean) != len(F) or not np.array_equal(clean, F)


def test_printed_tables_match_jax(logistic, capsys):
    calls = [("FW_alg_div_step", (logistic.L, "x0", 4, 2.0), {}),
             ("FW_alg_descent_step", ("x0", 4), {}),
             ("FW_alg_L0_L1_shortest_step",
              (logistic.L0, logistic.L1, "x0", 4, 2.0), {}),
             ("FW_l0l1_log_and_linear_step",
              (1e-3, logistic.L1, "x0", 4), dict(ls_ratio=2.2, verbskip=1)),
             ("FW_l0l1_log_only", (1e-3, logistic.L1, "x0", 4),
              dict(ls_ratio=2.2, verbskip=1))]
    for name, args, kw in calls:
        out = []
        for pkg, (f, h, x0), lmo in ((acc, logistic.j, logistic.lmo[0]),
                                     (port, logistic.p, logistic.lmo[1])):
            a = [x0 if v == "x0" else v for v in args]
            getattr(pkg, name)(f, h, *a, lmo=lmo, **kw)
            out.append(capsys.readouterr().out.splitlines())
        ref, got = out
        assert len(got) == len(ref) and got[:3] == ref[:3]
        # every column but the time
        assert [r.rsplit(None, 1)[0] for r in got[3:]] == \
            [r.rsplit(None, 1)[0] for r in ref[3:]]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name", ["FW_alg_descent_step", "FW_alg_div_step",
                                  "FW_l0l1_log_only"])
def test_checkpoint_resumes_across_packages(logistic, tmp_path, writer,
                                            name):
    """30 iterations saved by one package, resumed to 60 by the other,
    against JAX's uninterrupted run."""
    ck = str(tmp_path / "fw.npz")
    args = {"FW_alg_descent_step": (),
            "FW_alg_div_step": (logistic.L,),
            "FW_l0l1_log_only": (1e-3, logistic.L1)}[name]
    tail = {"FW_alg_div_step": (2.0,)}.get(name, ())
    kw = dict(ls_ratio=2.2) if name == "FW_l0l1_log_only" else {}
    step = {"FW_alg_descent_step": "_fw_descent_step|_FWDescentCfg",
            "FW_alg_div_step": "_fw_div_step|_FWDivCfg",
            "FW_l0l1_log_only": "_fw_l0l1_log_step|_FWLogCfg"}[name]
    first, second = (acc, port) if writer == "jax" else (port, acc)

    def run(pkg, iters, **extra):
        (f, h, x0), lmo = ((logistic.j, logistic.lmo[0]) if pkg is acc
                           else (logistic.p, logistic.lmo[1]))
        return getattr(pkg, name)(f, h, *args, x0, iters, *tail, lmo=lmo,
                                  verbose=False, chunk=20, **kw, **extra)

    r1 = run(first, 30, checkpoint=ck)
    with np.load(ck) as z:
        assert str(z["__fp"]) == f"accbpg_and_fw_tpu.algorithms.fw.{step}"
        assert int(z["__k_next"]) == 30
    r2 = run(second, 60, checkpoint=ck)
    ref = run(acc, 60)
    # the saved rows come back bit for bit (the descent step's k = 0 row
    # is evaluated anew by the resuming package)
    skip = int(name == "FW_alg_descent_step")
    np.testing.assert_array_equal(np.asarray(r2[1])[skip:30],
                                  np.asarray(r1[1])[skip:30])
    assert_rows(r2[1], ref[1])
    x2 = r2[0] if isinstance(r2[0], torch.Tensor) else torch.tensor(
        np.asarray(r2[0]))
    assert_x(x2, ref[0])
