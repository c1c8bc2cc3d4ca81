"""The port's inexact-oracle and constrained drivers (``algorithms/
extras.py``: AIBM, AdaptFGM, UniversalGM, PrimalDualSwitchingGradientMethod)
against the JAX drivers on the same inputs, in float64: the JAX oracles
cross over by ``interop.from_jax_oracle``, or the port's factory rebuilds
the same numpy arrays.

Bars: F and G (or the duality gaps and step sizes) at rtol 1e-11 with the
same number of rows (the same productive count and stop row for the
primal-dual driver); the final iterate at atol 1e-12.  Checkpoints move
between the packages in both directions.  The card's tests are in
tests/test_torch_extras_card.py, which imports no JAX.
"""

import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu as acc
import accbpg_and_fw_tpu.apps.applications as jax_apps
import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu_torch.interop import from_jax_oracle

from test_torch_lazy import keep_jax_exec_cache  # noqa: F401 (autouse)

torch.set_num_threads(1)

F_RTOL, X_ATOL = 1e-11, 1e-12
ITERS = {"AIBM": 100, "AdaptFGM": 60, "UniversalGM": 60}


def _call(pkg, name, f, h, L, x0, iters, **kw):
    if name == "AIBM":
        return pkg.AIBM(f, h, L, x0, gamma=2.0, maxitrs=iters, **kw)
    return getattr(pkg, name)(f, h, L, x0, maxitrs=iters, **kw)


def _rows(got, ref, rtol=F_RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert len(got) == len(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)


def _x(xp, xj):
    assert isinstance(xp, torch.Tensor) and xp.dtype == torch.float64
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=0,
                               atol=X_ATOL)


@pytest.fixture(scope="module")
def poisson():
    """``Poisson_regr_simplex_acc(80, 40, noise=0.001)`` after seed 7, as
    tests/test_algorithms.py's extras use it."""
    np.random.seed(7)
    fj, hs, L, x0j = acc.Poisson_regr_simplex_acc(80, 40, noise=0.001)
    return ((fj, hs[0], L, x0j),
            (from_jax_oracle(fj, device="cpu"), from_jax_oracle(hs[0]), L,
             torch.tensor(np.asarray(x0j))))


@pytest.fixture(scope="module")
def svm():
    """The SVM ball with the PolyDiv kernel on a 60x25 dataset (the
    factory's own draws, from a seeded generator in place of its unseeded
    700x2000 one)."""
    def small(m, n):
        data = np.random.default_rng(5).standard_normal((60, 25)) * 100
        return data, np.where((data > 0).sum(axis=1) < 25 * 0.53, 1, -1)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_apps, "generate_dataset_for_svm", small)
        np.random.seed(11)
        fj, (hj, _), L, x0j, _ = acc.svm_digits_ds_divs_ball(lamda=0.001)
    return ((fj, hj, L, x0j),
            (from_jax_oracle(fj, device="cpu"), from_jax_oracle(hj), L,
             torch.tensor(np.asarray(x0j))))


@pytest.mark.parametrize("name", ["AIBM", "AdaptFGM", "UniversalGM"])
@pytest.mark.parametrize("which", ["poisson", "svm"])
def test_inexact_drivers_match_jax(request, which, name):
    """On the SVM, 20 rows: the hinge is not smooth, and from row 22
    AdaptFGM's L grows by 2^17, past which its acceptance tests compare
    values equal to their last bits (the two packages then part ways)."""
    jx, pt = request.getfixturevalue(which)
    iters = ITERS[name] if which == "poisson" else 20
    rj = _call(acc, name, *jx, iters, verbose=False)
    rp = _call(port, name, *pt, iters, verbose=False)
    _rows(rp[1], rj[1])
    _rows(rp[2], rj[2])
    _x(rp[0], rj[0])
    assert np.all(np.isfinite(rp[1])) and rp[1][-1] < rp[1][0]


def test_aibm_g_records_the_adapted_l(poisson):
    _, (f, h, L, x0) = poisson
    x, F, G, T = port.AIBM(f, h, L, x0, gamma=2.0, maxitrs=5, verbose=False)
    assert G[0] >= L and np.all(G[1:] == 0.0) and len(T) == len(F) == 5


@pytest.mark.parametrize("name", ["AIBM", "AdaptFGM", "UniversalGM"])
def test_one_iteration_returns_the_k0_row(poisson, name):
    jx, pt = poisson
    rj = _call(acc, name, *jx, 1, verbose=False)
    rp = _call(port, name, *pt, 1, verbose=False)
    _rows(rp[1], rj[1])
    _rows(rp[2], rj[2])
    _x(rp[0], rj[0])


# ---------------------------------------------------------------------------
# the primal-dual switching method
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pd_problem():
    """``TestPrimalDualGolden``'s instance (tests/test_reference_parity.py):
    rank-1 M from 25 uniform draws after seed 31, r = 4, built by each
    package's factory from the same numpy stream."""
    out = []
    for make in (acc.FrobeniusSymLossExWithLinearCnstrnts,
                 lambda M, r: port.FrobeniusSymLossExWithLinearCnstrnts(
                     M, r, device="cpu")):
        np.random.seed(31)
        x = np.random.rand(25)
        out.append(make(np.outer(x, x), 4))
    return out


def test_constrained_factory_is_the_jax_instance(pd_problem):
    (fj, gj, hj, Lj, X0j), (fp, gp, hp, Lp, X0p) = pd_problem
    np.testing.assert_array_equal(X0p.numpy(), np.asarray(X0j))
    np.testing.assert_array_equal(fp.M.numpy(), np.asarray(fj.M))
    np.testing.assert_array_equal(gp.A.numpy(), np.asarray(gj.A))
    np.testing.assert_array_equal(gp.b.numpy(), np.asarray(gj.b))
    assert hp.sigma == float(hj.sigma) and hp.alpha == float(hj.alpha)
    assert Lp == Lj == 1.0 and fp.noise_level is None


def _pd(pkg, prob, iters, **kw):
    f, g, h, L, X0 = prob
    return pkg.PrimalDualSwitchingGradientMethod(
        f, h, L, g, X0, iters, epsilon=1e-9, verbose=False, **kw)


def _pd_same(rp, rj):
    (Fp, Gp, Lp), (Fj, Gj, Lj) = rp, rj
    assert len(Fp) == len(Fj)  # the same productive count
    assert len(Gp) == len(Gj)  # the same stop row
    for got, ref in ((Fp, Fj), (Gp, Gj), (Lp, Lj)):
        assert isinstance(got, np.ndarray)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=F_RTOL,
                                   atol=0)


@pytest.mark.parametrize("exact_dual_grad", [False, True])
@pytest.mark.parametrize("linesearch", [True, False])
def test_primal_dual_matches_jax(pd_problem, linesearch, exact_dual_grad):
    kw = dict(linesearch=linesearch, exact_dual_grad=exact_dual_grad)
    rj = _pd(acc, pd_problem[0], 25, **kw)
    rp = _pd(port, pd_problem[1], 25, **kw)
    _pd_same(rp, rj)
    assert 0 < len(rp[0]) < len(rp[1])  # both kinds of step were taken


def test_primal_dual_scalar_constraint():
    """The dual ascent's scalar-constraint branch (``TestPrimalDualGolden``'s
    second case: g(x) = sum(x) - c)."""
    from accbpg_and_fw_tpu.ops.base import SmoothOracle
    from accbpg_and_fw_tpu.struct import pytree_dataclass
    import jax.numpy as jnp

    @pytree_dataclass
    class SumMinusC(SmoothOracle):
        c: float = 0.0

        def value(self, x, key=None):
            return jnp.sum(x) - self.c

        def grad(self, x, key=None):
            return jnp.ones_like(x)

        def value_and_grad(self, x, key=None):
            return self.value(x), self.grad(x)

    class PortSumMinusC(port.SmoothOracle):
        def __init__(self, c):
            self.c = c

        def value(self, x, key=None):
            return torch.sum(x) - self.c

        def grad(self, x, key=None):
            return torch.ones_like(x)

        def value_and_grad(self, x, key=None):
            return self.value(x), self.grad(x)

    probs = []
    for pkg, kw in ((acc, {}), (port, {"device": "cpu"})):
        np.random.seed(32)
        x = np.random.rand(20)
        probs.append(pkg.FrobeniusSymLossExWithLinearCnstrnts(
            np.outer(x, x), 3, **kw))
    c = float(0.9 * np.asarray(probs[0][4]).sum())
    (fj, _, hj, L, X0j), (fp, _, hp, _, X0p) = probs
    rj = _pd(acc, (fj, SumMinusC(c=c), hj, L, X0j), 15)
    rp = _pd(port, (fp, PortSumMinusC(c), hp, L, X0p), 15)
    _pd_same(rp, rj)


def test_primal_dual_one_block_per_short_ascent(pd_problem, monkeypatch):
    """The inner ascent's masked bodies change the host reads only: chunks
    run through the graph chunk's code on the CPU with one masked body
    per ascent (every iteration overflows and runs again eagerly) give the
    eager run bit for bit."""
    from accbpg_and_fw_tpu_torch.algorithms import driver, extras

    ref = _pd(port, pd_problem[1], 10)
    monkeypatch.setattr(driver, "chunk_mode",
                        lambda carry, problem=None, cfg=None: "graph")
    monkeypatch.setattr(driver, "_GRAPHS", type(driver._GRAPHS)())
    monkeypatch.setattr(extras, "DUAL_BODIES", 1)
    before = driver.GRAPH_STATS["continuations"]
    got = _pd(port, pd_problem[1], 10)
    assert driver.GRAPH_STATS["continuations"] - before == 10
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# checkpoints and printed tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_aibm_checkpoint_resumes_across_packages(poisson, tmp_path, writer):
    """40 noisy iterations saved by one package (the noise key in the
    carry), resumed to 80 by the other, against JAX's uninterrupted run;
    the port draws JAX's samples (``_rng``)."""
    ck = str(tmp_path / "aibm.npz")
    first, second = (acc, port) if writer == "jax" else (port, acc)
    args = {acc: poisson[0], port: poisson[1]}
    # delta at 1e-6, the examples' own: at 1e-4 the run meets its noise
    # floor by row 39, where acceptances rest on last bits
    kw = dict(noise=1e-6, seed=3, verbose=False, chunk=10)
    r1 = _call(first, "AIBM", *args[first], 40, checkpoint=ck, **kw)
    with np.load(ck) as z:
        assert str(z["__fp"]) == ("accbpg_and_fw_tpu.algorithms.extras."
                                  "_aibm_step|_AIBMCfg(stochastic=False)")
        assert int(z["__k_next"]) == 40 and z["c::key"].dtype == np.uint32
    r2 = _call(second, "AIBM", *args[second], 80, checkpoint=ck, **kw)
    # rows 1-39 come from the file; the k=0 row is the resuming package's
    np.testing.assert_array_equal(np.asarray(r2[1])[1:40],
                                  np.asarray(r1[1])[1:])
    ref = _call(acc, "AIBM", *poisson[0], 80, **kw)
    _rows(r2[1], ref[1])


def test_aibm_checkpoint_resumes_jax_noiseless(poisson, tmp_path):
    ck = str(tmp_path / "aibm0.npz")
    _call(acc, "AIBM", *poisson[0], 40, checkpoint=ck, chunk=10,
          verbose=False)
    r2 = _call(port, "AIBM", *poisson[1], 80, checkpoint=ck, chunk=10,
               verbose=False)
    ref = _call(acc, "AIBM", *poisson[0], 80, chunk=10, verbose=False)
    _rows(r2[1], ref[1])
    _x(r2[0], ref[0])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_primal_dual_checkpoint_resumes_across_packages(pd_problem, tmp_path,
                                                        writer):
    ck = str(tmp_path / "pd.npz")
    first, second = (acc, port) if writer == "jax" else (port, acc)
    args = {acc: pd_problem[0], port: pd_problem[1]}
    _pd(first, args[first], 12, chunk=4, checkpoint=ck)
    with np.load(ck) as z:
        assert str(z["__fp"]) == (
            "accbpg_and_fw_tpu.algorithms.extras._pd_step|_PDCfg("
            "linesearch=True, dual_max_inner=100, exact_dual_grad=False)")
    r2 = _pd(second, args[second], 25, chunk=4, checkpoint=ck)
    ref = _pd(acc, pd_problem[0], 25, chunk=4)
    _pd_same(tuple(np.asarray(a) for a in r2), ref)


def _strip_time(lines):
    return [r.rsplit(None, 1)[0] if r.strip() else r for r in lines]


@pytest.mark.parametrize("name", ["AIBM", "AdaptFGM", "UniversalGM"])
def test_printed_tables_match_jax(poisson, capsys, name):
    _call(acc, name, *poisson[0], 6, verbskip=2)
    ref = capsys.readouterr().out.splitlines()
    _call(port, name, *poisson[1], 6, verbskip=2)
    got = capsys.readouterr().out.splitlines()
    assert got[:3] == ref[:3] and len(got) == len(ref)
    assert _strip_time(got[3:]) == _strip_time(ref[3:])


def test_primal_dual_printed_table_matches_jax(pd_problem, capsys):
    for pkg, prob in ((acc, pd_problem[0]), (port, pd_problem[1])):
        f, g, h, L, X0 = prob
        pkg.PrimalDualSwitchingGradientMethod(f, h, L, g, X0, 25,
                                              epsilon=1e-9, verbskip=1)
    out = capsys.readouterr().out.splitlines()
    ref, got = out[:len(out) // 2], out[len(out) // 2:]
    assert got[:3] == ref[:3] and len(got) > 3
    assert _strip_time(got[3:]) == _strip_time(ref[3:])
