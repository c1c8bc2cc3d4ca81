"""The port's sharding (``accbpg_and_fw_tpu_torch/parallel/mesh.py``) on a
2-rank ``torch.distributed`` gloo group on the CPU, against the JAX
package's sharded runs of the same cases on the 8-virtual-device mesh of
``tests/conftest.py`` and against the port's unsharded runs.

One spawn serves the module: ``tests/torch_mesh_worker.py`` runs every
case in one 2-rank group and rank 0 prints one ``RESULT`` line.  The
problems are the JAX package's (the worker builds the port's oracles from
their arrays), so the three runs see the same numbers.  The bars are
``tests/test_parallel.py``'s for each case.  A padded design has n padded
to a multiple of 2 here and of 8 in JAX: the iterates are compared over
the first n entries, and the pads stay at 0 (or, for ABDA's dual
averaging, at the prox's ~1e-30 floor).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import accbpg_and_fw_tpu as acc
import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu.parallel import (data_mesh, shard_dopt_design,
                                        shard_dopt_problem,
                                        shard_regression_problem,
                                        shard_symnmf_problem)

from test_torch_lazy import keep_jax_exec_cache  # noqa: F401 (autouse)

_WORKER = os.path.join(os.path.dirname(__file__), "torch_mesh_worker.py")
EXTRAS_ITERS, PD_ITERS = 10, 12  # as in the worker


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _extras_problem():
    """The extras' Poisson problem: 64 samples of 20 features from
    ``default_rng(1)``, x0 = 0.05, and the primal-dual method's scalar
    constraint x @ a - b with b half of x0's value."""
    rng = np.random.default_rng(1)
    A = rng.uniform(0.0, 1.0, (64, 20))
    b = A @ rng.uniform(0.0, 1.0, 20)
    x0 = np.full(20, 0.05)
    a = rng.uniform(0.0, 1.0, 20)
    return A, b, x0, a, np.asarray(0.5 * float(x0 @ a))


def _symnmf_matrix():
    rng = np.random.default_rng(6)
    n, r = 64, 4
    Y = np.abs(rng.standard_normal((n, r)))
    M = Y @ Y.T / r + 0.01 * np.abs(rng.standard_normal((n, n)))
    return 0.5 * (M + M.T), r


@pytest.fixture(scope="module")
def problems():
    """The JAX problems of every case, as (f, h, L, x0) or extras."""
    p = {}
    for name, (m, n, seed) in {"dopt16": (16, 64, 5), "dopt51": (12, 51, 5),
                               "dopt45": (10, 45, 9),
                               "fw51": (10, 51, 4)}.items():
        p[name] = acc.D_opt_design(m, n, randseed=seed)
    p["log"] = acc.hard_FW_log_reg_jax(jax.random.PRNGKey(1), 64, 10,
                                       radius=1.5, domain="l2")
    p["poi"] = acc.Poisson_regrL1(64, 20, noise=0.0001, randseed=2)
    M, r = _symnmf_matrix()
    np.random.seed(3)
    p["nmf"] = acc.FrobeniusSymLossResMeasEx(M, r)
    return p


@pytest.fixture(scope="module")
def jmesh():
    return data_mesh(jax.devices()[:8])


class _Spawn:
    """The 2-rank worker group; ``get`` waits for its ``RESULT``."""

    def __init__(self, path):
        port_no = _free_port()
        env = {k: v for k, v in os.environ.items()
               if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
        self.procs = [subprocess.Popen(
            [sys.executable, _WORKER, str(port_no), str(rank), "2", path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for rank in range(2)]
        self.out = None

    def get(self):
        if self.out is None:
            self.out = self._wait()
        return self.out

    def _wait(self):
        try:
            outs = [p.communicate(timeout=300) for p in self.procs]
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
            pytest.fail("mesh workers timed out")
        for p, (out, err) in zip(self.procs, outs):
            assert p.returncode == 0, (
                f"worker {p.args} exited {p.returncode}\nstdout:\n"
                f"{out[-2000:]}\nstderr:\n{err[-3000:]}")
        lines = [ln for ln in outs[0][0].splitlines()
                 if ln.startswith("RESULT ")]
        assert lines, f"no RESULT from rank 0:\n{outs[0][0][-2000:]}"
        return json.loads(lines[0][len("RESULT "):])


@pytest.fixture(scope="module")
def spawn(problems, tmp_path_factory):
    data = {}
    for name in ("dopt16", "dopt51", "dopt45"):
        f, h, L, x0 = problems[name]
        data.update({f"{name}_H": np.asarray(f.H), f"{name}_x0": x0,
                     f"{name}_L": L})
    f, h, L, x0 = problems["fw51"]
    data.update(fw51_V=np.asarray(f.H), fw51_x0=x0)
    f, h, L, L0, L1, x0, X, y = problems["log"]
    data.update(log_X=X, log_y=y, log_alpha=f.alpha, log_x0=x0, log_L=L,
                log_radius=1.5)
    f, h, L, x0 = problems["poi"]
    data.update(poi_A=f.A, poi_b=f.b, poi_x0=x0, poi_L=L)
    f, (h, _), L, X0 = problems["nmf"]
    data.update(nmf_M=f.M, nmf_X0=X0, nmf_sigma=h.sigma)
    A, b, x0, a, c = _extras_problem()
    data.update(ext_A=A, ext_b=b, ext_x0=x0, pdc_A=a, pdc_b=c)
    path = str(tmp_path_factory.mktemp("mesh") / "data.npz")
    np.savez(path, **{k: np.asarray(v, np.float64) for k, v in data.items()})
    sp = _Spawn(path)
    yield sp
    for p in sp.procs:  # a test that failed before waiting leaves none
        if p.poll() is None:
            p.kill()
            p.communicate()


def _port_args(problem):
    """The port's (f, h, L, x0) on the CPU from a JAX D-opt problem."""
    f, h, L, x0 = problem
    return (port.DOptimalObj(np.asarray(f.H), device="cpu"),
            port.BurgEntropySimplex(), L,
            torch.tensor(np.asarray(x0, np.float64)))


def _check(got, ref_j, ref_p, n, rtol, atol, hists=("h1",)):
    """The worker's case against JAX's sharded run and the port's
    unsharded one: histories at ``rtol``, x over its first n entries at
    ``atol``; returns the worker's x."""
    for i, key in enumerate(hists):
        idx = int(key[1:])
        for ref in (ref_j, ref_p):
            h = np.asarray(ref[idx])
            assert len(got[key]) == len(h), key
            np.testing.assert_allclose(got[key], h, rtol=rtol)
    x = np.asarray(got["x"])
    for ref in (ref_j, ref_p):
        r = ref[0].numpy() if isinstance(ref[0], torch.Tensor) else ref[0]
        np.testing.assert_allclose(x[:n], np.asarray(r)[:n], atol=atol,
                                   rtol=0)
    return x


@pytest.fixture(scope="module")
def refs(problems, jmesh):
    """Every case's JAX sharded run and the port's unsharded one.  (They
    run before the worker group starts: run beside it, JAX's thread pool
    and the two ranks slowed each other down past their sum.)"""
    out = {}
    pf = _port_args
    for fast in (False, True):
        tag = "_fast" if fast else ""
        f, h, L, x0 = problems["dopt16"]
        f_sh, x_sh = shard_dopt_problem(f, x0, jmesh)
        out["bpg" + tag] = (
            acc.BPG(f_sh, h, L, x_sh, maxitrs=50, verbose=False,
                    fast_gram=fast),
            port.BPG(*pf(problems["dopt16"]), 50, verbose=False,
                     fast_gram=fast))
        out["gain" + tag] = (
            acc.ABPG_gain(f_sh, h, L, x_sh, gamma=2, maxitrs=40,
                          verbose=False, fast_gram=fast),
            port.ABPG_gain(*pf(problems["dopt16"]), 2.0, 40, verbose=False,
                           fast_gram=fast))

    f, h, L, x0 = problems["dopt51"]
    f_sh, x_sh = shard_dopt_problem(f, x0, jmesh)
    assert f_sh.H.shape == (12, 56)
    out["bpg51_fast"] = (
        acc.BPG(f_sh, h, L, x_sh, maxitrs=60, verbose=False, fast_gram=True),
        port.BPG(*pf(problems["dopt51"]), 60, verbose=False, fast_gram=True))

    f, h, L, x0 = problems["dopt45"]
    f_sh, x_sh = shard_dopt_problem(f, x0, jmesh)
    out["abda45_fast"] = (
        acc.ABDA(f_sh, h, L, x_sh, gamma=2, maxitrs=40, verbose=False,
                 fast_gram=True),
        port.ABDA(*pf(problems["dopt45"]), 2.0, 40, verbose=False,
                  fast_gram=True))

    f, h, L, x0 = problems["fw51"]
    V = np.asarray(f.H)
    Vs, x0s = shard_dopt_design(V, x0, jmesh)
    out["fw51"] = (
        acc.D_opt_FW_away(Vs, x0s, eps=1e-6, maxitrs=800, verbose=False,
                          chunk=400),
        port.D_opt_FW_away(V, x0, 1e-6, 800, verbose=False, chunk=400,
                           device="cpu"))

    f, h, L, L0, L1, x0, X, y = problems["log"]
    f_sh, x_sh = shard_regression_problem(f, x0, jmesh)
    fp = port.LogisticRegression(np.asarray(X), np.asarray(y),
                                 alpha=float(f.alpha), device="cpu")
    out["logreg"] = (
        acc.FW_alg_div_step(f_sh, h, float(L), x_sh, 50, gamma=2.0,
                            lmo=acc.lmo_l2_ball(1.5), verbose=False),
        port.FW_alg_div_step(fp, port.SquaredL2Norm(), float(L),
                             torch.tensor(np.asarray(x0)), 50, gamma=2.0,
                             lmo=port.lmo_l2_ball(1.5), verbose=False))

    f, h, L, x0 = problems["poi"]
    f_sh, x_sh = shard_regression_problem(f, x0, jmesh)
    fp = port.PoissonRegression(np.asarray(f.A), np.asarray(f.b),
                                device="cpu")
    out["poisson"] = (
        acc.BPG(f_sh, h, L, x_sh, maxitrs=50, linesearch=False,
                verbose=False),
        port.BPG(fp, port.BurgEntropyL1(lamda=0.0), L,
                 torch.tensor(np.asarray(x0)), 50, linesearch=False,
                 verbose=False))

    f, (h, _), L, X0 = problems["nmf"]
    f_sh, X_sh = shard_symnmf_problem(f, X0, jmesh)
    fp = port.FrobeniusSymLoss(np.asarray(f.M), device="cpu")
    hp = port.SumOf2nd4thPowersPositiveOrthant(alpha=6.0, sigma=h.sigma,
                                               upper_bound=None)
    out["symnmf"] = (
        acc.BPG(f_sh, h, L, X_sh, maxitrs=50, linesearch=False,
                verbose=False),
        port.BPG(fp, hp, L, torch.tensor(np.asarray(X0)), 50,
                 linesearch=False, verbose=False))
    out.update(_extras_refs(jmesh))
    return out


def _extras_refs(jmesh):
    """JAX's sharded runs and the port's unsharded runs of the worker's
    extras cases (``extras_cases``)."""
    from jax.sharding import NamedSharding, PartitionSpec

    A, b, x0, a, c = _extras_problem()
    fj, xj = shard_regression_problem(
        acc.PoissonRegression(A=jnp.asarray(A), b=jnp.asarray(b)),
        jnp.asarray(x0), jmesh)
    fp = port.PoissonRegression(A, b, device="cpu")
    xp = torch.tensor(x0)
    hj, hp = acc.BurgEntropySimplex(), port.BurgEntropySimplex()
    out = {}
    for name, run in {
            "aibm": lambda pkg, f, h, x: pkg.AIBM(
                f, h, 1.0, x, gamma=2.0, maxitrs=EXTRAS_ITERS,
                verbose=False),
            "adaptfgm": lambda pkg, f, h, x: pkg.AdaptFGM(
                f, h, 1.0, x, maxitrs=EXTRAS_ITERS, verbose=False),
            "universalgm": lambda pkg, f, h, x: pkg.UniversalGM(
                f, h, 1.0, x, maxitrs=EXTRAS_ITERS, verbose=False)}.items():
        out[name] = (run(acc, fj, hj, xj), run(port, fp, hp, xp))
    rep = NamedSharding(jmesh, PartitionSpec())
    gj = acc.AX_b(A=jax.device_put(jnp.asarray(a), rep),
                  b=jax.device_put(jnp.asarray(c), rep))
    out["pd_poisson"] = (
        acc.PrimalDualSwitchingGradientMethod(
            fj, acc.BurgEntropy(), 1.0, gj, xj, PD_ITERS, epsilon=1e-9,
            verbose=False),
        port.PrimalDualSwitchingGradientMethod(
            fp, port.BurgEntropy(), 1.0, port.AX_b(a, c, device="cpu"), xp,
            PD_ITERS, epsilon=1e-9, verbose=False))
    return out


@pytest.mark.parametrize("name,n,rtol,atol,hists", [
    ("bpg", 64, 1e-10, 1e-11, ("h1", "h2")),
    ("bpg_fast", 64, 1e-9, 1e-11, ("h1", "h2")),
    ("gain", 64, 1e-11, 1e-11, ("h1", "h2")),
    ("gain_fast", 64, 1e-9, 1e-11, ("h1", "h2")),
    ("logreg", 10, 1e-9, 1e-9, ("h1",)),
    ("poisson", 20, 1e-9, 1e-9, ("h1",)),
    ("symnmf", 64, 1e-9, 1e-7, ("h1",)),
])
def test_sharded_matches_jax_and_unsharded(refs, spawn, name, n, rtol, atol,
                                           hists):
    """BPG and ABPG_gain, plain and fast_gram, on 16x64; FW with the
    divergence step on logistic regression, BPG on Poisson regression and
    on SymNMF."""
    _check(spawn.get()[name], *refs[name], n, rtol, atol, hists)


@pytest.mark.parametrize("name", ["aibm", "adaptfgm", "universalgm"])
@pytest.mark.parametrize("graph", [False, True])
def test_sharded_extras_match_jax_and_unsharded(refs, spawn, name, graph):
    """AIBM, AdaptFGM and UniversalGM on a sample-sharded Poisson problem,
    eagerly and through the graph chunk's code (its rows bit for bit with
    the eager run's), against JAX's sharded run and the port's unsharded
    one at ``tests/test_parallel.py``'s bar.  The set-up before the loop
    (AIBM's k=0 line search, the FGM's k=0 row) runs under the steps'
    rule, and the gradient, a partial sum over the samples, is reduced
    before the simplex prox takes it."""
    got = spawn.get()[name + ("_graph" if graph else "")]
    assert got["sharded"] and got["placements"] == "(Replicate(),)"
    if graph:
        assert got["eager_equal"]
    assert len(got["h1"]) == EXTRAS_ITERS
    _check(got, *refs[name], 20, rtol=1e-9, atol=1e-10, hists=("h1", "h2"))


def test_sharded_primal_dual_matches_jax_and_unsharded(refs, spawn):
    """The primal-dual method on the sample-sharded Poisson problem with a
    replicated scalar constraint: F, the gaps and the step sizes against
    JAX's sharded run and the port's unsharded one, and the graph chunk's
    rows bit for bit with the eager run's."""
    got = spawn.get()["pd_poisson"]
    assert got["eager_equal"]
    ref_j, ref_p = refs["pd_poisson"]
    assert 0 < len(got["h0"]) < len(got["h1"]) == PD_ITERS
    for i in range(3):
        for ref in (ref_j, ref_p):
            np.testing.assert_allclose(got[f"h{i}"], np.asarray(ref[i]),
                                       rtol=1e-9, atol=0)


def test_bpg_fast_gram_non_divisible_n(refs, spawn):
    assert spawn.get()["dopt51_padded"] == [52, 51]
    x = _check(spawn.get()["bpg51_fast"], *refs["bpg51_fast"], 51,
               rtol=1e-9, atol=1e-10)
    np.testing.assert_array_equal(x[51:], 0.0)  # pads never move


def test_abda_fast_gram_padded(refs, spawn):
    x = _check(spawn.get()["abda45_fast"], *refs["abda45_fast"], 45,
               rtol=1e-8, atol=1e-9)
    assert np.abs(x[45:]).max() < 1e-12


def test_fw_away_sharded_design(refs, spawn):
    assert spawn.get()["fw51_padded"] == 52
    # F and the stopping row, as tests/test_parallel.py holds them (the
    # slacks tend to 0, where a relative bar means nothing)
    ref_j, ref_p = refs["fw51"]
    x = _check(spawn.get()["fw51"], ref_j, ref_p, 51, rtol=1e-9, atol=1e-11)
    assert 1 < len(ref_j[1]) < 800  # the run stopped at eps
    np.testing.assert_array_equal(x[51:], 0.0)


def test_sharded_graph_chunk_matches_eager_and_jax(refs, spawn):
    """A sharded solve through the graph chunk's code (on the CPU its
    spans run ``_masked_steps`` without a capture): its rows bit for bit
    with the eager sharded run's, and against JAX's sharded run and the
    port's unsharded one at the eager case's bars.  ABPG_gain fast_gram
    runs the worker's GRAPH_ITERS (10) iterations, held to the first rows
    of the 40-iteration references; D_opt_FW_away its whole run, the
    iterate too."""
    result = spawn.get()
    got = result["gain_fast_graph"]
    assert got["eager_equal"] and got["sharded"]
    for i in (1, 2):
        for ref in refs["gain_fast"]:
            h = np.asarray(ref[i])[:len(got[f"h{i}"])]
            assert len(got[f"h{i}"]) == 10
            np.testing.assert_allclose(got[f"h{i}"], h, rtol=1e-9)
    got = result["fw51_graph"]
    assert got["eager_equal"] and got["sharded"]
    _check(got, *refs["fw51"], 51, rtol=1e-9, atol=1e-11)


def test_sharded_graph_chunk_static_buffers(spawn):
    """The entry's static buffers are the local shards (plain tensors, x
    of 64 / 2 entries), the step sees DTensors of the carry's placements
    around them, and the key names x's local shape, placements and mesh."""
    e = spawn.get()["graph_entry"]
    assert e["bufs"]["x"] == ["Tensor", [32]]
    assert e["bufs"]["Gx"] == ["Tensor", [16, 16]]
    assert all(kind == "Tensor" for kind, _ in e["bufs"].values())
    assert e["views"]["x"] == "(Shard(dim=0),)"
    assert e["views"]["Gx"] == e["views"]["done"] == "(Replicate(),)"
    assert e["x_spec"] == ["(64,)", "torch.float64", "cpu", "(32,)",
                           "(Shard(dim=0),)", "cpu", "(2,)", "(0, 1)"]
    assert e["problem_plain"] and [16, 32] in e["problem_local_shapes"]


def test_sharded_graph_chunk_second_solve_and_keys(spawn):
    """A second solve of the same shapes on other data replays the same
    entry and matches its eager run; another placement of x and a mesh of
    other ranks give other keys."""
    result = spawn.get()
    second = result["graph_second"]
    assert second == {"entries": 1, "eager_equal": True,
                      "differs_from_first": True}
    assert result["graph_keys_distinct"]


def test_group_and_mesh(spawn):
    result = spawn.get()
    assert result["world"] == 2 and result["mesh"] == [2]
    assert result["dopt16_H_placements"] == "(Shard(dim=1),)"


def test_output_keeps_sharding(spawn):
    """The iterate a sharded run returns is sharded as its start was:
    columns for the D-opt drivers, replicated for a regression."""
    result = spawn.get()
    for name in ("bpg", "bpg_fast", "gain", "gain_fast", "bpg51_fast",
                 "abda45_fast", "fw51", "symnmf"):
        assert result[name]["sharded"], name
        assert result[name]["placements"] == "(Shard(dim=0),)", name
    for name in ("logreg", "poisson"):
        assert result[name]["placements"] == "(Replicate(),)", name


def test_kernel_modes_refuse_a_sharded_design(spawn):
    assert spawn.get()["refused"] == {"pallas": True, "pallas_lazy": True,
                                      "use_pallas": True, "batch_auto": True,
                                      "batch_pallas": True}


def test_auto_takes_the_exact_engine_for_a_sharded_design(monkeypatch):
    """``_resolve_auto_u_mode`` on a CUDA device (no card is needed to
    ask): a design that "auto" sends to a kernel goes to the exact engine
    once it is sharded, and the explicit kernel modes refuse it."""
    from accbpg_and_fw_tpu_torch.algorithms import d_opt

    V = torch.zeros(30, 1000, dtype=torch.float64)
    limits, cuda = (132, 232448), torch.device("cuda")
    assert d_opt._resolve_auto_u_mode(V, "auto", cuda, limits) == "pallas"
    monkeypatch.setattr(d_opt, "is_dtensor", lambda a: True)
    assert d_opt._resolve_auto_u_mode(V, "auto", cuda, limits) == "exact"
    for mode in ("pallas", "pallas_lazy"):
        with pytest.raises(ValueError, match="sharded design"):
            d_opt._resolve_auto_u_mode(V, mode, cuda, limits)


def test_distributed_init_is_a_no_op_for_one_process():
    from accbpg_and_fw_tpu_torch.parallel import distributed_init

    for n in (None, 1):
        distributed_init("localhost:1", num_processes=n, process_id=0)
    assert not torch.distributed.is_initialized()


def test_vmap_solver_matches_jax():
    from accbpg_and_fw_tpu.algorithms import fastgram as jfg
    from accbpg_and_fw_tpu.parallel import vmap_solver as jvmap
    from accbpg_and_fw_tpu_torch.algorithms import fastgram as pfg
    from accbpg_and_fw_tpu_torch.parallel import vmap_solver

    rng = np.random.default_rng(11)
    K, m, n = 4, 6, 20
    Vs = rng.standard_normal((K, m, n))
    xs = rng.uniform(0.5, 1.5, (K, n))

    def solve_j(V, x):
        G = (V * x) @ V.T
        return jfg.schulz(jnp.eye(m) / jnp.trace(G) * m, G, 12)

    def solve_p(V, x):
        G = (V * x) @ V.T
        return pfg.schulz(torch.eye(m, dtype=G.dtype) / torch.trace(G) * m,
                          G, 12)

    got = vmap_solver(solve_p, torch.tensor(Vs), torch.tensor(xs))
    ref = jvmap(solve_j, jnp.asarray(Vs), jnp.asarray(xs))
    assert got.shape == (K, m, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-12)
    # the vmapped wrapper is cached per solver
    from accbpg_and_fw_tpu_torch.parallel import batched

    hits = batched._vmapped.cache_info().hits
    vmap_solver(solve_p, torch.tensor(Vs), torch.tensor(xs))
    assert batched._vmapped.cache_info().hits == hits + 1
