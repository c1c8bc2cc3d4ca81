"""The port's chunked driver (``algorithms/driver.py``): JAX's cached step
form ``run_driver(step, ..., problem=, cfg=)``, the budget-masked chunk a
CUDA graph captures, the eager-or-graph choice and the graph cache.

On the CPU every chunk runs eagerly; the body a graph captures
(``_masked_steps``: ``k`` an int64 tensor, a device ``limit``) is run here
as it is, without a capture.  Bars:

* the cached form against the closure form: bit for bit; against JAX's
  ``run_driver`` on its own ``_dopt_step``: F rtol 1e-12, SP and SN atol
  1e-12 (the two differ in the order of BLAS sums), and the checkpoint
  fingerprints equal to JAX's;
* the masked partial chunk against the unmasked eager steps: bit for bit;
* the tensor-``k`` descent step against JAX ``FW_alg_descent_step``: F
  rtol 1e-12, and against the port's eager run bit for bit.

The tests marked ``cuda`` run the graph on the card: the exact engine and
``FW_alg_descent_step`` against the eager loop bit for bit, a second solve
of the same shapes without a new capture, and a capture that fails
raising.
"""

import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu_torch.algorithms import d_opt, driver, fw
from accbpg_and_fw_tpu_torch.ops.dopt_common import factorize

from test_torch_lazy import keep_jax_exec_cache  # noqa: F401 (autouse)

torch.set_num_threads(1)

JAX_RTOL, EXACT_ATOL = 1e-12, 1e-12


@pytest.fixture(scope="module")
def dopt_problem():
    V = np.random.default_rng(4).standard_normal((6, 30))
    return V, np.full(30, 1.0 / 30)


def _dopt_carry(V, x0, device="cpu"):
    Vt = torch.as_tensor(V, device=device)
    x = torch.as_tensor(x0, device=device)
    H, w, ld = factorize(Vt, x)
    return Vt, dict(done=torch.tensor(False, device=device), x=x, w=w, H=H,
                    logdet=ld)


def test_cached_form_matches_closure_and_jax(dopt_problem, tmp_path):
    import jax.numpy as jnp

    from accbpg_and_fw_tpu.algorithms import d_opt as jd_opt
    from accbpg_and_fw_tpu.algorithms import driver as jdriver

    V, x0 = dopt_problem
    Vt, carry = _dopt_carry(V, x0)
    cfg = d_opt._DOptCfg(away=True)
    prob = dict(V=Vt, eps=1e-10)
    ck_port = str(tmp_path / "port.npz")
    c1, h1, _ = driver.run_driver(d_opt._dopt_step, carry, 300,
                                  verbose=False, problem=prob, cfg=cfg,
                                  chunk=64, checkpoint=ck_port)
    c2, h2, _ = driver.run_driver(
        lambda c, k: d_opt._dopt_step(cfg, prob, c, k), carry, 300,
        verbose=False, chunk=64)
    for name in ("F", "SP", "SN"):
        np.testing.assert_array_equal(h1[name], h2[name])
    assert torch.equal(c1["x"], c2["x"])

    ck_jax = str(tmp_path / "jax.npz")
    jcarry = {k: jnp.asarray(v.numpy()) for k, v in carry.items()}
    _, hj, _ = jdriver.run_driver(
        jd_opt._dopt_step, jcarry, 300, verbose=False,
        problem=dict(V=jnp.asarray(V), eps=jnp.asarray(1e-10)),
        cfg=jd_opt._DOptCfg(away=True, mixed=False), chunk=64,
        checkpoint=ck_jax)
    assert len(h1["F"]) == len(hj["F"]) < 300
    np.testing.assert_allclose(h1["F"], np.asarray(hj["F"]), rtol=JAX_RTOL)
    for name in ("SP", "SN"):  # slacks that reach ~1e-11: absolute
        np.testing.assert_allclose(h1[name], np.asarray(hj[name]), rtol=0,
                                   atol=EXACT_ATOL)
    with np.load(ck_port) as zp, np.load(ck_jax) as zj:
        assert str(zp["__fp"]) == str(zj["__fp"])


def test_fingerprints_are_jax(dopt_problem):
    """``_fingerprint(step, cfg)`` of a port step is JAX's for its
    counterpart: the JAX module name, the config's repr, or its type name
    where the repr holds an address (an LMO closure)."""
    import accbpg_and_fw_tpu as acc
    from accbpg_and_fw_tpu.algorithms import bpg as jbpg
    from accbpg_and_fw_tpu.algorithms import d_opt as jd_opt
    from accbpg_and_fw_tpu.algorithms import driver as jdriver
    from accbpg_and_fw_tpu.algorithms import fw as jfw

    from accbpg_and_fw_tpu_torch.algorithms import bpg

    pairs = [
        ((d_opt._dopt_step, d_opt._DOptCfg(away=False)),
         (jd_opt._dopt_step, jd_opt._DOptCfg(away=False, mixed=False))),
        ((fw._fw_descent_step,
          fw._FWDescentCfg(lmo=port.lmo_simplex(), stochastic=False)),
         (jfw._fw_descent_step,
          jfw._FWDescentCfg(lmo=acc.lmo_simplex(), stochastic=False))),
        ((bpg._bpg_step, bpg._BPGCfg(linesearch=True)),
         (jbpg._bpg_step, jbpg._BPGCfg(linesearch=True))),
    ]
    for (ps, pc), (js, jc) in pairs:
        assert driver._fingerprint(ps, pc) == jdriver._fingerprint(js, jc)


def test_masked_partial_chunk_matches_unmasked(dopt_problem):
    """A chunk of 64 from k0 = 5 with its limit at 40 (the partial last
    chunk): the rows before the limit and the carry are the unmasked
    steps' bit for bit; the rows past it are invalid and freeze the carry;
    a real stop persists into the carry, a budget freeze does not."""
    V, x0 = dopt_problem
    Vt, carry = _dopt_carry(V, x0)
    cfg, prob = d_opt._DOptCfg(away=True), dict(V=Vt, eps=1e-10)

    def step(c, k):
        return d_opt._dopt_step(cfg, prob, c, k)

    k0, limit = torch.tensor(5), torch.tensor(40)
    got, packed, names, _ = driver._masked_steps(step, carry, k0, limit, 64)
    ref, rows = driver._frozen_steps(step, carry, 5, 40)
    for key in carry:
        assert torch.equal(got[key], ref[key])
    h = dict(zip(names, packed))
    assert h["_valid"][:35].all() and not h["_valid"][35:].any()
    for name in ("F", "SP", "SN"):
        want = torch.stack([r[name] for r in rows])
        assert torch.equal(h[name][:35], want)
    assert not bool(got["done"])
    # a stop inside the chunk: the carry keeps it
    got, packed, names, _ = driver._masked_steps(step, carry, k0,
                                                 torch.tensor(1000), 400)
    h = dict(zip(names, packed))
    nv = int(h["_valid"].sum())
    assert 0 < nv < 400 and bool(h["_stop"][nv - 1]) and bool(got["done"])
    assert bool(h["_done"][-1])


def _symnmf_matrix():
    """A 24x24 similarity matrix of four clusters (seed 0)."""
    rng = np.random.default_rng(0)
    pts = np.concatenate([c + 0.3 * rng.standard_normal((6, 8))
                          for c in rng.standard_normal((4, 8)) * 2.0])
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    return np.exp(-d2 / d2.mean())


@pytest.fixture(scope="module")
def symnmf():
    import jax.numpy as jnp

    import accbpg_and_fw_tpu as acc
    from accbpg_and_fw_tpu_torch.interop import from_jax_oracle

    M = _symnmf_matrix()
    np.random.seed(0)
    fj, (hj, _), _, X0 = acc.FrobeniusSymLossResMeasEx(M, 3)
    return ((fj, hj, jnp.asarray(X0), acc.lmo_linf_ball(1.0, 1.0)),
            (from_jax_oracle(fj, device="cpu"),
             from_jax_oracle(hj, device="cpu"),
             torch.tensor(np.asarray(X0, np.float64)),
             port.lmo_linf_ball(1.0, 1.0)))


def test_tensor_k_descent_step_matches_jax(symnmf):
    """The descent step with ``k`` an int64 tensor (as a graph passes it)
    through the masked chunk body: F against JAX ``FW_alg_descent_step``
    at rtol 1e-12, and the port's eager run (a host ``k``) bit for bit."""
    import accbpg_and_fw_tpu as acc

    (fj, hj, Xj, lmoj), (f, h, X0, lmo) = symnmf
    iters = 120
    Fj = np.asarray(acc.FW_alg_descent_step(fj, hj, Xj, iters, lmoj,
                                            verbose=False)[1])
    xe, Fe, *_ = port.FW_alg_descent_step(f, h, X0, iters, lmo,
                                          verbose=False)
    fx, g = f.value_and_grad(X0)
    carry = dict(done=torch.tensor(False), x=X0, g=g,
                 F_prev=fx + h.extra_psi(X0))
    cfg = fw._FWDescentCfg(lmo=lmo)
    prob = driver._as_device_numbers(dict(f=f, h=h, eps=1e-14), "cpu")
    assert prob["eps"].dtype == torch.float64 and prob["eps"].dim() == 0
    got, packed, names, _ = driver._masked_steps(
        lambda c, k: fw._fw_descent_step(cfg, prob, c, k), carry,
        torch.tensor(1), torch.tensor(iters), iters - 1)
    hist = dict(zip(names, packed))
    F = np.concatenate([[float(carry["F_prev"])], hist["F"].numpy()])
    assert len(F) == len(Fj) == len(Fe) == iters
    np.testing.assert_allclose(F, Fj, rtol=JAX_RTOL, atol=0)
    np.testing.assert_array_equal(F, Fe)
    assert torch.equal(got["x"], xe)
    ks = np.arange(1, iters)
    np.testing.assert_array_equal(hist["alpha"].numpy(), 2.0 / (ks + 2.0))


def test_chunk_mode_choice(monkeypatch):
    """The choice, from the carry alone: a carry of plain tensors on one
    card is a graph, and so is one with a DTensor of one mesh there; a
    host leaf (a Python-bool ``done``, the noise key as words), DTensors
    of two meshes or the CPU goes eager, and so does everything inside
    ``eager_chunks``.  There is no third mode."""
    t = torch.zeros(3)
    done = torch.tensor(False)
    assert driver.chunk_mode(dict(done=False, x=t)) == "eager"
    assert driver.chunk_mode(dict(done=done, x=t)) == "eager"  # the CPU
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    assert driver.chunk_mode(dict(done=done, x=t)) == "graph"
    assert driver.chunk_mode(dict(done=False, x=t)) == "eager"
    assert driver.chunk_mode(dict(done=done, x=t,
                                  key=np.zeros(2, np.uint32))) == "eager"
    assert driver.chunk_mode(dict(done=done, x=t, L=1.0)) == "eager"
    t.device_mesh = "mesh a"  # a DTensor's, whose device is its shard's
    monkeypatch.setattr(driver, "is_dtensor", lambda a: a is t)
    assert driver.chunk_mode(dict(done=done, x=t)) == "graph"
    u = torch.zeros(3)
    u.device_mesh = "mesh b"
    monkeypatch.setattr(driver, "is_dtensor", lambda a: a is t or a is u)
    assert driver.chunk_mode(dict(done=done, x=t, y=u)) == "eager"
    monkeypatch.setattr(driver, "is_dtensor", lambda a: False)
    with driver.eager_chunks():
        assert driver.chunk_mode(dict(done=done, x=t)) == "eager"
    assert driver.chunk_mode(dict(done=done, x=t)) == "graph"


def test_graph_key_by_shapes(symnmf):
    """JAX's cache key: step, cfg, chunk and the shapes, dtypes and devices
    of problem (an oracle's tensors included) and carry.  Another oracle
    object of the same shapes gives the same key; other shapes, another
    chunk or another LMO closure a new one."""
    f, h, X0, lmo = symnmf[1]
    cfg = fw._FWDescentCfg(lmo=lmo)
    carry = dict(done=torch.tensor(False), x=X0, g=X0, F_prev=X0.sum())

    def key(prob, c=carry, chunk=256, cfg_=cfg):
        return driver.graph_key(fw._fw_descent_step, cfg_, chunk, prob, c)[0]

    prob = dict(f=f, h=h, eps=torch.tensor(1e-14))
    twin = port.FrobeniusSymLoss(f.M.clone(), device="cpu")
    f2 = port.FrobeniusSymLoss(f.M.clone(), device="cpu")
    assert key(dict(prob, f=twin)) == key(dict(prob, f=f2))
    big = port.FrobeniusSymLoss(torch.zeros(30, 30, dtype=torch.float64),
                                device="cpu")
    assert key(dict(prob, f=big)) != key(dict(prob, f=f2))
    assert key(prob) != key(prob, chunk=128)
    assert key(prob) != key(prob, cfg_=fw._FWDescentCfg(
        lmo=port.lmo_linf_ball(1.0, 1.0)))
    wide = dict(carry, x=torch.zeros(X0.shape[0], 5, dtype=torch.float64))
    assert key(prob) != key(prob, c=wide)
    # the problem's tensors come back in the key's order, an oracle's too
    _, leaves, keep = driver.graph_key(fw._fw_descent_step, cfg, 256, prob,
                                       carry)
    assert any(t is f.M for t in leaves) and any(t is prob["eps"]
                                                 for t in leaves)
    rebuilt = driver._rebuild(prob, iter([t.clone() for t in leaves]))
    assert type(rebuilt["f"]) is type(f) and rebuilt["f"] is not f
    assert torch.equal(rebuilt["f"].M, f.M) and rebuilt["f"].M is not f.M
    assert lmo not in keep  # the cfg holds the LMO, not the problem


def test_graph_cache_reuses_same_shapes(monkeypatch, dopt_problem):
    """``_graph_chunk``: a second call with the same shapes replays the
    cached capture (its problem buffers reloaded); other shapes capture
    anew; the closure form captures per call and caches nothing."""
    made, loaded = [], []

    class Fake:
        def __init__(self, *args):
            made.append(args)

        def load_problem(self, leaves):
            loaded.append(leaves)

    monkeypatch.setattr(driver, "_GraphChunk", Fake)
    monkeypatch.setattr(driver, "_GRAPHS", type(driver._GRAPHS)())
    V, x0 = dopt_problem
    Vt, carry = _dopt_carry(V, x0)
    cfg = d_opt._DOptCfg(away=True)

    def get(Vm, c, cached=True):
        return driver._graph_chunk(d_opt._dopt_step, cfg, 256,
                                   dict(V=Vm, eps=torch.tensor(1e-8)), c,
                                   cached)

    a = get(Vt, carry)
    b = get(Vt.clone(), carry)
    assert a is b and len(made) == 1 and len(loaded) == 1
    Vs, cs = _dopt_carry(V[:, :20], x0[:20] * 1.5)
    assert get(Vs, cs) is not a and len(made) == 2
    get(Vt, carry, cached=False)
    assert len(made) == 3 and len(driver._GRAPHS) == 2


def test_replay_stops_at_an_overflowed_span(monkeypatch):
    """A step whose bounded loop needs three bodies at k = 2 and k = 13 and
    has one in the graph: chunks of 24 over spans of 8.  The replay from 0
    stops after its first span (the overflow at 2), the one from 3 after
    its second (at 13), the one from 14 runs its two: five spans launched
    where launching the rest of each chunk took eight; two
    continuations, and the eager run's rows."""
    from accbpg_and_fw_tpu_torch import _loops

    def step(c, k):
        target = torch.where((torch.as_tensor(k) == 2)
                             | (torch.as_tensor(k) == 13), 3.0, 0.0)
        n = _loops.device_while(lambda s: s[0] < target,
                                lambda s: (s[0] + 1.0,),
                                (torch.zeros((), dtype=torch.float64),),
                                None, 1)[0]
        v = c["v"] + n
        return (dict(done=c["done"], v=v),
                dict(F=v, _stop=torch.zeros((), dtype=torch.bool)))

    carry = dict(done=torch.tensor(False),
                 v=torch.zeros((), dtype=torch.float64))
    _, ref, _ = driver.run_driver(step, carry, 24, chunk=24, verbose=False)
    monkeypatch.setattr(driver, "chunk_mode",
                        lambda carry, problem=None, cfg=None: "graph")
    before = dict(driver.GRAPH_STATS)
    got, hist, _ = driver.run_driver(step, carry, 24, chunk=24,
                                     verbose=False, graph_span=8)
    st = {k: driver.GRAPH_STATS[k] - before[k] for k in before}
    assert st["replays"] == 5 and st["continuations"] == 2
    np.testing.assert_array_equal(hist["F"], ref["F"])
    assert float(got["v"]) == 6.0 and len(hist["F"]) == 24


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_exact_engine_graph_matches_eager_on_card(dopt_problem, cuda_dev):
    V, x0 = dopt_problem
    Vc = torch.as_tensor(V, device=cuda_dev)
    driver.clear_graph_cache()
    before = dict(driver.GRAPH_STATS)
    run = dict(verbose=False, u_mode="exact", chunk=64)
    g1 = port.D_opt_FW_away(Vc, x0, 1e-10, 300, **run)
    g2 = port.D_opt_FW_away(Vc, x0, 1e-10, 300, **run)
    assert driver.GRAPH_STATS["captures"] == before["captures"] + 1
    assert driver.GRAPH_STATS["replays"] > before["replays"]
    with driver.eager_chunks():
        e = port.D_opt_FW_away(Vc, x0, 1e-10, 300, **run)
    for got in (g1, g2):
        assert torch.equal(got[0], e[0])
        for a, b in zip(got[1:4], e[1:4]):
            np.testing.assert_array_equal(a, b)
    c = port.D_opt_FW_away(V, x0, 1e-10, 300, device="cpu", **run)
    np.testing.assert_allclose(g1[1], c[1], rtol=1e-9)


@pytest.mark.cuda
def test_descent_graph_matches_eager_on_card(cuda_dev):
    """Both h-oracles of the SymNMF factory, built on the card: graph and
    eager bit for bit, the second solve a replay, and the CPU at 1e-9."""
    M, lmo = _symnmf_matrix(), port.lmo_linf_ball(1.0, 1.0)
    runs = {}
    for dev in (cuda_dev, "cpu"):
        np.random.seed(0)
        runs[str(dev)] = port.FrobeniusSymLossResMeasEx(M, 3, device=dev)
    f, hs, _, X0 = runs[str(cuda_dev)]
    for which in (0, 1):
        before = driver.GRAPH_STATS["captures"]
        g1 = port.FW_alg_descent_step(f, hs[which], X0, 200, lmo,
                                      verbose=False)
        g2 = port.FW_alg_descent_step(f, hs[which], X0, 200, lmo,
                                      verbose=False)
        assert driver.GRAPH_STATS["captures"] == before + 1
        with driver.eager_chunks():
            e = port.FW_alg_descent_step(f, hs[which], X0, 200, lmo,
                                         verbose=False)
        for got in (g1, g2):
            assert torch.equal(got[0], e[0])
            np.testing.assert_array_equal(got[1], e[1])
        fc, hc, _, Xc = runs["cpu"]
        c = port.FW_alg_descent_step(fc, hc[which], Xc, 200, lmo,
                                     verbose=False)
        np.testing.assert_allclose(g1[1], c[1], rtol=1e-9)


@pytest.mark.cuda
def test_failed_capture_raises(cuda_dev):
    """A step that reads a value back cannot be captured: the driver
    raises, and never runs the chunk eagerly instead."""
    def step(cfg, prob, c, k):
        v = c["v"] * (0.5 if float(c["v"]) > 0 else 2.0)  # a host read
        return dict(done=c["done"], v=v), dict(F=v, _stop=v < 0)

    carry = dict(done=torch.tensor(False, device=cuda_dev),
                 v=torch.tensor(1.0, device=cuda_dev))
    with pytest.raises(RuntimeError):
        driver.run_driver(step, carry, 20, verbose=False,
                          problem=dict(s=1.0), cfg=None)
