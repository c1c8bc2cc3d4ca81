"""The five Bregman drivers' plain steps as device-scalar steps
(``algorithms/bpg.py``), their bounded loops (``_loops.device_while``),
``theta.solve_theta`` and ``roots.simplex_inv_multiplier`` on 0-d tensors,
held against the JAX package on the CPU.

On the CPU a chunk runs eagerly and every loop is the Python form that
reads its condition; that is the plain version of the graph chunk the card
replays.  Bars:

* the five drivers on ``D_opt_design(30, 200, randseed=10)``, 60
  iterations, with both ``use_pallas`` values, against the JAX drivers on
  the same inputs: the final iterate, F and the line-search histories
  (Ls, Gamma, Gain, Gavg) rtol 1e-12 (a history's rows also within 1e-12
  of its largest magnitude: F crosses 0 on this design, where the sums'
  order leaves ~1e-15 absolute).  The triangle-scaling gains G and Gdiv
  are ratios of two Burg divergences that cancel as the iterates
  converge, whatever the order of their sums (``tests/test_torch_bpg.py``):
  rtol 1e-10 (measured up to 1.1e-11 over these 60 rows).  With
  ``checkdiv=True`` no descent test holds the iteration and rounding is
  amplified (``tests/test_torch_abpg.py``): the iterate and F rtol 1e-11
  (measured 4.6e-12), Gdiv 1e-8 (measured 8.2e-10).  The JAX route of
  ``use_pallas=True`` is the TPU kernel's body ``_simplex_kernel`` in
  float64 through an interpret-mode ``pallas_call`` (the JAX entry casts
  to float32), as ``tests/test_torch_simplex.py`` runs it;
* the masked form of the loops (forced on the CPU through the graph
  chunk's code, with one or two bodies per loop so that iterations
  overflow): bit for bit with the Python form, every overflow counted as
  a continuation;
* ``solve_theta`` against JAX's at rtol 1e-15,
  ``simplex_inv_multiplier`` at rtol 1e-14;
* checkpoints written mid-run by either package resume in the other, the
  resumed rows bit for bit with the writer's and the rest at 1e-12 from
  JAX's uninterrupted run.

The test marked ``cuda`` holds the graph chunk against the eager loop on
the card (``python -m pytest --noconftest -m cuda
tests/test_torch_bregman_device.py``); the JAX side of this file is
imported only inside fixtures and tests, so it runs without JAX.
"""

import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu_torch import _loops
from accbpg_and_fw_tpu_torch.algorithms import bpg, driver, theta
from accbpg_and_fw_tpu_torch.ops import roots

from test_torch_lazy import keep_jax_exec_cache  # noqa: F401 (autouse)

torch.set_num_threads(1)

M, N, ITERS, RTOL = 30, 200, 60, 1e-12
RATIO_RTOL, CHECKDIV_RTOL, CHECKDIV_RATIO_RTOL = 1e-10, 1e-11, 1e-8

# the histories each driver returns, between the iterate and T
RETURNS = {"BPG": ("F", "Ls"), "ABPG": ("F", "G"),
           "ABPG_expo": ("F", "Gamma", "G"),
           "ABPG_gain": ("F", "Gain", "Gdiv", "Gavg"), "ABDA": ("F", "G")}

CASES = {
    "BPG": ("BPG", (), {}),
    "ABPG": ("ABPG", (2.0,), {}),
    "ABPG_restart_f": ("ABPG", (2.0,), dict(theta_eq=True, restart=True,
                                            restart_rule="f")),
    "ABPG_restart_g": ("ABPG", (2.0,), dict(restart=True, restart_rule="g")),
    "ABPG_expo": ("ABPG_expo", (3.0,), {}),
    "ABPG_gain": ("ABPG_gain", (2.0,), {}),
    "ABPG_gain_restart_f": ("ABPG_gain", (2.0,), dict(restart=True,
                                                      restart_rule="f")),
    "ABPG_gain_restart_g": ("ABPG_gain", (2.0,), dict(restart=True,
                                                      restart_rule="g")),
    "ABPG_gain_checkdiv": ("ABPG_gain", (2.0,), dict(checkdiv=True)),
    "ABDA": ("ABDA", (2.0,), {}),
}


def _jax_kernel_h(acc):
    """A JAX h-oracle whose prox runs ``_simplex_kernel`` in float64."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from accbpg_and_fw_tpu.ops.pallas_kernels import _LANE, _simplex_kernel
    from accbpg_and_fw_tpu.struct import pytree_dataclass

    def multiplier(gg):
        pad = (-gg.shape[0]) % _LANE
        g = jnp.concatenate([gg, jnp.full(pad, jnp.inf, gg.dtype)])
        out = pl.pallas_call(
            _simplex_kernel,
            out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float64),
            interpret=True)(g.reshape(1, -1))
        return out[0, 0]

    @pytree_dataclass
    class KernelSimplexF64(acc.BurgEntropySimplex):
        def prox_map(self, g, L):
            gg = g / L
            return 1.0 / (gg + multiplier(gg))

    return KernelSimplexF64()


@pytest.fixture(scope="module")
def problems():
    import accbpg_and_fw_tpu as acc

    fj, hj, L, x0j = acc.D_opt_design(M, N, randseed=10)
    fp, hp, _, x0p = port.D_opt_design(M, N, randseed=10, device="cpu")
    hk = port.BurgEntropySimplex(use_pallas=True)
    return dict(jax=(acc, fj, {False: hj, True: _jax_kernel_h(acc)}, L,
                     x0j),
                port=(port, fp, {False: hp, True: hk}, L, x0p))


def _run(pkg, problems, case, use_pallas, iters=ITERS, **more):
    name, args, kw = CASES[case]
    mod, f, hs, L, x0 = problems[pkg]
    return getattr(mod, name)(f, hs[use_pallas], L, x0, *args, iters,
                              verbose=False, **kw, **more)


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["default_h", "kernel_route"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_steps_match_jax(problems, case, use_pallas):
    rj = _run("jax", problems, case, use_pallas)
    rp = _run("port", problems, case, use_pallas)
    assert len(rp) == len(rj)
    assert isinstance(rp[0], torch.Tensor) and rp[0].dtype == torch.float64
    assert_returns(case, rp, rj, ITERS)


def assert_returns(case, got, ref, rows):
    """The iterate and each history at its bar (module docstring)."""
    checkdiv = CASES[case][2].get("checkdiv", False)
    rtol = CHECKDIV_RTOL if checkdiv else RTOL
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                               rtol=rtol)
    for name, a, b in zip(RETURNS[CASES[case][0]], got[1:-1], ref[1:-1]):
        assert len(a) == len(b) == rows
        if name in ("G", "Gdiv"):
            bar = CHECKDIV_RATIO_RTOL if checkdiv else RATIO_RTOL
        else:
            bar = rtol if name == "F" else RTOL
        assert_rows(a, b, bar)


def assert_rows(got, ref, rtol):
    """``rtol``, also relative to the history's largest magnitude where a
    value sits near 0 (F crosses 0 on this design)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.max(np.abs(ref)))


def _force_graph(monkeypatch, bodies):
    """Run CPU carries through the graph chunk's code (``_masked_steps``,
    no capture) with ``bodies`` masked bodies per loop."""
    monkeypatch.setattr(driver, "chunk_mode",
                        lambda carry, problem=None, cfg=None: "graph")
    for mod, name in ((bpg, "BPG_BODIES"), (bpg, "EXPO_BODIES"),
                      (bpg, "GAIN_BODIES"), (theta, "NEWTON_BODIES"),
                      (roots, "NEWTON_BODIES")):
        monkeypatch.setattr(mod, name, bodies)
    monkeypatch.setattr(driver, "_GRAPHS", type(driver._GRAPHS)())


@pytest.mark.parametrize("case,bodies", [
    ("BPG", 1), ("BPG", 2), ("ABPG_restart_f", 1), ("ABPG_expo", 1),
    ("ABPG_gain", 1), ("ABPG_gain", 2), ("ABPG_gain_checkdiv", 1),
    ("ABDA", 1)])
def test_masked_loops_bit_equal_with_continuations(problems, monkeypatch,
                                                   case, bodies):
    """Chunks of 20 over spans of 8 (the third span runs past the chunk,
    masked) with one or two bodies per loop: the theta and multiplier
    Newtons need more, so iterations overflow, run again in the Python
    form and are counted; every bit matches the eager run."""
    ref = _run("port", problems, case, False, 40, chunk=20)
    _force_graph(monkeypatch, bodies)
    monkeypatch.setattr(bpg, "GRAPH_SPAN", 8)
    before = dict(driver.GRAPH_STATS)
    got = _run("port", problems, case, False, 40, chunk=20)
    cont = driver.GRAPH_STATS["continuations"] - before["continuations"]
    assert 0 < cont <= 40
    # two chunks of three spans, and a replay from each continuation on
    assert driver.GRAPH_STATS["replays"] - before["replays"] >= 6
    assert torch.equal(got[0], ref[0])
    for a, b in zip(got[1:-1], ref[1:-1]):
        np.testing.assert_array_equal(a, b)


def test_masked_loops_without_overflow(problems, monkeypatch):
    """With enough bodies no iteration overflows: one replay per span (six
    of 8 iterations over two chunks of 20) and the eager run's bits, the
    kernel route's plain version included."""
    ref = _run("port", problems, "ABPG_gain", True, 40, chunk=20)
    _force_graph(monkeypatch, 8)
    monkeypatch.setattr(bpg, "GRAPH_SPAN", 8)
    before = dict(driver.GRAPH_STATS)
    got = _run("port", problems, "ABPG_gain", True, 40, chunk=20)
    assert driver.GRAPH_STATS["continuations"] == before["continuations"]
    assert driver.GRAPH_STATS["replays"] - before["replays"] == 6
    assert torch.equal(got[0], ref[0])
    for a, b in zip(got[1:-1], ref[1:-1]):
        np.testing.assert_array_equal(a, b)


def test_device_while_forms():
    """The masked form takes the Python form's bodies; a loop nested in a
    masked body that is not live never overflows; a bound that the bodies
    reach needs no overflow flag."""
    def cond(s):
        return s[0] < s[1]

    def body(s):
        return s[0] * 2.0 + 1.0, s[1]

    start = (torch.tensor(0.0, dtype=torch.float64),
             torch.tensor(20.0, dtype=torch.float64))
    py = _loops.device_while(cond, body, start, None, 3)
    assert float(py[0]) == 31.0
    for bodies, over in ((3, True), (5, False), (8, False)):
        flags = []
        _loops.OVERFLOW[0] = flags
        try:
            got = _loops.device_while(cond, body, start, None, bodies)
        finally:
            _loops.OVERFLOW[0] = None
        assert len(flags) == 1 and bool(flags[0]) is over
        if not over:
            assert torch.equal(got[0], py[0])
    flags = []
    _loops.OVERFLOW[0] = flags
    try:
        # bound 2 <= bodies: the loop stops at its bound, no flag
        got = _loops.device_while(cond, body, start, 2, 4)
        assert float(got[0]) == 3.0 and not flags
        # an outer body that is not live: the inner loop's flag is false
        _loops.ENCLOSING[0] = torch.tensor(False)
        _loops.device_while(cond, body, start, None, 1)
        assert len(flags) == 1 and not bool(flags[0])
    finally:
        _loops.OVERFLOW[0] = None
        _loops.ENCLOSING[0] = None


THETA_GRID = [(th, gam, r) for th in (1.0, 0.61, 0.2, 0.013)
              for gam in (2.0, 1.5, 3.0) for r in (1.0, 1.3, 0.45)]


def test_solve_theta_matches_jax():
    from accbpg_and_fw_tpu.algorithms.theta import solve_theta as jax_theta
    import jax.numpy as jnp

    for th, gam, r in THETA_GRID:
        ref = float(jax_theta(jnp.asarray(th), gam, r))
        got = theta.solve_theta(torch.tensor(th, dtype=torch.float64),
                                torch.tensor(gam, dtype=torch.float64),
                                torch.tensor(r, dtype=torch.float64))
        assert got.dim() == 0 and got.dtype == torch.float64
        np.testing.assert_allclose(float(got), ref, rtol=1e-15)


@pytest.mark.parametrize("warm", ["none", "below", "above", "nan", "inf",
                                  "out_of_domain", "past_bound"])
def test_simplex_multiplier_matches_jax(warm):
    import jax.numpy as jnp

    from accbpg_and_fw_tpu.ops import roots as jax_roots

    rng = np.random.default_rng(21)
    gg = rng.standard_normal(400) * 2.0 + 1.0
    gg[::11] = np.inf
    fin = gg[np.isfinite(gg)]
    c_star = float(jax_roots.simplex_inv_multiplier(jnp.asarray(gg), 1e-12))
    cw = {"none": None, "below": c_star - 2.0, "above": c_star + 30.0,
          "nan": np.nan, "inf": np.inf, "out_of_domain": -fin.min() - 1.0,
          "past_bound": -fin.min() + 10.0 * fin.size}[warm]
    ref = float(jax_roots.simplex_inv_multiplier(
        jnp.asarray(gg), 1e-8, c_warm=None if cw is None else jnp.asarray(cw)))
    for c_warm in ((cw,) if cw is None else
                   (cw, torch.tensor(cw, dtype=torch.float64))):
        got = roots.simplex_inv_multiplier(torch.tensor(gg), 1e-8,
                                           c_warm=c_warm)
        assert got.dim() == 0 and got.dtype == torch.float64
        np.testing.assert_allclose(float(got), ref, rtol=1e-14)
    # the masked form, with room for every pass: the same bits, no flag
    flags = []
    _loops.OVERFLOW[0] = flags
    try:
        masked = roots.simplex_inv_multiplier(torch.tensor(gg), 1e-8,
                                              c_warm=cw)
    finally:
        _loops.OVERFLOW[0] = None
    assert torch.equal(masked, got) and not bool(flags[0])


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("case", ["ABPG_expo", "ABDA"])
def test_checkpoint_resumes_across_packages(problems, tmp_path, case,
                                            writer):
    """30 iterations saved by one package, resumed to 60 by the other."""
    ck = str(tmp_path / "ck.npz")
    first, second = ("jax", "port") if writer == "jax" else ("port", "jax")
    r1 = _run(first, problems, case, False, 30, chunk=10, checkpoint=ck)
    with np.load(ck) as z:
        assert int(z["__k_next"]) == 30
    r2 = _run(second, problems, case, False, 60, chunk=10, checkpoint=ck)
    ref = _run("jax", problems, case, False, 60, chunk=10)
    for got, first_rows in zip(r2[1:-1], r1[1:-1]):
        np.testing.assert_array_equal(np.asarray(got)[:30],
                                      np.asarray(first_rows))
    assert_returns(case, r2, ref, 60)


def test_chunk_mode_of_a_problem_that_reads_the_host(monkeypatch):
    """A carry of plain tensors on one card is a graph, unless an oracle
    of the problem declares ``host_reads`` (a user's LMO behind the FW
    adapter here): then its chunks run eagerly.  The dual prox's loop and
    the nuclear ball's top singular pair are each one kernel launch on the
    card and read nothing back, so their chunks are graphs; a solve on the
    CPU with the dual prox runs."""
    dual = port.SumOf2nd4thPowersDualProxMap(num_iters=40)
    svd_h = port.SumOf2nd4thPowersWithFrankWolfe(
        lmo=port.lmo_nuclear_norm_ball())

    def user_lmo(g):
        return -g / float(torch.linalg.vector_norm(g))  # a host read

    user_lmo.host_reads = True
    user_h = port.SumOf2nd4thPowersWithFrankWolfe(lmo=user_lmo)
    assert not getattr(dual, "host_reads", False)
    assert not getattr(port.BurgEntropySimplex(), "host_reads", False)
    assert driver.host_reads(dict(h=user_h)) and not driver.host_reads(None)
    assert not driver.host_reads(dict(h=dual))
    assert not driver.host_reads(dict(h=svd_h))
    t = torch.zeros(3)
    carry = dict(done=torch.tensor(False), x=t, L=t.sum())
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    assert driver.chunk_mode(carry) == "graph"
    assert driver.chunk_mode(carry, dict(h=port.BurgEntropySimplex())) == \
        "graph"
    assert driver.chunk_mode(carry, dict(f=None, h=dual)) == "graph"
    assert driver.chunk_mode(carry, dict(f=None, h=svd_h)) == "graph"
    assert driver.chunk_mode(carry, dict(f=None, h=user_h)) == "eager"
    monkeypatch.undo()
    A = np.random.default_rng(5).standard_normal((12, 4))
    f = port.FrobeniusSymLoss(A @ A.T, device="cpu")
    x0 = torch.full((12, 2), 0.3, dtype=torch.float64)
    x, F, _, _ = port.BPG(f, dual, 1.0, x0, 3, linesearch=False,
                          verbose=False)
    assert len(F) == 3 and np.all(np.isfinite(F))


# ---- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_gain_graph_matches_eager_on_card():
    """ABPG_gain through kernel 5 on the card: the graph's rows against the
    eager loop's (bit for bit, or 1e-13 where cuBLAS took another
    algorithm under capture), one capture, kernel 5 counted on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from accbpg_and_fw_tpu_torch.ops import simplex as sm

    f, _, L, x0 = port.D_opt_design(M, N, randseed=10, device="cuda")
    h = port.BurgEntropySimplex(use_pallas=True)
    driver.clear_graph_cache()
    before = dict(driver.GRAPH_STATS)
    g = port.ABPG_gain(f, h, L, x0, 2.0, 300, verbose=False)
    assert driver.GRAPH_STATS["captures"] == before["captures"] + 1
    sm.reset_device_launches()
    port.ABPG_gain(f, h, L, x0, 2.0, 300, verbose=False)
    assert sm.device_launches() >= 300
    with driver.eager_chunks():
        e = port.ABPG_gain(f, h, L, x0, 2.0, 300, verbose=False)
    for a, b in zip(g[1:-1], e[1:-1]):
        np.testing.assert_allclose(a, b, rtol=1e-13)
