"""The four Frank-Wolfe line-search drivers as device-scalar steps
(``algorithms/fw.py``), their bounded loops (``_loops.device_while``), the
LMOs' array constants and the nuclear ball in a graph, held against
the JAX package on the CPU.

On the CPU a chunk runs eagerly and every line search is the Python form
that reads its exit test each trial; that is the plain version of the
graph chunk the card replays.  Bars:

* the drivers on the oracles of ``tests/test_torch_fw.py`` (built in JAX,
  handed over by ``interop.from_jax_oracle``) against the JAX drivers: F
  and the L / a_k history rtol 1e-11 with the same number of rows, the
  iterate atol 1e-12, LOG_STEPS equal.  The two log-step drivers with
  their line search are held over 60 rows, as there: on the ill-conditioned
  logistic problem the two packages' sums (XLA's and PyTorch's GEMVs and
  norms) part by their last bits, and JAX's scalar order does not move
  where that shows (the a_k history passes 1e-11 at row 63 and F at row 76,
  as with the earlier host scalars).  Without the line search they hold
  over all 200 rows;
* the masked form of the loops (forced on the CPU through the graph
  chunk's code, one or two bodies per loop so that iterations overflow):
  bit for bit with the Python form, every overflow counted as a
  continuation; with enough bodies none;
* an ascent LMO: the run stops on JAX's row, with ``bad`` set there, and
  raises JAX's ``ValueError`` after the run;
* the array centres and bounds of four LMOs are copied to a device once.

The tests marked ``cuda`` hold the graph chunks against the eager loop on
the card (``python -m pytest --noconftest -m cuda
tests/test_torch_fw_device.py``); the JAX side of this file is imported
only inside fixtures and tests, so it runs without JAX.
"""

import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu_torch.algorithms import driver, fw

from test_torch_lazy import keep_jax_exec_cache  # noqa: F401 (autouse)

torch.set_num_threads(1)

F_RTOL, X_ATOL = 1e-11, 1e-12
ITERS, LOG_ITERS = 200, 60
RADIUS = 25.0

# (driver, extra arguments, iterations): the JAX-parity cases
CASES = {
    "div": ("FW_alg_div_step", dict(ls_ratio=2.2), ITERS),
    "div_plain": ("FW_alg_div_step", dict(linesearch=False), ITERS),
    "shortest": ("FW_alg_L0_L1_shortest_step", {}, ITERS),
    "shortest_plain": ("FW_alg_L0_L1_shortest_step",
                       dict(linesearch=False), ITERS),
    "log": ("FW_l0l1_log_and_linear_step", dict(ls_ratio=2.2), LOG_ITERS),
    "log_plain": ("FW_l0l1_log_and_linear_step",
                  dict(ls_ratio=2.2, linesearch=False), ITERS),
    "log_only": ("FW_l0l1_log_only", dict(ls_ratio=2.2), LOG_ITERS),
    "log_only_plain": ("FW_l0l1_log_only",
                       dict(ls_ratio=2.2, linesearch=False), ITERS),
    "log_caps": ("FW_l0l1_log_only", dict(ls_ratio=2.2, L0_max=5e-3),
                 LOG_ITERS),
}


def _args(name, prob, x0, iters):
    """The positional arguments of driver ``name`` on ``prob``."""
    if name == "FW_alg_div_step":
        return (prob["L"], x0, iters, 2.0)
    if name == "FW_alg_L0_L1_shortest_step":
        return (prob["L0"], prob["L1"], x0, iters, 2.0)
    return (1e-3, prob["L1"], x0, iters)


def _run(pkg, prob, name, iters, lmo=None, **kw):
    f, h, x0 = prob[pkg]
    mod = prob["acc"] if pkg == "jax" else port
    lmo = lmo or prob["lmo"][pkg]
    return getattr(mod, name)(f, h, *_args(name, prob, x0, iters), lmo=lmo,
                              verbose=False, **kw)


@pytest.fixture(scope="module")
def logistic():
    """``tests/test_torch_fw.py``'s hard logistic regression (the illcond
    regime at 150x30, an l2 ball of radius 25) in both packages."""
    import jax

    import accbpg_and_fw_tpu as acc
    from accbpg_and_fw_tpu_torch.interop import from_jax_oracle

    fj, hj, L, L0, L1, x0, _, _ = acc.hard_FW_log_reg_jax(
        jax.random.PRNGKey(63), 150, 30, radius=RADIUS, domain="l2",
        rho=0.99, col_scale=1.0, flip_y=0.2, noise=0.1)
    return dict(acc=acc, jax=(fj, hj, jax.numpy.asarray(x0)),
                port=(from_jax_oracle(fj, device="cpu"),
                      from_jax_oracle(hj, device="cpu"),
                      torch.tensor(np.asarray(x0, np.float64))),
                lmo=dict(jax=acc.lmo_l2_ball(RADIUS),
                         port=port.lmo_l2_ball(RADIUS)),
                L=float(L), L0=max(float(L0), 1e-9), L1=float(L1))


def assert_rows(got, ref, rtol=F_RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert len(got) == len(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_line_search_drivers_match_jax(logistic, case):
    name, kw, iters = CASES[case]
    rj = _run("jax", logistic, name, iters, **kw)
    rp = _run("port", logistic, name, iters, **kw)
    assert len(rp) == len(rj)
    assert isinstance(rp[0], torch.Tensor) and rp[0].dtype == torch.float64
    np.testing.assert_allclose(rp[0].numpy(), np.asarray(rj[0]), rtol=0,
                               atol=X_ATOL)
    assert_rows(rp[1], rj[1])
    assert_rows(rp[2], rj[2])
    if "log" in case:
        np.testing.assert_array_equal(rp[3], np.asarray(rj[3]))
    if kw.get("linesearch", True):
        assert np.unique(np.asarray(rj[2])).size > 1  # the search moved


def _force_graph(monkeypatch, bodies, span=8):
    """Run CPU carries through the graph chunk's code (``_masked_steps``,
    no capture) with ``bodies`` masked bodies per line search."""
    monkeypatch.setattr(driver, "chunk_mode",
                        lambda carry, problem=None, cfg=None: "graph")
    for name in ("DIV_BODIES", "SHORTEST_BODIES", "LOG_BODIES",
                 "LOG_ONLY_BODIES"):
        monkeypatch.setattr(fw, name, bodies)
    monkeypatch.setattr(fw, "GRAPH_SPAN", span)
    monkeypatch.setattr(driver, "_GRAPHS", type(driver._GRAPHS)())


def record_continuations(monkeypatch):
    """The iteration of each continuation of a forced graph run, as
    ``_graph_run`` hands it to ``_device_chunk`` (which a forced run calls
    for nothing else)."""
    ks, run = [], driver._device_chunk

    def rec(step, carry, k0, limit):
        ks.append(k0)
        return run(step, carry, k0, limit)

    monkeypatch.setattr(driver, "_device_chunk", rec)
    return ks


def spans_replayed(conts, iters, chunk, span):
    """The spans a forced graph run of ``iters`` iterations replays, with
    continuations at ``conts``: in each chunk, from its start and from the
    iteration after each continuation, through the span that holds the
    chunk's next continuation, else to the chunk's end."""
    n = 0
    for c0 in range(0, iters, chunk):
        c1 = min(c0 + chunk, iters)
        starts = [c0] + [k + 1 for k in conts if c0 <= k < c1 - 1]
        stops = [k for k in conts if c0 <= k < c1] + [None]
        for s, k in zip(starts, stops):
            n += -(-(c1 - s) // span) if k is None else (k - s) // span + 1
    return n


def _same(got, ref):
    """The iterate and the histories bit for bit (``FW_alg_descent_step``
    returns ``(x, F, T, G)``, the others ``(x, ..., T)``: T is a time)."""
    assert torch.equal(got[0], ref[0])
    hists = (1, 3) if len(got) == 4 and not np.any(got[3]) else range(
        1, len(got) - 1)
    for i in hists:
        np.testing.assert_array_equal(got[i], ref[i])


LS_DRIVERS = ["div", "shortest", "log", "log_only"]


@pytest.mark.parametrize("bodies", [1, 2])
@pytest.mark.parametrize("case", LS_DRIVERS)
def test_masked_loops_bit_equal_with_continuations(logistic, monkeypatch,
                                                   case, bodies):
    """Chunks of 20 over spans of 8 (the third span runs past the chunk,
    masked) with one or two bodies per line search: iterations that need
    more overflow, run again in the Python form and are counted; every bit
    matches the eager run."""
    name, kw, _ = CASES[case]
    ref = _run("port", logistic, name, 60, chunk=20, **kw)
    _force_graph(monkeypatch, bodies)
    conts = record_continuations(monkeypatch)
    before = dict(driver.GRAPH_STATS)
    got = _run("port", logistic, name, 60, chunk=20, **kw)
    cont = driver.GRAPH_STATS["continuations"] - before["continuations"]
    assert 0 < cont <= 60 and len(conts) == cont
    # three chunks of three spans; a replay stops at the span that
    # overflowed, and another starts after each continuation
    assert driver.GRAPH_STATS["replays"] - before["replays"] == (
        spans_replayed(conts, 60, 20, 8))
    _same(got, ref)


@pytest.mark.parametrize("case", ["div", "log", "log_only"])
def test_masked_loops_without_overflow(logistic, monkeypatch, case):
    """With enough bodies (these runs take at most 4, 4 and 8) no
    iteration overflows: one replay per span, nine over three chunks of
    20, and the eager run's bits."""
    name, kw, _ = CASES[case]
    ref = _run("port", logistic, name, 60, chunk=20, **kw)
    _force_graph(monkeypatch, 8)
    before = dict(driver.GRAPH_STATS)
    got = _run("port", logistic, name, 60, chunk=20, **kw)
    assert driver.GRAPH_STATS["continuations"] == before["continuations"]
    assert driver.GRAPH_STATS["replays"] - before["replays"] == 9
    _same(got, ref)


@pytest.mark.parametrize("bodies", [1, 3])
def test_bound_keeps_the_last_trial(logistic, monkeypatch, bodies):
    """At a bound of 2 trials after the first (JAX's ``_LS_MAX``, cut) the
    search stops on the trial it reached, in both forms: the masked loop
    that overflows (1 body) and the one that reaches the bound (3 bodies,
    no continuation) take the eager run's bits."""
    monkeypatch.setattr(fw, "_LS_MAX", 2)
    name, kw, _ = CASES["shortest"]
    ref = _run("port", logistic, name, 40, chunk=20, **kw)
    _force_graph(monkeypatch, bodies)
    before = dict(driver.GRAPH_STATS)
    got = _run("port", logistic, name, 40, chunk=20, **kw)
    cont = driver.GRAPH_STATS["continuations"] - before["continuations"]
    assert (cont > 0) == (bodies < 2)
    _same(got, ref)


def _ascent_lmo(pkg):
    """An LMO that returns the ascent vertex: <g, s - x> > 0."""
    inner = pkg.lmo_l2_ball(RADIUS)
    return lambda g: inner(-g)


@pytest.mark.parametrize("case", LS_DRIVERS)
def test_ascent_lmo_raises_after_the_run_on_jax_row(logistic, monkeypatch,
                                                    case):
    """The ``bad`` flag stops the run on the row where JAX's stops (its
    history and the row of the flag equal JAX's), and the driver raises
    JAX's error after the run."""
    import accbpg_and_fw_tpu.algorithms.fw as jax_fw

    name, kw, _ = CASES[case]
    seen = {}
    for pkg, mod in (("jax", jax_fw), ("port", fw)):
        def record(hist, pkg=pkg, raise_if_bad=mod._raise_if_bad):
            seen[pkg] = {k: np.asarray(v) for k, v in hist.items()}
            raise_if_bad(hist)

        monkeypatch.setattr(mod, "_raise_if_bad", record)
        lmo = _ascent_lmo(logistic["acc"] if pkg == "jax" else port)
        with pytest.raises(ValueError, match="grad_d_prod must be "
                                             "non-positive"):
            _run(pkg, logistic, name, 50, lmo=lmo, **kw)
    j, p = seen["jax"], seen["port"]
    assert len(p["bad"]) == len(j["bad"]) < 50
    np.testing.assert_array_equal(p["bad"], j["bad"])
    assert p["bad"][-1]
    assert_rows(p["F"], j["F"])


def _kept(lmo):
    """The device copies an LMO closure keeps, by its constants."""
    out = []
    for cell in lmo.__closure__ or ():
        inner = getattr(cell.cell_contents, "__closure__", None) or ()
        out += [c.cell_contents for c in inner
                if isinstance(c.cell_contents, dict)]
    return out


ARRAY_LMOS = {
    "l2_ball": (lambda c: port.lmo_l2_ball(2.0, center=c), 1),
    "l2_ball_positive_orthant": (
        lambda c: port.lmo_l2_ball_positive_orthant(2.0, center=np.abs(c)),
        1),
    "linf_ball": (lambda c: port.lmo_linf_ball(1.0, center=c), 1),
    "matrix_box": (lambda c: port.lmo_matrix_box(c - 1.0, c + 1.0), 2),
}


@pytest.mark.parametrize("name", list(ARRAY_LMOS))
def test_array_constants_are_copied_once(monkeypatch, name):
    """A numpy centre (or bounds) is copied to a device at the closure's
    first call there and reused: the same tensor at the second call, and
    no copy from the host per call (a copy cannot be captured)."""
    make, n_consts = ARRAY_LMOS[name]
    rng = np.random.default_rng(4)
    c = rng.standard_normal((6, 3))
    lmo = make(c)
    copies = []
    as_tensor = torch.as_tensor

    def counted(*args, **kwargs):
        copies.append(args[0])
        return as_tensor(*args, **kwargs)

    monkeypatch.setattr(torch, "as_tensor", counted)
    g = torch.tensor(rng.standard_normal((6, 3)))
    first = lmo(g)
    assert len(copies) == n_consts
    kept = _kept(lmo)
    assert len(kept) == n_consts and all(len(k) == 1 for k in kept)
    tensors = [next(iter(k.values())) for k in kept]
    second = lmo(-g)
    assert len(copies) == n_consts  # nothing copied at the second call
    assert all(next(iter(k.values())) is t for k, t in zip(kept, tensors))
    assert torch.equal(lmo(g), first) and not torch.equal(second, first)


def test_nuclear_ball_chunk_is_a_graph(monkeypatch):
    """The nuclear ball's closure reads nothing back (its top singular pair
    is a kernel on the card, ``ops/svd.py``), so a carry that is a graph
    stays one with it, as does a Bregman prox that delegates to it, and so
    does the l2 ball's; an LMO of the user's that declares ``host_reads``
    sends the chunks to the eager loop, through the config or through the
    prox.  A CPU solve with the nuclear ball runs."""
    nuc = port.lmo_nuclear_norm_ball()
    assert not getattr(nuc, "host_reads", False)
    assert not getattr(port.lmo_l2_ball(1.0), "host_reads", False)

    def user_lmo(g):
        return -g / float(torch.linalg.vector_norm(g))  # a host read

    user_lmo.host_reads = True
    fw_h = port.SumOf2nd4thPowersWithFrankWolfe(lmo=nuc)
    user_h = port.SumOf2nd4thPowersWithFrankWolfe(lmo=user_lmo)
    assert not fw_h.host_reads and user_h.host_reads
    assert not port.SumOf2nd4thPowersWithFrankWolfe(
        lmo=port.lmo_l2_ball(1.0)).host_reads
    t = torch.zeros(3)
    carry = dict(done=torch.tensor(False), x=t, L=t.sum())
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    cfg_nuc = fw._FWDivCfg(lmo=nuc, linesearch=True)
    cfg_user = fw._FWDivCfg(lmo=user_lmo, linesearch=True)
    cfg_l2 = fw._FWDivCfg(lmo=port.lmo_l2_ball(1.0), linesearch=True)
    assert driver.chunk_mode(carry, dict(h=None), cfg_nuc) == "graph"
    assert driver.chunk_mode(carry, dict(h=None), cfg_l2) == "graph"
    assert driver.chunk_mode(carry, dict(h=None), cfg_user) == "eager"
    assert driver.chunk_mode(carry, dict(h=fw_h)) == "graph"
    assert driver.chunk_mode(carry, dict(h=user_h)) == "eager"
    monkeypatch.undo()
    A = np.random.default_rng(5).standard_normal((12, 4))
    f = port.FrobeniusSymLoss(A @ A.T, device="cpu")
    X0 = torch.full((12, 2), 0.02, dtype=torch.float64)
    before = dict(driver.GRAPH_STATS)
    # the reference's vertex is the top singular pair's (an ascent vertex
    # for the line-search drivers' test, which raise on it as JAX's do)
    for run in (lambda: port.FW_alg_descent_step(
                    f, port.SquaredL2Norm(), X0, 20, nuc, verbose=False),
                lambda: port.BPG(f, fw_h, 1.0, X0, 20, linesearch=False,
                                 verbose=False)):
        F = run()[1]
        assert len(F) >= 2 and np.all(np.isfinite(F))
    assert driver.GRAPH_STATS == before


# ---- on the card ------------------------------------------------------------


@pytest.fixture(scope="module")
def card_logistic():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    f, h, L, L0, L1, x0, _, _ = port.hard_FW_log_reg_jax(
        63, 150, 30, radius=RADIUS, domain="l2", rho=0.99, col_scale=1.0,
        flip_y=0.2, noise=0.1, device="cuda")
    return dict(port=(f, h, x0), lmo=dict(port=port.lmo_l2_ball(RADIUS)),
                L=float(L), L0=max(float(L0), 1e-9), L1=float(L1))


def _graph_and_eager(run):
    """``run()`` as a graph (one capture) and under ``eager_chunks``."""
    driver.clear_graph_cache()
    before = driver.GRAPH_STATS["captures"]
    g = run()
    assert driver.GRAPH_STATS["captures"] == before + 1
    with driver.eager_chunks():
        e = run()
    return g, e


@pytest.mark.cuda
@pytest.mark.parametrize("case", LS_DRIVERS)
def test_line_search_graphs_match_eager_on_card(card_logistic, case):
    name, kw, _ = CASES[case]
    g, e = _graph_and_eager(
        lambda: _run("port", card_logistic, name, 300, **kw))
    _same(g, e)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ARRAY_LMOS))
def test_descent_step_with_array_centre_on_card(name):
    """``FW_alg_descent_step`` with a numpy centre (or bounds) on SymNMF
    on the card: one capture, bit for bit with the eager loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(6)
    A = rng.standard_normal((40, 6))
    f = port.FrobeniusSymLoss(A @ A.T, device="cuda")
    c = 0.5 + 0.1 * rng.standard_normal((40, 3))
    lmo = ARRAY_LMOS[name][0](c)
    X0 = torch.tensor(c, device="cuda")
    g, e = _graph_and_eager(lambda: port.FW_alg_descent_step(
        f, port.SquaredL2Norm(), X0, 300, lmo, verbose=False))
    _same(g, e)
