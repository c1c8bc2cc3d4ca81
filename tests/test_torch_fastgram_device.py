"""The ``fast_gram`` steps as device-scalar steps (``algorithms/bpg.py``'s
``_*_dopt_step``s, ``algorithms/fastgram.py``'s gates as device selects,
the warm prox's multiplier carried as a tensor), held against the JAX
package on the CPU at the small shapes of ``tests/test_torch_fastgram.py``
(12x60 and 16x64) and at its bars.

* The five drivers with ``fast_gram=True`` against JAX's with a chunk of
  7, so that the chunk-boundary refresh (on the device, no read) runs
  seven times in 50 iterations; the carry the driver runs is all tensors
  (``done`` a bool, ``kk`` int64, the scalars 0-d float64), the carry
  keys JAX's, and on a card it would be a graph chunk.
* The masked form forced on the CPU through the graph chunk's code
  (``driver._masked_steps``) with one or two bodies per loop, so that
  iterations overflow: bit for bit with the Python form, every overflow
  counted as a continuation, and both branches of each gate taken on the
  way (``fastgram.TALLY`` over the Python form's run).
* A gate's branch that is not taken may hold a NaN (``inv_seed`` of a
  Gram that is not positive definite); the select drops it, and
  ``diagnostics.debug_mode`` does not raise for it.
* Checkpoints written mid-run by either package resume in the other.

The test marked ``cuda`` holds the graph chunk against ``eager_chunks`` on
the card (``python -m pytest --noconftest -m cuda
tests/test_torch_fastgram_device.py``); the JAX side of this file is
imported only inside fixtures and tests, so it runs without JAX.
"""

import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu_torch import diagnostics
from accbpg_and_fw_tpu_torch.algorithms import bpg, driver, fastgram, theta
from accbpg_and_fw_tpu_torch.ops import roots

from test_torch_fw_device import record_continuations, spans_replayed
from test_torch_lazy import keep_jax_exec_cache  # noqa: F401 (autouse)

torch.set_num_threads(1)

# tests/test_torch_fastgram.py's bars, and tests/test_torch_abpg.py's with
# checkdiv (no descent test holds the iteration: rounding is amplified)
F_RTOL, G_RTOL, X_ATOL = 1e-11, 1e-8, 1e-12
CHECKDIV_F_RTOL, CHECKDIV_G_RTOL, CHECKDIV_X_ATOL = 1e-9, 1e-4, 1e-10
ITERS, CHUNK = 50, 7

# driver, its positional arguments, options, and the bar of each history
# it returns between the iterate and T ("F": F_RTOL against the history's
# largest |F| too; "exact": equal)
CASES = {
    "BPG": ("BPG", (), {}, ("F", F_RTOL)),
    "BPG_no_ls": ("BPG", (), dict(linesearch=False), ("F", F_RTOL)),
    "ABPG": ("ABPG", (2.0,), dict(restart=True, restart_rule="g"),
             ("F", G_RTOL)),
    "ABPG_expo": ("ABPG_expo", (3.0,), {}, ("F", "exact", G_RTOL)),
    "ABPG_expo_checkdiv": ("ABPG_expo", (3.0,), dict(checkdiv=True),
                           ("F", "exact", CHECKDIV_G_RTOL)),
    "ABPG_gain": ("ABPG_gain", (2.0,), {}, ("F", F_RTOL, G_RTOL, F_RTOL)),
    "ABPG_gain_restart_f": ("ABPG_gain", (2.0,),
                            dict(restart=True, restart_rule="f"),
                            ("F", F_RTOL, G_RTOL, F_RTOL)),
    "ABDA": ("ABDA", (2.0,), {}, ("F", G_RTOL)),
}


def _instance(m, n, seed):
    """``tests/test_torch_fastgram.py``'s random design, for both
    packages: (JAX oracle, h, x0), (port oracle, h, x0)."""
    import jax.numpy as jnp

    import accbpg_and_fw_tpu as acc
    from accbpg_and_fw_tpu_torch.interop import from_jax_oracle

    np.random.seed(seed)
    V = np.random.randn(m, n)
    fj = acc.DOptimalObj(H=jnp.asarray(V, jnp.float64))
    hj = acc.ops.h_oracles.BurgEntropySimplex()
    x0 = np.full(n, 1.0 / n)
    return dict(jax=(acc, fj, hj, jnp.asarray(x0)),
                port=(port, from_jax_oracle(fj, device="cpu"),
                      port.BurgEntropySimplex(), torch.tensor(x0)))


@pytest.fixture(scope="module")
def problems():
    return {"small": _instance(12, 60, 5), "wide": _instance(16, 64, 3)}


def _run(problem, pkg, case, iters=ITERS, **more):
    name, args, kw, _ = CASES[case]
    mod, f, h, x0 = problem[pkg]
    return getattr(mod, name)(f, h, 1.0, x0, *args, iters, verbose=False,
                              fast_gram=True, **kw, **more)


def _assert_returns(case, got, ref):
    cd = CASES[case][2].get("checkdiv", False)
    for bar, a, b in zip(CASES[case][3], got[1:-1], ref[1:-1]):
        a, b = np.asarray(a), np.asarray(b)
        assert len(a) == len(b)
        if bar == "exact":
            np.testing.assert_array_equal(a, b)
            continue
        if bar == "F":
            bar = CHECKDIV_F_RTOL if cd else F_RTOL
            np.testing.assert_allclose(a, b, rtol=bar,
                                       atol=bar * np.abs(b).max())
        else:
            np.testing.assert_allclose(a, b, rtol=bar, atol=0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=CHECKDIV_X_ATOL if cd else X_ATOL)


@pytest.mark.parametrize("inst", ["small", "wide"])
@pytest.mark.parametrize("case", list(CASES))
def test_device_steps_match_jax(problems, monkeypatch, case, inst):
    seen = []
    run_driver = bpg.run_driver

    def spy(step, carry, *args, **kw):
        seen.append((dict(carry), kw["problem"], kw["cfg"]))
        out = run_driver(step, carry, *args, **kw)
        seen.append((out[0], kw["problem"], kw["cfg"]))
        return out

    monkeypatch.setattr(bpg, "run_driver", spy)
    rp = _run(problems[inst], "port", case, chunk=CHUNK)
    rj = _run(problems[inst], "jax", case, chunk=CHUNK)
    _assert_returns(case, rp, rj)
    for carry, prob, cfg in seen:
        assert {"Gx", "Minv", "fx", "cpx"} <= set(carry)
        assert all(isinstance(v, torch.Tensor) for v in carry.values())
        assert carry["done"].dtype == torch.bool
        for key in ("L", "theta", "G", "sumlogG", "F_prev", "fx", "cpx",
                    "gamma", "csum"):
            if key in carry:
                v = carry[key]
                assert v.dim() == 0 and v.dtype == torch.float64, key
        if "kk" in carry:
            assert carry["kk"].dtype == torch.int64
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    assert driver.chunk_mode(seen[0][0], seen[0][1], seen[0][2]) == "graph"


def _force_graph(monkeypatch, bodies):
    """Run CPU carries through the graph chunk's code (``_masked_steps``,
    no capture) with ``bodies`` masked bodies per loop."""
    monkeypatch.setattr(driver, "chunk_mode",
                        lambda carry, problem=None, cfg=None: "graph")
    for mod, name in ((bpg, "FG_BPG_BODIES"), (bpg, "FG_EXPO_BODIES"),
                      (bpg, "FG_GAIN_BODIES"), (theta, "NEWTON_BODIES"),
                      (roots, "NEWTON_BODIES"),
                      (roots, "WARM_NEWTON_BODIES")):
        monkeypatch.setattr(mod, name, bodies)
    monkeypatch.setattr(bpg, "GRAPH_SPAN", 8)
    monkeypatch.setattr(driver, "_GRAPHS", type(driver._GRAPHS)())


@pytest.mark.parametrize("case,bodies", [
    ("BPG", 1), ("BPG", 2), ("ABPG", 1), ("ABPG_expo", 1),
    ("ABPG_expo_checkdiv", 2), ("ABPG_gain", 1), ("ABPG_gain", 2),
    ("ABPG_gain_restart_f", 1), ("ABDA", 2)])
def test_masked_form_bit_equal_with_continuations(problems, monkeypatch,
                                                  case, bodies):
    """Chunks of 20 over spans of 8 (the third span runs past the chunk,
    masked), 40 iterations on 12x60: the multiplier's Newton needs more
    than 2 passes, so iterations overflow, run again in the Python form
    and are counted; every bit matches the Python form's run, which took
    both branches of each gate."""
    fastgram.TALLY[0] = {}
    try:
        ref = _run(problems["small"], "port", case, 40, chunk=20)
        tally = fastgram.TALLY[0]
    finally:
        fastgram.TALLY[0] = None
    assert set(tally) == {"warm start", "series"}
    assert all(counts.get(True) and counts.get(False)
               for counts in tally.values()), tally
    _force_graph(monkeypatch, bodies)
    conts = record_continuations(monkeypatch)
    before = dict(driver.GRAPH_STATS)
    got = _run(problems["small"], "port", case, 40, chunk=20)
    cont = driver.GRAPH_STATS["continuations"] - before["continuations"]
    assert 0 < cont <= 40 and len(conts) == cont
    # two chunks of three spans; a replay stops at the span that
    # overflowed, and another starts after each continuation
    assert driver.GRAPH_STATS["replays"] - before["replays"] == (
        spans_replayed(conts, 40, 20, 8))
    assert torch.equal(got[0], ref[0])
    for a, b in zip(got[1:-1], ref[1:-1]):
        np.testing.assert_array_equal(a, b)


def test_masked_form_without_overflow(problems, monkeypatch):
    """With enough bodies no iteration overflows: one replay per span and
    the Python form's bits."""
    ref = _run(problems["small"], "port", "ABPG_gain", 40, chunk=20)
    _force_graph(monkeypatch, 12)
    before = dict(driver.GRAPH_STATS)
    got = _run(problems["small"], "port", "ABPG_gain", 40, chunk=20)
    assert driver.GRAPH_STATS["continuations"] == before["continuations"]
    assert driver.GRAPH_STATS["replays"] - before["replays"] == 6
    assert torch.equal(got[0], ref[0])
    for a, b in zip(got[1:-1], ref[1:-1]):
        np.testing.assert_array_equal(a, b)


def test_branch_not_taken_drops_its_nan(problems):
    """A Gram that is not positive definite: ``inv_seed`` and
    ``logdet_full`` give NaN, but where the gates take the warm start and
    the series the results are finite, and a solve under ``debug_mode``
    reads no NaN."""
    _, f, h, x0 = problems["small"]["port"]
    G = -f.gram(x0)
    M_prev = torch.linalg.inv(G) * (1.0 + 1e-4)
    assert torch.isnan(f.inv_seed(G)).all() and torch.isnan(
        f.logdet_full(G))
    M = fastgram.inv_at(f, G, M_prev)
    assert torch.isfinite(M).all()
    torch.testing.assert_close(M, torch.linalg.inv(G), rtol=1e-12, atol=0)
    ld, s = fastgram.anchored_logdet_shift(f, 0.5, 1.0, M, G, G)
    assert torch.isfinite(ld) and abs(float(s)) < 1e-12
    clean = _run(problems["small"], "port", "ABPG_gain", 30)
    with diagnostics.debug_mode():
        again = _run(problems["small"], "port", "ABPG_gain", 30)
    np.testing.assert_array_equal(again[1], clean[1])


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("case", ["BPG", "ABPG_expo", "ABDA"])
def test_checkpoint_resumes_across_packages(problems, tmp_path, case,
                                            writer):
    """30 iterations saved by one package (the refresh at two chunk
    boundaries included), resumed to 60 by the other: the resumed rows bit
    for bit with the writer's, the rest at the bars against JAX's
    uninterrupted run."""
    ck = str(tmp_path / "ck.npz")
    first, second = ("jax", "port") if writer == "jax" else ("port", "jax")
    prob = problems["small"]
    r1 = _run(prob, first, case, 30, chunk=15, checkpoint=ck)
    with np.load(ck) as z:
        assert int(z["__k_next"]) == 30
        assert {"Gx", "Minv", "fx", "cpx"} <= {
            n[3:] for n in z.files if n.startswith("c::")}
    r2 = _run(prob, second, case, 60, chunk=15, checkpoint=ck)
    ref = _run(prob, "jax", case, 60, chunk=15)
    for got, first_rows in zip(r2[1:-1], r1[1:-1]):
        np.testing.assert_array_equal(np.asarray(got)[:30],
                                      np.asarray(first_rows))
    x2 = r2[0] if isinstance(r2[0], torch.Tensor) else torch.tensor(
        np.asarray(r2[0]))
    _assert_returns(case, (x2,) + tuple(r2[1:]), ref)


# ---- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_fast_gram_graphs_match_eager_on_card():
    """The five drivers with ``fast_gram=True`` at 30x1000 on the card: one
    capture each, the graph's rows against ``eager_chunks``' (bit for bit,
    or 1e-13 where cuBLAS took another algorithm under capture)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    f, h, L, x0 = port.D_opt_design(30, 1000, randseed=10, device="cuda")
    runs = {"BPG": (), "ABPG": (2.0,), "ABPG_expo": (3.0,),
            "ABPG_gain": (2.0,), "ABDA": (2.0,)}
    for name, args in runs.items():
        def run():
            return getattr(port, name)(f, h, L, x0, *args, 100,
                                       verbose=False, fast_gram=True)

        driver.clear_graph_cache()
        before = dict(driver.GRAPH_STATS)
        g = run()
        assert driver.GRAPH_STATS["captures"] == before["captures"] + 1
        with driver.eager_chunks():
            e = run()
        assert g[0].device.type == "cuda"
        for a, b in zip(g[1:-1], e[1:-1]):
            assert len(a) == len(b)
            np.testing.assert_allclose(a, b, rtol=1e-13)
