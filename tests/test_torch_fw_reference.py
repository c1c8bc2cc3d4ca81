"""The (L0,L1) shortest-step Frank-Wolfe of the port held against the
benchmark's plain reference (``portbench/reference/fw_l0l1_shortest.py``,
plain PyTorch that imports nothing of the port) on small ill-conditioned
logistic regressions of the fork's regime (``examples/ex_fw_l0l1.py``
"illcond": rho 0.99, 20% label flips, noise 0.1, the l2 ball of radius
25), and the live-trial counter of the masked loops (``_loops.LIVE``)
held against the Python form's ``_loops.TALLY``.

On the CPU, with the masked form forced (``driver.chunk_mode`` patched to
"graph": ``_GraphChunk`` runs ``_masked_steps`` without a capture) and
few bodies, so that continuations happen: every trial the Python form
runs is a live masked body of a kept iteration or a trial of a
continuation, and the rows are the Python form's bit for bit.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu_torch import _loops, diagnostics
from accbpg_and_fw_tpu_torch.algorithms import driver, fw

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.core.registry import load_module  # noqa: E402

torch.set_num_threads(1)

REF = load_module("reference", "fw_l0l1_shortest")
M, N, RADIUS, ITERS = 200, 60, 25.0, 300
REGIME = dict(radius=RADIUS, domain="l2", rho=0.99, col_scale=1.0,
              flip_y=0.2, noise=0.1)
LOOP = "FW shortest trials"


def _instance(key):
    f, h, _, L0, L1, x0, X, y = port.hard_FW_log_reg_jax(
        key, M, N, device="cpu", **REGIME)
    return f, h, max(float(L0), 1e-9), float(L1), x0, X, y


def _solve(f, h, L0, L1, x0, lmo, iters=ITERS):
    return port.FW_alg_L0_L1_shortest_step(f, h, L0, L1, x0, iters,
                                           gamma=2.0, lmo=lmo, verbose=False)


def _trials(tally):
    """The bodies the Python-form line searches ran, in all."""
    return sum(b * c for b, c in (tally or {}).get(LOOP, {}).items())


@pytest.mark.parametrize("key", [3, 63])
def test_port_matches_the_reference(key):
    """The reference computes each row with the port's operations in the
    port's order (the same GEMVs, softplus, sigmoid, norms and dot
    products, the scalars in float64), so on the CPU the rows agree to
    the last bit; rtol 1e-11 leaves room for a BLAS that blocks a product
    otherwise (the card's rows of 200 steps stay within 1.8e-12 of the
    CPU's), and atol 1e-12 on x (|x| <= 25) the same few ulps."""
    f, h, L0, L1, x0, X, y = _instance(key)
    x, F, Ls, _ = _solve(f, h, L0, L1, x0, port.lmo_l2_ball(RADIUS))
    xr, Fr, Lsr = REF.shortest_step(X, y, L0, L1, x0, ITERS, RADIUS)
    assert len(F) == len(Fr) == ITERS
    np.testing.assert_allclose(F, Fr, rtol=1e-11, atol=0)
    np.testing.assert_allclose(Ls, Lsr, rtol=1e-11, atol=0)
    torch.testing.assert_close(x, xr, rtol=0, atol=1e-12)
    assert float(torch.linalg.vector_norm(x)) <= RADIUS * (1 + 1e-15)
    # the follow of the program's own a_k gives its F rows and its
    # iterate, with no breach; the reference's own L0 and L1 are the pool's
    xf, Ff, a_gap, breach = REF.follow(X, y, L0, L1, x0, Ls, RADIUS)
    np.testing.assert_allclose(Ff, F, rtol=1e-11, atol=0)
    torch.testing.assert_close(xf, x, rtol=0, atol=1e-12)
    assert a_gap <= 1e-13 and breach <= 1e-13
    assert REF.constants(X, {"L0_floor": 1e-9}) == (L0, L1)


@pytest.fixture
def masked(monkeypatch):
    """The graph chunk's masked form on the CPU, with ``bodies`` masked
    trials after the first, from the call of ``masked(bodies)`` on."""
    def use(bodies):
        monkeypatch.setattr(driver, "chunk_mode",
                            lambda carry, problem=None, cfg=None: "graph")
        monkeypatch.setattr(fw, "SHORTEST_BODIES", bodies)

    return use


def _counted(run):
    """``run()``'s result with the change of ``_loops.live_counts()`` for
    the loop, the Python form's ``TALLY`` over it, and the continuations
    and replays."""
    before = _loops.live_counts().get(LOOP, (0, 0))
    stats = dict(driver.GRAPH_STATS)
    _loops.TALLY[0] = {}
    try:
        out = run()
        tally = _loops.TALLY[0]
    finally:
        _loops.TALLY[0] = None
    after = _loops.live_counts().get(LOOP, (0, 0))
    return (out, after[0] - before[0], after[1] - before[1], tally,
            {k: driver.GRAPH_STATS[k] - stats[k] for k in stats})


@pytest.mark.parametrize("bodies", [1, 2])
def test_live_counter_adds_up_to_the_tally(masked, bodies):
    """Few bodies: iterations overflow and run again in the Python form.
    The live bodies of the kept iterations and the continuations' trials
    add up to the Python form's trials; every launched span counts its
    bodies as run; the rows are the Python form's bit for bit."""
    f, h, L0, L1, x0, _, _ = _instance(3)
    py, _, _, tally, _ = _counted(
        lambda: _solve(f, h, L0, L1, x0, port.lmo_l2_ball(RADIUS)))
    masked(bodies)
    got, live, run, cont, stats = _counted(
        lambda: _solve(f, h, L0, L1, x0, port.lmo_l2_ball(RADIUS)))
    assert stats["continuations"] > 0
    assert sum((cont or {}).get(LOOP, {}).values()) == \
        stats["continuations"]
    assert live + _trials(cont) == _trials(tally)
    assert run == bodies * fw.GRAPH_SPAN * stats["replays"]
    assert 0 < live < run
    np.testing.assert_array_equal(got[1], py[1])
    np.testing.assert_array_equal(got[2], py[2])
    assert torch.equal(got[0], py[0])


def test_live_counter_equals_the_tally_without_overflow(masked):
    """Bodies enough for every iteration: no continuation, and the live
    masked bodies are the Python form's trials."""
    f, h, L0, L1, x0, _, _ = _instance(63)
    _, _, _, tally, _ = _counted(
        lambda: _solve(f, h, L0, L1, x0, port.lmo_l2_ball(RADIUS)))
    masked(max(tally[LOOP]) + 1)
    _, live, _, cont, stats = _counted(
        lambda: _solve(f, h, L0, L1, x0, port.lmo_l2_ball(RADIUS)))
    assert stats["continuations"] == 0 and not cont
    assert live == _trials(tally) > 0


def test_live_counts_outside_a_chunk():
    """The masked form called alone (no ``_masked_steps``) counts
    nothing, and ``live_counts`` reads every loop's pair."""
    before = _loops.live_counts()
    flags = []
    _loops.OVERFLOW[0] = flags
    try:
        _loops.device_while(lambda s: s[0] < 3.0, lambda s: (s[0] + 1.0,),
                            (torch.zeros((), dtype=torch.float64),), None,
                            4, "alone")
    finally:
        _loops.OVERFLOW[0] = None
    assert _loops.live_counts() == before
    assert all(len(p) == 2 for p in before.values())


def test_solve_span_names_the_driver_and_shape():
    f, h, L0, L1, x0, _, _ = _instance(3)
    with diagnostics.recording() as out:
        _solve(f, h, L0, L1, x0, port.lmo_l2_ball(RADIUS), iters=4)
    (root,) = [s for s in out if s[1] is None]
    assert root[3] == "driver.solve"
    assert root[6] == {"driver": "_fw_l0l1_shortest_step", "m": M, "n": N}
