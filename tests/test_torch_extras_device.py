"""The inexact-oracle and primal-dual drivers in their device form
(``algorithms/extras.py``: device scalars, ``device_while`` line searches
and dual ascent, the noise key a device tensor) against the JAX drivers on
the inputs of tests/test_torch_extras.py and to its bars (F, G and the
gaps rtol 1e-11 with the same rows, the iterate atol 1e-12):

* with and without noise (AIBM's delta, UniversalGM's and AdaptFGM's
  slack; a stochastic f-oracle's draws are tests/test_torch_stochastic.py's
  replays), with and without the primal-dual line search;
* the masked form (``driver.chunk_mode`` patched to "graph" on the CPU,
  one or two masked bodies a loop, spans of 8 over chunks of 20) against
  the Python form bit for bit, continuations counted;
* a noisy checkpoint with the device key saved by one package and resumed
  by the other;
* ``chunk_mode`` of the extras' carries;
* the dual prox's plain route (``ops/dual_prox.py``) against JAX's
  ``div_prox_map``, and its kernel's launch plan.

The card's side is tests/test_torch_extras_card.py.
"""

import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu as acc
import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu_torch import _loops, _rng
from accbpg_and_fw_tpu_torch.algorithms import driver, extras
from accbpg_and_fw_tpu_torch.interop import from_jax_oracle
from accbpg_and_fw_tpu_torch.ops import dual_prox as dp

from test_torch_extras import (_call, _pd, _pd_same, _rows, _x, pd_problem,  # noqa: F401
                               poisson, svm)
from test_torch_lazy import keep_jax_exec_cache  # noqa: F401 (autouse)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# against JAX, noisy and not
# ---------------------------------------------------------------------------


NOISY = {
    "AIBM": dict(noise=1e-6, seed=3),
    "AdaptFGM": dict(noise=1e-6, seed=5),
    "UniversalGM": dict(noise_level=1e-6, seed=7),
}


@pytest.mark.parametrize("name", list(NOISY))
@pytest.mark.parametrize("noisy", [False, True])
def test_inexact_drivers_noisy_match_jax(poisson, name, noisy):
    kw = NOISY[name] if noisy else {}
    rj = _call(acc, name, *poisson[0], 40, verbose=False, **kw)
    rp = _call(port, name, *poisson[1], 40, verbose=False, **kw)
    _rows(rp[1], rj[1])
    _rows(rp[2], rj[2])
    _x(rp[0], rj[0])
    assert rp[0].device.type == "cpu"


@pytest.fixture(scope="module")
def noisy_symnmf():
    """A stochastic f-oracle (its gradients draw normals from the key
    chain): the SymNMF of tests/test_torch_stochastic.py at noise 0.05,
    whose replays against JAX that file holds."""
    rng = np.random.default_rng(7)
    B = rng.random((20, 20))
    np.random.seed(3)
    fj, (hj, _), L, X0j = acc.FrobeniusSymLossResMeasEx((B + B.T) / 2.0, 2,
                                                        noise=0.05)
    return ((fj, hj, L, X0j),
            (from_jax_oracle(fj, device="cpu"), from_jax_oracle(hj), L,
             torch.tensor(np.asarray(X0j))))


@pytest.mark.parametrize("linesearch", [True, False])
def test_primal_dual_device_form_matches_jax(pd_problem, linesearch):
    rj = _pd(acc, pd_problem[0], 25, linesearch=linesearch)
    rp = _pd(port, pd_problem[1], 25, linesearch=linesearch)
    _pd_same(rp, rj)


# ---------------------------------------------------------------------------
# the masked form against the Python form
# ---------------------------------------------------------------------------


def _force_graph(monkeypatch, bodies):
    """Run CPU carries through the graph chunk's code (``_masked_steps``,
    no capture) with ``bodies`` masked bodies per loop and spans of 8."""
    monkeypatch.setattr(driver, "chunk_mode",
                        lambda carry, problem=None, cfg=None: "graph")
    for name in ("AIBM_BODIES", "ADAPT_BODIES", "UNIVERSAL_BODIES",
                 "PD_BODIES"):
        monkeypatch.setattr(extras, name, bodies)
    monkeypatch.setattr(extras, "DUAL_BODIES", 4 * bodies)
    monkeypatch.setattr(extras, "GRAPH_SPAN", 8)
    monkeypatch.setattr(extras, "PD_GRAPH_SPAN", 8)
    monkeypatch.setattr(driver, "_GRAPHS", type(driver._GRAPHS)())


MASKED = {
    "AIBM": lambda p: _call(port, "AIBM", *p, 40, chunk=20, verbose=False,
                            noise=1e-6, seed=3),
    "AdaptFGM": lambda p: _call(port, "AdaptFGM", *p, 40, chunk=20,
                                verbose=False),
    "UniversalGM": lambda p: _call(port, "UniversalGM", *p, 40, chunk=20,
                                   verbose=False, noise_level=1e-6, seed=1),
}


@pytest.mark.parametrize("bodies", [1, 2])
@pytest.mark.parametrize("name", list(MASKED))
def test_masked_loops_bit_equal_with_continuations(poisson, monkeypatch,
                                                   name, bodies):
    """Chunks of 20 over spans of 8 (the third span runs past the chunk,
    masked): iterations whose line search needs more bodies overflow, run
    again in the Python form and are counted; every bit matches."""
    _loops.TALLY[0] = {}
    ref = MASKED[name](poisson[1])
    tally, _loops.TALLY[0] = _loops.TALLY[0], None
    loop = "AIBM trials" if name == "AIBM" else "FGM trials"
    over = sum(c for b, c in tally[loop].items() if b > bodies)
    _force_graph(monkeypatch, bodies)
    before = dict(driver.GRAPH_STATS)
    got = MASKED[name](poisson[1])
    cont = driver.GRAPH_STATS["continuations"] - before["continuations"]
    # every iteration whose line search needs more bodies runs again (and
    # so may one whose prox's Newton does)
    assert over <= cont <= 40 and (bodies > 1 or cont > 0)
    assert driver.GRAPH_STATS["replays"] - before["replays"] >= 6
    assert torch.equal(got[0], ref[0])
    for a, b in zip(got[1:-1], ref[1:-1]):
        np.testing.assert_array_equal(a, b)


def test_masked_stochastic_oracle_bit_equal(noisy_symnmf, monkeypatch):
    """A stochastic f-oracle's per-trial draws in masked bodies: the keys
    of the bodies that die are dropped with them."""
    run = lambda: _call(port, "UniversalGM", *noisy_symnmf[1], 30,  # noqa: E731
                        chunk=20, verbose=False, seed=2)
    ref = run()
    _force_graph(monkeypatch, 1)
    got = run()
    for a, b in zip(got[:-1], ref[:-1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("linesearch", [True, False])
def test_primal_dual_masked_bit_equal(pd_problem, monkeypatch, linesearch):
    """The primal-dual driver with one masked trial and four masked ascent
    steps: its productive line search and its ascent overflow, and the
    run is the eager run's bit for bit."""
    ref = _pd(port, pd_problem[1], 20, chunk=20, linesearch=linesearch)
    _force_graph(monkeypatch, 1)
    before = driver.GRAPH_STATS["continuations"]
    got = _pd(port, pd_problem[1], 20, chunk=20, linesearch=linesearch)
    assert driver.GRAPH_STATS["continuations"] > before
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# checkpoints and the chunk's mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_noisy_universalgm_checkpoint_with_device_key(noisy_symnmf, tmp_path,
                                                      writer):
    """A noisy UniversalGM with a stochastic oracle: 10 iterations saved by
    one package (the key as JAX's uint32 words), resumed to 20 by the
    other, against JAX's uninterrupted run."""
    ck = str(tmp_path / "ugm.npz")
    first, second = (acc, port) if writer == "jax" else (port, acc)
    args = {acc: noisy_symnmf[0], port: noisy_symnmf[1]}
    kw = dict(noise_level=1e-4, seed=6, verbose=False, chunk=5)
    _call(first, "UniversalGM", *args[first], 10, checkpoint=ck, **kw)
    with np.load(ck) as z:
        assert z["c::key"].dtype == np.uint32 and z["c::key"].shape == (2,)
    r2 = _call(second, "UniversalGM", *args[second], 20, checkpoint=ck, **kw)
    ref = _call(acc, "UniversalGM", *noisy_symnmf[0], 20, **kw)
    _rows(r2[1], ref[1])


def test_extras_carries_choose_graph(poisson, pd_problem, monkeypatch):
    """The extras' carries are all tensors with the key among them: on a
    card (the device patched) a chunk is a graph, for every driver and
    also for ``exact_dual_grad`` (its autograd runs on the card's stream);
    on the CPU eager."""
    f, h, L, x0 = poisson[1]
    carry = dict(done=torch.tensor(False), key=_rng.key(0), x=x0,
                 L=torch.tensor(1.0), F_prev=torch.tensor(0.0))
    prob = dict(f=f, h=h, eps=torch.tensor(1e-9))
    assert driver.chunk_mode(carry, prob, extras._AIBMCfg()) == "eager"
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    assert driver.chunk_mode(carry, prob, extras._AIBMCfg()) == "graph"
    pf, pg, ph, _, _ = pd_problem[1]
    cfg = extras._PDCfg(linesearch=True, dual_max_inner=100,
                        exact_dual_grad=True)
    assert driver.chunk_mode(carry, dict(f=pf, h=ph, cnstrnt=pg),
                             cfg) == "graph"


# ---------------------------------------------------------------------------
# the dual prox's plain route and its kernel's plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,L,num_iters", [((40, 10), 1.0, 3000),
                                               ((12, 3), 5.0, 30)])
def test_dual_prox_plain_route_matches_jax(shape, L, num_iters):
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    y, g = rng.random(shape), rng.standard_normal(shape)
    hj = acc.SumOf2nd4thPowersDualProxMap(alpha=6.0, sigma=3.0,
                                          num_iters=num_iters)
    Xj = np.asarray(hj.div_prox_map(jnp.asarray(y), jnp.asarray(g), L))
    hp = port.SumOf2nd4thPowersDualProxMap(alpha=6.0, sigma=3.0,
                                           num_iters=num_iters)
    G = torch.tensor(g) + hp.grad(torch.tensor(y))
    before = dp.LAUNCHES
    X, steps, reads = dp.dual_prox(G, torch.tensor(y), torch.tensor(L),
                                   alpha=6.0, sigma=3.0, num_iters=num_iters,
                                   eta_base=1e-2, tol=1e-4, radius=15.0)
    assert dp.LAUNCHES == before and 0 < int(steps) <= num_iters
    np.testing.assert_allclose(X.numpy(), Xj, rtol=1e-12, atol=1e-12)


def test_dual_prox_plan_layouts():
    limit = 232448
    study = dp.dual_prox_plan(4000, limit, 16)  # the primal-dual study
    assert (study.cluster, study.chunk, study.threads) == (16, 250, 64)
    assert (study.per_thread, study.layout) == (4, "registers")
    assert study.smem_bytes == 2 * 32 * 88 + 2 * 80 * 16 * 2
    assert sum(len(study.owned(r)) for r in range(16)) == 4000
    one = dp.dual_prox_plan(4000, limit, 1)  # a card with no clusters
    assert (one.cluster, one.threads, one.layout) == (1, 256, "shared")
    big = dp.dual_prox_plan(40000, limit, 16)
    assert big.cluster == 16 and big.chunk == 2500 and big.layout == "shared"
    assert big.threads == 256 and big.per_thread == 0
    huge = dp.dual_prox_plan(10**6, limit, 16)
    assert huge.cluster == 16 and huge.layout == "global"
    assert huge.smem_bytes == 8 * 32 * 88 + 2 * 80 * 16 * 8
    small = dp.dual_prox_plan(50, limit, 16)
    assert (small.cluster, small.threads, small.per_thread) == (1, 32, 4)
    assert dp.dual_prox_plan(40000, limit, 4).cluster == 4
    with pytest.raises(ValueError):
        dp.dual_prox_plan(0, limit, 16)
    with pytest.raises(ValueError):
        dp.dual_prox_plan(100, limit, 3)
