"""The inexact-oracle drivers on the card (marked ``cuda``; they skip
without one): AIBM through the multiplier kernel against the port on the
CPU, and a noisy run reproduced bit for bit.  This file imports no JAX,
so the card's test command can run it without conftest.py.
"""

import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu_torch.ops import simplex as sm


def _rows(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert len(got) == len(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_aibm_through_the_multiplier_kernel_matches_the_cpu():
    _card()
    runs = {}
    for dev in ("cuda", "cpu"):
        np.random.seed(7)
        f, _, L, x0 = port.Poisson_regr_simplex_acc(80, 40, noise=0.001,
                                                    device=dev)
        h = port.BurgEntropySimplex(eps=1e-7, use_pallas=True)
        before = sm.LAUNCHES
        runs[dev] = port.AIBM(f, h, L, x0, gamma=2.0, maxitrs=100,
                              verbose=False)
        runs[dev + "_launches"] = sm.LAUNCHES - before
    assert runs["cuda_launches"] >= 100 and runs["cpu_launches"] == 0
    _rows(runs["cuda"][1], runs["cpu"][1], rtol=1e-9)


@pytest.mark.cuda
def test_noisy_run_is_reproduced_on_the_card():
    _card()
    rng = np.random.default_rng(7)
    B = rng.random((20, 20))
    M = (B + B.T) / 2.0
    out = []
    for _ in range(2):
        np.random.seed(3)
        f, (h, _), L, X0 = port.FrobeniusSymLossResMeasEx(M, 2, noise=0.5,
                                                          device="cuda")
        out.append(port.UniversalGM(f, h, L, X0, 20, noise_level=0.1,
                                    verbose=False, seed=4)[1])
    np.testing.assert_array_equal(out[0], out[1])


def _graph_and_eager(run):
    """``run()`` as graph chunks (one capture) and under ``eager_chunks``."""
    from accbpg_and_fw_tpu_torch.algorithms import driver

    driver.clear_graph_cache()
    before = driver.GRAPH_STATS["captures"]
    got = run()
    assert driver.GRAPH_STATS["captures"] - before == 1
    with driver.eager_chunks():
        ref = run()
    return got, ref


@pytest.mark.cuda
def test_inexact_drivers_as_graphs_match_eager():
    """AIBM through kernel 5 and a noisy UniversalGM on a stochastic
    oracle (the key chain on the card) as graph chunks: every row and the
    iterate bit for bit with the eager loop."""
    _card()
    np.random.seed(7)
    f, _, L, x0 = port.Poisson_regr_simplex_acc(80, 40, noise=0.001,
                                                device="cuda")
    h = port.BurgEntropySimplex(eps=1e-7, use_pallas=True)
    got, ref = _graph_and_eager(lambda: port.AIBM(
        f, h, L, x0, gamma=2.0, maxitrs=80, noise=1e-6, seed=3,
        verbose=False))
    assert torch.equal(got[0], ref[0])
    for a, b in zip(got[1:3], ref[1:3]):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(7)
    B = rng.random((20, 20))
    np.random.seed(3)
    f, (h, _), L, X0 = port.FrobeniusSymLossResMeasEx((B + B.T) / 2.0, 2,
                                                      noise=0.05,
                                                      device="cuda")
    got, ref = _graph_and_eager(lambda: port.UniversalGM(
        f, h, L, X0, 40, noise_level=0.01, verbose=False, seed=4))
    assert torch.equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("h_kind", ["closed form", "dual prox"])
def test_primal_dual_as_graphs_matches_eager(h_kind):
    """The primal-dual driver (line search and dual ascent as masked
    loops) as graph chunks against the eager loop, bit for bit; with the
    dual prox as h its kernel runs inside the graph."""
    from accbpg_and_fw_tpu_torch.ops import dual_prox as dp

    _card()
    np.random.seed(31)
    x = np.random.rand(25)
    f, g, h, L, X0 = port.FrobeniusSymLossExWithLinearCnstrnts(
        np.outer(x, x), 4, device="cuda")
    if h_kind == "dual prox":
        h = port.SumOf2nd4thPowersDualProxMap(alpha=h.alpha, sigma=h.sigma,
                                              num_iters=500)
    dp.reset_device_launches()
    got, ref = _graph_and_eager(lambda: port.PrimalDualSwitchingGradientMethod(
        f, h, L, g, X0, 20, epsilon=1e-9, verbose=False))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert (dp.device_launches() > 0) == (h_kind == "dual prox")


def _study_prox():
    """The primal-dual study's 400x10 prox input (examples/ex_primal_dual.py
    figure()'s instance: its start, the gradient there, the oracle's
    constants with num_iters 7000), where the projection is active in
    every step."""
    np.random.seed(11)
    x = np.random.rand(400)
    f, _, h, _, X0 = port.FrobeniusSymLossExWithLinearCnstrnts(
        np.outer(x, x), 10, device="cuda")
    hd = port.SumOf2nd4thPowersDualProxMap(alpha=h.alpha, sigma=h.sigma)
    kw = dict(alpha=hd.alpha, sigma=hd.sigma, num_iters=hd.num_iters,
              eta_base=hd.eta_base, tol=hd.tolerance, radius=hd.radius)
    return f.grad(X0) + hd.grad(X0), X0, 1.0, kw


@pytest.mark.cuda
@pytest.mark.parametrize("shape,num_iters,per_thread", [
    ((10, 10), 3000, None), ((100, 10), 3000, None),
    ((200, 100), 200, None), ((1000, 300), 30, None),
    ("study", 7000, None), ((100, 40), 300, 8)])
def test_dual_prox_kernel_matches_plain(shape, num_iters, per_thread):
    """The kernel against its plain version on the card's tensors: one CTA
    (10x10), clusters of 4 and 16 CTAs (100x10, 200x100), the arrays in
    global memory (1000x300), the primal-dual study's 400x10 prox, and a
    layout of 8 elements a thread (100x40): the same steps, X within 1e-12
    of its largest entry."""
    from accbpg_and_fw_tpu_torch.ops import dual_prox as dp

    _card()
    if shape == "study":
        G, y, L, kw = _study_prox()
    else:
        rng = np.random.default_rng(4)
        y = torch.tensor(rng.random(shape), device="cuda")
        G = torch.tensor(rng.standard_normal(shape), device="cuda")
        L = torch.tensor(2.0, device="cuda")
        kw = dict(alpha=6.0, sigma=3.0, num_iters=num_iters, eta_base=1e-2,
                  tol=1e-5, radius=15.0)
    before = dp.LAUNCHES
    if per_thread is None:
        X, steps, reads = dp.dual_prox(G, y, L, **kw)
        assert dp.LAUNCHES - before == 1 and reads == 0
    else:
        index = torch.cuda.current_device()
        cluster = dp.device_plan(y.numel(), index).cluster
        plan = dp.layout_plan(y.numel(), cluster, per_thread,
                              dp.smem_limit(index))
        assert plan.per_thread == per_thread and dp.schedulable(plan, index)
        X, steps = dp._launch_cuda(G, y, L, plan=plan, **kw)
    Xp, steps_p, _ = dp.dual_prox_reference(G, y, L, **kw)
    assert float(steps) == float(steps_p)
    err = float((X - Xp).abs().max() / Xp.abs().max())
    assert err <= 1e-12
