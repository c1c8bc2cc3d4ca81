"""The fused noise draws of ``accbpg_and_fw_tpu_torch/_rng.py``: a noisy
gradient's split, normal draw, shift, scale and add as one call
(``split_noise``), and the inexact drivers' ``noise * uniform(sub)`` as
one scaled split (``split_uniform(key, scale)``).

On the CPU the plain versions are held against JAX's composition
(``jax.random.split``, then ``(jax.random.normal(sub) - 0.5) * level + G``
or ``noise * jax.random.uniform(sub)``): the keys and the uniforms bit for
bit, the values within the normal bar of tests/test_torch_rng_device.py
(``NORMAL_RTOL`` of the normal, times the scale, plus the last bits of the
sum); and against the port's unfused composition bit for bit, directly,
through ``FrobeniusSymLoss``'s keyed form and through the drivers.

The tests marked ``cuda`` hold the kernel's noise mode against its plain
version and against the unfused launches, count one launch per noisy
gradient inside a captured graph, and hold a stochastic ABPG_gain as
graphs against ``eager_chunks``.  JAX is imported inside the CPU tests
only, so the card's test command runs this file without conftest.py.
"""

import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu_torch import _rng

SHAPES = ((400, 10), (200, 20), (1,))
SEEDS = (0, 7, 2**40 + 3)
LEVEL = 0.05
# tests/test_torch_rng_device.py's bar of torch's normals against JAX's
NORMAL_RTOL = 1e-11
# the card's erfinv against torch's on the CPU (as there)
CARD_NORMAL_RTOL = 1e-13


def _words(k):
    return np.asarray(k).astype(np.int64)


def _base(shape, seed):
    return torch.tensor(np.random.default_rng(seed).standard_normal(shape))


def _within_normal_bar(got, ref, z, scale, rtol=NORMAL_RTOL):
    """|got - ref| within ``rtol`` of the normal ``z`` times ``scale``,
    plus two ulps of the value (where the sum rounds)."""
    got, ref, z = (np.asarray(a, dtype=np.float64) for a in (got, ref, z))
    bar = rtol * np.abs(z) * abs(scale) + 2 * np.spacing(np.abs(ref))
    assert np.all(np.abs(got - ref) <= bar), float(
        np.max(np.abs(got - ref) - bar))


@pytest.fixture(scope="module")
def jr():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax.random


def _unfused(k, shape, shift, scale, base):
    """The port's composition before the fused call: split, normal draw,
    shift, scale, add (five launches on the card)."""
    nxt, sub = _rng.split(k)
    v = (_rng.normal(sub, shape) - shift) * scale
    return nxt, sub, v if base is None else base + v


# ---- on the CPU -------------------------------------------------------------


@pytest.mark.parametrize("with_base", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_plain_matches_jax(jr, shape, with_base):
    import jax.numpy as jnp

    for seed in SEEDS:
        kj, kp = jr.PRNGKey(seed), _rng.key(seed)
        G = _base(shape, seed) if with_base else None
        for _ in range(3):  # three links of the chain
            nj, sj = jr.split(kj)
            z = np.asarray(jr.normal(sj, shape, jnp.float64))
            ref = (z - 0.5) * LEVEL
            if with_base:
                ref = np.asarray(jnp.asarray(G.numpy()) + ref)
            np_, sp, got = _rng.split_noise(kp, shape, 0.5, LEVEL, G)
            np.testing.assert_array_equal(np_.numpy(), _words(nj))
            np.testing.assert_array_equal(sp.numpy(), _words(sj))
            assert got.shape == shape and got.dtype == torch.float64
            _within_normal_bar(got.numpy(), ref, z, LEVEL)
            kj, kp = nj, np_


@pytest.mark.parametrize("shape", SHAPES + ((7, 3, 2),))
def test_fused_plain_is_the_unfused_composition(shape):
    for seed in SEEDS:
        k = _rng.key(seed)
        for shift, scale, with_base in ((0.5, LEVEL, True), (0.5, 3.0, False),
                                        (0.0, 1.0, False)):
            G = _base(shape, seed + 1) if with_base else None
            a = _rng.split_noise(k, shape, shift, scale, G)
            b = _unfused(k, shape, shift, scale, G)
            for x, y in zip(a, b):
                assert torch.equal(x, y)
            k = a[0]
    # no shift, unit scale and no base: the normal draw of the draw key
    nxt, sub, z = _rng.split_noise(_rng.key(9), (40,))
    assert torch.equal(z, _rng.normal(_rng.split(_rng.key(9))[1], (40,)))


def test_scaled_split_is_noise_times_uniform(jr):
    import jax.numpy as jnp

    noise = torch.tensor(1e-6, dtype=torch.float64)
    kj, kp = jr.PRNGKey(4), _rng.key(4)
    for _ in range(50):
        nj, sj = jr.split(kj)
        np_, sp, delta = _rng.split_uniform(kp, scale=noise)
        np.testing.assert_array_equal(np_.numpy(), _words(nj))
        np.testing.assert_array_equal(sp.numpy(), _words(sj))
        assert delta.shape == () and delta.dtype == torch.float64
        # the port's unfused composition and JAX's, bit for bit
        assert torch.equal(delta, noise * _rng.uniform(sp))
        assert float(delta) == float(jnp.asarray(1e-6, jnp.float64)
                                     * jr.uniform(sj, dtype=jnp.float64))
        kj, kp = nj, np_
    # no scale: the uniform itself
    assert torch.equal(_rng.split_uniform(kp)[2],
                       _rng.uniform(_rng.split(kp)[1]))


def _symnmf(n=30, r=3, noise=LEVEL, seed=3):
    rng = np.random.default_rng(seed)
    B = rng.random((n, n))
    M = (B + B.T) / 2.0
    X = np.abs(rng.standard_normal((n, r)))
    return M, X, port.FrobeniusSymLoss(M, noise_level=noise, device="cpu")


def test_keyed_oracle_is_grad_with_the_split_key():
    M, X, f = _symnmf()
    x = torch.tensor(X)
    k = _rng.key(12)
    for _ in range(3):
        nxt, sub = _rng.split(k)
        k2, g = f._grad_keyed(x, k)
        assert torch.equal(k2, nxt)
        assert torch.equal(g, f.grad(x, key=sub))
        k3, (fx, g3) = f._value_and_grad_keyed(x, k)
        fx_ref, g_ref = f.value_and_grad(x, key=sub)
        assert torch.equal(k3, nxt) and torch.equal(g3, g_ref)
        assert torch.equal(fx, fx_ref)
        k = nxt
    # an exact oracle's keyed form splits and adds nothing
    exact = port.FrobeniusSymLoss(M, device="cpu")
    k2, g = exact._grad_keyed(x, k)
    assert torch.equal(k2, _rng.split(k)[0])
    assert torch.equal(g, exact.grad(x))


def test_keyed_oracle_matches_jax_grad(jr):
    import accbpg_and_fw_tpu as acc
    import jax.numpy as jnp

    M, X, f = _symnmf()
    fj = acc.FrobeniusSymLoss.create(jnp.asarray(M), noise_level=LEVEL)
    kj, kp = jr.PRNGKey(21), _rng.key(21)
    x = torch.tensor(X)
    for _ in range(3):
        nj, sj = jr.split(kj)
        ref = np.asarray(fj.grad(jnp.asarray(X), key=sj))
        z = np.asarray(jr.normal(sj, X.shape, jnp.float64))
        kp, g = f._grad_keyed(x, kp)
        np.testing.assert_array_equal(kp.numpy(), _words(nj))
        # the exact gradients' last bits (their sums' order) and the normal
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-12,
                                   atol=NORMAL_RTOL * LEVEL * np.abs(z).max()
                                   + 1e-12 * np.abs(ref).max())
        kj = nj


class _Unfused(port.FrobeniusSymLoss):
    """The oracle without its keyed form: the drivers split and call the
    public keyed gradient, the unfused composition."""

    _grad_keyed = None
    _value_and_grad_keyed = None


def _symnmf_problem(M):
    np.random.seed(3)  # the factory draws X0 from np.random
    f, (h, _), L, X0 = port.FrobeniusSymLossResMeasEx(M, 3, noise=LEVEL,
                                                      device="cpu")
    return f, _Unfused(M, noise_level=LEVEL, device="cpu"), h, L, X0


RUNS = {
    "BPG": lambda f, h, L, x0: port.BPG(f, h, L, x0, 15, verbose=False,
                                        seed=5),
    "ABPG": lambda f, h, L, x0: port.ABPG(f, h, L, x0, 2.0, 15,
                                          verbose=False, seed=5),
    "ABPG_gain": lambda f, h, L, x0: port.ABPG_gain(f, h, L, x0, 2.0, 15,
                                                    verbose=False, seed=5),
    "FW_alg_descent_step": lambda f, h, L, x0: port.FW_alg_descent_step(
        f, h, x0, 15, port.lmo_linf_ball(1.0, 1.0), verbose=False, seed=5),
    "UniversalGM": lambda f, h, L, x0: port.UniversalGM(
        f, h, L, x0, 15, noise_level=0.01, verbose=False, seed=5),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_drivers_draw_one_fused_call_per_gradient(monkeypatch, run):
    """Each noisy gradient of a driver is one ``split_noise`` call (on the
    card one launch) and no separate split, and the rows and the iterate
    are the unfused composition's bit for bit."""
    M, _, _ = _symnmf()
    f, fu, h, L, X0 = _symnmf_problem(M)
    calls = {"split_noise": 0, "split": 0}
    for name in calls:
        real = getattr(_rng, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(_rng, name, counted)
    fused = RUNS[run](f, h, L, X0)
    counts = dict(calls)
    unfused = RUNS[run](fu, h, L, X0)
    assert counts["split_noise"] >= len(fused[1]) - 1 > 0
    # no split beside the fused calls but UniversalGM's seed set-up
    assert counts["split"] == (1 if run == "UniversalGM" else 0)
    # the unfused run splits once per gradient, and as often at set-up
    assert calls["split"] - counts["split"] == sum(counts.values())
    np.testing.assert_array_equal(np.asarray(fused[1]),
                                  np.asarray(unfused[1]))
    assert torch.equal(fused[0], unfused[0])


def test_draw_plan_is_a_launchable_shape():
    threads, per_thread = _rng.DRAW_PLAN
    assert threads % 32 == 0 and 32 <= threads <= 256
    assert per_thread in (1, 2)


def test_fused_plain_version_launches_nothing():
    before = (_rng.SPLIT_LAUNCHES, _rng.DRAW_LAUNCHES)
    zeros = torch.zeros(10, dtype=torch.float64)
    _rng.split_noise(_rng.key(1), (10,), 0.5, 2.0, zeros)
    _rng.split_uniform(_rng.key(1), scale=torch.tensor(2.0).double())
    assert (_rng.SPLIT_LAUNCHES, _rng.DRAW_LAUNCHES) == before
    with pytest.raises(ValueError):
        _rng.split_noise(torch.zeros(2, dtype=torch.int32), (3,))


# ---- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("with_base", [True, False])
@pytest.mark.parametrize("shape", SHAPES + ((100001,),))
def test_noise_kernel_matches_plain_and_the_unfused_launches(cuda_dev, shape,
                                                             with_base):
    for seed in SEEDS:
        kc, kp = _rng.key(seed, cuda_dev), _rng.key(seed)
        G = _base(shape, seed) if with_base else None
        Gc = None if G is None else G.to(cuda_dev)
        before = _rng.DRAW_LAUNCHES
        nc, sc, vc = _rng.split_noise(kc, shape, 0.5, LEVEL, Gc)
        assert _rng.DRAW_LAUNCHES - before == 1
        np_, sp, vp = _rng.split_noise(kp, shape, 0.5, LEVEL, G)
        assert torch.equal(nc.cpu(), np_) and torch.equal(sc.cpu(), sp)
        assert vc.shape == shape
        _within_normal_bar(vc.cpu().numpy(), vp.numpy(),
                           _rng.normal(sp, shape).numpy(), LEVEL,
                           rtol=CARD_NORMAL_RTOL)
        # the split, normal and three tensor operations on the card
        for x, y in zip((nc, sc, vc), _unfused(kc, shape, 0.5, LEVEL, Gc)):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [(64, 1), (128, 2), (256, 1), (256, 2)])
def test_noise_kernel_launch_shapes_agree(cuda_dev, plan):
    k = _rng.key(3, cuda_dev)
    G = _base((400, 10), 3).to(cuda_dev)
    ref = _rng.split_noise(k, (400, 10), 0.5, LEVEL, G)
    got = _rng._noise_cuda(k, (400, 10), 0.5, LEVEL, G, plan)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_scaled_split_kernel_matches_plain(cuda_dev):
    noise_c = torch.tensor(1e-6, dtype=torch.float64, device=cuda_dev)
    noise_p = noise_c.cpu()
    kc, kp = _rng.key(2**40 + 7, cuda_dev), _rng.key(2**40 + 7)
    for _ in range(200):
        nc, sc, dc = _rng.split_uniform(kc, scale=noise_c)
        np_, sp, dp = _rng.split_uniform(kp, scale=noise_p)
        assert torch.equal(nc.cpu(), np_) and torch.equal(sc.cpu(), sp)
        assert dc.shape == () and torch.equal(dc.cpu(), dp)
        kc, kp = nc, np_
    with pytest.raises(ValueError):
        _rng.split_uniform(kc, scale=noise_p)


@pytest.mark.cuda
def test_one_launch_per_noisy_gradient_in_a_graph(cuda_dev):
    M, X, _ = _symnmf()
    f = port.FrobeniusSymLoss(M, noise_level=LEVEL, device=cuda_dev)
    x = torch.tensor(X, device=cuda_dev)
    k = _rng.key(8, cuda_dev)
    f._grad_keyed(x, k)  # the counts and the library exist before
    _rng.reset_device_launches()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        k2, g = f._grad_keyed(x, k)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert _rng.device_launches("draw") == 3
    assert _rng.device_launches("split") == 0
    nxt, sub = _rng.split(k)
    assert torch.equal(k2, nxt) and torch.equal(g, f.grad(x, key=sub))


@pytest.mark.cuda
def test_stochastic_abpg_gain_graph_rows_equal_eager(cuda_dev):
    from accbpg_and_fw_tpu_torch.algorithms import driver

    rng = np.random.default_rng(7)
    B = rng.random((200, 200))
    M = (B + B.T) / 2.0
    np.random.seed(3)
    f, (h, _), L, X0 = port.FrobeniusSymLossResMeasEx(M, 20, noise=0.05,
                                                      device="cuda")

    def run():
        return port.ABPG_gain(f, h, L, X0, 2.0, 100, verbose=False, seed=5)

    driver.clear_graph_cache()
    before = driver.GRAPH_STATS["captures"]
    got = run()
    assert driver.GRAPH_STATS["captures"] - before == 1
    with driver.eager_chunks():
        ref = run()
    F = np.asarray(got[1])
    assert np.all(np.isfinite(F)) and len(F) > 1
    np.testing.assert_array_equal(F, np.asarray(ref[1]))
    assert torch.equal(got[0], ref[0])
