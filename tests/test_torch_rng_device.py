"""The noise stream on the device (``accbpg_and_fw_tpu_torch/_rng.py``):
JAX's threefry2x32 chain, held on the CPU against ``jax.random`` itself.

* ``split``, the raw 64-bit draws (``bits``) and ``uniform`` equal JAX's
  bit for bit, over a few hundred links of the chain from several seeds,
  those of 2**40 and more included;
* ``normal`` uses torch's ``erfinv`` where XLA uses its own polynomial:
  measured over 10**6 draws, half of the normals differ from JAX's, 99% by
  at most 14 ulps, all by at most 1.5e-12 relative (8355 ulps, in the far
  tails where ``erfinv`` is ill-conditioned).  The bars: 99% within
  ``NORMAL_ULPS_99``, all within ``NORMAL_RTOL``.

The tests marked ``cuda`` hold each entry of the kernel
``csrc/threefry.cu`` against its plain version on the same keys; JAX is
imported inside the CPU tests only, so the card's test command runs this
file without conftest.py.
"""

import numpy as np
import pytest
import torch

from accbpg_and_fw_tpu_torch import _rng

SEEDS = (0, 1, 7, 123456789, 2**32 + 5, 2**40 + 3, 2**63 - 1)
LINKS = 200
NORMAL_ULPS_99, NORMAL_RTOL = 32, 1e-11
# the card's erfinv against torch's on the CPU: two accurate versions
CARD_NORMAL_RTOL = 1e-13


@pytest.fixture(scope="module")
def jr():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax.random


def _words(k):
    return np.asarray(k).astype(np.int64)


def _u64(hi, lo):
    return (hi.numpy().astype(np.uint64) << np.uint64(32)) | \
        lo.numpy().astype(np.uint64)


@pytest.mark.parametrize("seed", SEEDS)
def test_chain_bits_and_uniforms_are_jax_bit_for_bit(jr, seed):
    import jax.numpy as jnp

    kj, kp = jr.PRNGKey(seed), _rng.key(seed)
    np.testing.assert_array_equal(kp.numpy(), _words(kj))
    for _ in range(LINKS):
        nj, sj = jr.split(kj)
        np_, sp, up = _rng.split_uniform(kp)
        np.testing.assert_array_equal(np_.numpy(), _words(nj))
        np.testing.assert_array_equal(sp.numpy(), _words(sj))
        assert float(up) == float(jr.uniform(sj, dtype=jnp.float64))
        assert torch.equal(up, _rng.uniform(sp))
        kj, kp = nj, np_
    hi, lo = _rng.bits(kp, (5, 3))
    np.testing.assert_array_equal(_u64(hi, lo),
                                  np.asarray(jr.bits(kj, (5, 3), jnp.uint64)))
    u = _rng._draw(kp, (257,), "uniform")
    np.testing.assert_array_equal(
        u.numpy(), np.asarray(jr.uniform(kj, (257,), jnp.float64)))


def test_split_is_split_uniform_without_the_draw():
    k = _rng.key(11)
    a, b = _rng.split(k)
    c, d, _ = _rng.split_uniform(k)
    assert torch.equal(a, c) and torch.equal(b, d)


def test_normals_within_the_stated_ulps(jr):
    import jax.numpy as jnp

    zs, refs = [], []
    for seed in SEEDS:
        k = _rng.key(seed)
        for _ in range(3):
            k, sub = _rng.split(k)
            zs.append(_rng.normal(sub, (40, 25)).numpy().ravel())
            refs.append(np.asarray(jr.normal(jnp.asarray(
                _rng.host_words(sub)), (40, 25), jnp.float64)).ravel())
    z, ref = np.concatenate(zs), np.concatenate(refs)
    ulps = np.abs(z - ref) / np.spacing(np.abs(ref))
    assert np.quantile(ulps, 0.99) <= NORMAL_ULPS_99
    np.testing.assert_allclose(z, ref, rtol=NORMAL_RTOL, atol=0)
    assert abs(z.mean()) < 0.05 and abs(z.std() - 1.0) < 0.05


def test_keys_cross_over_as_jax_words(jr):
    k = jr.PRNGKey(2**40 + 9)
    port_key = _rng.as_key(np.asarray(k), "cpu")
    assert port_key.dtype == torch.int64
    np.testing.assert_array_equal(_rng.host_words(port_key), np.asarray(k))
    assert _rng.host_words(port_key).dtype == np.uint32
    with pytest.raises(ValueError):
        _rng.as_key(np.zeros(3, np.uint32), "cpu")
    with pytest.raises(ValueError):
        _rng.split(torch.zeros(2, dtype=torch.int32))


def test_plain_version_launches_nothing():
    before = (_rng.SPLIT_LAUNCHES, _rng.DRAW_LAUNCHES)
    k, sub, _ = _rng.split_uniform(_rng.key(1))
    _rng.normal(sub, (10,))
    assert (_rng.SPLIT_LAUNCHES, _rng.DRAW_LAUNCHES) == before


# ---- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_split_kernel_matches_plain_over_the_chain(cuda_dev):
    kc, kp = _rng.key(2**40 + 7, cuda_dev), _rng.key(2**40 + 7)
    before = _rng.SPLIT_LAUNCHES
    for _ in range(500):
        nc, sc, uc = _rng.split_uniform(kc)
        np_, sp, up = _rng.split_uniform(kp)
        assert torch.equal(nc.cpu(), np_) and torch.equal(sc.cpu(), sp)
        assert torch.equal(uc.cpu(), up)
        kc, kp = nc, np_
    assert _rng.SPLIT_LAUNCHES - before == 500


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1,), (400, 10), (100001,)])
def test_draw_kernel_matches_plain(cuda_dev, shape):
    sc, sp = _rng.split(_rng.key(5, cuda_dev))[1], _rng.split(_rng.key(5))[1]
    hc, lc = _rng.bits(sc, shape)
    hp, lp = _rng.bits(sp, shape)
    assert torch.equal(hc.cpu(), hp) and torch.equal(lc.cpu(), lp)
    assert torch.equal(_rng._draw(sc, shape, "uniform").cpu(),
                       _rng._draw(sp, shape, "uniform"))
    zc, zp = _rng.normal(sc, shape).cpu(), _rng.normal(sp, shape)
    np.testing.assert_allclose(zc.numpy(), zp.numpy(), rtol=CARD_NORMAL_RTOL,
                               atol=0)


@pytest.mark.cuda
def test_kernels_count_their_launches_in_a_graph(cuda_dev):
    k = _rng.key(3, cuda_dev)
    # the library and the device counts exist before the capture
    _rng.normal(_rng.split_uniform(k)[1], (30,))
    _rng.reset_device_launches()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        _, sub, _ = _rng.split_uniform(k)
        z = _rng.normal(sub, (30,))
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert _rng.device_launches("split") == 3
    assert _rng.device_launches("draw") == 3
    ref = _rng.normal(_rng.split(_rng.key(3))[1], (30,))
    np.testing.assert_allclose(z.cpu().numpy(), ref.numpy(),
                               rtol=CARD_NORMAL_RTOL, atol=0)
