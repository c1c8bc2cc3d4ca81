"""The stochastic (inexact) oracle protocol on the port: the drivers thread
a chain of keys (``accbpg_and_fw_tpu_torch/_rng.py``) so a declared noise
reaches the run, the same seed reproduces it, another seed changes it, and
an exact oracle ignores the seed (the port's mirror of
tests/test_stochastic_oracles.py).

The port draws JAX's samples: ``_rng`` is JAX's threefry chain (its bits
and uniforms equal, its normals within the last bits of ``erfinv``:
tests/test_torch_rng_device.py), so the noisy runs of BPG, ABPG_gain,
AIBM, UniversalGM and FW_alg_descent_step follow the JAX drivers at rtol
1e-11 as they are.  The noise is 0.05 there: at 0.5 a run reaches its
noise floor within 25 rows, where line-search decisions rest on the last
bits of sums the two packages order differently.
"""

import jax
import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu as acc
import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu_torch import _rng
from accbpg_and_fw_tpu_torch.interop import from_jax_oracle

from test_torch_lazy import keep_jax_exec_cache  # noqa: F401 (autouse)

torch.set_num_threads(1)


def _differs(a, b):
    n = min(len(a), len(b))
    return len(a) != len(b) or not np.allclose(a[:n], b[:n])


def _same(a, b):
    return len(a) == len(b) and np.array_equal(a, b)


@pytest.fixture(scope="module")
def M():
    rng = np.random.default_rng(7)
    B = rng.random((20, 20))
    return (B + B.T) / 2.0


def _symnmf(M, noise):
    np.random.seed(3)  # the factory draws X0 from np.random
    f, (h, _), L, X0 = port.FrobeniusSymLossResMeasEx(M, 2, noise=noise,
                                                      device="cpu")
    return f, h, L, X0


def _bpg(M, noise, seed, linesearch=True):
    f, h, L, X0 = _symnmf(M, noise)
    return port.BPG(f, h, L, X0, maxitrs=25, verbose=False,
                    linesearch=linesearch, seed=seed)[1]


def test_keys_are_jax_prngkey_words():
    np.testing.assert_array_equal(_rng.key(5).numpy(), np.asarray(
        jax.random.PRNGKey(5)))
    np.testing.assert_array_equal(_rng.key(2**40 + 3).numpy(), np.asarray(
        jax.random.PRNGKey(2**40 + 3)))
    k, sub = _rng.split(_rng.key(0))
    assert k.dtype == sub.dtype == torch.int64
    assert k.shape == sub.shape == (2,) and not torch.equal(k, sub)
    np.testing.assert_array_equal(
        _rng.host_words(sub),
        np.asarray(jax.random.split(jax.random.PRNGKey(0))[1]))
    u = _rng.uniform(sub)
    assert u.dtype == torch.float64 and u.shape == () and 0.0 <= u < 1.0
    assert torch.equal(u, _rng.uniform(sub.clone()))
    z = _rng.normal(sub, (3, 2))
    assert z.dtype == torch.float64 and z.shape == (3, 2)
    assert torch.equal(z, _rng.normal(sub, (3, 2)))


def test_bpg_noise_perturbs_and_is_seed_reproducible(M):
    F_clean = _bpg(M, 0.0, seed=0)
    F_noisy = _bpg(M, 0.5, seed=0)
    assert _differs(F_clean, F_noisy)            # noise reaches the run
    assert _same(F_noisy, _bpg(M, 0.5, seed=0))  # reproducible per seed
    assert _differs(F_noisy, _bpg(M, 0.5, seed=1))  # the seed matters


def test_bpg_no_linesearch_also_noisy(M):
    assert _differs(_bpg(M, 0.0, 0, linesearch=False),
                    _bpg(M, 0.5, 0, linesearch=False))


def test_abpg_gain_noise_threads(M):
    runs = [port.ABPG_gain(*_symnmf(M, noise), gamma=2, maxitrs=20,
                           verbose=False, seed=0)[1] for noise in (0.5, 0.0)]
    assert _differs(*runs)


@pytest.mark.parametrize("name", ["ABPG", "ABPG_expo", "ABDA"])
def test_accelerated_drivers_noise_threads(M, name):
    gamma = 3.0 if name == "ABPG_expo" else 2.0

    def run(noise, seed):
        return getattr(port, name)(*_symnmf(M, noise), gamma, 20,
                                   verbose=False, seed=seed)[1]

    assert _differs(run(0.0, 0), run(0.5, 0))
    assert _same(run(0.5, 2), run(0.5, 2))


def test_fw_descent_noise_threads(M):
    lmo = port.lmo_linf_ball(radius=1, center=1)

    def run(noise):
        f, h, L, X0 = _symnmf(M, noise)
        return port.FW_alg_descent_step(f, h, X0, 25, lmo, verbose=False,
                                        seed=0)[1]

    assert _differs(run(0.0), run(0.5))
    assert _same(run(0.5), run(0.5))


def test_universalgm_oracle_noise_threads(M):
    def run(noise):
        f, h, L, X0 = _symnmf(M, noise)
        return port.UniversalGM(f, h, L, X0, maxitrs=20, verbose=False,
                                noise_level=0, seed=0)[1]

    assert _differs(run(0.0), run(0.5))


def test_aibm_noise_is_seeded():
    np.random.seed(7)
    f, hs, L, x0 = port.Poisson_regr_simplex_acc(80, 40, noise=0.001,
                                                 device="cpu")

    def run(noise, seed):
        return port.AIBM(f, hs[0], L, x0, gamma=2.0, maxitrs=60, noise=noise,
                         seed=seed, verbose=False)[1]

    noisy = run(1e-2, 5)
    assert _same(noisy, run(1e-2, 5))
    assert _differs(noisy, run(1e-2, 6))
    assert _differs(noisy, run(0.0, 5))


def test_deterministic_oracle_unaffected_by_seed():
    f, h, L, x0 = port.D_opt_design(10, 30, randseed=4, device="cpu")
    r1 = port.BPG(f, h, L, x0, maxitrs=30, verbose=False, seed=0)
    r2 = port.BPG(f, h, L, x0, maxitrs=30, verbose=False, seed=5)
    np.testing.assert_array_equal(r1[1], r2[1])


# ---------------------------------------------------------------------------
# replay: the port draws JAX's samples
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def noisy_pair(M):
    np.random.seed(3)
    fj, (hj, _), L, X0j = acc.FrobeniusSymLossResMeasEx(M, 2, noise=0.05)
    return ((fj, hj, L, X0j),
            (from_jax_oracle(fj, device="cpu"), from_jax_oracle(hj), L,
             torch.tensor(np.asarray(X0j))))


REPLAY = {
    "BPG": lambda pkg, f, h, L, x0: pkg.BPG(f, h, L, x0, 25, verbose=False,
                                           seed=0),
    "ABPG_gain": lambda pkg, f, h, L, x0: pkg.ABPG_gain(
        f, h, L, x0, 2.0, 20, verbose=False, seed=0),
    "AIBM": lambda pkg, f, h, L, x0: pkg.AIBM(
        f, h, L, x0, gamma=2.0, maxitrs=25, noise=1e-3, verbose=False,
        seed=2),
    "UniversalGM": lambda pkg, f, h, L, x0: pkg.UniversalGM(
        f, h, L, x0, 25, noise_level=0.05, verbose=False, seed=1),
    "FW_alg_descent_step": lambda pkg, f, h, L, x0: pkg.FW_alg_descent_step(
        f, h, x0, 25, pkg.lmo_linf_ball(1.0, 1.0), verbose=False, seed=0),
}


@pytest.mark.parametrize("name", list(REPLAY))
def test_noisy_runs_replay_jax(noisy_pair, name):
    rj = REPLAY[name](acc, *noisy_pair[0])
    rp = REPLAY[name](port, *noisy_pair[1])
    Fj, Fp = np.asarray(rj[1]), np.asarray(rp[1])
    assert len(Fp) == len(Fj)
    np.testing.assert_allclose(Fp, Fj, rtol=1e-11, atol=0)


# ---------------------------------------------------------------------------
# noisy checkpoints resume bit for bit
# ---------------------------------------------------------------------------


RESUME = {
    "BPG": lambda f, h, L, x0, it, **kw: port.BPG(f, h, L, x0, it, seed=4,
                                                  **kw),
    "ABPG_gain": lambda f, h, L, x0, it, **kw: port.ABPG_gain(
        f, h, L, x0, 2.0, it, seed=4, **kw),
    "FW_alg_descent_step": lambda f, h, L, x0, it, **kw:
        port.FW_alg_descent_step(f, h, x0, it, port.lmo_linf_ball(1.0, 1.0),
                                 seed=4, **kw),
    "AIBM": lambda f, h, L, x0, it, **kw: port.AIBM(
        f, h, L, x0, 2.0, it, noise=1e-3, seed=4, **kw),
}


@pytest.mark.parametrize("name", list(RESUME))
def test_noisy_checkpoint_resumes_bit_exactly(M, tmp_path, name):
    prob = _symnmf(M, 0.5)
    ck = str(tmp_path / f"{name}.npz")
    RESUME[name](*prob, 10, chunk=5, checkpoint=ck, verbose=False)
    with np.load(ck) as z:
        assert z["c::key"].dtype == np.uint32
    resumed = RESUME[name](*prob, 20, chunk=5, checkpoint=ck, verbose=False)
    straight = RESUME[name](*prob, 20, chunk=5, verbose=False)
    np.testing.assert_array_equal(resumed[1], straight[1])
    assert torch.equal(resumed[0], straight[0])
