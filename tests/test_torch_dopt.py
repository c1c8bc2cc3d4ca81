"""The port's exact FP64 D-opt engine against the JAX exact engine.

Same numpy inputs through ``accbpg_and_fw_tpu`` (CPU, float64 — see
conftest.py) and ``accbpg_and_fw_tpu_torch`` (CPU, float64).  The two
differ only in the order of BLAS sums, so state parity is held at atol
1e-12 over the first 200 iterations; the D-opt endgame is chaotic, so past
that only iterations-to-eps are compared.
"""

import inspect

import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu as acc
import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu_torch.algorithms import d_opt as port_dopt

from test_torch_lazy import keep_jax_exec_cache  # noqa: F401 (autouse)

torch.set_num_threads(1)

STATE_ATOL = 1e-12


@pytest.fixture(scope="module")
def small():
    V = np.random.default_rng(3).standard_normal((12, 160))
    return V, np.full(160, 1.0 / 160)


@pytest.fixture(scope="module")
def golden():
    """30x300 seed-10 design (tests/test_algorithms.py:153)."""
    f, h, L, x0 = acc.D_opt_design(30, 300, randseed=10)
    return np.asarray(f.H), np.asarray(x0)


def _solvers(away):
    return ((acc.D_opt_FW_away, port.D_opt_FW_away) if away
            else (acc.D_opt_FW, port.D_opt_FW))


@pytest.mark.parametrize("away", [True, False], ids=["away", "plain"])
def test_state_parity_first_200(small, away, tmp_path):
    """x, w, F, SP and SN agree to atol 1e-12 over 200 iterations (w read
    from each package's own end-of-run checkpoint carry)."""
    V, x0 = small
    jax_fn, port_fn = _solvers(away)
    ck_j, ck_p = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    xj, Fj, SPj, SNj, _ = jax_fn(V, x0, 1e-8, 200, verbose=False, chunk=64,
                                 checkpoint=ck_j)
    xp, Fp, SPp, SNp, _ = port_fn(V, x0, 1e-8, 200, verbose=False, chunk=64,
                                  checkpoint=ck_p, device="cpu")
    assert len(Fj) == len(Fp) == 200
    assert isinstance(xp, torch.Tensor) and xp.dtype == torch.float64
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=0,
                               atol=STATE_ATOL)
    for a, b in ((Fp, Fj), (SPp, SPj), (SNp, SNj)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=STATE_ATOL)
    with np.load(ck_j) as zj, np.load(ck_p) as zp:
        np.testing.assert_allclose(zp["c::w"], zj["c::w"], rtol=0,
                                   atol=STATE_ATOL)


def test_golden_iterations_to_eps(golden):
    """30x300 seed 10, eps=1e-7: iterations-to-eps equal to the JAX
    engine's (at most 1% apart, printed), and the final state certified by
    a fresh factorization."""
    V, x0 = golden
    _, Fj, *_ = acc.D_opt_FW_away(V, x0, eps=1e-7, maxitrs=20000,
                                  verbose=False, chunk=1000)
    x, F, SP, SN, T = port.D_opt_FW_away(V, x0, eps=1e-7, maxitrs=20000,
                                         verbose=False, chunk=1000,
                                         device="cpu")
    print(f"iterations to eps: jax {len(Fj)}, port {len(F)}, "
          f"difference {len(F) - len(Fj)}")
    assert abs(len(F) - len(Fj)) <= 0.01 * len(Fj)
    assert SP[-1] <= 1e-7 and SN[-1] <= 1e-7
    xs = x.numpy()
    assert xs.sum() == pytest.approx(1.0, abs=1e-8)
    _, fresh = np.linalg.slogdet((V * xs) @ V.T)
    assert abs(F[-1] - (-fresh)) < 1e-6
    assert len(T) == len(F) and np.all(np.diff(T) >= 0)


def test_truncation_inclusive_stop():
    V = np.random.default_rng(11).standard_normal((8, 64))
    x0 = np.full(64, 1.0 / 64)
    eps = 1e-3
    _, Fj, *_ = acc.D_opt_FW_away(V, x0, eps, 500, verbose=False, chunk=50)
    x, F, SP, SN, T = port.D_opt_FW_away(V, x0, eps, 500, verbose=False,
                                         chunk=50, device="cpu")
    assert len(F) == len(Fj) < 500
    assert len(F) == len(SP) == len(SN) == len(T)
    assert SP[-1] <= eps and SN[-1] <= eps
    assert not ((SP[:-1] <= eps) & (SN[:-1] <= eps)).any()


def test_chunk_size_does_not_change_the_run(small):
    V, x0 = small
    a = port.D_opt_FW_away(V, x0, 1e-8, 90, verbose=False, chunk=7,
                           device="cpu")
    b = port.D_opt_FW_away(V, x0, 1e-8, 90, verbose=False, device="cpu")
    assert torch.equal(a[0], b[0])
    for i in (1, 2, 3):
        np.testing.assert_array_equal(a[i], b[i])


def test_refresh_every_matches_jax(small):
    """Refactorization at chunk boundaries, as the JAX engine does it."""
    V, x0 = small
    xj, Fj, *_ = acc.D_opt_FW_away(V, x0, 1e-8, 150, verbose=False,
                                   chunk=25, refresh_every=50)
    xp, Fp, *_ = port.D_opt_FW_away(V, x0, 1e-8, 150, verbose=False,
                                    chunk=25, refresh_every=50, device="cpu")
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=0,
                               atol=STATE_ATOL)
    np.testing.assert_allclose(Fp, Fj, rtol=0, atol=STATE_ATOL)
    # and a refresh moves the run by rounding only
    x0p, F0p, *_ = port.D_opt_FW_away(V, x0, 1e-8, 150, verbose=False,
                                      chunk=25, device="cpu")
    np.testing.assert_allclose(Fp, F0p, rtol=0, atol=1e-10)


def test_refresh_every_calls_factorization(small, monkeypatch):
    V, x0 = small
    calls = []
    real = port_dopt._dopt_factorize

    def spy(V_, x_):
        calls.append(1)
        return real(V_, x_)

    monkeypatch.setattr(port_dopt, "_dopt_factorize", spy)
    port.D_opt_FW_away(V, x0, 1e-8, 100, verbose=False, chunk=10,
                       refresh_every=30, device="cpu")
    # initial + refreshes at k = 30, 60, 90 (chunk boundaries)
    assert len(calls) == 4


def test_checkpoint_resume_reproduces_uninterrupted(small, tmp_path):
    V, x0 = small
    ck = str(tmp_path / "exact.npz")
    full = port.D_opt_FW_away(V, x0, 1e-8, 120, verbose=False, chunk=16,
                              device="cpu")
    part = port.D_opt_FW_away(V, x0, 1e-8, 45, verbose=False, chunk=16,
                              checkpoint=ck, device="cpu")
    assert len(part[1]) == 45
    resumed = port.D_opt_FW_away(V, x0, 1e-8, 120, verbose=False, chunk=16,
                                 checkpoint=ck, device="cpu")
    assert torch.equal(resumed[0], full[0])
    for i in (1, 2, 3):
        np.testing.assert_array_equal(resumed[i], full[i])


def test_checkpoint_refuses_other_solver(small, tmp_path):
    V, x0 = small
    ck = str(tmp_path / "away.npz")
    port.D_opt_FW_away(V, x0, 1e-8, 20, verbose=False, checkpoint=ck,
                       device="cpu")
    with pytest.raises(ValueError, match="different solver"):
        port.D_opt_FW(V, x0, 1e-8, 40, verbose=False, checkpoint=ck,
                      device="cpu")


def test_verbose_table(small, capsys):
    V, x0 = small
    port.D_opt_FW_away(V, x0, 1e-8, 12, verbose=True, verbskip=5, device="cpu")
    out = capsys.readouterr().out
    assert "Frank-Wolfe method with away steps" in out
    assert "pos_slack   neg_slack" in out
    rows = [ln for ln in out.splitlines() if ln[:6].strip().isdigit()]
    assert [int(r[:6]) for r in rows] == [0, 5, 10]
    acc.D_opt_FW_away(V, x0, 1e-8, 12, verbose=True, verbskip=5)
    jax_rows = [ln for ln in capsys.readouterr().out.splitlines()
                if ln[:6].strip().isdigit()]
    # same format: equal up to the wall-time column
    assert [r[:42] for r in rows] == [r[:42] for r in jax_rows]


@pytest.mark.parametrize("mode", ["ds", "mixed", "auto"])
def test_u_mode_aliases_resolve_to_exact(small, mode):
    V, x0 = small
    ref = port.D_opt_FW_away(V, x0, 1e-8, 30, verbose=False, u_mode="exact",
                             device="cpu")
    got = port.D_opt_FW_away(V, x0, 1e-8, 30, verbose=False, u_mode=mode,
                             device="cpu")
    assert torch.equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


def test_u_mode_pallas_not_ported(small):
    """u_mode="pallas" is ported now: it runs the dense block engine (its
    plain block on the CPU), which follows the exact engine; unknown names
    still raise."""
    V, x0 = small
    x, F, *_ = port.D_opt_FW(V, x0, 1e-8, 10, verbose=False, u_mode="pallas",
                             device="cpu")
    xe, Fe, *_ = port.D_opt_FW(V, x0, 1e-8, 10, verbose=False,
                               u_mode="exact", device="cpu")
    np.testing.assert_allclose(F, Fe, rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(x.numpy(), xe.numpy(), rtol=0,
                               atol=STATE_ATOL)
    with pytest.raises(ValueError, match="unknown u_mode"):
        port.D_opt_FW(V, x0, 1e-8, 10, verbose=False, u_mode="fast",
                      device="cpu")


@pytest.mark.parametrize("name", ["D_opt_FW", "D_opt_FW_away"])
def test_public_signature_matches_jax(name):
    pj = list(inspect.signature(getattr(acc, name)).parameters.items())
    pp = list(inspect.signature(getattr(port, name)).parameters.items())
    assert [(k, v.default) for k, v in pp[:len(pj)]] == \
        [(k, v.default) for k, v in pj]
    assert [k for k, _ in pp[len(pj):]] == ["device"]
