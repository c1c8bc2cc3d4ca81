"""A run started in the JAX package continues in the port.

JAX runs k iterations and hands its state over (``from_jax_carry``, or a
checkpoint file read directly); the port continues and must match JAX
continuing.  Bars: the exact engines at atol 1e-12 (as in
test_torch_dopt.py); the double-single and lazy-kernel engines at SP atol
1e-9 and x atol 1e-11 (as in test_torch_lazy.py).
"""

import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu as acc
import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu.ops.pallas_dopt import dopt_fw_pallas
from accbpg_and_fw_tpu.ops.pallas_dopt_lazy import dopt_fw_pallas_lazy
from accbpg_and_fw_tpu_torch.interop import continue_dopt, from_jax_carry
from accbpg_and_fw_tpu_torch.ops.dopt_dense import dopt_fw_dense

from test_torch_lazy import keep_jax_exec_cache  # noqa: F401 (autouse)

torch.set_num_threads(1)

K, TOTAL = 50, 120


@pytest.fixture(scope="module")
def problem():
    V = np.random.default_rng(3).standard_normal((12, 160))
    return V, np.full(160, 1.0 / 160)


def _jax_carry(path):
    with np.load(path) as z:
        return {n[3:]: z[n] for n in z.files if n.startswith("c::")}


def test_exact_carry_continues(problem, tmp_path):
    V, x0 = problem
    ck = str(tmp_path / "jax.npz")
    acc.D_opt_FW_away(V, x0, 1e-8, K, verbose=False, chunk=25, checkpoint=ck)
    state = from_jax_carry(_jax_carry(ck), device="cpu")
    assert set(state) == {"done", "x", "w", "H", "logdet"}
    assert all(t.dtype in (torch.float64, torch.bool) for t in state.values())
    x, F, SP, SN, T = continue_dopt(V, state, 1e-8, TOTAL, k_start=K,
                                    chunk=25, device="cpu")
    xj, Fj, SPj, SNj, _ = acc.D_opt_FW_away(V, x0, 1e-8, TOTAL,
                                            verbose=False, chunk=25)
    assert len(F) == TOTAL - K
    for a, b in ((F, Fj), (SP, SPj), (SN, SNj)):
        np.testing.assert_allclose(a, np.asarray(b)[K:], rtol=0, atol=1e-12)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-12)


def test_ds_carry_continues(problem, tmp_path):
    """The double-single engine's (hi, lo) pairs, summed in f64."""
    V, x0 = problem
    ck = str(tmp_path / "ds.npz")
    acc.D_opt_FW_away(V, x0, 1e-8, K, verbose=False, chunk=25, u_mode="ds",
                      checkpoint=ck)
    carry = _jax_carry(ck)
    assert "x_hi" in carry
    state = from_jax_carry(carry, device="cpu")
    np.testing.assert_array_equal(
        state["x"].numpy(),
        carry["x_hi"].astype(np.float64) + carry["x_lo"].astype(np.float64))
    x, F, SP, SN, T = continue_dopt(V, state, 1e-8, TOTAL, k_start=K,
                                    device="cpu")
    xj, Fj, SPj, SNj, _ = acc.D_opt_FW_away(V, x0, 1e-8, TOTAL,
                                            verbose=False, chunk=25,
                                            u_mode="ds")
    # the DS engine's SP history is float32: compare after the same rounding
    np.testing.assert_allclose(SP.astype(np.float32).astype(np.float64),
                               np.asarray(SPj, np.float64)[K:], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-11)


def test_port_resumes_jax_driver_checkpoint(problem, tmp_path):
    """The exact engine's checkpoint file, read by the port's driver."""
    V, x0 = problem
    ck = str(tmp_path / "jax.npz")
    _, Fk, *_ = acc.D_opt_FW_away(V, x0, 1e-8, K, verbose=False, chunk=25,
                                  checkpoint=ck)
    x, F, SP, SN, T = port.D_opt_FW_away(V, x0, 1e-8, TOTAL, verbose=False,
                                         chunk=25, checkpoint=ck, device="cpu")
    xj, Fj, *_ = acc.D_opt_FW_away(V, x0, 1e-8, TOTAL, verbose=False,
                                   chunk=25)
    assert len(F) == TOTAL
    np.testing.assert_array_equal(F[:K], np.asarray(Fk))
    np.testing.assert_allclose(F, Fj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-12)


def test_port_resumes_jax_lazy_checkpoint(problem, tmp_path):
    """A ``dopt_fw_pallas_lazy`` checkpoint resumed by the port's lazy
    engine matches the JAX kernel resuming the same file."""
    V, x0 = problem
    ck_j, ck_p = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    a = dopt_fw_pallas_lazy(V, x0, 1e-8, 40, verbose=False, interpret=True,
                            group=1, checkpoint=ck_j)
    with open(ck_j, "rb") as src, open(ck_p, "wb") as dst:
        dst.write(src.read())
    state = from_jax_carry(ck_p, device="cpu")
    assert state["k"] == 40
    np.testing.assert_array_equal(state["x"].numpy(), np.asarray(a[0]))
    xp, Fp, SPp, *_ = port.D_opt_FW_away(V, x0, 1e-8, 80, verbose=False,
                                         u_mode="pallas_lazy",
                                         checkpoint=ck_p, device="cpu")
    xj, Fj, SPj, *_ = dopt_fw_pallas_lazy(V, x0, 1e-8, 80, verbose=False,
                                          interpret=True, group=1,
                                          checkpoint=ck_j)
    assert len(Fp) == len(Fj) == 80
    np.testing.assert_array_equal(SPp[:40], np.asarray(a[2]))
    np.testing.assert_allclose(SPp.astype(np.float32).astype(np.float64),
                               np.asarray(SPj, np.float64), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-11)


def test_continue_from_lazy_iterate(problem, tmp_path):
    """``continue_dopt`` on a lazy checkpoint refactorizes from its iterate
    and continues in the exact engine."""
    V, x0 = problem
    ck = str(tmp_path / "jax.npz")
    dopt_fw_pallas_lazy(V, x0, 1e-8, 40, verbose=False, interpret=True,
                        group=1, checkpoint=ck)
    x, F, *_ = continue_dopt(V, from_jax_carry(ck, device="cpu"), 1e-8, 80,
                             k_start=40, device="cpu")
    xe, Fe, *_ = acc.D_opt_FW_away(V, x0, 1e-8, 80, verbose=False)
    assert len(F) == 40
    np.testing.assert_allclose(F, np.asarray(Fe)[40:], rtol=1e-9)
    np.testing.assert_allclose(x.numpy(), np.asarray(xe), rtol=0, atol=1e-11)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dense_checkpoint_resumes_in_either_package(problem, tmp_path,
                                                    writer):
    """A dense-engine checkpoint (``dopt_fw_pallas`` format) written by one
    package and resumed by the other matches the writer resuming it (both
    refactorize from the saved iterate)."""
    V, x0 = problem
    ck = str(tmp_path / "dense.npz")
    kw = dict(verbose=False, chunk=64, checkpoint=ck)
    if writer == "jax":
        a = dopt_fw_pallas(V, x0, 1e-8, 64, interpret=True, **kw)
    else:
        a = port.D_opt_FW_away(V, x0, 1e-8, 64, u_mode="pallas",
                               device="cpu", **kw)
    state = from_jax_carry(ck, device="cpu")
    assert state["k"] == 64
    np.testing.assert_array_equal(state["x"].numpy(), np.asarray(a[0]))
    with open(ck, "rb") as src:
        saved = src.read()
    xp, Fp, SPp, *_ = dopt_fw_dense(V, x0, 1e-8, 128, device="cpu", **kw)
    with open(ck, "wb") as dst:
        dst.write(saved)
    xj, Fj, SPj, *_ = dopt_fw_pallas(V, x0, 1e-8, 128, interpret=True, **kw)
    assert len(Fp) == len(Fj) == 128
    np.testing.assert_array_equal(SPp[:64], np.asarray(a[2], np.float64))
    np.testing.assert_array_equal(np.asarray(SPj[:64], np.float64),
                                  np.asarray(a[2], np.float64))
    np.testing.assert_allclose(SPp, np.asarray(SPj, np.float64),
                               rtol=2.0 ** -24, atol=1e-9)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-11)


def test_unrecognised_carry_raises(tmp_path):
    with pytest.raises(ValueError, match="unrecognised"):
        from_jax_carry({"x": np.zeros(3)}, device="cpu")
    other = str(tmp_path / "other.npz")
    np.savez(other, __v=np.asarray(1), __fp=np.asarray("something|else"),
             x=np.zeros(3))
    with pytest.raises(ValueError, match="not a block-engine checkpoint"):
        from_jax_carry(other, device="cpu")
