"""The one-kernel Burg-simplex multiplier (``ops/simplex.py``, the port of
``accbpg_and_fw_tpu/ops/pallas_kernels.py``).

On the CPU ``simplex_inv_multiplier_pallas`` runs its plain version.  It
is held against the TPU kernel's body ``_simplex_kernel`` run in float64:
the test builds its ``pl.pallas_call`` with ``interpret=True`` and a
float64 output, which changes nothing in the JAX package.  Bar: rtol
1e-13 (the same 64 + 24 steps; only the sums' order differs).  The JAX
package's own float32 entry is held to ``tests/test_pallas.py``'s bars
(|sum x - 1| < 1e-5, c within 1e-3 relative).

The tests marked ``cuda`` hold the Hopper kernel against the plain version
on the card: c to rtol 1e-12, or, where the two froze at different Newton
steps, both residuals within 1e-8 (the kernel's stall threshold).  Run
them with ``python -m pytest --noconftest -m cuda tests/test_torch_simplex.py``.
"""

import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu_torch.ops import simplex as sm

torch.set_num_threads(1)

STALL = 1e-8


def _gg(n, seed=0, inf_every=0):
    gg = np.random.default_rng(seed).standard_normal(n) * 3.0 + 1.0
    if inf_every:
        gg[1::inf_every] = np.inf
    return gg


def _jax_kernel_f64(gg):
    """``_simplex_kernel`` in float64 through an interpret-mode
    ``pallas_call`` (the JAX entry casts to float32)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from accbpg_and_fw_tpu.ops.pallas_kernels import _LANE, _simplex_kernel

    pad = (-gg.size) % _LANE
    g = np.concatenate([gg, np.full(pad, np.inf)]).reshape(1, -1)
    out = pl.pallas_call(
        _simplex_kernel,
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float64),
        interpret=True)(jnp.asarray(g, jnp.float64))
    return float(out[0, 0])


def _resid(gg, c):
    return float(np.sum(1.0 / (gg + c)) - 1.0)


@pytest.mark.parametrize("n,inf_every", [(7, 3), (100, 0), (1111, 10),
                                         (10000, 7)])
def test_plain_matches_jax_kernel_body_f64(n, inf_every):
    gg = _gg(n, seed=n, inf_every=inf_every)
    c_ref = _jax_kernel_f64(gg)
    before = sm.LAUNCHES
    c = sm.simplex_inv_multiplier_pallas(torch.tensor(gg))
    assert sm.LAUNCHES == before  # a CPU tensor takes the plain version
    assert c.dim() == 0 and c.dtype == torch.float64
    np.testing.assert_allclose(float(c), c_ref, rtol=1e-13)
    assert abs(_resid(gg, float(c))) <= STALL + n * 2.0**-52


@pytest.mark.parametrize("n", [100, 200, 1000, 1111])
def test_jax_f32_entry_within_its_bars(n):
    """The JAX package's float32 kernel against the port on the same
    float32-rounded input (tests/test_pallas.py's bars)."""
    import jax.numpy as jnp

    from accbpg_and_fw_tpu.ops.pallas_kernels import (
        simplex_inv_multiplier_pallas)

    gg32 = _gg(n, seed=0).astype(np.float32)
    c32 = float(simplex_inv_multiplier_pallas(jnp.asarray(gg32),
                                              interpret=True))
    gg = gg32.astype(np.float64)
    c = float(sm.simplex_inv_multiplier_pallas(torch.tensor(gg)))
    assert abs(np.sum(1.0 / (gg + c32)) - 1.0) < 1e-5
    assert abs(c32 - c) <= 1e-3 * max(1.0, abs(c))


# n = 1 inputs where cmin + 1 leaves a residual one rounding below 0, so
# the bisection does move c (and two where it does not)
BISECT_MOVES = (-1.3210486329130189, -7.354832923422751)
BISECT_IDLE = (0.1, 3.3)


def test_reference_keeps_the_bisection():
    """The plain version runs every bisection step as the TPU kernel does,
    including the inputs where the bisection is not idle."""
    for g in BISECT_MOVES + BISECT_IDLE:
        gg = np.array([g])
        assert (_resid(gg, -g + 1.0) < 0) == (g in BISECT_MOVES)
        c = float(sm.simplex_multiplier_reference(torch.tensor(gg)))
        assert c == _jax_kernel_f64(gg)
        assert abs(_resid(gg, c)) <= STALL


def test_wrapper_checks_its_input():
    with pytest.raises(ValueError, match="1-d"):
        sm.simplex_inv_multiplier_pallas(torch.zeros((2, 2),
                                                     dtype=torch.float64))
    with pytest.raises(ValueError, match="empty"):
        sm.simplex_inv_multiplier_pallas(torch.zeros(0, dtype=torch.float64))
    with pytest.raises(ValueError, match="cpu or cuda"):
        sm.simplex_inv_multiplier_pallas(torch.zeros(4, device="meta"))


def test_use_pallas_prox_on_cpu():
    """``BurgEntropySimplex(use_pallas=True)`` on the CPU runs the plain
    kernel version; its point is the default prox's root to the kernel's
    1e-8 stall threshold."""
    g = torch.tensor(_gg(500, seed=3))
    x_k = port.BurgEntropySimplex(use_pallas=True).prox_map(g, 1.3)
    x_d = port.BurgEntropySimplex().prox_map(g, 1.3)
    assert abs(float(x_k.sum()) - 1.0) <= STALL
    np.testing.assert_allclose(x_k.numpy(), x_d.numpy(), rtol=1e-7)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kernel_vs_plain(gg, dev):
    t = torch.tensor(gg, device=dev)
    before = sm.LAUNCHES
    c = sm.simplex_inv_multiplier_pallas(t)
    torch.cuda.synchronize()
    assert sm.LAUNCHES == before + 1
    assert c.device.type == "cuda" and c.dim() == 0
    c_k = float(c)
    c_p = float(sm.simplex_multiplier_reference(t))
    if abs(c_k - c_p) > 1e-12 * abs(c_p):
        # the two froze at different Newton steps
        assert abs(_resid(gg, c_k)) <= STALL + gg.size * 2.0**-52
        assert abs(_resid(gg, c_p)) <= STALL + gg.size * 2.0**-52
    return c_k, c_p


@pytest.mark.cuda
@pytest.mark.parametrize("n,inf_every", [
    (1, 0), (2, 0), (31, 0), (1000, 0), (1023, 5), (1025, 0), (10000, 7),
    (29000, 0), (40000, 3), (100000, 0)])
def test_kernel_matches_plain(cuda_dev, n, inf_every):
    """n = 1, non-multiples of the block, +inf entries, and n past the
    shared-memory limit (about 29,000)."""
    _kernel_vs_plain(_gg(n, seed=n, inf_every=inf_every), cuda_dev)


@pytest.mark.cuda
@pytest.mark.parametrize("g", BISECT_MOVES + BISECT_IDLE)
def test_kernel_bisection_at_n1(cuda_dev, g):
    c_k, c_p = _kernel_vs_plain(np.array([g]), cuda_dev)
    assert c_k == c_p


@pytest.mark.cuda
def test_cuda_never_takes_the_plain_version(cuda_dev, monkeypatch):
    def refuse(gg):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(sm, "simplex_multiplier_reference", refuse)
    g = torch.tensor(_gg(3000, seed=9), device=cuda_dev)
    before = sm.LAUNCHES
    x = port.BurgEntropySimplex(use_pallas=True).prox_map(g, 1.0)
    torch.cuda.synchronize()
    assert sm.LAUNCHES == before + 1
    assert abs(float(x.sum()) - 1.0) <= STALL + 3000 * 2.0**-52


@pytest.mark.cuda
def test_kernel_is_deterministic(cuda_dev):
    g = torch.tensor(_gg(20000, seed=4), device=cuda_dev)
    cs = {float(sm.simplex_inv_multiplier_pallas(g)) for _ in range(5)}
    assert len(cs) == 1
