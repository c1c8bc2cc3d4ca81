"""Which engine ``u_mode="auto"`` and ``precision="auto"`` pick for a design
on a CUDA device, decided on the CPU from a given SM count and
shared-memory limit: the lazy-H kernel for single designs of 1.8M elements
and more where it takes them (m within its 16384 and a launch plan that
fits); below that size, and for sweeps, the dense kernel where its layout
keeps V and H in shared memory, else the lazy-H kernel where it takes the
shape (the walls measured on an H100, PERF.md); the FP64 exact engine
where no kernel takes the design, as the JAX package falls back to its
"ds" engine past its kernel's memory budget.  The designs are meta tensors
(shapes without memory).  The tests marked ``cuda`` solve on the card: a
design no kernel takes, and the 30x1000 shapes that "auto" sends to the
dense kernel.
"""

import numpy as np
import pytest
import torch

from accbpg_and_fw_tpu_torch import D_opt_FW_away
from accbpg_and_fw_tpu_torch.algorithms.d_opt import _resolve_auto_u_mode
from accbpg_and_fw_tpu_torch.ops import dopt_dense as dd
from accbpg_and_fw_tpu_torch.ops import dopt_lazy as dl
from accbpg_and_fw_tpu_torch.parallel.batched import (
    _resolve_auto_batch_precision)

H100 = (132, 232448)  # SMs, shared-memory opt-in per CTA (bytes)
CUDA = torch.device("cuda")


def _meta(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("shape,limits,engine", [
    ((1000, 5000), H100, "pallas_lazy"),
    ((16384, 20000), H100, "pallas_lazy"),
    ((16385, 20000), H100, "exact"),       # past the kernel's m
    ((20000, 40000), H100, "exact"),       # 6.4 GB in FP64: fits the card
    ((1000, 5000), (132, 8000), "exact"),  # the plan's fixed part does not
    ((100, 1000), (132, 2000), "exact"),   # below 1.8M, no plan fits
])
def test_auto_u_mode_routing(shape, limits, engine):
    assert _resolve_auto_u_mode(_meta(*shape), "auto", CUDA,
                                limits=limits) == engine


def test_auto_u_mode_on_the_cpu_is_exact():
    assert _resolve_auto_u_mode(_meta(1000, 5000), "auto",
                                torch.device("cpu")) == "exact"
    for mode in ("exact", "ds", "mixed"):
        assert _resolve_auto_u_mode(_meta(20000, 40000), mode, CUDA,
                                    limits=H100) == "exact"


@pytest.mark.parametrize("shape,limits,engine", [
    ((3, 1000, 2000), H100, "pallas_lazy"),
    ((3, 63, 2000), (132, 2000), "native"),  # neither kernel's plan fits
    ((2, 16385, 17000), H100, "native"),    # past the kernel's m
    ((200, 1000, 2000), H100, "pallas_lazy"),
    ((3, 1000, 2000), (132, 8000), "native"),
])
def test_auto_batch_precision_routing(shape, limits, engine):
    assert _resolve_auto_batch_precision(_meta(*shape), CUDA,
                                         limits=limits) == engine


# below 1.8M elements: the H100 walls (PERF.md) put the dense kernel ahead
# where its layout keeps V resident (30x1000, 100x1000) and the lazy kernel
# ahead where the dense layout streams V (200x1000)
@pytest.mark.parametrize("shape,limits,engine", [
    ((30, 1000), H100, "pallas"),
    ((100, 1000), H100, "pallas"),
    ((200, 1000), H100, "pallas_lazy"),
    ((1000, 1799), H100, "pallas_lazy"),
    ((5000, 300), H100, "pallas_lazy"),    # past the dense kernel's m
    ((100, 1000), (132, 8000), "pallas_lazy"),  # dense would stream V
])
def test_auto_u_mode_below_the_lazy_size(shape, limits, engine):
    assert _resolve_auto_u_mode(_meta(*shape), "auto", CUDA,
                                limits=limits) == engine


@pytest.mark.parametrize("shape,limits,engine", [
    ((32, 30, 1000), H100, "pallas"),       # the dense sweep
    ((3, 64, 1000), H100, "pallas"),
    ((3, 100, 1000), H100, "pallas"),
    ((3, 200, 1000), H100, "pallas_lazy"),
    ((3, 1000, 2000), H100, "pallas_lazy"),  # the large-m sweep
])
def test_auto_batch_precision_from_the_walls(shape, limits, engine):
    assert _resolve_auto_batch_precision(_meta(*shape), CUDA,
                                         limits=limits) == engine


def test_dense_layout():
    assert dd.dense_layout(1, 30, 1000, H100) == "resident"
    assert dd.dense_layout(1, 200, 1000, H100) == "streamed"
    assert dd.dense_layout(1, dd._MAX_M + 1, 5000, H100) is None
    assert dd.dense_layout(1, 30, 1000, (132, 2000)) is None
    assert dd.dense_layout(1, 30, 1000, None) is None  # no card to ask


def test_lazy_fits_is_launch_plan_acceptance():
    assert dl.lazy_fits(1000, 5000, 1, H100)
    assert not dl.lazy_fits(dl._MAX_M + 1, 20000, 1, H100)
    with pytest.raises(ValueError, match="shared memory"):
        dl.launch_plan(1000, 5000, dl._KR, 1, 132, 8000)
    assert not dl.lazy_fits(1000, 5000, 1, (132, 8000))
    # no card to ask: the bound on m alone
    assert dl.lazy_fits(dl._MAX_M, 20000, 1, None)
    assert not dl.lazy_fits(dl._MAX_M + 1, 20000, 1, None)


@pytest.mark.cuda
def test_auto_solves_a_design_past_the_lazy_kernel_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m, n = dl._MAX_M + 16, dl._MAX_M + 200
    V = torch.randn(m, n, dtype=torch.float64, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    before = dl.LAUNCHES
    x, F, SP, SN, _ = D_opt_FW_away(V, torch.full((n,), 1.0 / n,
                                                  dtype=torch.float64,
                                                  device="cuda"),
                                    1e-8, 4, verbose=False)
    assert dl.LAUNCHES == before  # the exact engine, not the kernel
    assert len(F) == 4 and np.all(np.isfinite(F)) and F[-1] < F[0]
    assert abs(float(x.sum()) - 1.0) < 1e-12


def _design(m, n, seed):
    np.random.seed(seed)
    return np.random.randn(m, n)


@pytest.mark.cuda
def test_auto_single_30x1000_runs_the_dense_kernel_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    V = _design(30, 1000, 1)
    before = dd.LAUNCHES
    x, F, SP, SN, _ = D_opt_FW_away(V, np.full(1000, 1e-3), 1e-8, 20000,
                                    verbose=False)
    assert dd.LAUNCHES > before
    assert SP[-1] <= 1e-8 and SN[-1] <= 1e-8
    xs = x.cpu().numpy() / float(x.sum())
    _, ld = np.linalg.slogdet((V * xs) @ V.T)
    assert abs(-ld - F[-1]) <= 1e-9 * abs(F[-1])


@pytest.mark.cuda
def test_auto_sweep_30x1000_runs_the_dense_batch_kernel_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from accbpg_and_fw_tpu_torch import dopt_fw_batch

    Vs = np.stack([_design(30, 1000, k + 1) for k in range(4)])
    before = dd.LAUNCHES
    x, F, SP, SN = dopt_fw_batch(Vs, np.full((4, 1000), 1e-3), 1e-8, 20000,
                                 precision="auto")
    assert dd.LAUNCHES > before
    assert np.all(SP[:, -1] <= 1e-8) and np.all(SN[:, -1] <= 1e-8)
