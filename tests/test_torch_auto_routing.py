"""Which engine ``u_mode="auto"`` and ``precision="auto"`` pick for a design
on a CUDA device, decided on the CPU from a given SM count and
shared-memory limit: the lazy-H kernel where it takes the design (m within
its 16384 and a launch plan that fits), the FP64 exact engine otherwise,
as the JAX package falls back to its "ds" engine past its kernel's memory
budget.  The designs are meta tensors (shapes without memory).  One test
marked ``cuda`` solves a design the kernel cannot take on the card.
"""

import numpy as np
import pytest
import torch

from accbpg_and_fw_tpu_torch import D_opt_FW_away
from accbpg_and_fw_tpu_torch.algorithms.d_opt import _resolve_auto_u_mode
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
    ((100, 1000), H100, "exact"),          # below 1.8M elements
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
    ((3, 63, 2000), H100, "native"),        # below m = 64
    ((2, 16385, 17000), H100, "native"),    # past the kernel's m
    ((200, 1000, 2000), H100, "pallas_lazy"),
    ((3, 1000, 2000), (132, 8000), "native"),
])
def test_auto_batch_precision_routing(shape, limits, engine):
    assert _resolve_auto_batch_precision(_meta(*shape), CUDA,
                                         limits=limits) == engine


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
