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
