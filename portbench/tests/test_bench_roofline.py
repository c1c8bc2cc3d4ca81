"""The work counts against hand-computed values, and against the
formulas of ``chip_smoke.py`` they were copied from."""

import importlib.util

import pytest

from conftest import ROOT
from portbench.core.registry import load_module

lazy = load_module("roofline", "dopt_lazy_kernel")
dense = load_module("roofline", "dopt_dense_kernel")
simplex = load_module("roofline", "simplex_mult_kernel")
peaks = load_module("roofline", "peaks")


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_bounds", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lazy_block_by_hand():
    m, n, nrun = 4, 10, 3
    nbytes, flops = lazy.block_work(m, n, [nrun])
    assert nbytes == 8 * (40 + 16 + 40 + 3 * 5 + 4 + 5 * 256)
    # 3 (2 m n + 2 m^2 + 8 n) + 4 m (0 + 1 + 2)
    assert flops == 3 * (80 + 32 + 80) + 4 * 4 * 3
    assert lazy.block_work(m, n, [0, 0]) == (0, 0)


def test_lazy_solve_splits_into_blocks():
    m, n = 6, 20
    nb, fl = lazy.solve_work(m, n, [300, 100])
    b0 = lazy.block_work(m, n, [256, 100])
    b1 = lazy.block_work(m, n, [44, 0])
    assert (nb, fl) == (b0[0] + b1[0], b0[1] + b1[1])


def test_dense_and_simplex_by_hand():
    assert dense.block_work(2, 3, 5, 4, 7) == (
        8 * 2 * (15 + 18 + 20 + 3 + 20), 7 * (30 + 36 + 40))
    assert simplex.solve_work(10000) == (80008, 50000)
    assert peaks.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 67e12) == pytest.approx(1.0)


@pytest.mark.parametrize("m,n,nrun", [(12, 160, [256]), (1000, 5000, [256]),
                                      (30, 1000, [3, 256, 0, 17])])
def test_lazy_agrees_with_chip_smoke(m, n, nrun):
    smoke = _smoke()
    nbytes, flops = lazy.block_work(m, n, [r for r in nrun if r])
    assert smoke.lazy_bound(m, n, [r for r in nrun if r])[0] == \
        pytest.approx(1e3 * peaks.least_seconds(nbytes, flops))


@pytest.mark.parametrize("B,m,n,kmax,iters", [(1, 30, 1000, 256, 256),
                                               (32, 30, 1000, 256, 8192)])
def test_dense_agrees_with_chip_smoke(B, m, n, kmax, iters):
    smoke = _smoke()
    nbytes, flops = dense.block_work(B, m, n, kmax, iters)
    assert smoke.dense_bound(B, m, n, kmax, iters)[0] == \
        pytest.approx(1e3 * peaks.least_seconds(nbytes, flops))
