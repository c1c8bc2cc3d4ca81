"""The port's ABPG_expo and ABPG_gain (``algorithms/bpg.py``) against the
JAX drivers on ``D_opt_design(40, 120, randseed=10)`` with the default h,
in float64, at the bars of ``tests/test_torch_bpg.py`` (F and the
line-search histories Gamma and Gain rtol 1e-11 over the first 200 rows
with equal trial counts; the divergence ratios G and Gdiv rtol 1e-8),
plus:

* the kernel route of the prox, ``BurgEntropySimplex(use_pallas=True)``
  (on the CPU the kernel's plain version), against the port's default h:
  the line-search histories equal over 200 rows, F rtol 2e-7.  The kernel
  stops its Newton at |sum x - 1| <= 1e-8 where the default prox polishes
  to the last bit, and log det moves by up to m times that (measured
  6.4e-8 relative over the five drivers);
* ``checkdiv=True`` (steps accepted by the divergence test alone): the
  divergences shrink to where their cancellation leaves few digits, so G
  and Gdiv are held to rtol 1e-4 (measured 8.5e-6), while Gamma and Gain
  show the same decisions in every row.  ABPG_expo with an adapting
  gamma and no descent test amplifies rounding: F parts from JAX's by
  more than 1e-11 after row 37, and how far by row 200 depends on the
  host's BLAS, which orders the sums: 1.9e-10 on one host; under MKL
  with AVX-512 2.75e-9 in one thread and 4.2e-9 in many, both at row
  112, where G parts by 1.3e-4 and 2.0e-4.  So its F is held to 1e-8 and
  its G to 1e-3, a few times the largest measured (the final iterate by
  9e-12 and 5.4e-11: held to atol 1e-10);
* checkpoints of ABPG_gain resumed across the packages.
"""

import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu as acc
import accbpg_and_fw_tpu_torch as port

from test_torch_bpg import (F_RTOL, ROWS, assert_gains, assert_rows,
                            assert_x, trials)
from test_torch_lazy import keep_jax_exec_cache  # noqa: F401 (autouse)

torch.set_num_threads(1)

PALLAS_F_RTOL = 2e-7
CHECKDIV_F_RTOL, CHECKDIV_G_RTOL, CHECKDIV_X_ATOL = 1e-9, 1e-4, 1e-10
# ABPG_expo with checkdiv amplifies rounding (see the module docstring)
EXPO_CHECKDIV_F_RTOL, EXPO_CHECKDIV_G_RTOL = 1e-8, 1e-3


@pytest.fixture(scope="module")
def problems():
    fj, hj, L, x0j = acc.D_opt_design(40, 120, randseed=10)
    fp, hp, _, x0p = port.D_opt_design(40, 120, randseed=10, device="cpu")
    return (fj, hj, L, x0j), (fp, hp, L, x0p)


@pytest.mark.parametrize("kw", [
    {},
    dict(checkdiv=True),
    dict(restart=True, restart_rule="f"),
    dict(theta_eq=False, restart=True, restart_rule="g", delta=0.5),
], ids=["default", "checkdiv", "restart_f", "theta_closed_restart_g"])
def test_abpg_expo_matches_jax(problems, kw):
    (fj, hj, L, x0j), (fp, hp, _, x0p) = problems
    rj = acc.ABPG_expo(fj, hj, L, x0j, 3.0, ROWS, verbose=False, **kw)
    rp = port.ABPG_expo(fp, hp, L, x0p, 3.0, ROWS, verbose=False, **kw)
    assert len(rp) == len(rj) == 5
    assert_rows(rp[1], rj[1], rtol=EXPO_CHECKDIV_F_RTOL
                if kw.get("checkdiv") else F_RTOL)
    assert_rows(rp[2], rj[2])  # Gamma: the same decrements in every row
    assert np.asarray(rj[2]).min() < 3.0  # gamma did adapt
    if kw.get("checkdiv"):
        assert_rows(rp[3], rj[3], rtol=EXPO_CHECKDIV_G_RTOL)
        assert_x(rp[0], rj[0], atol=CHECKDIV_X_ATOL)
    else:
        assert_gains(rp[3], rj[3])
        assert_x(rp[0], rj[0])


@pytest.mark.parametrize("kw", [
    {},
    dict(G0=0.1),
    dict(theta_eq=False),
    dict(checkdiv=True),
    dict(restart=True, restart_rule="f"),
    dict(restart=True, restart_rule="g", ls_inc=1.5, ls_dec=1.1),
], ids=["default", "G0", "theta_closed", "checkdiv", "restart_f",
        "restart_g"])
def test_abpg_gain_matches_jax(problems, kw):
    (fj, hj, L, x0j), (fp, hp, _, x0p) = problems
    rj = acc.ABPG_gain(fj, hj, L, x0j, 2.0, ROWS, verbose=False, **kw)
    rp = port.ABPG_gain(fp, hp, L, x0p, 2.0, ROWS, verbose=False, **kw)
    assert len(rp) == len(rj) == 6
    assert_rows(rp[1], rj[1])
    assert_rows(rp[2], rj[2])
    inc, dec = kw.get("ls_inc", 1.2), kw.get("ls_dec", 1.2)
    if inc == dec:
        tp = trials(rp[2], kw.get("G0", 1.0), inc)
        np.testing.assert_array_equal(tp, trials(rj[2], kw.get("G0", 1.0),
                                                 inc))
        assert tp.max() >= 2
    if kw.get("checkdiv"):
        assert_rows(rp[3], rj[3], rtol=CHECKDIV_G_RTOL)
    else:
        assert_gains(rp[3], rj[3])
    assert_rows(rp[4], rj[4])  # Gavg
    assert_x(rp[0], rj[0])


def test_epsilon_truncates_like_jax(problems):
    (fj, hj, L, x0j), (fp, hp, _, x0p) = problems
    kw = dict(epsilon=1e-3, chunk=64, verbose=False)
    rj = acc.ABPG_gain(fj, hj, L, x0j, 2.0, 1000, **kw)
    rp = port.ABPG_gain(fp, hp, L, x0p, 2.0, 1000, **kw)
    assert 64 < len(rp[1]) == len(rj[1]) < 1000
    assert_rows(rp[1], rj[1], rows=len(rj[1]))


@pytest.mark.parametrize("name,args", [
    ("BPG", ()), ("ABPG", (2.0,)), ("ABPG_expo", (3.0,)),
    ("ABPG_gain", (2.0,)), ("ABDA", (2.0,))])
def test_kernel_prox_route_against_default_h(problems, name, args):
    from accbpg_and_fw_tpu_torch.ops import simplex as sm

    _, (fp, hp, L, x0p) = problems
    hk = port.BurgEntropySimplex(use_pallas=True)
    run = getattr(port, name)
    calls = []
    hk.prox_map = lambda g, Lt, _p=hk.prox_map: calls.append(1) or _p(g, Lt)
    before = sm.LAUNCHES
    rk = run(fp, hk, L, x0p, *args, ROWS, verbose=False)
    assert sm.LAUNCHES == before  # CPU tensors take the plain version
    assert len(calls) >= ROWS
    rd = run(fp, hp, L, x0p, *args, ROWS, verbose=False)
    assert_rows(rk[1], rd[1], rtol=PALLAS_F_RTOL)
    if name in ("BPG", "ABPG_expo", "ABPG_gain"):
        np.testing.assert_array_equal(rk[2][:ROWS], rd[2][:ROWS])
    x = rk[0].numpy()
    assert abs(x.sum() - 1.0) <= 1e-8 + x.size * 2.0**-52


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_gain_checkpoint_resumes_across_packages(problems, tmp_path, writer):
    (fj, hj, L, x0j), (fp, hp, _, x0p) = problems
    ck = str(tmp_path / "gain.npz")
    first, second = (acc, port) if writer == "jax" else (port, acc)
    args = {acc: (fj, hj, L, x0j), port: (fp, hp, L, x0p)}
    kw = dict(chunk=25, checkpoint=ck, verbose=False)
    r1 = first.ABPG_gain(*args[first], 2.0, 75, **kw)
    with np.load(ck) as z:
        assert str(z["__fp"]) == (
            "accbpg_and_fw_tpu.algorithms.bpg._abpg_gain_step|_ABPGGainCfg("
            "theta_eq=True, checkdiv=False, restart=False, restart_rule='g', "
            "stochastic=False, gamma2=False)")
    r2 = second.ABPG_gain(*args[second], 2.0, 150, **kw)
    ref = acc.ABPG_gain(fj, hj, L, x0j, 2.0, 150, chunk=25, verbose=False)
    np.testing.assert_array_equal(np.asarray(r2[1])[:75], np.asarray(r1[1]))
    assert_rows(r2[1], ref[1])
    assert_rows(r2[2], ref[2])
    x2 = r2[0] if isinstance(r2[0], torch.Tensor) else torch.tensor(
        np.asarray(r2[0]))
    assert_x(x2, ref[0])
