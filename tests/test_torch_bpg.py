"""The port's BPG, ABPG and ABDA (``algorithms/bpg.py``) against the JAX
drivers, on the JAX package's own ``D_opt_design(40, 120, randseed=10)``
with the default h, in float64.

Bars, over the first 200 rows (later rows may part ways chaotically):

* F and the line-search history Ls: rtol 1e-11, with the same number of
  line-search trials in every row (read off the Ls ratios);
* the triangle-scaling gains G: rtol 1e-8.  G is a ratio of two Burg
  divergences, each a sum of n terms r - log r - 1 that cancel to about
  (r - 1)^2 / 2 while every term keeps an absolute rounding of ~1e-16
  whatever the order of the sum, so its relative error grows as the
  iterates converge and cannot meet the F bar (measured: up to 2.7e-9, in
  ABDA's row 114; 9.6e-10 within 50 rows of ABPG_gain with checkdiv);
* the final iterate: atol 1e-12.

The tests of ABPG_expo, ABPG_gain and the kernel route of the prox are in
``tests/test_torch_abpg.py``.
"""

import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu as acc
import accbpg_and_fw_tpu_torch as port

from test_torch_lazy import keep_jax_exec_cache  # noqa: F401 (autouse)

torch.set_num_threads(1)

ROWS, F_RTOL, G_RTOL = 200, 1e-11, 1e-8


@pytest.fixture(scope="module")
def problems():
    fj, hj, L, x0j = acc.D_opt_design(40, 120, randseed=10)
    fp, hp, _, x0p = port.D_opt_design(40, 120, randseed=10, device="cpu")
    return (fj, hj, L, x0j), (fp, hp, L, x0p)


def assert_rows(got, ref, rtol=F_RTOL, rows=ROWS):
    got, ref = np.asarray(got), np.asarray(ref)
    assert len(got) == len(ref)
    np.testing.assert_allclose(got[:rows], ref[:rows], rtol=rtol, atol=0)


def assert_gains(got, ref):
    assert_rows(got, ref, G_RTOL)


def trials(hist, first, ratio):
    """Line-search trials per row from a multiplicative history (row k
    starts at hist[k-1] / ratio, or ``first``, and multiplies by ratio per
    failed trial)."""
    prev = np.concatenate([[first], np.asarray(hist)[:-1]]) / ratio
    return np.rint(np.log(np.asarray(hist) / prev) / np.log(ratio)) + 1


def assert_x(xp, xj, atol=1e-12):
    assert isinstance(xp, torch.Tensor) and xp.dtype == torch.float64
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("ls_ratio", [1.2, 2.0])
def test_bpg_linesearch_matches_jax(problems, ls_ratio):
    (fj, hj, L, x0j), (fp, hp, _, x0p) = problems
    rj = acc.BPG(fj, hj, L, x0j, ROWS, ls_ratio=ls_ratio, verbose=False)
    rp = port.BPG(fp, hp, L, x0p, ROWS, ls_ratio=ls_ratio, verbose=False)
    assert len(rp) == len(rj) == 4
    assert_rows(rp[1], rj[1])
    assert_rows(rp[2], rj[2])
    tp, tj = trials(rp[2], L, ls_ratio), trials(rj[2], L, ls_ratio)
    np.testing.assert_array_equal(tp, tj)
    assert tp.min() >= 1 and tp.max() >= 2  # the line search backtracked
    assert_x(rp[0], rj[0])
    assert len(rp[3]) == len(rp[1]) and np.all(np.diff(rp[3]) >= 0)


def test_bpg_without_linesearch(problems):
    (fj, hj, L, x0j), (fp, hp, _, x0p) = problems
    rj = acc.BPG(fj, hj, 1.5, x0j, 100, linesearch=False, verbose=False)
    rp = port.BPG(fp, hp, 1.5, x0p, 100, linesearch=False, verbose=False)
    assert_rows(rp[1], rj[1])
    assert np.all(rp[2] == 1.5)
    assert_x(rp[0], rj[0])


def test_bpg_epsilon_truncates_like_jax(problems):
    (fj, hj, L, x0j), (fp, hp, _, x0p) = problems
    rj = acc.BPG(fj, hj, L, x0j, 3000, epsilon=1e-6, chunk=64,
                 verbose=False)
    rp = port.BPG(fp, hp, L, x0p, 3000, epsilon=1e-6, chunk=64,
                  verbose=False)
    assert 1 < len(rp[1]) == len(rj[1]) < 3000
    assert_rows(rp[1], rj[1], rows=len(rj[1]))


@pytest.mark.parametrize("theta_eq,restart,rule", [
    (False, False, "g"), (True, False, "g"), (False, True, "g"),
    (True, True, "f")])
def test_abpg_matches_jax(problems, theta_eq, restart, rule):
    (fj, hj, L, x0j), (fp, hp, _, x0p) = problems
    kw = dict(theta_eq=theta_eq, restart=restart, restart_rule=rule,
              verbose=False)
    rj = acc.ABPG(fj, hj, L, x0j, 2.0, ROWS, **kw)
    rp = port.ABPG(fp, hp, L, x0p, 2.0, ROWS, **kw)
    assert len(rp) == len(rj) == 4
    assert_rows(rp[1], rj[1])
    assert_gains(rp[2], rj[2])
    assert_x(rp[0], rj[0])


@pytest.mark.parametrize("theta_eq", [True, False])
def test_abda_matches_jax(problems, theta_eq):
    (fj, hj, L, x0j), (fp, hp, _, x0p) = problems
    rj = acc.ABDA(fj, hj, L, x0j, 2.0, ROWS, theta_eq=theta_eq,
                  verbose=False)
    rp = port.ABDA(fp, hp, L, x0p, 2.0, ROWS, theta_eq=theta_eq,
                   verbose=False)
    assert len(rp) == len(rj) == 4
    assert_rows(rp[1], rj[1])
    assert_gains(rp[2], rj[2])
    assert_x(rp[0], rj[0])


def test_printed_table_headers(problems, capsys):
    (fj, hj, L, x0j), (fp, hp, _, x0p) = problems
    for name, args in (("BPG", ()), ("ABPG", (2.0,)), ("ABDA", (2.0,))):
        getattr(acc, name)(fj, hj, L, x0j, *args, 3, verbskip=1)
        ref = capsys.readouterr().out.splitlines()
        getattr(port, name)(fp, hp, L, x0p, *args, 3, verbskip=1)
        got = capsys.readouterr().out.splitlines()
        assert got[:3] == ref[:3]
        assert len(got) == len(ref)
        # every column but the time
        assert [r.rsplit(None, 1)[0] for r in got[3:]] == \
            [r.rsplit(None, 1)[0] for r in ref[3:]]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bpg_checkpoint_resumes_across_packages(problems, tmp_path, writer):
    """60 iterations saved by one package, resumed to 120 by the other,
    against JAX's uninterrupted run."""
    (fj, hj, L, x0j), (fp, hp, _, x0p) = problems
    ck = str(tmp_path / "bpg.npz")
    first, second = (acc, port) if writer == "jax" else (port, acc)
    args = {acc: (fj, hj, L, x0j), port: (fp, hp, L, x0p)}
    r1 = first.BPG(*args[first], 60, chunk=20, checkpoint=ck, verbose=False)
    with np.load(ck) as z:
        assert str(z["__fp"]) == ("accbpg_and_fw_tpu.algorithms.bpg._bpg_step"
                                  "|_BPGCfg(linesearch=True, "
                                  "stochastic=False)")
        assert int(z["__k_next"]) == 60
    r2 = second.BPG(*args[second], 120, chunk=20, checkpoint=ck,
                    verbose=False)
    ref = acc.BPG(fj, hj, L, x0j, 120, chunk=20, verbose=False)
    np.testing.assert_array_equal(np.asarray(r2[1])[:60], np.asarray(r1[1]))
    assert_rows(r2[1], ref[1])
    assert_rows(r2[2], ref[2])
    x2 = r2[0] if isinstance(r2[0], torch.Tensor) else torch.tensor(
        np.asarray(r2[0]))
    assert_x(x2, ref[0])


def test_checkpoint_of_another_solver_is_refused(problems, tmp_path):
    (fj, hj, L, x0j), (fp, hp, _, x0p) = problems
    ck = str(tmp_path / "abpg.npz")
    acc.ABPG(fj, hj, L, x0j, 2.0, 20, checkpoint=ck, verbose=False)
    with pytest.raises(ValueError, match="different solver"):
        port.BPG(fp, hp, L, x0p, 40, checkpoint=ck, verbose=False)


def test_unported_options_raise(problems):
    _, (fp, hp, L, x0p) = problems
    for fg in (True, "ds"):
        with pytest.raises(NotImplementedError, match="fast_gram"):
            port.BPG(fp, hp, L, x0p, 5, fast_gram=fg, verbose=False)
        with pytest.raises(NotImplementedError, match="fast_gram"):
            port.ABDA(fp, hp, L, x0p, 2.0, 5, fast_gram=fg, verbose=False)

    class Noisy(port.DOptimalObj):
        stochastic = True

    with pytest.raises(NotImplementedError, match="stochastic"):
        port.ABPG(Noisy(fp.H), hp, L, x0p, 2.0, 5, verbose=False)
