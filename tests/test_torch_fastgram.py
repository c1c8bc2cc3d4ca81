"""The port's linear-Gram fast path (``fast_gram=True``,
``algorithms/fastgram.py`` and the ``_*_dopt_step``s of
``algorithms/bpg.py``) against the JAX package's, in float64.

* Every ``fastgram`` function against JAX's on the same seeded inputs at
  rtol 1e-12, on both branches of each gate (warm start or reseed;
  series or factorization), each gate a device select of the branch its
  sum decides (``fastgram.TALLY`` counting the decision).
* The five drivers with ``fast_gram=True`` against JAX's on JAX-built
  ``DOptimalObj``s (12x60 and 16x64, random designs seeded as in
  ``tests/test_fast_gram.py``), 100 iterations with a chunk of 30 so the
  chunk-boundary refresh runs three times: F and the line-search
  histories (Ls, Gamma, Gain) at rtol 1e-11 with the same number of rows,
  the final iterate at atol 1e-12.  (Past ~100 iterations ABPG_expo
  amplifies rounding, in the plain step as in the fast one: its final
  iterate parts from JAX's by 1e-15 at 100 iterations, 1e-9 at 150.)
  F crosses zero on these designs, where a relative bar means nothing,
  so F is held at 1e-11 of the history's largest |F| as well.  The
  divergence ratios (G, Gdiv) at the 1e-8 of ``tests/test_torch_bpg.py``.
* Checkpoints of ``ABPG_gain(fast_gram=True)`` resumed across the
  packages, ``fast_gram="ds"`` as the FP64 engine, and the ``ValueError``
  for an oracle without the protocol.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import accbpg_and_fw_tpu as acc
import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu.algorithms import fastgram as jfg
from accbpg_and_fw_tpu_torch.algorithms import fastgram as pfg
from accbpg_and_fw_tpu_torch.interop import from_jax_oracle

from test_torch_abpg import CHECKDIV_F_RTOL, CHECKDIV_G_RTOL, CHECKDIV_X_ATOL
from test_torch_lazy import keep_jax_exec_cache  # noqa: F401 (autouse)

torch.set_num_threads(1)

FN_RTOL, F_RTOL, G_RTOL, X_ATOL = 1e-12, 1e-11, 1e-8, 1e-12
ITERS, CHUNK = 100, 30


def _instance(m, n, seed):
    np.random.seed(seed)
    V = np.random.randn(m, n)
    fj = acc.DOptimalObj(H=jnp.asarray(V, jnp.float64))
    hj = acc.ops.h_oracles.BurgEntropySimplex()
    x0 = np.full(n, 1.0 / n)
    return ((fj, hj, 1.0, jnp.asarray(x0)),
            (from_jax_oracle(fj, device="cpu"),
             from_jax_oracle(hj, device="cpu"), 1.0, torch.tensor(x0)))


@pytest.fixture(scope="module")
def small():
    return _instance(12, 60, 5)


@pytest.fixture(scope="module")
def wide():
    return _instance(16, 64, 3)


def t(a):
    return torch.tensor(np.asarray(a, np.float64))


def close(got, ref, rtol=FN_RTOL, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# fastgram functions
# ---------------------------------------------------------------------------


def _gram(small, seed=0):
    (fj, *_), (fp, *_) = small
    x = np.random.default_rng(seed).uniform(0.5, 1.5, fj.n)
    x /= x.sum()
    return fj, fp, np.asarray(fj.gram(jnp.asarray(x))), x


def test_protocol_matches_jax(small):
    fj, fp, G, x = _gram(small)
    close(fp.gram(t(x)), G)
    close(fp.logdet_full(t(G)), fj.logdet_full(jnp.asarray(G)))
    close(fp.inv_seed(t(G)), fj.inv_seed(jnp.asarray(G)), rtol=1e-11)
    M = np.linalg.inv(G)
    close(fp.grad_from_inv(t(M)), fj.grad_from_inv(jnp.asarray(M)))
    assert pfg.supports_fast_gram(fp)
    # not positive definite: NaN, as JAX's Cholesky gives
    assert torch.isnan(fp.logdet_full(-t(G)))
    assert torch.isnan(fp.inv_seed(-t(G))).all()


def test_schulz_matches_jax(small):
    _, _, G, _ = _gram(small)
    M0 = np.linalg.inv(G) * (1.0 + 0.02 * np.random.default_rng(1)
                             .standard_normal(G.shape))
    for steps in (1, 4):
        close(pfg.schulz(t(M0), t(G), steps),
              jfg.schulz(jnp.asarray(M0), jnp.asarray(G), steps))


@pytest.mark.parametrize("noise,warm", [(1e-3, True), (0.3, False)])
def test_inv_at_both_branches(small, noise, warm):
    fj, fp, G, _ = _gram(small)
    M_prev = np.linalg.inv(G) * (1.0 + noise * np.random.default_rng(2)
                                 .standard_normal(G.shape))
    E0 = np.eye(len(G)) - M_prev @ G
    assert (np.sum(E0 * E0) <= pfg.WARM_TAU2) == warm
    ref = jfg.inv_at(fj, jnp.asarray(G), jnp.asarray(M_prev))
    pfg.TALLY[0] = {}
    try:
        got = pfg.inv_at(fp, t(G), t(M_prev))
        tally = pfg.TALLY[0]
    finally:
        pfg.TALLY[0] = None
    assert tally == {"warm start": {warm: 1}}
    close(got, ref)
    # the select form: the seed the gate takes, polished once
    seed = t(M_prev) if warm else fp.inv_seed(t(G))
    assert torch.equal(got, pfg.schulz(seed, t(G)))


def test_series_logdet(small):
    m = 10
    E = 0.002 * np.random.default_rng(3).standard_normal((m, m))
    assert np.sum(E * E) <= pfg.SERIES_TAU2
    ref = jfg.series_logdet(jnp.asarray(E))
    close(pfg.series_logdet(t(E)), ref)
    close(pfg.series_logdet(t(E)), np.linalg.slogdet(np.eye(m) - E)[1],
          rtol=0, atol=1e-12)


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("noise,series", [(1e-3, True), (0.05, False)])
def test_anchored_logdet_shift(small, sign, noise, series):
    fj, fp, G, x = _gram(small)
    _, _, G2, _ = _gram(small, seed=4)
    Gs = G + noise * (G2 - G) * 10.0
    M = np.linalg.inv(G)
    E = np.eye(len(G)) - M @ Gs
    assert (np.sum(E * E) <= pfg.SERIES_TAU2) == series
    # sign +1: the anchor is the point M inverts and the target the series
    # G; sign -1 the other way round
    anchor, target = (G, Gs) if sign > 0 else (Gs, G)
    ld = float(np.linalg.slogdet(anchor)[1])
    ref = jfg.anchored_logdet_shift(fj, jnp.asarray(ld), sign, jnp.asarray(M),
                                    jnp.asarray(Gs), jnp.asarray(target))
    got = pfg.anchored_logdet_shift(fp, ld, sign, t(M), t(Gs), t(target))
    close(got[0], ref[0])
    close(got[1], ref[1])
    close(pfg.anchored_logdet(fp, ld, sign, t(M), t(Gs), t(target)), ref[0])


def test_init_and_refresh_state_match_jax(small):
    (fj, _, _, x0j), (fp, _, _, x0p) = small
    x = np.random.default_rng(5).uniform(0.5, 1.5, fj.n)
    x /= x.sum()
    sj, sp = jfg.init_state(fj, x0j), pfg.init_state(fp, x0p)
    for k in ("G0", "M0", "ld0"):
        close(sp[k], sj[k], rtol=1e-11)
    rj = jfg.refresh_state(fj, jnp.asarray(x), x0j)
    rp = pfg.refresh_state(fp, t(x), x0p)
    assert sorted(rp) == sorted(rj)
    assert isinstance(rp["fx"], torch.Tensor) and rp["fx"].dim() == 0
    for k in rj:
        close(rp[k], rj[k], rtol=1e-11)
    assert "Gz" not in pfg.refresh_state(fp, t(x), x0p, with_z=False)


def test_require_fast_gram_error_text():
    fj, *_ = acc.Poisson_regrL1(20, 10, randseed=1)
    with pytest.raises(ValueError) as ej:
        jfg.require_fast_gram(fj)
    fp = from_jax_oracle(fj, device="cpu")
    with pytest.raises(ValueError) as ep:
        pfg.require_fast_gram(fp)
    assert str(ep.value) == str(ej.value)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def assert_F(got, ref, rtol=F_RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert len(got) == len(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def assert_hist(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert len(got) == len(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)


def assert_x(got, ref, atol=X_ATOL):
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=atol)


def _pair(prob, name, *args, **kw):
    (fj, hj, L, x0j), (fp, hp, _, x0p) = prob
    kw = dict(verbose=False, chunk=CHUNK, fast_gram=True, **kw)
    return (getattr(acc, name)(fj, hj, L, x0j, *args, ITERS, **kw),
            getattr(port, name)(fp, hp, L, x0p, *args, ITERS, **kw))


def _cases(kws, ids):
    """Each option on the 12x60 instance, the first two also on 16x64."""
    return ([pytest.param("small", kw, id=f"small-{i}")
             for kw, i in zip(kws, ids)]
            + [pytest.param("wide", kw, id=f"wide-{i}")
               for kw, i in zip(kws[:2], ids[:2])])


@pytest.mark.parametrize("inst,kw", _cases(
    [{}, dict(linesearch=False, L=1.5)], ["ls", "no_ls"]))
def test_bpg_fast_gram_matches_jax(request, inst, kw):
    prob = request.getfixturevalue(inst)
    kw = dict(kw)
    if "L" in kw:
        (fj, hj, _, x0j), (fp, hp, _, x0p) = prob
        prob = ((fj, hj, kw.pop("L"), x0j), (fp, hp, 1.5, x0p))
    rj, rp = _pair(prob, "BPG", **kw)
    assert len(rp) == len(rj) == 4
    assert_F(rp[1], rj[1])
    assert_hist(rp[2], rj[2], F_RTOL)
    assert_x(rp[0], rj[0])


@pytest.mark.parametrize("inst,kw", _cases(
    [{}, dict(restart=True, restart_rule="g"),
     dict(theta_eq=True, restart=True, restart_rule="f")],
    ["plain", "restart_g", "theta_eq_restart_f"]))
def test_abpg_fast_gram_matches_jax(request, inst, kw):
    prob = request.getfixturevalue(inst)
    rj, rp = _pair(prob, "ABPG", 2.0, **kw)
    assert len(rp) == len(rj) == 4
    assert_F(rp[1], rj[1])
    assert_hist(rp[2], rj[2], G_RTOL)
    assert_x(rp[0], rj[0])


@pytest.mark.parametrize("inst,kw", _cases(
    [{}, dict(checkdiv=True), dict(restart=True, restart_rule="g")],
    ["plain", "checkdiv", "restart_g"]))
def test_abpg_expo_fast_gram_matches_jax(request, inst, kw):
    prob = request.getfixturevalue(inst)
    rj, rp = _pair(prob, "ABPG_expo", 3.0, **kw)
    assert len(rp) == len(rj) == 5
    # with checkdiv, the bars tests/test_torch_abpg.py holds the plain step
    # to: no descent test, so the iteration amplifies rounding (measured
    # 2.5e-10 in F and 4.1e-11 in x at 16x64, the plain step 2.2e-10 and
    # 3.8e-11 on the same problem), and G's divergences shrink to few digits
    cd = kw.get("checkdiv", False)
    assert_F(rp[1], rj[1], CHECKDIV_F_RTOL if cd else F_RTOL)
    np.testing.assert_array_equal(rp[2], np.asarray(rj[2]))  # Gamma
    assert_hist(rp[3], rj[3], CHECKDIV_G_RTOL if cd else G_RTOL)
    assert_x(rp[0], rj[0], CHECKDIV_X_ATOL if cd else X_ATOL)


@pytest.mark.parametrize("inst,kw", _cases(
    [{}, dict(checkdiv=True), dict(restart=True, restart_rule="g"),
     dict(restart=True, restart_rule="f"), dict(theta_eq=False)],
    ["plain", "checkdiv", "restart_g", "restart_f", "theta_closed"]))
def test_abpg_gain_fast_gram_matches_jax(request, inst, kw):
    prob = request.getfixturevalue(inst)
    pfg.TALLY[0] = {}
    try:
        rj, rp = _pair(prob, "ABPG_gain", 2.0, **kw)
        tally = pfg.TALLY[0]
    finally:
        pfg.TALLY[0] = None
    assert len(rp) == len(rj) == 6
    assert_F(rp[1], rj[1])
    assert_hist(rp[2], rj[2], F_RTOL)  # Gain: the line search's decisions
    assert_hist(rp[3], rj[3], G_RTOL)
    assert_hist(rp[4], rj[4], F_RTOL)
    assert_x(rp[0], rj[0])
    # three gates a trial, and the fallback branch taken on the way
    gates = sum(sum(counts.values()) for counts in tally.values())
    fallbacks = sum(counts.get(False, 0) for counts in tally.values())
    assert gates >= 3 * ITERS and 0 < fallbacks < gates


@pytest.mark.parametrize("inst,kw", _cases(
    [dict(theta_eq=True), dict(theta_eq=False)], ["theta_eq", "closed"]))
def test_abda_fast_gram_matches_jax(request, inst, kw):
    prob = request.getfixturevalue(inst)
    rj, rp = _pair(prob, "ABDA", 2.0, **kw)
    assert len(rp) == len(rj) == 4
    assert_F(rp[1], rj[1])
    assert_hist(rp[2], rj[2], G_RTOL)
    assert_x(rp[0], rj[0])


def test_fast_gram_ds_is_the_fp64_engine(small):
    (fj, hj, L, x0j), (fp, hp, _, x0p) = small
    for name, args in (("BPG", ()), ("ABPG_gain", (2.0,)), ("ABDA", (2.0,))):
        run = getattr(port, name)
        a = run(fp, hp, L, x0p, *args, 60, verbose=False, fast_gram="ds")
        b = run(fp, hp, L, x0p, *args, 60, verbose=False, fast_gram=True)
        np.testing.assert_array_equal(a[1], b[1])
        assert torch.equal(a[0], b[0])


def test_oracle_without_protocol_raises():
    fj, hj, L, x0 = acc.Poisson_regrL1(20, 10, randseed=1)
    fp, hp = from_jax_oracle(fj, device="cpu"), from_jax_oracle(hj,
                                                                device="cpu")
    x0p = torch.tensor(np.asarray(x0))
    for name, args in (("BPG", ()), ("ABPG", (2.0,)), ("ABPG_expo", (3.0,)),
                       ("ABPG_gain", (2.0,)), ("ABDA", (2.0,))):
        with pytest.raises(ValueError, match="linear-Gram oracle"):
            getattr(port, name)(fp, hp, L, x0p, *args, 5, verbose=False,
                                fast_gram=True)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_gain_checkpoint_resumes_across_packages(small, tmp_path, writer):
    """75 iterations saved by one package (the refresh at the chunk
    boundary included), resumed to 150 by the other, against JAX's
    uninterrupted run."""
    (fj, hj, L, x0j), (fp, hp, _, x0p) = small
    ck = str(tmp_path / "gain.npz")
    first, second = (acc, port) if writer == "jax" else (port, acc)
    args = {acc: (fj, hj, L, x0j), port: (fp, hp, L, x0p)}
    kw = dict(chunk=25, checkpoint=ck, verbose=False, fast_gram=True)
    r1 = first.ABPG_gain(*args[first], 2.0, 75, **kw)
    with np.load(ck) as z:
        assert str(z["__fp"]) == (
            "accbpg_and_fw_tpu.algorithms.bpg._abpg_gain_dopt_step|"
            "_ABPGGainCfg(theta_eq=True, checkdiv=False, restart=False, "
            "restart_rule='g', stochastic=False, gamma2=False)")
        assert {"Gx", "Gz", "Minv", "fx", "cpx"} <= {
            n[3:] for n in z.files if n.startswith("c::")}
    r2 = second.ABPG_gain(*args[second], 2.0, 150, **kw)
    ref = acc.ABPG_gain(fj, hj, L, x0j, 2.0, 150, chunk=25, verbose=False,
                        fast_gram=True)
    np.testing.assert_array_equal(np.asarray(r2[1])[:75], np.asarray(r1[1]))
    assert_F(r2[1], ref[1])
    assert_hist(r2[2], ref[2], F_RTOL)
    x2 = r2[0] if isinstance(r2[0], torch.Tensor) else torch.tensor(
        np.asarray(r2[0]))
    assert_x(x2, ref[0])


def test_stochastic_flag_is_ignored_under_fast_gram(small, tmp_path):
    """As in JAX, the fast-Gram steps draw no noise: a DOptimalObj that
    declares itself stochastic runs the exact fast-Gram trajectory, and
    its carry holds no key."""
    _, (fp, hp, L, x0p) = small

    class Noisy(port.DOptimalObj):
        stochastic = True

    ck = str(tmp_path / "noisy.npz")
    a = port.ABPG_gain(Noisy(fp.H), hp, L, x0p, 2.0, 30, verbose=False,
                       fast_gram=True, seed=3, checkpoint=ck)
    b = port.ABPG_gain(fp, hp, L, x0p, 2.0, 30, verbose=False,
                       fast_gram=True)
    np.testing.assert_array_equal(a[1], b[1])
    with np.load(ck) as z:
        assert "c::key" not in z.files
        assert "stochastic=False" in str(z["__fp"])
