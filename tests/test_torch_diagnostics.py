"""The port's supporting pieces against the JAX package's: ``diagnostics``
(``check_domain``, ``iteration_rate``, ``divergence_is_valid``,
``debug_mode``, ``profile_trace``), ``viz`` (``tse_curve`` at rtol
1e-12, ``plot_comparisons`` drawing what JAX's draws), the names that
complete the JAX ``__all__`` (the digit contractions, ``scan_full``,
``solver_device``, the keyed l2-ball point) and the ``accbpg_torch``
alias.  CPU, float64, small shapes.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import accbpg_and_fw_tpu as acc
import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu import diagnostics as jdiag
from accbpg_and_fw_tpu_torch import diagnostics as pdiag

from test_torch_lazy import keep_jax_exec_cache  # noqa: F401 (autouse)

torch.set_num_threads(1)


def _raises(fn, *args):
    """The exception type and message ``fn(*args)`` raises, or None."""
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 - the exception is the result
        return type(e), str(e)
    return None


@pytest.mark.parametrize("h_name,x", [
    ("BurgEntropy", [0.5, 0.2, 0.3]),
    ("BurgEntropy", [0.5, -0.2, 0.3]),
    ("BurgEntropy", [0.5, np.nan, 0.3]),
    ("BurgEntropySimplex", [0.5, 0.2, 0.3]),
    ("BurgEntropySimplex", [0.5, 0.2, 0.4]),
    ("ShannonEntropy", [0.0, 0.2, 0.3]),
    ("ShannonEntropy", [0.1, -0.2, 0.3]),
    ("ShannonEntropySimplex", [0.1, 0.2, 0.3]),
    ("PowerNeg1", [0.0, 1.0]),
    ("SquaredL2Norm", [-1.0, np.inf]),
    ("SquaredL2Norm", [-1.0, 2.0]),
])
def test_check_domain_matches_jax(h_name, x):
    hj, hp = getattr(acc, h_name)(), getattr(port, h_name)()
    ref = _raises(jdiag.check_domain, hj, jnp.asarray(x))
    assert _raises(pdiag.check_domain, hp,
                   torch.tensor(x, dtype=torch.float64)) == ref
    assert _raises(pdiag.check_domain, hp, np.asarray(x)) == ref


def test_iteration_rate_and_divergence_is_valid_match_jax():
    for T in ([], [0.0], [0.0, 0.5, 1.0, 2.0], [0.0, 0.0]):
        got, ref = pdiag.iteration_rate(T), jdiag.iteration_rate(T)
        np.testing.assert_array_equal(got, ref)
    rng = np.random.default_rng(3)
    x, y = rng.uniform(0.1, 1.0, 20), rng.uniform(0.1, 1.0, 20)
    for name in ("BurgEntropy", "ShannonEntropy", "SquaredL2Norm"):
        hj, hp = getattr(acc, name)(), getattr(port, name)()
        for a, b, atol in ((x, y, 0.0), (x, x, 0.0), (x, -y, 0.0),
                           (x, y, 1e-3)):
            got = pdiag.divergence_is_valid(hp, torch.tensor(a),
                                            torch.tensor(b), atol)
            ref = jdiag.divergence_is_valid(hj, jnp.asarray(a),
                                            jnp.asarray(b), atol)
            assert isinstance(got, torch.Tensor)
            assert bool(got) == bool(ref), (name, atol)


def _nan_at(k_bad):
    """A device-flag step whose F turns NaN at iteration ``k_bad``."""
    def step(c, k):
        v = c["v"] * (torch.nan if k == k_bad else 0.5)
        return dict(done=c["done"], v=v), dict(F=v, _stop=v < 0)
    return step


def test_debug_mode_raises_on_a_nan_solve():
    from accbpg_and_fw_tpu_torch.algorithms.driver import run_driver

    f, h, L, x0 = port.D_opt_design(8, 20, randseed=2, device="cpu")
    bad = x0.clone()
    bad[3] = torch.nan
    clean = port.BPG(f, h, L, x0, 20, verbose=False)
    with pdiag.debug_mode():
        again = port.BPG(f, h, L, x0, 20, verbose=False)  # a clean solve
        np.testing.assert_array_equal(again[1], clean[1])
        with pytest.raises(FloatingPointError, match="debug_mode"):
            port.BPG(f, h, L, bad, 20, verbose=False)
        # the device-flag chunk mode (tensor scalars, one read per chunk)
        # fails at the boundary of the chunk whose history holds the NaN
        with pytest.raises(FloatingPointError, match="'F' history"):
            run_driver(_nan_at(7), dict(done=torch.tensor(False),
                                        v=torch.tensor(1.0)), 20, chunk=5,
                       verbose=False)
    # outside the block the NaN runs through, as without debug mode
    r = port.BPG(f, h, L, bad, 3, verbose=False)
    assert np.isnan(r[1]).all()


def test_debug_mode_infs_and_restore():
    from accbpg_and_fw_tpu_torch import _scalar

    with pdiag.debug_mode(nans=False, infs=True):
        with pytest.raises(FloatingPointError):
            _scalar.read(torch.tensor(float("inf")))
        assert _scalar.read(torch.tensor(float("nan")))[0] != 0.0
        with pdiag.debug_mode():
            assert _scalar.read(torch.tensor(float("inf"))) == [np.inf]
        assert _scalar.DEBUG == [False, True]
    assert _scalar.DEBUG == [False, False]


def test_profile_trace_writes_a_trace(tmp_path):
    f, h, L, x0 = port.D_opt_design(8, 20, randseed=2, device="cpu")
    logdir = str(tmp_path / "trace")
    with pdiag.profile_trace(logdir) as prof:
        port.BPG(f, h, L, x0, 5, verbose=False)
    assert prof is not None
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(logdir, files[0])) as fh:
        trace = json.load(fh)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("cholesky" in n for n in names)


@pytest.mark.parametrize("name", ["BurgEntropy", "ShannonEntropy",
                                  "SumOf2nd4thPowers"])
def test_tse_curve_matches_jax(name):
    rng = np.random.default_rng(5)
    x, y, z = (rng.uniform(0.1, 1.0, 10) for _ in range(3))
    thetas = np.arange(0.01, 1.0, 0.01)
    hj, hp = getattr(acc, name)(), getattr(port, name)()
    ref = acc.tse_curve(hj, x, y, z, thetas)
    got = port.tse_curve(hp, x, y, z, thetas, device="cpu")
    assert got.dtype == torch.float64 and got.shape == (len(thetas),)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)


class _Axis:
    """Records every call a plot function makes on its axis."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args, **kw):
            self.calls.append((name, [np.asarray(a).tolist()
                                      if not isinstance(a, str) else a
                                      for a in args], kw))
        return call


@pytest.mark.parametrize("kw", [{}, dict(plotdiff=True, yscale="log",
                                          legendloc="outside", xlim=(1, 5))])
def test_plot_comparisons_draws_what_jax_draws(kw):
    Fs = [np.array([3.0, 2.0, 1.5, 1.25]), np.array([3.0, 1.0, 1.1, 1.0])]
    aj, ap = _Axis(), _Axis()
    acc.plot_comparisons(aj, Fs, ["a", "b"], **kw)
    port.plot_comparisons(ap, Fs, ["a", "b"], **kw)
    assert ap.calls == aj.calls and len(ap.calls) >= 6


def test_plot_tse_draws():
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    port.plotTSE(port.BurgEntropy(), dim=5, nTriples=2, nThetas=10,
                 randseed=1, device="cpu")
    port.plotTSE0(port.BurgEntropy(), dim=5, nThetas=20, device="cpu")
    assert len(plt.get_fignums()) >= 2
    plt.close("all")


def test_names_cover_the_jax_package():
    assert set(acc.__all__) <= set(port.__all__)
    for name in acc.__all__:
        assert hasattr(port, name), name
    import accbpg_torch

    assert accbpg_torch.__all__ == port.__all__
    assert accbpg_torch.BPG is port.BPG
    assert port.diagnostics is pdiag
    assert port.parallel.vmap_solver is not None


def test_digit_contractions_match_jax():
    from accbpg_and_fw_tpu.ops import mixed_precision as jmp

    rng = np.random.default_rng(9)
    B = rng.standard_normal((12, 30)) * np.logspace(0, 3, 30)
    a = rng.standard_normal(12)
    dj, sj = jmp.digit_split_matrix(jnp.asarray(B), 7)
    dp, sp = port.digit_split_matrix(torch.tensor(B), 7)
    np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    vj, tj = jmp.digit_split_vector(jnp.asarray(a), 7)
    vp, tp = port.digit_split_vector(torch.tensor(a), 7)
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
    assert float(tp) == float(tj)
    pj, pp = jmp.pack_digit_planes(dj), port.pack_digit_planes(dp)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(pj))
    uj = jmp.ozaki_gemv(jnp.asarray(a), dj, sj)
    up = port.ozaki_gemv(torch.tensor(a), dp, sp)
    np.testing.assert_array_equal(up.numpy(), np.asarray(uj))
    np.testing.assert_allclose(up.numpy(), a @ B, rtol=0,
                               atol=1e-11 * np.abs(a @ B).max())
    uj = jmp.ozaki_gemv_packed(jnp.asarray(a), pj, sj, 7)
    up = port.ozaki_gemv_packed(torch.tensor(a), pp, sp, 7)
    np.testing.assert_array_equal(up.numpy(), np.asarray(uj))


def test_scan_full_runs_the_frozen_step():
    """``scan_full`` over the exact D-opt step gives the histories of the
    chunked driver, then frozen rows past the stop."""
    from accbpg_and_fw_tpu_torch.algorithms import d_opt
    from accbpg_and_fw_tpu_torch.ops.dopt_common import factorize

    f, h, L, x0 = port.D_opt_design(6, 20, randseed=4, device="cpu")
    V = f.H
    ref = port.D_opt_FW_away(V, x0, 1e-6, 400, verbose=False)
    H, w, ld = factorize(V, x0)
    carry = dict(done=False, x=x0, w=w, H=H, logdet=ld)
    c, hist = port.scan_full(
        lambda c, k: d_opt._dopt_step(d_opt._DOptCfg(away=True),
                                      dict(V=V, eps=1e-6), c, k), carry, 400)
    n = len(ref[1])
    assert n < 400 and int(hist["_valid"].sum()) == n
    np.testing.assert_array_equal(hist["F"][:n].numpy(), ref[1])
    assert torch.equal(c["x"], ref[0]) and bool(c["done"])


def test_solver_device_pins_numpy_inputs():
    V = np.random.default_rng(1).standard_normal((4, 9))
    with port.solver_device("cpu"):
        f = port.DOptimalObj(V)
        assert f.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port.DOptimalObj(V)


def test_keyed_l2_ball_point_matches_jax():
    from accbpg_and_fw_tpu_torch import _rng

    center = np.array([0.5, -1.0, 2.0, 0.0])
    for pos_dir in (False, True):
        ref = acc.random_point_in_l2_ball_jax_version(
            jnp.asarray(center), 1.5, pos_dir=pos_dir,
            key=jax.random.PRNGKey(4))
        got = port.random_point_in_l2_ball_jax_version(
            center, 1.5, pos_dir=pos_dir, key=_rng.key(4), device="cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-14)
        r = np.linalg.norm(got.numpy() - center)
        assert 0.15 <= r <= 1.485
