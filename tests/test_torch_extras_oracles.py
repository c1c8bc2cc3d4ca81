"""The last oracles, factories and loaders of the port against the JAX
package, on the same inputs in float64:

* ``SumOf2nd4thPowersDualProxMap.div_prox_map`` at 1e-12, on inputs whose
  inner loop exits on its gap test and on inputs that run it to
  ``num_iters`` (1, 2 and 30 steps; one step is the JAX loop's exit at
  ``it == 1``), with every block length giving the same iterate;
* ``AX_b`` and ``calculate_tse_constant`` (the cases of
  tests/test_f_oracles.py and tests/test_misc.py, and the ValueError);
* ``load_libsvm_file`` on synthetic files (plain, gzip, bz2, the error
  cases) against the JAX loader, ``row_norm_squared``, ``load_sido``;
  ``D_opt_libsvm``, ``load_a9a_data`` and ``L0L1_FW_log_reg_a9a`` on a
  synthetic a9a-shaped file (the data is not in the repository and
  nothing is downloaded).
"""

import bz2
import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu as acc
import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu_torch.interop import from_jax_oracle
from accbpg_and_fw_tpu_torch.ops import dual_prox as port_dp

from test_torch_lazy import keep_jax_exec_cache  # noqa: F401 (autouse)

torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


# ---------------------------------------------------------------------------
# SumOf2nd4thPowersDualProxMap
# ---------------------------------------------------------------------------


def _reads(steps, num_iters, block):
    """The exit flag is read after every block but one that ends at
    ``num_iters``: up to the block that holds the last step taken."""
    return min(-(-steps // block), -(-num_iters // block) - 1)


def _dual_case(n, r, seed, L, **kw):
    rng = np.random.default_rng(seed)
    y, g = rng.random((n, r)), rng.standard_normal((n, r))
    hj = acc.SumOf2nd4thPowersDualProxMap(alpha=6.0, sigma=3.0, **kw)
    return hj, from_jax_oracle(hj), y, g, L


@pytest.mark.parametrize("num_iters,L,exits_early", [
    (7000, 1.0, True),     # the gap test fires after 1315 steps
    (1, 1.0, False),       # the JAX loop's exit at it == 1
    (2, 1.0, False),       # the first step's gap never exits
    (30, 5.0, False),
])
def test_dual_prox_map_matches_jax(num_iters, L, exits_early):
    hj, hp, y, g, L = _dual_case(12, 3, 0, L, num_iters=num_iters)
    Xj = np.asarray(hj.div_prox_map(jnp.asarray(y), jnp.asarray(g), L))
    X, steps, reads = hp.dual_solve(_t(y), _t(g), L)
    np.testing.assert_allclose(X.numpy(), Xj, rtol=1e-12, atol=1e-12)
    assert (int(steps) < num_iters) == exits_early
    assert reads == _reads(int(steps), num_iters, port_dp.DUAL_BLOCK)
    np.testing.assert_array_equal(hp.div_prox_map(_t(y), _t(g), L).numpy(),
                                  X.numpy())


@pytest.mark.parametrize("block", [1, 7, 4096])
def test_dual_prox_map_block_length_changes_reads_only(monkeypatch, block):
    _, hp, y, g, L = _dual_case(10, 2, 3, 2.0, num_iters=400,
                                tolerance=1e-3)
    ref, steps, _ = hp.dual_solve(_t(y), _t(g), L)
    assert 2 < int(steps) < 400
    monkeypatch.setattr(port_dp, "DUAL_BLOCK", block)
    got, steps_b, reads = hp.dual_solve(_t(y), _t(g), L)
    assert torch.equal(got, ref) and int(steps_b) == int(steps)
    assert reads == _reads(int(steps), 400, block)


def test_dual_prox_map_fields_cross_over():
    hj = acc.SumOf2nd4thPowersDualProxMap(alpha=2.0, sigma=0.5, num_iters=9,
                                          eta_base=0.02, tolerance=1e-5,
                                          radius=3.0)
    hp = from_jax_oracle(hj)
    assert type(hp) is port.SumOf2nd4thPowersDualProxMap
    assert (hp.alpha, hp.sigma, hp.num_iters, hp.eta_base, hp.tolerance,
            hp.radius) == (2.0, 0.5, 9, 0.02, 1e-5, 3.0)
    x = np.random.default_rng(1).random((6, 2))
    np.testing.assert_allclose(hp.value(_t(x)).item(),
                               float(hj.value(jnp.asarray(x))), rtol=1e-14)


# ---------------------------------------------------------------------------
# AX_b and calculate_tse_constant
# ---------------------------------------------------------------------------


def test_ax_b_matches_jax():
    rng = np.random.default_rng(0)
    n, r = 6, 4
    A, b, X = rng.uniform(size=r), rng.uniform(size=n), rng.uniform(size=(n, r))
    gj = acc.AX_b(A=jnp.asarray(A), b=jnp.asarray(b))
    gp = from_jax_oracle(gj, device="cpu")
    assert type(gp) is port.AX_b
    v, gr = gp.value_and_grad(_t(X))
    np.testing.assert_allclose(v.numpy(), np.asarray(gj.value(X)),
                               rtol=1e-15)
    np.testing.assert_array_equal(gr.numpy(), A)
    np.testing.assert_array_equal(gp.grad(_t(X)).numpy(), A)
    np.testing.assert_array_equal(gp.value(_t(X)).numpy(), v.numpy())


def _tse_cases():
    rng = np.random.default_rng(0)
    x, y, z = (rng.standard_normal(10) for _ in range(3))
    a = 0.3
    yield "euclid", "SquaredL2Norm", ((1 - a) * x + a * y, (1 - a) * x + a * z,
                                      y, z, a)
    z0, z1 = np.array([0.0, 0.0]), np.array([1.0, 1.0])
    y0 = np.array([0.5, 0.5])
    yield "shift", "SquaredL2Norm", (y0 + a * (z1 - z0), y0, z1, z0, a)
    p = rng.uniform(0.5, 1.5, (4, 12))
    yield "burg", "BurgEntropy", (p[0], p[1], p[2], p[3], 0.6)
    yield "none feasible", "BurgEntropy", (p[0], p[1], p[0], p[0] * 1.0001,
                                           0.2)


@pytest.mark.parametrize("label,kernel,args",
                         list(_tse_cases()), ids=[c[0] for c in _tse_cases()])
def test_calculate_tse_constant_matches_jax(label, kernel, args):
    *vecs, alpha = args
    gj = float(acc.calculate_tse_constant(getattr(acc, kernel)(),
                                          *map(jnp.asarray, vecs), alpha))
    gp = port.calculate_tse_constant(getattr(port, kernel)(),
                                     *map(_t, vecs), alpha)
    assert isinstance(gp, torch.Tensor) and gp.dim() == 0
    assert float(gp) == gj
    if label in ("euclid", "shift"):
        assert abs(gj - 2.0) < 1e-3


@pytest.mark.parametrize("alpha", [1.5, 0.0, 1.0, -0.2])
def test_calculate_tse_rejects_bad_alpha(alpha):
    v = torch.ones(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="interval"):
        port.calculate_tse_constant(port.SquaredL2Norm(), v, v, v, v, alpha)


# ---------------------------------------------------------------------------
# LIBSVM files and the factories that read them
# ---------------------------------------------------------------------------

SAMPLE = """\
1 1:0.5 3:-1.25 7:3e-2
-1 2:1.0 3:2.5   # trailing comment
# full comment line

2.5 1:4 2:5 3:6 8:7.5
"""


def _write(path, text):
    if path.suffix == ".gz":
        with gzip.open(path, "wt") as fh:
            fh.write(text)
    elif path.suffix == ".bz2":
        with bz2.open(path, "wt") as fh:
            fh.write(text)
    else:
        path.write_text(text)
    return str(path)


def _same_csr(Xp, yp, Xj, yj):
    assert Xp.shape == Xj.shape and Xp.format == "csr"
    np.testing.assert_array_equal(Xp.toarray(), Xj.toarray())
    np.testing.assert_array_equal(Xp.indices, Xj.indices)
    np.testing.assert_array_equal(yp, yj)


@pytest.mark.parametrize("suffix", [".libsvm", ".libsvm.gz", ".libsvm.bz2"])
@pytest.mark.parametrize("zero_based", ["auto", False, True])
def test_load_libsvm_file_matches_jax(tmp_path, suffix, zero_based):
    p = _write(tmp_path / f"sample{suffix}", SAMPLE)
    Xj, yj = acc.load_libsvm_file(p, zero_based=zero_based)
    Xp, yp = port.load_libsvm_file(p, zero_based=zero_based)
    _same_csr(Xp, yp, Xj, yj)
    assert Xp.shape == ((3, 8) if zero_based in ("auto", False) else (3, 9))


def test_load_libsvm_file_zero_based_auto_and_n_features(tmp_path, capsys):
    p = _write(tmp_path / "z.libsvm", "1 0:1.5 4:2\n-1 2:3\n")
    Xp, yp = port.load_libsvm_file(p)
    assert Xp.shape == (2, 5) and Xp[0, 0] == 1.5
    Xp, _ = port.load_libsvm_file(p, n_features=9)
    assert Xp.shape == (2, 9)
    Xp, _ = port.load_libsvm_file(p, n_features=2)
    assert Xp.shape == (2, 5)
    assert "n_features increased" in capsys.readouterr().out


@pytest.mark.parametrize("text,match", [
    ("1 3:1.0 2:2.0\n", "sorted and unique"),
    ("1 2:1.0 2:2.0\n", "sorted and unique"),
    ("1 -1:1.0\n", "Invalid"),  # the JAX C++ parser words it its own way
])
def test_load_libsvm_file_errors(tmp_path, text, match):
    for suffix in (".libsvm", ".libsvm.gz"):
        p = _write(tmp_path / f"bad{suffix}", text)
        with pytest.raises(ValueError, match=match):
            port.load_libsvm_file(p)
        with pytest.raises(ValueError, match=match):
            acc.load_libsvm_file(p)


def test_load_libsvm_file_index_zero_when_one_based(tmp_path):
    p = _write(tmp_path / "zero.libsvm", "1 0:1.0 2:1.0\n")
    with pytest.raises(ValueError, match="Invalid index 0"):
        port.load_libsvm_file(p, zero_based=False)


def test_row_norm_squared_and_load_sido(tmp_path):
    Xp, _ = port.load_libsvm_file(_write(tmp_path / "s.libsvm", SAMPLE))
    np.testing.assert_array_equal(port.row_norm_squared(Xp),
                                  acc.row_norm_squared(Xp))
    np.testing.assert_allclose(port.row_norm_squared(Xp),
                               (Xp.toarray() ** 2).sum(1), rtol=1e-15)
    ck = tmp_path / "sido.npz"
    np.savez(ck, Xdata=Xp.data, Xindices=Xp.indices, Xindptr=Xp.indptr,
             shape=np.asarray(Xp.shape), y=np.array([1, -1, 1]))
    Xs, ys = port.load_sido(str(ck))
    Xr, yr = acc.load_sido(str(ck))
    _same_csr(Xs, ys, Xr, yr)


@pytest.fixture(scope="module")
def a9a_file(tmp_path_factory):
    """An a9a-shaped file: 0/1 features (123 columns, about 14 per row),
    labels +1 and -1, 300 rows."""
    rng = np.random.default_rng(9)
    rows = []
    for _ in range(300):
        idx = np.sort(rng.choice(123, size=14, replace=False)) + 1
        rows.append(("+1 " if rng.random() < 0.25 else "-1 ")
                    + " ".join(f"{i}:1" for i in idx))
    path = tmp_path_factory.mktemp("a9a") / "a9a"
    return _write(path, "\n".join(rows) + "\n")


@pytest.mark.parametrize("bias", [True, False])
def test_load_a9a_data_matches_jax(a9a_file, bias):
    Xp, yp = port.load_a9a_data(a9a_file, bias=bias)
    Xj, yj = acc.load_a9a_data(a9a_file, bias=bias)
    np.testing.assert_array_equal(Xp, Xj)
    np.testing.assert_array_equal(yp, yj)
    assert set(np.unique(yp)) == {-1, 1}


def test_l0l1_fw_log_reg_a9a_matches_jax(a9a_file):
    np.random.seed(4)
    fj, hj, Lj, L0j, L1j, x0j = acc.L0L1_FW_log_reg_a9a(5.0, a9a_file)
    np.random.seed(4)
    fp, hp, Lp, L0p, L1p, x0p = port.L0L1_FW_log_reg_a9a(5.0, a9a_file,
                                                        device="cpu")
    np.testing.assert_array_equal(fp.X.numpy(), np.asarray(fj.X))
    np.testing.assert_array_equal(fp.y.numpy(), np.asarray(fj.y))
    np.testing.assert_array_equal(x0p.numpy(), np.asarray(x0j))
    assert (Lp, L0p, L1p) == (Lj, L0j, L1j)
    assert type(hp) is port.SquaredL2Norm
    vj, gj = fj.value_and_grad(x0j)
    vp, gp = fp.value_and_grad(x0p)
    np.testing.assert_allclose(vp.item(), float(vj), rtol=1e-13)
    np.testing.assert_allclose(gp.numpy(), np.asarray(gj), rtol=1e-12,
                               atol=1e-15)


def test_d_opt_libsvm_matches_jax(a9a_file, tmp_path):
    for path in (a9a_file, _write(tmp_path / "wide.libsvm",
                                  "1 1:1 2:2 5:1\n-1 3:1 4:2\n1 2:3 5:1\n")):
        fj, hj, Lj, x0j = acc.D_opt_libsvm(path)
        fp, hp, Lp, x0p = port.D_opt_libsvm(path, device="cpu")
        np.testing.assert_array_equal(fp.H.numpy(), np.asarray(fj.H))
        np.testing.assert_array_equal(x0p.numpy(), np.asarray(x0j))
        assert Lp == Lj and type(hp) is port.BurgEntropySimplex
        assert fp.H.shape[0] <= fp.H.shape[1]
