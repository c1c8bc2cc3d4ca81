"""The port's native LIBSVM parser (``accbpg_and_fw_tpu_torch/native``, a
copy of the JAX package's ``native/libsvm_parser.cpp`` built by the port's
own loader into ``build/native``) and ``apps/utils.load_libsvm_file``,
held against the JAX loader on synthetic files, as ``tests/test_native.py``
holds the JAX package's: the same CSR arrays and labels, the same errors,
and the a9a factory on a small file of a9a's kind.
"""

import gzip
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu_torch import native
from accbpg_and_fw_tpu_torch.apps import utils

from test_torch_lazy import keep_jax_exec_cache  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]

SAMPLE = """\
1 1:0.5 3:-1.25 7:3e-2
-1 2:1.0 3:2.5   # trailing comment
# full comment line

2.5 1:4 2:5 3:6 8:7.5
"""


@pytest.fixture
def svm_file(tmp_path):
    p = tmp_path / "sample.libsvm"
    p.write_text(SAMPLE)
    return str(p)


def _a9a_like(path, rows, seed):
    """A small file of a9a's kind: 123 binary features, 14 ones a row,
    labels +1 / -1."""
    rng = np.random.default_rng(seed)
    cols = np.sort(np.argsort(rng.random((rows, 123)), axis=1)[:, :14],
                   axis=1) + 1
    labels = np.where(rng.random(rows) < 0.24, "+1", "-1")
    path.write_text("\n".join(f"{lab} " + " ".join(f"{j}:1" for j in row)
                              for lab, row in zip(labels, cols)) + "\n")
    return str(path)


def test_native_parser_is_built_from_the_ports_copy():
    """The native path is the one taken on this host (g++ is here): the
    library is the port's own source's build under ``build/native``."""
    lib = native.load_native_library("libsvm_parser")
    assert lib is not None
    out = native.library_path("libsvm_parser")
    assert out.exists() and out.parent == ROOT / "build" / "native"
    assert (Path(native.__file__).parent / "libsvm_parser.cpp").exists()


@pytest.mark.parametrize("zero_based", ["auto", False, True])
def test_native_parse_matches_the_jax_loader(svm_file, zero_based):
    from accbpg_and_fw_tpu.apps.utils import load_libsvm_file as jax_load

    assert utils._load_libsvm_native(svm_file) is not None
    X, y = utils.load_libsvm_file(svm_file, zero_based=zero_based)
    Xj, yj = jax_load(svm_file, zero_based=zero_based)
    assert X.shape == Xj.shape
    for name in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(X, name), getattr(Xj, name))
    np.testing.assert_array_equal(y, yj)


def test_native_matches_the_python_parse(svm_file, tmp_path):
    X, y = utils.load_libsvm_file(svm_file)  # the native parse
    gz = tmp_path / "sample.libsvm.gz"
    with gzip.open(gz, "wt") as fh:
        fh.write(SAMPLE)
    Xp, yp = utils.load_libsvm_file(str(gz))  # the Python parse
    np.testing.assert_array_equal(y, yp)
    assert X.shape == Xp.shape == (3, 8)
    np.testing.assert_array_equal(X.toarray(), Xp.toarray())
    assert X[0, 6] == pytest.approx(0.03) and X[2, 7] == 7.5


def test_n_features_grows_like_jax(svm_file, capsys):
    from accbpg_and_fw_tpu.apps.utils import load_libsvm_file as jax_load

    assert utils.load_libsvm_file(svm_file, n_features=20)[0].shape == (3, 20)
    X, _ = utils.load_libsvm_file(svm_file, n_features=4)
    ours = capsys.readouterr().out
    Xj, _ = jax_load(svm_file, n_features=4)
    assert X.shape == Xj.shape == (3, 8)
    assert ours == capsys.readouterr().out == (
        "Warning: n_features increased to match data.\n")


@pytest.mark.parametrize("text,kw,match", [
    ("1 3:1.0 2:2.0\n", {}, "sorted and unique"),
    ("1 0:1.0 2:2.0\n", dict(zero_based=False), "Invalid index 0"),
    ("1 -2:1.0\n", {}, "Invalid"),
])
def test_errors_match_jax(tmp_path, text, kw, match):
    from accbpg_and_fw_tpu.apps.utils import load_libsvm_file as jax_load

    p = tmp_path / "bad.libsvm"
    p.write_text(text)
    for load in (utils.load_libsvm_file, jax_load):
        with pytest.raises(ValueError, match=match):
            load(str(p), **kw)


def test_no_trailing_newline_page_multiple(tmp_path):
    """A file whose size is a multiple of the page size and whose last
    line ends mid-token: the parser reads that line from a NUL-terminated
    copy, not past the mapping."""
    page = 4096
    row = "1 1:0.5 2:-1.25\n"
    tail = "-1 1:2.5 2:0.125"
    nrows = 100
    fixed = len(row) * nrows + 1 + len(tail)
    total = -(-fixed // page) * page
    content = row * nrows + "#" * (total - fixed) + "\n" + tail
    assert len(content) % page == 0
    p = tmp_path / "exact.libsvm"
    p.write_bytes(content.encode())
    data, indices, indptr, labels = utils._load_libsvm_native(str(p))
    assert len(labels) == nrows + 1 and labels[-1] == -1
    assert data[-1] == 0.125 and indptr[-1] == len(data) == 2 * (nrows + 1)


def test_a9a_factory_matches_jax_on_a_small_file(tmp_path):
    """``L0L1_FW_log_reg_a9a`` on a 300-row file of a9a's kind against
    JAX's factory after the same ``np.random`` seed: the standardized
    data, labels, constants and start."""
    import accbpg_and_fw_tpu as acc

    path = _a9a_like(tmp_path / "a9a_small", 300, seed=3)
    np.random.seed(2025)
    fj, hj, Lj, L0j, L1j, x0j = acc.L0L1_FW_log_reg_a9a(250.0, path)
    np.random.seed(2025)
    fp, hp, Lp, L0p, L1p, x0p = port.L0L1_FW_log_reg_a9a(250.0, path,
                                                        device="cpu")
    assert fp.X.shape == (300, 124)
    np.testing.assert_allclose(fp.X.numpy(), np.asarray(fj.X), rtol=0,
                               atol=1e-15)
    np.testing.assert_array_equal(fp.y.numpy(), np.asarray(fj.y))
    np.testing.assert_allclose([Lp, L0p, L1p],
                               [float(Lj), float(L0j), float(L1j)],
                               rtol=1e-15)
    np.testing.assert_array_equal(x0p.numpy(), np.asarray(x0j))
    assert isinstance(hp, port.SquaredL2Norm) and x0p.dtype == torch.float64


def test_parser_leaves_the_jax_package_out(tmp_path):
    """Loading the port's parser imports nothing of the JAX package."""
    path = _a9a_like(tmp_path / "a9a_tiny", 20, seed=4)
    code = ("import sys\n"
            "from accbpg_and_fw_tpu_torch.apps import utils\n"
            f"X, y = utils.load_libsvm_file({path!r})\n"
            "assert utils._load_libsvm_native(" f"{path!r}) is not None\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'accbpg_and_fw_tpu.')) or "
            "m == 'accbpg_and_fw_tpu')\n"
            "print(X.shape, bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "(20, 123) []"
