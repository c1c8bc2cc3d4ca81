"""Data loading, sampling and metric helpers of the problem factories.

The port's own copy of the numpy helpers of
``accbpg_and_fw_tpu/apps/utils.py`` (reference: accbpg/utils.py): the same
numpy call sequences, so the same ``np.random`` state gives the same
arrays bit for bit.  Every function here is numpy in and numpy out.
``generate_dataset_for_svm`` draws from an unseeded generator, as there.
``load_libsvm_file`` parses a plain file with the port's copy of the JAX
package's C++ parser (``native/libsvm_parser.cpp``, built by
``native.load_native_library``) and a compressed one, or any file on a
host without ``g++``, with the single-pass Python parse, as there.
"""

from __future__ import annotations

import os.path

import numpy as np
import torch

try:
    import scipy.sparse as sparse
except ImportError:  # pragma: no cover
    sparse = None


def _open_maybe_compressed(filename):
    _, ext = os.path.splitext(filename)
    if ext == ".gz":
        import gzip

        return gzip.open(filename, "rt")
    if ext == ".bz2":
        import bz2

        return bz2.open(filename, "rt")
    return open(filename, "r")


def _load_libsvm_native(filename):
    """mmap + C++ single-pass parse (``native/libsvm_parser.cpp``): the
    ``(data, indices, indptr, labels)`` numpy arrays, or None where the
    parser is not available (or cannot open the file: the Python parse then
    raises)."""
    import ctypes

    from ..native import load_native_library

    lib = load_native_library("libsvm_parser")
    if lib is None:
        return None
    lib.libsvm_parse.restype = ctypes.c_void_p
    lib.libsvm_parse.argtypes = [ctypes.c_char_p]
    lib.libsvm_last_error.restype = ctypes.c_char_p
    lib.libsvm_nnz.restype = ctypes.c_int64
    lib.libsvm_nnz.argtypes = [ctypes.c_void_p]
    lib.libsvm_rows.restype = ctypes.c_int64
    lib.libsvm_rows.argtypes = [ctypes.c_void_p]
    lib.libsvm_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
    lib.libsvm_free.argtypes = [ctypes.c_void_p]

    handle = lib.libsvm_parse(os.fsencode(filename))
    if not handle:
        err = lib.libsvm_last_error().decode()
        if "sorted and unique" in err or "Invalid" in err:
            raise ValueError(err)
        return None
    try:
        nnz = lib.libsvm_nnz(handle)
        rows = lib.libsvm_rows(handle)
        data = np.empty(nnz, np.float64)
        indices = np.empty(nnz, np.int64)
        indptr = np.empty(rows + 1, np.int64)
        labels = np.empty(rows, np.float64)
        lib.libsvm_fill(handle, *(a.ctypes.data_as(ctypes.c_void_p)
                                  for a in (data, indices, indptr, labels)))
    finally:
        lib.libsvm_free(handle)
    return data, indices, indptr, labels


def _grown(n_features, nf):
    """The JAX loader's column count: ``n_features``, grown (with its
    warning) to the data's."""
    if n_features is None:
        return nf
    if n_features < nf:
        print("Warning: n_features increased to match data.")
        return nf
    return n_features


def load_libsvm_file(filename, dtype=np.float64, n_features=None,
                     zero_based="auto"):
    """Parse an svmlight/LIBSVM file (plain, ``.gz`` or ``.bz2``) into
    ``(CSR matrix, labels)`` (reference: utils.py:22-95).  Comments
    (``#``) are stripped; indices must be sorted and unique per row, and
    positive unless ``zero_based`` (``"auto"``: zero-based when an index 0
    occurs).  A plain file goes through the C++ parser, a compressed one
    (or any, without ``g++``) through the Python parse, with the JAX
    loader's rules and errors either way."""
    _, ext = os.path.splitext(filename)
    native = None if ext in (".gz", ".bz2") else _load_libsvm_native(
        filename)
    if native is not None:
        data, indices, indptr, labels = native
        if zero_based is False and indices.size and indices.min() == 0:
            raise ValueError("Invalid index 0 in LibSVM data file.")
        if zero_based is False or (zero_based == "auto" and indices.size
                                   and indices.min() > 0):
            indices = indices - 1
        n_features = _grown(n_features,
                            int(indices.max()) + 1 if indices.size else 0)
        X = sparse.csr_matrix((data.astype(dtype, copy=False), indices,
                               indptr), shape=(len(labels), n_features))
        X.sort_indices()
        return X, labels

    labels, data, indices, indptr = [], [], [], [0]

    with _open_maybe_compressed(filename) as fh:
        for line in fh:
            hash_pos = line.find("#")
            if hash_pos >= 0:
                line = line[:hash_pos]
            parts = line.split()
            if not parts:
                continue
            labels.append(float(parts[0]))
            prev = -1
            for tok in parts[1:]:
                idx_s, val_s = tok.split(":", 1)
                idx = int(idx_s)
                if idx < 0 or (zero_based is False and idx == 0):
                    raise ValueError(
                        f"Invalid index {idx} in LibSVM data file.")
                if idx <= prev:
                    raise ValueError(
                        "Feature indices in LibSVM data file should be "
                        "sorted and unique.")
                indices.append(idx)
                data.append(dtype(val_s))
                prev = idx
            indptr.append(len(data))

    data = np.asarray(data, dtype=dtype)
    indices = np.asarray(indices, dtype=np.int64)
    indptr = np.asarray(indptr, dtype=np.int64)

    if zero_based is False or (zero_based == "auto" and indices.min() > 0):
        indices = indices - 1
    n_features = _grown(n_features, int(indices.max()) + 1)

    X = sparse.csr_matrix((data, indices, indptr),
                          shape=(len(labels), n_features))
    X.sort_indices()
    return X, np.asarray(labels)


def row_norm_squared(X):
    """Squared 2-norm of every row of a CSR matrix (reference:
    utils.py:142-145)."""
    X2 = sparse.csr_matrix((X.data**2, X.indices, X.indptr), X.shape)
    return np.squeeze(np.asarray(X2.sum(1)))


def load_sido(filename):
    """Load the sido0 npz-packed CSR dataset (reference: utils.py:148-158)."""
    with np.load(filename) as D:
        X = sparse.csr_matrix((D["Xdata"], D["Xindices"], D["Xindptr"]),
                              D["shape"])
        y = D["y"]
    return X, y


def shuffle_data(X, y):
    """Shuffle rows of X and y together (reference: utils.py:98-107)."""
    index = np.arange(len(y))
    np.random.shuffle(index)
    return X[index, :], y[index]


def mnist_2digits(X, y, d1, d2):
    """Binary +-1 subproblem of two digit classes (reference: utils.py:110-120)."""
    idx1 = np.nonzero(y == d1)
    idx2 = np.nonzero(y == d2)
    yy = y.copy()
    yy[idx1] = 1
    yy[idx2] = -1
    index = np.concatenate((idx1[0], idx2[0]))
    np.random.shuffle(index)
    return X[index, :], yy[index]


def _dense(a):
    return a if sparse is not None and sparse.issparse(a) else np.asarray(a)


def binary_error_rate(X, y, w, bias=0):
    """Classification error of sign(Xw + bias) (reference: utils.py:123-129)."""
    yp = np.sign(_dense(X) @ np.asarray(w) + bias)
    return (1 - np.dot(yp, y) / len(y)) / 2


def rmse(X, y, w, bias=0):
    """Root-mean-square prediction error (reference: utils.py:132-139)."""
    yp = _dense(X) @ np.asarray(w) + bias
    return np.sqrt(np.mean((yp - y) ** 2))


def generate_dataset_for_svm(m, n):
    """Random normal dataset with sign-balance labels, from an unseeded
    generator (reference: utils.py:161-192)."""
    rng = np.random.default_rng()
    data = rng.standard_normal((m, n)) * 100
    labels = np.where((data > 0).sum(axis=1) < n * 0.53, 1, -1)
    return data, labels


def random_point_in_l2_ball(center, radius, spread_btm=0.1, spread_up=0.99,
                            pos_dir=False):
    """Uniform direction, uniform radius in [r*btm, r*up]
    (reference: utils.py:195-212)."""
    direction = np.random.randn(len(center))
    direction /= np.linalg.norm(direction)
    if pos_dir:
        direction = np.abs(direction)
    r = np.random.uniform(radius * spread_btm, radius * spread_up)
    point = center + r * direction
    assert np.linalg.norm(point - center) - radius <= 1e-15
    return point


def random_point_in_l2_ball_jax_version(center, radius, spread_btm=0.1,
                                        spread_up=0.99, pos_dir=False,
                                        key=None, device=None):
    """Keyed version of random_point_in_l2_ball (reference:
    utils.py:214-249): the direction and the radius are drawn from the two
    keys JAX splits ``key`` into, with ``_rng``'s draws, JAX's; ``key`` is
    a device key as ``_rng.key(seed)`` makes it, or JAX's ``uint32[2]``
    words, and moves to the result's device.  A float64 tensor on
    ``device`` (for None a tensor ``center``'s device, else CUDA)."""
    assert key is not None, ("You must pass a PRNG key (_rng.key(seed), "
                             "the device key)")
    from .. import _rng
    from .._device import as_f64, resolve_device

    center = as_f64(center, resolve_device(device, like=center))
    key_dir, key_radius = _rng.split(_rng.as_key(key, center.device))
    direction = _rng.normal(key_dir, center.shape)
    direction = direction / torch.linalg.vector_norm(direction)
    if pos_dir:
        direction = torch.abs(direction)
    lo, hi = radius * spread_btm, radius * spread_up
    r = lo + (hi - lo) * _rng.uniform(key_radius)
    return center + r * direction


def random_point_on_simplex(n, radius=1, center=False):
    """Uniform-gap point on the radius-simplex (reference: utils.py:252-268)."""
    if center:
        return np.ones(n) / n
    cuts = np.sort(np.random.uniform(0.01, radius, size=n - 1))
    cuts = np.concatenate([[0.0], cuts, [radius]])
    return np.diff(cuts)


def edge_point_on_simplex(edge_index, n, radius=1, tol=1e-5):
    """Near-vertex point on the simplex (reference: utils.py:271-275)."""
    x = np.full(n, tol)
    x[edge_index] = radius - tol * (n - 1)
    return x


def get_random_float(var=1):
    """Uniform draw in (0, var]; 0 when var == 0 (reference: utils.py:278-285)."""
    if var == 0:
        return 0
    assert var > 0, "The range must be positive."
    return var * np.random.random_sample()


def get_random_vector(size, range=1):  # noqa: A002 - reference kwarg name
    """Uniform vector in (0, range]^size (reference: utils.py:288-295)."""
    if range == 0:
        return np.zeros(size)
    assert range > 0, "The range must be positive."
    return range * np.random.random_sample(size=size)
