"""The port's LMOs (``ops/lmo.py``) against the JAX package's, in float64 on
the same numpy inputs: vectors and matrices, tied minima, a zero gradient.

Bars: the vertices to atol 1e-15 (a norm and a division per entry; the
rest is exact selects), and the same vertex bit for bit where the LMO only
selects (simplex vertices, signs, boxes).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import accbpg_and_fw_tpu as acc
import accbpg_and_fw_tpu_torch as port

torch.set_num_threads(1)

ATOL = 1e-15

# (name, args) of every LMO; the vector-only simplex takes vectors alone
LMOS = [
    ("lmo_l2_ball", (2.5,)), ("lmo_l2_ball", (1.5, 0.25)),
    ("lmo_l2_ball_positive_orthant", (2.0,)),
    ("lmo_l2_ball_positive_orthant", (2.0, 0.5, 0.1)),
    ("lmo_linf_ball", (1.0,)), ("lmo_linf_ball", (1.0, 1.0)),
    ("lmo_simplex", ()), ("lmo_simplex", (3.0,)),
    ("lmo_matrix_simplex", ()), ("lmo_matrix_simplex", (2.0,)),
    ("lmo_matrix_box", (0.0, 1.0)), ("lmo_matrix_box", (-1.0, 2.0)),
    ("lmo_nuclear_norm_ball", ()),
]
SHAPES = {"vector": (17,), "matrix": (6, 4)}


def _gradient(shape, kind):
    rng = np.random.default_rng(11)
    g = rng.standard_normal(shape)
    if kind == "ties":
        # the minimum taken twice, and repeated magnitudes
        flat = g.reshape(-1)
        flat[[2, 9]] = flat.min() - 1.0
        flat[[4, 5]] = flat[3]
    elif kind == "zero":
        g = np.zeros(shape)
    return g


def _cases():
    for name, args in LMOS:
        for shape in SHAPES:
            if shape == "matrix" and name == "lmo_simplex":
                continue
            if shape == "vector" and name == "lmo_nuclear_norm_ball":
                continue
            for kind in ("random", "ties", "zero"):
                if name == "lmo_nuclear_norm_ball" and kind != "random":
                    continue  # its vertex is ambiguous at a repeated top
                    # singular value (a zero gradient has only those)
                yield name, args, shape, kind


@pytest.mark.parametrize("name,args,shape,kind", list(_cases()))
def test_lmo_matches_jax(name, args, shape, kind):
    g = _gradient(SHAPES[shape], kind)
    sj = np.asarray(getattr(acc, name)(*args)(jnp.asarray(g)))
    sp = getattr(port, name)(*args)(torch.tensor(g))
    assert sp.dtype == torch.float64 and tuple(sp.shape) == g.shape
    np.testing.assert_allclose(sp.numpy(), sj, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["lmo_simplex", "lmo_matrix_simplex"])
def test_simplex_vertex_takes_the_first_minimum(name):
    g = np.array([0.5, -2.0, 1.0, -2.0, -2.0, 3.0])
    s = getattr(port, name)(4.0)(torch.tensor(g)).numpy()
    floor = 1e-15 if name == "lmo_simplex" else 1e-60
    expect = np.full(6, floor)
    expect[1] = 4.0
    np.testing.assert_array_equal(s, expect)


def test_l2_ball_zero_gradient_stays_at_the_center():
    center = np.array([0.5, -1.0, 2.0])
    for g in (np.zeros(3), np.full(3, 1e-12)):
        s = port.lmo_l2_ball(3.0, center)(torch.tensor(g))
        np.testing.assert_array_equal(s.numpy(), center)


def test_nuclear_norm_vertex_is_the_top_singular_pair():
    rng = np.random.default_rng(5)
    U, _ = np.linalg.qr(rng.standard_normal((6, 4)))
    W, _ = np.linalg.qr(rng.standard_normal((4, 4)))
    g = (U * np.array([5.0, 2.0, 1.0, 0.5])) @ W.T  # a gap at the top
    s = port.lmo_nuclear_norm_ball()(torch.tensor(g)).numpy()
    np.testing.assert_allclose(s, np.outer(U[:, 0], W[:, 0]), atol=1e-14)
    # the reference's sign convention: outer(u1, v1), so <g, s> = +sigma_1
    np.testing.assert_allclose(np.vdot(g, s), 5.0, rtol=1e-14)
