"""Linear minimization oracles (LMOs) for the Frank-Wolfe family.

Port of ``accbpg_and_fw_tpu/ops/lmo.py`` (reference: functions_lmo.py):
each ``lmo_*`` returns a closure ``g -> s`` over float64 tensors, with the
JAX package's floors and tie-breaks.  ``torch.argmin`` returns the first
index of a tied minimum, as numpy and ``jnp.argmin`` do, which the
simplex vertices rely on for trace parity.  A closure reads nothing back
to the host: the degenerate-gradient rules are ``torch.where`` selects,
and an array center or bound is copied to each device once, at the
closure's first call there (a copy from the host cannot be captured in a
graph chunk), as JAX's jitted closure takes it as a constant.  The nuclear
ball's top singular pair is a kernel (``ops/svd.py``) that reads nothing
back, so its chunks are captured like the others.
"""

from __future__ import annotations

import numbers

import torch

from .svd import top_singular_pair


def _constant(value):
    """``get(like)``: ``value`` (None for 0, a number, an array or a
    tensor) as a tensor of ``like``'s shape, dtype and device, as the JAX
    closures' ``jnp.broadcast_to(jnp.asarray(value, g.dtype), g.shape)``.
    A number is a fill on the device; an array is copied to a device once
    and kept for the closure's later calls."""
    if value is None:
        return torch.zeros_like
    if isinstance(value, numbers.Real):
        return lambda like: torch.full_like(like, float(value))
    kept = {}

    def get(like):
        key = (like.device, like.dtype)
        if key not in kept:
            kept[key] = torch.as_tensor(value, dtype=like.dtype,
                                        device=like.device)
        return kept[key].expand(like.shape)

    return get


def lmo_nuclear_norm_ball():
    """Rank-1 vertex of the unit nuclear-norm ball: ``outer(u1, v1)`` from
    the top singular pair of g (reference: functions_lmo.py:4-13), by
    one-sided Jacobi (``ops/svd.py``: the kernel on the card, its plain
    version on the CPU).  The product does not depend on the sign of the
    pair; it is ambiguous only at a repeated top singular value."""

    def f(g):
        return top_singular_pair(g)

    return f


def lmo_l2_ball(radius, center=None):
    """argmin_{||s-center||<=radius} <g,s> = center - radius*g/||g||, the
    center itself when ||g|| < 1e-10 (reference: functions_lmo.py:16-51)."""

    center_of = _constant(center)

    def f(g):
        center_p = center_of(g)
        g_norm = torch.linalg.vector_norm(g)
        s = center_p - radius * g / torch.clamp_min(g_norm, 1e-30)
        return torch.where(g_norm < 1e-10, center_p, s)

    return f


def lmo_l2_ball_positive_orthant(radius, center=None, epsilon=0.0):
    """LMO for the L2 ball intersected with {x_i >= epsilon}: move radius
    units along the negative coordinates of g only, then floor at epsilon
    (reference: functions_lmo.py:54-102)."""

    center_of = _constant(center)

    def f(g):
        center_p = center_of(g)
        g_neg = torch.where(g < 0, g, 0.0)
        neg_norm = torch.linalg.vector_norm(g_neg)
        direction = torch.where(
            neg_norm > 0, -g_neg / torch.clamp_min(neg_norm, 1e-30), 0.0)
        s = center_p + radius * direction
        return torch.clamp_min(s, epsilon)

    return f


def lmo_linf_ball(radius, center=None):
    """Vertex of the l-inf ball: center - radius*sign(g)
    (reference: functions_lmo.py:106-134)."""

    center_of = _constant(center)

    def f(g):
        return center_of(g) - radius * torch.sign(g)

    return f


def lmo_simplex(radius=1):
    """Vertex of the radius-simplex at the first argmin coordinate of the
    vector g, with the reference's 1e-15 positivity floor
    (functions_lmo.py:137-160)."""

    def f(g):
        s = torch.full_like(g, 1e-15)
        return s.index_fill_(0, torch.argmin(g).view(1), radius)

    return f


def lmo_matrix_simplex(radius=1.0):
    """Matrix-simplex vertex at the first argmin entry of G, 1e-60 floor
    (reference: functions_lmo.py:163-187)."""

    def f(G):
        flat = G.reshape(-1)
        s = torch.full_like(flat, 1e-60)
        s.index_fill_(0, torch.argmin(flat).view(1), radius)
        return s.reshape(G.shape)

    return f


def lmo_matrix_box(lower, upper):
    """Box LMO: upper where G < 0, else lower
    (reference: functions_lmo.py:190-212)."""

    upper_of, lower_of = _constant(upper), _constant(lower)

    def f(G):
        return torch.where(G < 0, upper_of(G), lower_of(G))

    return f
