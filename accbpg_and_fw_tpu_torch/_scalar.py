"""Host scalars for the drivers' scalar recurrences.

The Bregman drivers keep their scalars (step sizes, theta, gains, the
multiplier of the simplex prox) on the host as Python floats, which are
IEEE doubles, and only the vectors on the device.  A line search has to
bring each trial's accept/reject decision back to the host anyway, so the
scalars it needs come back in the same read (``read``), and the recurrences
between reads cost no kernel launches.

Python raises where IEEE arithmetic gives inf or NaN (division by zero,
``math.log(0)``, overflow in ``math.exp``); ``div``, ``power``, ``log``,
``exp`` and ``expm1`` return what the JAX package's float64 arrays give
instead.  Python's ``min`` drops a NaN that ``jnp.minimum`` propagates;
``minimum`` propagates it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ._device import full

# set by ``diagnostics.debug_mode``: (raise on NaN, raise on Inf)
DEBUG = [False, False]


def read(*vals):
    """``vals`` (0-d tensors or numbers) as Python floats, with one device
    read for all the tensors among them (one host sync on a CUDA device).

    A sharded value (a DTensor, possibly a partial sum or max on each rank)
    is gathered to its full value first, so every rank reads the same
    floats.  Under ``diagnostics.debug_mode`` a NaN (or Inf) among the
    tensors' values raises ``FloatingPointError``."""
    out = [None if isinstance(v, torch.Tensor) else float(v) for v in vals]
    idx = [i for i, v in enumerate(out) if v is None]
    if idx:
        got = torch.stack([full(vals[i]).reshape(()).to(torch.float64)
                           for i in idx]).tolist()
        for i, v in zip(idx, got):
            out[i] = v
        if DEBUG[0] or DEBUG[1]:
            check_finite(got, "a host read")
    return out


def check_finite(values, where):
    """Raise ``FloatingPointError`` if ``values`` (host floats) hold a NaN,
    or an Inf when ``debug_mode(infs=True)`` is active."""
    for v in values:
        if (DEBUG[0] and math.isnan(v)) or (DEBUG[1] and math.isinf(v)):
            raise FloatingPointError(
                f"debug_mode: {v!r} in {where} (the first host read after "
                "the operation that produced it)")


def _ieee(fn, *args):
    with np.errstate(all="ignore"):
        return float(fn(*(np.float64(a) for a in args)))


def div(a, b):
    try:
        return a / b
    except ZeroDivisionError:
        return _ieee(np.divide, a, b)


def power(a, b):
    try:
        return math.pow(a, b)
    except (ValueError, OverflowError):
        return _ieee(np.power, a, b)


def log(a):
    try:
        return math.log(a)
    except ValueError:
        return _ieee(np.log, a)


def exp(a):
    try:
        return math.exp(a)
    except OverflowError:
        return math.inf


def expm1(a):
    try:
        return math.expm1(a)
    except OverflowError:
        return math.inf


def minimum(a, b):
    return a if math.isnan(a) else b if math.isnan(b) else min(a, b)
