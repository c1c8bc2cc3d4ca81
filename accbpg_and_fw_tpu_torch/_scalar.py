"""Host reads of device scalars, and ``diagnostics.debug_mode``'s check.

``read`` brings 0-d tensors back as Python floats in one device read (one
host sync on a CUDA device), where a caller needs the numbers on the host;
under ``debug_mode`` a NaN (or Inf) among them raises.
"""

from __future__ import annotations

import math

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
