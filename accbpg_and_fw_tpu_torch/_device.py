"""Device and dtype resolution for the port's public functions.

A sharded input is a ``torch.distributed.tensor.DTensor`` (placed by
``parallel/mesh.py``).  It keeps its placement through these functions:
``resolve_device`` gives its local device and ``as_f64`` converts its
dtype where it lies.  ``is_dtensor`` asks without importing
``torch.distributed.tensor`` (over a second to import): no tensor can be a
DTensor before some module has imported it.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

DTYPE = torch.float64

# the device that ``solver_device`` pins for inputs that are not tensors
_OVERRIDE = [None]


def is_dtensor(a) -> bool:
    """Whether ``a`` is a sharded ``DTensor``."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(a, mod.DTensor)


def full(a):
    """``a`` as a plain tensor: a DTensor gathered to its full value on
    every rank (a collective), anything else as it is."""
    return a.full_tensor() if is_dtensor(a) else a


def replicated(a):
    """A DTensor's pending partial sums (or maxima) reduced, so every rank
    holds its whole value (an all-reduce); anything else as it is."""
    if not is_dtensor(a):
        return a
    from torch.distributed.tensor import Replicate

    return a.redistribute(placements=[Replicate()] * a.device_mesh.ndim)


def replicate_like(a, ref):
    """``a``, a plain tensor that every rank holds whole (a Gram, its
    inverse), as a replicated DTensor on ``ref``'s mesh where ``ref`` is a
    DTensor, so the two can meet in one operation (no communication);
    else ``a`` as it is."""
    if not is_dtensor(ref) or is_dtensor(a):
        return a
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


@contextlib.contextmanager
def solver_device(device):
    """Run the entry points inside the block on ``device`` where the caller
    gives no device and no tensor: numpy inputs land there instead of on
    CUDA (the JAX ``solver_device`` pins its drivers' device the same
    way).  A tensor input keeps its own device, as outside the block."""
    prev = _OVERRIDE[0]
    _OVERRIDE[0] = torch.device(device)
    try:
        yield
    finally:
        _OVERRIDE[0] = prev


def resolve_device(device=None, like=None) -> torch.device:
    """The device a solve runs on.

    The port runs on the card unless the caller asks for the CPU:
    ``device=None`` keeps a tensor input's device and puts anything else
    (numpy arrays, lists) on CUDA; ``device="cpu"`` asks for the CPU.  On a
    machine without a card the default raises, as an explicit
    ``device="cuda"`` does, instead of falling back."""
    if device is None:
        if isinstance(like, torch.Tensor):
            return like.device
        if _OVERRIDE[0] is not None:
            device = _OVERRIDE[0]
            asked = f"solver_device({device!s}) was entered"
        else:
            device = "cuda"
            asked = "no device was given, the port's default is CUDA,"
    else:
        asked = f"device={device!r} was requested"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{asked} but torch.cuda.is_available() is False (no CUDA card, "
            'or a CPU-only torch build); pass device="cpu" or CPU tensors '
            "to run on the CPU")
    return dev


def as_f64(a, device: torch.device) -> torch.Tensor:
    """``a`` as a float64 tensor on ``device``: a tensor is copied only when
    needed, anything else always (the solvers never write into it).  A
    DTensor keeps its placement on its mesh (its dtype converts shard by
    shard)."""
    if is_dtensor(a):
        return a.to(dtype=DTYPE)
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=DTYPE)
    return torch.tensor(np.asarray(a, np.float64), device=device)
