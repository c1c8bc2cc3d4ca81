"""Device and dtype resolution for the port's public functions."""

from __future__ import annotations

import numpy as np
import torch

DTYPE = torch.float64


def resolve_device(device=None, like=None) -> torch.device:
    """The device a solve runs on.

    ``device=None`` keeps a tensor input's device and puts anything else
    (numpy arrays, lists) on the CPU.  Asking for CUDA on a machine without
    a card raises instead of falling back."""
    if device is None:
        if isinstance(like, torch.Tensor):
            return like.device
        return torch.device("cpu")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} was requested but torch.cuda.is_available() "
            "is False (no CUDA card, or a CPU-only torch build)")
    return dev


def as_f64(a, device: torch.device) -> torch.Tensor:
    """``a`` as a float64 tensor on ``device``: a tensor is copied only when
    needed, anything else always (the solvers never write into it)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=DTYPE)
    return torch.tensor(np.asarray(a, np.float64), device=device)
