"""Device and dtype resolution for the port's public functions."""

from __future__ import annotations

import numpy as np
import torch

DTYPE = torch.float64


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
    needed, anything else always (the solvers never write into it)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=DTYPE)
    return torch.tensor(np.asarray(a, np.float64), device=device)
