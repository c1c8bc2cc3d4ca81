"""Burg-simplex multiplier in one kernel: the counterpart of
``accbpg_and_fw_tpu/ops/pallas_kernels.py``.

``simplex_inv_multiplier_pallas(gg)`` solves ``sum_i 1/(gg_i + c) = 1`` for
``c`` with the TPU kernel's algorithm (``_simplex_kernel``): 64 bisection
steps from ``cmin + 1`` toward ``cmin = -min(gg)`` while the residual is
negative, then 24 Newton steps that freeze once an update stalls
(``c_new == c`` or ``|resid| <= 1e-8``).  A +inf entry contributes exactly
0.  The TPU kernel ran in float32 because Mosaic has no f64; the port runs
it in FP64.

On a CUDA tensor it launches the Hopper kernel ``csrc/simplex_mult.cu``
(one CTA, the vector staged in shared memory) and counts the launch in
``LAUNCHES``; the result stays on the device, so a call makes no host read.
On a CPU tensor it runs ``simplex_multiplier_reference``, the plain version.
Any other device raises, and a failed build or launch raises: nothing falls
back to the plain version on the card.
"""

from __future__ import annotations

import ctypes

import torch

_BISECT_ITERS = 64
_NEWTON_ITERS = 24
_STALL = 1e-8

# Kernel launches made by ``simplex_inv_multiplier_pallas`` on a CUDA tensor
# (never by the plain version), so a run can show that it went through the
# kernel.
LAUNCHES = 0


def _check(gg):
    if not isinstance(gg, torch.Tensor) or gg.dim() != 1:
        raise ValueError("gg must be a 1-d tensor")
    if gg.numel() == 0:
        raise ValueError("gg must not be empty")


def simplex_multiplier_reference(gg):
    """Plain PyTorch version of ``_simplex_kernel``, line for line in FP64:
    64 bisection steps, then 24 Newton steps with the stall freeze.  Every
    step runs (no early exit and no host read).  Returns a 0-d tensor."""
    _check(gg)
    gg = gg.to(torch.float64)
    cmin = -torch.min(gg)

    def resid(c):
        return torch.sum(torch.div(1.0, gg + c)) - 1.0

    # Phase 1: bisect from cmin + 1 toward cmin until resid >= 0
    c = cmin + 1.0
    for _ in range(_BISECT_ITERS):
        r = resid(c)
        c = torch.where(r < 0.0, 0.5 * (cmin + c), c)

    # Phase 2: Newton with freeze-on-stall (resid convex decreasing in c)
    fc = resid(c)
    for _ in range(_NEWTON_ITERS):
        fpc = torch.sum(torch.div(-1.0, (gg + c) ** 2))
        c_new = c - fc / fpc
        stall = (c_new == c) | (torch.abs(fc) <= _STALL)
        c_new = torch.where(stall, c, c_new)
        fc = torch.where(stall, fc, resid(c_new))
        c = c_new
    return c


def simplex_inv_multiplier_pallas(gg):
    """The multiplier ``c`` of ``gg`` (1-d float64) as a 0-d tensor on
    ``gg``'s device: the Hopper kernel on CUDA, the plain version on the
    CPU (see the module docstring)."""
    _check(gg)
    if gg.device.type == "cpu":
        return simplex_multiplier_reference(gg)
    if gg.device.type != "cuda":
        raise ValueError(f"simplex_inv_multiplier_pallas runs on cpu or "
                         f"cuda, not {gg.device}")
    global LAUNCHES
    out = _launch_cuda(gg)
    LAUNCHES += 1
    return out


def _kernel_lib():
    from . import _build

    lib = _build.load("simplex_mult")
    p = ctypes.c_void_p
    lib.simplex_mult_run.argtypes = [p, ctypes.c_int, p, p]
    lib.simplex_mult_run.restype = ctypes.c_int
    lib.simplex_mult_error_string.argtypes = [ctypes.c_int]
    lib.simplex_mult_error_string.restype = ctypes.c_char_p
    return lib


def _launch_cuda(gg):
    if gg.dtype != torch.float64 or not gg.is_contiguous():
        raise ValueError("the simplex kernel takes a contiguous float64 "
                         "vector")
    n = gg.numel()
    if n >= 2**31:
        raise ValueError(f"the simplex kernel takes n < 2**31, got {n}")
    lib = _kernel_lib()
    c = torch.empty(1, dtype=torch.float64, device=gg.device)
    with torch.cuda.device(gg.device):
        stream = torch.cuda.current_stream(gg.device).cuda_stream
        err = lib.simplex_mult_run(gg.data_ptr(), n, c.data_ptr(), stream)
    if err:
        raise RuntimeError("simplex_mult kernel launch failed: "
                           + lib.simplex_mult_error_string(err).decode())
    return c.view(())
