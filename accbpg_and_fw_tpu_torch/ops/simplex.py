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
(one thread-block cluster per solve, laid out by ``simplex_plan``: each CTA
keeps its slice of the vector in shared memory and the CTAs exchange their
partial sums through distributed shared memory) and counts the launch in
``LAUNCHES``; the result stays on the device, so a call makes no host read.
On a CPU tensor it runs ``simplex_multiplier_reference``, the plain version.
Any other device raises, and a failed build or launch raises: nothing falls
back to the plain version on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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


# ---- the kernel's launch plan -----------------------------------------------

_MAX_THREADS = 256        # more warps cost a pass more than they save
_CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 needs the non-portable opt-in
_STATIC_SMEM = 2048       # room left for the kernel's static shared memory
_ONE_CTA_ELEMS = 2048     # up to here one CTA beats any exchange
_ELEMS_PER_CTA = 512      # past it: the slice a CTA of a cluster aims at
_ELEMS_PER_THREAD = 4     # a thread takes four elements at a time


class SimplexPlan(NamedTuple):
    """How one solve of the multiplier kernel is laid out (see
    ``simplex_plan``).  The fields after ``n`` are what the C entry takes,
    in its order."""
    n: int
    cluster: int     # CTAs of the one cluster that runs the solve
    threads: int     # threads per CTA (a power-of-two number of warps)
    chunk: int       # CTA r owns elements [r chunk, (r + 1) chunk) below n
    resident: int    # ... and keeps the first of them in shared memory
    smem_bytes: int  # dynamic shared memory per CTA

    def owned(self, r):
        """The elements that CTA ``r`` of the cluster owns."""
        return range(min(self.n, r * self.chunk),
                     min(self.n, (r + 1) * self.chunk))


def simplex_plan(n, smem_limit, max_cluster):
    """The layout of one multiplier solve over ``n`` elements on a card
    whose CTAs may take ``smem_limit`` bytes of shared memory and whose
    largest schedulable cluster is ``max_cluster`` CTAs.

    A small input takes one small CTA (the chain of reductions is all there
    is, and fewer warps make each shorter); past ``_ONE_CTA_ELEMS`` elements
    the reciprocals of a pass are spread over a cluster, doubling its size
    toward ``_ELEMS_PER_CTA`` elements per CTA, up to ``max_cluster``.  The
    elements are split evenly in rank order; a CTA keeps as many of its own
    as its shared memory holds and reads the rest from global memory in
    every pass."""
    if not 1 <= n < 2**31:
        raise ValueError(f"simplex_plan needs 1 <= n < 2**31, got {n}")
    if max_cluster not in _CLUSTER_SIZES:
        raise ValueError(f"max_cluster must be one of {_CLUSTER_SIZES}, got "
                         f"{max_cluster}")
    room = (smem_limit - _STATIC_SMEM) // 8
    if room < 0:
        raise ValueError(f"the kernel needs {_STATIC_SMEM} bytes of shared "
                         f"memory per CTA, the card gives {smem_limit}")
    cluster = 1
    while (n > _ONE_CTA_ELEMS and cluster < max_cluster
           and cluster * _ELEMS_PER_CTA < n):
        cluster *= 2
    chunk = -(-n // cluster)
    warps = 1
    while warps * 32 < _MAX_THREADS and \
            warps * 32 * _ELEMS_PER_THREAD < chunk:
        warps *= 2
    resident = min(chunk, room)
    return SimplexPlan(n, cluster, 32 * warps, chunk, resident, 8 * resident)


# The stages of a pass that thread 0 of CTA 0 clocks when a launch is given
# ``prof`` (the kernel's ``Stage``); the entry after them counts the passes.
STAGES = ("update of c and elements", "lanes", "warps", "exchange",
          "cluster")


class _Kernel(NamedTuple):
    """The loaded library, bound once per process."""
    run: object
    info: object
    active_clusters: object
    error_string: object


@functools.lru_cache(maxsize=None)
def _kernel_lib():
    from . import _build

    lib = _build.load("simplex_mult")
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.simplex_mult_run.argtypes = [p, i, p, i, i, i, i, p, i, p]
    lib.simplex_mult_run.restype = i
    if lib.simplex_mult_stages() != len(STAGES):
        raise RuntimeError("the simplex kernel's stages differ from STAGES")
    lib.simplex_mult_info.argtypes = [i, ip]
    lib.simplex_mult_info.restype = i
    lib.simplex_mult_active_clusters.argtypes = [i, i, i, i, ip]
    lib.simplex_mult_active_clusters.restype = i
    lib.simplex_mult_error_string.argtypes = [i]
    lib.simplex_mult_error_string.restype = ctypes.c_char_p
    return _Kernel(lib.simplex_mult_run, lib.simplex_mult_info,
                   lib.simplex_mult_active_clusters,
                   lib.simplex_mult_error_string)


def _check_err(err, what):
    if err:
        raise RuntimeError(f"simplex_mult {what} failed: "
                           + _kernel_lib().error_string(err).decode())


@functools.lru_cache(maxsize=None)
def kernel_info(device_index):
    """The kernel as compiled, and the card's limit: ``(registers per
    thread, static shared bytes, local (spill) bytes per thread, dynamic
    shared bytes a CTA may ask for)``.  The first call on a device also
    makes the once-per-device set-up of the function's attributes."""
    info = (ctypes.c_int * 4)()
    _check_err(_kernel_lib().info(device_index, info), "set-up")
    return tuple(info)


@functools.lru_cache(maxsize=None)
def device_plan(n, device_index):
    """``simplex_plan`` for ``n`` elements on CUDA device ``device_index``,
    with the cluster size taken down to what the card says it can schedule
    (``cudaOccupancyMaxActiveClusters``)."""
    limit = kernel_info(device_index)[3] + _STATIC_SMEM
    active = ctypes.c_int()
    for max_cluster in reversed(_CLUSTER_SIZES):
        plan = simplex_plan(n, limit, max_cluster)
        if plan.cluster < max_cluster and max_cluster > 1:
            continue  # the same plan comes again under a smaller cap
        _check_err(_kernel_lib().active_clusters(
            device_index, plan.cluster, plan.threads, plan.resident,
            ctypes.byref(active)), "occupancy query")
        if active.value >= 1:
            return plan
    raise RuntimeError(f"the card schedules no launch of the simplex kernel "
                       f"for n={n}")


def _launch_cuda(gg, prof=None):
    """``prof``: a zeroed int64 tensor of ``len(STAGES) + 1`` that thread 0
    of CTA 0 adds its clocks per stage to, and the number of passes."""
    if gg.dtype != torch.float64 or not gg.is_contiguous():
        raise ValueError("the simplex kernel takes a contiguous float64 "
                         "vector")
    n = gg.numel()
    if n >= 2**31:
        raise ValueError(f"the simplex kernel takes n < 2**31, got {n}")
    index = gg.device.index
    plan = device_plan(n, index)
    c = torch.empty((), dtype=torch.float64, device=gg.device)
    err = _kernel_lib().run(
        gg.data_ptr(), n, c.data_ptr(), plan.cluster, plan.threads,
        plan.chunk, plan.resident,
        None if prof is None else prof.data_ptr(), index,
        torch._C._cuda_getCurrentRawStream(index))
    _check_err(err, "kernel launch")
    return c
