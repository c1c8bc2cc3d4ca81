"""The dual prox's extragradient loop in one kernel:
``SumOf2nd4thPowersDualProxMap.div_prox_map``'s inner solver.

``dual_prox(G, y, L, ...)`` runs the JAX oracle's ``lax.while_loop``
(``accbpg_and_fw_tpu/ops/h_oracles.py:476-507``): up to ``num_iters``
primal-dual extragradient steps on the prox of the quartic kernel over
``{X >= 0, ||X|| <= radius}``, with a gap test after every step and no exit
on the first step's gap.  It returns the iterate the loop stops at, the
steps it took (a 0-d float64 tensor) and the host reads it made.

On a CUDA tensor it launches the Hopper kernel ``csrc/dual_prox.cu`` (one
thread-block cluster laid out by ``dual_prox_plan``, the whole loop in one
launch, no host read) and counts the launch in ``LAUNCHES`` on the host
and, from inside the kernel, in a device int64 (``device_launches``: a
graph's replays count there).  On a CPU tensor it runs
``dual_prox_reference``, the plain version.  Any other device raises, and a
failed build or launch raises: nothing falls back to the plain version on
the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .base import vdot

# Steps of the plain version between two host reads of its exit flag: the
# steps after the exit freeze through ``torch.where``, so the block length
# changes the reads, not the result.
DUAL_BLOCK = 8

LAUNCHES = 0
_DEVICE_COUNTS: dict = {}


def _grads(G, L, alpha, sigma, X, lam):
    n2 = vdot(X, X)
    return G - L * (alpha * n2 * X + sigma * X) - lam, -X


def _f(G, y, L, alpha, sigma, X, lam):
    n2 = vdot(X, X)
    return (vdot(G, X - y) - L * (alpha / 4.0 * n2 * n2 + sigma / 2.0 * n2)
            - vdot(lam, X))


def _project(X, radius):
    Xp = torch.clamp_min(X, 0.0)
    norm = torch.sqrt(vdot(Xp, Xp))
    return torch.where(norm <= radius, X, (radius / norm) * Xp)


def dual_prox_reference(G, y, L, *, alpha, sigma, num_iters, eta_base, tol,
                        radius):
    """The plain version: the JAX loop's steps in torch operations, in
    blocks of ``DUAL_BLOCK`` that freeze once the exit test has fired (as
    the JAX ``while_loop`` leaves its state), with one host read of the
    exit flag per block.  Returns ``(X, steps, reads)``."""
    def go(it, gap):
        return (it < num_iters) & ((it <= 1) | (gap >= tol))

    def body(X, lam, it):
        eta = eta_base / (it + 1.0)
        gX, gl = _grads(G, L, alpha, sigma, X, lam)
        X_mid = _project(X + eta * gX, radius)
        lam_mid = torch.clamp_min(lam - eta * gl, 0.0)
        gXm, glm = _grads(G, L, alpha, sigma, X_mid, lam_mid)
        X_new = _project(X + eta * gXm, radius)
        lam_new = torch.clamp_min(lam - eta * glm, 0.0)
        X_cand = _project(X_new + eta * gX, radius)
        lam_cand = torch.clamp_min(lam_new - eta * gl, 0.0)
        gap = (_f(G, y, L, alpha, sigma, X_cand, lam_new)
               - _f(G, y, L, alpha, sigma, X_new, lam_cand))
        return X_new, lam_new, it + 1.0, gap

    X, lam = torch.zeros_like(y), torch.zeros_like(y)
    it = torch.zeros((), dtype=y.dtype, device=y.device)
    gap = torch.full((), torch.inf, dtype=y.dtype, device=y.device)
    ran = reads = 0
    while ran < num_iters:
        steps = min(DUAL_BLOCK, num_iters - ran)
        for _ in range(steps):
            live = go(it, gap)
            X_n, lam_n, it_n, gap_n = body(X, lam, it)
            X = torch.where(live, X_n, X)
            lam = torch.where(live, lam_n, lam)
            it = torch.where(live, it_n, it)
            gap = torch.where(live, gap_n, gap)
        ran += steps
        if ran >= num_iters:
            break
        reads += 1
        if not bool(go(it, gap)):
            break
    return X, it, reads


def dual_prox(G, y, L, *, alpha, sigma, num_iters, eta_base, tol, radius):
    """The prox of ``G`` (``g + grad h(y)``) at ``y`` with the prox
    parameter ``L`` (a number or a 0-d tensor): ``(X, steps, reads)``, the
    kernel on CUDA, the plain version on the CPU (see the module
    docstring)."""
    if not (isinstance(G, torch.Tensor) and isinstance(y, torch.Tensor)
            and G.shape == y.shape):
        raise ValueError("G and y must be tensors of one shape")
    consts = dict(alpha=float(alpha), sigma=float(sigma),
                  num_iters=int(num_iters), eta_base=float(eta_base),
                  tol=float(tol), radius=float(radius))
    if y.device.type == "cpu":
        return dual_prox_reference(G, y, L, **consts)
    if y.device.type != "cuda":
        raise ValueError(f"the dual prox runs on cpu or cuda, not "
                         f"{y.device}")
    global LAUNCHES
    X, steps = _launch_cuda(G, y, L, **consts)
    LAUNCHES += 1
    return X, steps, 0


# ---- the kernel's launch plan -----------------------------------------------

_MAX_THREADS = 1024
_CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 needs the non-portable opt-in
_STATIC_SMEM = 4096       # room left for the kernel's static shared memory
# The cluster doubles toward this many elements a CTA, one a thread.  At
# the primal-dual study's 400x10 on an "NVIDIA H100 80GB HBM3, 700.00 W"
# (chip_smoke.py's [dual prox] line, PERF.md) a step took 10.1 us
# on one CTA of 1024 threads and 6.9 us on 16 CTAs of 256: a step's FP64
# work spread over more SMs saves more than the exchanges cost.
_ELEMS_PER_CTA = 256
_ELEMS_PER_THREAD = 1
_ARRAYS = 4               # X, lam, gX and X_mid of each element


class DualProxPlan(NamedTuple):
    """How one dual prox is laid out (see ``dual_prox_plan``)."""
    n: int
    cluster: int     # CTAs of the one cluster that runs the loop
    threads: int     # threads per CTA (a power-of-two number of warps)
    chunk: int       # CTA r owns elements [r chunk, (r + 1) chunk) below n
    resident: bool   # its four arrays in shared memory (else global scratch)
    smem_bytes: int  # dynamic shared memory per CTA

    def owned(self, r):
        """The elements that CTA ``r`` of the cluster owns."""
        return range(min(self.n, r * self.chunk),
                     min(self.n, (r + 1) * self.chunk))


def dual_prox_plan(n, smem_limit, max_cluster):
    """The layout of one dual prox over ``n`` elements on a card whose CTAs
    may take ``smem_limit`` bytes of shared memory and whose largest
    schedulable cluster is ``max_cluster`` CTAs: a cluster doubling
    toward ``_ELEMS_PER_CTA`` elements a CTA, threads toward one element
    each.  A CTA keeps its elements' four arrays in shared memory where
    they fit, else in a global scratch."""
    if not 1 <= n < 2**40:
        raise ValueError(f"dual_prox_plan needs 1 <= n < 2**40, got {n}")
    if max_cluster not in _CLUSTER_SIZES:
        raise ValueError(f"max_cluster must be one of {_CLUSTER_SIZES}, got "
                         f"{max_cluster}")
    cluster = 1
    while cluster < max_cluster and cluster * _ELEMS_PER_CTA < n:
        cluster *= 2
    chunk = -(-n // cluster)
    if chunk >= 2**31:
        raise ValueError(f"dual_prox_plan: {chunk} elements a CTA is past "
                         "the kernel's int range")
    warps = 1
    while warps * 32 < _MAX_THREADS and \
            warps * 32 * _ELEMS_PER_THREAD < chunk:
        warps *= 2
    need = _ARRAYS * 8 * chunk
    resident = need <= smem_limit - _STATIC_SMEM
    return DualProxPlan(n, cluster, 32 * warps, chunk, resident,
                        need if resident else 0)


class _Kernel(NamedTuple):
    run: object
    info: object
    active_clusters: object
    error_string: object


@functools.lru_cache(maxsize=None)
def _kernel_lib():
    from . import _build

    lib = _build.load("dual_prox")
    p, i, d, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                   ctypes.c_longlong)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.dual_prox_run.argtypes = [p, p, p, d, d, d, d, d, i, ll, i, i, i, i,
                                  p, p, p, p, i, p]
    lib.dual_prox_run.restype = i
    lib.dual_prox_info.argtypes = [i, ip]
    lib.dual_prox_info.restype = i
    lib.dual_prox_active_clusters.argtypes = [i, i, i, i, i, ip]
    lib.dual_prox_active_clusters.restype = i
    lib.dual_prox_error_string.argtypes = [i]
    lib.dual_prox_error_string.restype = ctypes.c_char_p
    return _Kernel(lib.dual_prox_run, lib.dual_prox_info,
                   lib.dual_prox_active_clusters,
                   lib.dual_prox_error_string)


def _check_err(err, what):
    if err:
        raise RuntimeError(f"dual_prox {what} failed: "
                           + _kernel_lib().error_string(err).decode())


@functools.lru_cache(maxsize=None)
def kernel_info(device_index):
    """``(registers per thread, static shared bytes, local (spill) bytes
    per thread, dynamic shared bytes a CTA may ask for)``."""
    info = (ctypes.c_int * 4)()
    _check_err(_kernel_lib().info(device_index, info), "set-up")
    return tuple(info)


@functools.lru_cache(maxsize=None)
def device_plan(n, device_index):
    """``dual_prox_plan`` on CUDA device ``device_index``, the cluster
    taken down to what the card schedules."""
    limit = kernel_info(device_index)[3] + _STATIC_SMEM
    active = ctypes.c_int()
    for max_cluster in reversed(_CLUSTER_SIZES):
        plan = dual_prox_plan(n, limit, max_cluster)
        if plan.cluster < max_cluster and max_cluster > 1:
            continue  # the same plan comes again under a smaller cap
        _check_err(_kernel_lib().active_clusters(
            device_index, plan.cluster, plan.threads, plan.chunk,
            int(plan.resident), ctypes.byref(active)), "occupancy query")
        if active.value >= 1:
            return plan
    raise RuntimeError(f"the card schedules no launch of the dual prox "
                       f"kernel for n={n}")


def _device_count(device):
    count = _DEVICE_COUNTS.get(device.index)
    if count is None:
        count = torch.zeros((), dtype=torch.int64, device=device)
        _DEVICE_COUNTS[device.index] = count
    return count


def device_launches():
    """The launches the cards counted since the last reset (one read)."""
    return sum(int(c) for c in _DEVICE_COUNTS.values())


def reset_device_launches():
    for c in _DEVICE_COUNTS.values():
        c.zero_()


def _launch_cuda(G, y, L, *, alpha, sigma, num_iters, eta_base, tol,
                 radius):
    dev = y.device
    for name, t in (("G", G), ("y", y)):
        if t.dtype != torch.float64 or t.device != dev:
            raise ValueError(f"{name} must be float64 on {dev}")
    G, y = G.contiguous(), y.contiguous()
    L_t = (L.to(device=dev, dtype=torch.float64).reshape(())
           if isinstance(L, torch.Tensor)
           else torch.full((), float(L), dtype=torch.float64, device=dev))
    n = y.numel()
    plan = device_plan(n, dev.index)
    X = torch.empty_like(y)
    steps = torch.empty((), dtype=torch.float64, device=dev)
    scratch = (None if plan.resident else
               torch.empty(_ARRAYS * n, dtype=torch.float64, device=dev))
    err = _kernel_lib().run(
        G.data_ptr(), y.data_ptr(), L_t.data_ptr(), alpha, sigma, eta_base,
        tol, radius, num_iters, n, plan.cluster, plan.threads, plan.chunk,
        int(plan.resident), None if scratch is None else scratch.data_ptr(),
        X.data_ptr(), steps.data_ptr(), _device_count(dev).data_ptr(),
        dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    _check_err(err, "kernel launch")
    return X, steps
