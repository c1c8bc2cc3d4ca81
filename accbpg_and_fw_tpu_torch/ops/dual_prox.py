"""The dual prox's extragradient loop in one kernel:
``SumOf2nd4thPowersDualProxMap.div_prox_map``'s inner solver.

``dual_prox(G, y, L, ...)`` runs the JAX oracle's ``lax.while_loop``
(``accbpg_and_fw_tpu/ops/h_oracles.py:476-507``): up to ``num_iters``
primal-dual extragradient steps on the prox of the quartic kernel over
``{X >= 0, ||X|| <= radius}``, with a gap test after every step and no exit
on the first step's gap.  It returns the iterate the loop stops at, the
steps it took (a 0-d float64 tensor) and the host reads it made.

On a CUDA tensor it launches the Hopper kernel ``csrc/dual_prox.cu`` (one
thread-block cluster laid out by ``dual_prox_plan``: a few elements a
thread in registers, or past what registers hold the per-element arrays in
memory; three cluster reductions a step; the whole loop in one launch, no
host read) and counts the launch in ``LAUNCHES`` on the host
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

_CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 needs the non-portable opt-in
PER_THREAD = (1, 2, 4, 8)  # the register layouts: elements a thread
_STATIC_SMEM = 4096       # room left for the kernel's static shared memory
_SLOT_BYTES = 2 * 80      # a warp's sums in every CTA, in each of two sets
_TABLE_BYTES = 32 * 88    # a warp's table of its lanes' sums
_ARRAYS = 5               # past registers: X, lam, gX, X_mid, d an element
# The cluster doubles toward this many elements a CTA, E elements a thread
# in registers: the fastest layout of the sweep over clusters 1-16 and E
# 1-8 at the primal-dual study's 400x10 (chip_smoke.py --dual-prox; on an
# "NVIDIA H100 80GB HBM3, 700.00 W" 16 CTAs of 4 a thread took 21.0 ms
# for 7000 steps, 8 CTAs of 4 21.0 ms, 16 CTAs of 2 22.2 ms, of 8 25.0
# ms, one CTA 50.0 ms; PERF.md).
_ELEMS_PER_CTA = 256
_ELEMS_PER_THREAD = 4


def max_threads(per_thread):
    """The most threads a CTA of a layout takes (the kernel's
    ``max_threads``): what the registers of ``per_thread`` elements allow;
    256 with the arrays in memory (``per_thread`` 0)."""
    if per_thread == 0 or per_thread >= 8:
        return 256
    return 512 if per_thread >= 2 else 1024


class DualProxPlan(NamedTuple):
    """How one dual prox is laid out (see ``dual_prox_plan``)."""
    n: int
    cluster: int     # CTAs of the one cluster that runs the loop
    threads: int     # threads per CTA (a power-of-two number of warps)
    chunk: int       # CTA r owns elements [r chunk, (r + 1) chunk) below n
    per_thread: int  # elements a thread keeps in registers (0: in memory)
    layout: str      # "registers", "shared" or "global": where they live
    smem_bytes: int  # dynamic shared memory a CTA (tables, slots, arrays)

    def owned(self, r):
        """The elements that CTA ``r`` of the cluster owns."""
        return range(min(self.n, r * self.chunk),
                     min(self.n, (r + 1) * self.chunk))


def layout_plan(n, cluster, per_thread, smem_limit):
    """``n`` elements over a cluster of ``cluster`` CTAs, ``per_thread``
    of them a thread in registers (the fewest warps that hold them, a
    power of two), or None where that takes more threads than the layout
    allows; ``per_thread`` 0 keeps the elements in memory (threads toward
    one an element, their arrays in shared memory where they fit beside
    the warps' tables and slots, else in a global scratch)."""
    chunk = -(-n // cluster)
    if chunk >= 2**31:
        raise ValueError(f"dual_prox_plan: {chunk} elements a CTA is past "
                         "the kernel's int range")
    cap = max_threads(per_thread)
    each = per_thread or 1
    warps = 1
    while warps * 32 < cap and warps * 32 * each < chunk:
        warps *= 2
    sums = _TABLE_BYTES * warps + (
        _SLOT_BYTES * cluster * warps if cluster * warps > 1 else 0)
    if per_thread:
        if warps * 32 * per_thread < chunk:
            return None
        return DualProxPlan(n, cluster, 32 * warps, chunk, per_thread,
                            "registers", sums)
    arrays = _ARRAYS * 8 * chunk
    if sums + arrays <= smem_limit - _STATIC_SMEM:
        return DualProxPlan(n, cluster, 32 * warps, chunk, 0, "shared",
                            sums + arrays)
    return DualProxPlan(n, cluster, 32 * warps, chunk, 0, "global", sums)


def dual_prox_plan(n, smem_limit, max_cluster):
    """The layout of one dual prox over ``n`` elements on a card whose CTAs
    may take ``smem_limit`` bytes of shared memory and whose largest
    schedulable cluster is ``max_cluster`` CTAs: a cluster doubling
    toward ``_ELEMS_PER_CTA`` elements a CTA, ``_ELEMS_PER_THREAD``
    elements a thread in registers, or more where the threads would not
    hold them, and past what registers hold the arrays in memory."""
    if not 1 <= n < 2**40:
        raise ValueError(f"dual_prox_plan needs 1 <= n < 2**40, got {n}")
    if max_cluster not in _CLUSTER_SIZES:
        raise ValueError(f"max_cluster must be one of {_CLUSTER_SIZES}, got "
                         f"{max_cluster}")
    cluster = 1
    while cluster < max_cluster and cluster * _ELEMS_PER_CTA < n:
        cluster *= 2
    for per_thread in PER_THREAD:
        if per_thread >= _ELEMS_PER_THREAD:
            plan = layout_plan(n, cluster, per_thread, smem_limit)
            if plan is not None:
                return plan
    return layout_plan(n, cluster, 0, smem_limit)


# The stages of a step that thread 0 of CTA 0 clocks when a launch is given
# ``prof`` (the kernel's ``Stage``); the entry after them counts the steps.
STAGES = ("elementwise", "warp", "block", "exchange", "combine", "tail")


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
                                  i, p, p, p, p, p, i, p]
    if lib.dual_prox_stages() != len(STAGES):
        raise RuntimeError("the dual prox kernel's stages differ from STAGES")
    lib.dual_prox_run.restype = i
    lib.dual_prox_info.argtypes = [i, i, ip]
    lib.dual_prox_info.restype = i
    lib.dual_prox_active_clusters.argtypes = [i, i, i, i, i, i, ip]
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
def kernel_info(device_index, per_thread):
    """The kernel of layout ``per_thread`` as compiled and the card's
    limit: ``(registers per thread, static shared bytes, local (spill)
    bytes per thread, dynamic shared bytes a CTA may ask for)``."""
    info = (ctypes.c_int * 4)()
    _check_err(_kernel_lib().info(device_index, per_thread, info), "set-up")
    return tuple(info)


def smem_limit(device_index):
    """The shared bytes a CTA of the kernel may take on the card, counted
    as ``dual_prox_plan`` counts them."""
    return kernel_info(device_index, 0)[3] + _STATIC_SMEM


def schedulable(plan, device_index):
    """Whether the card schedules a cluster of ``plan``
    (``cudaOccupancyMaxActiveClusters``)."""
    active = ctypes.c_int()
    _check_err(_kernel_lib().active_clusters(
        device_index, plan.cluster, plan.threads, plan.chunk,
        plan.per_thread, int(plan.layout == "shared"), ctypes.byref(active)),
        "occupancy query")
    return active.value >= 1


@functools.lru_cache(maxsize=None)
def device_plan(n, device_index):
    """``dual_prox_plan`` on CUDA device ``device_index``, the cluster
    taken down to what the card schedules."""
    limit = smem_limit(device_index)
    for max_cluster in reversed(_CLUSTER_SIZES):
        plan = dual_prox_plan(n, limit, max_cluster)
        if plan.cluster < max_cluster and max_cluster > 1:
            continue  # the same plan comes again under a smaller cap
        if schedulable(plan, device_index):
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
                 radius, prof=None, plan=None):
    """``prof``: a zeroed int64 tensor of ``len(STAGES) + 1`` that thread 0
    of CTA 0 adds its clocks per stage to, and the steps; ``plan``: a
    layout in place of ``device_plan``'s (``layout_plan``)."""
    dev = y.device
    for name, t in (("G", G), ("y", y)):
        if t.dtype != torch.float64 or t.device != dev:
            raise ValueError(f"{name} must be float64 on {dev}")
    G, y = G.contiguous(), y.contiguous()
    L_t = (L.to(device=dev, dtype=torch.float64).reshape(())
           if isinstance(L, torch.Tensor)
           else torch.full((), float(L), dtype=torch.float64, device=dev))
    n = y.numel()
    if plan is None:
        plan = device_plan(n, dev.index)
    elif plan.n != n:
        raise ValueError(f"the plan is for n={plan.n}, not {n}")
    X = torch.empty_like(y)
    steps = torch.empty((), dtype=torch.float64, device=dev)
    scratch = (torch.empty(_ARRAYS * n, dtype=torch.float64, device=dev)
               if plan.layout == "global" else None)
    err = _kernel_lib().run(
        G.data_ptr(), y.data_ptr(), L_t.data_ptr(), alpha, sigma, eta_base,
        tol, radius, num_iters, n, plan.cluster, plan.threads, plan.chunk,
        plan.per_thread, int(plan.layout == "shared"),
        None if scratch is None else scratch.data_ptr(), X.data_ptr(),
        steps.data_ptr(), _device_count(dev).data_ptr(),
        None if prof is None else prof.data_ptr(), dev.index,
        torch._C._cuda_getCurrentRawStream(dev.index))
    _check_err(err, "kernel launch")
    return X, steps
