"""Dense whole-iteration engine for small and medium D-optimal design
Frank-Wolfe, one instance or a batch of sweep instances.

Port of ``accbpg_and_fw_tpu/ops/pallas_dopt.py``.  The full m x m inverse
H = (V diag(x) V^T)^-1 is carried and updated by the rank-1 step every
iteration,

    g = H V[:, v],   u = g^T V (u[v] pinned to w[v]),
    w <- (w - c u^2) / (1 - tau),   H <- (H - c g g^T) / (1 - tau),

for up to ``kmax`` iterations per launch block, and the host rebuilds the
F history in f64 from the recorded (tau, tau (w_v - 1)) pairs.  The TPU
kernels carried double-single pairs because Mosaic has no f64; here every
block runs in FP64.  ``dense_block`` is the block for B instances: on a
CUDA tensor it launches the hand-written Hopper kernel
(``csrc/dopt_dense.cu``: a thread-block cluster per instance, laid out by
``dense_plan``, with each CTA's columns of V resident in its shared
memory), on a CPU tensor it runs ``dense_block_reference``, the plain
PyTorch version of the same iteration.  ``dopt_fw_dense`` (B = 1) ports
``dopt_fw_pallas`` and ``dopt_fw_dense_batch`` ports
``dopt_fw_pallas_batch``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .._device import as_f64, resolve_device
from .dopt_common import (XTOL, check_operands, f_rows, factorize, pivots,
                          run_blocks, step_scalars)

# Launch lengths round up to these multiples, as in the JAX kernels, so
# refreshes, checkpoints and the batch's lockstep row count fall on the
# same iterations: the single-instance kernel left its loop every 64
# iterations, the batch kernel flushed 128-row history buffers and its
# lockstep row count is a multiple of 128 (or the launch's kmax).
_INNER = 64
_ROW_BLOCK = 128
_MAX_M = 4096     # the kernel keeps three length-m vectors in shared memory

# Kernel launches made by ``dense_block`` on a CUDA tensor (never by the
# plain version), so a run can show that it went through the kernel.
LAUNCHES = 0


class DenseBlock(NamedTuple):
    """One launch block's results for B instances (float64, input device).

    ``x``, ``w`` (B, n) and ``H`` (B, m, m) are the new state.  ``misc``
    (B, 3) is ``[done, iters, nrun]``: ``iters`` rows up to and including
    the stop row were recorded (``kmax`` when the instance did not stop, 0
    when it entered done), ``nrun`` of them applied an update.  ``hist``
    (B, 5, kmax) holds ``tau``, ``tau (w_v - 1)``, ``SP``, ``SN`` and the
    pivot ``v`` per row.  From the stop row on (every row, for an instance
    that entered done) the state is frozen: the rows repeat its slacks with
    ``tau = tau (w_v - 1) = 0`` and ``v = -1``."""
    x: torch.Tensor
    w: torch.Tensor
    H: torch.Tensor
    misc: torch.Tensor
    hist: torch.Tensor


def _dense_one(V, H, x, w, eps, kmax, done, away, xtol):
    """The plain block for one instance: ``(x, w, H, misc, hist)``."""
    m_f = float(V.shape[0])
    hist = torch.zeros((5, kmax), dtype=torch.float64, device=V.device)
    x, w, H = x.clone(), w.clone(), H.clone()
    entered = bool(done)
    done = entered
    k = 0
    while k < kmax and not done:
        i, wi, j, wj = pivots(w, x, away, xtol)
        sp, sn, v, wv, tau, drop = step_scalars(
            away, m_f, i, wi, j, wj, float(x[j]) if away else 0.0)
        if sp <= eps and sn <= eps:
            done = True
            break
        wvm1 = wv - 1.0
        c = tau / (1.0 + tau * wvm1)
        r = 1.0 / (1.0 - tau)

        g = H @ V[:, v]
        u = g @ V
        u[v] = wv  # consistency pin u[v] = w[v]
        w = (w - c * (u * u)) * r
        H = (H - c * torch.outer(g, g)) * r
        x = x * (1.0 - tau)
        x[v] = 0.0 if drop else float(x[v]) + tau

        hist[:, k] = torch.tensor([tau, tau * wvm1, sp, sn, float(v)],
                                  dtype=torch.float64)
        k += 1
    if done and k < kmax:
        # frozen from row k on: its slacks, tau = 0, no pivot
        if entered:
            i, wi, j, wj = pivots(w, x, away, xtol)
            sp, sn = (wi - m_f) / m_f, (m_f - wj) / m_f
        hist[2, k:] = sp
        hist[3, k:] = sn
        hist[4, k:] = -1.0
    iters = 0 if entered else (k + 1 if done else k)
    misc = torch.tensor([float(done), float(iters), float(k)],
                        dtype=torch.float64)
    return x, w, H, misc, hist


def dense_block_reference(Vs, Hs, xs, ws, *, eps, kmax, done=None, away=True,
                          xtol=XTOL):
    """Plain PyTorch version of one launch block for B instances: up to
    ``kmax`` FW(-away) iterations each, with the semantics of the TPU
    kernels ``_fw_kernel_body`` and ``_fw_kernel_body_b`` in FP64.
    ``done`` (B bools, default all False) marks instances that enter
    frozen.  Scalars go through the host."""
    B = Vs.shape[0]
    done = [False] * B if done is None else list(done)
    outs = [_dense_one(Vs[b], Hs[b], xs[b], ws[b], eps, kmax, done[b], away,
                       xtol) for b in range(B)]
    x, w, H, misc, hist = (torch.stack(t).to(Vs.device) for t in zip(*outs))
    return DenseBlock(x, w, H, misc, hist)


def _check_block_args(Vs, Hs, xs, ws, kmax, done):
    if Vs.dim() != 3:
        raise ValueError(f"Vs must be 3-d (B, m, n), got {tuple(Vs.shape)}")
    B, m, n = Vs.shape
    check_operands(Vs.device, (("Vs", Vs, (B, m, n)), ("Hs", Hs, (B, m, m)),
                               ("xs", xs, (B, n)), ("ws", ws, (B, n))))
    if kmax < 0:
        raise ValueError(f"kmax={kmax} must be >= 0")
    if done is not None and len(done) != B:
        raise ValueError(f"done has {len(done)} flags for {B} instances")


def dense_block(Vs, Hs, xs, ws, *, eps, kmax, done=None, away=True,
                xtol=XTOL, VTs=None):
    """One launch block for B instances (see ``dense_block_reference``).

    On a CUDA tensor this launches the Hopper kernel and counts the launch
    in ``LAUNCHES``; a launch that fails raises.  On a CPU tensor it runs
    the plain version.  ``VTs`` is ``Vs.transpose(1, 2).contiguous()``,
    which the kernel reads pivot columns from where its plan streams V
    (``dense_plan``: ``resident == 0``); pass it to avoid a copy per call."""
    _check_block_args(Vs, Hs, xs, ws, kmax, done)
    if Vs.device.type == "cpu":
        return dense_block_reference(Vs, Hs, xs, ws, eps=eps, kmax=kmax,
                                     done=done, away=away, xtol=xtol)
    if Vs.device.type != "cuda":
        raise ValueError(f"dense_block runs on cpu or cuda, not {Vs.device}")
    global LAUNCHES
    out = _launch_cuda(Vs, Hs, xs, ws, eps, kmax, done, away, xtol, VTs)
    LAUNCHES += 1
    return out


# ---- the kernel's launch plan -----------------------------------------------

_MAX_THREADS = 512
_CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 needs the non-portable opt-in
_STATIC_SMEM = 4608  # room left for the kernel's static shared memory
_MIN_COLS = 96       # fewer columns per CTA are not worth a larger cluster
_MAX_SLOTS = 64      # warps of a cluster: each has a slot in every CTA


class DensePlan(NamedTuple):
    """How one launch of the dense kernel is laid out on a card (see
    ``dense_plan``).  The fields after ``n`` are what the C entry takes,
    in its order."""
    n: int
    cluster: int     # CTAs per instance (the grid is B clusters)
    threads: int     # threads per CTA (a power-of-two number of warps)
    chunk: int       # CTA r owns columns [r chunk, (r + 1) chunk) below n
    resident: int    # 1: the CTA's panel of V, w and x live in shared
                     # memory; 0: one CTA streams V from the L2
    h_in_smem: int   # 1: every CTA keeps a copy of H in shared memory;
                     # 0: H stays in global memory
    smem_bytes: int  # dynamic shared memory per CTA

    def cols(self, r):
        """The columns of V that CTA ``r`` of a cluster owns."""
        return range(min(self.n, r * self.chunk),
                     min(self.n, (r + 1) * self.chunk))


def _pow2_warps(work):
    """Threads for ``work`` parallel items: a power-of-two number of
    warps, at most ``_MAX_THREADS``."""
    warps = 1
    while warps * 32 < _MAX_THREADS and warps * 32 < work:
        warps *= 2
    return 32 * warps


def dense_plan(B, m, n, sms, smem_limit, max_cluster):
    """The layout of one dense launch for B instances of an (m, n) design
    on a card of ``sms`` SMs whose CTAs may take ``smem_limit`` bytes of
    shared memory and whose largest schedulable cluster is ``max_cluster``
    CTAs.

    An instance runs on a cluster of C CTAs, the largest power of two with
    B C <= sms (and at least ``_MIN_COLS`` columns per CTA).  Every CTA
    keeps three length-m vectors, its own copy of H, and its n / C columns
    of V with their w and x (the panel's rows padded to an odd stride) in
    shared memory.  Where H and the panel do not fit together the cluster
    is halved; where they do not fit in one CTA either, one CTA per
    instance keeps H and streams V from the L2, and beyond that H stays in
    global memory as well."""
    if min(B, m, n, sms) < 1:
        raise ValueError(f"dense_plan needs positive sizes, got B={B} m={m} "
                         f"n={n} sms={sms}")
    if max_cluster not in _CLUSTER_SIZES:
        raise ValueError(f"max_cluster must be one of {_CLUSTER_SIZES}, got "
                         f"{max_cluster}")
    room = smem_limit - _STATIC_SMEM
    vec = 8 * 3 * m
    if vec > room:
        raise ValueError(f"m={m} needs {vec + _STATIC_SMEM} bytes of shared "
                         f"memory per CTA, the card gives {smem_limit}")
    cluster = 1
    while (2 * cluster <= max_cluster and B * 2 * cluster <= sms
           and n // (2 * cluster) >= _MIN_COLS):
        cluster *= 2
    while cluster >= 1:
        chunk = -(-n // cluster)
        need = vec + 8 * (m * m + m * (chunk | 1) + 2 * chunk)
        if need <= room:
            # a thread per column, or per eight elements of H if that is
            # more, within the slots that the warps of a cluster have
            threads = min(_pow2_warps(max(chunk, m * m // 8)),
                          32 * _MAX_SLOTS // cluster)
            return DensePlan(n, cluster, threads, chunk, 1, 1, need)
        cluster //= 2
    if vec + 8 * m * m <= room:
        return DensePlan(n, 1, _MAX_THREADS, n, 0, 1, vec + 8 * m * m)
    return DensePlan(n, 1, _MAX_THREADS, n, 0, 0, vec)


# The phases that thread 0 of CTA 0 clocks when a launch is given ``prof``
# (the kernel's ``Phase``).
PHASES = ("scan and warp merge", "exchange", "merge", "columns asked, "
          "slacks and step scalars", "columns staged", "g = H v",
          "H, u, w, x")


class _Kernel(NamedTuple):
    """The loaded library, bound once per process."""
    run: object
    info: object
    active_clusters: object
    error_string: object


@functools.lru_cache(maxsize=None)
def _kernel_lib():
    from . import _build

    lib = _build.load("dopt_dense")
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    ip = ctypes.POINTER(i)
    lib.dopt_dense_run.argtypes = [p] * 11 + [d, d] + [i] * 5 + [ip, p, i, p]
    lib.dopt_dense_run.restype = i
    if lib.dopt_dense_phases() != len(PHASES):
        raise RuntimeError("the dense kernel's phases differ from PHASES")
    lib.dopt_dense_info.argtypes = [i, ip]
    lib.dopt_dense_info.restype = i
    lib.dopt_dense_active_clusters.argtypes = [i, i, i, i, ip]
    lib.dopt_dense_active_clusters.restype = i
    lib.dopt_dense_error_string.argtypes = [i]
    lib.dopt_dense_error_string.restype = ctypes.c_char_p
    return _Kernel(lib.dopt_dense_run, lib.dopt_dense_info,
                   lib.dopt_dense_active_clusters,
                   lib.dopt_dense_error_string)


def _check_err(err, what):
    if err:
        raise RuntimeError(f"dopt_dense {what} failed: "
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
def device_plan(B, m, n, device_index):
    """``dense_plan`` for B instances of (m, n) on CUDA device
    ``device_index``, with the cluster size taken down to what the card
    says it can schedule (``cudaOccupancyMaxActiveClusters``).  Returns
    ``(plan, clusters the card holds at once)``."""
    limit = kernel_info(device_index)[3] + _STATIC_SMEM
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    active = ctypes.c_int()
    for max_cluster in reversed(_CLUSTER_SIZES):
        plan = dense_plan(B, m, n, sms, limit, max_cluster)
        if plan.cluster < max_cluster and max_cluster > 1:
            continue  # the same plan comes again under a smaller cap
        _check_err(_kernel_lib().active_clusters(
            device_index, plan.cluster, plan.threads, plan.smem_bytes,
            ctypes.byref(active)), "occupancy query")
        if active.value >= 1:
            return plan, active.value
    raise RuntimeError(f"the card schedules no launch of the dense kernel "
                       f"for B={B} m={m} n={n}")


def _launch_cuda(Vs, Hs, xs, ws, eps, kmax, done, away, xtol, VTs,
                 prof=None):
    """``prof``: a zeroed int64 tensor of ``len(PHASES)`` that thread 0 of
    CTA 0 adds its clocks per phase to."""
    B, m, n = Vs.shape
    if m > _MAX_M:
        raise ValueError(f"the dense kernel takes m <= {_MAX_M}, got {m}")
    dev = Vs.device
    plan, _ = device_plan(B, m, n, dev.index)
    if VTs is None:
        # a resident plan reads pivot columns from the panels, not from V^T
        VTs = Vs if plan.resident else Vs.transpose(1, 2).contiguous()
    elif (VTs.dtype != torch.float64 or VTs.device != Vs.device
          or tuple(VTs.shape) != (B, n, m) or not VTs.is_contiguous()):
        raise ValueError("VTs must be Vs.transpose(1, 2).contiguous() "
                         "(float64, same device)")
    f64 = dict(dtype=torch.float64, device=dev)
    xo = torch.empty((B, n), **f64)
    wo = torch.empty((B, n), **f64)
    Ho = torch.empty((B, m, m), **f64)
    misc = torch.empty((B, 3), **f64)
    hist = torch.empty((B, 5, max(kmax, 1)), **f64)
    flags = torch.tensor([0] * B if done is None else [int(bool(d))
                                                       for d in done],
                         dtype=torch.int32).to(dev)
    err = _kernel_lib().run(
        Vs.data_ptr(), VTs.data_ptr(), Hs.data_ptr(), xs.data_ptr(),
        ws.data_ptr(), flags.data_ptr(), xo.data_ptr(), wo.data_ptr(),
        Ho.data_ptr(), misc.data_ptr(), hist.data_ptr(), float(eps),
        float(xtol), B, m, n, int(kmax), int(bool(away)),
        (ctypes.c_int * 6)(*plan[1:]),
        None if prof is None else prof.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _check_err(err, "kernel launch")
    return DenseBlock(xo, wo, Ho, misc, hist[:, :, :kmax])


def dopt_fw_dense(V, x0, eps, maxitrs, away=True, verbose=True, verbskip=1,
                  chunk=None, refresh_every=0, checkpoint=None, device=None):
    """D-opt FW(-away) through dense launch blocks (the port of
    ``dopt_fw_pallas``).  Same contract as ``D_opt_FW_away``: returns
    ``(x, F, SP, SN, T)`` truncated at the first row with SP <= eps and
    SN <= eps; ``x`` is a float64 tensor on the device.

    ``chunk``: iterations per launch (default 8192, rounded up to a
    multiple of 64).  ``refresh_every``: full FP64 refactorization of
    (H, w, logdet) from the iterate at the first launch boundary at or past
    every R iterations.  ``checkpoint``: ``.npz`` snapshot at every launch
    boundary, the JAX ``dopt_fw_pallas`` format and fingerprint; a resume
    refactorizes from the saved iterate."""
    dev = resolve_device(device, like=V)
    V = as_f64(V, dev).contiguous()
    m, n = V.shape
    Vb = V[None]
    VTb = V.T.contiguous()[None] if dev.type == "cuda" else None

    def fresh_state(x):
        H, w, ld = factorize(V, x)
        return dict(x=x, w=w, H=H, ld=float(ld))

    def launch(state, kmax):
        blk = dense_block(Vb, state["H"][None], state["x"][None],
                          state["w"][None], eps=eps, kmax=kmax, away=away,
                          VTs=VTb)
        misc = blk.misc[0].cpu().numpy()  # the launch's one round trip
        hist = blk.hist[0].cpu().numpy()
        state.update(x=blk.x[0], w=blk.w[0], H=blk.H[0])
        return state, misc[0] > 0.5, hist[:, :int(misc[1])]

    name = ("Frank-Wolfe method with away steps" if away
            else "Frank-Wolfe method")
    return run_blocks(
        launch, fresh_state, as_f64(x0, dev), m, eps, maxitrs,
        block_len=-(-int(chunk or 8192) // _INNER) * _INNER,
        verbose=verbose, verbskip=verbskip, refresh_every=refresh_every,
        checkpoint=checkpoint,
        fingerprint=(f"dopt_fw_pallas|m={m}|n={n}|away={bool(away)}"
                     f"|eps={float(eps)!r}"),
        title=f"{name} (dense block kernel)")


def _lockstep_rows(misc, entered, kmax):
    """Rows a lockstep launch records for every instance of its group, as
    the JAX batch kernel counted them: all ``kmax`` while an instance is
    still running at the end, else up to the end of the ``_ROW_BLOCK`` in
    which the last instance stopped (0 when all entered done)."""
    if entered.all():
        return 0
    if (misc[:, 0] < 0.5).any():
        return kmax
    last = int(misc[~entered, 1].max()) - 1  # the latest stop row
    return min(kmax, (last // _ROW_BLOCK + 1) * _ROW_BLOCK)


def dopt_fw_dense_batch(Vs, x0s, eps, maxitrs, away=True, verbose=False,
                        chunk=None, refresh_every=0, group=None, device=None):
    """A batch of D-opt FW(-away) instances through the dense kernel, the
    port of ``dopt_fw_pallas_batch``.  Returns ``(x, F, SP, SN)`` with a
    leading batch axis: ``x`` a float64 tensor on the device, the
    histories numpy arrays of a common length T (the lockstep rows; an
    instance that stops early repeats its stop row's values).

    ``chunk``: rows per launch (default 4096, rounded up to a multiple of
    128).  ``refresh_every``: a full FP64 refactorization of every
    instance's (H, w, logdet) at the first launch boundary at or past every
    R rows.  ``group``: instances per launch, run one group after another
    and padded to a common T (default: every instance in one launch; the
    TPU needed groups to fit VMEM)."""
    dev = resolve_device(device, like=Vs)
    Vs = as_f64(Vs, dev).contiguous()
    K_inst, m, n = Vs.shape
    x0s = as_f64(x0s, dev)
    KB = -(-int(chunk or 4096) // _ROW_BLOCK) * _ROW_BLOCK
    group = K_inst if group is None else max(1, int(group))

    xs_out = torch.empty((K_inst, n), dtype=torch.float64, device=dev)
    F_groups, SP_groups, SN_groups = [], [], []
    for g0 in range(0, K_inst, group):
        gi = list(range(g0, min(g0 + group, K_inst)))
        Vg = Vs[gi[0]:gi[-1] + 1]
        VTg = Vg.transpose(1, 2).contiguous() if dev.type == "cuda" else None

        def refreshed(x):
            parts = [factorize(Vg[b], x[b]) for b in range(len(gi))]
            H = torch.stack([p[0] for p in parts])
            w = torch.stack([p[1] for p in parts])
            ld = np.array([float(p[2]) for p in parts])
            return H, w, ld

        x = x0s[gi[0]:gi[-1] + 1].clone()
        H, w, ld = refreshed(x)
        done = np.zeros(len(gi), bool)
        F_parts, SP_parts, SN_parts = [], [], []
        k_done = since_refresh = 0
        while k_done < maxitrs:
            kmax = min(KB, maxitrs - k_done)
            blk = dense_block(Vg, H, x, w, eps=eps, kmax=kmax,
                              done=done.tolist(), away=away, VTs=VTg)
            misc = blk.misc.cpu().numpy()
            nv = _lockstep_rows(misc, done, kmax)
            if nv == 0:
                break
            hist = blk.hist[:, :, :nv].cpu().numpy()
            F_rows, ld = f_rows(ld, hist[:, 0], hist[:, 1], m)
            F_parts.append(F_rows)
            SP_parts.append(hist[:, 2])
            SN_parts.append(hist[:, 3])
            x, w, H = blk.x, blk.w, blk.H
            done = misc[:, 0] > 0.5
            k_done += nv
            since_refresh += nv
            if verbose:
                print(f"[dense-batch] instances {gi[0]}-{gi[-1]}: "
                      f"k={k_done}, converged {int(done.sum())}/{len(gi)}, "
                      f"max slack {float(hist[:, 2, -1].max()):.3e}")
            if done.all():
                break
            if refresh_every and since_refresh >= refresh_every:
                H, w, ld = refreshed(x)
                since_refresh = 0
        xs_out[gi[0]:gi[-1] + 1] = x
        cat = (lambda parts: np.concatenate(parts, axis=1) if parts
               else np.zeros((len(gi), 0)))
        F_groups.append(cat(F_parts))
        SP_groups.append(cat(SP_parts))
        SN_groups.append(cat(SN_parts))

    # groups may stop at different row counts: pad with frozen repeats
    T = max(g.shape[1] for g in F_groups)

    def pad(groups):
        return np.concatenate(
            [np.concatenate([g, np.repeat(g[:, -1:], T - g.shape[1], 1)], 1)
             if g.shape[1] < T else g for g in groups], axis=0)

    return xs_out, pad(F_groups), pad(SP_groups), pad(SN_groups)
