"""Lazy-H block engine for large D-optimal design Frank-Wolfe.

Port of ``accbpg_and_fw_tpu/ops/pallas_dopt_lazy.py``.  Within a launch
block of up to ``_KR`` iterations the inverse is carried lazily,

    H_k = alpha_k * H0  +  C diag(beta) C^T,

with H0 frozen: each iteration appends g = H v as a row of C with
beta = -c and rescales alpha and beta by 1/(1 - tau), so no m^2 work runs
per iteration.  Between blocks the host folds the rank buffer back,
H0' = alpha H0 + C^T diag(beta) C, and rebuilds the F history in f64 from
the recorded (tau, tau (w_v - 1)) pairs.

The TPU kernel carried double-single pairs and int8 digit planes because
Mosaic has no f64; here the whole block runs in FP64.  ``lazy_block`` is
the block: on a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/dopt_lazy.cu``), on a CPU tensor it runs ``lazy_block_reference``,
the plain PyTorch version of the same iteration.  ``lazy_block_batch`` is
the same block for K instances of one shape (the port of the JAX
grid-over-instances kernel), and ``dopt_fw_lazy_batch`` the sweep driver
around it.

How a launch is laid out on the card (which columns of V and rows of H0
each CTA owns, how many columns stay in shared memory, the scratch sizes,
the groups and waves for K instances) is decided here, in ``launch_plan``,
from the SM count and the shared-memory limit, and handed to the C
entries.  A driver prepares the kernel once per solve (``_LazyKernel``:
the plan checked against the device, scratch and output buffers allocated
once) and reads a block's rows back in one copy.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .._device import as_f64, resolve_device
from .dopt_common import (XTOL, check_operands, f_rows, factorize, pivots,
                          run_blocks, step_scalars)

_KR = 256         # iterations per launch block == rank-buffer capacity
_MAX_M = 16384    # the kernel keeps one length-m vector in shared memory

# Kernel launches made by ``lazy_block`` and by ``lazy_block_batch`` on a
# CUDA tensor (never by the plain versions), so a run can show that it
# went through each kernel.
LAUNCHES = 0
BATCH_LAUNCHES = 0


class LazyBlock(NamedTuple):
    """One launch block's results (all float64 on the input's device).

    ``C`` (KR, m) holds the appended g rows and ``beta`` (KR,) their
    weights; rows ``>= nrun`` are unspecified.  ``misc`` is
    ``[done, iters, alpha, nrun]``: ``iters`` rows were recorded, ``nrun``
    of them ran (the stop row records slacks only).  ``hist`` (5, KR) holds
    ``tau``, ``tau (w_v - 1)``, ``SP``, ``SN`` and the pivot ``v`` per
    recorded row (columns ``>= iters`` are unspecified); on the stop row
    ``tau`` and ``tau (w_v - 1)`` are 0 and ``v`` is -1."""
    x: torch.Tensor
    w: torch.Tensor
    C: torch.Tensor
    beta: torch.Tensor
    misc: torch.Tensor
    hist: torch.Tensor


def lazy_block_reference(V, H0, x, w, *, eps, kmax, done=False, away=True,
                         xtol=XTOL):
    """Plain PyTorch version of one launch block: up to ``kmax`` FW(-away)
    iterations on the lazy inverse, with the semantics of the TPU kernel
    ``_lazy_kernel_body`` in FP64.  Scalars go through the host."""
    m, n = V.shape
    KR = _KR
    f64 = dict(dtype=torch.float64, device=V.device)
    C = torch.zeros((KR, m), **f64)
    beta = torch.zeros(KR, **f64)
    hist = torch.zeros((5, KR), **f64)
    x = x.clone()
    w = w.clone()
    m_f = float(m)
    alpha = 1.0
    k = 0
    done = bool(done)
    while k < kmax and not done:
        i, wi, j, wj = pivots(w, x, away, xtol)
        sp, sn, v, wv, tau, drop = step_scalars(
            away, m_f, i, wi, j, wj, float(x[j]) if away else 0.0)
        hist[2, k] = sp
        hist[3, k] = sn
        if sp <= eps and sn <= eps:
            hist[4, k] = -1.0
            done = True
            k += 1
            break

        wvm1 = wv - 1.0
        c = tau / (1.0 + tau * wvm1)
        r = 1.0 / (1.0 - tau)

        vcol = V[:, v]
        g = alpha * (H0 @ vcol)
        if k:
            g = g + C[:k].T @ (beta[:k] * (C[:k] @ vcol))
        u = g @ V
        u[v] = wv  # consistency pin u[v] = w[v]
        w = (w - c * (u * u)) * r

        C[k] = g
        beta[k] = -c
        beta[:k + 1] *= r
        alpha *= r
        x = x * (1.0 - tau)
        x[v] = 0.0 if drop else float(x[v]) + tau

        hist[0, k] = tau
        hist[1, k] = tau * wvm1
        hist[4, k] = v
        k += 1
    nrun = k - 1 if done and k else k
    misc = torch.tensor([float(done), float(k), alpha, float(nrun)], **f64)
    return LazyBlock(x, w, C, beta, misc, hist)


def _check_block_args(V, H0, x, w, kmax):
    if V.dim() != 2:
        raise ValueError(f"V must be 2-d, got shape {tuple(V.shape)}")
    m, n = V.shape
    check_operands(V.device, (("V", V, (m, n)), ("H0", H0, (m, m)),
                              ("x", x, (n,)), ("w", w, (n,))))
    if not 0 <= kmax <= _KR:
        raise ValueError(f"kmax={kmax} outside [0, {_KR}]")


def lazy_block(V, H0, x, w, *, eps, kmax, done=False, away=True, xtol=XTOL,
               VT=None):
    """One launch block (see ``lazy_block_reference``).

    On a CUDA tensor this launches the Hopper kernel and counts the launch
    in ``LAUNCHES``; a launch that fails raises.  On a CPU tensor it runs
    the plain version.  ``VT`` is ``V.T.contiguous()``, which is what the
    kernel reads; pass it to avoid a copy per call."""
    _check_block_args(V, H0, x, w, kmax)
    return _prepared(V, VT).run(H0, x, w, eps=eps, kmax=kmax, done=done,
                                away=away, xtol=xtol)


# ---- the kernel's launch plan -----------------------------------------------

_WARPS = 16          # warps of a CTA (512 threads)
_STATIC_SMEM = 2048  # room left for the kernel's static shared memory
_MAX_SEGS = 8        # most segments a row of H0 is cut into
_BAR_WORDS = 32      # the barrier's 128-byte line, in ints


class LaunchPlan(NamedTuple):
    """How one launch of the lazy-H kernel is laid out on a card (see
    ``launch_plan``).  The fields up to ``iwords`` are what the C entries
    take, in their order."""
    group: int       # CTAs per instance
    wave: int        # instances per cooperative launch
    col_base: int    # CTA b owns col_base + (b < col_extra) columns of V
    col_extra: int
    row_base: int    # ... and row_base + (b < row_extra) rows of H0
    row_extra: int
    resident: int    # columns a CTA keeps in shared memory (the first
                     # of its own; it streams the rest each iteration)
    segs: int        # segments a row of H0 (or C) is cut into for H0 v
    seg_len: int     # their length, a multiple of 32
    smem_bytes: int  # dynamic shared memory per CTA
    dwords: int      # double scratch per instance
    iwords: int      # int scratch per instance
    waves: int       # launches that K instances take

    def cols(self, b):
        """The columns of V that CTA ``b`` of a group owns."""
        start = b * self.col_base + min(b, self.col_extra)
        return range(start, start + self.col_base + (b < self.col_extra))

    def rows(self, b):
        """The rows of H0 that CTA ``b`` of a group owns."""
        start = b * self.row_base + min(b, self.row_extra)
        return range(start, start + self.row_base + (b < self.row_extra))


def launch_plan(m, n, kr, K, sms, smem_limit):
    """The layout of one lazy-H launch for K instances of an (m, n) design
    with a ``kr``-row rank buffer, on a card of ``sms`` SMs whose CTAs may
    take ``smem_limit`` bytes of shared memory.

    One persistent CTA per SM.  A wave runs ``min(K, sms)`` instances side
    by side, each on a group of ``sms // wave`` CTAs.  Within a group the
    columns of V and the rows of H0 are split evenly (the first ``extra``
    CTAs take one more), the rows of C round-robin.  A CTA's shared memory
    holds one length-m vector, the segment sums of its rows, and as many
    of its own columns of V as the rest of the limit takes."""
    if min(m, n, kr, K, sms) < 1:
        raise ValueError(f"launch_plan needs positive sizes, got m={m} n={n} "
                         f"kr={kr} K={K} sms={sms}")
    wave = min(K, sms)
    group = sms // wave
    col_base, col_extra = divmod(n, group)
    row_base, row_extra = divmod(m, group)
    rows = row_base + 1 + -(-kr // group)  # most rows of H0 and C per CTA
    segs = max(1, min(_MAX_SEGS, -(-_WARPS // rows), -(-m // 32)))
    seg_len = 32 * -(-m // (32 * segs))
    fixed = 8 * (m + rows * segs + rows)
    room = smem_limit - _STATIC_SMEM - fixed
    if room < 0:
        raise ValueError(f"m={m} needs {fixed + _STATIC_SMEM} bytes of shared "
                         f"memory per CTA, the card gives {smem_limit}")
    # a resident column takes its m doubles and its w and x
    resident = min(col_base + (col_extra > 0), room // (8 * (m + 2)))
    iwords = -(-(_BAR_WORDS + 2 * group) // _BAR_WORDS) * _BAR_WORDS
    return LaunchPlan(group, wave, col_base, col_extra, row_base, row_extra,
                      resident, segs, seg_len,
                      fixed + 8 * resident * (m + 2),
                      m + kr + 3 * group, iwords, -(-K // wave))


def _kernel_lib():
    from . import _build

    lib = _build.load("dopt_lazy")
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    ip = ctypes.POINTER(ctypes.c_int)
    lib.dopt_lazy_plan_len.argtypes = []
    lib.dopt_lazy_plan_len.restype = i
    lib.dopt_lazy_prepare.argtypes = [ip, i, i, i, i, ip]
    lib.dopt_lazy_prepare.restype = i
    lib.dopt_lazy_run.argtypes = ([ip] + [p] * 13 + [d, d] + [i] * 6 + [p])
    lib.dopt_lazy_run.restype = i
    lib.dopt_lazy_batch_run.argtypes = ([ip] + [p] * 14 + [d, d] + [i] * 5
                                        + [p])
    lib.dopt_lazy_batch_run.restype = i
    lib.dopt_lazy_error_string.argtypes = [i]
    lib.dopt_lazy_error_string.restype = ctypes.c_char_p
    return lib


class _LazyKernel:
    """The Hopper kernel prepared for one design on one card: the launch
    plan (made and checked against the device once), the scratch, and the
    output buffers, which every ``run`` reuses.

    ``VT`` is ``V.T.contiguous()`` (n, m) for the single-instance entry or
    ``Vs.transpose(1, 2).contiguous()`` (K, n, m) for the batch entry.  A
    block's C, beta, misc and hist are overwritten by the next ``run``; x
    and w alternate between two buffers, so a block's x and w may be the
    next block's inputs."""

    def __init__(self, VT):
        if (VT.dtype != torch.float64 or VT.device.type != "cuda"
                or VT.dim() not in (2, 3) or not VT.is_contiguous()):
            raise ValueError("VT must be a contiguous float64 CUDA tensor, "
                             "V.T of one design or of a stack of designs")
        self.batch = VT.dim() == 3
        self.VT = VT
        self.K = VT.shape[0] if self.batch else 1
        self.n, self.m = VT.shape[-2:]
        self.kr = _KR
        K, m, n, kr = self.K, self.m, self.n, self.kr
        if m > _MAX_M:
            raise ValueError(f"the lazy kernel takes m <= {_MAX_M}, got {m}")
        dev = self.dev = VT.device
        props = torch.cuda.get_device_properties(dev)
        self.plan = launch_plan(m, n, kr, K, props.multi_processor_count,
                                props.shared_memory_per_block_optin)
        self.lib = _kernel_lib()
        n_plan = self.lib.dopt_lazy_plan_len()
        self._plan = (ctypes.c_int * n_plan)(*self.plan[:n_plan])
        info = (ctypes.c_int * 4)()
        with torch.cuda.device(dev):
            self._check(self.lib.dopt_lazy_prepare(
                self._plan, m, n, kr, int(self.batch), info), "prepare")
        self.regs = info[0]  # registers per thread, as compiled
        f64 = dict(dtype=torch.float64, device=dev)
        self._xw = torch.empty((2, 2, K, n), **f64)  # two (x, w) pairs
        self._turn = 0
        self._C = torch.empty((K, kr, m), **f64)
        self._beta = torch.empty((K, kr), **f64)
        self._rows = torch.empty(K * (4 + 5 * kr), **f64)  # misc, then hist
        self._dscr = torch.empty(K * self.plan.dwords, **f64)
        self._iscr = torch.empty(K * self.plan.iwords, dtype=torch.int32,
                                 device=dev)

    def _check(self, err, what):
        if err:
            raise RuntimeError(
                f"dopt_lazy {what} failed: "
                + self.lib.dopt_lazy_error_string(err).decode())

    def run(self, H0, x, w, *, eps, kmax, done, away, xtol, prof=None):
        """Launch one block from ``(H0, x, w)`` and count it.  Single
        entry: ``kmax`` an int and ``done`` a bool; batch entry: one of
        each per instance (``done`` may be None).  ``prof``: a zeroed int64
        tensor of 8 that CTA 0 adds its clocks per phase to."""
        global LAUNCHES, BATCH_LAUNCHES
        K, m, n, kr = self.K, self.m, self.n, self.kr
        lead = (K,) if self.batch else ()
        check_operands(self.dev, (("H0", H0, lead + (m, m)),
                                  ("x", x, lead + (n,)),
                                  ("w", w, lead + (n,))))
        pair = self._xw[self._turn]
        if x.data_ptr() == pair[0].data_ptr() or \
                w.data_ptr() == pair[1].data_ptr():
            self._turn ^= 1
            pair = self._xw[self._turn]
        self._turn ^= 1
        misc = self._rows[:4 * K].view(K, 4)
        hist = self._rows[4 * K:].view(K, 5, kr)
        ptrs = (self.VT.data_ptr(), H0.data_ptr(), x.data_ptr(),
                w.data_ptr(), pair[0].data_ptr(), pair[1].data_ptr(),
                self._C.data_ptr(), self._beta.data_ptr(), misc.data_ptr(),
                hist.data_ptr(), self._dscr.data_ptr(),
                self._iscr.data_ptr())
        with torch.cuda.device(self.dev):
            stream = torch.cuda.current_stream(self.dev).cuda_stream
            if self.batch:
                done = [False] * K if done is None else done
                flags = torch.tensor([[int(q) for q in kmax],
                                      [int(bool(d)) for d in done]],
                                     dtype=torch.int32).to(self.dev)
                err = self.lib.dopt_lazy_batch_run(
                    self._plan, *ptrs, flags[0].data_ptr(),
                    flags[1].data_ptr(), float(eps), float(xtol), m, n, kr,
                    K, int(bool(away)), stream)
            else:
                err = self.lib.dopt_lazy_run(
                    self._plan, *ptrs,
                    None if prof is None else prof.data_ptr(), float(eps),
                    float(xtol), m, n, kr, int(kmax), int(bool(done)),
                    int(bool(away)), stream)
        self._check(err, "kernel launch")
        if self.batch:
            BATCH_LAUNCHES += self.plan.waves
            return LazyBlock(pair[0], pair[1], self._C, self._beta, misc,
                             hist)
        LAUNCHES += 1
        return LazyBlock(pair[0, 0], pair[1, 0], self._C[0], self._beta[0],
                         misc[0], hist[0])

    def host_rows(self):
        """The last block's ``(misc, hist)`` as numpy arrays, in one copy
        to the host (the block's one round trip)."""
        rows = self._rows.cpu().numpy()
        K, kr = self.K, self.kr
        misc = rows[:4 * K].reshape(K, 4)
        hist = rows[4 * K:].reshape(K, 5, kr)
        return (misc, hist) if self.batch else (misc[0], hist[0])


class _PlainBlocks:
    """The plain version behind ``_LazyKernel``'s interface, for a design
    (m, n) or a stack of designs (K, m, n) on the CPU."""

    def __init__(self, V):
        self.V = V
        self.batch = V.dim() == 3

    def run(self, H0, x, w, *, eps, kmax, done, away, xtol):
        ref = (lazy_block_batch_reference if self.batch
               else lazy_block_reference)
        self._blk = ref(self.V, H0, x, w, eps=eps, kmax=kmax, done=done,
                        away=away, xtol=xtol)
        return self._blk

    def host_rows(self):
        return self._blk.misc.numpy(), self._blk.hist.numpy()


def _prepared(V, VT=None):
    """What runs the blocks of a design ``V`` (m, n) or of a stack (K, m,
    n): the Hopper kernel on a CUDA tensor, the plain version on a CPU
    tensor, and nothing else.  ``VT`` is ``V.transpose(-2, -1).contiguous()``
    where the caller holds it already (the kernel reads it)."""
    if V.device.type == "cpu":
        return _PlainBlocks(V)
    if V.device.type != "cuda":
        raise ValueError(f"the lazy-H block runs on cpu or cuda, not "
                         f"{V.device}")
    if VT is None:
        VT = V.transpose(-2, -1).contiguous()
    elif VT.device != V.device or VT.shape != V.transpose(-2, -1).shape:
        raise ValueError("VT must be V.transpose(-2, -1).contiguous() "
                         "(float64, same device)")
    return _LazyKernel(VT)


def lazy_block_batch_reference(Vs, H0s, xs, ws, *, eps, kmax, done=None,
                               away=True, xtol=XTOL):
    """Plain version of one launch block for K instances: the plain block
    of each instance with its own ``kmax[k]`` and ``done[k]``, stacked
    along a leading axis."""
    K = Vs.shape[0]
    done = [False] * K if done is None else list(done)
    outs = [lazy_block_reference(Vs[k], H0s[k], xs[k], ws[k], eps=eps,
                                 kmax=int(kmax[k]), done=done[k], away=away,
                                 xtol=xtol) for k in range(K)]
    return LazyBlock(*(torch.stack(t) for t in zip(*outs)))


def _check_batch_args(Vs, H0s, xs, ws, kmax, done):
    if Vs.dim() != 3:
        raise ValueError(f"Vs must be 3-d (K, m, n), got {tuple(Vs.shape)}")
    K, m, n = Vs.shape
    check_operands(Vs.device, (("Vs", Vs, (K, m, n)), ("H0s", H0s, (K, m, m)),
                               ("xs", xs, (K, n)), ("ws", ws, (K, n))))
    if len(kmax) != K or (done is not None and len(done) != K):
        raise ValueError(f"kmax and done need one entry per instance ({K})")
    if not all(0 <= int(q) <= _KR for q in kmax):
        raise ValueError(f"kmax={list(kmax)} outside [0, {_KR}]")


def lazy_block_batch(Vs, H0s, xs, ws, *, eps, kmax, done=None, away=True,
                     xtol=XTOL, VTs=None):
    """One launch block for K instances of one (m, n) shape (see
    ``lazy_block_batch_reference``): ``kmax`` and ``done`` hold one entry
    per instance, and every field of the result gains a leading K axis.

    On a CUDA tensor this launches the instance-partitioned Hopper kernel
    (all instances side by side, in waves when they outnumber the SMs) and
    adds its launches to ``BATCH_LAUNCHES``; a launch that fails raises.
    On a CPU tensor it runs the plain version.  ``VTs`` is
    ``Vs.transpose(1, 2).contiguous()``; pass it to avoid a copy per
    call."""
    _check_batch_args(Vs, H0s, xs, ws, kmax, done)
    return _prepared(Vs, VTs).run(H0s, xs, ws, eps=eps, kmax=kmax, done=done,
                                  away=away, xtol=xtol)


def _lazy_refresh(H0, C, beta, alpha):
    """Fold the block's rank buffer back: H0' = alpha H0 + C^T diag(beta) C
    (an FP64 matmul outside the kernel, as the JAX package leaves it to
    XLA)."""
    return alpha * H0 + (C.T * beta) @ C


def dopt_fw_lazy(V, x0, eps, maxitrs, away=True, verbose=True, verbskip=1,
                 chunk=None, refresh_every=0, checkpoint=None, device=None):
    """D-opt FW(-away) through lazy-H blocks (the port of
    ``dopt_fw_pallas_lazy``).  Same contract as ``D_opt_FW_away``: returns
    ``(x, F, SP, SN, T)`` truncated at the stopping iteration (``chunk`` is
    accepted and unused: a block is ``_KR`` iterations).

    ``refresh_every``: full FP64 refactorization cadence, rounded UP to
    block boundaries.  ``checkpoint``: ``.npz`` snapshot at every block
    boundary, the JAX ``dopt_fw_pallas_lazy`` format and fingerprint; a
    resume refactorizes from the saved iterate."""
    dev = resolve_device(device, like=V)
    V = as_f64(V, dev).contiguous()
    m, n = V.shape
    # prepared once for the solve (on the card: plan, scratch and output
    # buffers; C and beta are folded before the next launch)
    kernel = _prepared(V)

    def fresh_state(x):
        H0, w, ld = factorize(V, x)
        return dict(x=x, w=w, H0=H0, ld=float(ld))

    def launch(state, kmax):
        blk = kernel.run(state["H0"], state["x"], state["w"], eps=eps,
                         kmax=kmax, done=False, away=away, xtol=XTOL)
        misc, hist = kernel.host_rows()
        nrun = int(misc[3])
        if nrun:
            state["H0"] = _lazy_refresh(state["H0"], blk.C[:nrun],
                                        blk.beta[:nrun], blk.misc[2])
        state["x"], state["w"] = blk.x, blk.w
        return state, misc[0] > 0.5, hist[:, :int(misc[1])]

    name = ("Frank-Wolfe method with away steps" if away
            else "Frank-Wolfe method")
    return run_blocks(
        launch, fresh_state, as_f64(x0, dev), m, eps, maxitrs,
        block_len=_KR, verbose=verbose, verbskip=verbskip,
        refresh_every=refresh_every, checkpoint=checkpoint,
        fingerprint=(f"dopt_fw_pallas_lazy|m={m}|n={n}|away={bool(away)}"
                     f"|eps={float(eps)!r}"),
        title=f"{name} (lazy-H block kernel)")


def _lazy_refresh_batch(H0s, C, beta, alpha, nrun):
    """``_lazy_refresh`` for K instances in one batched GEMM.  Rows at and
    past ``nrun[k]`` of C and beta are unspecified and are masked out, so
    an instance that ran no iteration (alpha = 1) keeps its H0 bit for
    bit."""
    top = int(max(nrun))
    if top == 0:
        return H0s
    live = (torch.arange(top, device=C.device)
            < torch.as_tensor(nrun, device=C.device)[:, None])
    Cm = torch.where(live[..., None], C[:, :top], 0.0)
    bm = torch.where(live, beta[:, :top], 0.0)
    return torch.baddbmm(H0s * alpha[:, None, None],
                         Cm.transpose(1, 2) * bm[:, None, :], Cm)


def _fresh_w(H0s, Vs):
    """w = diag(V^T H0 V) per instance from the carried folded H0, which
    after a fold is the current inverse (the port of the JAX ``_fresh_w``,
    which also ran outside the kernel)."""
    return (Vs * torch.bmm(H0s, Vs)).sum(dim=1)


def _next_pow2(v):
    """The JAX engines' power-of-two rounding (never below 8)."""
    p = 8
    while p < v:
        p *= 2
    return p


def _pad_rows(parts, T, first):
    """One instance's history of length T: its emitted rows, then frozen
    repeats of the last one.  An instance that emitted no row holds
    ``first`` (its initial iterate's value) throughout."""
    rows = np.concatenate(parts) if parts else np.zeros(0)
    out = np.full(T, rows[-1] if rows.size else first)
    out[:rows.size] = rows
    return out


def dopt_fw_lazy_batch(Vs, x0s, eps, num_iters, away=True, group=None,
                       verbose=False, refresh_every=0, device=None):
    """K same-shape D-opt instances through lazy-H launch blocks (the port
    of ``dopt_fw_pallas_lazy_batch``).  ``Vs`` (K, m, n), ``x0s`` (K, n).
    Returns ``(x, F, SP, SN)``: ``x`` a (K, n) float64 tensor on the
    device, the histories (K, T) numpy arrays, T the largest per-instance
    row count; an instance stops at its first row with SP <= eps and
    SN <= eps and its later rows repeat that row.

    Each block runs every live instance (a stopped one re-enters with
    kmax = 0 and keeps its state), then one batched fold.
    ``refresh_every``: the w-only refresh w = diag(V^T H0 V) from the
    folded H0, on the JAX cadence: the JAX engine dispatched ``group``
    blocks at a time (by default ``nb = min(next_pow2(ceil(num_iters /
    256)), 32)``, capped at ``next_pow2(ceil(refresh_every / 256))``, with
    next_pow2 never below 8) and refreshed after a dispatch once
    ``nb * 256 >= refresh_every`` iterations had accumulated; here the
    same count of blocks makes one round."""
    dev = resolve_device(device, like=Vs)
    Vs = as_f64(Vs, dev).contiguous()
    K, m, n = Vs.shape
    x = as_f64(x0s, dev).clone()
    kernel = _prepared(Vs)
    parts = [factorize(Vs[k], x[k]) for k in range(K)]
    H0 = torch.stack([p[0] for p in parts])
    w = torch.stack([p[1] for p in parts])
    ld = np.array([float(p[2]) for p in parts])
    m_f = float(m)
    first = []
    for k in range(K):
        i, wi, j, wj = pivots(w[k], x[k], away, XTOL)
        first.append((-ld[k], (wi - m_f) / m_f, (m_f - wj) / m_f))

    if group is None:
        nb = min(_next_pow2(max(1, -(-num_iters // _KR))), 32)
        if refresh_every:
            nb = min(nb, _next_pow2(max(1, -(-refresh_every // _KR))))
    else:
        nb = max(1, int(group))
    rows = [([], [], []) for _ in range(K)]
    stopped = np.zeros(K, bool)
    emitted = np.zeros(K, np.int64)
    since_refresh = 0
    while (~stopped).any() and (emitted[~stopped] < num_iters).any():
        for _ in range(nb):
            if stopped.all():
                break  # the rest of the JAX dispatch would be no-ops
            kmax = [0 if stopped[k] else int(min(_KR, num_iters - emitted[k]))
                    for k in range(K)]
            blk = kernel.run(H0, x, w, eps=eps, kmax=kmax, done=None,
                             away=away, xtol=XTOL)
            misc, hist = kernel.host_rows()
            x, w = blk.x, blk.w
            H0 = _lazy_refresh_batch(H0, blk.C, blk.beta, blk.misc[:, 2],
                                     misc[:, 3].astype(np.int64))
            for k in range(K):
                if stopped[k]:
                    continue
                nv = int(misc[k, 1])
                if nv:
                    F_k, ld[k] = f_rows(ld[k], hist[k, 0, :nv],
                                        hist[k, 1, :nv], m)
                    for dst, src in zip(rows[k], (F_k, hist[k, 2, :nv],
                                                  hist[k, 3, :nv])):
                        dst.append(src)
                    emitted[k] += nv
                if misc[k, 0] > 0.5 or emitted[k] >= num_iters:
                    stopped[k] = True
        if verbose:
            print(f"# lazy batch: emitted={emitted.tolist()} "
                  f"stopped={int(stopped.sum())}/{K}")
        since_refresh += nb * _KR
        if (refresh_every and since_refresh >= refresh_every
                and (~stopped).any()):
            w = _fresh_w(H0, Vs)
            since_refresh = 0

    T = int(emitted.max()) if K else 0
    F, SP, SN = (np.stack([_pad_rows(rows[k][q], T, first[k][q])
                           for k in range(K)]) if K else np.zeros((0, T))
                 for q in range(3))
    return x, F, SP, SN
