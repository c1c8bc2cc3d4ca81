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
    recorded row; on the stop row ``tau`` and ``tau (w_v - 1)`` are 0 and
    ``v`` is -1."""
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
    the plain version.  ``VT`` is ``V.T.contiguous()``, which the kernel
    reads the pivot column from; pass it to avoid a copy per call."""
    _check_block_args(V, H0, x, w, kmax)
    if V.device.type == "cpu":
        return lazy_block_reference(V, H0, x, w, eps=eps, kmax=kmax,
                                    done=done, away=away, xtol=xtol)
    if V.device.type != "cuda":
        raise ValueError(f"lazy_block runs on cpu or cuda, not {V.device}")
    global LAUNCHES
    out = _launch_cuda(V, H0, x, w, eps, kmax, done, away, xtol, VT)
    LAUNCHES += 1
    return out


def _kernel_lib():
    from . import _build

    lib = _build.load("dopt_lazy")
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.dopt_lazy_scratch.argtypes = [i, i, i,
                                      ctypes.POINTER(ctypes.c_longlong),
                                      ctypes.POINTER(ctypes.c_longlong)]
    lib.dopt_lazy_scratch.restype = i
    lib.dopt_lazy_run.argtypes = ([p] * 13 + [d, d] + [i] * 6 + [p])
    lib.dopt_lazy_run.restype = i
    lib.dopt_lazy_batch_scratch.argtypes = [
        i, i, i, i, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(i)]
    lib.dopt_lazy_batch_scratch.restype = i
    lib.dopt_lazy_batch_run.argtypes = ([p] * 15 + [d, d] + [i] * 5 + [p])
    lib.dopt_lazy_batch_run.restype = i
    lib.dopt_lazy_error_string.argtypes = [i]
    lib.dopt_lazy_error_string.restype = ctypes.c_char_p
    return lib


def _launch_cuda(V, H0, x, w, eps, kmax, done, away, xtol, VT):
    m, n = V.shape
    if m > _MAX_M:
        raise ValueError(f"the lazy kernel takes m <= {_MAX_M}, got {m}")
    if VT is None:
        VT = V.T.contiguous()
    elif (VT.dtype != torch.float64 or VT.device != V.device
          or tuple(VT.shape) != (n, m) or not VT.is_contiguous()):
        raise ValueError("VT must be V.T.contiguous() (float64, same device)")
    lib = _kernel_lib()
    dwords, iwords = ctypes.c_longlong(), ctypes.c_longlong()
    err = lib.dopt_lazy_scratch(m, n, _KR, ctypes.byref(dwords),
                                ctypes.byref(iwords))
    if err:
        raise RuntimeError("dopt_lazy_scratch failed: "
                           + lib.dopt_lazy_error_string(err).decode())
    dev = V.device
    f64 = dict(dtype=torch.float64, device=dev)
    xo = torch.empty(n, **f64)
    wo = torch.empty(n, **f64)
    C = torch.empty((_KR, m), **f64)
    beta = torch.empty(_KR, **f64)
    misc = torch.empty(4, **f64)
    hist = torch.empty((5, _KR), **f64)
    dscr = torch.empty(dwords.value, **f64)
    iscr = torch.zeros(iwords.value, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dopt_lazy_run(
            V.data_ptr(), VT.data_ptr(), H0.data_ptr(), x.data_ptr(),
            w.data_ptr(), xo.data_ptr(), wo.data_ptr(), C.data_ptr(),
            beta.data_ptr(), misc.data_ptr(), hist.data_ptr(),
            dscr.data_ptr(), iscr.data_ptr(), float(eps), float(xtol),
            m, n, _KR, int(kmax), int(bool(done)), int(bool(away)), stream)
    if err:
        raise RuntimeError("dopt_lazy kernel launch failed: "
                           + lib.dopt_lazy_error_string(err).decode())
    return LazyBlock(xo, wo, C, beta, misc, hist)


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


def lazy_block_batch(Vs, H0s, xs, ws, *, eps, kmax, done=None, away=True,
                     xtol=XTOL, VTs=None):
    """One launch block for K instances of one (m, n) shape (see
    ``lazy_block_batch_reference``): ``kmax`` and ``done`` hold one entry
    per instance, and every field of the result gains a leading K axis.

    On a CUDA tensor this launches the instance-partitioned Hopper kernel
    (all instances side by side, in waves when they outnumber the
    co-resident CTAs) and adds its launches to ``BATCH_LAUNCHES``; a launch
    that fails raises.  On a CPU tensor it runs the plain version.  ``VTs``
    is ``Vs.transpose(1, 2).contiguous()``; pass it to avoid a copy per
    call."""
    if Vs.dim() != 3:
        raise ValueError(f"Vs must be 3-d (K, m, n), got {tuple(Vs.shape)}")
    K, m, n = Vs.shape
    check_operands(Vs.device, (("Vs", Vs, (K, m, n)), ("H0s", H0s, (K, m, m)),
                               ("xs", xs, (K, n)), ("ws", ws, (K, n))))
    if len(kmax) != K or (done is not None and len(done) != K):
        raise ValueError(f"kmax and done need one entry per instance ({K})")
    if not all(0 <= int(q) <= _KR for q in kmax):
        raise ValueError(f"kmax={list(kmax)} outside [0, {_KR}]")
    if Vs.device.type == "cpu":
        return lazy_block_batch_reference(Vs, H0s, xs, ws, eps=eps,
                                          kmax=kmax, done=done, away=away,
                                          xtol=xtol)
    if Vs.device.type != "cuda":
        raise ValueError(f"lazy_block_batch runs on cpu or cuda, not "
                         f"{Vs.device}")
    global BATCH_LAUNCHES
    out, waves = _launch_cuda_batch(Vs, H0s, xs, ws, eps, kmax, done, away,
                                    xtol, VTs)
    BATCH_LAUNCHES += waves
    return out


def _launch_cuda_batch(Vs, H0s, xs, ws, eps, kmax, done, away, xtol, VTs):
    K, m, n = Vs.shape
    if m > _MAX_M:
        raise ValueError(f"the lazy kernel takes m <= {_MAX_M}, got {m}")
    if VTs is None:
        VTs = Vs.transpose(1, 2).contiguous()
    elif (VTs.dtype != torch.float64 or VTs.device != Vs.device
          or tuple(VTs.shape) != (K, n, m) or not VTs.is_contiguous()):
        raise ValueError("VTs must be Vs.transpose(1, 2).contiguous() "
                         "(float64, same device)")
    lib = _kernel_lib()
    dwords, iwords = ctypes.c_longlong(), ctypes.c_longlong()
    waves = ctypes.c_int()
    err = lib.dopt_lazy_batch_scratch(m, n, _KR, K, ctypes.byref(dwords),
                                      ctypes.byref(iwords),
                                      ctypes.byref(waves))
    if err:
        raise RuntimeError("dopt_lazy_batch_scratch failed: "
                           + lib.dopt_lazy_error_string(err).decode())
    dev = Vs.device
    f64 = dict(dtype=torch.float64, device=dev)
    xo = torch.empty((K, n), **f64)
    wo = torch.empty((K, n), **f64)
    C = torch.empty((K, _KR, m), **f64)
    beta = torch.empty((K, _KR), **f64)
    misc = torch.empty((K, 4), **f64)
    hist = torch.empty((K, 5, _KR), **f64)
    dscr = torch.empty(K * dwords.value, **f64)
    iscr = torch.zeros(K * iwords.value, dtype=torch.int32, device=dev)
    flags = torch.tensor(
        [[int(q) for q in kmax],
         [0] * K if done is None else [int(bool(d)) for d in done]],
        dtype=torch.int32).to(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dopt_lazy_batch_run(
            Vs.data_ptr(), VTs.data_ptr(), H0s.data_ptr(), xs.data_ptr(),
            ws.data_ptr(), xo.data_ptr(), wo.data_ptr(), C.data_ptr(),
            beta.data_ptr(), misc.data_ptr(), hist.data_ptr(),
            dscr.data_ptr(), iscr.data_ptr(), flags[0].data_ptr(),
            flags[1].data_ptr(), float(eps), float(xtol), m, n, _KR, K,
            int(bool(away)), stream)
    if err:
        raise RuntimeError("dopt_lazy batch kernel launch failed: "
                           + lib.dopt_lazy_error_string(err).decode())
    return LazyBlock(xo, wo, C, beta, misc, hist), waves.value


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
    VT = V.T.contiguous() if dev.type == "cuda" else None

    def fresh_state(x):
        H0, w, ld = factorize(V, x)
        return dict(x=x, w=w, H0=H0, ld=float(ld))

    def launch(state, kmax):
        blk = lazy_block(V, state["H0"], state["x"], state["w"], eps=eps,
                         kmax=kmax, away=away, VT=VT)
        misc = blk.misc.cpu().numpy()  # the block's one host round trip
        hist = blk.hist.cpu().numpy()
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
    VTs = Vs.transpose(1, 2).contiguous() if dev.type == "cuda" else None
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
            blk = lazy_block_batch(Vs, H0, x, w, eps=eps, kmax=kmax,
                                   away=away, VTs=VTs)
            misc = blk.misc.cpu().numpy()  # the block's one host round trip
            hist = blk.hist.cpu().numpy()
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
