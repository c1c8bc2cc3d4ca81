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
the plain PyTorch version of the same iteration.
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple

import numpy as np
import torch

from .._device import as_f64, resolve_device
from .dopt_common import ROW, XTOL, ckpt_load, ckpt_save, factorize

_KR = 256         # iterations per launch block == rank-buffer capacity
_MAX_M = 16384    # the kernel keeps one length-m vector in shared memory

# Kernel launches made by ``lazy_block`` on a CUDA tensor (never by the
# plain version), so a run can show that it went through the kernel.
LAUNCHES = 0


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
        # pivots: first argmax of w; first argmin of w over the support
        i = int(torch.argmax(w))
        wi = float(w[i])
        if away:
            j = int(torch.argmin(torch.where(x > xtol, w, torch.inf)))
            wj = float(w[j])
        else:
            j = i
            wj = float(torch.where(x > 0, w, torch.inf).min())
        sp = (wi - m_f) / m_f
        sn = (m_f - wj) / m_f
        hist[2, k] = sp
        hist[3, k] = sn
        if sp <= eps and sn <= eps:
            hist[4, k] = -1.0
            done = True
            k += 1
            break

        v, wv, tau, drop = i, wi, sp / (wi - 1.0), False
        if away and not sp >= sn:
            xj = float(x[j])
            a1 = sn / (wj - 1.0)
            a2 = xj / (1.0 - xj)
            v, wv = j, wj
            tau = -(a1 if a1 < a2 else a2)
            drop = not a1 < a2
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
    for name, t, shape in (("V", V, (m, n)), ("H0", H0, (m, m)),
                           ("x", x, (n,)), ("w", w, (n,))):
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if t.device != V.device:
            raise ValueError(f"{name} is on {t.device}, V on {V.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
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


def _lazy_refresh(H0, C, beta, alpha):
    """Fold the block's rank buffer back: H0' = alpha H0 + C^T diag(beta) C
    (an FP64 matmul outside the kernel, as the JAX package leaves it to
    XLA)."""
    return alpha * H0 + (C.T * beta) @ C


def dopt_fw_lazy(V, x0, eps, maxitrs, away=True, verbose=True, verbskip=1,
                 chunk=None, refresh_every=0, checkpoint=None, device=None):
    """D-opt FW(-away) through lazy-H launch blocks.  Same contract as
    ``D_opt_FW_away``: returns ``(x, F, SP, SN, T)`` truncated at the
    stopping iteration (``chunk`` is accepted and unused: a block is
    ``_KR`` iterations).

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

    if verbose:
        name = ("Frank-Wolfe method with away steps" if away
                else "Frank-Wolfe method")
        print(f"\nSolving D-opt design problem using {name} "
              "(lazy-H block kernel)")
        print("     k      F(x)     pos_slack   neg_slack    time")

    F_parts, SP_parts, SN_parts, T_parts = [], [], [], []
    k_done = 0
    t_prev = 0.0
    ckpt_fp = (f"dopt_fw_pallas_lazy|m={m}|n={n}|away={bool(away)}"
               f"|eps={float(eps)!r}")
    x = as_f64(x0, dev)
    if checkpoint is not None:
        loaded = ckpt_load(checkpoint, ckpt_fp)
        if loaded is not None:
            (x_np, k_done, t_prev, F_parts, SP_parts, SN_parts,
             T_parts) = loaded
            if x_np.shape != (n,):
                raise ValueError(
                    f"lazy-engine checkpoint {checkpoint!r}: iterate length "
                    f"{x_np.shape} does not match n={n}")
            x = as_f64(x_np, dev)
            if (SP_parts[0].size and SP_parts[0][-1] <= eps
                    and SN_parts[0][-1] <= eps):
                k_done = maxitrs
    state = fresh_state(x)
    since_refresh = 0
    stopped = False
    t0 = time.time() - t_prev

    while k_done < maxitrs and not stopped:
        blk = lazy_block(V, state["H0"], state["x"], state["w"], eps=eps,
                         kmax=min(_KR, maxitrs - k_done), away=away, VT=VT)
        misc = blk.misc.cpu().numpy()  # the block's one host round trip
        hist = blk.hist.cpu().numpy()
        done, iters, nrun = misc[0] > 0.5, int(misc[1]), int(misc[3])
        state["x"], state["w"] = blk.x, blk.w
        if nrun:
            state["H0"] = _lazy_refresh(state["H0"], blk.C[:nrun],
                                        blk.beta[:nrun], blk.misc[2])
        t_b = time.time() - t0
        t_a = T_parts[-1][-1] if T_parts and len(T_parts[-1]) else 0.0

        nv = iters
        if done:
            hit = np.flatnonzero((hist[2, :iters] <= eps)
                                 & (hist[3, :iters] <= eps))
            if hit.size:
                nv = int(hit[0]) + 1
            stopped = True
        if nv == 0:
            break
        incs = ((m - 1.0) * np.log1p(-hist[0, :nv])
                + np.log1p(hist[1, :nv]))
        ld_rows = state["ld"] + np.concatenate([[0.0], np.cumsum(incs)[:-1]])
        state["ld"] += float(np.sum(incs))
        F_parts.append(-ld_rows)
        SP_parts.append(hist[2, :nv])
        SN_parts.append(hist[3, :nv])
        T_parts.append(t_a + (t_b - t_a) * (np.arange(nv) + 1) / nv)
        if verbose:
            for r in range(nv):
                if (k_done + r) % verbskip == 0:
                    print(ROW.format(k_done + r, F_parts[-1][r],
                                      SP_parts[-1][r], SN_parts[-1][r],
                                      T_parts[-1][r]))
        k_done += nv
        since_refresh += nv
        if checkpoint is not None:
            ckpt_save(checkpoint, ckpt_fp, state["x"].cpu().numpy(), k_done,
                      (F_parts, SP_parts, SN_parts, T_parts),
                      time.time() - t0)
        if not stopped and refresh_every and since_refresh >= refresh_every:
            # resets ld to the exact logdet of the refreshed iterate
            state = fresh_state(state["x"])
            since_refresh = 0

    F = np.concatenate(F_parts) if F_parts else np.zeros(0)
    SP = np.concatenate(SP_parts) if SP_parts else np.zeros(0)
    SN = np.concatenate(SN_parts) if SN_parts else np.zeros(0)
    T = np.concatenate(T_parts) if T_parts else np.zeros(0)
    ncut = min(len(F), len(SP), len(SN))
    Tfull = np.zeros(ncut)
    Tfull[:min(ncut, len(T))] = T[:ncut]
    return state["x"], F[:ncut], SP[:ncut], SN[:ncut], Tfull
