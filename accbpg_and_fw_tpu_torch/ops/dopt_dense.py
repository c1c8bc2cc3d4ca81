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
(``csrc/dopt_dense.cu``, one CTA per instance), on a CPU tensor it runs
``dense_block_reference``, the plain PyTorch version of the same
iteration.  ``dopt_fw_dense`` (B = 1) ports ``dopt_fw_pallas`` and
``dopt_fw_dense_batch`` ports ``dopt_fw_pallas_batch``.
"""

from __future__ import annotations

import ctypes
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
_MAX_M = 4096     # the kernel keeps two length-m vectors in shared memory

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
    which the kernel reads pivot columns from; pass it to avoid a copy per
    call."""
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


def _kernel_lib():
    from . import _build

    lib = _build.load("dopt_dense")
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.dopt_dense_run.argtypes = [p] * 11 + [d, d] + [i] * 5 + [p]
    lib.dopt_dense_run.restype = i
    lib.dopt_dense_error_string.argtypes = [i]
    lib.dopt_dense_error_string.restype = ctypes.c_char_p
    return lib


def _launch_cuda(Vs, Hs, xs, ws, eps, kmax, done, away, xtol, VTs):
    B, m, n = Vs.shape
    if m > _MAX_M:
        raise ValueError(f"the dense kernel takes m <= {_MAX_M}, got {m}")
    if VTs is None:
        VTs = Vs.transpose(1, 2).contiguous()
    elif (VTs.dtype != torch.float64 or VTs.device != Vs.device
          or tuple(VTs.shape) != (B, n, m) or not VTs.is_contiguous()):
        raise ValueError("VTs must be Vs.transpose(1, 2).contiguous() "
                         "(float64, same device)")
    lib = _kernel_lib()
    dev = Vs.device
    f64 = dict(dtype=torch.float64, device=dev)
    xo = torch.empty((B, n), **f64)
    wo = torch.empty((B, n), **f64)
    Ho = torch.empty((B, m, m), **f64)
    misc = torch.empty((B, 3), **f64)
    hist = torch.empty((B, 5, max(kmax, 1)), **f64)
    flags = torch.tensor([0] * B if done is None else [int(bool(d))
                                                       for d in done],
                         dtype=torch.int32).to(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dopt_dense_run(
            Vs.data_ptr(), VTs.data_ptr(), Hs.data_ptr(), xs.data_ptr(),
            ws.data_ptr(), flags.data_ptr(), xo.data_ptr(), wo.data_ptr(),
            Ho.data_ptr(), misc.data_ptr(), hist.data_ptr(), float(eps),
            float(xtol), B, m, n, int(kmax), int(bool(away)), stream)
    if err:
        raise RuntimeError("dopt_dense kernel launch failed: "
                           + lib.dopt_dense_error_string(err).decode())
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
