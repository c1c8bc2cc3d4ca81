"""Host helpers shared by the D-opt block engines (lazy-H and dense).

Ports of ``accbpg_and_fw_tpu/ops/pallas_dopt.py``: the fresh FP64
factorization ``_factorize_np`` (here on the tensor's own device), the
launch-block checkpoint ``.npz`` of ``_pallas_ckpt_save``/``_load`` (same
keys, version and fingerprint check, so either package resumes a file the
other wrote), and the single-instance host block loop that
``dopt_fw_pallas`` and ``dopt_fw_pallas_lazy`` each wrote out
(``run_blocks``).  Also the plain blocks' pivots and step scalars, the F
rebuild from the recorded (tau, tau (w_v - 1)) pairs, and the operand
checks of the block wrappers.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

_CKPT_VERSION = 1

XTOL = 1.0e-8  # support threshold of the away pivot (the reference's 1e-8)

# verbose table row: k, F, pos_slack, neg_slack, time
ROW = "{0:6d}  {1:10.3e}  {2:10.3e}  {3:10.3e}  {4:6.1f}"


def factorize(V, x):
    """Fresh ``(H, w, logdet)`` for ``V diag(x) V^T`` in FP64 via Cholesky:
    ``logdet = 2 sum log diag(R)``, ``H = R^-T R^-1`` and ``w`` the squared
    column norms of ``R^-1 V``.  ``logdet`` is a 0-d tensor."""
    m = V.shape[0]
    R = torch.linalg.cholesky((V * x) @ V.T)  # lower
    logdet = 2.0 * torch.log(torch.diagonal(R)).sum()
    Rinv = torch.linalg.solve_triangular(
        R, torch.eye(m, dtype=V.dtype, device=V.device), upper=False)
    H = Rinv.T @ Rinv
    W = Rinv @ V
    w = (W * W).sum(dim=0)
    return H, w, logdet


def check_operands(device, operands):
    """Raise unless every ``(name, tensor, shape)`` is a contiguous float64
    tensor of that shape on ``device`` (what the kernels take)."""
    for name, t, shape in operands:
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def pivots(w, x, away, xtol):
    """The FW(-away) pivots of the plain block versions, on the host:
    ``(i, wi, j, wj)``.  ``i`` is the first argmax of ``w``; for away steps
    ``j`` is the first argmin of ``w`` over ``x > xtol``, for plain FW
    ``j = i`` and ``wj`` the minimum of ``w`` over ``x > 0``."""
    i = int(torch.argmax(w))
    wi = float(w[i])
    if away:
        j = int(torch.argmin(torch.where(x > xtol, w, torch.inf)))
        wj = float(w[j])
    else:
        j = i
        wj = float(torch.where(x > 0, w, torch.inf).min())
    return i, wi, j, wj


def step_scalars(away, m_f, i, wi, j, wj, xj):
    """Slacks and step of one FW(-away) iteration, in host float64:
    ``(sp, sn, v, wv, tau, drop)``.  Toward: ``tau = sp/(wi - 1) > 0`` at
    ``v = i``; away (when ``sn > sp``): ``tau = -min(a1, a2)`` at ``v = j``
    with ``a1 = sn/(wj - 1)`` and ``a2 = xj/(1 - xj)``, and ``drop`` when
    ``a2`` wins (``x_j`` becomes exactly 0)."""
    sp = (wi - m_f) / m_f
    sn = (m_f - wj) / m_f
    v, wv, tau, drop = i, wi, sp / (wi - 1.0), False
    if away and not sp >= sn:
        a1 = sn / (wj - 1.0)
        a2 = xj / (1.0 - xj)
        v, wv = j, wj
        tau = -(a1 if a1 < a2 else a2)
        drop = not a1 < a2
    return sp, sn, v, wv, tau, drop


def f_rows(ld, tau, twv, m):
    """F rows (the objective before each row's update) from the recorded
    (tau, tau (w_v - 1)) pairs, and the logdet after the last row; ``ld``
    and the returned logdet broadcast over leading instance axes."""
    incs = (m - 1.0) * np.log1p(-tau) + np.log1p(twv)
    csum = np.cumsum(incs, axis=-1)
    ld = np.asarray(ld, np.float64)
    rows = ld[..., None] + np.concatenate(
        [np.zeros(csum.shape[:-1] + (1,)), csum[..., :-1]], axis=-1)
    nv = incs.shape[-1]
    return -rows[..., :nv], ld + (csum[..., -1] if nv else 0.0)


def ckpt_save(path, fp, x64, k_done, parts, t_spent):
    """Atomically write the block-boundary snapshot: the iterate, the
    history parts and the progress marker."""
    F_parts, SP_parts, SN_parts, T_parts = parts
    payload = dict(
        __v=np.asarray(_CKPT_VERSION), __fp=np.asarray(fp),
        __k=np.asarray(k_done), __t=np.asarray(t_spent),
        x=np.asarray(x64, np.float64),
        F=(np.concatenate(F_parts) if F_parts else np.zeros(0)),
        SP=(np.concatenate(SP_parts) if SP_parts else np.zeros(0)),
        SN=(np.concatenate(SN_parts) if SN_parts else np.zeros(0)),
        T=(np.concatenate(T_parts) if T_parts else np.zeros(0)),
    )
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def ckpt_load(path, fp):
    """``(x, k_done, t_spent, F_parts, SP_parts, SN_parts, T_parts)`` from a
    snapshot, or None when ``path`` does not exist."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if int(z["__v"]) != _CKPT_VERSION:
            raise ValueError(f"block-engine checkpoint {path!r}: "
                             "incompatible version; delete it to start fresh")
        if str(z["__fp"]) != fp:
            raise ValueError(
                f"block-engine checkpoint {path!r} was saved by a different "
                f"solve ({z['__fp']}); refusing to resume as {fp}")
        return (z["x"].copy(), int(z["__k"]), float(z["__t"]),
                [z["F"].copy()], [z["SP"].copy()], [z["SN"].copy()],
                [z["T"].copy()])


def run_blocks(launch, fresh_state, x0, m, eps, maxitrs, *, block_len,
               verbose, verbskip, refresh_every, checkpoint, fingerprint,
               title):
    """The single-instance host loop around a launch block, as both JAX
    block engines run it, for an (m, n) design.  Returns
    ``(x, F, SP, SN, T)``.

    ``fresh_state(x)`` is the state of a fresh FP64 factorization at
    ``x``, a dict holding at least ``x`` and ``ld`` (its logdet, a float).
    ``launch(state, kmax)`` runs one block of up to ``kmax`` iterations
    and returns ``(state, done, hist)``: ``hist`` (numpy, 5 x rows) holds
    ``tau``, ``tau (w_v - 1)``, ``SP``, ``SN`` and the pivot for the rows
    up to and including the stop row, so F is rebuilt from it here and
    the run is truncated at its first row with SP <= eps and SN <= eps.

    ``refresh_every``: a fresh factorization from the iterate at the first
    block boundary at or past every R iterations.  ``checkpoint``: an
    ``.npz`` snapshot at every block boundary, saved under
    ``fingerprint`` (the JAX engine's), from which a resume refactorizes.
    """
    n = len(x0)
    if verbose:
        print(f"\nSolving D-opt design problem using {title}")
        print("     k      F(x)     pos_slack   neg_slack    time")
    F_parts, SP_parts, SN_parts, T_parts = [], [], [], []
    k_done = 0
    t_prev = 0.0
    x = x0
    if checkpoint is not None:
        loaded = ckpt_load(checkpoint, fingerprint)
        if loaded is not None:
            (x_np, k_done, t_prev, F_parts, SP_parts, SN_parts,
             T_parts) = loaded
            if x_np.shape != (n,):
                raise ValueError(
                    f"block-engine checkpoint {checkpoint!r}: iterate "
                    f"length {x_np.shape} does not match n={n}")
            x = torch.as_tensor(x_np, dtype=x0.dtype).to(x0.device)
            if (SP_parts[0].size and SP_parts[0][-1] <= eps
                    and SN_parts[0][-1] <= eps):
                k_done = maxitrs  # the saved run already stopped
    state = fresh_state(x)
    since_refresh = 0
    t0 = time.time() - t_prev

    while k_done < maxitrs:
        state, done, hist = launch(state, min(block_len, maxitrs - k_done))
        nv = hist.shape[1]
        t_b = time.time() - t0
        t_a = T_parts[-1][-1] if T_parts and len(T_parts[-1]) else 0.0
        F_rows, ld = f_rows(state["ld"], hist[0], hist[1], m)
        state["ld"] = float(ld)
        F_parts.append(F_rows)
        SP_parts.append(hist[2])
        SN_parts.append(hist[3])
        T_parts.append(t_a + (t_b - t_a) * (np.arange(nv) + 1) / max(nv, 1))
        if verbose:
            for r in range(nv):
                if (k_done + r) % verbskip == 0:
                    print(ROW.format(k_done + r, F_rows[r], hist[2, r],
                                     hist[3, r], T_parts[-1][r]))
        k_done += nv
        since_refresh += nv
        if checkpoint is not None:
            ckpt_save(checkpoint, fingerprint, state["x"].cpu().numpy(),
                      k_done, (F_parts, SP_parts, SN_parts, T_parts),
                      time.time() - t0)
        if done or nv == 0:
            break
        if refresh_every and since_refresh >= refresh_every:
            # resets ld to the exact logdet of the refreshed iterate
            state = fresh_state(state["x"])
            since_refresh = 0

    def cat(parts):
        return np.concatenate(parts) if parts else np.zeros(0)

    return (state["x"], cat(F_parts), cat(SP_parts), cat(SN_parts),
            cat(T_parts))
