"""Host helpers shared by the D-opt engines.

Ports of ``accbpg_and_fw_tpu/ops/pallas_dopt.py``: the fresh FP64
factorization ``_factorize_np`` (here on the tensor's own device) and the
launch-block checkpoint ``.npz`` of ``_pallas_ckpt_save``/``_load`` (same
keys, version and fingerprint check, so either package resumes a file the
other wrote).
"""

from __future__ import annotations

import os

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
            raise ValueError(f"lazy-engine checkpoint {path!r}: incompatible "
                             "version; delete it to start fresh")
        if str(z["__fp"]) != fp:
            raise ValueError(
                f"lazy-engine checkpoint {path!r} was saved by a different "
                f"solve ({z['__fp']}); refusing to resume as {fp}")
        return (z["x"].copy(), int(z["__k"]), float(z["__t"]),
                [z["F"].copy()], [z["SP"].copy()], [z["SN"].copy()],
                [z["T"].copy()])
