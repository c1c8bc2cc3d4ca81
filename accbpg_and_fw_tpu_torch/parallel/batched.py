"""Batched multi-instance D-opt solving (counterpart of
``accbpg_and_fw_tpu/parallel/batched.py``).

The reference's iteration-complexity studies solve K independent
instances of one (m, n) shape, one after another.  ``dopt_fw_batch``
solves them together and returns histories with a leading K axis, through
one of three engines:

* the FP64 exact engine below, a batched form of the exact engine's step
  (``"native"``, and the aliases ``"mixed"`` and ``"ds"``, which existed
  in the JAX package only because the TPU has no fast f64);
* ``"pallas"``: the dense block kernel (``ops/dopt_dense.py``);
* ``"pallas_lazy"``: the lazy-H block kernel (``ops/dopt_lazy.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import as_f64, resolve_device
from ..ops.dopt_common import XTOL, factorize
from ..ops.dopt_dense import dopt_fw_dense_batch
from ..ops.dopt_lazy import dopt_fw_lazy_batch

# "auto" takes the lazy-H batch kernel on a CUDA device from this m up.
# The threshold is the TPU's (the JAX package's on-chip A/B, BASELINE.md
# round 5); the crossover on the H100 is not measured yet.
_LAZY_MIN_M = 64

# the engine's all-done check runs at most this many iterations apart
# (the JAX double-single engine's exit_every)
_EXIT_EVERY = 2048


def _gather(a, idx):
    """``a[k, idx[k]]`` for every instance k."""
    return a.gather(1, idx[:, None]).squeeze(1)


def _batch_step(away, Vs, eps, c):
    """One FW(-away) iteration for every instance of the carry
    ``{x (K, n), w (K, n), H (K, m, m), logdet (K,)}``: the exact engine's
    ``_dopt_step`` (``algorithms/d_opt.py``) with the instance axis
    written out, the same expressions in the same order.  Returns the new
    state, the rows ``(F, SP, SN)`` and the stop flags."""
    x, w, H, logdet = c["x"], c["w"], c["H"], c["logdet"]
    m_f = float(Vs.shape[1])
    i = torch.argmax(w, dim=1)
    wi = _gather(w, i)
    eps_pos = wi / m_f - 1.0

    t_tow = (wi / m_f - 1.0) / (wi - 1.0)
    c_tow = t_tow / (1.0 - t_tow + t_tow * wi)
    inc_tow = ((m_f - 1.0) * torch.log1p(-t_tow)
               + torch.log1p(t_tow * (wi - 1.0)))
    if away:
        ww = w - wi[:, None]  # shift so max is 0; masked entries sit at 0
        j = torch.argmin(ww * (x > XTOL), dim=1)
        wj = _gather(w, j)
        eps_neg = 1.0 - wj / m_f
        xj = _gather(x, j)
        t_aw = torch.minimum((1.0 - wj / m_f) / (wj - 1.0), xj / (1.0 - xj))
        c_aw = t_aw / (1.0 + t_aw - t_aw * wj)
        inc_aw = ((m_f - 1.0) * torch.log1p(t_aw)
                  + torch.log1p(t_aw - t_aw * wj))
        toward = eps_pos >= eps_neg
        v = torch.where(toward, i, j)
        wv = torch.where(toward, wi, wj)
        sc = torch.where(toward, -c_tow, c_aw)
        st = torch.where(toward, -t_tow, t_aw)
        inc = torch.where(toward, inc_tow, inc_aw)
    else:
        wmin = torch.where(x > 0, w, torch.inf).min(dim=1).values
        eps_neg = 1.0 - wmin / m_f
        v, wv, sc, st, inc = i, wi, -c_tow, -t_tow, inc_tow

    stop = (eps_pos <= eps) & (eps_neg <= eps)

    K, m, _ = Vs.shape
    vcol = Vs.gather(2, v.view(K, 1, 1).expand(K, m, 1)).squeeze(2)
    g = torch.bmm(H, vcol[:, :, None]).squeeze(2)
    H_new = ((H + sc[:, None, None] * (g[:, :, None] * g[:, None, :]))
             / (1.0 + st)[:, None, None])
    u = torch.bmm(g[:, None, :], Vs).squeeze(1)
    # u[v] = w[v]: the exact line search lands the new w[v] on m only when
    # the recomputed v^T H v agrees with the tracked w[v]
    u = u.scatter(1, v[:, None], wv[:, None])
    w_new = (w + sc[:, None] * u * u) / (1.0 + st)[:, None]
    x_new = (x * (1.0 + st)[:, None]).scatter_add(1, v[:, None],
                                                  (-st)[:, None])
    new = dict(x=x_new, w=w_new, H=H_new, logdet=logdet + inc)
    return new, (-logdet, eps_pos, eps_neg), stop


def _factorize_all(Vs, xs):
    parts = [factorize(Vs[k], xs[k]) for k in range(Vs.shape[0])]
    return dict(x=xs, H=torch.stack([p[0] for p in parts]),
                w=torch.stack([p[1] for p in parts]),
                logdet=torch.stack([p[2] for p in parts]))


def dopt_fw_batch_exact(Vs, x0s, eps, num_iters, away=True, refresh_every=0,
                        device=None):
    """The batched FP64 exact engine: ``num_iters`` FW(-away) iterations
    for every instance, each frozen from the iteration its stop test fires
    (the reference's ``break``, which applies no update).  Returns
    ``(x, F, SP, SN)``, histories of length ``num_iters``: a frozen
    instance's rows repeat its state's values.

    ``refresh_every``: refactorize every instance's (H, w, logdet) from its
    iterate at every multiple of R iterations (when R < ``num_iters``), a
    frozen instance included, as both JAX engines do."""
    dev = resolve_device(device, like=Vs)
    Vs = as_f64(Vs, dev).contiguous()
    K, m, n = Vs.shape
    x0s = as_f64(x0s, dev)
    if num_iters <= 0:
        z = np.zeros((K, 0))
        return x0s.clone(), z, z.copy(), z.copy()
    R = int(refresh_every) if (refresh_every
                               and refresh_every < num_iters) else num_iters
    c = _factorize_all(Vs, x0s.clone())
    done = torch.zeros(K, dtype=torch.bool, device=dev)
    rows = []
    k = 0
    while k < num_iters:
        if k and k % R == 0:
            c = _factorize_all(Vs, c["x"])
        end = min(num_iters, (k // R + 1) * R, k + _EXIT_EVERY)
        if bool(done.all()):
            # every instance is frozen: its rows repeat until the next
            # refresh boundary
            _, row, _ = _batch_step(away, Vs, eps, c)
            rows.append(torch.stack(row).unsqueeze(1).expand(3, end - k, K))
            k = end
            continue
        seg = []
        for _ in range(k, end):
            new, row, stop = _batch_step(away, Vs, eps, c)
            seg.append(torch.stack(row))
            frozen = done | stop
            c = {key: torch.where(frozen.view((K,) + (1,) * (val.dim() - 1)),
                                  c[key], val) for key, val in new.items()}
            done = frozen
        rows.append(torch.stack(seg, dim=1))
        k = end
    hist = torch.cat(rows, dim=1).transpose(1, 2).cpu().numpy()  # (3, K, T)
    return c["x"], hist[0], hist[1], hist[2]


def _resolve_auto_batch_precision(Vs, device):
    """The engine for ``precision="auto"``: the lazy-H batch kernel for
    instances with m >= 64 on a CUDA device, the exact engine otherwise.
    (The JAX rule also bounded the TPU's VMEM, which has no counterpart
    here.)"""
    shape = getattr(Vs, "shape", None)
    if (device.type == "cuda" and shape is not None and len(shape) == 3
            and shape[1] >= _LAZY_MIN_M):
        return "pallas_lazy"
    return "native"


def dopt_fw_batch(Vs, x0s, eps, num_iters, away=True, refresh_every=0,
                  precision="native", device=None):
    """Solve a batch of D-optimal design instances together.

    ``Vs``: (K, m, n) stacked designs; ``x0s``: (K, n) starts.  Returns
    ``(x, F, SP, SN)`` with a leading K axis: ``x`` a float64 tensor on
    the device, the histories numpy arrays.  An instance that stops early
    freezes, and its later rows repeat its stop row.

    ``precision``: ``"native"`` (and its aliases ``"mixed"`` and ``"ds"``)
    runs the batched FP64 exact engine for ``num_iters`` rows;
    ``"pallas"`` the dense block kernel (rows to the lockstep stop);
    ``"pallas_lazy"`` the lazy-H block kernel (rows to the last
    instance's stop); ``"auto"`` the lazy-H kernel for m >= 64 on a CUDA
    device and the exact engine otherwise.  ``refresh_every`` keeps each
    engine's JAX meaning: a full refactorization every R rows for the
    exact and dense engines, the w-only refresh for the lazy one.
    ``device``: None keeps a tensor ``Vs``'s device and puts numpy input
    on the CPU.
    """
    dev = resolve_device(device, like=Vs)
    if precision == "auto":
        precision = _resolve_auto_batch_precision(Vs, dev)
    if precision == "pallas":
        return dopt_fw_dense_batch(Vs, x0s, eps, num_iters, away=away,
                                   refresh_every=refresh_every, device=dev)
    if precision == "pallas_lazy":
        return dopt_fw_lazy_batch(Vs, x0s, eps, num_iters, away=away,
                                  refresh_every=refresh_every, device=dev)
    if precision not in ("native", "mixed", "ds"):
        raise ValueError(f"unknown precision {precision!r}; expected "
                         "'native', 'mixed', 'ds', 'pallas' or "
                         "'pallas_lazy'")
    return dopt_fw_batch_exact(Vs, x0s, eps, num_iters, away=away,
                               refresh_every=refresh_every, device=dev)
