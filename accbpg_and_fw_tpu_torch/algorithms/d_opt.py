"""D-optimal design Frank-Wolfe solvers with O(mn) rank-1 iterations.

Port of ``accbpg_and_fw_tpu/algorithms/d_opt.py``: the Khachiyan
Frank-Wolfe method (``D_opt_FW``) and the Wolfe-Atwood away-step variant
(``D_opt_FW_away``) for

    minimize  -log det(V diag(x) V^T)   s.t.  x in unit simplex.

The exact engine keeps the JAX engine's deviations from the upstream
reference: log-space determinant (log1p increments), the ``u[i] = w[i]``
consistency pin, the away-branch logdet through ``w[j]``, the stop test
before the update, and optional ``refresh_every`` refactorization at chunk
boundaries.  On a CUDA device ``u_mode="auto"`` routes to the lazy-H
block kernel (``ops/dopt_lazy.py``) or the dense block kernel
(``ops/dopt_dense.py``) by the design's shape (``_kernel_engine``);
``u_mode="pallas"`` takes the dense block kernel on any device.

The JAX ``u_mode`` names stay accepted: ``"ds"`` and ``"mixed"`` existed
because the TPU has no fast f64, and resolve here to the FP64 exact engine.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import as_f64, is_dtensor, replicate_like, resolve_device
from ..diagnostics import span
from ..ops.dopt_common import ROW, XTOL
from ..ops.dopt_common import factorize as _dopt_factorize
from ..ops.dopt_dense import dense_layout, dopt_fw_dense
from ..ops.dopt_lazy import device_limits, dopt_fw_lazy, lazy_fits
from .driver import run_driver

# "auto" takes the lazy-H block kernel at and above this design size on a
# CUDA device (the JAX package's threshold for its lazy kernel,
# accbpg_and_fw_tpu/algorithms/d_opt.py _OZAKI_U_MIN_SIZE).  Below it,
# ``_kernel_engine`` decides.
_LAZY_MIN_SIZE = 1_800_000


class _DOptCfg(NamedTuple):
    """The exact engine's config, JAX's ``_DOptCfg`` (same name, fields and
    repr, so the checkpoint fingerprint is JAX's and a checkpoint written
    by either package resumes in the other); ``mixed`` is always False
    here: the int8 contraction was the TPU's."""
    away: bool
    mixed: bool = False


def _at(a, idx):
    """``a[idx]`` for a 0-d index tensor, without a host round trip."""
    return a.index_select(0, idx.view(1)).squeeze(0)


def _pivot(a, largest):
    """``torch.argmax(a)`` (``largest``) or ``torch.argmin(a)`` of a
    vector: the first index of the extreme value.

    A sharded vector (a DTensor) pivots on each rank's shard and gathers
    the ``(value, index)`` pairs with one c10d all-gather, keeping the
    first extreme entry.  DTensor's own arg-reduction gathers through
    functional collectives, which corrupted the heap on a gloo group
    (torch 2.13, CPU).  Nothing reads the host or copies from it, so a
    graph chunk captures the gather with the step (NCCL)."""
    arg = torch.argmax if largest else torch.argmin
    if not is_dtensor(a):
        return arg(a)
    from torch.distributed.tensor import Shard

    local = a.to_local()
    if not any(isinstance(p, Shard) for p in a.placements):
        return arg(local)
    import torch.distributed as dist

    mesh = a.device_mesh
    world = mesh.size()
    rank = mesh.get_local_rank()
    step = -(-a.shape[0] // world)  # torch.chunk's shard length
    if local.numel():
        j = arg(local)
        # ``local[j]`` of a 0-d index tensor reads it back to the host
        pair = torch.stack([_at(local, j),
                            (j + rank * step).to(local.dtype)])
    else:  # an empty trailing shard never wins
        # fills on the device: a copy from the host cannot be captured
        worst = -torch.inf if largest else torch.inf
        pair = torch.full((2,), worst, dtype=local.dtype,
                          device=local.device)
        pair[1:].fill_(a.shape[0])
    pairs = torch.empty(world * 2, dtype=local.dtype, device=local.device)
    dist.all_gather_into_tensor(pairs, pair, group=mesh.get_group())
    pairs = pairs.view(world, 2)
    # the first rank holding the extreme value holds its first index
    best = arg(pairs[:, 0])
    return _at(pairs[:, 1], best).to(torch.int64)


def _dopt_step(cfg, prob, c, k):
    """One FW(-away) iteration on the carry ``{done, x, w, H, logdet}`` of
    the design ``prob["V"]`` with the stop threshold ``prob["eps"]`` (JAX's
    cached step form).

    Both branches of the JAX ``lax.cond`` are written in one signed form:
    toward ``(H - c gg^T)/(1 - t)`` and away ``(H + c gg^T)/(1 + t)`` are
    ``(H + sc gg^T)/(1 + st)`` with ``(sc, st) = (-c, -t)`` or ``(c, t)``,
    which rounds identically (negation is exact).  The scalar step sizes
    and logdet increments keep each branch's own expression."""
    V, eps, away = prob["V"], prob["eps"], cfg.away
    x, w, H, logdet = c["x"], c["w"], c["H"], c["logdet"]
    m_f = float(V.shape[0])
    i = _pivot(w, True)
    wi = _at(w, i)
    eps_pos = wi / m_f - 1.0

    t_tow = (wi / m_f - 1.0) / (wi - 1.0)
    c_tow = t_tow / (1.0 - t_tow + t_tow * wi)
    inc_tow = ((m_f - 1.0) * torch.log1p(-t_tow)
               + torch.log1p(t_tow * (wi - 1.0)))
    if away:
        ww = w - wi  # shift so max is 0; masked entries dominate at 0
        j = _pivot(ww * (x > XTOL), False)
        wj = _at(w, j)
        eps_neg = 1.0 - wj / m_f
        xj = _at(x, j)
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
        wmin = torch.where(x > 0, w, torch.inf).min()
        eps_neg = 1.0 - wmin / m_f
        v, wv, sc, st, inc = i, wi, -c_tow, -t_tow, inc_tow

    stop = (eps_pos <= eps) & (eps_neg <= eps)

    g = H @ V.index_select(1, v.view(1)).squeeze(1)
    H_new = (H + sc * torch.outer(g, g)) / (1.0 + st)
    u = g @ V
    # u[v] = w[v]: the exact line search lands the new w[v] on m only when
    # the recomputed v^T H v agrees with the tracked w[v]
    u = u.index_copy(0, v.view(1), wv.view(1))
    w_new = (w + sc * u * u) / (1.0 + st)
    x_new = (x * (1.0 + st)).index_add(0, v.view(1), (-st).view(1))
    logdet_new = logdet + inc

    # the reference breaks BEFORE applying the update (D_opt_alg.py:72-73)
    new = dict(x=x_new, w=w_new, H=H_new, logdet=logdet_new)
    c2 = {key: torch.where(stop, c[key], val) for key, val in new.items()}
    c2["done"] = c["done"]
    return c2, dict(F=-logdet, SP=eps_pos, SN=eps_neg, _stop=stop)


def _kernel_engine(m, n, K, limits):
    """The kernel for K instances of an (m, n) design on a card of
    ``limits = (sms, smem_limit)``: the dense kernel where its layout
    keeps V and H in shared memory, else the lazy kernel where it takes
    the design, else the dense kernel where it takes m, else None (the
    exact engine).  The order is the walls' on an "NVIDIA H100 80GB HBM3,
    700.00 W" (PERF.md, chip_smoke.py [auto], two runs): 30x1000 and
    100x1000 solve 1.4-3.3x faster on the dense kernel than on the lazy
    one, 200x1000, where the dense layout streams V, 4.2-4.5x slower; the
    FP64 exact engine took 148-573x the faster kernel's time."""
    layout = dense_layout(K, m, n, limits)
    if layout == "resident":
        return "pallas"
    if lazy_fits(m, n, K, limits):
        return "pallas_lazy"
    return "pallas" if layout else None


def _resolve_auto_u_mode(V, u_mode, device, limits=None):
    """The engine for ``u_mode``: ``"pallas_lazy"`` (the lazy-H block
    kernel), ``"pallas"`` (the dense block kernel; each runs its plain
    block on the CPU) or ``"exact"`` (this module's FP64 engine).

    ``"auto"`` on a CUDA device (``limits``: its ``(sms, smem_limit)``,
    the device's own when None) takes the lazy kernel for a design of at
    least ``_LAZY_MIN_SIZE`` elements that it takes (``lazy_fits``), and
    ``_kernel_engine``'s choice below that size; the exact engine where no
    kernel takes the design, as the JAX package falls back to its ``"ds"``
    engine past its kernel's memory budget.  Without a card to ask, only
    the lazy kernel's bound on m is applied, and only above the size.  On
    the CPU ``"auto"`` is the exact engine.

    A sharded design (a DTensor, ``parallel/mesh.py``) takes the exact
    engine under ``"auto"``: the kernels take one device's arrays, so the
    explicit kernel modes raise ``ValueError`` for it."""
    if is_dtensor(V):
        if u_mode in ("pallas", "pallas_lazy"):
            raise ValueError(
                f"u_mode={u_mode!r} runs a kernel on one device's arrays; a "
                "sharded design runs on the exact engine (u_mode='auto' or "
                "'exact')")
        if u_mode not in ("auto", "exact", "ds", "mixed"):
            raise ValueError(f"unknown u_mode={u_mode!r}")
        return "exact"
    if u_mode == "auto":
        if device.type == "cuda":
            m, n = V.shape
            limits = limits or device_limits(device)
            if V.numel() >= _LAZY_MIN_SIZE and lazy_fits(m, n, 1, limits):
                return "pallas_lazy"
            if limits is not None:
                return _kernel_engine(m, n, 1, limits) or "exact"
        return "exact"
    if u_mode in ("exact", "ds", "mixed"):
        return "exact"
    if u_mode in ("pallas", "pallas_lazy"):
        return u_mode
    raise ValueError(f"unknown u_mode={u_mode!r}")


def _run_exact(V, carry, eps, maxitrs, *, away, verbose, verbskip, chunk,
               refresh_every, header, checkpoint, k_start=0):
    """Drive the exact engine from ``carry`` (``{done, x, w, H, logdet}``
    tensors on V's device) for iterations ``k_start <= k < maxitrs``."""
    between = None
    if refresh_every:
        last_refresh = k_start

        def between(c, k_next):
            # refactorize at chunk boundaries (cancels rank-1 drift)
            nonlocal last_refresh
            if k_next - last_refresh >= refresh_every:
                last_refresh = k_next
                H, w, ld = _dopt_factorize(V, c["x"])
                return dict(c, H=H, w=w, logdet=ld)
            return c

    def row(k, r, t):
        print(ROW.format(k, r["F"], r["SP"], r["SN"], t))

    carry, hist, T = run_driver(_dopt_step, carry, maxitrs, verbose=verbose,
                                verbskip=verbskip, header=header,
                                print_row=row, chunk=chunk,
                                between_chunks=between, checkpoint=checkpoint,
                                problem=dict(V=V, eps=eps),
                                cfg=_DOptCfg(away=bool(away)),
                                k_start=k_start)
    return carry["x"], hist["F"], hist["SP"], hist["SN"], T


def _run_dopt(V, x0, eps, maxitrs, verbose, verbskip, chunk, away,
              refresh_every, header, checkpoint, u_mode, device):
    dev = resolve_device(device, like=V)
    V = as_f64(V, dev)
    engine = _resolve_auto_u_mode(V, u_mode, dev)
    if engine != "exact":
        block_engine = {"pallas_lazy": dopt_fw_lazy,
                        "pallas": dopt_fw_dense}[engine]
        with span("dopt.solve", engine=engine, m=V.shape[0], n=V.shape[1],
                  K=1):
            return block_engine(V, x0, eps, maxitrs, away=away,
                                verbose=verbose, verbskip=verbskip,
                                chunk=chunk, refresh_every=refresh_every,
                                checkpoint=checkpoint, device=dev)
    x0 = as_f64(x0, dev)
    H, w, logdet = _dopt_factorize(V, x0)
    carry = dict(done=replicate_like(torch.tensor(False, device=dev), V),
                 x=x0, w=w, H=H, logdet=logdet)
    out = _run_exact(V, carry, eps, maxitrs, away=away, verbose=verbose,
                     verbskip=verbskip, chunk=chunk,
                     refresh_every=refresh_every, header=header,
                     checkpoint=checkpoint)
    if is_dtensor(x0):
        # the single-entry updates replicate the iterate on the way; it
        # returns placed as it came
        out = (out[0].redistribute(x0.device_mesh, x0.placements),) + out[1:]
    return out


def D_opt_FW(V, x0, eps, maxitrs, verbose=True, verbskip=1, chunk=None,
             refresh_every=0, checkpoint=None, u_mode="auto", device=None):
    """Khachiyan Frank-Wolfe for D-optimal design on the simplex with rank-1
    Sherman-Morrison updates of H = (V diag(x) V^T)^{-1} and w = -gradient
    (reference: D_opt_alg.py:9-88).  Returns ``(x, F, SP, SN, T)``: ``x``
    a float64 tensor on ``device``, the histories numpy arrays.

    ``u_mode``: "auto" (on a CUDA device: the lazy-H block kernel for
    designs of at least 1.8M elements, where the kernel takes them: m <=
    16384 and a launch plan that fits in shared memory; below that size the
    dense block kernel where its layout keeps V in shared memory, as at
    30x1000 and 100x1000, else the lazy-H kernel; the exact engine where no
    kernel takes the design, and on the CPU), "exact",
    "pallas_lazy" (the lazy-H engine on any device; the plain block on the
    CPU), "pallas" (the dense block engine, likewise), and "ds"/"mixed" as
    aliases of "exact".
    ``device``: None keeps a tensor ``V``'s device and puts numpy input on
    CUDA; "cpu" asks for the CPU; CUDA without a card raises.
    """
    header = ("\nSolving D-opt design problem using Frank-Wolfe method\n"
              "     k      F(x)     pos_slack   neg_slack    time")
    return _run_dopt(V, x0, eps, maxitrs, verbose, verbskip, chunk,
                     away=False, refresh_every=refresh_every, header=header,
                     checkpoint=checkpoint, u_mode=u_mode, device=device)


def D_opt_FW_away(V, x0, eps, maxitrs, verbose=True, verbskip=1, chunk=None,
                  refresh_every=0, checkpoint=None, u_mode="auto",
                  device=None):
    """Wolfe-Atwood method: Frank-Wolfe with away steps for D-optimal design
    (linearly convergent; reference: D_opt_alg.py:91-185).
    Returns ``(x, F, SP, SN, T)``.  ``u_mode``, ``device``: see
    ``D_opt_FW``.
    """
    header = ("\nSolving D-opt design problem using Frank-Wolfe method with "
              "away steps\n"
              "     k      F(x)     pos_slack   neg_slack    time")
    return _run_dopt(V, x0, eps, maxitrs, verbose, verbskip, chunk,
                     away=True, refresh_every=refresh_every, header=header,
                     checkpoint=checkpoint, u_mode=u_mode, device=device)
