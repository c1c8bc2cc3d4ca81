"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --blocks-only [--root DIR] [--solves N]
                          [--gain-iters N]
    python3 chip_smoke.py --micro

With ``--micro`` it builds and runs ``csrc/micro_cluster.cu``: the clocks
of the primitives the cluster kernels are built from (an exchange across a
cluster by a store and the cluster barrier or by ``st.async`` and a
transaction barrier, an IEEE FP64 division, the Newton reciprocal).

With ``--blocks-only`` it prints only the lazy-H kernel's block times
(1000x5000, and K=3 of 1000x2000), the dense kernel's block times (B=1 and
B=32 of 30x1000, and two shapes whose layout streams V: B=1 of 165x1000 and
B=2 of 200x700), the multiplier's time per call (n = 1000, 10000, 100000:
by events, the kernel's device time in a trace, and the wrapper's host
cost), the warm walls of the dense sweep and of one ``u_mode="pallas"``
solve, of ``ABPG_gain`` 30x10000 over ``--gain-iters`` iterations (0: not
run) and of ``--solves`` warm main-path solves, for the package under
``--root`` (default: this file's directory), through the wrappers that
every commit of the port has.  That is how two commits are compared
on one card, in ONE call (two calls may land on cards with other power
limits):

    mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
    for r in build/parent . . build/parent; do
        python3 chip_smoke.py --blocks-only --root $r; done

Without arguments it runs these phases, one line each; any failure raises
and the script exits non-zero without the result line:

1. the card: CUDA must be available; torch version, card name and power
   limit;
2. the build of every kernel (one nvcc per source, started together, from
   the checkout);
3. each kernel against its plain PyTorch version on the card, at a small
   shape and at the shapes its path gives it, plus per-block times: the
   lazy-H kernel (12x160, 1000x5000), its instance-partitioned batch entry
   (K=3 of 100x1000 and of 1000x2000); for those two at the paths' shapes
   also the launch plan (resident and streamed columns per CTA, registers
   per thread), the time of a prepared block as the drivers launch it, the
   bound, two blocks from one state compared bit for bit and, for the
   1000x5000 kernel, the clocks of CTA 0 per phase, two cuBLAS DGEMV
   times as yardsticks of its phases, and a launch after a smaller design's
   kernel was prepared in between; the dense kernel (B=4 and B=32 of
   30x1000, and B=1: the launch plan, registers and spills, two launches
   from one state bit for bit, and thread 0 of CTA 0's clocks per phase),
   the Burg-simplex multiplier (the first
   prox input of the 30x10000 and 30x1000 paths, n=1 where its bisection
   moves, and random inputs at n = 1000, 10000, 100000: the launch plan,
   ms per call by events, the kernel's device time in a trace, the
   wrapper's host cost over 1000 unsynchronised calls and thread 0 of CTA
   0's clocks per stage of a pass);
4. the paths, each with its kernel's launch count set to 0 just before it
   and read just after:
   a. the dense sweep: ``dopt_fw_batch(precision="pallas")`` on K=32 of
      30x1000 (instance k from ``np.random.seed(k + 1)``), uniform starts,
      FW-away, eps=1e-8, a 20000 budget; every instance must stop and
      certify by fresh float64 slacks of its final iterate; one more sweep
      is traced (the dense kernel's time in its path);
   b. the large-m sweep: ``dopt_fw_batch(precision="auto")`` on K=3 of
      1000x2000 (seeds 1, 2, 3) from ``D_opt_KYinit`` starts, FW-away,
      refresh_every=4096, cut to a 20000 budget and eps=1e-7; it must run
      the lazy-H batch kernel, stop every instance and certify it at its
      stop row;
   c. one instance through ``D_opt_FW_away(u_mode="pallas")`` at 30x1000
      to eps=1e-8, against the CPU exact engine;
   d. the main path: ``D_opt_FW_away`` on the 1000x5000 seed-10 design
      from the uniform start, eps=1e-8, the reference's 20741-iteration
      budget, ``u_mode="auto"`` and no ``device`` (the port's default is
      the card); it must go through the lazy-H kernel and its final
      iterate must certify against the known optimum by a fresh float64
      slogdet; one more solve is traced (device busy and idle shares, the
      kernel's share), as is one more large-m sweep;
   e. the Bregman path: ``ABPG_gain`` (gamma=2, 9000 iterations) on
      ``D_opt_design(30, 10000, randseed=10, device="cuda")`` with
      ``BurgEntropySimplex(use_pallas=True)``; every prox must launch the
      multiplier kernel and land on the simplex (|sum x - 1| <= 1e-8 plus
      the sum's rounding), and the fresh float64 F of the final iterate
      must reach -16.0963 (the reference notebook's numpy run: -16.096434);
   f. ``BPG`` with its line search (9000 iterations) on the 30x1000 seed-10
      design with the default h on the card: the last F row within 1e-7 of
      the reference's -8.62103647488 (its history's last row), the returned
      iterate (one step further) at or below it by a fresh float64
      slogdet, and no multiplier kernel launch;
   g. the README example's BPG, ABPG, ABPG_expo and ABPG_gain calls
      (``examples/ex_Dopt_random.py``) at 80x200 seed 10 on the card with
      ``use_pallas=True``: finite F, BPG and ABPG within 0.05 of 17.59 and
      17.585 at 900 iterations; and ABPG_gain for 300 iterations on the
      card against the CPU (the kernel's plain version), F rtol 1e-9 over
      the first 100 rows;
   h. per-iteration costs of the five Bregman drivers at 30x1000 on the
      card, with each h: host syncs (``torch.cuda.set_sync_debug_mode``)
      and device operations (``torch.profiler``) per iteration;
5. the kernels' JSON line (launches on the path, error against the plain
   version, kernel and plain times, the bound from this run's inputs and
   the time of a PyTorch call for the same function where one exists), the
   card line, then the result line ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# main-path instance (baselines/dopt_1000x5000_ref.json)
M, N, SEED, EPS, REF_ITERS = 1000, 5000, 10, 1e-8, 20741
F_STAR = 104.26595073287248   # F_star_certified of that file
GAP_TOL = 1e-6
# the dense sweep (BASELINE.md: K=32 of 30x1000 to slack 1e-8)
DENSE_K, DENSE_M, DENSE_N, DENSE_BUDGET = 32, 30, 1000, 20000
# the large-m sweep: the top row of the n=2000 study
# (examples/ex_Dopt_sweep_full.py), cut to a 20000 budget (from 100000)
# and eps=1e-7 (from 1e-8, which that size does not reach in 100000)
LARGE_K, LARGE_M, LARGE_N, LARGE_BUDGET, LARGE_EPS = 3, 1000, 2000, 20000, 1e-7
LARGE_REFRESH = 4096
# fresh float64 slacks against the recorded stop row
DENSE_CERT_TOL, LARGE_CERT_TOL = 1e-10, 1e-9
# the Bregman paths (BASELINE.md: the reference notebooks' numpy runs)
GAIN_M, GAIN_N, GAIN_ITERS, GAIN_F_BOUND = 30, 10000, 9000, -16.0963
BPG_M, BPG_N, BPG_ITERS, BPG_F_REF, BPG_F_TOL = 30, 1000, 9000, \
    -8.62103647488, 1e-7
README_M, README_N, README_ITERS = 80, 200, 900
# the multiplier kernel's Newton stall threshold
SIMPLEX_STALL = 1e-8
# kernel vs plain version on the card, over one 256-iteration block: x, w
# and C to rtol 1e-11 (each array's max-abs scales the atol, for entries
# that cancel to near zero); SP, SN, tau, tau (w_v - 1) to atol 1e-12.
RTOL_STATE = 1e-11
ATOL_HIST = 1e-12
# the card's published peaks for the bounds (NVIDIA's H100 SXM data sheet):
# HBM3 bytes/s, and FP64 operations/s on the tensor cores, the card's
# highest rate for this type (the sheet's "FP64 Tensor Core" line; its
# "FP64" line, outside the tensor cores, is 34 TFLOP/s)
PEAK_BYTES, PEAK_FP64 = 3.35e12, 67e12
PHASES = ("prologue", "pivots and step scalars", "phase 1 (H0 v, C v)",
          "barrier 1", "phase 2 (g)", "barrier 2", "phase 3 (u, w, x)",
          "barrier 3")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def fresh_slacks(V, x):
    """Float64 slacks of the simplex-normalized iterate by a fresh numpy
    factorization: (SP, SN, -logdet)."""
    m = V.shape[0]
    xs = np.asarray(x, np.float64)
    xs = xs / xs.sum()
    G = (V * xs) @ V.T
    sign, logdet = np.linalg.slogdet(G)
    if sign <= 0:
        raise AssertionError("the final iterate's information matrix is "
                             "not positive definite")
    w = np.einsum("ij,ij->j", V, np.linalg.solve(G, V))
    return w.max() / m - 1.0, 1.0 - w[xs > 1e-8].min() / m, -logdet


def stop_row(SP, SN, eps):
    hit = np.flatnonzero((SP <= eps) & (SN <= eps))
    return int(hit[0]) if hit.size else -1


def time_launches(fn, reps):
    """ms per call of ``fn`` over ``reps`` back-to-back calls (CUDA
    events), after one warm-up call."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def trace_line(label, fn, kernel_name):
    """Run ``fn`` once more under torch.profiler and print where the wall
    went: device busy and idle shares, and the share of the kernel whose
    name holds ``kernel_name``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        print(f"[trace] {label}: not measured (no device events in the "
              f"trace)", flush=True)
        return
    busy = sum(e.device_time for e in events) * 1e-6
    mine = [e.device_time * 1e-6 for e in events if kernel_name in e.name]
    print(f"[trace] {label}: traced wall {wall:.3f} s, device busy "
          f"{busy:.3f} s, idle {100 * (1 - busy / wall):.1f}%; "
          f"{kernel_name} {sum(mine):.3f} s in {len(mine)} launches "
          f"({100 * sum(mine) / wall:.1f}% of the wall, "
          f"{1e3 * sum(mine) / max(len(mine), 1):.3f} ms each)", flush=True)


def kernel_device_us(fn, kernel_name, reps):
    """Mean device time (us) of the kernel whose name holds ``kernel_name``
    over ``reps`` calls of ``fn`` under torch.profiler, or None where the
    trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    mine = [e.device_time for e in prof.events()
            if e.device_type == DeviceType.CUDA and kernel_name in e.name]
    return sum(mine) / len(mine) if mine else None


def host_cost_us(fn, reps=1000):
    """Host time (us) per call of ``fn`` over ``reps`` unsynchronised
    calls: what the wrapper costs the caller's thread.  Where the kernel is
    slower than that, the launch queue fills and this reads the kernel's
    pace instead."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    cost = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return cost


def us_text(value):
    return "not measured" if value is None else f"{value:.2f} us"


def timed_plain(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def bound(nbytes, flops):
    """The least time (ms) the card could take: bytes over the HBM rate or
    FP64 operations over the peak rate, whichever is larger, and which."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP64 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def lazy_bound(m, n, nrun_each):
    """Bound of one lazy-H block of ``nrun_each`` iterations per instance:
    V^T, H0, x and w read once, x, w, the run rows of C and beta, misc and
    hist written once; iteration k does 2 m n (u) + 2 m^2 (H0 v) + 4 k m
    (C v and g) + 8 n (w, x, pivots) FP64 operations."""
    nbytes = flops = 0
    for nrun in nrun_each:
        nbytes += 8 * (m * n + m * m + 4 * n + nrun * (m + 1) + 4 + 5 * 256)
        flops += nrun * (2 * m * n + 2 * m * m + 8 * n) \
            + 4 * m * nrun * (nrun - 1) // 2
    return bound(nbytes, flops)


def dense_bound(B, m, n, kmax, iters):
    """Bound of one dense block of B instances that ran ``iters``
    iterations in all: V^T, H, x, w read once, H, x, w and the ``kmax``
    rows written once; an iteration does 2 m n (u) + 4 m^2 (H v and the
    rank-1 update of H) + 8 n FP64 operations."""
    nbytes = 8 * B * (m * n + 2 * m * m + 4 * n + 3 + 5 * kmax)
    return bound(nbytes, iters * (2 * m * n + 4 * m * m + 8 * n))


def simplex_bound(gg):
    """Bound of one multiplier solve on this input: gg read once, c written
    once; the passes this input needs (one min, the bisection steps until
    the residual is >= 0, one per Newton step until it stalls), 5 FP64
    operations per element and pass."""
    g = gg.cpu().numpy()
    cmin = -g.min()
    c, passes = cmin + 1.0, 1
    for _ in range(64):
        passes += 1
        if np.sum(1.0 / (g + c)) - 1.0 >= 0.0:
            break
        c = 0.5 * (cmin + c)
    fc = np.sum(1.0 / (g + c)) - 1.0
    for _ in range(24):
        passes += 1
        c_new = c - fc / np.sum(-1.0 / (g + c) ** 2)
        if c_new == c or abs(fc) <= SIMPLEX_STALL:
            break
        c, fc = c_new, np.sum(1.0 / (g + c_new)) - 1.0
    return bound(8 * (g.size + 1), 5 * g.size * passes)


def close_state(name, got, ref):
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    err = float((got - ref).abs().max()) if ref.numel() else 0.0
    bound = RTOL_STATE * scale
    ok = bool(torch.allclose(got, ref, rtol=RTOL_STATE, atol=bound))
    if not ok:
        raise AssertionError(f"{name}: max |kernel - plain| = {err:.3e} "
                             f"exceeds rtol {RTOL_STATE} (scale {scale:.3e})")
    return err


def compare_block(dl, V, eps):
    """One 256-iteration block from the uniform start's fresh state,
    kernel against plain version; returns (max_abs_err, ms, plain_ms)."""
    from accbpg_and_fw_tpu_torch.ops.dopt_common import factorize

    m, n = V.shape
    x0 = torch.full((n,), 1.0 / n, dtype=torch.float64, device=V.device)
    H0, w0, _ = factorize(V, x0)
    VT = V.T.contiguous()
    kw = dict(eps=eps, kmax=dl._KR, away=True)

    torch.cuda.synchronize()
    t = time.perf_counter()
    ref = dl.lazy_block_reference(V, H0, x0, w0, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3

    before = dl.LAUNCHES
    out = dl.lazy_block(V, H0, x0, w0, VT=VT, **kw)
    torch.cuda.synchronize()
    if dl.LAUNCHES != before + 1:
        raise AssertionError("lazy_block did not count its launch")

    misc, misc_ref = out.misc.cpu(), ref.misc.cpu()
    if not torch.equal(misc[[0, 1, 3]], misc_ref[[0, 1, 3]]):
        raise AssertionError(f"done/iters/nrun differ: kernel {misc.tolist()}"
                             f" plain {misc_ref.tolist()}")
    iters, nrun = int(misc[1]), int(misc[3])
    h, h_ref = out.hist[:, :iters].cpu(), ref.hist[:, :iters].cpu()
    if not torch.equal(h[4], h_ref[4]):
        first = int(torch.nonzero(h[4] != h_ref[4])[0])
        raise AssertionError(f"pivot sequences differ first at row {first}")
    errs = [close_state("x", out.x, ref.x), close_state("w", out.w, ref.w),
            close_state("C", out.C[:nrun], ref.C[:nrun]),
            close_state("beta", out.beta[:nrun], ref.beta[:nrun]),
            close_state("alpha", misc[2:3], misc_ref[2:3])]
    for row, name in enumerate(("tau", "tau(w_v-1)", "SP", "SN")):
        err = float((h[row] - h_ref[row]).abs().max())
        if not err <= ATOL_HIST:
            raise AssertionError(f"{name}: max |kernel - plain| = {err:.3e} "
                                 f"exceeds atol {ATOL_HIST}")
        errs.append(err)

    # two launches from one state: the same bits
    again = dl.lazy_block(V, H0, x0, w0, VT=VT, **kw)
    torch.cuda.synchronize()
    same_bits("lazy_block", again, out, [nrun])

    # per-block time as the drivers launch it: the kernel prepared once
    # (plan, scratch and output buffers), CUDA events over back-to-back
    # launches
    kernel = dl._LazyKernel(VT)
    run = dict(eps=eps, kmax=dl._KR, done=False, away=True, xtol=1e-8)
    ms = time_launches(lambda: kernel.run(H0, x0, w0, **run), 10)
    bound_ms, bound_by = lazy_bound(m, n, [nrun])
    plan = kernel.plan
    print(f"[kernel] {m}x{n}: {iters} iterations, pivots identical, two "
          f"launches bit for bit, max |kernel - plain| {max(errs):.3e}; per "
          f"block kernel {ms:.3f} ms ({ms * 1e3 / max(nrun, 1):.2f} us per "
          f"iteration), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms (by "
          f"{bound_by}); {plan.group} CTAs of {plan.col_base}-"
          f"{plan.col_base + (plan.col_extra > 0)} columns, {plan.resident} "
          f"resident in {plan.smem_bytes} B of shared memory, the rest "
          f"streamed; {kernel.regs} registers per thread", flush=True)
    return max(errs), ms, plain_ms, bound_ms, bound_by


def same_bits(name, a, b, nrun_each):
    """Raise unless two blocks agree bit for bit (C and beta over the rows
    that ran, the histories over the rows that were recorded)."""
    single = a.misc.dim() == 1
    for k, nrun in enumerate(nrun_each):
        pick = (lambda t: t) if single else (lambda t: t[k])
        iters = int(pick(a.misc)[1])
        pairs = [(pick(a.x), pick(b.x)), (pick(a.w), pick(b.w)),
                 (pick(a.misc), pick(b.misc)),
                 (pick(a.hist)[:, :iters], pick(b.hist)[:, :iters]),
                 (pick(a.C)[:nrun], pick(b.C)[:nrun]),
                 (pick(a.beta)[:nrun], pick(b.beta)[:nrun])]
        if not all(torch.equal(p, q) for p, q in pairs):
            raise AssertionError(f"{name}: two launches from one state "
                                 f"differ (instance {k})")


def lazy_phases(dl, V, eps, ms):
    """The clocks of CTA 0 per phase over one 256-iteration block of the
    1000x5000 kernel, as shares of the block's time, and two cuBLAS DGEMV
    calls on the same operands as yardsticks of phases 1 and 3."""
    from accbpg_and_fw_tpu_torch.ops.dopt_common import factorize

    m, n = V.shape
    x0 = torch.full((n,), 1.0 / n, dtype=torch.float64, device=V.device)
    H0, w0, _ = factorize(V, x0)
    kernel = dl._LazyKernel(V.T.contiguous())
    prof = torch.zeros(8, dtype=torch.int64, device=V.device)
    blk = kernel.run(H0, x0, w0, eps=eps, kmax=dl._KR, done=False, away=True,
                     xtol=1e-8, prof=prof)
    clocks = prof.cpu().numpy().astype(np.float64)
    nrun = int(blk.misc[3])
    if not (clocks > 0).all():
        raise AssertionError(f"the phase clocks were not written: {clocks}")
    us = clocks / clocks.sum() * ms * 1e3 / max(nrun, 1)
    parts = "; ".join(f"{name} {t:.2f} us ({100 * t / us.sum():.1f}%)"
                      for name, t in zip(PHASES, us))
    g = torch.randn(m, dtype=torch.float64, device=V.device)
    gemv_u = time_launches(lambda: g @ V, 50) * 1e3
    gemv_h = time_launches(lambda: H0 @ g, 50) * 1e3
    print(f"[phases] {m}x{n} per iteration, CTA 0's clocks scaled to the "
          f"block time: {parts}; yardsticks: cuBLAS DGEMV g@V {gemv_u:.1f} "
          f"us, H0@v {gemv_h:.1f} us", flush=True)


def interleaved_kernels(dl, V, V_small, eps):
    """A kernel prepared for a large design still launches after one was
    prepared for a small design (the shared-memory opt-in is the
    function's for the whole process), and both give the bits of a fresh
    ``lazy_block``."""
    from accbpg_and_fw_tpu_torch.ops.dopt_common import factorize

    run = dict(eps=eps, kmax=dl._KR, done=False, away=True, xtol=1e-8)
    big = dl._LazyKernel(V.T.contiguous())
    small = dl._LazyKernel(V_small.T.contiguous())
    for name, kernel, W in (("large", big, V), ("small", small, V_small)):
        n = W.shape[1]
        x0 = torch.full((n,), 1.0 / n, dtype=torch.float64, device=W.device)
        H0, w0, _ = factorize(W, x0)
        got = kernel.run(H0, x0, w0, **run)
        ref = dl.lazy_block(W, H0, x0, w0, eps=eps, kmax=dl._KR, away=True)
        torch.cuda.synchronize()
        same_bits(f"interleaved {name} kernel", got, ref,
                  [int(ref.misc[3])])
    print(f"[kernel] a {V.shape[0]}x{V.shape[1]} kernel launches after a "
          f"{V_small.shape[0]}x{V_small.shape[1]} one was prepared "
          f"({big.plan.smem_bytes} and {small.plan.smem_bytes} B of shared "
          f"memory), both bit for bit with a fresh lazy_block", flush=True)


def compare_dense(dd, Vs, eps, kmax=256):
    """One dense block for B instances from their uniform starts' fresh
    states, kernel against plain version; returns (max_abs_err, ms,
    plain_ms)."""
    from accbpg_and_fw_tpu_torch.ops.dopt_common import factorize

    B, m, n = Vs.shape
    xs = torch.full((B, n), 1.0 / n, dtype=torch.float64, device=Vs.device)
    parts = [factorize(Vs[b], xs[b]) for b in range(B)]
    Hs = torch.stack([p[0] for p in parts])
    ws = torch.stack([p[1] for p in parts])
    VTs = Vs.transpose(1, 2).contiguous()
    kw = dict(eps=eps, kmax=kmax, away=True)
    ref, plain_ms = timed_plain(
        lambda: dd.dense_block_reference(Vs, Hs, xs, ws, **kw))
    before = dd.LAUNCHES
    out = dd.dense_block(Vs, Hs, xs, ws, VTs=VTs, **kw)
    torch.cuda.synchronize()
    if dd.LAUNCHES != before + 1:
        raise AssertionError("dense_block did not count its launch")
    misc, misc_ref = out.misc.cpu(), ref.misc.cpu()
    if not torch.equal(misc, misc_ref):
        raise AssertionError(f"dense misc differ: kernel {misc.tolist()} "
                             f"plain {misc_ref.tolist()}")
    h, h_ref = out.hist.cpu(), ref.hist.cpu()
    if not torch.equal(h[:, 4], h_ref[:, 4]):
        raise AssertionError("dense pivot sequences differ")
    errs = [close_state("x", out.x, ref.x), close_state("w", out.w, ref.w),
            close_state("H", out.H, ref.H)]
    err = float((h[:, :4] - h_ref[:, :4]).abs().max())
    if not err <= ATOL_HIST:
        raise AssertionError(f"dense histories: max |kernel - plain| "
                             f"{err:.3e} exceeds atol {ATOL_HIST}")
    errs.append(err)
    # two launches from one state: the same bits
    again = dd.dense_block(Vs, Hs, xs, ws, VTs=VTs, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(again, out)):
        raise AssertionError(f"dense_block B={B}: two launches from one "
                             f"state differ")
    ms = time_launches(lambda: dd.dense_block(Vs, Hs, xs, ws, VTs=VTs, **kw),
                       5)
    bound_ms, bound_by = dense_bound(B, m, n, kmax, int(misc[:, 1].sum()))
    plan, active = dd.device_plan(B, m, n, Vs.device.index)
    regs, _, spill, _ = dd.kernel_info(Vs.device.index)
    layout = (f"the columns resident in {plan.smem_bytes} B of shared "
              f"memory" if plan.resident else
              f"V streamed, H in {'shared' if plan.h_in_smem else 'global'} "
              f"memory ({plan.smem_bytes} B of shared memory)")
    print(f"[kernel] dense B={B} {m}x{n}: {kmax} iterations each, pivots "
          f"identical, two launches bit for bit, max |kernel - plain| "
          f"{max(errs):.3e}; per block kernel {ms:.3f} ms "
          f"({ms * 1e3 / kmax:.2f} us per iteration), plain {plain_ms:.3f} "
          f"ms, bound {bound_ms:.4f} ms (by {bound_by}); {B} clusters of "
          f"{plan.cluster} CTAs x {plan.threads} threads ({active} fit the "
          f"card at once), {plan.chunk} columns per CTA, {layout}; {regs} "
          f"registers per thread, {spill} B spilled", flush=True)
    return max(errs), ms, plain_ms, bound_ms, bound_by


def compare_lazy_batch(dl, Vs, x0s, eps):
    """One lazy-H block for K instances, kernel (batch entry) against the
    plain version; returns (max_abs_err, ms, plain_ms)."""
    from accbpg_and_fw_tpu_torch.ops.dopt_common import factorize

    K, m, n = Vs.shape
    parts = [factorize(Vs[k], x0s[k]) for k in range(K)]
    H0 = torch.stack([p[0] for p in parts])
    w0 = torch.stack([p[1] for p in parts])
    VTs = Vs.transpose(1, 2).contiguous()
    kw = dict(eps=eps, kmax=[dl._KR] * K, away=True)
    ref, plain_ms = timed_plain(
        lambda: dl.lazy_block_batch_reference(Vs, H0, x0s, w0, **kw))
    before = dl.BATCH_LAUNCHES
    out = dl.lazy_block_batch(Vs, H0, x0s, w0, VTs=VTs, **kw)
    torch.cuda.synchronize()
    if dl.BATCH_LAUNCHES <= before:
        raise AssertionError("lazy_block_batch did not count its launch")
    misc, misc_ref = out.misc.cpu(), ref.misc.cpu()
    if not torch.equal(misc[:, [0, 1, 3]], misc_ref[:, [0, 1, 3]]):
        raise AssertionError(f"batch done/iters/nrun differ: kernel "
                             f"{misc.tolist()} plain {misc_ref.tolist()}")
    errs = []
    for k in range(K):
        iters, nrun = int(misc[k, 1]), int(misc[k, 3])
        h, h_ref = out.hist[k, :, :iters].cpu(), ref.hist[k, :, :iters].cpu()
        if not torch.equal(h[4], h_ref[4]):
            raise AssertionError(f"batch instance {k}: pivots differ")
        errs += [close_state("x", out.x[k], ref.x[k]),
                 close_state("w", out.w[k], ref.w[k]),
                 close_state("C", out.C[k, :nrun], ref.C[k, :nrun]),
                 close_state("beta", out.beta[k, :nrun], ref.beta[k, :nrun]),
                 close_state("alpha", misc[k, 2:3], misc_ref[k, 2:3])]
        err = float((h[:4] - h_ref[:4]).abs().max())
        if not err <= ATOL_HIST:
            raise AssertionError(f"batch instance {k} histories: "
                                 f"{err:.3e} exceeds atol {ATOL_HIST}")
        errs.append(err)
    nrun_each = [int(q) for q in misc[:, 3]]
    again = dl.lazy_block_batch(Vs, H0, x0s, w0, VTs=VTs, **kw)
    torch.cuda.synchronize()
    same_bits("lazy_block_batch", again, out, nrun_each)
    kernel = dl._LazyKernel(VTs)
    run = dict(eps=eps, kmax=[dl._KR] * K, done=None, away=True, xtol=1e-8)
    ms = time_launches(lambda: kernel.run(H0, x0s, w0, **run), 10)
    bound_ms, bound_by = lazy_bound(m, n, nrun_each)
    plan = kernel.plan
    print(f"[kernel] lazy batch K={K} {m}x{n}: {dl._KR} iterations each, "
          f"pivots identical, two launches bit for bit, max |kernel - plain| "
          f"{max(errs):.3e}; per block kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms (by {bound_by}); "
          f"{plan.wave} groups of {plan.group} CTAs, {plan.col_base}-"
          f"{plan.col_base + (plan.col_extra > 0)} columns each, "
          f"{plan.resident} resident in {plan.smem_bytes} B of shared "
          f"memory, the rest streamed; {kernel.regs} registers per thread",
          flush=True)
    return max(errs), ms, plain_ms, bound_ms, bound_by


def dense_phases(dd, Vs, eps, ms, kmax=256):
    """Thread 0 of CTA 0's clocks per phase over one dense block, as shares
    of the block's time per iteration."""
    from accbpg_and_fw_tpu_torch.ops.dopt_common import factorize

    B, m, n = Vs.shape
    xs = torch.full((B, n), 1.0 / n, dtype=torch.float64, device=Vs.device)
    parts = [factorize(Vs[b], xs[b]) for b in range(B)]
    Hs = torch.stack([p[0] for p in parts])
    ws = torch.stack([p[1] for p in parts])
    prof = torch.zeros(len(dd.PHASES), dtype=torch.int64, device=Vs.device)
    blk = dd._launch_cuda(Vs, Hs, xs, ws, eps, kmax, None, True, 1e-8, None,
                          prof=prof)
    clocks = prof.cpu().numpy().astype(np.float64)
    nrun = int(blk.misc[0, 2])
    if not (clocks > 0).all():
        raise AssertionError(f"the phase clocks were not written: {clocks}")
    us = clocks / clocks.sum() * ms * 1e3 / max(nrun, 1)
    parts = "; ".join(f"{name} {t:.2f} us ({c / nrun:.0f} clocks)"
                      for name, t, c in zip(dd.PHASES, us, clocks))
    print(f"[phases] dense B={B} {m}x{n} per iteration, thread 0 of CTA 0's "
          f"clocks scaled to the block time: {parts}", flush=True)


def simplex_stages(sm, gg, label):
    """Thread 0 of CTA 0's clocks per stage of a pass of the multiplier
    kernel on one input."""
    prof = torch.zeros(len(sm.STAGES) + 1, dtype=torch.int64,
                       device=gg.device)
    sm._launch_cuda(gg, prof=prof)
    clocks = prof.cpu().numpy().astype(np.float64)
    passes = int(clocks[-1])
    if passes < 2:
        raise AssertionError(f"the stage clocks were not written: {clocks}")
    parts = "; ".join(f"{name} {c / passes:.0f}"
                      for name, c in zip(sm.STAGES, clocks[:-1]))
    print(f"[stages] simplex multiplier {label} n={gg.numel()}: {passes} "
          f"passes (the min pass and the staging included), "
          f"{clocks[:-1].sum() / passes:.0f} clocks a pass for thread 0 of "
          f"CTA 0: {parts}", flush=True)


def micro():
    """``--micro``: build ``csrc/micro_cluster.cu`` and run it."""
    from accbpg_and_fw_tpu_torch.ops import _build

    src = _build._CSRC / "micro_cluster.cu"
    out = _build._BUILD_DIR / "micro_cluster"
    out.parent.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_build._nvcc(), *flags, "-o", str(out), str(src)],
                   check=True, timeout=600)
    print(f"[micro] {card_line()}", flush=True)
    return subprocess.run([str(out)], timeout=600).returncode


def dense_designs():
    """The dense sweep's instances: instance k from np.random.seed(k + 1)."""
    Vs = np.empty((DENSE_K, DENSE_M, DENSE_N))
    for k in range(DENSE_K):
        np.random.seed(k + 1)
        Vs[k] = np.random.randn(DENSE_M, DENSE_N)
    return Vs


def main_design():
    """The main path's instance: 1000x5000 from np.random.seed(10)."""
    np.random.seed(SEED)
    return np.random.randn(M, N)


def large_designs(start=None):
    """The large-m sweep's instances, instance k from np.random.seed(k + 1),
    and their starts ``start(V)``, each drawn right after its design from
    the same stream (None: no starts are drawn); returns (Vs, x0s)."""
    Vs = np.empty((LARGE_K, LARGE_M, LARGE_N))
    x0s = np.empty((LARGE_K, LARGE_N))
    for k in range(LARGE_K):
        np.random.seed(k + 1)
        Vs[k] = np.random.randn(LARGE_M, LARGE_N)
        if start is not None:
            x0s[k] = start(Vs[k])
    return Vs, x0s


def dense_sweep(port, dd, dev):
    """Phase 4a; returns the dense kernel's launches in it."""
    Vs = dense_designs()
    x0s = np.full((DENSE_K, DENSE_N), 1.0 / DENSE_N)
    dd.LAUNCHES = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    x, F, SP, SN = port.dopt_fw_batch(Vs, x0s, EPS, DENSE_BUDGET, away=True,
                                      precision="pallas", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dd.LAUNCHES
    if launches < 1:
        raise AssertionError("the dense sweep made no dense kernel launch")
    xs = x.cpu().numpy()
    iters, worst = [], 0.0
    for k in range(DENSE_K):
        r = stop_row(SP[k], SN[k], EPS)
        if r < 0:
            raise AssertionError(f"dense sweep instance {k} did not stop "
                                 f"within {DENSE_BUDGET}")
        sp, sn, _ = fresh_slacks(Vs[k], xs[k])
        if not (sp <= EPS + DENSE_CERT_TOL and sn <= EPS + DENSE_CERT_TOL
                and abs(sp - SP[k, r]) <= DENSE_CERT_TOL
                and abs(sn - SN[k, r]) <= DENSE_CERT_TOL):
            raise AssertionError(
                f"dense sweep instance {k}: fresh slacks {sp:.3e}/{sn:.3e}, "
                f"recorded {SP[k, r]:.3e}/{SN[k, r]:.3e} at row {r}")
        iters.append(r + 1)
        worst = max(worst, sp, sn)
    print(f"[dense sweep] K={DENSE_K} of {DENSE_M}x{DENSE_N} "
          f"precision=pallas on cuda: wall {wall:.3f} s, {launches} "
          f"kernel launches, {F.shape[1]} lockstep rows, iterations to "
          f"1e-8 min {min(iters)} median {int(np.median(iters))} max "
          f"{max(iters)} (sum {sum(iters)}); {DENSE_K}/{DENSE_K} "
          f"fresh-certified, worst fresh slack {worst:.4e}", flush=True)
    trace_line(f"dense sweep K={DENSE_K} of {DENSE_M}x{DENSE_N}",
               lambda: port.dopt_fw_batch(Vs, x0s, EPS, DENSE_BUDGET,
                                          away=True, precision="pallas",
                                          device=dev),
               "dopt_dense_kernel")
    return launches


def large_sweep(port, dl, dev):
    """Phase 4b; returns the batch kernel's launches in it and the last
    instances (V, x0) for the per-block comparison."""
    Vs, x0s = large_designs(
        lambda V: port.D_opt_KYinit(V, device="cpu").numpy())
    dl.BATCH_LAUNCHES = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    x, F, SP, SN = port.dopt_fw_batch(Vs, x0s, LARGE_EPS, LARGE_BUDGET,
                                      away=True, precision="auto",
                                      refresh_every=LARGE_REFRESH,
                                      device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dl.BATCH_LAUNCHES
    if launches < 1:
        raise AssertionError("precision='auto' did not reach the lazy-H "
                             "batch kernel")
    xs = x.cpu().numpy()
    table = []
    for k in range(LARGE_K):
        r = stop_row(SP[k], SN[k], LARGE_EPS)
        if r < 0:
            raise AssertionError(f"large sweep instance {k} did not stop "
                                 f"within {LARGE_BUDGET}")
        sp, sn, fresh_F = fresh_slacks(Vs[k], xs[k])
        if not (abs(sp - SP[k, r]) <= LARGE_CERT_TOL
                and abs(sn - SN[k, r]) <= LARGE_CERT_TOL
                and abs(fresh_F - F[k, -1]) <= 1e-9 * abs(F[k, -1])):
            raise AssertionError(
                f"large sweep instance {k}: fresh slacks {sp:.3e}/{sn:.3e} "
                f"F {fresh_F:.12e}, recorded {SP[k, r]:.3e}/{SN[k, r]:.3e} "
                f"F {F[k, -1]:.12e} at row {r}")
        table.append([stop_row(SP[k], SN[k], e) + 1
                      for e in (1e-3, 1e-4, 1e-5, 1e-6, 1e-7)])
    print(f"[large sweep] K={LARGE_K} of {LARGE_M}x{LARGE_N} precision=auto "
          f"on cuda: wall {wall:.3f} s, {launches} batch kernel launches, "
          f"{LARGE_K}/{LARGE_K} stopped at 1e-7 and certified at the stop "
          f"row (fresh slacks within {LARGE_CERT_TOL}, F rtol 1e-9); "
          f"iterations to eps 1e-3..1e-7 per instance: {table}", flush=True)
    trace_line(f"large sweep K={LARGE_K} of {LARGE_M}x{LARGE_N}",
               lambda: port.dopt_fw_batch(Vs, x0s, LARGE_EPS, LARGE_BUDGET,
                                          away=True, precision="auto",
                                          refresh_every=LARGE_REFRESH,
                                          device=dev),
               "dopt_lazy_kernel")
    return launches, Vs, x0s


def single_pallas(port, dd, dev):
    """Phase 4c; returns the dense kernel's launches in it."""
    np.random.seed(1)
    V = np.random.randn(DENSE_M, DENSE_N)
    x0 = np.full(DENSE_N, 1.0 / DENSE_N)
    dd.LAUNCHES = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    x, F, SP, SN, T = port.D_opt_FW_away(V, x0, EPS, DENSE_BUDGET,
                                         verbose=False, u_mode="pallas",
                                         device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dd.LAUNCHES
    if launches < 1:
        raise AssertionError("u_mode='pallas' made no dense kernel launch")
    t = time.perf_counter()
    xe, Fe, SPe, SNe, _ = port.D_opt_FW_away(V, x0, EPS, DENSE_BUDGET,
                                             verbose=False, u_mode="exact",
                                             device="cpu")
    wall_cpu = time.perf_counter() - t
    if abs(len(F) - len(Fe)) > 0.01 * len(Fe):
        raise AssertionError(f"u_mode='pallas': {len(F)} iterations, the "
                             f"CPU exact engine {len(Fe)}")
    np.testing.assert_allclose(F[:300], Fe[:300], rtol=1e-9)
    for name, xx in (("pallas", x.cpu().numpy()), ("exact", xe.numpy())):
        sp, sn, _ = fresh_slacks(V, xx)
        if not (sp <= EPS + DENSE_CERT_TOL and sn <= EPS + DENSE_CERT_TOL):
            raise AssertionError(f"{name} run: fresh slacks {sp:.3e}/"
                                 f"{sn:.3e} above {EPS}")
    print(f"[single pallas] D_opt_FW_away {DENSE_M}x{DENSE_N} seed 1 "
          f"u_mode=pallas on cuda: wall {wall:.3f} s, {len(F)} iterations "
          f"({launches} launches); CPU exact engine {len(Fe)} iterations in "
          f"{wall_cpu:.3f} s; F rtol 1e-9 over the first 300 rows; both "
          f"fresh-certified at 1e-8", flush=True)
    trace_line(f"single pallas {DENSE_M}x{DENSE_N}",
               lambda: port.D_opt_FW_away(V, x0, EPS, DENSE_BUDGET,
                                          verbose=False, u_mode="pallas",
                                          device=dev),
               "dopt_dense_kernel")
    return launches


def simplex_resid(gg, c):
    """sum 1/(gg + c) - 1 in float64 on the host."""
    g = gg.cpu().numpy()
    return float(np.sum(1.0 / (g + c)) - 1.0)


def compare_simplex(sm, gg, label):
    """The multiplier kernel against its plain version on one input: c to
    rtol 1e-12, or (the two froze at different Newton steps) both residuals
    within the stall threshold; returns (|c_kernel - c_plain|, ms,
    plain_ms)."""
    before = sm.LAUNCHES
    c_k = float(sm.simplex_inv_multiplier_pallas(gg))
    if sm.LAUNCHES != before + 1:
        raise AssertionError("simplex_inv_multiplier_pallas did not count "
                             "its launch")
    c_p = float(sm.simplex_multiplier_reference(gg))
    err = abs(c_k - c_p)
    slack = SIMPLEX_STALL + gg.numel() * 2.0**-52
    if err > 1e-12 * abs(c_p):
        r_k, r_p = simplex_resid(gg, c_k), simplex_resid(gg, c_p)
        if not (abs(r_k) <= slack and abs(r_p) <= slack):
            raise AssertionError(
                f"simplex {label}: kernel c {c_k!r} (resid {r_k:.3e}) vs "
                f"plain {c_p!r} (resid {r_p:.3e})")
    if len({float(sm.simplex_inv_multiplier_pallas(gg))
            for _ in range(3)} | {c_k}) != 1:
        raise AssertionError(f"simplex {label}: launches from one input "
                             f"differ")

    def call():
        return sm.simplex_inv_multiplier_pallas(gg)

    ms = time_launches(call, 50)
    device_us = kernel_device_us(call, "simplex_mult_kernel", 50)
    host_us = host_cost_us(call)
    plain_ms = time_launches(lambda: sm.simplex_multiplier_reference(gg), 5)
    bound_ms, bound_by = simplex_bound(gg)
    plan = sm.device_plan(gg.numel(), gg.device.index)
    regs, _, spill, _ = sm.kernel_info(gg.device.index)
    print(f"[kernel] simplex multiplier {label} n={gg.numel()}: "
          f"|c kernel - c plain| {err:.3e} (c {c_p:.6e}), launches bit for "
          f"bit; per call kernel {ms:.4f} ms by events, "
          f"{us_text(device_us)} device time in a trace, host cost "
          f"{host_us:.2f} us over 1000 unsynchronised calls; plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms (by {bound_by}); one "
          f"cluster of {plan.cluster} CTAs x {plan.threads} threads, "
          f"{plan.chunk} elements per CTA, {plan.resident} resident in "
          f"{plan.smem_bytes} B of shared memory; {regs} registers per "
          f"thread, {spill} B spilled", flush=True)
    return err, ms, plain_ms, bound_ms, bound_by


def first_prox_input(port, m, n):
    """gg of the first prox of BPG (L = 1) from the uniform start on the
    seed-10 m x n design: (g + 1/x0) / 1."""
    f, _, _, x0 = port.D_opt_design(m, n, randseed=10, device="cuda")
    _, g = f.value_and_grad(x0)
    return (g + torch.div(1.0, x0)).contiguous()


def fresh_F(f, x):
    """-logdet(H diag(x / sum x) H^T) by a fresh float64 numpy slogdet."""
    H = f.H.cpu().numpy()
    xs = x.cpu().numpy()
    xs = xs / xs.sum()
    sign, logdet = np.linalg.slogdet((H * xs) @ H.T)
    if sign <= 0:
        raise AssertionError("the final information matrix is not "
                             "positive definite")
    return -logdet


def gain_trials(Gain, G0, ratio):
    """Line-search trials per ABPG_gain row, read off the gain history."""
    prev = np.concatenate([[G0], Gain[:-1]]) / ratio
    return np.rint(np.log(Gain / prev) / np.log(ratio)).astype(int) + 1


class ProxProbe:
    """Counts the prox calls of an h-oracle and keeps the largest
    |sum x - 1| of their outputs on the device (no host read)."""

    def __init__(self, h):
        self.calls, self.worst = 0, None
        inner = h.prox_map

        def prox_map(g, L):
            x = inner(g, L)
            self.calls += 1
            e = (x.sum() - 1.0).abs()
            self.worst = e if self.worst is None else torch.maximum(
                self.worst, e)
            return x

        h.prox_map = prox_map


def gain_path(port, sm):
    """Phase 4e; returns the kernel's launches in it."""
    f, _, L, x0 = port.D_opt_design(GAIN_M, GAIN_N, randseed=10,
                                    device="cuda")
    h = port.BurgEntropySimplex(use_pallas=True)
    probe = ProxProbe(h)
    sm.LAUNCHES = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    x, F, Gain, Gdiv, Gavg, T = port.ABPG_gain(f, h, L, x0, gamma=2,
                                               maxitrs=GAIN_ITERS,
                                               verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = sm.LAUNCHES
    trials = int(gain_trials(Gain, 1.0, 1.2).sum())
    if not launches >= probe.calls >= trials:
        raise AssertionError(f"ABPG_gain path: {launches} kernel launches, "
                             f"{probe.calls} prox calls, {trials} trials")
    worst = float(probe.worst)
    if not worst <= SIMPLEX_STALL + GAIN_N * 2.0**-52:
        raise AssertionError(f"a prox output is off the simplex by {worst}")
    Ff = fresh_F(f, x)
    if not (np.all(np.isfinite(F)) and Ff <= GAIN_F_BOUND):
        raise AssertionError(f"ABPG_gain path: fresh F {Ff!r} above "
                             f"{GAIN_F_BOUND}")
    print(f"[bregman gain] ABPG_gain gamma=2 {GAIN_M}x{GAIN_N} seed 10 "
          f"use_pallas=True on cuda: wall {wall:.3f} s (with the prox "
          f"probe), {len(F)} iterations, {trials} line-search trials, "
          f"{probe.calls} prox calls, {launches} kernel launches; fresh F "
          f"{Ff:.9f} (recorded {F[-1]:.9f}; numpy reference -16.096434); "
          f"worst |sum x - 1| of a prox {worst:.3e}", flush=True)
    return launches


def bpg_path(port, sm):
    """Phase 4f."""
    f, h, L, x0 = port.D_opt_design(BPG_M, BPG_N, randseed=10,
                                    device="cuda")
    sm.LAUNCHES = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    x, F, Ls, T = port.BPG(f, h, L, x0, maxitrs=BPG_ITERS, linesearch=True,
                           verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if sm.LAUNCHES != 0:
        raise AssertionError("the default h launched the multiplier kernel")
    # the reference's value is its history's last row, f(x_8999); the
    # returned iterate is one step further, so it must lie at or below it
    Ff, Fo = fresh_F(f, x), float(f.value(x))
    if not (len(F) == BPG_ITERS and abs(F[-1] - BPG_F_REF) <= BPG_F_TOL
            and Ff <= F[-1] and abs(Ff - Fo) <= 1e-12 * abs(Ff)):
        raise AssertionError(f"BPG-LS path: {len(F)} rows, F[-1] {F[-1]!r} "
                             f"(reference {BPG_F_REF}), fresh F of the "
                             f"iterate {Ff!r}, oracle {Fo!r}")
    trials = int(np.rint(np.log(Ls / np.concatenate([[L], Ls[:-1]])
                                * 1.2) / np.log(1.2)).sum()) + len(Ls)
    print(f"[bregman bpg] BPG-LS {BPG_M}x{BPG_N} seed 10 default h on cuda: "
          f"wall {wall:.3f} s, {len(F)} iterations, {trials} line-search "
          f"trials; F[-1] {F[-1]:.11f} (reference {BPG_F_REF}); the "
          f"returned iterate's fresh F {Ff:.11f}", flush=True)


def readme_path(port, sm):
    """Phase 4g."""
    f, _, L, x0 = port.D_opt_design(README_M, README_N, randseed=10,
                                    device="cuda")
    h = port.BurgEntropySimplex(use_pallas=True)
    n = README_ITERS
    calls = {
        "BPG": lambda: port.BPG(f, h, L, x0, maxitrs=n, linesearch=True,
                                ls_ratio=2, verbose=False),
        "ABPG": lambda: port.ABPG(f, h, L, x0, gamma=2.0, maxitrs=n,
                                  theta_eq=True, verbose=False),
        "ABPG_expo": lambda: port.ABPG_expo(f, h, L, x0, gamma0=3,
                                            maxitrs=n, theta_eq=True,
                                            Gmargin=100, verbose=False),
        "ABPG_gain": lambda: port.ABPG_gain(f, h, L, x0, gamma=2,
                                            maxitrs=n, G0=0.1,
                                            theta_eq=True, verbose=False),
    }
    bars = {"BPG": 17.59, "ABPG": 17.585}
    parts = []
    for name, run in calls.items():
        sm.LAUNCHES = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        F = run()[1]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if sm.LAUNCHES < len(F) or not np.all(np.isfinite(F)):
            raise AssertionError(f"README {name}: {sm.LAUNCHES} launches, "
                                 f"finite F {np.all(np.isfinite(F))}")
        if name in bars and not abs(F[-1] - bars[name]) < 0.05:
            raise AssertionError(f"README {name}: F {F[-1]} not within 0.05 "
                                 f"of {bars[name]}")
        parts.append(f"{name} F {F[-1]:.6f} in {wall:.3f} s "
                     f"({sm.LAUNCHES} launches)")
    print(f"[readme] {README_M}x{README_N} seed 10 use_pallas=True on cuda, "
          f"{n} iterations: " + "; ".join(parts), flush=True)

    kw = dict(gamma=2, maxitrs=300, G0=0.1, theta_eq=True, verbose=False)
    F_gpu = port.ABPG_gain(f, h, L, x0, **kw)[1]
    fc, _, _, x0c = port.D_opt_design(README_M, README_N, randseed=10,
                                      device="cpu")
    F_cpu = port.ABPG_gain(fc, port.BurgEntropySimplex(use_pallas=True),
                           L, x0c, **kw)[1]
    np.testing.assert_allclose(F_gpu[:100], F_cpu[:100], rtol=1e-9)
    err = float(np.max(np.abs(F_gpu[:100] - F_cpu[:100])
                       / np.abs(F_cpu[:100])))
    print(f"[readme] ABPG_gain 300 iterations, card against CPU (plain "
          f"multiplier): F max rel diff {err:.3e} over the first 100 rows "
          f"(bar 1e-9); {len(F_gpu)} and {len(F_cpu)} rows", flush=True)


def per_iteration_costs(port):
    """Phase 4h: host syncs and device operations per iteration."""
    f, _, L, x0 = port.D_opt_design(BPG_M, BPG_N, randseed=10,
                                    device="cuda")
    iters = 30
    drivers = {
        "BPG": lambda h: port.BPG(f, h, L, x0, iters, verbose=False),
        "ABPG": lambda h: port.ABPG(f, h, L, x0, 2.0, iters, verbose=False),
        "ABPG_expo": lambda h: port.ABPG_expo(f, h, L, x0, 3.0, iters,
                                              verbose=False),
        "ABPG_gain": lambda h: port.ABPG_gain(f, h, L, x0, 2.0, iters,
                                              verbose=False),
        "ABDA": lambda h: port.ABDA(f, h, L, x0, 2.0, iters, verbose=False),
    }
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rows = []
    for name, run in drivers.items():
        for use_pallas in (True, False):
            h = port.BurgEntropySimplex(use_pallas=use_pallas)
            run(h)  # warm-up
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    n_rows = len(run(h)[1])
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            syncs = sum("synchroniz" in str(w.message) for w in caught)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run(h)
                torch.cuda.synchronize()
            ops = sum(1 for e in prof.events()
                      if e.device_type == DeviceType.CUDA)
            ops_txt = (f"{ops / n_rows:.1f}" if ops else "not measured "
                       "(no device events in the trace)")
            rows.append(f"{name} use_pallas={use_pallas}: "
                        f"{syncs / n_rows:.2f} syncs, {ops_txt} device ops")
    print(f"[costs] per iteration at {BPG_M}x{BPG_N} on cuda ({iters} "
          f"iterations each): " + "; ".join(rows), flush=True)


def block_times(root, solves, gain_iters):
    """``--blocks-only``: one 256-iteration block of the lazy-H kernel from
    the uniform start's fresh state, through ``lazy_block`` at 1000x5000 and
    ``lazy_block_batch`` at K=3 of 1000x2000 (each call prepares the kernel
    anew, as every commit's wrapper does); one 256-iteration block of the
    dense kernel through ``dense_block`` at B=1 and B=32 of 30x1000; the
    multiplier through ``simplex_inv_multiplier_pallas`` on random inputs;
    then warm main-path solves."""
    sys.path.insert(0, root)
    import accbpg_and_fw_tpu_torch as port
    from accbpg_and_fw_tpu_torch.ops import dopt_dense as dd
    from accbpg_and_fw_tpu_torch.ops import dopt_lazy as dl
    from accbpg_and_fw_tpu_torch.ops import simplex as sm
    from accbpg_and_fw_tpu_torch.ops.dopt_common import factorize

    if pathlib.Path(root) not in pathlib.Path(port.__file__).resolve().parents:
        raise RuntimeError(f"imported {port.__file__}, not the package "
                           f"under {root}")
    dev = torch.device("cuda")
    V64 = main_design()
    designs = ((torch.tensor(V64, device=dev), dl.lazy_block, dl._KR, "VT"),
               (torch.tensor(large_designs()[0], device=dev),
                dl.lazy_block_batch, [dl._KR] * LARGE_K, "VTs"))
    ms = []
    for W, block, kmax, transposed in designs:
        n = W.shape[-1]
        x = torch.full(W.shape[:-2] + (n,), 1.0 / n, dtype=torch.float64,
                       device=dev)
        if W.dim() == 2:
            H0, w, _ = factorize(W, x)
        else:
            parts = [factorize(Wk, xk) for Wk, xk in zip(W, x)]
            H0 = torch.stack([p[0] for p in parts])
            w = torch.stack([p[1] for p in parts])
        kw = {"eps": EPS, "kmax": kmax,
              transposed: W.transpose(-2, -1).contiguous()}
        ms.append(time_launches(lambda: block(W, H0, x, w, **kw), 10))
    print(f"[blocks] {root}: {card_line()}; lazy block {M}x{N} {ms[0]:.3f} "
          f"ms, batch K={LARGE_K} of {LARGE_M}x{LARGE_N} {ms[1]:.3f} ms "
          f"({dl._KR} iterations each)", flush=True)

    dense_Vs = torch.tensor(dense_designs(), device=dev)
    rng = np.random.default_rng(11)
    off_path = [torch.tensor(rng.standard_normal(shape), device=dev)
                for shape in ((1, 165, 1000), (2, 200, 700))]
    dense_ms = []
    for W in (dense_Vs[:1].contiguous(), dense_Vs, *off_path):
        x = torch.full(W.shape[:1] + W.shape[2:], 1.0 / W.shape[2],
                       dtype=torch.float64, device=dev)
        parts = [factorize(Wk, xk) for Wk, xk in zip(W, x)]
        H = torch.stack([p[0] for p in parts])
        w = torch.stack([p[1] for p in parts])
        WT = W.transpose(1, 2).contiguous()
        dense_ms.append(time_launches(
            lambda: dd.dense_block(W, H, x, w, eps=EPS, kmax=256, VTs=WT),
            10))
    print(f"[blocks] {root}: dense block {DENSE_M}x{DENSE_N}, 256 iterations "
          f"each: B=1 {dense_ms[0]:.3f} ms, B={DENSE_K} {dense_ms[1]:.3f} ms; "
          f"off the paths: B=1 of 165x1000 {dense_ms[2]:.3f} ms, B=2 of "
          f"200x700 {dense_ms[3]:.3f} ms", flush=True)
    parts = []
    for n in (1000, 10000, 100000):
        gg = torch.tensor(np.random.default_rng(n).standard_normal(n) * 3.0
                          + 1.0, device=dev)

        def call():
            return sm.simplex_inv_multiplier_pallas(gg)

        parts.append(
            f"n={n} {time_launches(call, 200):.4f} ms by events, "
            f"{us_text(kernel_device_us(call, 'simplex_mult_kernel', 50))} "
            f"device time in a trace, host cost {host_cost_us(call):.2f} us")
    print(f"[blocks] {root}: multiplier per call (random input): "
          + "; ".join(parts), flush=True)

    def walls(fn, reps=4):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t)
        return " ".join(f"{w:.4f}" for w in out[1:])  # the first warms up

    Vs64 = dense_designs()
    x0s = np.full((DENSE_K, DENSE_N), 1.0 / DENSE_N)
    sweep = walls(lambda: port.dopt_fw_batch(
        Vs64, x0s, EPS, DENSE_BUDGET, away=True, precision="pallas",
        device=dev))
    single = walls(lambda: port.D_opt_FW_away(
        Vs64[0], x0s[0], EPS, DENSE_BUDGET, verbose=False, u_mode="pallas",
        device=dev))
    print(f"[blocks] {root}: warm walls: dense sweep K={DENSE_K} of "
          f"{DENSE_M}x{DENSE_N} {sweep} s; one u_mode=pallas solve {single} s",
          flush=True)
    if gain_iters:
        f, _, L, xg = port.D_opt_design(GAIN_M, GAIN_N, randseed=10,
                                        device="cuda")
        h = port.BurgEntropySimplex(use_pallas=True)
        port.ABPG_gain(f, h, L, xg, gamma=2, maxitrs=50, verbose=False)
        sm.LAUNCHES = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        Fg = port.ABPG_gain(f, h, L, xg, gamma=2, maxitrs=gain_iters,
                            verbose=False)[1]
        torch.cuda.synchronize()
        print(f"[blocks] {root}: ABPG_gain {GAIN_M}x{GAIN_N} use_pallas=True, "
              f"{gain_iters} iterations: wall {time.perf_counter() - t:.3f} "
              f"s, {sm.LAUNCHES} kernel launches, F {Fg[-1]:.9f}", flush=True)

    x0 = np.full(N, 1.0 / N)
    for rep in range(solves):
        dl.LAUNCHES = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        F = port.D_opt_FW_away(V64, x0, eps=EPS, maxitrs=REF_ITERS,
                               verbose=False, device="cuda")[1]
        torch.cuda.synchronize()
        print(f"[solve {rep}] {root}: D_opt_FW_away {M}x{N} wall "
              f"{time.perf_counter() - t:.3f} s, {len(F)} iterations, "
              f"{dl.LAUNCHES} kernel launches", flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks-only", action="store_true",
                    help="print only the block times of the lazy-H and "
                         "dense kernels, the multiplier's time per call and "
                         "the main-path walls of the package under --root")
    ap.add_argument("--root", default=str(pathlib.Path(__file__).parent),
                    help="checkout whose package --blocks-only times")
    ap.add_argument("--solves", type=int, default=3)
    ap.add_argument("--gain-iters", type=int, default=0,
                    help="with --blocks-only: also time ABPG_gain 30x10000 "
                         "over this many iterations")
    ap.add_argument("--micro", action="store_true",
                    help="build and run csrc/micro_cluster.cu")
    args = ap.parse_args()
    # ---- 1. the card --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    if args.blocks_only:
        return block_times(str(pathlib.Path(args.root).resolve()),
                           args.solves, args.gain_iters)
    if args.micro:
        return micro()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{card}", flush=True)

    import accbpg_and_fw_tpu_torch as port
    from accbpg_and_fw_tpu_torch import D_opt_FW_away
    from accbpg_and_fw_tpu_torch.ops import _build
    from accbpg_and_fw_tpu_torch.ops import dopt_dense as dd
    from accbpg_and_fw_tpu_torch.ops import dopt_lazy as dl
    from accbpg_and_fw_tpu_torch.ops import simplex as sm

    # ---- 2. the build -------------------------------------------------------
    names = ("dopt_lazy", "dopt_dense", "simplex_mult")
    cached = [n for n in names if _build.library_path(n).exists()]
    t = time.perf_counter()
    _build.build_all(names)
    for n in names:
        _build.load(n)
    built = ", ".join(f"{n}.cu -> {_build.library_path(n).name}"
                      for n in names)
    print(f"[build] {built} in {time.perf_counter() - t:.2f} s (one nvcc "
          f"per source, in parallel){'; already built: ' if cached else ''}"
          f"{', '.join(cached)}", flush=True)

    # ---- 3. kernels vs plain versions ---------------------------------------
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    V_small = torch.tensor(rng.standard_normal((12, 160)), device=dev)
    compare_block(dl, V_small, EPS)
    V64 = main_design()
    V = torch.tensor(V64, device=dev)
    lazy = compare_block(dl, V, EPS)
    lazy_phases(dl, V, EPS, lazy[1])
    interleaved_kernels(dl, V, V_small, EPS)

    dense_Vs = torch.tensor(dense_designs(), device=dev)
    compare_dense(dd, dense_Vs[:4].contiguous(), EPS)
    dense_batch = compare_dense(dd, dense_Vs, EPS)
    dense_phases(dd, dense_Vs, EPS, dense_batch[1])
    dense_one = compare_dense(dd, dense_Vs[:1].contiguous(), EPS)
    dense_phases(dd, dense_Vs[:1].contiguous(), EPS, dense_one[1])

    mid = torch.tensor(np.random.default_rng(5).standard_normal(
        (3, 100, 1000)), device=dev)
    compare_lazy_batch(dl, mid, torch.full((3, 1000), 1e-3,
                                           dtype=torch.float64, device=dev),
                       EPS)

    simplex_errs = []
    for g in (-1.3210486329130189, 0.1):  # n = 1: bisection moves / idle
        simplex_errs.append(compare_simplex(
            sm, torch.tensor([g], dtype=torch.float64, device=dev),
            f"g={g}")[0])
    simplex_errs.append(compare_simplex(
        sm, first_prox_input(port, BPG_M, BPG_N), "BPG 30x1000 first prox")[0])
    gain_gg = first_prox_input(port, GAIN_M, GAIN_N)
    simplex = compare_simplex(sm, gain_gg, "ABPG_gain 30x10000 first prox")
    simplex_errs.append(simplex[0])
    simplex_stages(sm, gain_gg, "ABPG_gain 30x10000 first prox")
    simplex_stages(sm, first_prox_input(port, BPG_M, BPG_N),
                   "BPG 30x1000 first prox")
    for n in (1000, 10000, 100000):
        gg = torch.tensor(np.random.default_rng(n).standard_normal(n) * 3.0
                          + 1.0, device=dev)
        simplex_errs.append(compare_simplex(sm, gg, "random")[0])

    # the small slice end to end on the card against the CPU exact engine
    x_s, F_s, _, _, _ = D_opt_FW_away(V_small, np.full(160, 1 / 160), 1e-8,
                                      300, verbose=False,
                                      u_mode="pallas_lazy", device=dev)
    x_e, F_e, _, _, _ = D_opt_FW_away(V_small.cpu(), np.full(160, 1 / 160),
                                      1e-8, 300, verbose=False,
                                      u_mode="exact", device="cpu")
    if len(F_s) != len(F_e):
        raise AssertionError(f"12x160 slice: {len(F_s)} vs {len(F_e)} rows")
    np.testing.assert_allclose(F_s, F_e, rtol=1e-9)
    np.testing.assert_allclose(x_s.cpu().numpy(), x_e.numpy(), atol=1e-11)
    print(f"[slice] 12x160 through the kernel matches the CPU exact engine "
          f"over {len(F_s)} iterations (F rtol 1e-9, x atol 1e-11)",
          flush=True)

    # ---- 4. the paths -------------------------------------------------------
    dense_batch_launches = dense_sweep(port, dd, dev)
    batch_launches, large_Vs, large_x0s = large_sweep(port, dl, dev)
    lazy_batch = compare_lazy_batch(
        dl, torch.tensor(large_Vs, device=dev),
        torch.tensor(large_x0s, device=dev), LARGE_EPS)
    dense_one_launches = single_pallas(port, dd, dev)

    x0 = np.full(N, 1.0 / N)
    dl.LAUNCHES = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    # numpy input and no device: the port's default is the card
    x, F, SP, SN, T = D_opt_FW_away(V64, x0, eps=EPS, maxitrs=REF_ITERS,
                                    verbose=False)
    torch.cuda.synchronize()
    if x.device.type != "cuda":
        raise AssertionError(f"the main path ran on {x.device}, not the card")
    wall = time.perf_counter() - t
    launches = dl.LAUNCHES
    iters = len(F)
    need = math.ceil(iters / dl._KR)
    if launches < need:
        raise AssertionError(f"main path made {launches} kernel launches, "
                             f"expected >= {need} for {iters} iterations")
    xs = x.cpu().numpy()
    xs = xs / xs.sum()
    sign, logdet = np.linalg.slogdet((V64 * xs) @ V64.T)
    gap = float(-logdet - F_STAR)
    if not (sign > 0 and np.all(np.isfinite(F)) and abs(gap) <= GAP_TOL):
        raise AssertionError(f"certification failed: sign {sign}, "
                             f"gap {gap:.3e} (limit {GAP_TOL})")
    print(f"[main] D_opt_FW_away {M}x{N} seed {SEED} on cuda: "
          f"wall {wall:.3f} s (after build), {iters} iterations "
          f"(reference {REF_ITERS}), {launches} kernel launches, "
          f"final SP {SP[-1]:.4e} SN {SN[-1]:.4e}, certified gap {gap:.3e}",
          flush=True)

    trace_line(f"main path {M}x{N}",
               lambda: D_opt_FW_away(V64, x0, eps=EPS, maxitrs=REF_ITERS,
                                     verbose=False),
               "dopt_lazy_kernel")

    simplex_launches = gain_path(port, sm)
    bpg_path(port, sm)
    readme_path(port, sm)
    per_iteration_costs(port)

    # ---- 5. the record ------------------------------------------------------
    def entry(name, source, replaces, launches, measured):
        err, ms, plain_ms, bound_ms, bound_by = measured
        # library_ms: no single PyTorch call computes any of these functions
        return {"name": name, "route": "cuda",
                "source": f"accbpg_and_fw_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None}

    kernels = [
        entry("dopt_lazy_block", "dopt_lazy.cu",
              "accbpg_and_fw_tpu/ops/pallas_dopt_lazy.py:153", launches,
              lazy),
        entry("dopt_lazy_block_batch", "dopt_lazy.cu",
              "accbpg_and_fw_tpu/ops/pallas_dopt_lazy.py:899",
              batch_launches, lazy_batch),
        entry("dopt_dense_block", "dopt_dense.cu",
              "accbpg_and_fw_tpu/ops/pallas_dopt.py:169",
              dense_one_launches, dense_one),
        entry("dopt_dense_block_batch", "dopt_dense.cu",
              "accbpg_and_fw_tpu/ops/pallas_dopt.py:830",
              dense_batch_launches, dense_batch),
        entry("simplex_multiplier", "simplex_mult.cu",
              "accbpg_and_fw_tpu/ops/pallas_kernels.py:32",
              simplex_launches, (max(simplex_errs),) + simplex[1:]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
