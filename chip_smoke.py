"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero
without the result line:

1. the card: CUDA must be available; torch version, card name and power
   limit;
2. the build of every kernel (one nvcc per source, started together, from
   the checkout);
3. each kernel against its plain PyTorch version on the card, at a small
   shape and at the shapes its path gives it, plus per-block times: the
   lazy-H kernel (12x160, 1000x5000), its instance-partitioned batch entry
   (K=3 of 100x1000 and of 1000x2000), the dense kernel (B=4 and B=32 of
   30x1000, and B=1);
4. the paths, each with its kernel's launch count set to 0 just before it
   and read just after:
   a. the dense sweep: ``dopt_fw_batch(precision="pallas")`` on K=32 of
      30x1000 (instance k from ``np.random.seed(k + 1)``), uniform starts,
      FW-away, eps=1e-8, a 20000 budget; every instance must stop and
      certify by fresh float64 slacks of its final iterate;
   b. the large-m sweep: ``dopt_fw_batch(precision="auto")`` on K=3 of
      1000x2000 (seeds 1, 2, 3) from ``D_opt_KYinit`` starts, FW-away,
      refresh_every=4096, cut to a 20000 budget and eps=1e-7; it must run
      the lazy-H batch kernel, stop every instance and certify it at its
      stop row;
   c. one instance through ``D_opt_FW_away(u_mode="pallas")`` at 30x1000
      to eps=1e-8, against the CPU exact engine;
   d. the main path: ``D_opt_FW_away`` on the 1000x5000 seed-10 design
      from the uniform start, eps=1e-8, the reference's 20741-iteration
      budget, ``u_mode="auto"`` on ``device="cuda"``; it must go through
      the lazy-H kernel and its final iterate must certify against the
      known optimum by a fresh float64 slogdet;
5. the kernels' JSON line, the card line, then the result line
   ``{"ok": true, "device": {...}}``.
"""

import json
import math
import subprocess
import sys
import time

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
# kernel vs plain version on the card, over one 256-iteration block: x, w
# and C to rtol 1e-11 (each array's max-abs scales the atol, for entries
# that cancel to near zero); SP, SN, tau, tau (w_v - 1) to atol 1e-12.
RTOL_STATE = 1e-11
ATOL_HIST = 1e-12


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


def timed_plain(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


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

    # per-block kernel time: CUDA events over back-to-back launches
    reps = 5
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        dl.lazy_block(V, H0, x0, w0, VT=VT, **kw)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    print(f"[kernel] {m}x{n}: {iters} iterations, pivots identical, "
          f"max |kernel - plain| {max(errs):.3e}; per block "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
    return max(errs), ms, plain_ms


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
    ms = time_launches(lambda: dd.dense_block(Vs, Hs, xs, ws, VTs=VTs, **kw),
                       5)
    print(f"[kernel] dense B={B} {m}x{n}: {kmax} iterations each, pivots "
          f"identical, max |kernel - plain| {max(errs):.3e}; per block "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
    return max(errs), ms, plain_ms


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
    ms = time_launches(
        lambda: dl.lazy_block_batch(Vs, H0, x0s, w0, VTs=VTs, **kw), 5)
    print(f"[kernel] lazy batch K={K} {m}x{n}: {dl._KR} iterations each, "
          f"pivots identical, max |kernel - plain| {max(errs):.3e}; per "
          f"block kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
    return max(errs), ms, plain_ms


def dense_designs():
    """The dense sweep's instances: instance k from np.random.seed(k + 1)."""
    Vs = np.empty((DENSE_K, DENSE_M, DENSE_N))
    for k in range(DENSE_K):
        np.random.seed(k + 1)
        Vs[k] = np.random.randn(DENSE_M, DENSE_N)
    return Vs


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
    return launches


def large_sweep(port, dl, dev):
    """Phase 4b; returns the batch kernel's launches in it and the last
    instances (V, x0) for the per-block comparison."""
    Vs = np.empty((LARGE_K, LARGE_M, LARGE_N))
    x0s = np.empty((LARGE_K, LARGE_N))
    for k in range(LARGE_K):
        np.random.seed(k + 1)
        Vs[k] = np.random.randn(LARGE_M, LARGE_N)
        x0s[k] = port.D_opt_KYinit(Vs[k]).numpy()
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
                                             verbose=False, u_mode="exact")
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
    return launches


def main():
    # ---- 1. the card --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{card}", flush=True)

    import accbpg_and_fw_tpu_torch as port
    from accbpg_and_fw_tpu_torch import D_opt_FW_away
    from accbpg_and_fw_tpu_torch.ops import _build
    from accbpg_and_fw_tpu_torch.ops import dopt_dense as dd
    from accbpg_and_fw_tpu_torch.ops import dopt_lazy as dl

    # ---- 2. the build -------------------------------------------------------
    names = ("dopt_lazy", "dopt_dense")
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
    np.random.seed(SEED)
    V64 = np.random.randn(M, N)
    V = torch.tensor(V64, device=dev)
    lazy_err, lazy_ms, lazy_plain_ms = compare_block(dl, V, EPS)

    dense_Vs = torch.tensor(dense_designs(), device=dev)
    compare_dense(dd, dense_Vs[:4].contiguous(), EPS)
    batch_err, batch_ms, batch_plain_ms = compare_dense(dd, dense_Vs, EPS)
    one_err, one_ms, one_plain_ms = compare_dense(
        dd, dense_Vs[:1].contiguous(), EPS)

    mid = torch.tensor(np.random.default_rng(5).standard_normal(
        (3, 100, 1000)), device=dev)
    compare_lazy_batch(dl, mid, torch.full((3, 1000), 1e-3,
                                           dtype=torch.float64, device=dev),
                       EPS)

    # the small slice end to end on the card against the CPU exact engine
    x_s, F_s, _, _, _ = D_opt_FW_away(V_small, np.full(160, 1 / 160), 1e-8,
                                      300, verbose=False,
                                      u_mode="pallas_lazy", device=dev)
    x_e, F_e, _, _, _ = D_opt_FW_away(V_small.cpu(), np.full(160, 1 / 160),
                                      1e-8, 300, verbose=False,
                                      u_mode="exact")
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
    lb_err, lb_ms, lb_plain_ms = compare_lazy_batch(
        dl, torch.tensor(large_Vs, device=dev),
        torch.tensor(large_x0s, device=dev), LARGE_EPS)
    dense_one_launches = single_pallas(port, dd, dev)

    x0 = np.full(N, 1.0 / N)
    dl.LAUNCHES = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    x, F, SP, SN, T = D_opt_FW_away(V64, x0, eps=EPS, maxitrs=REF_ITERS,
                                    verbose=False, device="cuda")
    torch.cuda.synchronize()
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

    # ---- 5. the record ------------------------------------------------------
    def entry(name, source, replaces, launches, err, ms, plain_ms):
        return {"name": name, "route": "cuda",
                "source": f"accbpg_and_fw_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    kernels = [
        entry("dopt_lazy_block", "dopt_lazy.cu",
              "accbpg_and_fw_tpu/ops/pallas_dopt_lazy.py:153", launches,
              lazy_err, lazy_ms, lazy_plain_ms),
        entry("dopt_lazy_block_batch", "dopt_lazy.cu",
              "accbpg_and_fw_tpu/ops/pallas_dopt_lazy.py:899",
              batch_launches, lb_err, lb_ms, lb_plain_ms),
        entry("dopt_dense_block", "dopt_dense.cu",
              "accbpg_and_fw_tpu/ops/pallas_dopt.py:169",
              dense_one_launches, one_err, one_ms, one_plain_ms),
        entry("dopt_dense_block_batch", "dopt_dense.cu",
              "accbpg_and_fw_tpu/ops/pallas_dopt.py:830",
              dense_batch_launches, batch_err, batch_ms, batch_plain_ms),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
