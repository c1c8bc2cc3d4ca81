"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero
without the result line:

1. the card: CUDA must be available; torch version, card name and power
   limit;
2. the build of every kernel on the main path (nvcc, from the checkout);
3. each kernel against its plain PyTorch version on the card, at a small
   shape and at the main path's 1000x5000, plus per-block times;
4. the main path: ``D_opt_FW_away`` on the 1000x5000 seed-10 design from
   the uniform start, eps=1e-8, the reference's 20741-iteration budget,
   ``u_mode="auto"`` on ``device="cuda"``; it must go through the kernel
   and its final iterate must certify against the known optimum by a fresh
   float64 slogdet;
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

    from accbpg_and_fw_tpu_torch import D_opt_FW_away
    from accbpg_and_fw_tpu_torch.ops import _build
    from accbpg_and_fw_tpu_torch.ops import dopt_lazy as dl

    # ---- 2. the build -------------------------------------------------------
    cached = _build.library_path("dopt_lazy").exists()
    t = time.perf_counter()
    _build.load("dopt_lazy")
    print(f"[build] dopt_lazy.cu -> {_build.library_path('dopt_lazy').name} "
          f"in {time.perf_counter() - t:.2f} s"
          f"{' (already built)' if cached else ''}", flush=True)

    # ---- 3. kernel vs plain version -----------------------------------------
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    V_small = torch.tensor(rng.standard_normal((12, 160)), device=dev)
    compare_block(dl, V_small, EPS)
    np.random.seed(SEED)
    V64 = np.random.randn(M, N)
    V = torch.tensor(V64, device=dev)
    max_err, ms, plain_ms = compare_block(dl, V, EPS)

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

    # ---- 4. the main path ---------------------------------------------------
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
    kernels = [{
        "name": "dopt_lazy_block",
        "route": "cuda",
        "source": "accbpg_and_fw_tpu_torch/csrc/dopt_lazy.cu",
        "replaces": "accbpg_and_fw_tpu/ops/pallas_dopt_lazy.py:153",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
