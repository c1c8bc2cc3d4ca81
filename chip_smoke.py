"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --blocks-only [--root DIR] [--solves N]
                          [--gain-iters N]
    python3 chip_smoke.py --micro
    python3 chip_smoke.py --dual-prox
    python3 chip_smoke.py --lookahead
    python3 chip_smoke.py --threefry
    python3 chip_smoke.py --bodies [--extras-only | --fastgram-only |
                                    --fw-only]

With ``--micro`` it builds and runs ``csrc/micro_cluster.cu``: the clocks
of the primitives the cluster kernels are built from (an exchange across a
cluster by a store and the cluster barrier or by ``st.async`` and a
transaction barrier, an IEEE FP64 division, the Newton reciprocal).

With ``--dual-prox`` it builds the dual prox kernel and runs its part of
phase 3 alone (below): the study's prox against the plain loop, the
plan, the clocks per stage and the sweep of layouts.

With ``--threefry`` it builds the threefry kernel and runs its part of
phase 3 alone: both entries against the plain chain, the sweep of the
draw entry's launch shapes, and each call's time per node in a graph and
host cost per eager call.

With ``--bodies`` it measures what the masked loops are chosen from:
ABPG_gain 30x10000 (kernel route) and BPG-LS 30x1000 (default h) under
``driver.eager_chunks`` over their 9000 iterations with ``_loops.TALLY``
(the bodies each loop took, per loop), then each as graph chunks over
2000 iterations at several masked bodies per line search (walls,
continuations, nodes per graph), and one ABPG_gain graph of 256
iterations against one of 32 (nodes, capture seconds); then the four FW
line-search drivers on phase 4i's illcond problem, eagerly first with the
tally, then as graphs at the shipped bodies with the live masked bodies
against those run (``_loops.live_counts``) beside the tally's trials
(``--fw-only`` runs this part alone), then as graphs of 256 and of 32
iterations at the bodies that cover 90%, 99% and 99.9% of their
iterations; then the extras of phase
4k (AIBM, UniversalGM and AdaptFGM on the Poisson problem, the
primal-dual study with its line search) the same way (``--extras-only``
runs this part alone); then the fast_gram paths (ABPG_gain 30x10000,
BPG-LS and ABPG_expo 30x1000 with ``fast_gram=True``) eagerly over their
9000 iterations with both tallies (the loops' bodies, the gates'
fallbacks), then as graphs at the trials, and on ABPG_gain the warm
multiplier's passes, that cover 90%, 99% and 99.9% of them
(``--fastgram-only`` runs this part alone); last, ABPG_gain's first
capture right after its 9000 eager iterations (where a capture once
failed), retried with the collector off and with
``capture_error_mode="thread_local"`` if it fails.

With ``--blocks-only`` it prints only the lazy-H kernel's block times
(1000x5000, and K=3 of 1000x2000), the dense kernel's block times (B=1 and
B=32 of 30x1000, and two shapes whose layout streams V: B=1 of 165x1000 and
B=2 of 200x700), the multiplier's time per call (n = 1000, 10000, 100000:
by events, the kernel's device time in a trace, and the wrapper's host
cost), the dual prox's time at the primal-dual study's 400x10 (two
timings of 10 launches by events), the noise stream's calls (a split, a
400x10 normal draw and a noisy gradient's draw, fused where the commit
has it: the device time per node in a graph beside an empty kernel's,
the host cost per eager call, and the host cost of each part of the
split's wrapper), the top singular pair at 200x20, 600x60, 1000x200 and
1000x1000 in the layouts the commit's plan takes, the stochastic runs through the public drivers as
graphs (SymNMF 200x20 under ABPG_gain and FW_alg_descent_step, AIBM with
noise 1e-6 on the Poisson problem: nodes per graph, warm walls, threefry
launches, digests of the rows as graphs and eagerly, which must agree
across commits bit for bit), the warm walls of the dense sweep and
of one ``u_mode="pallas"`` solve, of ``ABPG_gain`` 30x10000 over
``--gain-iters`` iterations (0: not run) and of ``--solves`` warm
main-path solves, for the package under ``--root`` (default: this file's
directory), through the wrappers that every commit of the port has.
That is how two commits are compared on one card, in ONE call (two calls may land on cards with other power
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
   times as yardsticks of its phases, a launch that enters with the stop
   flag set against the plain version (no row, x and w untouched) and
   its time, and a launch after a smaller design's kernel was prepared in
   between; the dense kernel (B=4 and B=32 of
   30x1000, and B=1: the launch plan, registers and spills, two launches
   from one state bit for bit, and thread 0 of CTA 0's clocks per phase),
   the Burg-simplex multiplier (the first
   prox input of the 30x10000 and 30x1000 paths, n=1 where its bisection
   moves, and random inputs at n = 1000, 10000, 100000: the launch plan,
   ms per call by events, the kernel's device time in a trace, the
   wrapper's host cost over 1000 unsynchronised calls and thread 0 of CTA
   0's clocks per stage of a pass); the noise stream's kernel
   (``csrc/threefry.cu``: its split entry over 3000 links of the chain,
   every other one scaled, keys and uniforms bit for bit, its draw entry
   at 400x10, 200x20 and 100001, bits and uniforms bit for bit and
   normals within 1e-13, and its noise mode (a noisy gradient's split,
   normals, shift, scale and add) with and without the gradient, keys bit
   for bit, values within 1e-13 of the normal times the level of the plain
   version and bit for bit with the unfused launches; the sweep of the
   draw entry's launch shapes, 64/128/256 threads by 1/2 counters a
   thread; each call's time per node in a graph of 500 beside an empty
   kernel's, its host cost per eager call and the split wrapper's parts;
   each entry's time by events beside the plain chain's on the card); the dual
   prox's kernel (``csrc/dual_prox.cu``: the primal-dual study's 400x10
   prox of up to 7000 steps, the same steps and X within 1e-12 of the
   plain loop's largest entry, its time by events and the plain loop's,
   the plan (cluster, threads, elements a thread, registers), thread 0 of
   CTA 0's clocks per stage of a step, every layout of clusters 1-16 and
   1, 2, 4, 8 elements a thread or the arrays in memory held to the
   plain loop and timed, with the clocks of the three fastest; then
   200x100 in registers, the arrays in shared memory at 400x100 and in
   global memory at 1000x1000); the nuclear ball's top singular pair
   (``csrc/top_singular.cu``: one-sided Jacobi, ``outer(u1, v1)``) against
   its plain version within 1e-13 at 6x4, 4x6, 200x20, 20x200, 600x60
   (the ring layout: CTAs that keep a run of pairs' columns in shared
   memory and pass the columns that leave it to the neighbouring CTA),
   a rank-1 7x5 and a zero 4x3, and 200x20 through the streamed layout
   and rings of one, two and five CTAs too: the plan, the sweeps (the
   largest, and none at the bound), the kernels' registers and spills;
   ``[svd sizes]``: 200x20, 600x60, 1000x200 and 1000x1000 in their
   layouts (1e-13, and 1e-12 at the two large ones, of the plain
   version), ms by events beside the bound (the rotations a timed launch
   counted), the streamed layout's ms (the parent commit's design),
   ``torch.linalg.svd``'s and the LMO's before the kernel, and the plain
   version's wall; ``[svd stages]``: thread 0 of CTA 0's clocks per stage
   of a round (dots, rotation, send, wait, the sweep's test) in the ring
   and the streamed layouts at 600x60, 1000x200 and 1000x1000;
   ``[svd sweep]``: ring layouts of other pairs, warps and clusters
   timed beside the plan's (``--svd`` runs these alone; ``--svd --root DIR`` times another
   checkout's top singular pair, as ``--blocks-only`` does);
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
      stop row; then against ``group=1`` in one call (bit for bit; warm
      walls, host reads per sweep, a trace of each);
   c. one instance through ``D_opt_FW_away(u_mode="pallas")`` at 30x1000
      to eps=1e-8, against the CPU exact engine;
   d. the main path: ``D_opt_FW_away`` on the 1000x5000 seed-10 design
      from the uniform start, eps=1e-8, the reference's 20741-iteration
      budget, ``u_mode="auto"`` and no ``device`` (the port's default is
      the card); it must go through the lazy-H kernel and its final
      iterate must certify against the known optimum by a fresh float64
      slogdet, with its host round trips counted (one per group of
      blocks); then against ``group=1`` in one call (bit for bit; warm
      walls, host reads per solve, and a trace of each: device busy and
      idle shares, the kernel's share); then the lookahead on the
      blocks in flight under the benchmark's cap of 100000 (a group of
      256 blocks) against the whole group enqueued (the engine before
      the lookahead), in one call: bit for bit, and ``FROZEN_BLOCKS``,
      ``SKIPPED_BLOCKS``, kernel launches and warm walls a solve
      (``--lookahead`` runs this part alone);
   e. the Bregman path: ``ABPG_gain`` (gamma=2, 9000 iterations) on
      ``D_opt_design(30, 10000, randseed=10, device="cuda")`` with
      ``BurgEntropySimplex(use_pallas=True)``, as graph chunks (one CUDA
      graph per 32 iterations, replayed; the line search, theta's Newton
      and the restart rules inside it): one capture; every prox must
      launch the multiplier kernel (the card's own count of launches and of
      prox calls, which a replay adds to, against the trials of the gain
      history) and land on the simplex (|sum x - 1| <= 1e-8 plus the sum's
      rounding), and the fresh float64 F of the final iterate must reach
      -16.0963 (the reference notebook's numpy run: -16.096434); then the
      same solve under ``driver.eager_chunks`` over 500 iterations, its
      rows against the graph's first 500 (bit for bit, or within 1e-13
      relative where cuBLAS took another algorithm under capture), and a
      traced window of 32 iterations of each (the device's idle share);
      then a checkpoint written at iteration 50 by a graph run and
      resumed as graphs to 100, every row and the iterate bit for bit
      with an uninterrupted graph run of 100 iterations (the file under
      the checkout's ``build/``);
   f. ``BPG`` with its line search (9000 iterations) on the 30x1000 seed-10
      design with the default h on the card, as graph chunks (the prox's
      Newton inside them): the last F row within 1e-7 of the reference's
      -8.62103647488 (its history's last row), the returned iterate (one
      step further) at or below it by a fresh float64 slogdet, and no
      multiplier kernel launch; the eager side run and traces as in e.
      One ``[bregman graph]`` line gives for both: walls, host syncs per
      solve, continuations (iterations run again eagerly after an
      overflow of their masked loops), nodes per graph, capture seconds,
      the graph's memory and the idle shares, beside the eager side run;
   g. the README example's BPG, ABPG, ABPG_expo and ABPG_gain calls
      (``examples/ex_Dopt_random.py``) at 80x200 seed 10 on the card with
      ``use_pallas=True``: finite F, the card's count of multiplier
      launches at least the rows, BPG and ABPG within 0.05 of 17.59 and
      17.585 at 900 iterations; and ABPG_gain for 300 iterations on the
      card against the CPU (the kernel's plain version), F rtol 1e-9 over
      the first 100 rows;
   h. per-iteration costs of the five Bregman drivers at 30x1000 on the
      card, with each h, as graphs and under ``driver.eager_chunks``: host
      syncs (``torch.cuda.set_sync_debug_mode``) and device operations
      (``torch.profiler``) per iteration;
   i. the Frank-Wolfe paths, which launch none of the kernels (their
      counts must stay 0): the five FW drivers on the ``"illcond"``
      logistic problem of ``examples/ex_fw_l0l1.py`` at 1000x1000 (rho
      0.99, 20% flipped labels, l2 ball of radius 25, the port's torch
      generator from seed 63, ``run_regime``'s 2000 iterations and
      ls_ratio 2.2), each as graph chunks (one capture at the cold run,
      none at the warm one; the four line searches' loops as masked
      bodies): finite F that ends below F[0], LOG_STEPS that never
      decrease (``FW_l0l1_log_only``: at least rows - 1), the cold run's
      F bit for bit, an ``eager_chunks`` run of the same 2000 iterations
      whose first 500 rows the graph's must equal bit for bit (or within
      1e-13 relative where cuBLAS took another algorithm under capture,
      then said), the first 200 rows of F within rtol 1e-9 of the port on
      the CPU on the same arrays, and per driver the warm wall, the rows,
      nodes per graph, capture seconds, pool MiB, replays,
      continuations, host syncs per solve, device operations per
      iteration and the device idle share of a traced 100-iteration run,
      beside the eager wall and syncs; ``FW_alg_div_step`` on the three
      ``examples/ex_fw_rs.py`` panels (500 iterations) and
      ``FW_alg_descent_step`` on SymNMF n=200, r=20 with both kernels
      (``examples/ex_params_free_symnmf.py``), each against the CPU on the
      same arrays (rtol 1e-9); and ``examples/ex_fw_rs.py`` (at 100
      iterations) and ``examples/ex_params_free_symnmf.py`` run with their
      import changed to the port's (``examples/ex_fw_l0l1.py`` is left out: it imports
      JAX for its PRNG key, and this script runs without JAX);
   j. "auto": the engine it picks for each D-opt shape this script solves,
      and the walls that set its rule below the lazy size (one warm
      ``D_opt_FW_away`` at 30x1000, 100x1000 and 200x1000 on the exact
      engine, the dense kernel and the lazy kernel; "auto" must pick the
      fastest), then a 30x1000 solve and the K=32 30x1000 sweep under
      "auto", which must run the dense kernel and certify;
   k. the inexact-oracle and constrained drivers at the examples' sizes,
      each as graph chunks (one capture at the cold run, none at the warm
      one) against ``driver.eager_chunks``, every row and the iterate bit
      for bit (or within 1e-13 relative where cuBLAS took another
      algorithm under capture, then said), with the counts of kernel 5,
      of the threefry kernel's two entries and of the dual prox kernel set
      to 0 just before the phase and read just after (no D-opt kernel may
      launch): AIBM (noiseless and with noise 1e-6), AdaptFGM and
      UniversalGM on the 2000x1000 Poisson problem of
      ``examples/ex_aibm_poisson.py`` (seed 1, gamma 2, 500 iterations,
      ``BurgEntropySimplex(eps=1e-7, use_pallas=True)``: kernel 5's
      launches inside each warm graph run at least its rows, the first 30
      rows of F against the port on the CPU at rtol 1e-8), the three on
      the synthetic 700x2000 SVM ball with PolyDiv (100 iterations), the
      primal-dual study of ``examples/ex_primal_dual.py`` (n=400, r=10,
      100 iterations, without and with the line search, against the CPU;
      then 8 iterations with ``SumOf2nd4thPowersDualProxMap`` as h, its
      kernel launched inside the graph), UniversalGM through the
      FW-as-prox adapter on the noisy SymNMF of
      ``examples/ex_universal_fw.py`` (noise 0.1 and 10, the noise
      reaching the run), and a stochastic SymNMF 200x20 (noise 0.05)
      under ABPG_gain and FW_alg_descent_step (200 iterations; the
      threefry kernel's launches inside the graphs); per run the warm
      wall against the eager one, host syncs per solve, continuations,
      nodes per graph, capture seconds, pool MiB and the device idle share
      of a traced run (the SVM ball's not traced); and the four examples'
      ``start()`` with their import changed to the port's (ex_aibm_svm's
      eagerly);
   l. the fast_gram paths as graph chunks, which launch none of the
      eight kernels (their counts go to 0 just before the phase and
      must stay 0):
      ``ABPG_gain(gamma=2, 9000 iterations, fast_gram=True)`` on
      ``D_opt_design(30, 10000, randseed=10)`` with the default
      ``BurgEntropySimplex()`` on the card, whose fresh float64 F must
      reach -16.0963 (phase e's bound): one capture; the wall beside
      phase e's in the same call, host syncs per solve, continuations,
      nodes per graph, capture seconds, pool MiB, the idle share of a
      traced window, and an ``eager_chunks`` run whose 500 rows the
      graph's must equal (bit for bit, or within 1e-13 relative where
      cuBLAS took another algorithm under capture, then said); the gates
      and their fallbacks (``fastgram.TALLY``) and the bodies of each loop
      over a tallied eager run of the first 500 iterations; the
      checkpoint resumed as in e (the fast_gram carry: Grams, inverse,
      logdet and the prox's multiplier); then BPG
      (line search), ABPG, ABPG_expo and ABDA with fast_gram at 30x1000
      seed 10, 150
      iterations, each as graphs (one capture, none at the warm run)
      against ``eager_chunks`` (bit for bit, or 1e-13 as above) and
      against the port on the CPU on the same arrays (rtol 1e-9 over the
      first 30 rows: later rows may part by amplification);
   m. sharding on one card: a world-size-1 NCCL group in this process
      (127.0.0.1, a free port) and ``data_mesh()`` on CUDA;
      ``shard_dopt_problem`` under ABPG_gain(fast_gram=True) at 30x10000
      (100 iterations) and ``shard_dopt_design`` under D_opt_FW_away at
      30x1000 (500 iterations; "auto" must take the exact engine), each as
      graph chunks whose collectives are captured with them (captures
      above 0), their rows bit for bit with the same sharded solve under
      ``eager_chunks`` and within rtol 1e-12 of the unsharded card run (a
      graph), the iterate still a DTensor; the sharded graph's wall (cold,
      with its capture, and warm) beside the sharded eager wall and the
      unsharded graph's; the kernel modes must refuse the sharded design;
      no kernel may launch; then AIBM on
      ``examples/ex_aibm_poisson.py``'s 2000x1000 Poisson problem placed
      by ``shard_regression_problem`` (30 iterations), as graphs against
      ``eager_chunks`` bit for bit, its first 4 rows within rtol 1e-9 of
      the unsharded run (the first row past it reported; only the
      threefry split entry launches, a noise draw an iteration); the group is destroyed.  One card shows the code path
      and its capture, not collectives across cards;
   n. ``diagnostics.profile_trace`` around a short solve (a trace under
      ``build/traces``) and ``debug_mode`` raising on a NaN start; then,
      with no kernel launch, ``examples/ex_Poisson_KL.py``'s ``poisson``
      and ``kl_regression`` (cut to 1000 iterations) and
      ``examples/ex_SymNMF.py``'s ``start`` with the import changed to
      the port's; last ``examples/ex_Dopt_sweep.py``'s
      ``start_full(fast_gram=True)`` (cut to K=1, 150 iterations) with
      its JAX lines replaced (the replacements are printed), whose FW
      rows run "auto" on the card (their kernel launches are printed);
   o. the graph chunk (``algorithms/driver.py``), no kernel launch: the
      exact D-opt engine at 30x1000 (phase 4c's design, eps 1e-8) and
      ``FW_alg_descent_step`` on phase 4i's illcond logistic problem and
      SymNMF (the first h), each captured at its first solve and replayed
      at its second (one capture, none at the second), against the eager
      loop (bit for bit, or within 1e-13 relative where cuBLAS took
      another algorithm under capture, then said) and against the port on
      the CPU from the earlier phase (rtol 1e-9: 300 rows, 200 rows, all
      rows); walls, replays per solve, host launches per chunk (CPU-side
      trace), capture time and the graph's memory; a step that reads a
      value back must make the capture raise;
   p. the LMOs that take arrays, no kernel launch: ``lmo_l2_ball``,
      ``lmo_l2_ball_positive_orthant`` and ``lmo_linf_ball`` with a numpy
      centre on phase 4i's problem and ``lmo_matrix_box`` with numpy
      bounds on SymNMF 200x20, under the five FW drivers (200 iterations)
      as graphs (one capture each) against ``eager_chunks``, bit for bit;
      the nuclear ball under ``FW_alg_descent_step`` and under BPG through
      ``SumOf2nd4thPowersWithFrankWolfe`` on SymNMF 200x20, as graphs (one
      capture each) against ``eager_chunks`` bit for bit, with the walls
      of both, the top-singular-pair kernel's launches on the card (the
      only kernel the phase may launch), counted from a reset just before
      each warm graph run to a read just after it, at least one a row,
      and no solve at the sweep bound;
      and whether ``torch.linalg.svd`` can be captured at all (in a
      process of its own: the record of why the kernel exists);
   q. the a9a path, no kernel launch: a synthetic LIBSVM file of a9a's
      published shape under ``build/`` (32561 rows, 123 binary features,
      14 ones a row, labels +1 / -1, numpy seed 9), parsed by the port's
      native parser (built by ``g++`` into ``build/native``) and by the
      Python parse (equal CSR arrays and labels, both timed), then
      ``L0L1_FW_log_reg_a9a(250, path)`` on the card and
      ``examples/ex_fw_l0l1_a9a.py``'s four runs
      (``FW_alg_L0_L1_shortest_step`` and ``FW_alg_div_step`` with the L2
      and L-inf balls of radius 250, ls_ratio 2, gamma 2, 600 iterations)
      as graph chunks: finite F that ends below F[0];
5. the kernels' JSON line (launches on the path, error against the plain
   version, kernel and plain times, the bound from this run's inputs and
   the time of a PyTorch call for the same function where one exists), the
   card line, then the result line ``{"ok": true, "device": {...}}``.
"""

import argparse
import hashlib
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
LOOKAHEAD_CAP = 100000  # the benchmark's cap: a group of 256 blocks
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
# the Bregman paths' side runs: the eager loop (driver.eager_chunks) over
# BREG_EAGER iterations against the graph's first rows, and a traced window
# of BREG_TRACE iterations of each for the device's idle share (one graph
# span: 256 took the profiler minutes, a graph of 32 iterations holding
# 40-53k nodes)
BREG_EAGER, BREG_TRACE = 500, 32
# the multiplier kernel's Newton stall threshold
SIMPLEX_STALL = 1e-8
# the Frank-Wolfe paths: the "illcond" regime of examples/ex_fw_l0l1.py at
# its 1000x1000 config with run_regime's defaults (2000 iterations,
# ls_ratio 2.2), its first FW_CPU_ROWS rows held against the port on the
# CPU and its first FW_EAGER_ROWS graph rows against eager_chunks, its
# costs over FW_COST_ITERS (100; 200 until the graph phase 4o came, for the
# script's time); the examples/ex_fw_rs.py panels (500
# iterations) and the examples/ex_params_free_symnmf.py run (n=200, r=20,
# 600 iterations)
FW_ILL = dict(seed=63, radius=25.0, rho=0.99, col_scale=1.0, flip_y=0.2,
              noise=0.1)
FW_NS, FW_NF, FW_ITERS, FW_LS_RATIO = 1000, 1000, 2000, 2.2
FW_CPU_ROWS, FW_COST_ITERS, FW_RTOL = 200, 100, 1e-9
FW_EAGER_ROWS = 500
# the FW line searches' masked bodies, by driver (``--bodies``)
FW_BODIES = {"FW_alg_div_step": "DIV_BODIES",
             "FW_alg_L0_L1_shortest_step": "SHORTEST_BODIES",
             "FW_l0l1_log_and_linear_step": "LOG_BODIES",
             "FW_l0l1_log_only": "LOG_ONLY_BODIES"}
# phase 4p: the array-centre LMOs, LMO_ITERS iterations per driver
LMO_ITERS = 200
# phase 4q: a synthetic file of a9a's published shape (LIBSVM's a9a: 32561
# rows, 123 binary features, 13-14 ones per row, 24% positive labels) and
# examples/ex_fw_l0l1_a9a.py's runs (radius 250, 600 iterations, seed 2025)
A9A_ROWS, A9A_FEATURES, A9A_NNZ, A9A_POSITIVE = 32561, 123, 14, 0.24
A9A_SEED, A9A_EXAMPLE_SEED, A9A_RADIUS, A9A_ITERS = 9, 2025, 250.0, 600
FW_RS_ITERS, FW_SYM_N, FW_SYM_R, FW_SYM_ITERS = 500, 200, 20, 600
# examples/ex_fw_rs.py's start() at FW_RS_START_ITERS iterations (500, its
# default, until it was cut for the script's time: 105 s of phase 4i)
FW_RS_START_ITERS = 100
# the single-solve shapes whose walls on the three engines set "auto"
AUTO_SHAPES = ((30, 1000), (100, 1000), (200, 1000))
# the [extras] phase, at the examples' own sizes: examples/ex_aibm_poisson.py
# (Poisson_regr_simplex_acc(2000, 1000, noise=0.001) after seed 1, gamma 2,
# EXP_ITERS iterations (500; 1000 until the graph phase 4o came, for the
# script's time), its first EX_HELD_ROWS rows held against the port on the
# CPU at EX_RTOL, the error over EX_CPU_ROWS reported beside the row where
# the two part past EX_RTOL), examples/ex_aibm_svm.py (the synthetic
# 700x2000 SVM ball), examples/ex_primal_dual.py's figure (n=400, r=10;
# with the dual prox as h over PD_DUAL_ITERS) and examples/ex_universal_fw.py
# (n=400, r=1, noise 0.1 and 10), EX_ITERS iterations each (100; 200 until
# the fast_gram, sharding and examples phases came, for the script's
# time); a stochastic SymNMF 200x20 under ABPG_gain and
# FW_alg_descent_step over STOCH_ITERS; each as graphs against
# eager_chunks, the idle share over a traced EX_COST_ITERS (40, a quarter
# of it for the SVM ball)
EXP_M, EXP_N, EXP_ITERS, EXP_GAMMA = 2000, 1000, 500, 2.0
EX_ITERS, EX_CPU_ROWS, EX_HELD_ROWS, EX_RTOL = 100, 100, 30, 1e-8
EX_COST_ITERS, PD_DUAL_ITERS, STOCH_ITERS = 40, 8, 200
PD_N, PD_R, UFW_N, UFW_R, UFW_NOISES = 400, 10, 400, 1, (0.1, 10.0)
# phase 4l: the fast_gram paths (ABPG_gain at GAIN_M x GAIN_N for
# GAIN_ITERS, as graphs since the fast_gram graphs came, which left its
# per-iteration cost windows out: a traced span of them holds ~103000
# device operations, and the [bregman graph] line has syncs, nodes and the
# idle share; the other four drivers at BPG_M x BPG_N for FG_SMALL_ITERS
# (150 since phase 4o came, 300 before), their first FG_CPU_ROWS rows
# against the CPU at FG_RTOL: later rows may part by amplification)
FG_SMALL_ITERS, FG_CPU_ROWS, FG_RTOL = 150, 30, 1e-9
# the gates' fallbacks are tallied over an eager run of the first
# FG_TALLY_ITERS iterations (one read per gate; they gather there); the
# host loop the fast_gram steps ran as before their graphs took
# FG_HOST_LOOP_S on an "NVIDIA H100 80GB HBM3, 700.00 W" (PERF.md)
FG_TALLY_ITERS, FG_HOST_LOOP_S = 500, "60-94 s"
# phases 4e and 4l: a checkpoint written at CKPT_ITERS and resumed to
# 2 CKPT_ITERS
CKPT_ITERS = 50
# phase 4m: the sharded solves on a one-card mesh; AIBM on a sample-sharded
# Poisson problem of examples/ex_aibm_poisson.py's 2000x1000 over
# SH_AIBM_ITERS iterations
SH_GAIN_ITERS, SH_FW_ITERS, SH_AIBM_ITERS = 100, 500, 30
# ... its first SH_AIBM_HELD rows held to the unsharded run at 1e-9
SH_AIBM_HELD = 4
# phase 4n: examples/ex_Dopt_sweep.py's start_full and ex_Poisson_KL.py's
# runs, cut for the time
SWEEP_K, SWEEP_ITERS, EXAMPLE_ITERS = 1, 150, 1000
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
# INT32 operations/s: 132 SMs x 64 INT32 lanes x the 1.98 GHz boost clock
# (H100 SXM; the Hopper white paper's SM)
PEAK_INT32 = 132 * 64 * 1.98e9
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


def bound(nbytes, flops, int_ops=0):
    """The least time (ms) the card could take: bytes over the HBM rate,
    FP64 operations over the peak rate or INT32 operations over theirs,
    whichever is largest, and which ("bytes" or "operations")."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(flops / PEAK_FP64, int_ops / PEAK_INT32) * 1e3
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
    frozen_us = frozen_launch(dl, kernel, V, H0, x0, w0, eps)
    bound_ms, bound_by = lazy_bound(m, n, [nrun])
    plan = kernel.plan
    print(f"[kernel] {m}x{n}: {iters} iterations, pivots identical, two "
          f"launches bit for bit, max |kernel - plain| {max(errs):.3e}; per "
          f"block kernel {ms:.3f} ms ({ms * 1e3 / max(nrun, 1):.2f} us per "
          f"iteration), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms (by "
          f"{bound_by}); a launch entering stopped {frozen_us}, state "
          f"untouched; {plan.group} CTAs of {plan.col_base}-"
          f"{plan.col_base + (plan.col_extra > 0)} columns, {plan.resident} "
          f"resident in {plan.smem_bytes} B of shared memory, the rest "
          f"streamed; {kernel.regs} registers per thread", flush=True)
    return max(errs), ms, plain_ms, bound_ms, bound_by


def frozen_launch(dl, kernel, V, H0, x0, w0, eps):
    """A launch that enters with the stop flag set (the rest of a group
    after a stop by eps) against the plain version: no row, misc [1, 0, 1,
    0], x and w handed through bit for bit; returns its time per call
    (us: by CUDA events over back-to-back calls, paced by the wrapper,
    and the kernel's device time in a trace), the flag carried on the card
    from launch to launch."""
    run = dict(eps=eps, kmax=dl._KR, away=True, xtol=1e-8)
    out = kernel.run(H0, x0, w0, done=True, **run)
    ref = dl.lazy_block_reference(V, H0, x0, w0, done=True, **run)
    torch.cuda.synchronize()
    if not (out.misc.cpu().tolist() == ref.misc.tolist() == [1.0, 0.0, 1.0,
                                                             0.0]
            and torch.equal(out.x, x0) and torch.equal(out.w, w0)):
        raise AssertionError(f"a stopped launch changed the state: misc "
                             f"{out.misc.cpu().tolist()}")
    def call():
        return kernel.run(H0, x0, w0, **run)

    us = time_launches(call, 50) * 1e3
    device_us = kernel_device_us(call, "dopt_lazy_kernel", 20)
    if int(kernel._done[0]) != 1:
        raise AssertionError("the stop flag did not stay set on the card")
    return f"{us_text(device_us)} device time in a trace, {us:.2f} us " \
        f"per call by events"


def count_reads(dl):
    """Count the lazy kernel's host reads (``_LazyKernel.host_rows``, one
    per group): returns a one-element list that the wrapper adds to."""
    reads = [0]
    rows = dl._LazyKernel.host_rows

    def counted(self, *args, **kwargs):
        reads[0] += 1
        return rows(self, *args, **kwargs)

    dl._LazyKernel.host_rows = counted
    return reads


def warm_walls(runs, reps=2):
    """``{name: [wall, ...]}`` of ``reps`` alternating warm calls of each
    of ``runs`` (``{name: fn}``), each returning its host reads."""
    out = {name: [] for name in runs}
    for _ in range(reps):
        for name, fn in runs.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            reads = fn()
            torch.cuda.synchronize()
            out[name].append((time.perf_counter() - t, reads))
    return out


def walls_reads_text(walls):
    return "; ".join(
        f"{name}: " + " ".join(f"{w:.4f}" for w, _ in v) + " s, "
        f"{v[-1][1]} host reads" for name, v in walls.items())


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
    iters, worst = certify_dense_sweep(Vs, x, SP, SN)
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


def certify_dense_sweep(Vs, x, SP, SN):
    """Every instance of a dense sweep stopped and certifies by fresh
    float64 slacks at its recorded stop row; returns (iterations to eps
    per instance, the worst fresh slack)."""
    xs = x.cpu().numpy()
    iters, worst = [], 0.0
    for k in range(len(Vs)):
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
    return iters, worst


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
    default = lambda: port.dopt_fw_batch(  # noqa: E731
        Vs, x0s, LARGE_EPS, LARGE_BUDGET, away=True, precision="auto",
        refresh_every=LARGE_REFRESH, device=dev)
    one = lambda: dl.dopt_fw_lazy_batch(  # noqa: E731
        Vs, x0s, LARGE_EPS, LARGE_BUDGET, away=True,
        refresh_every=LARGE_REFRESH, device=dev, group=1)
    ref = one()
    if not (torch.equal(ref[0], x) and all(
            np.array_equal(p, q) for p, q in zip(ref[1:], (F, SP, SN)))):
        raise AssertionError("large sweep: the default group and group=1 "
                             "differ")
    walls = warm_walls({"default group": lambda: reads_of(default),
                        "group=1": lambda: reads_of(one)})
    group = dl._group_size(LARGE_BUDGET, LARGE_REFRESH, False, 32)
    print(f"[large sweep] default group ({group} blocks) against group=1 "
          f"in one call, "
          f"x, F, SP, SN bit for bit; warm walls and host reads per sweep: "
          f"{walls_reads_text(walls)}", flush=True)
    trace_line(f"large sweep K={LARGE_K} of {LARGE_M}x{LARGE_N}", default,
               "dopt_lazy_kernel")
    trace_line(f"large sweep K={LARGE_K} of {LARGE_M}x{LARGE_N} group=1",
               one, "dopt_lazy_kernel")
    return launches, Vs, x0s


READS = [0]  # the lazy kernel's host reads, counted from main()
# runs on the CPU (and problems) that phase 4o holds its graphs against,
# kept from the phases that made them
CPU_RUNS = {}


def reads_of(run):
    """The lazy kernel's host reads in one call of ``run``."""
    before = READS[0]
    run()
    return READS[0] - before


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
    CPU_RUNS["exact"] = (V, x0, Fe)
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


def auto_walls(port):
    """The walls that set ``u_mode="auto"``'s thresholds below the lazy
    size: one ``D_opt_FW_away`` solve (seed 1, uniform start, eps 1e-8, the
    dense budget) per shape of AUTO_SHAPES on each of the three engines,
    warm (the kernels' engines run once before the timed solve; the exact
    engine after a 300-iteration solve of the shape, which captures its
    graph chunk).  Returns ``{(m, n): {engine: (wall, iterations)}}``."""
    out = {}
    for m, n in AUTO_SHAPES:
        np.random.seed(1)
        V = np.random.randn(m, n)
        x0 = np.full(n, 1.0 / n)
        row = {}
        for engine in ("exact", "pallas", "pallas_lazy"):
            port.D_opt_FW_away(V, x0, EPS,
                               300 if engine == "exact" else DENSE_BUDGET,
                               verbose=False, u_mode=engine)
            torch.cuda.synchronize()
            t = time.perf_counter()
            x, F, SP, SN, _ = port.D_opt_FW_away(V, x0, EPS, DENSE_BUDGET,
                                                 verbose=False,
                                                 u_mode=engine)
            torch.cuda.synchronize()
            row[engine] = (time.perf_counter() - t, len(F))
            sp, sn, _ = fresh_slacks(V, x.cpu().numpy())
            if len(F) < DENSE_BUDGET and not (sp <= EPS + DENSE_CERT_TOL
                                              and sn <= EPS + DENSE_CERT_TOL):
                raise AssertionError(f"{engine} {m}x{n}: stopped with fresh "
                                     f"slacks {sp:.3e}/{sn:.3e}")
        out[(m, n)] = row
    return out


def auto_sweep_walls(port):
    """The sweeps' counterpart of ``auto_walls``: K=3 instances of each of
    AUTO_SHAPES (instance k from ``np.random.seed(k + 1)``, starts 1e-3,
    eps 1e-8, the dense budget) on the dense and the lazy batch kernels,
    warm.  Returns ``{(m, n): {engine: (wall, rows)}}``."""
    out = {}
    for m, n in AUTO_SHAPES:
        Vs = np.empty((3, m, n))
        for k in range(3):
            np.random.seed(k + 1)
            Vs[k] = np.random.randn(m, n)
        row = {}
        for engine in ("pallas", "pallas_lazy"):
            run = lambda: port.dopt_fw_batch(  # noqa: E731
                Vs, np.full((3, n), 1e-3), EPS, DENSE_BUDGET,
                precision=engine)
            run()
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, F, _, _ = run()
            torch.cuda.synchronize()
            row[engine] = (time.perf_counter() - t, F.shape[1])
        out[(m, n)] = row
    return out


def walls_text(walls):
    return "; ".join(
        f"{m}x{n}: " + ", ".join(f"{e} {w:.4f} s ({it} it)"
                                 for e, (w, it) in row.items())
        for (m, n), row in walls.items())


def auto_phase(port, dd, card):
    """Phase 4j: which engine "auto" picks for each D-opt shape this script
    solves, the walls of step 0 (``auto_walls``; "auto" must pick the
    fastest engine at each of AUTO_SHAPES), then one single 30x1000 solve
    and the K=32 30x1000 sweep under "auto": both must run the dense
    kernel and certify."""
    from accbpg_and_fw_tpu_torch.algorithms.d_opt import _resolve_auto_u_mode
    from accbpg_and_fw_tpu_torch.parallel.batched import (
        _resolve_auto_batch_precision)

    dev = torch.device("cuda")

    def meta(*shape):
        return torch.empty(shape, device="meta")

    picks = {f"{m}x{n}": _resolve_auto_u_mode(meta(m, n), "auto", dev)
             for m, n in ((M, N), (12, 160)) + AUTO_SHAPES}
    picks.update({f"K={k} of {m}x{n}": _resolve_auto_batch_precision(
        meta(k, m, n), dev) for k, m, n in (
            (DENSE_K, DENSE_M, DENSE_N), (LARGE_K, LARGE_M, LARGE_N))})
    want = {f"{M}x{N}": "pallas_lazy", f"{DENSE_M}x{DENSE_N}": "pallas",
            f"K={DENSE_K} of {DENSE_M}x{DENSE_N}": "pallas",
            f"K={LARGE_K} of {LARGE_M}x{LARGE_N}": "pallas_lazy"}
    for key, engine in want.items():
        if picks[key] != engine:
            raise AssertionError(f"auto picks {picks[key]} for {key}, not "
                                 f"{engine}")
    picks.update({f"K=3 of {m}x{n}": _resolve_auto_batch_precision(
        meta(3, m, n), dev) for m, n in AUTO_SHAPES})
    walls, sweeps = auto_walls(port), auto_sweep_walls(port)
    for prefix, table in (("", walls), ("K=3 of ", sweeps)):
        for (m, n), row in table.items():
            fastest = min(row, key=lambda e: row[e][0])
            if picks[f"{prefix}{m}x{n}"] != fastest:
                raise AssertionError(
                    f"auto picks {picks[f'{prefix}{m}x{n}']} for {prefix}"
                    f"{m}x{n}; the fastest was {fastest}")

    np.random.seed(1)
    V = np.random.randn(DENSE_M, DENSE_N)
    x0 = np.full(DENSE_N, 1.0 / DENSE_N)
    dd.LAUNCHES = 0
    x, F, SP, SN, _ = port.D_opt_FW_away(V, x0, EPS, DENSE_BUDGET,
                                         verbose=False)
    single = dd.LAUNCHES
    sp, sn, fresh_F = fresh_slacks(V, x.cpu().numpy())
    if not (single >= 1 and sp <= EPS + DENSE_CERT_TOL
            and sn <= EPS + DENSE_CERT_TOL
            and abs(fresh_F - F[-1]) <= 1e-9 * abs(F[-1])):
        raise AssertionError(f"auto 30x1000: {single} dense launches, fresh "
                             f"slacks {sp:.3e}/{sn:.3e}")
    Vs = dense_designs()
    dd.LAUNCHES = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    xb, _, SPb, SNb = port.dopt_fw_batch(
        Vs, np.full((DENSE_K, DENSE_N), 1.0 / DENSE_N), EPS, DENSE_BUDGET,
        precision="auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    sweep = dd.LAUNCHES
    if sweep < 1:
        raise AssertionError("the auto sweep made no dense kernel launch")
    iters, worst = certify_dense_sweep(Vs, xb, SPb, SNb)
    print(f"[auto] engines under auto on cuda: "
          + ", ".join(f"{k} {v}" for k, v in picks.items())
          + f"; walls, one warm D_opt_FW_away per engine (seed 1, eps 1e-8; "
          f"{card}): {walls_text(walls)}; K=3 sweeps (seeds 1-3, "
          f"starts 1e-3): {walls_text(sweeps).replace(' it)', ' rows)')}; "
          f"auto is the fastest at each; "
          f"single {DENSE_M}x{DENSE_N} under auto: {single} dense launches, "
          f"{len(F)} iterations, fresh slacks {sp:.2e}/{sn:.2e}; sweep "
          f"K={DENSE_K} under auto: {sweep} dense launches in {wall:.3f} s, "
          f"{len(iters)}/{DENSE_K} fresh-certified (worst {worst:.3e})",
          flush=True)


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



# ---- the noise stream's and the dual prox's kernels ----------------------------

# the chain entries held against the plain chain (bit for bit), the draws'
# shapes (the primal-dual study's 400x10 and the SymNMF factors) and the
# normals' bar: the card's erfinv against torch's on the CPU
THREEFRY_LINKS, THREEFRY_SHAPES, NORMAL_RTOL = 3000, ((400, 10), (200, 20),
                                                      (100001,)), 1e-13
# a stochastic oracle's noise: (normal - NOISE_SHIFT) * NOISE_LEVEL added to
# its gradient (FrobeniusSymLoss at the paths' noise 0.05); the inexact
# drivers' scale (AIBM's noise=1e-6)
NOISE_SHIFT, NOISE_LEVEL, SPLIT_SCALE = 0.5, 0.05, 1e-6
# the draw entry's launch shapes swept (threads a block, counters a
# thread), at the paths' n and at THREEFRY_SHAPES' largest
DRAW_PLANS = tuple((t, c) for t in (64, 128, 256) for c in (1, 2))
# launches a graph of back-to-back nodes holds, to time one node
GRAPH_NODES = 500
# threefry2x32's integer operations a hash, counted from csrc/threefry.cu:
# 20 rounds of add, rotate (one funnel shift) and xor, the 2 initial and
# 15 injection adds, the key schedule's 2 xors
HASH_INT_OPS = 79
# FP64 operations an element: the normal's map (multiply, add, max),
# erfinv (~40) and sqrt(2) times it, and the uniform's conversion; the
# noise's shift, scale and add
NORMAL_FP64_OPS, NOISE_FP64_OPS = 45, 3


def threefry_bound(n, mode):
    """Bound of one launch: the bytes (the key read once, a ``"noise"``
    base read once, the values and keys written once), the hashes'
    integer operations at PEAK_INT32 and the FP64 operations at PEAK_FP64,
    whichever time is largest.  ``"split"``: three hashes, the scale read
    and the uniform times it; ``"normal"``: n hashes and normals of a draw
    key; ``"noise"``: the split's two hashes, n hashes and normals, the
    shift, scale and add."""
    if mode == "split":
        return bound(16 + 8 + 40, 3, 3 * HASH_INT_OPS)
    if mode == "normal":
        return bound(16 + 8 * n, NORMAL_FP64_OPS * n, HASH_INT_OPS * n)
    return bound(16 + 16 * n + 32, (NORMAL_FP64_OPS + NOISE_FP64_OPS) * n,
                 HASH_INT_OPS * (n + 2))


def graph_node_us(fn, nodes=GRAPH_NODES, reps=5):
    """Device time (us) per node of a graph of ``nodes`` back-to-back calls
    of ``fn``, captured once and replayed ``reps`` times between CUDA
    events (after one warm-up replay)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        for _ in range(nodes):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    us = start.elapsed_time(end) / (reps * nodes) * 1e3
    del graph
    return us


def chained(step, k):
    """A call that advances the chain key ``k`` by ``step(key)``'s first
    output at each call (a chain of dependent launches, as a driver's)."""
    state = [k]

    def call():
        state[0] = step(state[0])[0]

    return call


def noisy_draw(rng):
    """One noisy gradient's draw of ``rng`` (an ``_rng`` module of any
    commit) on a chain key: ``(next key, G + (normal - 0.5) * 0.05)``, the
    fused call where the module has it, else the split, the normal draw
    and the three tensor operations."""
    fused = getattr(rng, "split_noise", None)
    if fused is not None:
        def draw(k, G):
            nxt, _, g = fused(k, G.shape, NOISE_SHIFT, NOISE_LEVEL, G)
            return nxt, g
    else:
        def draw(k, G):
            nxt, sub = rng.split(k)
            return nxt, G + (rng.normal(sub, G.shape) - NOISE_SHIFT) \
                * NOISE_LEVEL
    return draw


def threefry_walls(rng, dev):
    """Each public call of the noise stream of ``rng`` (this commit's or a
    parent's) on the card, timed two ways: the device time per node in a
    graph of GRAPH_NODES back-to-back launches (chained keys), beside an
    empty kernel's node (``torch.cuda._sleep(0)``: the launch floor), and
    the host cost per eager call (unsynchronised calls); then the host cost
    of each part of the split's wrapper.  Returns the text."""
    k = rng.key(2**40 + 7, dev)
    sub = rng.split(k)[1]
    G = torch.tensor(np.random.default_rng(4).standard_normal((400, 10)),
                     device=dev)
    draw = noisy_draw(rng)
    calls = {
        "split": (rng.split_uniform, lambda: rng.split_uniform(k)),
        "normal 400x10": (None, lambda: rng.normal(sub, (400, 10))),
        "noisy gradient draw 400x10": (lambda kk: draw(kk, G),
                                       lambda: draw(k, G)),
    }
    if hasattr(rng, "split_noise"):
        scale = torch.tensor(SPLIT_SCALE, dtype=torch.float64, device=dev)
        calls["split with scale"] = (
            lambda kk: rng.split_uniform(kk, scale),
            lambda: rng.split_uniform(k, scale))
    floor = graph_node_us(lambda: torch.cuda._sleep(0))
    parts = [f"empty kernel {floor:.3f} us a node"]
    for name, (step, call) in calls.items():
        node = graph_node_us(call if step is None else chained(step, k))
        parts.append(f"{name} {node:.3f} us a node, host "
                     f"{host_cost_us(call):.2f} us a call")
    return "; ".join(parts) + "; split wrapper's parts: " + split_parts(rng, k)


def split_parts(rng, k):
    """Host cost (us) of each step a split's wrapper takes, in ``rng``'s
    form (a parent's: a check, ``contiguous``, two ``torch.empty``, the
    count's lookup, the stream, the ctypes launch, two slices; this
    commit's: the key check, ``get_device``, one ``new_empty``, the bound
    entries and counts, the stream, the launch, the views), each over
    unsynchronised calls less an empty call's cost."""
    dev, index = k.device, k.get_device()
    lib = rng._kernel_lib()
    out = torch.empty(5, dtype=torch.int64, device=dev)
    # the third pointer is the uniform's (a parent's) or the scale's (1.0)
    third = torch.ones((), dtype=torch.float64, device=dev)
    count = rng._device_count(dev, "split")
    stream = torch._C._cuda_getCurrentRawStream
    steps = {"check": lambda: rng._check(k),
             "k.device": lambda: k.device,
             "contiguous": lambda: k.contiguous(),
             "torch.empty int64[4]": lambda: torch.empty(
                 4, dtype=torch.int64, device=dev),
             "torch.empty float64 0-d": lambda: torch.empty(
                 (), dtype=torch.float64, device=dev),
             "count lookup": lambda: rng._device_count(dev, "split"),
             "stream": lambda: stream(index),
             "data_ptr": lambda: k.data_ptr(),
             "ctypes launch": lambda: lib.threefry_split_run(
                 k.data_ptr(), out.data_ptr(), third.data_ptr(),
                 count.data_ptr(), index, stream(index)),
             "slice": lambda: out[:2]}
    if hasattr(rng, "_card_key"):
        u = out.split((2, 2, 1))[2]
        steps.update({"key check": lambda: rng._card_key(k),
                      "get_device": lambda: k.get_device(),
                      "new_empty(5)": lambda: k.new_empty(5),
                      "bound entries": rng._bound,
                      "count pointers": lambda: rng._count_ptrs(index),
                      "split views": lambda: out.split((2, 2, 1)),
                      "uniform view": lambda: u.view(
                          torch.float64).view(())})
    empty = host_cost_us(lambda: None, 2000)
    text = [f"{name} {host_cost_us(fn, 300) - empty:.2f}"
            for name, fn in steps.items()]
    return ", ".join(text) + f" us (an empty call {empty:.2f} us)"


def compare_threefry(dev):
    """Kernel ``csrc/threefry.cu`` against ``_rng``'s plain chain: the split
    entry over THREEFRY_LINKS links, with and without a scale (next key,
    draw key and uniform bit for bit); the draw entry at THREEFRY_SHAPES
    (bits and uniforms bit for bit, normals within NORMAL_RTOL) and in its
    noise mode with and without a base (keys bit for bit, values within
    NORMAL_RTOL of the normal times the level, and bit for bit with the
    unfused launches); the sweep of its launch shapes; each entry's time
    by events, per node in a graph and the host cost per call (the
    sweep's and the walls' lines); the plain versions' on the card; the
    bounds.  Returns ``(split record, draw record)``, each ``(err, ms,
    plain_ms, bound_ms, bound_by)``: the split with its scale, the draw in
    its noise mode at 400x10 (what the paths launch), ``ms`` the device
    time per node in a graph."""
    from accbpg_and_fw_tpu_torch import _rng

    scale_c = torch.tensor(SPLIT_SCALE, dtype=torch.float64, device=dev)
    kc, kp = _rng.key(2**40 + 7, dev), _rng.key(2**40 + 7)
    for link in range(THREEFRY_LINKS):
        scaled = link % 2 == 1
        nc, sc, uc = _rng.split_uniform(kc, scale_c if scaled else None)
        np_, sp, up = _rng.split_uniform(kp, scale_c.cpu() if scaled
                                         else None)
        if not (torch.equal(nc.cpu(), np_) and torch.equal(sc.cpu(), sp)
                and torch.equal(uc.cpu(), up)):
            raise AssertionError("threefry split differs from the plain "
                                 "chain")
        kc, kp = nc, np_
    errs, noise_errs = [], []
    for shape in THREEFRY_SHAPES:
        hc, lc = _rng.bits(sc, shape)
        hp, lp = _rng.bits(sp, shape)
        uc = _rng._draw(sc, shape, "uniform")
        if not (torch.equal(hc.cpu(), hp) and torch.equal(lc.cpu(), lp)
                and torch.equal(uc.cpu(), _rng._draw(sp, shape, "uniform"))):
            raise AssertionError(f"threefry draw {shape} differs in its bits")
        zc, zp = _rng.normal(sc, shape).cpu(), _rng.normal(sp, shape)
        rel = float(((zc - zp).abs() / zp.abs()).max())
        if not rel <= NORMAL_RTOL:
            raise AssertionError(f"threefry normals {shape}: {rel:.3e} > "
                                 f"{NORMAL_RTOL}")
        errs.append(float((zc - zp).abs().max()))
        G = torch.tensor(np.random.default_rng(len(errs)).standard_normal(
            shape))
        for base in (G, None):
            got = _rng.split_noise(kc, shape, NOISE_SHIFT, NOISE_LEVEL,
                                   None if base is None else base.to(dev))
            ref = _rng.split_noise(kp, shape, NOISE_SHIFT, NOISE_LEVEL, base)
            unfused = (*_rng.split(kc), (_rng.normal(_rng.split(kc)[1], shape)
                                         - NOISE_SHIFT) * NOISE_LEVEL)
            if base is not None:
                unfused = unfused[:2] + (base.to(dev) + unfused[2],)
            if not (torch.equal(got[0].cpu(), ref[0])
                    and torch.equal(got[1].cpu(), ref[1])
                    and all(torch.equal(a, b) for a, b in zip(got, unfused))):
                raise AssertionError(f"threefry noise {shape}: keys differ "
                                     "or the values part from the unfused "
                                     "launches")
            z = _rng.normal(ref[1], shape)
            diff = (got[2].cpu() - ref[2]).abs()
            bar = (NORMAL_RTOL * z.abs() * NOISE_LEVEL
                   + 2 * torch.from_numpy(np.spacing(ref[2].abs().numpy())))
            if not bool((diff <= bar).all()):
                raise AssertionError(f"threefry noise {shape}: off the plain "
                                     f"version by {float(diff.max()):.3e}")
            noise_errs.append(float(diff.max()))
    print(f"[threefry] split over {THREEFRY_LINKS} links (every other one "
          f"scaled by {SPLIT_SCALE}) bit for bit with the plain chain; draws "
          f"{list(THREEFRY_SHAPES)}: bits and uniforms bit for bit, normals "
          f"within {max(errs):.1e} (bar {NORMAL_RTOL} relative); noise mode "
          f"(G + (normal - {NOISE_SHIFT}) * {NOISE_LEVEL}, and without G): "
          f"keys bit for bit, values within {max(noise_errs):.1e} of the "
          "plain version and bit for bit with the unfused launches",
          flush=True)
    threefry_sweep(_rng, dev)
    print(f"[threefry walls] {threefry_walls(_rng, dev)}", flush=True)

    kd = _rng.key(1, dev)
    G = torch.tensor(np.random.default_rng(4).standard_normal((400, 10)),
                     device=dev)

    def scaled_split(kk):
        return _rng.split_uniform(kk, scale_c)

    def noise(kk):
        return _rng.split_noise(kk, (400, 10), NOISE_SHIFT, NOISE_LEVEL, G)

    # the kernels' time: the device's per node of a graph of chained
    # launches (events around eager calls read the wrapper's host pace)
    split_ms = graph_node_us(chained(scaled_split, kd)) * 1e-3
    draw_ms = graph_node_us(chained(noise, kd)) * 1e-3
    split_ev = time_launches(lambda: scaled_split(kd), 2000)
    draw_ev = time_launches(lambda: noise(kd), 2000)

    def plain(fn):
        # the plain chain's torch operations on the card's tensors
        fn()
        return time_launches(fn, 50)

    split_plain = plain(lambda: scale_c * _rng.uniform_reference(
        _rng.split_reference(kd)[1]))
    draw_plain = plain(lambda: _rng.split_noise_reference(
        kd, (400, 10), NOISE_SHIFT, NOISE_LEVEL, G))
    split_rec = (0.0, split_ms, split_plain) + threefry_bound(0, "split")
    draw_rec = ((max(errs + noise_errs), draw_ms, draw_plain)
                + threefry_bound(4000, "noise"))
    floor = graph_node_us(lambda: torch.cuda._sleep(0))
    print(f"[threefry] per node in a graph / by events around eager calls: "
          f"scaled split {split_ms * 1e3:.3f} / {split_ev * 1e3:.2f} us "
          f"(plain chain on the card {split_plain * 1e3:.1f} us), a 400x10 "
          f"noisy gradient's draw {draw_ms * 1e3:.3f} / {draw_ev * 1e3:.2f} "
          f"us (plain {draw_plain * 1e3:.1f} us); bounds "
          f"{split_rec[3] * 1e3:.5f} us "
          f"({split_rec[4]}) / {draw_rec[3] * 1e3:.5f} us ({draw_rec[4]}; "
          f"the hash counted: {HASH_INT_OPS} INT32 operations at "
          f"{PEAK_INT32:.3e}/s); the launch floor, an empty kernel's node, "
          f"{floor:.3f} us; {card_line()}", flush=True)
    return split_rec, draw_rec


def threefry_sweep(rng, dev):
    """The draw entry's noise mode at each of DRAW_PLANS, at the paths'
    400x10 and at 100001: bit for bit with the default plan, the device
    time per node in a graph and by events per eager call."""
    rows = []
    for shape in ((400, 10), (100001,)):
        k = rng.key(6, dev)
        G = torch.tensor(np.random.default_rng(6).standard_normal(shape),
                         device=dev)
        ref = rng.split_noise(k, shape, NOISE_SHIFT, NOISE_LEVEL, G)
        cells = []
        for plan in DRAW_PLANS:
            def call(kk=k, plan=plan):
                return rng._noise_cuda(kk, shape, NOISE_SHIFT, NOISE_LEVEL,
                                       G, plan)

            if not all(torch.equal(a, b) for a, b in zip(call(), ref)):
                raise AssertionError(f"threefry noise {shape} at {plan} "
                                     "differs from the default plan")
            node = graph_node_us(chained(lambda kk: call(kk), k))
            ms = time_launches(call, 500)
            cells.append(f"{plan[0]}x{plan[1]} {node:.3f} / "
                         f"{ms * 1e3:.2f}")
        rows.append(f"n={math.prod(shape)}: " + ", ".join(cells))
    print(f"[threefry sweep] noise mode, threads x counters a thread: us a "
          f"node in a graph / us a call by events; default "
          f"{rng.DRAW_PLAN}: " + "; ".join(rows), flush=True)


def dual_prox_bound(n, steps):
    """Bound of one dual prox: G and y read once, X and the step count
    written once; ~60 FP64 operations an element a step (the three
    gradients, three projections, four dots and the updates)."""
    return bound(8 * (3 * n + 1), 60 * n * steps)


def study_prox(port, dev):
    """The primal-dual study's 400x10 prox input: ``(G, X0, kw)``, its
    gradient at its start and the oracle's constants as ``dual_prox``
    takes them (alpha and sigma of the study's h, num_iters 7000)."""
    f, _, h, _, X0 = pd_instance(port, dev)
    hd = port.SumOf2nd4thPowersDualProxMap(alpha=h.alpha, sigma=h.sigma)
    G = f.grad(X0) + hd.grad(X0)
    kw = dict(alpha=hd.alpha, sigma=hd.sigma, num_iters=hd.num_iters,
              eta_base=hd.eta_base, tol=hd.tolerance, radius=hd.radius)
    return G, X0, kw


def plan_text(dp, plan):
    regs, _, spill, _ = dp.kernel_info(torch.cuda.current_device(),
                                       plan.per_thread)
    return (f"{plan.cluster} CTA x {plan.threads} threads, "
            f"{plan.per_thread} a thread, {plan.layout}, {regs} registers, "
            f"{spill} B spilled")


def compare_dual_prox(port, dev):
    """Kernel ``csrc/dual_prox.cu`` against the plain loop
    (``ops/dual_prox.py::dual_prox_reference``, on the card's tensors): the
    primal-dual study's 400x10 prox (``study_prox``): the same step count,
    X within 1e-12 of the plain loop's largest entry, the kernel's ms by
    events and the plain loop's wall, the plan, thread 0 of CTA 0's clocks
    per stage and the sweep of layouts; then shapes the study does not
    reach, in registers (200x100), the arrays in shared memory (400x100)
    and in global memory (1000x1000, 60 steps), against the plain loop
    the same way.  Returns ``(err, ms, plain_ms, bound_ms,
    bound_by)`` of the 400x10 prox."""
    from accbpg_and_fw_tpu_torch.ops import dual_prox as dp

    G, X0, kw = study_prox(port, dev)
    hd = port.SumOf2nd4thPowersDualProxMap(alpha=kw["alpha"],
                                           sigma=kw["sigma"])

    def check(label, G, y, kw):
        X, steps, reads = dp.dual_prox(G, y, 1.0, **kw)
        (Xp, steps_p, _), plain_ms = timed_plain(
            lambda: dp.dual_prox_reference(G, y, 1.0, **kw))
        err = float((X - Xp).abs().max() / Xp.abs().max())
        if not (err <= 1e-12 and float(steps) == float(steps_p)
                and reads == 0):
            raise AssertionError(f"dual prox {label}: {err:.3e}, steps "
                                 f"{float(steps)} / {float(steps_p)}")
        return Xp, float(steps), err, plain_ms

    Xp, steps, err, plain_ms = check("400x10", G, X0, kw)
    ms = time_launches(lambda: dp.dual_prox(G, X0, 1.0, **kw), 20)
    plan = dp.device_plan(X0.numel(), torch.cuda.current_device())
    rec = (err, ms, plain_ms) + dual_prox_bound(X0.numel(), steps)
    more = []
    for shape, iters in (((200, 100), 200), ((400, 100), 400),
                         ((1000, 1000), 60)):
        rng = np.random.default_rng(3)
        y = torch.tensor(rng.random(shape), device=dev)
        g = torch.tensor(rng.standard_normal(shape), device=dev)
        kw2 = dict(kw, num_iters=iters, tol=1e-6)
        _, s2, e2, _ = check(f"{shape}", g + hd.grad(y), y, kw2)
        pl = dp.device_plan(y.numel(), torch.cuda.current_device())
        more.append(f"{shape[0]}x{shape[1]} ({plan_text(dp, pl)}) "
                    f"{s2:.0f} steps within {e2:.1e}")
    print(f"[dual prox] {X0.shape[0]}x{X0.shape[1]}: {steps:.0f} steps in "
          f"{ms:.3f} ms by events ({1e3 * ms / steps:.2f} us a step; plan "
          f"{plan_text(dp, plan)}), the plain loop {plain_ms:.1f} ms; X "
          f"within {err:.1e} of its largest entry; bound {rec[3]:.4f} ms by "
          f"{rec[4]}; " + "; ".join(more), flush=True)
    dual_prox_stages(dp, G, X0, kw, "400x10")
    dual_prox_sweep(dp, G, X0, kw, Xp, steps)
    return rec


def dual_prox_sweep(dp, G, y, kw, Xp, steps):
    """The 400x10 prox under every layout: clusters 1-16, E = 1, 2, 4, 8
    elements a thread in registers and E = 0 (the arrays in memory), each
    held to the plain loop's steps and X (``Xp``) and timed by events; the
    fastest is what ``dual_prox_plan`` should choose."""
    index = torch.cuda.current_device()
    limit = dp.smem_limit(index)
    rows, timed = [], []
    for cluster in (1, 2, 4, 8, 16):
        for per_thread in (1, 2, 4, 8, 0):
            plan = dp.layout_plan(y.numel(), cluster, per_thread, limit)
            label = f"C={cluster} E={per_thread}"
            if plan is None:
                rows.append(f"{label} over "
                            f"{dp.max_threads(per_thread)} threads")
                continue
            if not dp.schedulable(plan, index):
                rows.append(f"{label} not schedulable")
                continue

            def run(plan=plan):
                return dp._launch_cuda(G, y, 1.0, plan=plan, **kw)

            X, s = run()
            err = float((X - Xp).abs().max() / Xp.abs().max())
            if not (err <= 1e-12 and float(s) == steps):
                raise AssertionError(f"dual prox sweep {label}: {err:.3e}, "
                                     f"steps {float(s)} / {steps}")
            ms = time_launches(run, 5)
            rows.append(f"{label} ({plan.threads} threads, {plan.layout}) "
                        f"{ms:.3f} ms")
            timed.append((ms, label, plan))
    chosen = dp.device_plan(y.numel(), index)
    timed.sort(key=lambda t: t[0])
    print(f"[dual prox sweep] {y.shape[0]}x{y.shape[1]}, {steps:.0f} steps, "
          f"each within 1e-12 of the plain loop: " + "; ".join(rows)
          + f"; fastest {timed[0][1]} {timed[0][0]:.3f} ms; the plan takes "
          f"C={chosen.cluster} E={chosen.per_thread}", flush=True)
    for ms, label, plan in timed[:3]:
        dual_prox_stages(dp, G, y, kw, f"400x10 {label}", plan)


def dual_prox_stages(dp, G, y, kw, label, plan=None):
    """Thread 0 of CTA 0's clocks per stage of a step of the dual prox
    kernel (``dp.STAGES``) on one input (under ``plan``, else the device
    plan), the timed launch's ms by events and the clock rate they
    imply."""
    prof = torch.zeros(len(dp.STAGES) + 1, dtype=torch.int64, device=y.device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    extra = {} if plan is None else {"plan": plan}
    start.record()
    dp._launch_cuda(G, y, 1.0, prof=prof, **extra, **kw)
    end.record()
    torch.cuda.synchronize()
    clocks = prof.cpu().numpy().astype(np.float64)
    steps = int(clocks[-1])
    if steps < 2:
        raise AssertionError(f"the stage clocks were not written: {clocks}")
    per_step = clocks[:-1] / steps
    total = per_step.sum()
    ms = start.elapsed_time(end)
    parts = "; ".join(f"{name} {c:.0f} ({100 * c / total:.1f}%)"
                      for name, c in zip(dp.STAGES, per_step))
    print(f"[stages] dual prox {label}: {steps} steps, {total:.0f} clocks a "
          f"step for thread 0 of CTA 0 ({ms:.3f} ms timed launch, "
          f"{total * steps / (ms * 1e3):.0f} MHz): {parts}", flush=True)


# ---- the nuclear ball's top singular pair ---------------------------------

# the kernel against its plain version at these shapes (600x60 takes the
# ring layout: A and V are 317 KB) and on a rank-1 and a zero matrix; the
# bar: the two sum the dot products in other orders
SVD_SHAPES = ((6, 4), (4, 6), (200, 20), (20, 200), (600, 60))
SVD_TOL = 1e-13
# Gradients larger than the nuclear ball's SymNMF 200x20, in the ring
# layout, timed against torch.linalg.svd, the streamed layout (the parent
# commit's design) and the LMO of the commit before it (torch.linalg.svd,
# then the outer product of the top pair); held to the plain version at
# SVD_TOL_LARGE: ten thousand rounds at 1000x1000 carry each sum's
# last-bit differences further than 200x20's 150.
SVD_LARGE = ((1000, 200), (1000, 1000))
SVD_TOL_LARGE = 1e-12
# every shape [svd sizes] times (the path's 200x20 first)
SVD_TIMED = ((200, 20), (600, 60)) + SVD_LARGE


def svd_bound(m, n, sweeps, rotations):
    """Bound of one top-singular-pair solve of an m x n matrix that took
    ``sweeps`` sweeps and ``rotations`` rotations (a timed launch's
    count): g read once and s written once; each sweep's k (k - 1) / 2
    pairs take 6 p FP64 operations for their three dot products, and each
    rotation 6 (p + k) for two columns of A and of V (p = max(m, n), k =
    min(m, n))."""
    p, k = max(m, n), min(m, n)
    return bound(16 * m * n, sweeps * k * (k - 1) // 2 * 6 * p
                 + rotations * 6 * (p + k))


def svd_timed(svd, g, plan=None):
    """One timed launch (``_launch_cuda(prof=...)``): ``(sweeps,
    rotations, rounds, {stage: clocks a round})``."""
    prof = torch.zeros(svd.PROF_LEN, dtype=torch.int64, device=g.device)
    svd._launch_cuda(g, plan, prof)
    got = prof.tolist()
    stages, (rounds, sweeps, rotations) = got[:len(svd.STAGES)], got[-3:]
    return sweeps, rotations, rounds, {
        name: c / max(rounds, 1) for name, c in zip(svd.STAGES, stages)}


def svd_plan_text(plan):
    if plan.layout == "ring":
        return (f"ring {plan.ctas} CTAs x {plan.pairs} pairs x "
                f"{plan.pair_warps} warps, clusters of {plan.cluster}, "
                f"{plan.smem_bytes} shared bytes a CTA")
    return f"{plan.layout} {plan.ctas}x{plan.warps} warps"


def compare_svd(dev):
    """Kernel ``csrc/top_singular.cu`` against its plain version
    (``ops/svd.py::top_singular_pair_reference`` on the card's tensors) at
    SVD_SHAPES, a rank-1 and a zero matrix, within SVD_TOL, and 200x20
    through the streamed layout and rings of one, two and five CTAs as
    well; the plan and sweeps of each (none at the bound); the kernels'
    registers and spills; then ``svd_large`` and ``svd_stages``.
    Returns ``(err, ms, plain_ms, bound_ms, bound_by, library_ms)`` at
    200x20, the nuclear ball's SymNMF shape."""
    from accbpg_and_fw_tpu_torch.ops import svd

    rng = np.random.default_rng(9)
    cases = [(f"{m}x{n}", torch.tensor(rng.standard_normal((m, n)),
                                       device=dev)) for m, n in SVD_SHAPES]
    cases += [("rank-1 7x5", torch.outer(
                  torch.arange(1.0, 8.0, dtype=torch.float64, device=dev),
                  torch.tensor(rng.standard_normal(5), device=dev))),
              ("zero 4x3", torch.zeros(4, 3, dtype=torch.float64,
                                       device=dev))]
    lines, errs, most = [], [], 0
    for label, g in cases:
        plan = svd.device_plan(*g.shape, dev.index)
        s, sweeps = svd._launch_cuda(g)
        ref = svd.top_singular_pair_reference(g)
        ref_sweeps = svd._jacobi_reference(g)[2]
        err = float((s - ref).abs().max())
        sweeps = int(sweeps)
        if not (err <= SVD_TOL and sweeps < svd.MAX_SWEEPS):
            raise AssertionError(f"top singular pair {label}: error "
                                 f"{err:.3e}, {sweeps} sweeps")
        errs.append(err)
        most = max(most, sweeps)
        lines.append(f"{label} {svd_plan_text(plan)} {sweeps} sweeps (plain "
                     f"{ref_sweeps}) within {err:.1e}")
    g = cases[2][1]  # 200x20
    limit = svd.smem_limit(dev.index)
    for label, plan in (("streamed", svd.svd_plan(200, 20, 0)),
                        ("a ring of one CTA",
                         svd.ring_plan(200, 20, 10, 1, 1, limit)),
                        ("a ring of two CTAs",
                         svd.ring_plan(200, 20, 5, 2, 1, limit)),
                        ("a ring of five CTAs in clusters of two",
                         svd.ring_plan(200, 20, 2, 2, 2, limit))):
        err = float((svd._launch_cuda(g, plan)[0]
                     - svd.top_singular_pair(g)).abs().max())
        if not err <= SVD_TOL:
            raise AssertionError(f"top singular pair 200x20 {label}: "
                                 f"{err:.3e}")
        lines.append(f"200x20 through {label} within {err:.1e}")
    info = "; ".join(f"{name} {regs} registers, {spill} spill bytes"
                     for name, (regs, _, spill)
                     in svd.kernel_info(dev.index).items())
    print(f"[svd] top singular pair against its plain version (bar "
          f"{SVD_TOL:g}): " + "; ".join(lines) + f"; most sweeps {most} "
          f"(bound {svd.MAX_SWEEPS}); kernels: {info}", flush=True)
    timed = svd_large(svd, dev)
    svd_stages(svd, dev)
    svd_sweep(svd, dev)
    _, at_bound, _ = svd.device_stats()
    if at_bound:
        raise AssertionError(f"{at_bound} top-singular-pair solves reached "
                             "the sweep bound")
    return (max(errs),) + timed


def parent_lmo(g):
    """The nuclear ball's LMO of the commit before the kernel: cuSOLVER's
    SVD, then the outer product of the top pair (refuses a capture)."""
    U, _, Vh = torch.linalg.svd(g, full_matrices=False)
    return torch.outer(U[:, 0], Vh[0])


def svd_large(svd, dev):
    """The kernel at SVD_TIMED, each in the layout its shape takes: its
    plan, sweeps, error against the plain version, ms by events beside the
    bound (the rotations from a timed launch), the streamed layout's ms
    (the parent commit's design, in this call), torch.linalg.svd's and
    the LMO before the kernel; the plain version's wall; printed before
    the bar is checked.  Returns ``(ms, plain_ms, bound_ms, bound_by,
    library_ms)`` at 200x20."""
    rng = np.random.default_rng(11)
    lines, bad, out = [], [], None
    for m, n in SVD_TIMED:
        g = torch.tensor(rng.standard_normal((m, n)), device=dev)
        plan = svd.device_plan(m, n, dev.index)
        s, sweeps = svd._launch_cuda(g)
        sweeps = int(sweeps)
        _, rotations, _, _ = svd_timed(svd, g)
        ref, plain_ms = timed_plain(
            lambda: svd.top_singular_pair_reference(g))
        err = float((s - ref).abs().max())
        reps = 3 if m * n > 100000 else 20
        streamed = svd.svd_plan(m, n, 0, plan.ctas if plan.ctas > 1
                                else None)
        ms = time_launches(lambda: svd.top_singular_pair(g), reps)
        st_ms = time_launches(lambda: svd._launch_cuda(g, streamed), reps)
        lib_ms = time_launches(
            lambda: torch.linalg.svd(g, full_matrices=False), reps)
        parent_ms = time_launches(lambda: parent_lmo(g), reps)
        ms2 = time_launches(lambda: svd.top_singular_pair(g), reps)
        b, by = svd_bound(m, n, sweeps, rotations)
        lines.append(
            f"{m}x{n} {svd_plan_text(plan)}: {sweeps} sweeps, {rotations} "
            f"rotations, within {err:.1e} of the plain version: {ms:.4f} "
            f"and {ms2:.4f} ms by events (bound {b:.6f} ms by {by}); the "
            f"streamed layout ({streamed.ctas}x{streamed.warps} warps) "
            f"{st_ms:.4f} ms; torch.linalg.svd {lib_ms:.4f} ms; the LMO "
            f"before the kernel (svd and outer) {parent_ms:.4f} ms; plain "
            f"{plain_ms:.2f} ms")
        tol = SVD_TOL_LARGE if (m, n) in SVD_LARGE else SVD_TOL
        if not (err <= tol and sweeps < svd.MAX_SWEEPS):
            bad.append(f"{m}x{n}: error {err:.3e}, {sweeps} sweeps")
        if out is None:
            out = (ms, plain_ms, b, by, lib_ms)
    print(f"[svd sizes] ({card_line()}) " + "; ".join(lines), flush=True)
    if bad:
        raise AssertionError("top singular pair against its plain version: "
                             + "; ".join(bad))
    return out


def svd_stages(svd, dev):
    """``[svd stages]``: thread 0 of CTA 0's clocks per stage of a round
    in a timed launch of the ring layout and of the streamed one (a grid
    barrier a round), at 600x60, 1000x200 and 1000x1000, with the rounds,
    sweeps and rotations of each and the launch's ms (the timed instance's
    own)."""
    rng = np.random.default_rng(11)
    lines = []
    for m, n in ((600, 60),) + SVD_LARGE:
        g = torch.tensor(rng.standard_normal((m, n)), device=dev)
        ring = svd.device_plan(m, n, dev.index)
        for plan in (ring, svd.svd_plan(m, n, 0, ring.ctas)):
            svd_timed(svd, g, plan)  # warm
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            sweeps, rotations, rounds, per = svd_timed(svd, g, plan)
            end.record()
            torch.cuda.synchronize()
            total = sum(per.values())
            lines.append(
                f"{m}x{n} {svd_plan_text(plan)}: {rounds} rounds, {sweeps} "
                f"sweeps, {rotations} rotations, {total:.0f} clocks a "
                f"round (" + ", ".join(f"{k} {v:.0f}" for k, v in
                                       per.items())
                + f"), {start.elapsed_time(end):.3f} ms timed")
    print(f"[svd stages] ({card_line()}) " + "; ".join(lines), flush=True)


# [svd sweep]: ring layouts (pairs a CTA, warps a pair, CTAs a cluster)
# timed against the plan's, from which svd_plan's rule was chosen
SVD_SWEEP = {(600, 60): ((2, 1, 16), (2, 2, 16), (2, 4, 16), (4, 1, 16),
                         (1, 4, 1), (2, 4, 1), (4, 2, 1)),
             (1000, 200): ((7, 1, 16), (7, 2, 16), (2, 2, 1), (2, 4, 1),
                           (2, 4, 2), (4, 2, 1), (1, 8, 1)),
             (1000, 1000): ((4, 1, 1), (4, 2, 1), (4, 4, 1), (4, 2, 2),
                            (5, 2, 1))}


def svd_sweep(svd, dev):
    """``[svd sweep]``: each SVD_SWEEP layout's ms by events (3 launches
    after one) beside the plan's; a cluster the card cannot hold at once
    is said, not run."""
    rng = np.random.default_rng(11)
    limit = svd.smem_limit(dev.index)
    lines = []
    for (m, n), layouts in SVD_SWEEP.items():
        g = torch.tensor(rng.standard_normal((m, n)), device=dev)
        plan = svd.device_plan(m, n, dev.index)
        parts = [f"plan {plan.pairs}x{plan.pair_warps}x{plan.cluster} "
                 f"{time_launches(lambda: svd._launch_cuda(g), 3):.4f}"]
        for pairs, warps, cluster in layouts:
            ring = svd.ring_plan(m, n, pairs, warps, cluster, limit)
            if cluster > 1 and (svd.active_clusters(ring, dev.index)
                                * cluster < ring.ctas):
                parts.append(f"{pairs}x{warps}x{cluster} not held")
                continue
            ms = time_launches(lambda: svd._launch_cuda(g, ring), 3)
            parts.append(f"{pairs}x{warps}x{cluster} {ms:.4f}")
        lines.append(f"{m}x{n} (pairs x warps x cluster, ms): "
                     + ", ".join(parts))
    print(f"[svd sweep] ({card_line()}) " + "; ".join(lines), flush=True)


def svd_times(root):
    """``--svd --root DIR`` and ``--blocks-only``: the top singular pair of
    the checkout under DIR at SVD_TIMED through its ``top_singular_pair``
    (the layouts its plan takes), ms by events, for a parent and a change
    timed in turns in one call."""
    sys.path.insert(0, root)
    try:
        from accbpg_and_fw_tpu_torch.ops import svd
    except ImportError:  # a commit before the kernel
        print(f"[blocks] {root}: no top singular pair kernel", flush=True)
        return
    if pathlib.Path(root) not in pathlib.Path(svd.__file__).resolve().parents:
        raise RuntimeError(f"imported {svd.__file__}, not the package "
                           f"under {root}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    parts = []
    for m, n in SVD_TIMED:
        g = torch.tensor(rng.standard_normal((m, n)), device=dev)
        reps = 3 if m * n > 100000 else 20
        ms = time_launches(lambda: svd.top_singular_pair(g), reps)
        parts.append(f"{m}x{n} {svd.device_plan(m, n).layout} {ms:.4f} ms")
    print(f"[blocks] {root}: top singular pair by events: "
          + "; ".join(parts), flush=True)


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
    """Counts on the card the prox calls of an h-oracle the device ran (a
    graph captures the probe once and replays its count) and keeps the
    largest |sum x - 1| of their outputs there (no host read)."""

    def __init__(self, h):
        self.calls = torch.zeros((), dtype=torch.int64, device="cuda")
        self.worst = torch.zeros((), dtype=torch.float64, device="cuda")
        inner = h.prox_map

        def prox_map(g, L):
            x = inner(g, L)
            self.calls.add_(1)
            torch.maximum(self.worst, (x.sum() - 1.0).abs(), out=self.worst)
            return x

        h.prox_map = prox_map


def graph_nodes(entries):
    """Nodes of the captured graphs (``_GraphChunk.nodes``, the driver
    API's count at each capture), or None where one was not counted."""
    counts = [e.nodes for e in entries]
    return None if None in counts else sum(counts)


def synced(run):
    """``run()`` timed and with its host syncs counted
    (``torch.cuda.set_sync_debug_mode``): ``(result, wall s, syncs)``."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, wall, sum("synchroniz" in str(w.message) for w in caught)


def idle_share(run):
    """The device's idle share over one traced call of ``run`` (the
    profiler's own cost included), or None without device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    busy = sum(e.device_time for e in prof.events()
               if e.device_type == DeviceType.CUDA) * 1e-6
    return 1.0 - busy / wall if busy else None


def pct(share):
    return "not measured" if share is None else f"{100 * share:.1f}%"


def bregman_graph(driver, label, run, iters, check):
    """One Bregman path, ``run(n)`` a solve of n iterations: the graph path
    over ``iters`` iterations, captured at this call, then
    ``check(result)`` (the quality gate; returns its text); the eager loop
    (``driver.eager_chunks``) over BREG_EAGER iterations against the
    graph's first rows (bit for bit, or within 1e-13 relative where cuBLAS
    took another algorithm under capture); the idle share of a traced
    window of each.  Returns ``(result, the [bregman graph] text, the
    graph's wall)``."""
    driver.clear_graph_cache()
    before = dict(driver.GRAPH_STATS)
    res, wall, syncs = synced(lambda: run(iters))
    st = {k: driver.GRAPH_STATS[k] - before[k] for k in before}
    entries = list(driver._GRAPHS.values())
    if st["captures"] != 1 or not entries:
        raise AssertionError(f"{label}: {st['captures']} captures, the "
                             "graph path was not taken")
    gate = check(res)
    nodes = graph_nodes(entries)
    span = entries[0].span
    g_idle = idle_share(lambda: run(BREG_TRACE))
    with driver.eager_chunks():
        eager, e_wall, e_syncs = synced(lambda: run(BREG_EAGER))
        e_idle = idle_share(lambda: run(BREG_TRACE))
    F_g, F_e = np.asarray(res[1][:BREG_EAGER]), np.asarray(eager[1])
    if len(F_e) != BREG_EAGER:
        raise AssertionError(f"{label}: {len(F_e)} eager rows")
    if np.array_equal(F_g, F_e):
        agree = "bit for bit"
    else:
        rel = float(np.max(np.abs(F_g - F_e) / np.abs(F_e)))
        if not rel <= 1e-13:
            raise AssertionError(f"{label}: graph vs eager F rel err "
                                 f"{rel:.3e} > 1e-13")
        agree = (f"F within {rel:.1e} relative (not bit for bit: cuBLAS "
                 "may pick another algorithm under capture)")
    node_txt = ("not measured" if nodes is None else
                f"{nodes} nodes ({nodes / span:.0f} per iteration)")
    text = (f"{label}: graph {len(res[1])} iterations in {wall:.3f} s "
            f"({1e3 * wall / len(res[1]):.3f} ms per iteration; capture "
            f"{entries[0].capture_s:.2f} s of it), a graph of {span} "
            f"iterations with {node_txt}, pool "
            f"{entries[0].pool_bytes / 2**20:.1f} MiB, {st['replays']} "
            f"replays, {st['continuations']} continuations, {syncs} host "
            f"syncs per solve, device idle {pct(g_idle)} ({BREG_TRACE} "
            f"iterations traced); eager_chunks {BREG_EAGER} iterations in "
            f"{e_wall:.3f} s ({1e3 * e_wall / BREG_EAGER:.3f} ms per "
            f"iteration), {e_syncs / BREG_EAGER:.2f} host syncs per "
            f"iteration, device idle {pct(e_idle)}; first {BREG_EAGER} rows "
            f"{agree}; {gate}")
    return res, text, wall


def bodies_study(iters=2000):
    """``--bodies`` (see the module docstring): the Bregman paths (each as
    graphs first, then eagerly: the order of phases 4e-4f), the FW line
    searches (eagerly first), the extras, the fast_gram paths and
    ABPG_gain's first capture after its long eager run;
    ``--extras-only``, ``--fastgram-only`` and ``--fw-only`` run one part
    alone."""
    from accbpg_and_fw_tpu_torch.ops import _build

    _build.build_all(["simplex_mult", "threefry", "dual_prox"])
    print(f"[bodies] torch {torch.__version__}; {card_line()}", flush=True)
    only = {"--extras-only", "--fastgram-only", "--fw-only"} & set(sys.argv)
    if not only:
        bregman_bodies(iters)
    if not only or "--fw-only" in only:
        fw_bodies()
    if not only or "--extras-only" in only:
        extras_bodies()
    if not only or "--fastgram-only" in only:
        fastgram_bodies(iters)
    if not only:
        capture_after_eager()
    return 0


def fastgram_bodies(iters):
    """The fast_gram part of ``--bodies``: ABPG_gain 30x10000 and BPG-LS
    and ABPG_expo 30x1000 with ``fast_gram=True`` and the default h under
    ``eager_chunks`` over their 9000 iterations with ``_loops.TALLY`` (the
    trials of each line search, the warm multiplier's and theta's Newton
    passes) and ``fastgram.TALLY`` (the gates), then as graphs over
    ``iters`` iterations at the masked trials that cover 90%, 99% and 99.9%
    of the line searches (the warm multiplier's passes likewise, on
    ABPG_gain): warm walls, continuations, nodes per graph, capture
    seconds, pool MiB."""
    import accbpg_and_fw_tpu_torch as port
    from accbpg_and_fw_tpu_torch import _loops
    from accbpg_and_fw_tpu_torch.algorithms import bpg, driver, fastgram
    from accbpg_and_fw_tpu_torch.ops import roots

    fg, _, Lg, xg = port.D_opt_design(GAIN_M, GAIN_N, randseed=10,
                                      device="cuda")
    fb, hb, Lb, xb = port.D_opt_design(BPG_M, BPG_N, randseed=10,
                                       device="cuda")
    hg = port.BurgEntropySimplex()
    paths = {
        "ABPG_gain": (lambda n: port.ABPG_gain(
            fg, hg, Lg, xg, gamma=2, maxitrs=n, verbose=False,
            fast_gram=True), GAIN_ITERS, "FG_GAIN_BODIES"),
        "BPG-LS": (lambda n: port.BPG(
            fb, hb, Lb, xb, maxitrs=n, verbose=False, fast_gram=True),
            BPG_ITERS, "FG_BPG_BODIES"),
        "ABPG_expo": (lambda n: port.ABPG_expo(
            fb, hb, Lb, xb, 3.0, n, verbose=False, fast_gram=True),
            BPG_ITERS, "FG_EXPO_BODIES"),
    }
    for name, (run, full_iters, attr) in paths.items():
        _loops.TALLY[0], fastgram.TALLY[0] = {}, {}
        with driver.eager_chunks():
            res, ms = timed_plain(lambda: run(full_iters))
        tally, gates = _loops.TALLY[0], fastgram.TALLY[0]
        _loops.TALLY[0] = fastgram.TALLY[0] = None
        print(f"[bodies] {name} fast_gram eager_chunks {len(res[1])} "
              f"iterations in {ms / 1e3:.2f} s; "
              f"{fg_text(gates, len(res[1]))}; bodies taken per loop: "
              + "; ".join(f"{loop} {sorted(counts.items())}"
                          for loop, counts in tally.items()), flush=True)
        knobs = [(bpg, attr, tally[next(k for k in tally
                                         if "fast_gram trials" in k)])]
        if name == "ABPG_gain":
            knobs.append((roots, "WARM_NEWTON_BODIES",
                          tally["warm multiplier Newton"]))
        for mod, knob, counts in knobs:
            chosen, parts = getattr(mod, knob), []
            for bodies in quantile_bodies(counts):
                setattr(mod, knob, bodies)
                driver.clear_graph_cache()
                before = dict(driver.GRAPH_STATS)
                run(iters)  # the capture
                cont = (driver.GRAPH_STATS["continuations"]
                        - before["continuations"])
                entry = next(iter(driver._GRAPHS.values()))
                _, ms = timed_plain(lambda: run(iters))
                parts.append(f"{bodies}: {ms / 1e3:.3f} s warm, {cont} "
                             f"continuations, {graph_nodes([entry])} nodes "
                             f"per graph of {entry.span}, capture "
                             f"{entry.capture_s:.2f} s, pool "
                             f"{entry.pool_bytes / 2**20:.1f} MiB")
            setattr(mod, knob, chosen)
            print(f"[bodies] {name} fast_gram as graphs over {iters} "
                  f"iterations by {knob}: " + "; ".join(parts)
                  + f" ({knob} = {chosen})", flush=True)


def extras_bodies():
    """The extras' part of ``--bodies``: each driver of phase 4k at its
    size under ``eager_chunks`` with ``_loops.TALLY`` (the trials each line
    search took, the steps of the primal-dual ascent), then as graphs of
    extras.GRAPH_SPAN (PD_GRAPH_SPAN) iterations at the masked bodies that
    cover 90%, 99% and 99.9% of its iterations: warm walls,
    continuations, nodes per graph, capture seconds."""
    import accbpg_and_fw_tpu_torch as port
    from accbpg_and_fw_tpu_torch import _loops
    from accbpg_and_fw_tpu_torch.algorithms import driver, extras

    np.random.seed(1)
    f, _, L, x0 = port.Poisson_regr_simplex_acc(EXP_M, EXP_N, noise=0.001,
                                                device="cuda")
    h = port.BurgEntropySimplex(eps=1e-7, use_pallas=True)
    pd = pd_instance(port, "cuda")
    runs = {
        "AIBM": ("AIBM_BODIES", lambda: port.AIBM(
            f, h, L, x0, gamma=EXP_GAMMA, maxitrs=EXP_ITERS, epsilon=1e-12,
            verbose=False)),
        "UniversalGM": ("UNIVERSAL_BODIES", lambda: port.UniversalGM(
            f, h, L, x0, maxitrs=EXP_ITERS, epsilon=1e-12, verbose=False)),
        "AdaptFGM": ("ADAPT_BODIES", lambda: port.AdaptFGM(
            f, h, L, x0, maxitrs=EXP_ITERS, epsilon=1e-12, verbose=False)),
        "primal-dual": ("PD_BODIES", lambda: port.
                        PrimalDualSwitchingGradientMethod(
                            pd[0], pd[2], pd[3], pd[1], pd[4], EX_ITERS,
                            epsilon=1e-9, linesearch=True, verbose=False)),
    }
    for name, (attr, run) in runs.items():
        _loops.TALLY[0] = {}
        with driver.eager_chunks():
            _, ms = timed_plain(run)
        tally, _loops.TALLY[0] = _loops.TALLY[0], None
        print(f"[bodies] {name} eager_chunks in {ms / 1e3:.3f} s; bodies "
              f"taken per loop: " + "; ".join(
                  f"{loop} {sorted(counts.items())}"
                  for loop, counts in tally.items()), flush=True)
        loop = next(k for k in tally if "trials" in k and "k=0" not in k)
        chosen, parts = getattr(extras, attr), []
        for bodies in quantile_bodies(tally[loop]):
            setattr(extras, attr, bodies)
            driver.clear_graph_cache()
            before = dict(driver.GRAPH_STATS)
            run()  # the capture
            cont = (driver.GRAPH_STATS["continuations"]
                    - before["continuations"])
            entry = next(iter(driver._GRAPHS.values()))
            _, ms = timed_plain(run)
            parts.append(f"{bodies} bodies: {ms / 1e3:.3f} s warm, {cont} "
                         f"continuations, {graph_nodes([entry])} nodes per "
                         f"graph of {entry.span}, capture "
                         f"{entry.capture_s:.2f} s")
        setattr(extras, attr, chosen)
        print(f"[bodies] {name} as graphs: " + "; ".join(parts)
              + f" ({attr} = {chosen})", flush=True)


def bregman_bodies(iters):
    """The Bregman half of ``--bodies``."""
    import accbpg_and_fw_tpu_torch as port
    from accbpg_and_fw_tpu_torch import _loops
    from accbpg_and_fw_tpu_torch.algorithms import bpg, driver

    def gain_run():
        f, _, L, x0 = port.D_opt_design(GAIN_M, GAIN_N, randseed=10,
                                        device="cuda")
        h = port.BurgEntropySimplex(use_pallas=True)
        return lambda n: port.ABPG_gain(f, h, L, x0, gamma=2, maxitrs=n,
                                        verbose=False)

    def bpg_run():
        f, h, L, x0 = port.D_opt_design(BPG_M, BPG_N, randseed=10,
                                        device="cuda")
        return lambda n: port.BPG(f, h, L, x0, maxitrs=n, verbose=False)

    paths = (("ABPG_gain", gain_run, GAIN_ITERS, "GAIN_BODIES", (4, 6, 8)),
             ("BPG-LS", bpg_run, BPG_ITERS, "BPG_BODIES", (3, 5)))
    for name, make, full_iters, attr, choices in paths:
        run = make()
        chosen = getattr(bpg, attr)
        parts = []
        for bodies in choices:
            setattr(bpg, attr, bodies)
            driver.clear_graph_cache()
            before = dict(driver.GRAPH_STATS)
            run(iters)  # the capture
            cont = driver.GRAPH_STATS["continuations"] - before[
                "continuations"]
            _, ms = timed_plain(lambda: run(iters))
            nodes = graph_nodes(list(driver._GRAPHS.values()))
            parts.append(f"{bodies} bodies {ms / 1e3:.2f} s warm, {cont} "
                         f"continuations, {nodes} nodes per graph")
        setattr(bpg, attr, chosen)
        print(f"[bodies] {name} as graphs over {iters} iterations: "
              + "; ".join(parts) + f" ({attr} = {chosen})", flush=True)
        if name == "ABPG_gain":
            spans, chosen_span = [], bpg.GRAPH_SPAN
            for span in (256, 32):
                bpg.GRAPH_SPAN = span
                driver.clear_graph_cache()
                run(256)
                entry = next(iter(driver._GRAPHS.values()))
                spans.append(f"span {span}: {graph_nodes([entry])} nodes, "
                             f"capture {entry.capture_s:.2f} s, pool "
                             f"{entry.pool_bytes / 2**20:.1f} MiB")
            bpg.GRAPH_SPAN = chosen_span
            print("[bodies] ABPG_gain graphs: " + "; ".join(spans),
                  flush=True)
        _loops.TALLY[0] = {}
        with driver.eager_chunks():
            _, ms = timed_plain(lambda: run(full_iters))
        tally, _loops.TALLY[0] = _loops.TALLY[0], None
        print(f"[bodies] {name} eager_chunks {full_iters} iterations in "
              f"{ms / 1e3:.2f} s; bodies taken per loop: " + "; ".join(
                  f"{loop} {sorted(counts.items())}"
                  for loop, counts in tally.items()), flush=True)


def quantile_bodies(counts, shares=(0.9, 0.99, 0.999)):
    """The fewest bodies that cover each share of the iterations (at least
    1): the masked bodies whose walls are compared."""
    ks = sorted(counts)
    total = sum(counts.values())
    out = []
    for share in shares:
        run = 0
        for k in ks:
            run += counts[k]
            if run >= share * total:
                out.append(max(k, 1))
                break
    return sorted(set(out))


def fw_bodies():
    """The FW half of ``--bodies``: each line-search driver on phase 4i's
    illcond problem under ``eager_chunks`` over FW_ITERS iterations with
    ``_loops.TALLY`` first (eager runs followed by new captures), then as
    graphs of 256 and of 32 iterations at the masked bodies that cover
    90%, 99% and 99.9% of its iterations: warm walls, continuations, nodes
    per graph, capture seconds."""
    import accbpg_and_fw_tpu_torch as port
    from accbpg_and_fw_tpu_torch import _loops
    from accbpg_and_fw_tpu_torch.algorithms import driver, fw

    f, h, L, L0, L1, x0, _, _ = port.hard_FW_log_reg_jax(
        FW_ILL["seed"], FW_NS, FW_NF, domain="l2", device="cuda",
        **{k: v for k, v in FW_ILL.items() if k != "seed"})
    L, L0, L1 = float(L), max(float(L0), 1e-9), float(L1)
    lmo = port.lmo_l2_ball(FW_ILL["radius"])
    runs = fw_drivers(port, h, L, L0, L1)
    chosen_span = fw.GRAPH_SPAN
    for name, attr in FW_BODIES.items():
        def run():
            return runs[name](f, x0, lmo, FW_ITERS)

        _loops.TALLY[0] = {}
        with driver.eager_chunks():
            _, ms = timed_plain(run)
        tally, _loops.TALLY[0] = _loops.TALLY[0], None
        print(f"[bodies] {name} eager_chunks {FW_ITERS} iterations in "
              f"{ms / 1e3:.3f} s; bodies taken per loop: " + "; ".join(
                  f"{loop} {sorted(counts.items())}"
                  for loop, counts in tally.items()), flush=True)
        live_line(name, run, tally)
        chosen, parts = getattr(fw, attr), []
        for bodies in quantile_bodies(next(iter(tally.values()))):
            for span in (256, 32):
                setattr(fw, attr, bodies)
                fw.GRAPH_SPAN = span
                driver.clear_graph_cache()
                before = dict(driver.GRAPH_STATS)
                run()  # the capture
                cont = (driver.GRAPH_STATS["continuations"]
                        - before["continuations"])
                entry = next(iter(driver._GRAPHS.values()))
                _, ms = timed_plain(run)
                parts.append(f"{bodies} bodies span {span}: {ms / 1e3:.3f} "
                             f"s warm, {cont} continuations, "
                             f"{graph_nodes([entry])} nodes per graph, "
                             f"capture {entry.capture_s:.2f} s, pool "
                             f"{entry.pool_bytes / 2**20:.1f} MiB")
        setattr(fw, attr, chosen)
        fw.GRAPH_SPAN = chosen_span
        print(f"[bodies] {name} as graphs over {FW_ITERS} iterations: "
              + "; ".join(parts) + f" ({attr} = {chosen}, GRAPH_SPAN = "
              f"{chosen_span})", flush=True)


def live_line(label, run, tally):
    """The ``[bodies]`` line of one warm run as graphs at the shipped
    bodies: per loop, the masked bodies that did work against those run
    (``_loops.live_counts``), beside the trials after the first that the
    eager run's ``TALLY`` counted on the same problem (the live bodies and
    the continuations' trials add up to them)."""
    from accbpg_and_fw_tpu_torch import _loops
    from accbpg_and_fw_tpu_torch.algorithms import driver

    driver.clear_graph_cache()
    run()  # the capture
    before, cont = _loops.live_counts(), driver.GRAPH_STATS["continuations"]
    run()
    after = _loops.live_counts()
    parts = []
    for loop, counts in tally.items():
        live, ran = (after.get(loop, (0, 0))[i] - before.get(loop, (0, 0))[i]
                     for i in (0, 1))
        parts.append(f"{loop}: {live} live of {ran} masked bodies run "
                     f"({100.0 * live / max(ran, 1):.2f}%), eager TALLY "
                     f"{sum(b * c for b, c in counts.items())} trials")
    print(f"[bodies] {label} as graphs at the shipped bodies: "
          + "; ".join(parts) + f"; "
          f"{driver.GRAPH_STATS['continuations'] - cont} continuations",
          flush=True)


def capture_after_eager():
    """ABPG_gain's first capture right after its long eager run (the
    order in which a capture once failed with
    cudaErrorStreamCaptureInvalidated); where it fails, again with the
    collector off, then with ``capture_error_mode="thread_local"``."""
    import functools
    import gc

    import accbpg_and_fw_tpu_torch as port
    from accbpg_and_fw_tpu_torch.algorithms import driver

    f, _, L, x0 = port.D_opt_design(GAIN_M, GAIN_N, randseed=10,
                                    device="cuda")
    h = port.BurgEntropySimplex(use_pallas=True)

    def run(n):
        return port.ABPG_gain(f, h, L, x0, gamma=2, maxitrs=n, verbose=False)

    graph = torch.cuda.graph
    tried = []
    for label in ("as shipped", "gc disabled", "thread_local"):
        with driver.eager_chunks():
            _, ms = timed_plain(lambda: run(GAIN_ITERS))
        driver.clear_graph_cache()
        if label == "gc disabled":
            gc.disable()
        if label == "thread_local":
            torch.cuda.graph = functools.partial(
                graph, capture_error_mode="thread_local")
        try:
            run(256)
            tried.append(f"{label}: eager {GAIN_ITERS} iterations "
                         f"{ms / 1e3:.1f} s, then the capture held")
            break
        except RuntimeError as e:
            tried.append(f"{label}: eager {ms / 1e3:.1f} s, then the capture "
                         f"raised {str(e).splitlines()[0][:100]!r}")
        finally:
            gc.enable()
            torch.cuda.graph = graph
    print("[bodies] ABPG_gain's first capture after its eager run: "
          + "; ".join(tried), flush=True)


def resume_check(driver, name, run):
    """``run(n, checkpoint)``, a solve of n iterations as graph chunks: a
    checkpoint written at the end of a run of CKPT_ITERS iterations and
    resumed to 2 CKPT_ITERS, every history row and the iterate bit for bit
    with an uninterrupted run of 2 CKPT_ITERS.  The file lies under the
    checkout's ``build/``.  Returns the check's text."""
    tmp = pathlib.Path(__file__).resolve().parent / "build" / "chip_tmp"
    tmp.mkdir(parents=True, exist_ok=True)
    ck = tmp / f"{name}.npz"
    ck.unlink(missing_ok=True)
    whole = run(2 * CKPT_ITERS)
    run(CKPT_ITERS, str(ck))
    with np.load(ck) as z:
        saved = int(z["__k_next"])
    if saved != CKPT_ITERS:
        raise AssertionError(f"{name}: checkpoint at {saved}, not "
                             f"{CKPT_ITERS}")
    before = dict(driver.GRAPH_STATS)
    resumed = run(2 * CKPT_ITERS, str(ck))
    replays = driver.GRAPH_STATS["replays"] - before["replays"]
    ck.unlink()
    if not replays:
        raise AssertionError(f"{name}: the resumed run replayed no graph")
    # the last element is the time history
    if not (torch.equal(resumed[0], whole[0])
            and all(np.array_equal(a, b)
                    for a, b in zip(resumed[1:-1], whole[1:-1]))):
        raise AssertionError(f"{name}: the run resumed from iteration "
                             f"{CKPT_ITERS} parts from the uninterrupted "
                             "run")
    return (f"a checkpoint at iteration {CKPT_ITERS} resumed to "
            f"{2 * CKPT_ITERS} as graphs ({replays} replays): rows and "
            "iterate bit for bit with the uninterrupted run")


def gain_path(port, sm, driver):
    """Phase 4e; returns the kernel's launches in it (the card's count),
    the [bregman graph] text and the graph's wall."""
    f, _, L, x0 = port.D_opt_design(GAIN_M, GAIN_N, randseed=10,
                                    device="cuda")
    h = port.BurgEntropySimplex(use_pallas=True)
    probe = ProxProbe(h)
    counts = {}

    def run(n, checkpoint=None):
        return port.ABPG_gain(f, h, L, x0, gamma=2, maxitrs=n, verbose=False,
                              checkpoint=checkpoint)

    def check(res):
        x, F, Gain = res[0], res[1], res[2]
        counts["launches"] = sm.device_launches()
        counts["calls"] = int(probe.calls)
        trials = int(gain_trials(Gain, 1.0, 1.2).sum())
        if not counts["launches"] >= counts["calls"] >= trials:
            raise AssertionError(f"ABPG_gain path: {counts['launches']} "
                                 f"kernel launches, {counts['calls']} prox "
                                 f"calls, {trials} trials")
        worst = float(probe.worst)
        if not worst <= SIMPLEX_STALL + GAIN_N * 2.0**-52:
            raise AssertionError(f"a prox output is off the simplex by "
                                 f"{worst}")
        Ff = fresh_F(f, x)
        if not (np.all(np.isfinite(F)) and Ff <= GAIN_F_BOUND):
            raise AssertionError(f"ABPG_gain path: fresh F {Ff!r} above "
                                 f"{GAIN_F_BOUND}")
        return (f"{trials} line-search trials, {counts['calls']} prox calls "
                f"and {counts['launches']} kernel 5 launches on the card "
                f"(masked trials included), fresh F {Ff:.9f} (recorded "
                f"{F[-1]:.9f}; numpy reference -16.096434), worst |sum x - "
                f"1| of a prox {worst:.3e}")

    sm.reset_device_launches()
    sm.LAUNCHES = 0
    _, text, wall = bregman_graph(
        driver, f"ABPG_gain gamma=2 {GAIN_M}x{GAIN_N} use_pallas=True", run,
        GAIN_ITERS, check)
    text += "; " + resume_check(driver, "gain_plain", run)
    print(f"[bregman gain] {text}", flush=True)
    return counts["launches"], text, wall


def bpg_path(port, sm, driver):
    """Phase 4f; returns the [bregman graph] text."""
    f, h, L, x0 = port.D_opt_design(BPG_M, BPG_N, randseed=10,
                                    device="cuda")
    sm.reset_device_launches()
    sm.LAUNCHES = 0

    def run(n):
        return port.BPG(f, h, L, x0, maxitrs=n, linesearch=True,
                        verbose=False)

    def check(res):
        x, F, Ls = res[0], res[1], res[2]
        if sm.LAUNCHES or sm.device_launches():
            raise AssertionError("the default h launched the multiplier "
                                 "kernel")
        # the reference's value is its history's last row, f(x_8999); the
        # returned iterate is one step further, so it must lie at or below
        Ff, Fo = fresh_F(f, x), float(f.value(x))
        if not (len(F) == BPG_ITERS and abs(F[-1] - BPG_F_REF) <= BPG_F_TOL
                and Ff <= F[-1] and abs(Ff - Fo) <= 1e-12 * abs(Ff)):
            raise AssertionError(f"BPG-LS path: {len(F)} rows, F[-1] "
                                 f"{F[-1]!r} (reference {BPG_F_REF}), "
                                 f"fresh F of the iterate {Ff!r}, oracle "
                                 f"{Fo!r}")
        trials = int(np.rint(np.log(Ls / np.concatenate([[L], Ls[:-1]])
                                    * 1.2) / np.log(1.2)).sum()) + len(Ls)
        return (f"{trials} line-search trials; F[-1] {F[-1]:.11f} "
                f"(reference {BPG_F_REF}); the returned iterate's fresh F "
                f"{Ff:.11f}")

    _, text, _ = bregman_graph(driver, f"BPG-LS {BPG_M}x{BPG_N} default h",
                               run, BPG_ITERS, check)
    print(f"[bregman bpg] {text}", flush=True)
    return text


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
        sm.reset_device_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        F = run()[1]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = sm.device_launches()  # a graph's replays count there
        if launches < len(F) or not np.all(np.isfinite(F)):
            raise AssertionError(f"README {name}: {launches} launches, "
                                 f"finite F {np.all(np.isfinite(F))}")
        if name in bars and not abs(F[-1] - bars[name]) < 0.05:
            raise AssertionError(f"README {name}: F {F[-1]} not within 0.05 "
                                 f"of {bars[name]}")
        parts.append(f"{name} F {F[-1]:.6f} in {wall:.3f} s "
                     f"({launches} launches)")
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


def per_iteration_costs(port, driver):
    """Phase 4h: host syncs and device operations per iteration of the
    five Bregman drivers with each h, as graphs and under
    ``driver.eager_chunks``."""
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

    def costs(run):
        run()  # warm-up (a graph's capture)
        res, _, syncs = synced(run)
        n_rows = len(res[1])
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        ops = sum(1 for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
        ops_txt = (f"{ops / n_rows:.1f}" if ops else "not measured "
                   "(no device events in the trace)")
        return f"{syncs / n_rows:.2f} syncs, {ops_txt} device ops"

    rows = []
    for name, run in drivers.items():
        for use_pallas in (True, False):
            h = port.BurgEntropySimplex(use_pallas=use_pallas)
            graph = costs(lambda: run(h))
            with driver.eager_chunks():
                eager = costs(lambda: run(h))
            rows.append(f"{name} use_pallas={use_pallas}: graph {graph}; "
                        f"eager {eager}")
    print(f"[costs] per iteration at {BPG_M}x{BPG_N} on cuda ({iters} "
          f"iterations each): " + "; ".join(rows), flush=True)


def fw_syncs_and_ops(run):
    """Host syncs (``torch.cuda.set_sync_debug_mode``), device operations
    and the device's idle share (``torch.profiler``; the traced wall
    includes the profiler's own cost) of one call of ``run``, and its
    rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rows = len(run()[1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time for e in events) * 1e-6
    return syncs, len(events), 1.0 - busy / wall, rows


def fw_against_cpu(label, F_card, F_cpu, rows=None, rtol=FW_RTOL):
    """The card's F history against the CPU's on the same arrays: the same
    number of rows (``rows`` None), then ``rtol`` over the first ``rows``
    (all for None); returns the largest relative error."""
    F_card, F_cpu = np.asarray(F_card), np.asarray(F_cpu)
    if rows is None and len(F_card) != len(F_cpu):
        raise AssertionError(f"{label}: {len(F_card)} rows on the card, "
                             f"{len(F_cpu)} on the CPU")
    n = len(F_cpu) if rows is None else rows
    err = float(np.max(np.abs(F_card[:n] - F_cpu[:n]) / np.abs(F_cpu[:n])))
    if not err <= rtol:
        raise AssertionError(f"{label}: card vs CPU F rel err {err:.3e} > "
                             f"{rtol} over {n} rows")
    return err


def histories(name, res):
    """The histories a driver returns (``FW_alg_descent_step`` returns
    ``(x, F, T, G)``, the others ``(x, ..., T)``)."""
    return res[1:2] if name.endswith("descent_step") else res[1:-1]


def same_rows(label, got, ref, rows):
    """The first ``rows`` rows of each history of two runs of a driver
    (``label`` starts with its name) bit for bit, or within 1e-13 relative
    where cuBLAS took another algorithm under capture (then said); returns
    the text."""
    pairs = [(np.asarray(a)[:rows], np.asarray(b)[:rows]) for a, b in
             zip(histories(label.split()[-1], got),
                 histories(label.split()[-1], ref))]
    if any(len(a) != len(b) or len(a) < min(rows, len(got[1]))
           for a, b in pairs):
        raise AssertionError(f"{label}: {len(got[1])} and {len(ref[1])} rows")
    if all(np.array_equal(a, b) for a, b in pairs):
        return "bit for bit"
    rel = max(float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
              for a, b in pairs)
    if not rel <= 1e-13:
        raise AssertionError(f"{label}: graph vs eager rel err {rel:.3e} > "
                             "1e-13")
    return (f"within {rel:.1e} relative (not bit for bit: cuBLAS may pick "
            "another algorithm under capture)")


def fw_graph(driver, label, run):
    """One graph path: ``run()`` cold (the capture, the cache cleared: one
    capture or fail) and warm (timed, host syncs counted); returns the warm
    result, its wall and its text: continuations, nodes, capture seconds,
    pool MiB, replays and syncs per solve."""
    driver.clear_graph_cache()
    before = dict(driver.GRAPH_STATS)
    first = run()
    captures = driver.GRAPH_STATS["captures"] - before["captures"]
    entries = list(driver._GRAPHS.values())
    if captures != 1 or not entries:
        raise AssertionError(f"{label}: {captures} captures, the graph path "
                             "was not taken")
    mid = dict(driver.GRAPH_STATS)
    res, wall, syncs = synced(run)
    st = {k: driver.GRAPH_STATS[k] - mid[k] for k in mid}
    if st["captures"]:
        raise AssertionError(f"{label}: captured again at the second solve")
    np.testing.assert_array_equal(np.asarray(res[1]), np.asarray(first[1]))
    nodes = graph_nodes(entries)
    span = entries[0].span
    node_txt = ("nodes not measured" if nodes is None else
                f"{nodes} nodes ({nodes / span:.0f} per iteration)")
    text = (f"graph of {span} iterations with {node_txt}, capture "
            f"{entries[0].capture_s:.2f} s, pool "
            f"{entries[0].pool_bytes / 2**20:.1f} MiB, {st['replays']} "
            f"replays, {st['continuations']} continuations, {syncs} host "
            "syncs per solve")
    return res, wall, text


def fw_illcond(port, card):
    """Phase 4i, the full-width path: the five FW drivers on the 1000x1000
    ill-conditioned logistic problem as graph chunks, each against an
    ``eager_chunks`` run (its first FW_EAGER_ROWS rows) and the port on the
    CPU (FW_CPU_ROWS rows)."""
    from accbpg_and_fw_tpu_torch.algorithms import driver

    f, h, L, L0, L1, x0, X, y = port.hard_FW_log_reg_jax(
        FW_ILL["seed"], FW_NS, FW_NF, domain="l2", device="cuda",
        **{k: v for k, v in FW_ILL.items() if k != "seed"})
    f_cpu = port.LogisticRegression(X.cpu(), y.cpu(), device="cpu")
    L, L0, L1 = float(L), max(float(L0), 1e-9), float(L1)
    CPU_RUNS["illcond_problem"] = (f, h, L, L0, L1, x0)
    radius = FW_ILL["radius"]
    lmo, lmo_cpu = port.lmo_l2_ball(radius), port.lmo_l2_ball(radius)
    out = []
    for name, run in fw_drivers(port, h, L, L0, L1).items():
        res, wall, graph_txt = fw_graph(
            driver, name, lambda: run(f, x0, lmo, FW_ITERS))
        F = np.asarray(res[1])
        if not (np.all(np.isfinite(F)) and F[-1] < F[0]):
            raise AssertionError(f"{name}: F[0] {F[0]} F[-1] {F[-1]}")
        if "log" in name:
            steps = np.asarray(res[3])
            if np.any(np.diff(steps) < 0):
                raise AssertionError(f"{name}: LOG_STEPS decreased")
            if name == "FW_l0l1_log_only" and steps[-1] < len(F) - 1:
                raise AssertionError(f"{name}: LOG_STEPS[-1] {steps[-1]} < "
                                     f"rows - 1 = {len(F) - 1}")
        with driver.eager_chunks():
            eager, e_wall, e_syncs = synced(lambda: run(f, x0, lmo,
                                                        FW_ITERS))
        agree = same_rows(name, res, eager, FW_EAGER_ROWS)
        whole = all(np.array_equal(np.asarray(a), np.asarray(b))
                    for a, b in zip(histories(name, res),
                                    histories(name, eager)))
        cpu = run(f_cpu, x0.cpu(), lmo_cpu, FW_CPU_ROWS)
        if name == "FW_alg_descent_step":
            CPU_RUNS["illcond"] = (f, h, x0, cpu[1])
        held = min(FW_CPU_ROWS, len(F))
        err = fw_against_cpu(name, F, cpu[1], rows=held)
        syncs, ops, idle, rows = fw_syncs_and_ops(
            lambda: run(f, x0, lmo, FW_COST_ITERS))
        ops_txt = (f"{ops / rows:.1f} device ops per iteration (device "
                   f"idle {100 * idle:.1f}% of a traced run of {rows})"
                   if ops else "device ops not measured (no device events "
                   "in the trace)")
        out.append(f"{name}: graph warm wall {wall:.3f} s, {len(F)} rows, "
                   f"F {F[0]:.6e} -> {F[-1]:.6e}, {graph_txt}, {ops_txt}; "
                   f"eager_chunks {e_wall:.3f} s ({e_syncs / len(F):.2f} "
                   f"syncs per iteration), first {FW_EAGER_ROWS} rows "
                   f"{agree}{' (all rows)' if whole else ''}; card vs CPU "
                   f"{err:.1e} over {held} rows")
    print(f"[fw] illcond {FW_NS}x{FW_NF} l2 ball {radius} on cuda "
          f"({FW_ITERS} iterations, ls_ratio {FW_LS_RATIO}; {card}): "
          + "; ".join(out), flush=True)


def fw_drivers(port, h, L, L0, L1, ls_ratio=FW_LS_RATIO):
    """The five FW drivers as ``run(f, x0, lmo, iterations)``, with
    ``run_regime``'s settings."""
    return {
        "FW_l0l1_log_and_linear_step": lambda f, x0, lmo, it:
            port.FW_l0l1_log_and_linear_step(f, h, L0, L1, x0, it, lmo=lmo,
                                             ls_ratio=ls_ratio,
                                             verbose=False),
        "FW_l0l1_log_only": lambda f, x0, lmo, it:
            port.FW_l0l1_log_only(f, h, L0, L1, x0, it, lmo=lmo,
                                  ls_ratio=ls_ratio, verbose=False),
        "FW_alg_div_step": lambda f, x0, lmo, it:
            port.FW_alg_div_step(f, h, L, x0, it, gamma=2.0, lmo=lmo,
                                 ls_ratio=ls_ratio, verbose=False),
        "FW_alg_L0_L1_shortest_step": lambda f, x0, lmo, it:
            port.FW_alg_L0_L1_shortest_step(f, h, L0, L1, x0, it, gamma=2.0,
                                            lmo=lmo, verbose=False),
        "FW_alg_descent_step": lambda f, x0, lmo, it:
            port.FW_alg_descent_step(f, h, x0, it, lmo, verbose=False),
    }


def fw_rs_panels(port):
    """Phase 4i: FW_alg_div_step on the three examples/ex_fw_rs.py panels,
    the card against the CPU on the same arrays."""
    def dopt(dev):
        f, h, L, x0 = port.D_opt_design(80, 200, randseed=10, device=dev)
        return f, h, L, x0, port.lmo_simplex()

    def poisson(dev):
        np.random.seed(1)
        h, sc = port.Poisson_regr_simplex(200, 100, device=dev)
        f, L, _, x0 = sc["x0_center_sol_center"]
        return f, h, L, x0, port.lmo_simplex()

    np.random.seed(3)
    svm = port.svm_digits_ds_divs_ball(device="cuda")

    def svm_panel(dev):
        f, (poly_h, _), L, x0, radius = svm
        if dev == "cpu":
            f = port.SVM_fun(lamda=f.lamda, A=f.A.cpu(), y=f.y.cpu(),
                             device="cpu")
        return f, poly_h, L, x0.to(dev), port.lmo_l2_ball(radius)

    out = []
    for label, make in (("D-opt 80x200", dopt), ("Poisson 200x100", poisson),
                        ("SVM ball 700x2000", svm_panel)):
        runs = {}
        for dev in ("cuda", "cpu"):
            f, h, L, x0, lmo = make(dev)
            torch.cuda.synchronize()
            t = time.perf_counter()
            runs[dev] = port.FW_alg_div_step(f, h, L, x0, FW_RS_ITERS,
                                             gamma=2.0, lmo=lmo, ls_ratio=2,
                                             verbose=False)
            torch.cuda.synchronize()
            runs[dev + "_wall"] = time.perf_counter() - t
        F = np.asarray(runs["cuda"][1])
        if not (np.all(np.isfinite(F)) and F[-1] < F[0]):
            raise AssertionError(f"{label}: F[0] {F[0]} F[-1] {F[-1]}")
        err = fw_against_cpu(label, F, runs["cpu"][1])
        out.append(f"{label}: {len(F)} rows, F[-1] {F[-1]:.6e}, card vs CPU "
                   f"{err:.1e}, wall {runs['cuda_wall']:.3f} s (CPU "
                   f"{runs['cpu_wall']:.3f} s)")
    print(f"[fw] ex_fw_rs panels, FW_alg_div_step {FW_RS_ITERS} iterations: "
          + "; ".join(out), flush=True)


def symnmf_matrix(n):
    """The similarity matrix of examples/ex_params_free_symnmf.py (seed 0)."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((4, 8)) * 2.0
    pts = np.concatenate([c + 0.3 * rng.standard_normal((n // 4, 8))
                          for c in centers])[:n]
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    return np.exp(-d2 / d2.mean())


def fw_symnmf(port):
    """Phase 4i: FW_alg_descent_step on SymNMF with both kernels, the card
    against the CPU on the same arrays."""
    M = symnmf_matrix(FW_SYM_N)
    out = []
    for which in (0, 1):
        runs = {}
        for dev in ("cuda", "cpu"):
            np.random.seed(0)
            f, hs, _, X0 = port.FrobeniusSymLossResMeasEx(M, FW_SYM_R,
                                                          device=dev)
            torch.cuda.synchronize()
            t = time.perf_counter()
            runs[dev] = port.FW_alg_descent_step(
                f, hs[which], X0, FW_SYM_ITERS,
                port.lmo_linf_ball(radius=1, center=1), epsilon=1e-9,
                verbose=False)
            torch.cuda.synchronize()
            runs[dev + "_wall"] = time.perf_counter() - t
        if which == 0:
            CPU_RUNS["symnmf"] = (M, runs["cpu"][1])
        F = np.asarray(runs["cuda"][1])
        if not (np.all(np.isfinite(F)) and F[-1] < F[0]):
            raise AssertionError(f"SymNMF: F[0] {F[0]} F[-1] {F[-1]}")
        err = fw_against_cpu("SymNMF", F, runs["cpu"][1])
        out.append(f"{type(hs[which]).__name__}: {len(F)} rows, F[-1] "
                   f"{F[-1]:.6e}, card vs CPU {err:.1e}, wall "
                   f"{runs['cuda_wall']:.3f} s")
    print(f"[fw] SymNMF n={FW_SYM_N} r={FW_SYM_R}, FW_alg_descent_step "
          f"{FW_SYM_ITERS} iterations: " + "; ".join(out), flush=True)


def example_module(name, more=()):
    """examples/<name>.py with its import of the JAX package changed to the
    port's, and nothing else but the ``(old, new)`` replacements of
    ``more`` (each must occur once)."""
    path = pathlib.Path(__file__).parent / "examples" / f"{name}.py"
    src = path.read_text()
    for old, new in (("import accbpg_and_fw_tpu as acc",
                      "import accbpg_and_fw_tpu_torch as acc"),) + more:
        if src.count(old) != 1:
            raise AssertionError(f"{name}.py: expected one '{old}'")
        src = src.replace(old, new)
    module = type(sys)(name)
    module.__file__ = str(path)
    exec(compile(src, module.__file__, "exec"), module.__dict__)
    return module


def fw_examples():
    """Phase 4i: examples/ex_fw_rs.py and examples/ex_params_free_symnmf.py
    with their import of the JAX package changed to the port's, and
    nothing else, on the card."""
    out = []
    for name, call in (("ex_fw_rs", lambda m: m.start(
            maxitrs=FW_RS_START_ITERS, verbose=False)),
                       ("ex_params_free_symnmf",
                        lambda m: m.start(verbose=False))):
        module = example_module(name)
        t = time.perf_counter()
        res = call(module)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        curves = (res.values() if name == "ex_params_free_symnmf" else
                  [F for panel in res.values() for F in panel.values()])
        if not all(np.all(np.isfinite(np.asarray(F))) for F in curves):
            raise AssertionError(f"{name}: a curve is not finite")
        out.append(f"{name}.start() {wall:.2f} s, {len(list(curves))} "
                   "finite curves")
    print("[fw] examples with the import changed, on cuda: "
          + "; ".join(out), flush=True)


def fw_paths(port, card, counters):
    """Phase 4i: the Frank-Wolfe paths; they launch none of the kernels."""
    for mod, name in counters:
        setattr(mod, name, 0)
    t = time.perf_counter()
    fw_illcond(port, card)
    fw_rs_panels(port)
    fw_symnmf(port)
    fw_examples()
    launched = {f"{mod.__name__.rsplit('.', 1)[1]}.{name}":
                getattr(mod, name) for mod, name in counters}
    if any(launched.values()):
        raise AssertionError(f"the FW paths launched a kernel: {launched}")
    print(f"[fw] phase 4i in {time.perf_counter() - t:.1f} s; kernel "
          f"launches on the FW paths: {launched}", flush=True)


def extras_histories(label, res):
    """The iterate and histories of a run, without its times: ``(F, gaps,
    Ls)`` of the primal-dual driver, x and F of ``FW_alg_descent_step``
    (``(x, F, T, G)``), x and all but the last (T) of the others."""
    if label.startswith("primal-dual"):
        return [np.asarray(a) for a in res]
    hist = res[1:2] if label.endswith("descent_step") else res[1:-1]
    return [res[0].cpu().numpy()] + [np.asarray(a) for a in hist]


def extras_same(label, got, ref):
    """Every row of two runs bit for bit, or within 1e-13 relative where
    cuBLAS took another algorithm under capture (then said)."""
    pairs = list(zip(extras_histories(label, got),
                     extras_histories(label, ref)))
    if any(a.shape != b.shape for a, b in pairs):
        raise AssertionError(f"{label}: graph and eager differ in rows")
    if all(np.array_equal(a, b) for a, b in pairs):
        return "all rows bit for bit"
    rel = max(float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
              for a, b in pairs)
    if not rel <= 1e-13:
        raise AssertionError(f"{label}: graph vs eager rel err {rel:.3e}")
    return (f"all rows within {rel:.1e} relative (not bit for bit: cuBLAS "
            "may pick another algorithm under capture)")


def extras_graph(driver, label, run, trace_run=None):
    """One extras driver as graph chunks (``fw_graph``: one capture at the
    cold run, the warm run timed with its syncs) against ``eager_chunks``
    (wall, syncs, every row bit for bit), with the device's idle share of
    a traced ``trace_run()`` as graphs (None: not traced).  Returns the
    warm result and the text."""
    res, wall, text = fw_graph(driver, label, run)
    with driver.eager_chunks():
        eager, e_wall, e_syncs = synced(run)
    agree = extras_same(label, res, eager)
    idle = ("not traced" if trace_run is None else
            f"{pct(idle_share(trace_run))} of a traced run")
    return res, (f"{label}: graph {wall:.3f} s against eager_chunks "
                 f"{e_wall:.3f} s ({e_wall / wall:.1f}x; eager {e_syncs} "
                 f"host syncs), {text}, device idle {idle}; {agree}")


def extras_poisson(port, sm, driver, card):
    """Phase 4k: AIBM (noiseless and with noise 1e-6), AdaptFGM and
    UniversalGM on examples/ex_aibm_poisson.py's problem with the
    multiplier kernel's h, as graphs against eager_chunks; kernel 5's
    launches in each warm graph run by the card's count (at least the
    rows); the first EX_HELD_ROWS rows against the port on the CPU at
    EX_RTOL (these accelerated runs double a last-bit difference about
    every iteration from their tenth on, so the card and the CPU part
    ways later whatever the code: the row where they do is reported).
    Returns kernel 5's launches in AIBM's warm graph run."""
    np.random.seed(1)
    f, _, L, x0 = port.Poisson_regr_simplex_acc(EXP_M, EXP_N, noise=0.001,
                                                device="cuda")
    f_cpu = port.PoissonRegression(f.A.cpu(), f.b.cpu(), device="cpu")
    h = port.BurgEntropySimplex(eps=1e-7, use_pallas=True)
    drivers = {
        "AIBM": lambda f, x0, it: port.AIBM(
            f, h, L, x0, gamma=EXP_GAMMA, maxitrs=it, epsilon=1e-12,
            verbose=False),
        "AIBM noise=1e-6": lambda f, x0, it: port.AIBM(
            f, h, L, x0, gamma=EXP_GAMMA, maxitrs=it, epsilon=1e-12,
            noise=1e-6, verbose=False),
        "AdaptFGM": lambda f, x0, it: port.AdaptFGM(
            f, h, L, x0, maxitrs=it, epsilon=1e-12, verbose=False),
        "UniversalGM": lambda f, x0, it: port.UniversalGM(
            f, h, L, x0, maxitrs=it, epsilon=1e-12, verbose=False),
    }
    out, launches = [], {}
    for name, run in drivers.items():
        res, text = extras_graph(driver, name, lambda: run(f, x0, EXP_ITERS),
                                 lambda: run(f, x0, EX_COST_ITERS))
        before = sm.device_launches()
        run(f, x0, EXP_ITERS)
        launches[name] = sm.device_launches() - before
        F = np.asarray(res[1])
        if not (np.all(np.isfinite(F)) and F[-1] < F[0]
                and launches[name] >= len(F)):
            raise AssertionError(f"{name}: F[0] {F[0]} F[-1] {F[-1]}, "
                                 f"{launches[name]} kernel 5 launches")
        F_cpu = np.asarray(run(f_cpu, x0.cpu(), EX_CPU_ROWS)[1])
        err = fw_against_cpu(name, F, F_cpu, rows=EX_HELD_ROWS, rtol=EX_RTOL)
        out.append(f"{text}; {len(F)} rows, F {F[0]:.6e} -> {F[-1]:.6e}, "
                   f"card vs CPU {err:.1e} over {EX_HELD_ROWS} rows (first "
                   f"row past {EX_RTOL} of {len(F_cpu)}: "
                   f"{past_rtol(F, F_cpu)}), {launches[name]} kernel 5 "
                   "launches in the warm graph run")
    print(f"[extras] Poisson {EXP_M}x{EXP_N} (examples/ex_aibm_poisson.py, "
          f"gamma {EXP_GAMMA}, {EXP_ITERS} iterations, BurgEntropySimplex("
          f"use_pallas=True); {card}): " + "; ".join(out), flush=True)
    return launches["AIBM"]


def extras_svm(port, driver):
    """Phase 4k: the three inexact drivers with PolyDiv on the synthetic
    SVM ball of examples/ex_aibm_svm.py, as graphs against eager.  Not
    traced: a span of these graphs holds 195k-648k nodes, each a profiler
    event, and the Poisson runs trace the same drivers."""
    np.random.seed(11)
    f, (poly_h, _), L, x0, _ = port.svm_digits_ds_divs_ball(lamda=0.001,
                                                            device="cuda")
    f_cpu = port.SVM_fun(lamda=f.lamda, A=f.A.cpu(), y=f.y.cpu(),
                         device="cpu")
    drivers = {
        "AIBM": lambda f, x0, it: port.AIBM(f, poly_h, L, x0, gamma=2.0,
                                            maxitrs=it, verbose=False),
        "AdaptFGM": lambda f, x0, it: port.AdaptFGM(f, poly_h, L, x0,
                                                    maxitrs=it,
                                                    verbose=False),
        "UniversalGM": lambda f, x0, it: port.UniversalGM(
            f, poly_h, L, x0, maxitrs=it, verbose=False),
    }
    out = []
    for name, run in drivers.items():
        res, text = extras_graph(driver, f"SVM {name}",
                                 lambda: run(f, x0, EX_ITERS))
        F = np.asarray(res[1])
        if not np.all(np.isfinite(F)):
            raise AssertionError(f"SVM {name}: F is not finite")
        # the hinge is not smooth, and these line searches soon compare
        # values equal to their last bits (tests/test_torch_extras.py):
        # the k=0 row and the first step are held, the rest reported
        F_cpu = np.asarray(run(f_cpu, x0.cpu(), EX_HELD_ROWS)[1])
        err = fw_against_cpu(f"SVM {name}", F, F_cpu, rows=2, rtol=EX_RTOL)
        out.append(f"{text}; card vs CPU {err:.1e} over 2 rows (first row "
                   f"past {EX_RTOL} of {len(F_cpu)}: {past_rtol(F, F_cpu)})")
    print(f"[extras] SVM ball {f.A.shape[0]}x{f.A.shape[1]} PolyDiv "
          f"(examples/ex_aibm_svm.py, synthetic data, lamda 0.001, "
          f"{EX_ITERS} iterations): " + "; ".join(out), flush=True)


def pd_instance(port, device):
    """examples/ex_primal_dual.py figure()'s instance: rank-1 M from 400
    uniform draws after seed 11, r = 10."""
    np.random.seed(11)
    x = np.random.rand(PD_N)
    return port.FrobeniusSymLossExWithLinearCnstrnts(np.outer(x, x), PD_R,
                                                     device=device)


def extras_primal_dual(port, driver):
    """Phase 4k: the primal-dual study, without and with the line search,
    as graphs against eager and against the CPU on the same arrays; then
    once with the dual prox as h (its kernel inside the graph).  Returns
    the dual prox kernel's launches in that run's warm graph run."""
    from accbpg_and_fw_tpu_torch.ops import dual_prox as dp

    prob, prob_cpu = pd_instance(port, "cuda"), pd_instance(port, "cpu")

    def run(p, ls, it=EX_ITERS, h=None):
        f, g, h0, L, X0 = p
        return port.PrimalDualSwitchingGradientMethod(
            f, h or h0, L, g, X0, it, epsilon=1e-9, linesearch=ls,
            verbose=False)

    out = []
    for ls in (False, True):
        res, text = extras_graph(driver, f"primal-dual linesearch={ls}",
                                 lambda: run(prob, ls),
                                 lambda: run(prob, ls, EX_COST_ITERS // 2))
        cpu = run(prob_cpu, ls)
        F, gaps = np.asarray(res[0]), np.asarray(res[1])
        if not np.all(np.isfinite(gaps)):
            raise AssertionError(f"primal-dual ls={ls}: a gap is not finite")
        # the switch between step kinds tests X A - b <= 1e-9 where the
        # unproductive steps have brought it: the first rows are held, the
        # productive counts and stop rows reported
        err = fw_against_cpu(f"primal-dual ls={ls}", gaps, cpu[1], rows=5,
                             rtol=EX_RTOL)
        out.append(f"{text}; {len(F)} productive of {len(gaps)} rows (CPU "
                   f"{len(cpu[0])} of {len(cpu[1])}), card vs CPU {err:.1e} "
                   f"over 5 gaps (first gap row past {EX_RTOL}: "
                   f"{past_rtol(gaps, cpu[1])})")
    h = prob[2]
    hd = port.SumOf2nd4thPowersDualProxMap(alpha=h.alpha, sigma=h.sigma)
    res, text = extras_graph(
        driver, "primal-dual with the dual prox",
        lambda: run(prob, True, PD_DUAL_ITERS, hd),
        lambda: run(prob, True, PD_DUAL_ITERS // 2, hd))
    before = dp.device_launches()
    run(prob, True, PD_DUAL_ITERS, hd)
    dual_launches = dp.device_launches() - before
    if not (np.all(np.isfinite(res[1])) and dual_launches >= len(res[1])):
        raise AssertionError(f"primal-dual with the dual prox: "
                             f"{dual_launches} kernel launches, gaps "
                             f"{res[1]}")
    out.append(f"{text}; {dual_launches} dual prox launches in the warm "
               f"graph run of {len(res[1])} rows")
    print(f"[extras] primal-dual n={PD_N} r={PD_R} (examples/ex_primal_dual"
          f".py figure, {EX_ITERS} iterations, epsilon 1e-9; the dual prox "
          f"run {PD_DUAL_ITERS}): " + "; ".join(out), flush=True)
    return dual_launches


def extras_universal_fw(port, driver):
    """Phase 4k: UniversalGM through the FW-as-prox adapter on the noisy
    SymNMF of examples/ex_universal_fw.py, as graphs against eager (the
    noise key chain inside the graph); the noise reaches the run."""
    rng = np.random.default_rng(0)
    xv = rng.random(UFW_N)
    M_ = np.outer(xv, xv)
    X0 = np.ones((UFW_N, UFW_R)) + 1e-5
    h_fw = port.SumOf2nd4thPowersWithFrankWolfe(
        alpha=6.0, sigma=2.0 * np.linalg.norm(M_, 2),
        lmo=port.lmo_linf_ball(1.0, center=1.0))
    out = []
    for noise in UFW_NOISES:
        def run(noise_level=noise, it=EX_ITERS):
            f = port.FrobeniusSymLoss.create(
                M_, X0, noise_level=noise_level or None, device="cuda")
            return port.UniversalGM(f, h_fw, 1.0, X0, it,
                                    noise_level=noise_level, epsilon=1e-9,
                                    verbose=False, seed=0)

        res, text = extras_graph(driver, f"UniversalGM-FW noise {noise}",
                                 run, lambda: run(it=EX_COST_ITERS))
        F = np.asarray(res[1])
        clean = np.asarray(run(0)[1])
        if not np.all(np.isfinite(F)) or (len(F) == len(clean)
                                          and np.array_equal(F, clean)):
            raise AssertionError(f"UniversalGM-FW noise {noise}: finite "
                                 f"{np.all(np.isfinite(F))}, same as the "
                                 "noiseless run")
        out.append(f"{text}; F {F[0]:.6e} -> {F[-1]:.6e} (noiseless F[-1] "
                   f"{clean[-1]:.6e})")
    print(f"[extras] UniversalGM-FW SymNMF n={UFW_N} r={UFW_R} (examples/"
          f"ex_universal_fw.py, {EX_ITERS} iterations, seed 0): "
          + "; ".join(out), flush=True)


def stochastic_runs(port):
    """The stochastic SymNMF 200x20 (noise 0.05, seed 5) under ABPG_gain
    and FW_alg_descent_step: ``{name: run(it=STOCH_ITERS)}``."""
    M_ = symnmf_matrix(200)
    np.random.seed(3)
    f, (h, _), L, X0 = port.FrobeniusSymLossResMeasEx(M_, 20, noise=0.05,
                                                      device="cuda")
    # one LMO for every run: a graph is cached on the closure it captured
    lmo = port.lmo_linf_ball(1.0, 1.0)
    return {
        "ABPG_gain": lambda it=STOCH_ITERS: port.ABPG_gain(
            f, h, L, X0, 2.0, it, verbose=False, seed=5),
        "FW_alg_descent_step": lambda it=STOCH_ITERS:
            port.FW_alg_descent_step(f, h, X0, it, lmo, verbose=False,
                                     seed=5),
    }


def rows_digest(res):
    """A digest of a run's F rows and iterate (equal digests: equal bits)."""
    return hashlib.sha256(np.asarray(res[1]).tobytes()
                          + res[0].cpu().numpy().tobytes()).hexdigest()[:16]


def stochastic_walls(port, driver, rng):
    """``--blocks-only``: the stochastic runs through the public drivers as
    graphs, the SymNMF 200x20 ones of ``stochastic_runs`` and AIBM with
    noise 1e-6 on phase 4k's Poisson problem (EXP_ITERS iterations): per
    run the nodes per graph (one capture at a cold run), two warm walls,
    the threefry launches of a warm run by the card's count, and the
    digests of the rows and iterate as graphs and under ``eager_chunks``
    (equal within a commit; across commits where the bits are)."""
    runs = stochastic_runs(port)
    np.random.seed(1)
    f, _, L, x0 = port.Poisson_regr_simplex_acc(EXP_M, EXP_N, noise=0.001,
                                                device="cuda")
    h = port.BurgEntropySimplex(eps=1e-7, use_pallas=True)
    runs["AIBM noise=1e-6"] = lambda: port.AIBM(
        f, h, L, x0, gamma=EXP_GAMMA, maxitrs=EXP_ITERS, epsilon=1e-12,
        noise=1e-6, verbose=False)
    out = []
    for name, run in runs.items():
        driver.clear_graph_cache()
        run()
        nodes = graph_nodes(list(driver._GRAPHS.values()))
        walls = []
        for _ in range(2):
            rng.reset_device_launches()
            res, wall, _ = synced(run)
            walls.append(f"{wall:.3f}")
        drawn = {e: rng.device_launches(e) for e in rng.ENTRIES}
        with driver.eager_chunks():
            eager = run()
        out.append(f"{name} {len(res[1])} rows: graph {' '.join(walls)} s, "
                   f"{nodes} nodes, threefry launches {drawn}, rows "
                   f"{rows_digest(res)} as graphs, {rows_digest(eager)} "
                   "eagerly")
    return "; ".join(out)


def stochastic_graphs(port, driver):
    """Phase 4k: a stochastic f-oracle (its gradients draw normals from the
    device key chain) under ABPG_gain and FW_alg_descent_step on SymNMF
    200x20 at noise 0.05 (STOCH_ITERS iterations), as graphs against
    eager, every row bit for bit; the threefry kernel's launches in the
    warm graph runs by the card's count, per entry and per iteration (each
    noisy gradient one launch of the draw entry, no split)."""
    from accbpg_and_fw_tpu_torch import _rng

    out = []
    for name, run in stochastic_runs(port).items():
        res, text = extras_graph(driver, f"stochastic {name}", run,
                                 lambda: run(EX_COST_ITERS))
        before = {e: _rng.device_launches(e) for e in _rng.ENTRIES}
        run()
        drawn = {e: _rng.device_launches(e) - before[e]
                 for e in _rng.ENTRIES}
        F = np.asarray(res[1])
        # each noisy gradient is one launch of the draw entry (its noise
        # mode: the split, the normals, the shift, scale and add)
        if not (np.all(np.isfinite(F)) and drawn["draw"] >= len(F)
                and drawn["split"] == 0):
            raise AssertionError(f"stochastic {name}: threefry launches "
                                 f"{drawn}")
        per = ", ".join(f"{e} {n} ({n / len(F):.2f} an iteration)"
                        for e, n in drawn.items())
        out.append(f"{text}; threefry launches in the warm graph run: "
                   f"{per}")
    print(f"[extras] stochastic SymNMF 200x20 noise 0.05 ({STOCH_ITERS} "
          f"iterations, seed 5): " + "; ".join(out), flush=True)


def past_rtol(F, ref):
    """The first row where F leaves ``ref`` by more than EX_RTOL (the rows
    both have where it never does)."""
    n = min(len(F), len(ref))
    err = np.abs(np.asarray(F[:n]) - ref[:n]) / np.abs(ref[:n])
    return int(np.argmax(err > EX_RTOL)) if np.any(err > EX_RTOL) else n


def extras_examples(driver):
    """Phase 4k: the four examples' start() with their import changed to
    the port's, at small arguments, on the card; ex_aibm_svm's eagerly:
    as graphs it took 26 s, recapturing the SVM ball's PolyDiv graphs (22
    s of captures in the phase's own SVM runs), and eagerly 3.4 s."""
    calls = {
        "ex_aibm_poisson": lambda m: [F for c in m.start(
            m=200, n=100, maxitrs=100, gammas=(2.0,),
            verbose=False).values() for F in c.values()],
        "ex_aibm_svm": lambda m: list(m.start(maxitrs=40, real_ds=False,
                                              verbose=False).values()),
        "ex_primal_dual": lambda m: list(m.start(maxitrs=100,
                                                 verbose=False)),
        "ex_universal_fw": lambda m: [F for c in m.start(
            n=100, maxitrs=50, verbose=False).values() for F in c.values()],
    }
    out = []
    for name, call in calls.items():
        module = example_module(name)
        t = time.perf_counter()
        if name == "ex_aibm_svm":
            with driver.eager_chunks():
                curves = call(module)
        else:
            curves = call(module)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if not all(np.all(np.isfinite(np.asarray(F))) for F in curves):
            raise AssertionError(f"{name}: a curve is not finite")
        out.append(f"{name}.start() {wall:.2f} s, {len(curves)} finite "
                   "curves")
    print("[extras] examples with the import changed, on cuda (ex_aibm_svm "
          "eagerly): " + "; ".join(out), flush=True)


def extras_paths(port, card, counters, sm):
    """Phase 4k: the inexact-oracle and constrained drivers as graph chunks
    against eager_chunks, the stochastic Bregman and FW runs, and the
    examples; of the D-opt kernels none may launch.  Every count is set to
    0 just before the phase and read just after.  Returns the launches of
    kernel 5, of the threefry kernel's two entries and of the dual prox
    kernel, by the card's counts."""
    from accbpg_and_fw_tpu_torch import _rng
    from accbpg_and_fw_tpu_torch.algorithms import driver
    from accbpg_and_fw_tpu_torch.ops import dual_prox as dp

    for mod, name in counters:
        setattr(mod, name, 0)
    _rng.reset_device_launches()
    dp.reset_device_launches()
    t = time.perf_counter()
    parts = []

    def part(label, fn, *args):
        t_part = time.perf_counter()
        out = fn(*args)
        parts.append(f"{label} {time.perf_counter() - t_part:.1f} s")
        return out

    aibm = part("Poisson", extras_poisson, port, sm, driver, card)
    part("SVM", extras_svm, port, driver)
    part("primal-dual", extras_primal_dual, port, driver)
    part("UniversalGM-FW", extras_universal_fw, port, driver)
    part("stochastic", stochastic_graphs, port, driver)
    part("examples", extras_examples, driver)
    launched = {f"{mod.__name__.rsplit('.', 1)[1]}.{name}":
                getattr(mod, name) for mod, name in counters}
    drawn = {entry: _rng.device_launches(entry) for entry in _rng.ENTRIES}
    dual = dp.device_launches()
    if any(v for k, v in launched.items() if not k.startswith("simplex")):
        raise AssertionError(f"the extras launched a D-opt kernel: "
                             f"{launched}")
    if aibm < 1 or not all(drawn.values()) or dual < 1:
        raise AssertionError(f"kernel launches: {launched}, AIBM {aibm}, "
                             f"threefry {drawn}, dual prox {dual}")
    print(f"[extras] phase 4k in {time.perf_counter() - t:.1f} s ("
          f"{', '.join(parts)}); kernel "
          f"launches by the cards' counts: {launched}, threefry {drawn}, "
          f"dual prox {dual}; {aibm} of kernel 5's in AIBM's last Poisson "
          "run", flush=True)
    return launched["simplex_device.LAUNCHES"], drawn, dual


# ---- phases 4l-4n: fast_gram, sharding, diagnostics and examples ------------


class DeviceCount:
    """Kernel 5's launch count on the card as a counter of the phases'
    ``(module, name)`` pairs: a graph's replays count there, not in the
    wrapper's host count."""

    def __init__(self, sm):
        self.sm = sm
        # read_counts keys it "simplex_device.LAUNCHES": a kernel 5 count
        self.__name__ = "ops.simplex_device"

    @property
    def LAUNCHES(self):
        return self.sm.device_launches()

    @LAUNCHES.setter
    def LAUNCHES(self, value):
        self.sm.reset_device_launches()


def reset_counts(counters):
    for mod, name in counters:
        setattr(mod, name, 0)


def read_counts(counters):
    return {f"{mod.__name__.rsplit('.', 1)[1]}.{name}": getattr(mod, name)
            for mod, name in counters}


def no_launches(label, counters):
    launched = read_counts(counters)
    if any(launched.values()):
        raise AssertionError(f"{label} launched a kernel: {launched}")
    return launched


def fg_text(tally, rows):
    """The fast-Gram gates of a run (``fastgram.TALLY``): decisions and
    fallbacks per gate, per iteration."""
    gates = sum(sum(c.values()) for c in tally.values())
    falls = sum(c.get(False, 0) for c in tally.values())
    per = "; ".join(f"{name} {c.get(False, 0)} of {sum(c.values())}"
                    for name, c in sorted(tally.items()))
    return (f"{gates} gates ({gates / rows:.2f} per iteration), {falls} "
            f"fallbacks ({100 * falls / max(gates, 1):.2f}%: {per})")


def fastgram_paths(port, counters, plain_wall):
    """Phase 4l: the fast_gram steps as graph chunks, which launch none of
    the eight kernels (their counts go to 0 just before the phase and are
    read just after).  ABPG_gain(fast_gram=True) at full width (30x10000,
    9000 iterations) with the default h: the [bregman graph] measures
    beside phase 4e's wall (``plain_wall``), and the gates' fallbacks and
    the loops' bodies over a tallied eager run of its first
    FG_TALLY_ITERS iterations; then BPG (line search), ABPG, ABPG_expo and
    ABDA with fast_gram at 30x1000 as graphs against ``eager_chunks`` and
    against the CPU."""
    from accbpg_and_fw_tpu_torch import _loops
    from accbpg_and_fw_tpu_torch.algorithms import driver, fastgram

    reset_counts(counters)
    t0 = t = time.perf_counter()
    parts = []
    f, _, L, x0 = port.D_opt_design(GAIN_M, GAIN_N, randseed=10,
                                    device="cuda")
    h = port.BurgEntropySimplex()

    def run_l(maxitrs, checkpoint=None):
        return port.ABPG_gain(f, h, L, x0, gamma=2, maxitrs=maxitrs,
                              verbose=False, fast_gram=True,
                              checkpoint=checkpoint)

    def check(res):
        x, F, Gain = res[0], res[1], res[2]
        Ff = fresh_F(f, x)
        if not (np.all(np.isfinite(F)) and Ff <= GAIN_F_BOUND):
            raise AssertionError(f"ABPG_gain fast_gram: fresh F {Ff!r} "
                                 f"above {GAIN_F_BOUND}")
        trials = int(gain_trials(Gain, 1.0, 1.2).sum())
        return (f"{trials} line-search trials; fresh F {Ff:.9f} (recorded "
                f"{F[-1]:.9f}, bound {GAIN_F_BOUND})")

    _, text, wall = bregman_graph(
        driver, f"ABPG_gain gamma=2 fast_gram=True {GAIN_M}x{GAIN_N} "
        "default h", run_l, GAIN_ITERS, check)
    print(f"[fastgram] {text}; the graph's wall {wall:.3f} s against phase "
          f"4e's plain graph route {plain_wall:.3f} s in this call (the "
          f"host loop it replaces took {FG_HOST_LOOP_S} on an H100 80GB "
          "HBM3 at 700 W)",
          flush=True)
    parts.append(f"graph path {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    fastgram.TALLY[0], _loops.TALLY[0] = {}, {}
    try:
        with driver.eager_chunks():
            res = run_l(FG_TALLY_ITERS)
        tally, bodies = fastgram.TALLY[0], _loops.TALLY[0]
    finally:
        fastgram.TALLY[0] = _loops.TALLY[0] = None
    print(f"[fastgram] gates over the first {len(res[1])} iterations "
          f"(eager_chunks, one read per gate): "
          f"{fg_text(tally, len(res[1]))}; bodies taken per loop: "
          + "; ".join(f"{loop} {sorted(counts.items())}"
                      for loop, counts in bodies.items()), flush=True)
    parts.append(f"tally {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    print(f"[fastgram] ABPG_gain fast_gram: "
          f"{resume_check(driver, 'gain_fastgram', run_l)}", flush=True)
    parts.append(f"checkpoint {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()

    fc, hc, Lc, xc = port.D_opt_design(BPG_M, BPG_N, randseed=10,
                                       device="cuda")
    fh, hh, _, xh = port.D_opt_design(BPG_M, BPG_N, randseed=10,
                                      device="cpu")
    calls = {
        "BPG": lambda f_, h_, x_: port.BPG(
            f_, h_, Lc, x_, FG_SMALL_ITERS, linesearch=True, verbose=False,
            fast_gram=True),
        "ABPG": lambda f_, h_, x_: port.ABPG(
            f_, h_, Lc, x_, 2.0, FG_SMALL_ITERS, verbose=False,
            fast_gram=True),
        "ABPG_expo": lambda f_, h_, x_: port.ABPG_expo(
            f_, h_, Lc, x_, 3.0, FG_SMALL_ITERS, verbose=False,
            fast_gram=True),
        "ABDA": lambda f_, h_, x_: port.ABDA(
            f_, h_, Lc, x_, 2.0, FG_SMALL_ITERS, verbose=False,
            fast_gram=True),
    }
    small = []
    for name, call in calls.items():
        res, w, text = fw_graph(driver, f"fast_gram {name}",
                                lambda: call(fc, hc, xc))
        with driver.eager_chunks():
            eager = call(fc, hc, xc)
        agree = same_rows(f"fast_gram {name}", res, eager, FG_SMALL_ITERS)
        Fg = res[1]
        Fcpu = call(fh, hh, xh)[1]
        err = fw_against_cpu(f"{name} fast_gram", Fg, Fcpu, rows=FG_CPU_ROWS,
                             rtol=FG_RTOL)
        small.append(f"{name} warm wall {w:.3f} s, {len(Fg)} rows, F "
                     f"{Fg[-1]:.9f} (CPU {Fcpu[-1]:.9f}), card vs CPU "
                     f"{err:.1e} over {FG_CPU_ROWS} rows, eager_chunks "
                     f"{agree}, {text}")
    launched = no_launches("phase 4l", counters)
    print(f"[fastgram] {BPG_M}x{BPG_N} seed 10 default h, "
          f"{FG_SMALL_ITERS} iterations, fast_gram=True as graphs: "
          + "; ".join(small), flush=True)
    parts.append(f"four drivers {time.perf_counter() - t:.1f} s")
    print(f"[fastgram] phase 4l in {time.perf_counter() - t0:.1f} s ("
          f"{', '.join(parts)}); kernel launches: {launched}", flush=True)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class span_clock:
    """While open, the host seconds graph chunks spend in their replays
    (the spans ``graph.replay`` and ``graph.read``: the launches, the
    overflow flags' reads and the one read of the chunk's rows, which
    waits for them) and in their continuations (``graph.continuation``:
    the iteration whose bounded loops overflowed, rerun eagerly, which
    ends in its rows' read), as the driver records them
    (``diagnostics.recording``); ``split(wall)`` says what is left of a
    wall for the driver's host code around them."""

    def __init__(self):
        self.s = {"replay": 0.0, "continuation": 0.0}
        self.n = {"replay": 0, "continuation": 0}

    def __enter__(self):
        from accbpg_and_fw_tpu_torch import diagnostics

        self._rec = diagnostics.recording()
        self.spans = self._rec.__enter__()
        self.start = len(self.spans)
        return self

    def __exit__(self, *exc):
        for _, _, _, name, t0, t1, attrs in self.spans[self.start:]:
            what = ("continuation" if name == "graph.continuation" else
                    "replay" if name in ("graph.replay", "graph.read")
                    else None)
            if what is not None:
                self.s[what] += 1e-9 * (t1 - t0)
            # a replay call ends in its one read of the chunk's rows
            self.n["replay"] += bool(attrs.get("rows"))
            self.n["continuation"] += name == "graph.continuation"
        return self._rec.__exit__(*exc)

    def split(self, wall):
        rest = wall - self.s["replay"] - self.s["continuation"]
        return (f"{self.s['replay']:.3f} s in {self.n['replay']} replay "
                f"calls, {self.s['continuation']:.3f} s in "
                f"{self.n['continuation']} continuations, {rest:.3f} s "
                "around them")


def sharded_run(driver, run):
    """``run`` (a sharded solve) as graph chunks, cold (its capture) and
    warm (under ``span_clock``), then under ``eager_chunks``: ``(graph
    result, eager result, captures, the warm run's replays and
    continuations, cold s, warm s, eager s, the warm run's span_clock)``;
    the rows must agree bit for bit and the iterates too."""
    driver.clear_graph_cache()
    before = driver.GRAPH_STATS["captures"]
    walls = []
    for clock in (None, span_clock()):
        warm = dict(driver.GRAPH_STATS)
        torch.cuda.synchronize()
        t = time.perf_counter()
        if clock is None:
            res = run()
        else:
            with clock:
                res = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    captures = driver.GRAPH_STATS["captures"] - before
    spans = tuple(driver.GRAPH_STATS[k] - warm[k]
                  for k in ("replays", "continuations"))
    t = time.perf_counter()
    with driver.eager_chunks():
        eager = run()
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t)
    for a, b in zip(res[1:-1], eager[1:-1]):
        if not np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True):
            raise AssertionError("a sharded graph's rows differ from "
                                 "eager_chunks'")
    if not torch.equal(res[0].full_tensor(), eager[0].full_tensor()):
        raise AssertionError("a sharded graph's iterate differs from "
                             "eager_chunks'")
    if captures < 1:
        raise AssertionError("a sharded solve was not captured")
    return (res, eager, captures, spans) + tuple(walls) + (clock,)


def sharded_paths(port, counters):
    """Phase 4m: a world-size-1 NCCL group in this process and a one-card
    mesh: ``shard_dopt_problem`` under ABPG_gain(fast_gram=True) and
    ``shard_dopt_design`` under D_opt_FW_away on the exact engine, each as
    graph chunks (``sharded_run``: captured, rows bit for bit with
    ``eager_chunks``) and against the same solve unsharded on the card (a
    graph).  No kernel may launch."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from accbpg_and_fw_tpu_torch.algorithms import d_opt, driver
    from accbpg_and_fw_tpu_torch.parallel import (data_mesh,
                                                  shard_dopt_design,
                                                  shard_dopt_problem)

    reset_counts(counters)
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = data_mesh()
        if mesh.device_type != "cuda":
            raise AssertionError(f"data_mesh() on {mesh.device_type}")
        f, h, L, x0 = port.D_opt_design(GAIN_M, GAIN_N, randseed=10,
                                        device="cuda")
        f_sh, x_sh = shard_dopt_problem(f, x0, mesh)
        kw = dict(gamma=2, maxitrs=SH_GAIN_ITERS, verbose=False,
                  fast_gram=True)
        (r_sh, _, g_caps, g_spans, g_cold, g_warm, g_eager,
         g_clock) = sharded_run(
            driver, lambda: port.ABPG_gain(f_sh, h, L, x_sh, **kw))
        w_pl = []
        for pl_clock in (None, span_clock()):  # captured, replayed
            pl_stats = dict(driver.GRAPH_STATS)
            torch.cuda.synchronize()
            t = time.perf_counter()
            if pl_clock is None:
                r_pl = port.ABPG_gain(f, h, L, x0, **kw)
            else:
                with pl_clock:
                    r_pl = port.ABPG_gain(f, h, L, x0, **kw)
            torch.cuda.synchronize()
            w_pl.append(time.perf_counter() - t)
        pl_spans = tuple(driver.GRAPH_STATS[k] - pl_stats[k]
                         for k in ("replays", "continuations"))
        if not isinstance(r_sh[0], DTensor):
            raise AssertionError("the sharded ABPG_gain returned a plain "
                                 "tensor")
        if len(r_sh[1]) != len(r_pl[1]):
            raise AssertionError(f"sharded ABPG_gain: {len(r_sh[1])} rows, "
                                 f"unsharded {len(r_pl[1])}")
        np.testing.assert_allclose(r_sh[1], r_pl[1], rtol=1e-12)
        np.testing.assert_allclose(r_sh[0].full_tensor().cpu().numpy(),
                                   r_pl[0].cpu().numpy(), rtol=0,
                                   atol=1e-12)
        gerr = float(np.max(np.abs(r_sh[1] - r_pl[1]) / np.abs(r_pl[1])))

        fd, _, _, xd = port.D_opt_design(BPG_M, BPG_N, randseed=10,
                                         device="cuda")
        V_sh, xd_sh = shard_dopt_design(fd.H, xd, mesh)
        engine = d_opt._resolve_auto_u_mode(V_sh, "auto", V_sh.device)
        plain_engine = d_opt._resolve_auto_u_mode(fd.H, "auto", fd.H.device)
        if engine != "exact":
            raise AssertionError(f"'auto' took {engine} for a sharded design")
        fw_sh, _, f_caps, _, f_cold, f_warm, f_eager, f_clock = sharded_run(
            driver, lambda: port.D_opt_FW_away(V_sh, xd_sh, EPS, SH_FW_ITERS,
                                               verbose=False))
        torch.cuda.synchronize()
        t = time.perf_counter()
        fw_pl = port.D_opt_FW_away(fd.H, xd, EPS, SH_FW_ITERS, verbose=False,
                                   u_mode="exact")
        torch.cuda.synchronize()
        wf_pl = time.perf_counter() - t
        if len(fw_sh[1]) != len(fw_pl[1]):
            raise AssertionError(f"sharded FW-away: {len(fw_sh[1])} rows, "
                                 f"unsharded {len(fw_pl[1])}")
        np.testing.assert_allclose(fw_sh[1], fw_pl[1], rtol=1e-12)
        ferr = float(np.max(np.abs(fw_sh[1] - fw_pl[1]) / np.abs(fw_pl[1])))
        refused = []
        for mode in ("pallas", "pallas_lazy"):
            try:
                port.D_opt_FW_away(V_sh, xd_sh, EPS, 5, verbose=False,
                                   u_mode=mode)
            except ValueError:
                refused.append(mode)
        if refused != ["pallas", "pallas_lazy"]:
            raise AssertionError(f"kernel modes on a sharded design: only "
                                 f"{refused} refused")
        launched = no_launches("phase 4m", counters)
        aibm = sharded_aibm(port, driver, mesh, counters)
    finally:
        dist.destroy_process_group()
    print(f"[sharded] one card, a world-size-1 NCCL group and data_mesh() "
          f"on cuda (the code path of a sharded solve and its capture, not "
          f"collectives across cards): ABPG_gain fast_gram {GAIN_M}x{GAIN_N} "
          f"{SH_GAIN_ITERS} iterations sharded as graphs ({g_caps} "
          f"captures) {g_cold:.3f} s cold (capture included), {g_warm:.3f} "
          f"s warm ({g_spans[0]} replays, {g_spans[1]} continuations; "
          f"{g_clock.split(g_warm)}), rows "
          f"and x bit for bit with the sharded eager_chunks run "
          f"{g_eager:.3f} s; the unsharded graph {w_pl[0]:.3f} s cold, "
          f"{w_pl[1]:.3f} s warm ({pl_spans[0]} replays, {pl_spans[1]} "
          f"continuations; {pl_clock.split(w_pl[1])}); F max rel "
          f"diff to the unsharded {gerr:.1e} (bar 1e-12), x a DTensor "
          f"{r_sh[0].placements}; D_opt_FW_away {BPG_M}x{BPG_N} on "
          f"shard_dopt_design: 'auto' took {engine} (unsharded: "
          f"{plain_engine}), {len(fw_sh[1])} rows as graphs ({f_caps} "
          f"captures) {f_cold:.3f} s cold, {f_warm:.3f} s warm "
          f"({f_clock.split(f_warm)}), bit for bit "
          f"with eager_chunks {f_eager:.3f} s; the unsharded exact engine "
          f"{wf_pl:.3f} s; F max rel diff {ferr:.1e}; u_mode {refused} "
          f"refused", flush=True)
    print(f"[sharded] {aibm}", flush=True)
    print(f"[sharded] phase 4m in {time.perf_counter() - t0:.1f} s; kernel "
          f"launches before AIBM: {launched}", flush=True)


def sharded_aibm(port, driver, mesh, counters):
    """Phase 4m's AIBM: examples/ex_aibm_poisson.py's 2000x1000 Poisson
    problem (seed 1) placed by ``shard_regression_problem`` (samples
    sharded, x replicated) under AIBM with the default simplex prox, as
    graph chunks against ``eager_chunks`` bit for bit (``sharded_run``)
    and its first SH_AIBM_HELD rows against the same solve unsharded on
    the card at rtol 1e-9: the k=0 set-up and the steps reduce the
    partial gradient before the prox.
    Only the threefry split entry may launch (one noise draw an
    iteration).  Returns the ``[sharded]`` text."""
    from accbpg_and_fw_tpu_torch.parallel import shard_regression_problem

    np.random.seed(1)
    f, _, L, x0 = port.Poisson_regr_simplex_acc(EXP_M, EXP_N, noise=0.001,
                                                device="cuda")
    f_sh, x_sh = shard_regression_problem(f, x0, mesh)
    h = port.BurgEntropySimplex(eps=1e-7)

    def run(f_, x_):
        return port.AIBM(f_, h, L, x_, gamma=EXP_GAMMA,
                         maxitrs=SH_AIBM_ITERS, epsilon=1e-12, verbose=False)

    reset_counts(counters)
    (res, _, caps, spans, cold, warm, eager,
     clock) = sharded_run(driver, lambda: run(f_sh, x_sh))
    launched = {k: v for k, v in read_counts(counters).items() if v}
    if set(launched) - {"_rng.SPLIT_LAUNCHES"}:
        raise AssertionError(f"sharded AIBM launched {launched}")
    plain = run(f, x0)
    F, F_pl = np.asarray(res[1]), np.asarray(plain[1])
    if not np.all(np.isfinite(F)):  # (its first rows need not fall)
        raise AssertionError(f"sharded AIBM: F {F[0]} -> {F[-1]}")
    # the first rows against the unsharded run at 1e-9; later a line
    # search's decision may flip on last-bit differences of other
    # kernels' sums, and the accelerated run parts from there
    np.testing.assert_allclose(F[:SH_AIBM_HELD], F_pl[:SH_AIBM_HELD],
                               rtol=1e-9)
    n = min(len(F), len(F_pl))
    off = np.abs(F[:n] - F_pl[:n]) > 1e-9 * np.abs(F_pl[:n])
    past = int(np.argmax(off)) if off.any() else "none"
    return (f"AIBM Poisson {EXP_M}x{EXP_N} on shard_regression_problem, "
            f"{SH_AIBM_ITERS} iterations as graphs ({caps} captures) "
            f"{cold:.3f} s cold, {warm:.3f} s warm ({spans[0]} replays, "
            f"{spans[1]} continuations; {clock.split(warm)}), rows and x "
            f"bit for bit with eager_chunks {eager:.3f} s; F {F[0]:.6e}"
            f" -> {F[-1]:.6e}; the unsharded graph's first {SH_AIBM_HELD} "
            f"rows within 1e-9, the first row past it {past}; x "
            f"{res[0].placements}; launches "
            f"{launched}")


class _JnpOnCard:
    """The one ``jax.numpy`` call of examples/ex_Dopt_sweep.py's
    ``start_full``, ``jnp.asarray(a, dtype)``, as a float64 tensor on the
    card."""

    @staticmethod
    def asarray(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device="cuda")


def diagnostics_and_examples(port, counters):
    """Phase 4n: ``profile_trace`` and ``debug_mode`` on a short solve, then
    examples/ex_Poisson_KL.py's ``poisson`` and ``kl_regression`` and
    examples/ex_SymNMF.py's ``start`` at their default sizes with the
    import changed to the port's (no kernel may launch), and
    examples/ex_Dopt_sweep.py's ``start_full(fast_gram=True)``, whose
    FW rows run "auto" on the card (its kernel launches are reported)."""
    from accbpg_and_fw_tpu_torch import diagnostics

    reset_counts(counters)
    t0 = time.perf_counter()
    f, h, L, x0 = port.D_opt_design(BPG_M, BPG_N, randseed=10,
                                    device="cuda")
    logdir = pathlib.Path(__file__).parent / "build" / "traces"
    before = set(logdir.glob("*.json")) if logdir.exists() else set()
    with diagnostics.profile_trace(str(logdir)):
        port.BPG(f, h, L, x0, 20, verbose=False, fast_gram=True)
        torch.cuda.synchronize()
    new = sorted(set(logdir.glob("*.json")) - before)
    if len(new) != 1:
        raise AssertionError(f"profile_trace wrote {len(new)} traces")
    trace = json.loads(new[0].read_text())
    kernels = sum(1 for e in trace.get("traceEvents", ())
                  if e.get("cat") == "kernel")
    bad = x0.clone()
    bad[3] = float("nan")
    try:
        with diagnostics.debug_mode():
            port.BPG(f, h, L, bad, 20, verbose=False)
        raise AssertionError("debug_mode let a NaN solve through")
    except FloatingPointError as e:
        caught = str(e).split(" (")[0]
    print(f"[diagnostics] profile_trace wrote {new[0].name} "
          f"({new[0].stat().st_size} bytes, {kernels} device kernel "
          f"events); debug_mode raised FloatingPointError on a NaN start: "
          f"{caught!r}", flush=True)

    out = []
    for name, call in (
            ("ex_Poisson_KL.poisson",
             lambda m: m.poisson(maxitrs=EXAMPLE_ITERS, verbose=False)),
            ("ex_Poisson_KL.kl_regression",
             lambda m: m.kl_regression(maxitrs=EXAMPLE_ITERS,
                                       verbose=False)),
            ("ex_SymNMF.start", lambda m: m.start(verbose=False))):
        module = example_module(name.split(".")[0])
        t = time.perf_counter()
        curves = list(call(module).values())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if not all(np.all(np.isfinite(np.asarray(F))) for F in curves):
            raise AssertionError(f"{name}: a curve is not finite")
        out.append(f"{name}() {wall:.2f} s, {len(curves)} finite curves")
    launched = no_launches("phase 4n's examples", counters)
    print("[examples] with the import changed, at their default sizes (the "
          f"two ex_Poisson_KL runs cut to {EXAMPLE_ITERS} iterations, from "
          "10000 and 4000, for the time), on cuda: " + "; ".join(out)
          + f"; kernel launches {launched}", flush=True)

    module = example_module("ex_Dopt_sweep", (
        ("from accbpg_and_fw_tpu.parallel.batched import dopt_fw_batch",
         "from accbpg_and_fw_tpu_torch.parallel.batched import "
         "dopt_fw_batch"),
        ('    import jax\n    jax.config.update("jax_enable_x64", True)\n'
         '    import jax.numpy as jnp\n', ""),
        ("V = np.asarray(f.H, np.float64)",
         "V = np.asarray(f.H.cpu(), np.float64)")))
    module.jnp = _JnpOnCard()
    t = time.perf_counter()
    module.start_full(K=SWEEP_K, num_iters=SWEEP_ITERS, verbose=False,
                      fast_gram=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    print(f"[examples] ex_Dopt_sweep.start_full(fast_gram=True, K={SWEEP_K}, "
          f"num_iters={SWEEP_ITERS}; cut from K=3, 3000 for the time) with "
          "its two imports of the JAX package changed to the port's, its "
          "three JAX lines (x64 on, jax.numpy) dropped for jnp.asarray as a "
          "float64 tensor on the card, and f.H read back with .cpu() "
          f"before np.asarray: {wall:.2f} s; its FW rows' kernel "
          f"launches (\"auto\") {read_counts(counters)}", flush=True)
    print(f"[examples] phase 4n in {time.perf_counter() - t0:.1f} s",
          flush=True)


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
    from accbpg_and_fw_tpu_torch.ops import dual_prox as dp
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
    G, X0, kw = study_prox(port, dev)
    steps = float(dp.dual_prox(G, X0, 1.0, **kw)[1])
    prox_ms = [time_launches(lambda: dp.dual_prox(G, X0, 1.0, **kw), 10)
               for _ in range(2)]
    print(f"[blocks] {root}: dual prox 400x10 ({steps:.0f} steps): "
          + ", ".join(f"{t:.3f} ms ({1e3 * t / steps:.3f} us a step)"
                      for t in prox_ms), flush=True)
    svd_times(root)
    from accbpg_and_fw_tpu_torch import _rng
    from accbpg_and_fw_tpu_torch.algorithms import driver

    print(f"[blocks] {root}: threefry: {threefry_walls(_rng, dev)}",
          flush=True)
    print(f"[blocks] {root}: stochastic: "
          f"{stochastic_walls(port, driver, _rng)}", flush=True)

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
        # a graph replays launches without the wrapper: the card counts them
        # where the checkout has that count
        count = getattr(sm, "device_launches", lambda: sm.LAUNCHES)
        getattr(sm, "reset_device_launches", lambda: None)()
        sm.LAUNCHES = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        Fg = port.ABPG_gain(f, h, L, xg, gamma=2, maxitrs=gain_iters,
                            verbose=False)[1]
        torch.cuda.synchronize()
        print(f"[blocks] {root}: ABPG_gain {GAIN_M}x{GAIN_N} use_pallas=True, "
              f"{gain_iters} iterations: wall {time.perf_counter() - t:.3f} "
              f"s, {count()} kernel launches, F {Fg[-1]:.9f}", flush=True)

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


def main_group_one(port, dl, V64, x0, got):
    """Phase 4d: the main path under the default group (one host round
    trip) against ``group=1`` (one per block) in one call: bit for bit,
    warm walls, host reads and traces."""
    dev = torch.device("cuda")

    def default():
        return port.D_opt_FW_away(V64, x0, eps=EPS, maxitrs=REF_ITERS,
                                  verbose=False)

    def one():
        return dl.dopt_fw_lazy(V64, x0, EPS, REF_ITERS, verbose=False,
                               device=dev, group=1)

    ref = one()
    if not (torch.equal(ref[0], got[0]) and all(
            np.array_equal(p, q) for p, q in zip(ref[1:4], got[1:]))):
        raise AssertionError("main path: the default group and group=1 "
                             "differ")
    walls = warm_walls({"default group": lambda: reads_of(default),
                        "group=1": lambda: reads_of(one)})
    group = dl._group_size(REF_ITERS, 0, False, 256)
    print(f"[main] default group ({group} blocks) against group=1 in one "
          f"call, x, F, SP, SN bit for bit; "
          f"warm walls and host reads per solve: {walls_reads_text(walls)}",
          flush=True)
    trace_line(f"main path {M}x{N}", default, "dopt_lazy_kernel")
    trace_line(f"main path {M}x{N} group=1", one, "dopt_lazy_kernel")


def lookahead_phase(dl, V64, x0):
    """Phase 4d's lookahead: the main path's design under the benchmark's
    cap of 100000 iterations (one group of 256 blocks, the stop in block
    82) with at most ``_LOOKAHEAD`` blocks in flight, against the whole
    group enqueued (``seen_stop`` answering no, as the engine did before
    the lookahead), in turns in one call: bit for bit, then a solve's
    ``FROZEN_BLOCKS``, ``SKIPPED_BLOCKS``, kernel launches and warm
    walls."""
    V = torch.as_tensor(V64, device="cuda")
    seen_stop = dl._LazyKernel.seen_stop
    counters = ("LAUNCHES", "FROZEN_BLOCKS", "SKIPPED_BLOCKS")

    def counted():
        before = [getattr(dl, c) for c in counters]
        out = dl.dopt_fw_lazy(V, x0, EPS, LOOKAHEAD_CAP, verbose=False)
        return out, [getattr(dl, c) - b for c, b in zip(counters, before)]

    def whole_group():
        dl._LazyKernel.seen_stop = lambda self, slot: False
        try:
            return counted()
        finally:
            dl._LazyKernel.seen_stop = seen_stop

    runs = {"lookahead": counted, "whole group": whole_group}
    seen = {name: [] for name in runs}
    for _ in range(3):  # the first warms up
        for name, run in runs.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            out, counts = run()
            torch.cuda.synchronize()
            seen[name].append((time.perf_counter() - t, out, counts))
    (_, a, _), (_, b, _) = seen["lookahead"][0], seen["whole group"][0]
    if not (torch.equal(a[0], b[0]) and all(
            np.array_equal(p, q) for p, q in zip(a[1:4], b[1:4]))):
        raise AssertionError("lookahead: x, F, SP, SN differ from the "
                             "whole group's")
    frozen = seen["lookahead"][-1][2][1]
    if frozen > dl._LOOKAHEAD - 1:
        raise AssertionError(f"lookahead: {frozen} frozen blocks, more "
                             f"than {dl._LOOKAHEAD - 1}")
    text = "; ".join(
        f"{name}: launches {v[-1][2][0]}, frozen {v[-1][2][1]}, skipped "
        f"{v[-1][2][2]}, warm walls "
        + " ".join(f"{w:.4f}" for w, _, _ in v[1:]) + " s"
        for name, v in seen.items())
    print(f"[lookahead] ({card_line()}) {M}x{N} cap {LOOKAHEAD_CAP} "
          f"({len(a[1])} iterations, group "
          f"{dl._group_size(LOOKAHEAD_CAP, 0, False, 256)}, "
          f"_LOOKAHEAD {dl._LOOKAHEAD}), x, F, SP, SN bit for bit: {text}",
          flush=True)


def host_launches(run):
    """Runtime calls that launch work on the card (kernels, graphs, copies,
    fills) in one call of ``run``, from a CPU-side trace."""
    from torch.profiler import ProfilerActivity, profile

    names = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch",
             "cudaMemcpyAsync", "cudaMemsetAsync", "cuLaunchKernel")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.name in names)


def graph_against_eager(driver, label, run, short, cpu_F, cpu_rows):
    """One path of phase 4o: ``run`` (a solve returning ``(x, F, ...)``)
    as a graph, captured at its first call (the cache cleared) and
    replayed at its second, against the eager loop: bit for bit, or within
    1e-13 relative where cuBLAS took another algorithm under capture (then
    said); the card against the CPU's F (``cpu_F``) at rtol 1e-9 over
    ``cpu_rows`` rows; walls, captures, replays, host launches per chunk
    (``short(n)``: the same solve with a budget of n; a graph chunk's
    launches are those of 512 less those of 256, an eager chunk's those of
    256 less the graph run's set-up), capture time and the graph's
    memory.  Returns the line's text."""
    driver.clear_graph_cache()
    before = dict(driver.GRAPH_STATS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    first = run()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t
    captures = driver.GRAPH_STATS["captures"] - before["captures"]
    entries = list(driver._GRAPHS.values())
    mid = dict(driver.GRAPH_STATS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    graph = run()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t
    replays = driver.GRAPH_STATS["replays"] - mid["replays"]
    again = driver.GRAPH_STATS["captures"] - mid["captures"]
    if captures != 1 or again:
        raise AssertionError(f"{label}: {captures} captures at the first "
                             f"solve, {again} at the second (1 and 0)")
    one = host_launches(lambda: short(256))
    graph_launches = host_launches(lambda: short(512)) - one
    with driver.eager_chunks():
        torch.cuda.synchronize()
        t = time.perf_counter()
        eager = run()
        torch.cuda.synchronize()
        eager_wall = time.perf_counter() - t
        # the set-up outside the chunks is the graph run's
        eager_launches = host_launches(lambda: short(256)) - (
            one - graph_launches)
    F_g, F_e = np.asarray(graph[1]), np.asarray(eager[1])
    same = (torch.equal(graph[0], eager[0]) and np.array_equal(F_g, F_e)
            and np.array_equal(np.asarray(first[1]), F_g))
    if same:
        agree = "bit for bit"
    else:
        if len(F_g) != len(F_e):
            raise AssertionError(f"{label}: {len(F_g)} rows as a graph, "
                                 f"{len(F_e)} eager")
        rel = float(np.max(np.abs(F_g - F_e) / np.abs(F_e)))
        if not rel <= 1e-13:
            raise AssertionError(f"{label}: graph vs eager F rel err "
                                 f"{rel:.3e} > 1e-13")
        agree = (f"F within {rel:.1e} relative (not bit for bit: cuBLAS "
                 f"may pick another algorithm for a GEMV under capture)")
    err = fw_against_cpu(label, F_g, cpu_F, rows=cpu_rows)
    pool = sum(e.pool_bytes for e in entries) / 2 ** 20
    cap_s = sum(e.capture_s for e in entries)
    return (f"{label}: {len(F_g)} rows; graph {warm:.3f} s warm ({cold:.3f} "
            f"s with the capture of {cap_s:.3f} s), eager {eager_wall:.3f} "
            f"s; {replays} replays a solve, {graph_launches} host launches "
            f"per chunk against {eager_launches} eager; graph "
            f"memory {pool:.1f} MiB; graph vs eager {agree}; card vs CPU "
            f"{err:.1e} over {cpu_rows or len(F_g)} rows")


def graph_paths(port, card, counters):
    """Phase 4o: the graph chunk on the exact D-opt engine and on
    ``FW_alg_descent_step`` (phase 4i's problems), each against the eager
    loop and the CPU; a failed capture raises.  No kernel launches."""
    from accbpg_and_fw_tpu_torch.algorithms import driver

    reset_counts(counters)
    t0 = time.perf_counter()
    lines = []
    V, x0, F_cpu = CPU_RUNS["exact"]  # phase 4c's CPU run
    lines.append(graph_against_eager(
        driver, f"exact engine {DENSE_M}x{DENSE_N} eps 1e-8",
        lambda: port.D_opt_FW_away(V, x0, EPS, DENSE_BUDGET, verbose=False,
                                   u_mode="exact"),
        lambda n: port.D_opt_FW_away(V, x0, EPS, n, verbose=False,
                                     u_mode="exact"),
        F_cpu, 300))

    f, h, x_ill, F_cpu = CPU_RUNS["illcond"]  # phase 4i's problem and run
    lmo = port.lmo_l2_ball(FW_ILL["radius"])
    lines.append(graph_against_eager(
        driver, f"FW_alg_descent_step illcond {FW_NS}x{FW_NF}",
        lambda: port.FW_alg_descent_step(f, h, x_ill, FW_ITERS, lmo,
                                         verbose=False),
        lambda n: port.FW_alg_descent_step(f, h, x_ill, n, lmo,
                                           verbose=False),
        F_cpu, FW_CPU_ROWS))

    M, F_cpu = CPU_RUNS["symnmf"]  # phase 4i's run with the first h
    np.random.seed(0)
    fs, hs, _, X0 = port.FrobeniusSymLossResMeasEx(M, FW_SYM_R,
                                                   device="cuda")
    lmo = port.lmo_linf_ball(radius=1, center=1)
    lines.append(graph_against_eager(
        driver, f"FW_alg_descent_step SymNMF {FW_SYM_N}x{FW_SYM_R} "
                f"{type(hs[0]).__name__}",
        lambda: port.FW_alg_descent_step(fs, hs[0], X0, FW_SYM_ITERS, lmo,
                                         epsilon=1e-9, verbose=False),
        lambda n: port.FW_alg_descent_step(fs, hs[0], X0, n, lmo,
                                           epsilon=1e-9, verbose=False),
        F_cpu, None))

    def reads_back(cfg, prob, c, k):
        v = c["v"] * (0.5 if float(c["v"]) > 0 else 2.0)  # a host read
        return dict(done=c["done"], v=v), dict(F=v, _stop=v < 0)

    carry = dict(done=torch.tensor(False, device="cuda"),
                 v=torch.tensor(1.0, device="cuda"))
    try:
        driver.run_driver(reads_back, carry, 20, verbose=False,
                          problem=dict(s=1.0))
    except RuntimeError as e:
        raised = str(e).splitlines()[0][:80]
    else:
        raise AssertionError("a step that reads back was captured")
    launched = no_launches("the graph paths", counters)
    print(f"[graph] phase 4o ({card}): " + "; ".join(lines)
          + f"; a capture that reads back raises ({raised!r}); kernel "
          f"launches {launched}; phase 4o in {time.perf_counter() - t0:.1f} "
          f"s", flush=True)


SVD_PROBE = """
import torch
g = torch.randn(200, 20, dtype=torch.float64, device="cuda")
torch.linalg.svd(g, full_matrices=False)
torch.cuda.synchronize()
graph = torch.cuda.CUDAGraph()
try:
    with torch.cuda.graph(graph):
        torch.linalg.svd(g, full_matrices=False)
    print("captured")
except Exception as e:
    print("refused:", str(e).splitlines()[0][:120])
"""


def centre_runs(driver, label, runs, x0, lmo, f):
    """``runs`` (``fw_drivers``) with ``lmo`` from ``x0``: each as a graph
    (one capture: an array centre copied from the host per call would make
    it raise) against ``eager_chunks`` over all LMO_ITERS rows; returns the
    text."""
    out = []
    for name, run in runs.items():
        driver.clear_graph_cache()
        before = dict(driver.GRAPH_STATS)
        g = run(f, x0, lmo, LMO_ITERS)
        captures = driver.GRAPH_STATS["captures"] - before["captures"]
        if captures != 1:
            raise AssertionError(f"{label} {name}: {captures} captures")
        with driver.eager_chunks():
            e = run(f, x0, lmo, LMO_ITERS)
        F = np.asarray(g[1])
        if not np.all(np.isfinite(F)):
            raise AssertionError(f"{label} {name}: F not finite")
        agree = same_rows(f"{label} {name}", g, e, LMO_ITERS)
        if not torch.equal(g[0], e[0]) and agree == "bit for bit":
            raise AssertionError(f"{label} {name}: the iterates differ")
        out.append(f"{name.replace('FW_', '')} {len(F)} rows {agree}")
    return f"{label}: " + ", ".join(out)


def lmo_centres(port, card, counters):
    """Phase 4p: the four LMOs that take an array (a numpy centre, numpy
    bounds) under the five FW drivers as graphs against ``eager_chunks``,
    and the nuclear ball under the descent step and BPG's FW-as-prox as
    graphs against ``eager_chunks``, with whether ``torch.linalg.svd`` can
    be captured at all (in a process of its own).  Only the top singular
    pair's kernel may launch; returns its launches on the card in the two
    warm graph runs (the main path), each counted alone."""
    from accbpg_and_fw_tpu_torch.algorithms import driver

    reset_counts(counters)
    t0 = time.perf_counter()
    f, h, L, L0, L1, _ = CPU_RUNS["illcond_problem"]  # phase 4i's
    rng = np.random.default_rng(7)
    c = 0.1 * rng.standard_normal(FW_NF)
    runs = fw_drivers(port, h, L, L0, L1)
    zero = torch.zeros(FW_NF, dtype=torch.float64, device="cuda")
    lines = [
        centre_runs(driver, "lmo_l2_ball(25, centre)", runs, zero,
                    port.lmo_l2_ball(FW_ILL["radius"], center=c), f),
        # from its centre, which is small: where the gradient has no
        # negative entry the vertex is the centre and the run stops
        centre_runs(driver, "lmo_l2_ball_positive_orthant(25, centre)",
                    runs, torch.tensor(0.01 * np.abs(c), device="cuda"),
                    port.lmo_l2_ball_positive_orthant(
                        FW_ILL["radius"], center=0.01 * np.abs(c)), f),
        centre_runs(driver, "lmo_linf_ball(1, centre)", runs, zero,
                    port.lmo_linf_ball(1.0, center=c), f)]

    M = symnmf_matrix(FW_SYM_N)
    np.random.seed(0)
    fs, hs, Ls, X0 = port.FrobeniusSymLossResMeasEx(M, FW_SYM_R,
                                                    device="cuda")
    lower = 0.01 * rng.random((FW_SYM_N, FW_SYM_R))
    upper = lower + 1.0 + rng.random((FW_SYM_N, FW_SYM_R))
    X0 = torch.clamp(X0, torch.tensor(lower, device="cuda"),
                     torch.tensor(upper, device="cuda"))
    lines.append(centre_runs(
        driver, f"lmo_matrix_box(lower, upper) SymNMF {FW_SYM_N}x{FW_SYM_R}",
        fw_drivers(port, hs[0], float(Ls), 1.0, 1.0), X0,
        port.lmo_matrix_box(lower, upper), fs))

    # the reference's nuclear vertex is the top singular pair's, an ascent
    # vertex for the line-search drivers (which raise on it, as JAX's do):
    # the descent step, and BPG through the FW-as-prox h-oracle, as graphs
    # whose only kernel is the top singular pair's
    from accbpg_and_fw_tpu_torch.ops import svd

    nuc = port.lmo_nuclear_norm_ball()
    Xn = X0 / (2.0 * torch.linalg.matrix_norm(X0, ord="nuc"))
    nuc_calls = {
        "FW_alg_descent_step": lambda: port.FW_alg_descent_step(
            fs, hs[0], Xn, LMO_ITERS, nuc, verbose=False),
        "BPG(SumOf2nd4thPowersWithFrankWolfe)": lambda: port.BPG(
            fs, port.SumOf2nd4thPowersWithFrankWolfe(lmo=nuc), 1.0, Xn,
            LMO_ITERS, linesearch=False, verbose=False)}
    svd.LAUNCHES = 0
    nuc_text, nuc_launches, at_bound, most = [], 0, 0, 0

    def kernel_stats(run):
        """``run()`` synced, with the kernel's counts on the card from a
        reset just before it to a read just after it."""
        svd.reset_device_stats()
        out = synced(run)
        return out, svd.device_stats()

    for name, run in nuc_calls.items():
        driver.clear_graph_cache()
        before = driver.GRAPH_STATS["captures"]
        (_, cold_wall, _), cold = kernel_stats(run)  # captured
        # the main path: the replayed graph, its launches counted alone
        (res, warm_wall, _), warm = kernel_stats(run)
        captures = driver.GRAPH_STATS["captures"] - before
        with driver.eager_chunks():
            (eager, eager_wall, _), side = kernel_stats(run)
        F = np.asarray(res[1])
        if captures != 1 or not np.all(np.isfinite(F)):
            raise AssertionError(f"nuclear ball {name}: {captures} captures,"
                                 f" F finite {np.all(np.isfinite(F))}")
        # every iteration calls the LMO at least once (the descent step
        # once, BPG-FW's prox once or more); F's first row is the start's
        if warm[0] < len(F) - 1:
            raise AssertionError(f"nuclear ball {name}: the replayed graph "
                                 f"launched the kernel {warm[0]} times for "
                                 f"{len(F) - 1} iterations")
        for a, b in zip(histories(name, res), histories(name, eager)):
            if not np.array_equal(np.asarray(a), np.asarray(b),
                                  equal_nan=True):
                raise AssertionError(f"nuclear ball {name}: the graph's rows "
                                     "differ from eager_chunks'")
        if not torch.equal(res[0], eager[0]):
            raise AssertionError(f"nuclear ball {name}: the graph's iterate "
                                 "differs from eager_chunks'")
        nuc_launches += warm[0]
        at_bound += cold[1] + warm[1] + side[1]
        most = max(most, cold[2], warm[2], side[2])
        nuc_text.append(
            f"{name.replace('FW_', '')} {len(F)} rows, F {F[0]:.4e} -> "
            f"{F[-1]:.4e}, one capture, bit for bit with eager_chunks; graph"
            f" {cold_wall:.3f} s cold, {warm_wall:.3f} s warm, eager "
            f"{eager_wall:.3f} s; the kernel's launches on the card: "
            f"{warm[0]} in the warm graph run (the main path), {cold[0]} in "
            f"the capturing run, {side[0]} in the eager comparison")
    if at_bound:
        raise AssertionError(f"nuclear ball: {at_bound} solves at the sweep "
                             "bound")
    probe = subprocess.run([sys.executable, "-c", SVD_PROBE],
                           capture_output=True, text=True, timeout=300)
    svd_probe = (probe.stdout.strip().splitlines() or
                 [f"probe failed (exit {probe.returncode})"])[-1]
    lines.append(
        f"lmo_nuclear_norm_ball on SymNMF {FW_SYM_N}x{FW_SYM_R}: "
        + "; ".join(nuc_text)
        + f"; the top singular pair's kernel launched {nuc_launches} times "
        f"on the card in the two warm graph runs ({svd.LAUNCHES} host "
        f"launches: the captures and the eager runs), most sweeps {most}, "
        f"none at the bound "
        f"{svd.MAX_SWEEPS}; torch.linalg.svd under a capture alone (why the "
        f"kernel exists): {svd_probe}")
    launched = no_launches("phase 4p", counters)
    print(f"[lmo] phase 4p ({card}, {LMO_ITERS} iterations each, graphs "
          "against eager_chunks): " + "; ".join(lines) + f"; other kernels' "
          f"launches {launched}; phase 4p in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return nuc_launches


def write_a9a_like(path):
    """A synthetic LIBSVM file of a9a's published shape (A9A_ROWS rows,
    A9A_FEATURES binary features, A9A_NNZ ones per row, labels +1 / -1 in
    a9a's proportion), from A9A_SEED."""
    rng = np.random.default_rng(A9A_SEED)
    cols = np.sort(np.argpartition(rng.random((A9A_ROWS, A9A_FEATURES)),
                                   A9A_NNZ, axis=1)[:, :A9A_NNZ], axis=1) + 1
    labels = np.where(rng.random(A9A_ROWS) < A9A_POSITIVE, "+1", "-1")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(
        f"{lab} " + " ".join(f"{j}:1" for j in row)
        for lab, row in zip(labels, cols)) + "\n")


def a9a_phase(port, card, counters):
    """Phase 4q: the a9a path on a synthetic file of a9a's shape: the
    native parse against the Python parse (equal CSR arrays, both timed),
    ``L0L1_FW_log_reg_a9a(250, path)`` on the card and
    ``examples/ex_fw_l0l1_a9a.py``'s four runs as graph chunks."""
    from accbpg_and_fw_tpu_torch import native
    from accbpg_and_fw_tpu_torch.algorithms import driver
    from accbpg_and_fw_tpu_torch.apps import utils

    reset_counts(counters)
    t0 = time.perf_counter()
    path = pathlib.Path(__file__).resolve().parent / "build" / "a9a_like"
    write_a9a_like(path)
    built = native.library_path("libsvm_parser").exists()
    t = time.perf_counter()
    if native.load_native_library("libsvm_parser") is None:
        raise AssertionError("the native LIBSVM parser did not build")
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    X, y = utils.load_libsvm_file(str(path))
    native_s = time.perf_counter() - t
    parse = utils._load_libsvm_native
    utils._load_libsvm_native = lambda filename: None  # the Python parse
    try:
        t = time.perf_counter()
        Xp, yp = utils.load_libsvm_file(str(path))
        python_s = time.perf_counter() - t
    finally:
        utils._load_libsvm_native = parse
    for name in ("data", "indices", "indptr"):
        if not np.array_equal(getattr(X, name), getattr(Xp, name)):
            raise AssertionError(f"a9a-like: native and Python {name} "
                                 "differ")
    if not (np.array_equal(y, yp) and X.shape == Xp.shape
            == (A9A_ROWS, A9A_FEATURES)):
        raise AssertionError(f"a9a-like: shapes {X.shape} {Xp.shape}")

    np.random.seed(A9A_EXAMPLE_SEED)  # the example's x0 draw
    f, h, L, L0, L1, x0 = port.L0L1_FW_log_reg_a9a(A9A_RADIUS, str(path))
    if x0.device.type != "cuda":
        raise AssertionError(f"the a9a problem is on {x0.device}")
    out = []
    for lmo_name, lmo in (("L2 ball", port.lmo_l2_ball(A9A_RADIUS)),
                          ("Linf ball", port.lmo_linf_ball(A9A_RADIUS))):
        for name, run in (
                ("FW_alg_L0_L1_shortest_step", lambda: (
                    port.FW_alg_L0_L1_shortest_step(
                        f, h, L0, L1, x0, A9A_ITERS, gamma=2.0, lmo=lmo,
                        ls_ratio=2.0, verbose=False))),
                ("FW_alg_div_step", lambda: port.FW_alg_div_step(
                    f, h, L, x0, A9A_ITERS, gamma=2.0, lmo=lmo, ls_ratio=2.0,
                    verbose=False))):
            driver.clear_graph_cache()
            before = dict(driver.GRAPH_STATS)
            res, wall, syncs = synced(run)
            st = {k: driver.GRAPH_STATS[k] - before[k] for k in before}
            cap_s = sum(e.capture_s for e in driver._GRAPHS.values())
            F = np.asarray(res[1])
            if st["captures"] != 1:
                raise AssertionError(f"a9a {lmo_name} {name}: "
                                     f"{st['captures']} captures")
            if not (np.all(np.isfinite(F)) and F[-1] < F[0]):
                raise AssertionError(f"a9a {lmo_name} {name}: F[0] {F[0]} "
                                     f"F[-1] {F[-1]}")
            out.append(f"{lmo_name} {name}: {len(F)} rows, F {F[0]:.6f} -> "
                       f"{F[-1]:.6f}, {wall:.3f} s with the capture of "
                       f"{cap_s:.2f} s, {st['continuations']} "
                       f"continuations, {syncs} syncs")
    launched = no_launches("phase 4q", counters)
    print(f"[a9a] phase 4q ({card}): synthetic a9a-shaped file "
          f"{A9A_ROWS}x{A9A_FEATURES}, {X.nnz} nonzeros, seed {A9A_SEED}; "
          f"native parse {native_s:.3f} s (g++ build "
          f"{'cached' if built else f'{build_s:.2f} s'}) against the Python "
          f"parse {python_s:.3f} s, equal CSR arrays and labels; "
          f"L0L1_FW_log_reg_a9a({A9A_RADIUS:g}) on cuda: L {L:.1f}, L1 "
          f"{L1:.2f}; {A9A_ITERS} iterations, ls_ratio 2, gamma 2: "
          + "; ".join(out) + f"; kernel launches {launched}; phase 4q in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks-only", action="store_true",
                    help="print only the block times of the lazy-H and "
                         "dense kernels, the multiplier's time per call, "
                         "the study's dual prox, the top singular pair and "
                         "the main-path walls of the package under --root")
    ap.add_argument("--root", default=str(pathlib.Path(__file__).parent),
                    help="checkout whose package --blocks-only times")
    ap.add_argument("--solves", type=int, default=3)
    ap.add_argument("--gain-iters", type=int, default=0,
                    help="with --blocks-only: also time ABPG_gain 30x10000 "
                         "over this many iterations")
    ap.add_argument("--dual-prox", action="store_true",
                    help="build the dual prox kernel and run its phase "
                         "alone ([dual prox], [stages], the plan sweep)")
    ap.add_argument("--lookahead", action="store_true",
                    help="run the main path's lookahead part of phase 4d "
                         "alone (frozen and skipped blocks a solve "
                         "against the whole group enqueued)")
    ap.add_argument("--threefry", action="store_true",
                    help="build the threefry kernel and run its phase "
                         "alone ([threefry], the sweep, the walls)")
    ap.add_argument("--svd", action="store_true",
                    help="build the top singular pair's kernel and run its "
                         "phase alone ([svd], [svd sizes], [svd stages]); "
                         "with --root of another checkout, time only that "
                         "checkout's top singular pair")
    ap.add_argument("--micro", action="store_true",
                    help="build and run csrc/micro_cluster.cu")
    ap.add_argument("--bodies", action="store_true",
                    help="the Bregman loops' bodies and what masked "
                         "bodies cost")
    ap.add_argument("--extras-only", action="store_true",
                    help="with --bodies: only the extras' loops")
    ap.add_argument("--fastgram-only", action="store_true",
                    help="with --bodies: only the fast_gram loops")
    ap.add_argument("--fw-only", action="store_true",
                    help="with --bodies: only the FW line searches")
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
    if args.dual_prox:
        import accbpg_and_fw_tpu_torch as port

        print(f"[card] {card_line()}", flush=True)
        compare_dual_prox(port, torch.device("cuda"))
        return 0
    if args.lookahead:
        from accbpg_and_fw_tpu_torch.ops import dopt_lazy as dl

        lookahead_phase(dl, main_design(), np.full(N, 1.0 / N))
        return 0
    if args.threefry:
        print(f"[card] {card_line()}", flush=True)
        compare_threefry(torch.device("cuda"))
        return 0
    if args.svd:
        print(f"[card] {card_line()}", flush=True)
        root = pathlib.Path(args.root).resolve()
        if root != pathlib.Path(__file__).resolve().parent:
            svd_times(str(root))  # another checkout: its times alone
        else:
            compare_svd(torch.device("cuda"))
        return 0
    if args.bodies:
        return bodies_study()
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
    names = ("dopt_lazy", "dopt_dense", "simplex_mult", "threefry",
             "dual_prox", "top_singular")
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
    threefry_split, threefry_draw = compare_threefry(dev)
    dual_prox = compare_dual_prox(port, dev)
    top_singular = compare_svd(dev)

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
    global READS
    READS = count_reads(dl)
    dense_batch_launches = dense_sweep(port, dd, dev)
    batch_launches, large_Vs, large_x0s = large_sweep(port, dl, dev)
    lazy_batch = compare_lazy_batch(
        dl, torch.tensor(large_Vs, device=dev),
        torch.tensor(large_x0s, device=dev), LARGE_EPS)
    dense_one_launches = single_pallas(port, dd, dev)
    auto_phase(port, dd, card)

    x0 = np.full(N, 1.0 / N)
    dl.LAUNCHES = 0
    reads = READS[0]
    torch.cuda.synchronize()
    t = time.perf_counter()
    # numpy input and no device: the port's default is the card
    x, F, SP, SN, T = D_opt_FW_away(V64, x0, eps=EPS, maxitrs=REF_ITERS,
                                    verbose=False)
    torch.cuda.synchronize()
    reads = READS[0] - reads
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
          f"(reference {REF_ITERS}), {launches} kernel launches in "
          f"{reads} host round trips, final SP {SP[-1]:.4e} SN "
          f"{SN[-1]:.4e}, certified gap {gap:.3e}", flush=True)
    main_group_one(port, dl, V64, x0, (x, F, SP, SN))
    lookahead_phase(dl, V64, x0)

    from accbpg_and_fw_tpu_torch.algorithms import driver

    t = time.perf_counter()
    simplex_launches, gain_text, gain_wall = gain_path(port, sm, driver)
    bpg_text = bpg_path(port, sm, driver)
    print(f"[bregman graph] ({card}) phases 4e-4f in "
          f"{time.perf_counter() - t:.1f} s; {gain_text}; {bpg_text}",
          flush=True)
    readme_path(port, sm)
    per_iteration_costs(port, driver)
    counters = [(dl, "LAUNCHES"), (dl, "BATCH_LAUNCHES"), (dd, "LAUNCHES"),
                (sm, "LAUNCHES"), (DeviceCount(sm), "LAUNCHES")]
    fw_paths(port, card, counters)
    graph_paths(port, card, counters)
    svd_launches = lmo_centres(port, card, counters)
    a9a_phase(port, card, counters)
    _, drawn, dual_launches = extras_paths(port, card, counters, sm)
    from accbpg_and_fw_tpu_torch import _rng
    from accbpg_and_fw_tpu_torch.ops import dual_prox as dp
    from accbpg_and_fw_tpu_torch.ops import svd

    # all nine kernels: the D-opt ones, kernel 5 (host and card counts),
    # the threefry entries, the dual prox and the top singular pair
    every = counters + [(_rng, "SPLIT_LAUNCHES"), (_rng, "DRAW_LAUNCHES"),
                        (dp, "LAUNCHES"), (svd, "LAUNCHES")]
    fastgram_paths(port, every, gain_wall)
    sharded_paths(port, every)
    diagnostics_and_examples(port, counters)

    # ---- 5. the record ------------------------------------------------------
    def entry(name, source, replaces, launches, measured):
        # library_ms: no single PyTorch call computes any of these functions
        # (torch's own generator draws other bits than JAX's threefry) but
        # the top singular pair's (torch.linalg.svd)
        err, ms, plain_ms, bound_ms, bound_by = measured[:5]
        library_ms = measured[5] if len(measured) > 5 else None
        return {"name": name, "route": "cuda",
                "source": f"accbpg_and_fw_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}

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
        # no TPU kernel: what JAX compiles into the chunk there
        entry("threefry_split", "threefry.cu",
              "accbpg_and_fw_tpu/algorithms/extras.py:79",
              drawn["split"], threefry_split),
        entry("threefry_draw", "threefry.cu",
              "accbpg_and_fw_tpu/ops/f_oracles.py:805",
              drawn["draw"], threefry_draw),
        entry("dual_prox", "dual_prox.cu",
              "accbpg_and_fw_tpu/ops/h_oracles.py:505", dual_launches,
              dual_prox),
        # no TPU kernel: the SVD that JAX compiles into the chunk
        entry("top_singular_pair", "top_singular.cu",
              "accbpg_and_fw_tpu/ops/lmo.py:20", svd_launches, top_singular),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
