"""Worker process for tests/test_torch_mesh.py.

One of N ranks of a local ``torch.distributed`` gloo group on the CPU
(``tcp://localhost:PORT``).  It builds the port's problems from the arrays
in DATA (an ``.npz`` the test module wrote from the JAX package's
problems), shards them over a 1-D mesh of all ranks with
``accbpg_and_fw_tpu_torch.parallel``, runs every case in this one group,
and prints one ``RESULT {json}`` line from rank 0: each case's histories
and its final iterate gathered to one array, and what the test checks
about placements and refusals.  No JAX here: the comparisons are the test
module's.

Usage: python torch_mesh_worker.py PORT RANK WORLD DATA
"""

import faulthandler
import json
import os
import sys

# iterations of the sharded ABPG_gain through the graph chunk's code, and
# the iterations of its graph spans there
GRAPH_ITERS, GRAPH_SPAN = 10, 5
# iterations of the sharded extras (eager and through the graph chunk's
# code) and of the primal-dual method
EXTRAS_ITERS, PD_ITERS = 10, 12


def main():
    faulthandler.enable()
    port_no, rank, world, data = (sys.argv[1], int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)

    import numpy as np
    import torch

    torch.set_num_threads(1)
    import accbpg_and_fw_tpu_torch as port
    from accbpg_and_fw_tpu_torch.parallel import (
        data_mesh, distributed_init, shard_dopt_design, shard_dopt_problem,
        shard_regression_problem, shard_symnmf_problem)
    from torch.distributed.tensor import DTensor

    distributed_init(f"localhost:{port_no}", num_processes=world,
                     process_id=rank, backend="gloo")
    mesh = data_mesh("cpu")
    z = dict(np.load(data))
    out = {"world": torch.distributed.get_world_size(),
           "mesh": list(mesh.shape)}

    def full(a):
        return (a.full_tensor() if isinstance(a, DTensor) else a).tolist()

    def record(name, r, hist=(1,)):
        x = r[0]
        out[name] = {"x": full(x), "sharded": isinstance(x, DTensor),
                     "placements": (str(x.placements)
                                    if isinstance(x, DTensor) else None),
                     **{f"h{i}": np.asarray(r[i]).tolist() for i in hist}}

    quiet = dict(verbose=False)
    h_simplex = port.BurgEntropySimplex()

    # D-opt, 16x64: BPG and ABPG_gain, plain and fast_gram
    f = port.DOptimalObj(z["dopt16_H"], device="cpu")
    f_sh, x_sh = shard_dopt_problem(f, z["dopt16_x0"], mesh)
    L = float(z["dopt16_L"])
    out["dopt16_H_placements"] = str(f_sh.H.placements)
    for fg in (False, True):
        tag = "_fast" if fg else ""
        record("bpg" + tag, port.BPG(f_sh, h_simplex, L, x_sh, 50,
                                     fast_gram=fg, **quiet), (1, 2))
        record("gain" + tag, port.ABPG_gain(f_sh, h_simplex, L, x_sh, 2.0,
                                            40, fast_gram=fg, **quiet),
               (1, 2))

    # BPG fast_gram at a non-divisible n (padded)
    f = port.DOptimalObj(z["dopt51_H"], device="cpu")
    f_sh, x_sh = shard_dopt_problem(f, z["dopt51_x0"], mesh)
    out["dopt51_padded"] = [f_sh.H.shape[1], f_sh.n_valid]
    record("bpg51_fast", port.BPG(f_sh, h_simplex, float(z["dopt51_L"]),
                                  x_sh, 60, fast_gram=True, **quiet), (1, 2))

    # ABDA fast_gram, padded (its dual averaging needs the n_valid mask)
    f = port.DOptimalObj(z["dopt45_H"], device="cpu")
    f_sh, x_sh = shard_dopt_problem(f, z["dopt45_x0"], mesh)
    record("abda45_fast", port.ABDA(f_sh, h_simplex, float(z["dopt45_L"]),
                                    x_sh, 2.0, 40, fast_gram=True, **quiet))

    # D_opt_FW_away on a column-sharded design, non-divisible n: "auto"
    # takes the exact engine; the explicit kernel modes refuse
    V_sh, x_sh = shard_dopt_design(z["fw51_V"], z["fw51_x0"], mesh)
    out["fw51_padded"] = V_sh.shape[1]
    record("fw51", port.D_opt_FW_away(V_sh, x_sh, 1e-6, 800, chunk=400,
                                      **quiet), (1, 2, 3))
    refused = {}
    for mode in ("pallas", "pallas_lazy"):
        try:
            port.D_opt_FW_away(V_sh, x_sh, 1e-8, 5, u_mode=mode, **quiet)
            refused[mode] = False
        except ValueError:
            refused[mode] = True
    try:
        port.BurgEntropySimplex(use_pallas=True).prox_map(x_sh, 1.0)
        refused["use_pallas"] = False
    except ValueError:
        refused["use_pallas"] = True
    Vs_sh, x0s_sh = shard_dopt_design(z["fw51_V"][None], z["fw51_x0"][None],
                                      mesh)
    for precision in ("auto", "pallas"):  # the batch takes no sharded input
        try:
            port.dopt_fw_batch(Vs_sh, x0s_sh, 1e-8, 5, precision=precision)
            refused[f"batch_{precision}"] = False
        except ValueError:
            refused[f"batch_{precision}"] = True
    out["refused"] = refused

    # logistic regression (FW with the divergence step), samples sharded
    f = port.LogisticRegression(z["log_X"], z["log_y"],
                                alpha=float(z["log_alpha"]), device="cpu")
    f_sh, x_sh = shard_regression_problem(f, z["log_x0"], mesh)
    record("logreg", port.FW_alg_div_step(
        f_sh, port.SquaredL2Norm(), float(z["log_L"]), x_sh, 50, gamma=2.0,
        lmo=port.lmo_l2_ball(float(z["log_radius"])), **quiet))

    # Poisson regression (BPG without line search), samples sharded
    f = port.PoissonRegression(z["poi_A"], z["poi_b"], device="cpu")
    f_sh, x_sh = shard_regression_problem(f, z["poi_x0"], mesh)
    record("poisson", port.BPG(f_sh, port.BurgEntropyL1(lamda=0.0),
                               float(z["poi_L"]), x_sh, 50,
                               linesearch=False, **quiet))

    # SymNMF (BPG without line search), M and X rows sharded
    f = port.FrobeniusSymLoss(z["nmf_M"], device="cpu")
    f_sh, X_sh = shard_symnmf_problem(f, z["nmf_X0"], mesh)
    h = port.SumOf2nd4thPowersPositiveOrthant(
        alpha=6.0, sigma=float(z["nmf_sigma"]), upper_bound=None)
    record("symnmf", port.BPG(f_sh, h, 1.0, X_sh, 50, linesearch=False,
                              **quiet))

    graph_cases(out, z, mesh, record, port, h_simplex, shard_dopt_problem,
                shard_dopt_design)
    extras_cases(out, z, mesh, record, port, h_simplex,
                 shard_regression_problem)

    torch.distributed.destroy_process_group()
    if rank == 0:
        print("RESULT " + json.dumps(out), flush=True)


def graph_cases(out, z, mesh, record, port, h_simplex, shard_dopt_problem,
                shard_dopt_design):
    """The sharded solves through the graph chunk's code (``_GraphChunk``,
    which on the CPU runs ``_masked_steps`` without a capture), forced by
    ``chunk_mode``: ABPG_gain fast_gram on dopt16 (GRAPH_ITERS iterations:
    its masked loops make an iteration here several times an eager one)
    and D_opt_FW_away on fw51, each against the eager run recorded above
    bit for bit, and recorded for the test's bars against JAX; the entry's
    static buffers and keys; a second solve of the same shapes on other
    data; the key of another placement and of another mesh."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate

    from accbpg_and_fw_tpu_torch.algorithms import driver

    def rows_equal(got, name, hists):
        """The histories of ``got`` against the first rows of the eager run
        recorded as ``name``, bit for bit."""
        return all(np.array_equal(np.asarray(got[i]),
                                  np.asarray(out[name][f"h{i}"])[
                                      :len(got[i])], equal_nan=True)
                   for i in hists)

    f = port.DOptimalObj(z["dopt16_H"], device="cpu")
    f_sh, x_sh = shard_dopt_problem(f, z["dopt16_x0"], mesh)
    L = float(z["dopt16_L"])

    def gain(f_, x_, iters=GRAPH_ITERS):
        return port.ABPG_gain(f_, h_simplex, L, x_, 2.0, iters,
                              fast_gram=True, verbose=False)

    driver.clear_graph_cache()
    graph = as_graph(lambda: gain(f_sh, x_sh))
    record("gain_fast_graph", graph, (1, 2))
    out["gain_fast_graph"]["eager_equal"] = rows_equal(graph, "gain_fast",
                                                       (1, 2))
    (key, entry), = driver._GRAPHS.items()
    cspec = dict((k[0], k[1:]) for k in key[5])
    out["graph_entry"] = {
        "bufs": {k: (type(v).__name__, list(v.shape))
                 for k, v in entry.bufs.items()},
        "views": {k: (str(v.placements) if isinstance(v, DTensor) else None)
                  for k, v in entry.carry.items()},
        "x_spec": [str(a) for a in cspec["x"]],
        "problem_local_shapes": [list(t.shape) for t in entry.leaves],
        "problem_plain": all(not isinstance(t, DTensor)
                             for t in entry.leaves)}

    # a second solve of the same shapes on other data: no new entry
    rng = np.random.default_rng(7)
    f2 = port.DOptimalObj(z["dopt16_H"] * rng.uniform(0.5, 1.5, (16, 64)),
                          device="cpu")
    f2_sh, x2_sh = shard_dopt_problem(f2, z["dopt16_x0"], mesh)
    eager2 = gain(f2_sh, x2_sh, 4)
    graph2 = as_graph(lambda: gain(f2_sh, x2_sh, 4))
    out["graph_second"] = {
        "entries": len(driver._GRAPHS),
        "eager_equal": all(np.array_equal(a, b) for a, b in
                           zip(graph2[1:-1], eager2[1:-1])),
        "differs_from_first": not np.array_equal(graph2[1],
                                                 graph[1][:4])}

    # another placement, another mesh: other keys
    carry = dict(done=DTensor.from_local(torch.tensor(False), mesh,
                                         [Replicate()]), x=x_sh)
    keys = [driver.graph_key(gain, None, 8, None, carry)[0]]
    carry["x"] = x_sh.redistribute(mesh, [Replicate()])
    keys.append(driver.graph_key(gain, None, 8, None, carry)[0])
    flipped = DeviceMesh("cpu", list(range(mesh.size()))[::-1])
    carry["x"] = DTensor.from_local(x_sh.to_local(), flipped,
                                    list(x_sh.placements), run_check=False)
    keys.append(driver.graph_key(gain, None, 8, None, carry)[0])
    out["graph_keys_distinct"] = len(set(keys)) == 3

    # D_opt_FW_away on the column-sharded design, through the c10d gather
    V_sh, x_sh = shard_dopt_design(z["fw51_V"], z["fw51_x0"], mesh)
    # chunks of 100: the rows of the chunks of 400 above (no hook runs
    # between chunks), and fewer frozen steps after the stop
    graph = as_graph(lambda: port.D_opt_FW_away(V_sh, x_sh, 1e-6, 800,
                                                chunk=100, verbose=False))
    record("fw51_graph", graph, (1, 2, 3))
    out["fw51_graph"]["eager_equal"] = (
        rows_equal(graph, "fw51", (1, 2, 3))
        and len(graph[1]) == len(out["fw51"]["h1"])
        and out["fw51_graph"]["x"] == out["fw51"]["x"])


def as_graph(run):
    """``run()`` with every carry sent through the graph chunk's code
    (``_GraphChunk``, which on the CPU runs ``_masked_steps`` without a
    capture) and spans of GRAPH_SPAN iterations: a span runs whole,
    masked past the run's end, so short spans keep the masked steps few."""
    from accbpg_and_fw_tpu_torch.algorithms import bpg, driver, extras

    saved = (driver.chunk_mode, bpg.GRAPH_SPAN, extras.GRAPH_SPAN,
             extras.PD_GRAPH_SPAN)
    driver.chunk_mode = lambda carry, problem=None, cfg=None: "graph"
    bpg.GRAPH_SPAN = extras.GRAPH_SPAN = extras.PD_GRAPH_SPAN = GRAPH_SPAN
    try:
        return run()
    finally:
        (driver.chunk_mode, bpg.GRAPH_SPAN, extras.GRAPH_SPAN,
         extras.PD_GRAPH_SPAN) = saved


def extras_cases(out, z, mesh, record, port, h_simplex,
                 shard_regression_problem):
    """AIBM, AdaptFGM and UniversalGM on a sample-sharded Poisson problem
    (``ext_*``), eagerly and through the graph chunk's code, and the
    primal-dual method on it with a replicated linear constraint (``pdc_*``,
    a scalar ``x @ a - b``); each graph run's rows against its eager run's,
    bit for bit."""
    import copy

    import numpy as np
    from torch.distributed.tensor import Replicate, distribute_tensor

    from accbpg_and_fw_tpu_torch.algorithms import driver

    f = port.PoissonRegression(z["ext_A"], z["ext_b"], device="cpu")
    f_sh, x_sh = shard_regression_problem(f, z["ext_x0"], mesh)
    runs = {
        "aibm": lambda: port.AIBM(f_sh, h_simplex, 1.0, x_sh, 2.0,
                                  EXTRAS_ITERS, verbose=False),
        "adaptfgm": lambda: port.AdaptFGM(f_sh, h_simplex, 1.0, x_sh,
                                          EXTRAS_ITERS, verbose=False),
        "universalgm": lambda: port.UniversalGM(f_sh, h_simplex, 1.0, x_sh,
                                                EXTRAS_ITERS, verbose=False)}
    for name, run in runs.items():
        record(name, run(), (1, 2))
        driver.clear_graph_cache()
        graph = as_graph(run)
        record(name + "_graph", graph, (1, 2))
        out[name + "_graph"]["eager_equal"] = all(
            np.array_equal(out[name + "_graph"][k], out[name][k])
            for k in ("x", "h1", "h2"))

    g = port.AX_b(z["pdc_A"], z["pdc_b"], device="cpu")
    g_rep = copy.copy(g)
    g_rep.A = distribute_tensor(g.A, mesh, [Replicate()])
    g_rep.b = distribute_tensor(g.b, mesh, [Replicate()])

    def pd():
        return port.PrimalDualSwitchingGradientMethod(
            f_sh, port.BurgEntropy(), 1.0, g_rep, x_sh, PD_ITERS,
            epsilon=1e-9, verbose=False)

    eager = pd()
    driver.clear_graph_cache()
    graph = as_graph(pd)
    out["pd_poisson"] = {f"h{i}": np.asarray(eager[i]).tolist()
                         for i in range(3)}
    out["pd_poisson"]["eager_equal"] = all(
        np.array_equal(a, b, equal_nan=True) for a, b in zip(graph, eager))


if __name__ == "__main__":
    main()
