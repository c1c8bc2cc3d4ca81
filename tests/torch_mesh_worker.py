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

    torch.distributed.destroy_process_group()
    if rank == 0:
        print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
