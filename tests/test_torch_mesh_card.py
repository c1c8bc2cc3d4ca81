"""A sharded solve as a CUDA graph on the card: a world-size-1 NCCL group
in this process and a one-card mesh, ``shard_dopt_problem`` under
ABPG_gain(fast_gram=True), ``shard_dopt_design`` under D_opt_FW_away and
``shard_regression_problem`` under AIBM, each captured with its collectives (``algorithms/driver.py``) and held
against the same sharded solve under ``eager_chunks``: every row and the
iterate bit for bit.  One card shows the capture of DTensor's collectives
on a group of one, not collectives across cards.

Run on the card with ``python -m pytest --noconftest -m cuda
tests/test_torch_mesh_card.py``; without a card it skips.  No JAX here.
"""

import socket

import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu_torch as port


@pytest.fixture
def nccl_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist

    from accbpg_and_fw_tpu_torch.parallel import data_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free}",
                            world_size=1, rank=0)
    try:
        yield data_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_sharded_solves_as_graphs_match_eager(nccl_mesh):
    from torch.distributed.tensor import DTensor

    from accbpg_and_fw_tpu_torch.algorithms import driver
    from accbpg_and_fw_tpu_torch.parallel import (shard_dopt_design,
                                                  shard_dopt_problem)

    f, h, L, x0 = port.D_opt_design(12, 200, randseed=10, device="cuda")
    f_sh, x_sh = shard_dopt_problem(f, x0, nccl_mesh)
    V_sh, xd_sh = shard_dopt_design(f.H, x0, nccl_mesh)
    runs = {
        "gain_fast": lambda: port.ABPG_gain(f_sh, h, L, x_sh, gamma=2,
                                            maxitrs=40, verbose=False,
                                            fast_gram=True),
        "fw_away": lambda: port.D_opt_FW_away(V_sh, xd_sh, 1e-8, 120,
                                              verbose=False)}
    for name, run in runs.items():
        driver.clear_graph_cache()
        before = driver.GRAPH_STATS["captures"]
        graph = run()
        assert driver.GRAPH_STATS["captures"] > before, name
        assert isinstance(graph[0], DTensor), name
        with driver.eager_chunks():
            eager = run()
        for a, b in zip(graph[1:-1], eager[1:-1]):
            np.testing.assert_array_equal(a, b)
        assert torch.equal(graph[0].full_tensor(), eager[0].full_tensor())


@pytest.mark.cuda
def test_sharded_aibm_as_a_graph_matches_eager(nccl_mesh):
    """AIBM on a sample-sharded Poisson problem (``shard_regression_problem``
    on the card's mesh) is captured as a graph, its k=0 set-up and steps
    under the rule that reduces a partial gradient before the simplex prox,
    and its rows and iterate equal ``eager_chunks``' bit for bit."""
    from torch.distributed.tensor import DTensor

    from accbpg_and_fw_tpu_torch.algorithms import driver
    from accbpg_and_fw_tpu_torch.parallel import shard_regression_problem

    rng = np.random.default_rng(1)
    A = rng.uniform(0.0, 1.0, (64, 20))
    b = A @ rng.uniform(0.0, 1.0, 20)
    f = port.PoissonRegression(A, b, device="cuda")
    f_sh, x_sh = shard_regression_problem(f, np.full(20, 0.05), nccl_mesh)

    def run():
        return port.AIBM(f_sh, port.BurgEntropySimplex(), 1.0, x_sh, 2.0, 40,
                         verbose=False)

    driver.clear_graph_cache()
    before = driver.GRAPH_STATS["captures"]
    graph = run()
    assert driver.GRAPH_STATS["captures"] > before
    assert isinstance(graph[0], DTensor)
    with driver.eager_chunks():
        eager = run()
    for a, b_ in zip(graph[1:-1], eager[1:-1]):
        np.testing.assert_array_equal(a, b_)
    assert torch.equal(graph[0].full_tensor(), eager[0].full_tensor())
    # the unsharded run on the card: the first rows alike (later a line
    # search's accept or reject may flip on last-bit differences of other
    # kernels' sums, and the accelerated run parts from there)
    unsharded = port.AIBM(f, port.BurgEntropySimplex(), 1.0,
                          torch.full((20,), 0.05, dtype=torch.float64,
                                     device="cuda"), 2.0, 40, verbose=False)
    np.testing.assert_allclose(graph[1][:4], unsharded[1][:4], rtol=1e-9)
    assert np.all(np.isfinite(graph[1])) and graph[1][-1] < graph[1][0]
