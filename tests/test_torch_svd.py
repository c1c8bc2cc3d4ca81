"""The nuclear ball's top singular pair (``ops/svd.py``): the plain version
of the kernel against JAX's ``lmo_nuclear_norm_ball`` (``jnp.linalg.svd``)
on the CPU, its sweeps, its layouts, and on the card the kernel against
the plain version and inside graph chunks.

Bars against JAX, in float64 on the same numpy inputs: the vertex
``outer(u1, v1)`` to atol 1e-15 at 6x4, 4x6, 1x5 and 5x1, a rank-1 matrix
and a zero one (``tests/test_torch_lmo.py``'s bar); to 1e-14 at 200x20
and 20x200, where sigma_1 - sigma_2 is about a twentieth of sigma_1; to
1e-12 at a top gap of 1e-3 (both SVDs' vectors move by about eps
sigma_1 / gap).  At a repeated top singular value the vertex is not
unique: there s must be rank 1 with ||s||_F = 1 and <g, s> = sigma_1 to
1e-12 relative.

The tests marked ``cuda`` hold the kernel against the plain version on
the card (``python -m pytest --noconftest -m cuda tests/test_torch_svd.py``):
1e-13 at every shape (the two sum the dot products in other orders), and
the nuclear solves as graphs against ``eager_chunks`` bit for bit.  JAX is
imported only inside the tests that use it, so they run without JAX.
"""

import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu_torch.ops import svd

torch.set_num_threads(1)


def _gapped(m, n, sv, seed):
    """An m x n matrix with singular values ``sv`` (k = min(m, n) of
    them) and random singular vectors."""
    rng = np.random.default_rng(seed)
    k = min(m, n)
    U, _ = np.linalg.qr(rng.standard_normal((m, k)))
    W, _ = np.linalg.qr(rng.standard_normal((n, k)))
    return (U * np.asarray(sv)) @ W.T


def _case(name):
    rng = np.random.default_rng(11)
    if name == "rank1":
        return np.outer(rng.standard_normal(7), rng.standard_normal(5))
    if name == "rank1_equal_columns":
        return np.outer(np.arange(1.0, 8.0), np.ones(5))
    if name == "rank1_graded":  # rotated against the others forever, the
        # columns it leaves at rounding level took the sweep bound on the
        # card before ``negligible``
        return np.outer(np.arange(1.0, 8.0), rng.standard_normal(5))
    if name == "zero_4x3":
        return np.zeros((4, 3))
    if name == "zero_3x4":
        return np.zeros((3, 4))
    if name == "gap_1e-3":
        sv = np.linspace(1.0, 0.1, 10)
        sv[1] = 1.0 - 1e-3
        return _gapped(30, 10, sv, 4)
    if name in ("200x20", "20x200"):
        m, n = map(int, name.split("x"))
        sv = np.linspace(2.0, 0.1, 20)  # sigma_1 - sigma_2 = 0.1
        return _gapped(m, n, sv, 5)
    m, n = map(int, name.split("x"))
    return rng.standard_normal((m, n))


CASES = [("6x4", 1e-15), ("4x6", 1e-15), ("1x5", 1e-15), ("5x1", 1e-15),
         ("200x20", 1e-14), ("20x200", 1e-14), ("rank1", 1e-15),
         ("rank1_equal_columns", 1e-15), ("rank1_graded", 1e-15),
         ("gap_1e-3", 1e-12),
         ("zero_4x3", 0.0), ("zero_3x4", 0.0)]


@pytest.mark.parametrize("name,atol", CASES)
def test_plain_version_matches_jax(name, atol):
    import jax.numpy as jnp

    import accbpg_and_fw_tpu as acc

    g = _case(name)
    sj = np.asarray(acc.lmo_nuclear_norm_ball()(jnp.asarray(g)))
    s = svd.top_singular_pair_reference(torch.tensor(g))
    sweeps = svd._jacobi_reference(torch.tensor(g))[2]
    assert s.dtype == torch.float64 and tuple(s.shape) == g.shape
    np.testing.assert_allclose(s.numpy(), sj, rtol=0, atol=atol)
    assert 1 <= sweeps < svd.MAX_SWEEPS


def test_zero_matrix_gives_the_first_corner():
    """sigma_1 = 0: outer(e1, e1), JAX's SVD of zeros, in both layouts."""
    for shape in ((4, 3), (3, 4)):
        s = svd.top_singular_pair_reference(torch.zeros(shape,
                                                        dtype=torch.float64))
        expect = np.zeros(shape)
        expect[0, 0] = 1.0
        np.testing.assert_array_equal(s.numpy(), expect)


@pytest.mark.parametrize("shape", [(9, 5), (5, 9)])
def test_repeated_top_singular_value_gives_a_valid_vertex(shape):
    """sigma_1 = sigma_2: any unit rank-1 s in the top singular subspace
    is a vertex; the one returned is rank 1, of unit norm, and attains
    <g, s> = sigma_1."""
    sv = [3.0, 3.0, 1.0, 0.5, 0.25]
    g = _gapped(*shape, sv, 8)
    s = svd.top_singular_pair_reference(torch.tensor(g)).numpy()
    assert np.linalg.matrix_rank(s, tol=1e-12) == 1
    np.testing.assert_allclose(np.linalg.norm(s), 1.0, rtol=1e-12)
    np.testing.assert_allclose(np.vdot(g, s), 3.0, rtol=1e-12)


@pytest.mark.parametrize("seed", range(6))
def test_sweeps_stay_under_the_bound(seed):
    """Random shapes and ranks, scaled by up to 1e+-100 (a rank-deficient
    matrix leaves columns of rounding noise, which ``negligible`` keeps
    out of the rotations): the sweeps end well under MAX_SWEEPS."""
    rng = np.random.default_rng(seed)
    m, n = rng.integers(2, 40, 2)
    r = int(rng.integers(1, min(m, n) + 1))
    g = (rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
         * 10.0 ** rng.integers(-100, 100))
    sweeps = svd._jacobi_reference(torch.tensor(g))[2]
    assert sweeps <= svd.MAX_SWEEPS // 2


@pytest.mark.parametrize("k", [1, 2, 5, 8, 20, 21])
def test_rounds_cover_every_pair_once(k):
    """kk - 1 rounds; a round's pairs touch distinct columns; every pair
    i < j < k once in a sweep."""
    rounds = svd.rounds(k)
    assert len(rounds) == max(k + k % 2 - 1, 1)
    seen = []
    for r in rounds:
        cols = [c for pair in r for c in pair]
        assert len(cols) == len(set(cols))
        assert all(i < j < k for i, j in r)
        seen += r
    assert sorted(seen) == [(i, j) for i in range(k)
                            for j in range(i + 1, k)]


@pytest.mark.parametrize("pairs", [1, 2, 4, 7])
@pytest.mark.parametrize("k", [1, 2, 5, 8, 20, 21, 200, 1000])
def test_ring_exchange_reproduces_rounds(k, pairs):
    """The ring layout's exchange (``ring_rounds``): the pairs placed on
    CTAs of ``pairs`` pairs, each CTA's columns in the buffers of its
    arcs, shifted by a slot map, and at the start of each round the
    column that left an arc in the round before sent to the neighbouring
    CTA.  It gives ``rounds(k)`` round for round over two sweeps (across
    the sweep's wrap; one at k = 1000); no send lands in a buffer that a
    neighbour a round behind may still use; every cycle position is held
    by exactly one CTA."""
    sweeps = 2 if k < 1000 else 1  # the wrap, where it stays cheap
    assert svd.ring_rounds(k, pairs, sweeps) == svd.rounds(k) * sweeps
    kk = k + k % 2
    Q, L = kk // 2, kk - 1
    C = -(-Q // pairs)
    held = []
    for c in range(C):
        q0, q1, arcs, fixed = svd.ring_layout(c, C, Q, pairs)
        assert q1 - q0 >= 1
        used = [b for _, _, nb, base, _, _ in arcs
                for b in range(base, base + nb)]
        used += [] if fixed is None else [fixed]
        assert sorted(used) == list(range(len(used)))
        assert len(used) <= svd.ring_buffers(Q, pairs, C)
        for t0, n, nb, _, cin, cout in arcs:
            held += [(t0 + u) % L for u in range(n)]
            assert (cin, cout) == (-1, -1) if C == 1 else (
                0 <= cin < C and 0 <= cout < C and abs(cin - c) == 1
                and abs(cout - c) == 1 and nb == n + 2)
    assert sorted(held) == list(range(L))


def test_svd_plan_layouts():
    """Three layouts by shape.  Resident where A, V and the norms fit in
    one CTA's shared memory (SymNMF's 200x20: 35,360 bytes), a warp a
    pair, at most 32.  Ring where the card's CTAs hold A and V (each
    CTA's ``ring_buffers`` columns within its shared memory): in one
    cluster of up to 16 where its CTAs hold them, else spread over the
    card, a CTA a multiprocessor, mailboxes between all CTAs.  Else
    streamed, over CTAs of 4 warps, one warp a pair, at most one CTA a
    multiprocessor, with a partial sum a CTA and two flags beside A, V
    and the norms.  A is g^T where m < n."""
    limit = 232448 - 1024  # an H100's opt-in shared bytes, less statics
    p = svd.svd_plan(200, 20, limit)
    assert (p.p, p.k, p.transposed, p.layout, p.warps, p.ctas) == \
        (200, 20, False, "resident", 10, 1)
    assert p.work_bytes == 8 * (200 * 20 + 20 * 20 + 20) == 35360
    q = svd.svd_plan(20, 200, limit)
    assert (q.p, q.k, q.transposed, q.layout) == (200, 20, True, "resident")
    # 600x60: A and V are 317 KB, past one CTA; 30 pairs, 2 a CTA in one
    # cluster of 16 (15 CTAs hold pairs), 2 warps a pair
    big = svd.svd_plan(600, 60, limit)
    assert (big.layout, big.pairs, big.pair_warps, big.warps, big.ctas,
            big.cluster) == ("ring", 2, 2, 4, 16, 16)
    cs = svd.colstride(600, 60)
    assert cs == 660 and big.smem_bytes == 8 * cs * (2 * 2 + 4)
    # mailboxes (a column and a flag for 2 sides x 2 parities a ring
    # CTA), a partial sum and a best norm a CTA, a pad to 16 bytes, the
    # top column
    head = 15 * 4 * (cs + 1) + 3 * 16
    assert big.work_bytes == svd.ring_work_bytes(600, 60, 15, 16) == 8 * (
        head + cs) == 322944
    # 1000x200: 100 pairs, 7 a CTA in one cluster, a warp a pair
    ring = svd.svd_plan(1000, 200, limit, sms=132)
    assert (ring.layout, ring.pairs, ring.pair_warps, ring.ctas,
            ring.cluster) == ("ring", 7, 1, 16, 16)
    # 1000x1000: 500 pairs; 32 a CTA would not fit one cluster's CTAs:
    # spread over the card's 132 SMs, 4 a CTA, 125 CTAs, 2 warps a pair
    square = svd.svd_plan(1000, 1000, limit, sms=132)
    assert (square.layout, square.pairs, square.pair_warps, square.warps,
            square.ctas, square.cluster) == ("ring", 4, 2, 8, 125, 1)
    assert square.smem_bytes == 8 * 2000 * (2 * 4 + 4) == 192000
    # past the card's shared memory: streamed
    assert svd.svd_plan(1000, 2000, limit, sms=100).ctas == 100
    assert svd.svd_plan(1000, 2000, limit, sms=100).layout == "streamed"
    assert svd.svd_plan(1, 5, limit).warps == 1
    assert svd.svd_plan(3, 100000, limit)[5:7] == ("streamed", 2)
    assert svd.svd_plan(200, 20, 0).ctas == 3  # 10 pairs over 4 warps
    # the bound between the resident layout and the ring
    k = 20
    fits = (limit - 1024) // 8 - k * k - k
    p_max = fits // k
    assert svd.svd_plan(p_max, k, limit).layout == "resident"
    assert svd.svd_plan(p_max + 1, k, limit).layout == "ring"
    # the bound between the ring and the streamed layout (no SM cap: a
    # pair a CTA spread, 1 x 2 + 4 buffers of 2 (p + k) doubles, even)
    k = 60
    p_ring = (limit - 1024) // (8 * 6) - k
    p_ring -= (p_ring + k) % 2
    assert svd.svd_plan(p_ring, k, limit).layout == "ring"
    assert svd.svd_plan(p_ring + 2, k, limit).layout == "streamed"
    # a CTA at most 16 warps, a cluster at most 16 CTAs
    for pairs, warps, cluster in ((4, 8, 1), (2, 1, 32)):
        with pytest.raises(ValueError):
            svd.ring_plan(600, 60, pairs, warps, cluster)
    with pytest.raises(ValueError, match="shared bytes"):
        svd.ring_plan(1000, 1000, 6, 2, 1, limit)
    with pytest.raises(ValueError):
        svd.svd_plan(0, 3, limit)


def test_wrapper_routes_by_device():
    """The CPU takes the plain version and counts no launch; another
    device or dtype raises."""
    g = torch.tensor(_case("6x4"))
    before = svd.LAUNCHES
    assert torch.equal(svd.top_singular_pair(g),
                       svd.top_singular_pair_reference(g))
    assert torch.equal(port.lmo_nuclear_norm_ball()(g),
                       svd.top_singular_pair_reference(g))
    assert svd.LAUNCHES == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        svd.top_singular_pair(torch.zeros(3, 2, dtype=torch.float64,
                                          device="meta"))
    with pytest.raises(ValueError, match="float64"):
        svd.top_singular_pair(g.float())


# ---- on the card ------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["6x4", "4x6", "1x5", "5x1", "200x20",
                                  "20x200", "rank1", "rank1_equal_columns",
                                  "rank1_graded", "zero_4x3", "600x60",
                                  "60x600", "1000x200"])
def test_kernel_matches_plain_version_on_card(name):
    """Each shape in its own layout (600x60, 60x600 and 1000x200 in the
    ring, 1e-12 at 1000x200 as chip_smoke.py's SVD_TOL_LARGE), and the
    resident ones also through the streamed layout and through rings of
    one, two and several CTAs (two pairs a CTA, alone and in clusters of
    two)."""
    dev = _card()
    g = (torch.tensor(np.random.default_rng(3).standard_normal(
        tuple(map(int, name.split("x")))), device=dev)
        if name in ("600x60", "60x600", "1000x200")
        else torch.tensor(_case(name), device=dev))
    tol = 1e-12 if name == "1000x200" else 1e-13
    s, sweeps = svd._launch_cuda(g)
    ref = svd.top_singular_pair_reference(g)
    torch.testing.assert_close(s, ref, rtol=0, atol=tol)
    assert 1 <= int(sweeps) < svd.MAX_SWEEPS
    plan = svd.device_plan(*g.shape, dev.index)
    if name in ("600x60", "60x600", "1000x200"):
        assert plan.layout == "ring"
    if plan.layout == "resident":
        streamed = svd.svd_plan(*g.shape, 0)
        assert streamed.layout == "streamed"
        torch.testing.assert_close(svd._launch_cuda(g, streamed)[0], s,
                                   rtol=0, atol=1e-13)
        k = min(g.shape)
        Q = (k + 1) // 2
        for pairs, cluster in ((Q, 1), (-(-Q // 2), 1), (2, 1), (2, 2)):
            ring = svd.ring_plan(*g.shape, pairs, 1, cluster,
                                 svd.smem_limit(dev.index))
            torch.testing.assert_close(svd._launch_cuda(g, ring)[0], s,
                                       rtol=0, atol=1e-13)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(200, 20), (600, 60), (1000, 200)])
def test_one_launch_per_lmo_call_in_a_graph(shape):
    """A captured LMO call is one kernel node in either layout (600x60 and
    1000x200 are rings: a cooperative launch): each replay adds one launch
    on the card and none on the host, and gives the eager call's bits."""
    import ctypes

    dev = _card()
    nuc = port.lmo_nuclear_norm_ball()
    g = torch.tensor(np.random.default_rng(4).standard_normal(shape),
                     device=dev)
    eager = nuc(g)  # built and loaded outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = nuc(g)
    nodes = ctypes.c_size_t(0)
    assert ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None,
        ctypes.byref(nodes)) == 0
    assert nodes.value == 1
    graph.instantiate()
    svd.reset_device_stats()
    host = svd.LAUNCHES
    for _ in range(5):
        graph.replay()
    torch.cuda.synchronize()
    launches, at_bound, _ = svd.device_stats()
    assert (launches, at_bound, svd.LAUNCHES) == (5, 0, host)
    assert torch.equal(out, eager)
    torch.testing.assert_close(out, svd.top_singular_pair_reference(g),
                               rtol=0, atol=1e-12 if shape[0] > 600
                               else 1e-13)


@pytest.mark.cuda
def test_nuclear_solves_as_graphs_match_eager_on_card():
    """FW_alg_descent_step and BPG through SumOf2nd4thPowersWithFrankWolfe
    with the nuclear ball on a SymNMF problem: one capture each, rows bit
    for bit with ``eager_chunks``, no solve at the sweep bound."""
    from accbpg_and_fw_tpu_torch.algorithms import driver

    dev = _card()
    A = np.abs(np.random.default_rng(6).standard_normal((40, 4)))
    f = port.FrobeniusSymLoss(A @ A.T / 4, device=dev)
    X0 = torch.full((40, 4), 0.01, dtype=torch.float64, device=dev)
    nuc = port.lmo_nuclear_norm_ball()
    runs = {
        "descent": lambda: port.FW_alg_descent_step(
            f, port.SquaredL2Norm(), X0, 40, nuc, verbose=False),
        "bpg": lambda: port.BPG(
            f, port.SumOf2nd4thPowersWithFrankWolfe(lmo=nuc), 1.0, X0, 40,
            linesearch=False, verbose=False)}
    svd.reset_device_stats()
    for name, run in runs.items():
        driver.clear_graph_cache()
        before = driver.GRAPH_STATS["captures"]
        g = run()
        assert driver.GRAPH_STATS["captures"] == before + 1, name
        with driver.eager_chunks():
            e = run()
        # the descent step returns (x, F, T, G), BPG (x, F, Ls, T)
        rows = slice(1, 2) if name == "descent" else slice(1, -1)
        for a, b in zip(g[rows], e[rows]):
            np.testing.assert_array_equal(a, b)
        assert torch.equal(g[0], e[0])
    launches, at_bound, _ = svd.device_stats()
    assert launches > 0 and at_bound == 0
