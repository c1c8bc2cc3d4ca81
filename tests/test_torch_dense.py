"""The port's dense block engine (``ops/dopt_dense.py``) against the JAX
package's ``ops/pallas_dopt.py``.

On the CPU ``dense_block`` runs its plain PyTorch version; the JAX kernels
run in interpret mode with x64, as tests/test_pallas_dopt.py runs them.
The JAX kernels carry double-single state and record float32 histories,
so the bars are: x atol 1e-11; SP and SN atol 1e-9 plus half a float32
ulp (the JAX slacks are float32 roundings of values within ~1e-12 of the
port's); F rtol 1e-7 scaled by the largest |F|
of the run (the JAX tau history is float32, and its rounding accumulates
along the run, so it is an error relative to the run's scale, not to an F
row that crosses zero).

The tests marked ``cuda`` need a card: they hold the Hopper kernel against
the plain version over one block (identical pivots; x, w, H rtol 1e-11
scaled by each array's max-abs; tau, tau (w_v - 1), SP, SN atol 1e-12)
and skip without one.  JAX is imported inside fixtures, so the card tests
run with ``python -m pytest --noconftest -m cuda tests/test_torch_dense.py``.
"""

import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu_torch.ops import dopt_dense as dd
from accbpg_and_fw_tpu_torch.ops.dopt_common import factorize

from test_torch_lazy import keep_jax_exec_cache  # noqa: F401 (autouse)

torch.set_num_threads(1)

X_ATOL, SP_ATOL, F_RTOL = 1e-11, 1e-9, 1e-7
F32_HALF_ULP = 2.0 ** -24
STATE_RTOL, HIST_ATOL = 1e-11, 1e-12
EPS, BUDGET = 1e-8, 400
SHAPES = [(12, 160), (30, 300)]


def _design(shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.fixture(scope="module")
def jax_single():
    """``dopt_fw_pallas(interpret=True)`` per (shape, away), run once."""
    from accbpg_and_fw_tpu.ops.pallas_dopt import dopt_fw_pallas

    cache = {}

    def run(shape, away):
        if (shape, away) not in cache:
            V = _design(shape)
            x0 = np.full(shape[1], 1.0 / shape[1])
            cache[shape, away] = dopt_fw_pallas(
                V, x0, EPS, BUDGET, away=away, verbose=False, chunk=256,
                interpret=True)
        return cache[shape, away]

    return run


@pytest.fixture(scope="module")
def batch_problem():
    Vs = _design((3, 12, 160), seed=5)
    return Vs, np.full((3, 160), 1.0 / 160)


@pytest.fixture(scope="module")
def jax_batch(batch_problem):
    from accbpg_and_fw_tpu.ops.pallas_dopt import dopt_fw_pallas_batch

    Vs, x0s = batch_problem
    return dopt_fw_pallas_batch(Vs, x0s, 1e-6, 2000, interpret=True, group=2)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")



def _assert_matches_jax(got, ref):
    """``(x, F, SP, SN)`` of the port against the JAX kernel's."""
    x, F, SP, SN = got
    xj, Fj, SPj, SNj = ref
    assert np.shape(F) == np.shape(Fj)
    np.testing.assert_allclose(np.asarray(x), np.asarray(xj), rtol=0,
                               atol=X_ATOL)
    for a, b in ((SP, SPj), (SN, SNj)):
        np.testing.assert_allclose(a, np.asarray(b, np.float64),
                                   rtol=F32_HALF_ULP, atol=SP_ATOL)
    Fj = np.asarray(Fj)
    np.testing.assert_allclose(F, Fj, rtol=F_RTOL,
                               atol=F_RTOL * np.abs(Fj).max())


def _fresh(Vs, device="cpu"):
    Vs = torch.as_tensor(Vs, dtype=torch.float64, device=device)
    B, m, n = Vs.shape
    xs = torch.full((B, n), 1.0 / n, dtype=torch.float64, device=device)
    parts = [factorize(Vs[b], xs[b]) for b in range(B)]
    return (Vs, torch.stack([p[0] for p in parts]), xs,
            torch.stack([p[1] for p in parts]))


@pytest.mark.parametrize("shape", SHAPES, ids=["12x160", "30x300"])
@pytest.mark.parametrize("away", [True, False], ids=["away", "plain"])
def test_single_matches_jax_kernel(jax_single, shape, away):
    V = _design(shape)
    x0 = np.full(shape[1], 1.0 / shape[1])
    before = dd.LAUNCHES
    x, F, SP, SN, T = dd.dopt_fw_dense(V, x0, EPS, BUDGET, away=away,
                                       verbose=False, chunk=256, device="cpu")
    assert dd.LAUNCHES == before  # CPU tensors take the plain block
    assert isinstance(x, torch.Tensor) and x.dtype == torch.float64
    assert len(T) == len(F)
    xj, Fj, SPj, SNj, _ = jax_single(shape, away)
    _assert_matches_jax((x.numpy(), F, SP, SN), (xj, Fj, SPj, SNj))


def test_batch_matches_jax_kernel_with_groups(batch_problem, jax_batch):
    """K=3 in groups of 2: the same lockstep row count (the stopped
    instances' frozen rows included, and the second group padded to the
    first's length) and the same rows."""
    Vs, x0s = batch_problem
    x, F, SP, SN = dd.dopt_fw_dense_batch(Vs, x0s, 1e-6, 2000, group=2,
                                          device="cpu")
    assert F.shape == (3, 896)  # stops 573, 842, 583: lockstep rows 896
    _assert_matches_jax((x.numpy(), F, SP, SN), jax_batch)
    for k in range(3):
        stop = int(np.argmax((SP[k] <= 1e-6) & (SN[k] <= 1e-6)))
        assert (F[k, stop:] == F[k, stop]).all()
        assert (SP[k, stop:] == SP[k, stop]).all()


def test_batch_one_group_matches_groups(batch_problem):
    Vs, x0s = batch_problem
    a = dd.dopt_fw_dense_batch(Vs, x0s, 1e-6, 2000, device="cpu")
    b = dd.dopt_fw_dense_batch(Vs, x0s, 1e-6, 2000, group=2, device="cpu")
    assert torch.equal(a[0], b[0])
    for i in (1, 2, 3):
        np.testing.assert_array_equal(a[i], b[i])


def test_batch_refresh_every(batch_problem, monkeypatch):
    """A full refactorization of every instance at the first launch
    boundary past R rows; it moves the run by rounding only."""
    Vs, x0s = batch_problem
    calls = []
    real = dd.factorize

    def spy(V_, x_):
        calls.append(1)
        return real(V_, x_)

    monkeypatch.setattr(dd, "factorize", spy)
    x, F, SP, SN = dd.dopt_fw_dense_batch(Vs, x0s, 1e-6, 2000, chunk=256,
                                          refresh_every=500, device="cpu")
    # launches end at 256, 512, ...: refreshes after 512 (and not again
    # before every instance stopped at 896 rows)
    assert len(calls) == 3 * 2
    x0, F0, *_ = dd.dopt_fw_dense_batch(Vs, x0s, 1e-6, 2000, chunk=256,
                                        device="cpu")
    assert F.shape == F0.shape
    np.testing.assert_allclose(F, F0, rtol=0, atol=1e-10)
    np.testing.assert_allclose(x.numpy(), x0.numpy(), rtol=0, atol=1e-12)


def test_lockstep_rows_rule():
    misc = np.array([[1.0, 300.0, 299.0], [1.0, 10.0, 9.0]])
    entered = np.array([False, False])
    assert dd._lockstep_rows(misc, entered, 4096) == 384
    assert dd._lockstep_rows(misc, entered, 350) == 350
    running = np.array([[0.0, 500.0, 500.0], [1.0, 10.0, 9.0]])
    assert dd._lockstep_rows(running, entered, 500) == 500
    frozen = np.array([[1.0, 0.0, 0.0], [1.0, 129.0, 128.0]])
    assert dd._lockstep_rows(frozen, np.array([True, False]), 4096) == 256
    assert dd._lockstep_rows(frozen, np.array([True, True]), 4096) == 0


def test_dense_block_rows_contract():
    """Stop inside the block: the stop row records slacks only and the
    rows after it repeat them; an instance that entered done records its
    slacks on every row and runs nothing."""
    Vs, Hs, xs, ws = _fresh(_design((2, 8, 64), seed=11))
    before = dd.LAUNCHES
    out = dd.dense_block(Vs, Hs, xs, ws, eps=1e-3, kmax=300,
                         done=[False, True])
    ref = dd.dense_block_reference(Vs, Hs, xs, ws, eps=1e-3, kmax=300,
                                   done=[False, True])
    assert dd.LAUNCHES == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    done, iters, nrun = out.misc[0].tolist()
    assert done == 1.0 and 0 < iters < 300 and nrun == iters - 1
    h = out.hist[0]
    stop = int(iters) - 1
    assert (h[2, stop:] == h[2, stop]).all() and (h[4, stop:] == -1).all()
    assert (h[0, stop:] == 0).all() and (h[0, :stop] != 0).all()
    assert out.misc[1].tolist() == [1.0, 0.0, 0.0]
    assert torch.equal(out.x[1], xs[1]) and torch.equal(out.H[1], Hs[1])
    assert (out.hist[1, 4] == -1).all() and (out.hist[1, 0] == 0).all()
    sp1 = (float(ws[1].max()) - 8.0) / 8.0
    assert torch.allclose(out.hist[1, 2], torch.full((300,), sp1,
                                                     dtype=torch.float64))


def test_dense_block_state_is_a_fresh_factorization():
    Vs, Hs, xs, ws = _fresh(_design((1, 12, 160)))
    out = dd.dense_block(Vs, Hs, xs, ws, eps=1e-8, kmax=50)
    H_new, w_new, _ = factorize(Vs[0], out.x[0])
    torch.testing.assert_close(out.H[0], H_new, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(out.w[0], w_new, rtol=1e-10, atol=0)


def test_dense_block_rejects_bad_arguments():
    Vs, Hs, xs, ws = _fresh(_design((2, 8, 64)))
    with pytest.raises(TypeError, match="float64"):
        dd.dense_block(Vs.float(), Hs, xs, ws, eps=1e-8, kmax=4)
    with pytest.raises(ValueError, match="contiguous"):
        dd.dense_block(Vs, Hs.transpose(1, 2), xs, ws, eps=1e-8, kmax=4)
    with pytest.raises(ValueError, match="shape"):
        dd.dense_block(Vs, Hs, xs[:, :-1], ws, eps=1e-8, kmax=4)
    with pytest.raises(ValueError, match="done"):
        dd.dense_block(Vs, Hs, xs, ws, eps=1e-8, kmax=4, done=[False])


def test_d_opt_entry_routes_pallas():
    """u_mode="pallas" through the public entry point is this engine."""
    V = _design((12, 160))
    x0 = np.full(160, 1.0 / 160)
    a = port.D_opt_FW(V, x0, 1e-8, 70, verbose=False, u_mode="pallas",
                      device="cpu")
    b = dd.dopt_fw_dense(V, x0, 1e-8, 70, away=False, verbose=False,
                         device="cpu")
    assert torch.equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_budget_and_chunk(acc_exact):
    """A budget across launches of 64: the exact engine's run."""
    V, x0, xe, Fe = acc_exact
    x, F, SP, SN, T = dd.dopt_fw_dense(V, x0, 1e-8, 150, verbose=False,
                                       chunk=50, device="cpu")
    assert len(F) == 150
    np.testing.assert_allclose(F, Fe, rtol=1e-9)
    np.testing.assert_allclose(x.numpy(), xe, rtol=0, atol=X_ATOL)


@pytest.fixture(scope="module")
def acc_exact():
    import accbpg_and_fw_tpu as acc

    V = _design((12, 160))
    x0 = np.full(160, 1.0 / 160)
    xe, Fe, *_ = acc.D_opt_FW_away(V, x0, 1e-8, 150, verbose=False,
                                   chunk=150)
    return V, x0, np.asarray(xe), np.asarray(Fe)


def test_refresh_every_full_refactorization(monkeypatch):
    V = _design((12, 160))
    x0 = np.full(160, 1.0 / 160)
    calls = []
    real = dd.factorize

    def spy(V_, x_):
        calls.append(1)
        return real(V_, x_)

    monkeypatch.setattr(dd, "factorize", spy)
    dd.dopt_fw_dense(V, x0, 1e-8, 200, verbose=False, chunk=64,
                     refresh_every=100, device="cpu")
    # launches end at 64, 128, 192, 200: a refresh after 128, then none
    # before the budget ends
    assert len(calls) == 2


def test_checkpoint_resume(tmp_path):
    V = _design((12, 160))
    x0 = np.full(160, 1.0 / 160)
    ck = str(tmp_path / "dense.npz")
    a = dd.dopt_fw_dense(V, x0, 1e-8, 128, verbose=False, chunk=64,
                         checkpoint=ck, device="cpu")
    b = dd.dopt_fw_dense(V, x0, 1e-8, 256, verbose=False, chunk=64,
                         checkpoint=ck, device="cpu")
    full = dd.dopt_fw_dense(V, x0, 1e-8, 256, verbose=False, chunk=64,
                            device="cpu")
    assert len(b[1]) == 256
    np.testing.assert_array_equal(b[2][:128], a[2])
    np.testing.assert_allclose(b[1], full[1], rtol=1e-9)
    np.testing.assert_allclose(b[0].numpy(), full[0].numpy(), rtol=0,
                               atol=X_ATOL)
    with pytest.raises(ValueError, match="different solve"):
        dd.dopt_fw_dense(V, x0, 1e-6, 256, verbose=False, checkpoint=ck,
                         device="cpu")


def test_verbose_rows(capsys):
    V = _design((12, 160))
    dd.dopt_fw_dense(V, np.full(160, 1.0 / 160), 1e-8, 10, verbose=True,
                     verbskip=5, device="cpu")
    out = capsys.readouterr().out
    assert "dense block kernel" in out
    rows = [ln for ln in out.splitlines() if ln[:6].strip().isdigit()]
    assert [int(r[:6]) for r in rows] == [0, 5]


# --------------------------------------------------------------------------
# the kernel's launch plan (plain Python, decided from the shape and the card)
# --------------------------------------------------------------------------

SMS, SMEM_LIMIT = 132, 232448  # an H100's SMs and shared memory per CTA


@pytest.mark.parametrize("max_cluster", [1, 8, 16])
@pytest.mark.parametrize("B,m,n", [
    (1, 30, 1000), (4, 30, 1000), (32, 30, 1000), (200, 30, 1000),
    (1, 100, 1000), (1, 165, 1000), (1, 30, 999), (3, 30, 1003),
    (2, 200, 700), (3, 8, 64), (1, 12, 400)])
def test_dense_plan_covers_every_column_once(B, m, n, max_cluster):
    plan = dd.dense_plan(B, m, n, SMS, SMEM_LIMIT, max_cluster)
    assert plan == dd.dense_plan(B, m, n, SMS, SMEM_LIMIT, max_cluster)
    assert plan.n == n
    assert plan.cluster in (1, 2, 4, 8, 16) and plan.cluster <= max_cluster
    assert plan.threads in (32, 64, 128, 256, 512)
    # the grid is B clusters of one CTA per SM at most; a lone CTA per
    # instance may outnumber the SMs (its launches queue)
    assert plan.cluster == 1 or B * plan.cluster <= SMS
    # each warp of a cluster has a slot in every CTA
    assert plan.cluster * plan.threads // 32 <= dd._MAX_SLOTS
    owned = [j for r in range(plan.cluster) for j in plan.cols(r)]
    assert owned == list(range(n))
    assert all(len(plan.cols(r)) <= plan.chunk for r in range(plan.cluster))
    # what the plan keeps in shared memory fits in what it asks for
    need = 3 * m
    if plan.h_in_smem:
        need += m * m
    if plan.resident:
        need += m * (plan.chunk | 1) + 2 * plan.chunk
    assert 8 * need == plan.smem_bytes
    assert plan.smem_bytes + dd._STATIC_SMEM <= SMEM_LIMIT
    # only a lone CTA streams V or leaves H in global memory
    assert plan.resident or plan.cluster == 1
    assert plan.h_in_smem or not plan.resident


@pytest.mark.parametrize("B,m,n,cluster,resident,h_in_smem", [
    (1, 30, 1000, 8, 1, 1),     # one instance: 125 columns per CTA
    (4, 30, 1000, 8, 1, 1),
    (32, 30, 1000, 4, 1, 1),    # the dense sweep: 128 CTAs, 250 columns each
    (200, 30, 1000, 1, 0, 1),   # more instances than SMs: one CTA each
    (1, 100, 1000, 8, 1, 1),
    (1, 165, 1000, 1, 0, 1),    # H leaves no room for a panel: V streamed
    (2, 200, 700, 1, 0, 0),     # H does not fit either
    (3, 8, 64, 1, 1, 1)])       # too few columns for a second CTA
def test_dense_plan_at_the_paths_shapes(B, m, n, cluster, resident,
                                        h_in_smem):
    plan = dd.dense_plan(B, m, n, SMS, SMEM_LIMIT, 16)
    assert (plan.cluster, plan.resident, plan.h_in_smem) == (
        cluster, resident, h_in_smem)
    # under a smaller cap the cluster shrinks (to one CTA where no panel of
    # half the columns fits beside H)
    assert dd.dense_plan(B, m, n, SMS, SMEM_LIMIT, 2).cluster in (
        {1, 2} if m == 100 else {min(cluster, 2)})


@pytest.mark.parametrize("B,m,n,sms,limit,max_cluster", [
    (0, 30, 1000, SMS, SMEM_LIMIT, 16), (1, 0, 1000, SMS, SMEM_LIMIT, 16),
    (1, 30, 0, SMS, SMEM_LIMIT, 16), (1, 30, 1000, 0, SMEM_LIMIT, 16),
    (1, 30, 1000, SMS, SMEM_LIMIT, 3), (1, 30, 1000, SMS, SMEM_LIMIT, 32),
    (1, 20000, 1000, SMS, SMEM_LIMIT, 16), (1, 30, 1000, SMS, 1024, 16)])
def test_dense_plan_rejects_invalid_sizes(B, m, n, sms, limit, max_cluster):
    with pytest.raises(ValueError):
        dd.dense_plan(B, m, n, sms, limit, max_cluster)


# --------------------------------------------------------------------------
# ties across the CTAs' panels: the lowest index wins
# --------------------------------------------------------------------------

TIE_SHAPE, TIE_BUDGET = (12, 400), 96


def _tie_design():
    """A design whose second half repeats its first: w_j == w_{j+200} in
    every iteration, so every pivot is a tie between two columns."""
    V = _design(TIE_SHAPE, seed=17)
    V[:, 200:] = V[:, :200]
    return V


def test_tie_design_splits_equal_columns_across_panels():
    plan = dd.dense_plan(1, *TIE_SHAPE, SMS, SMEM_LIMIT, 16)
    assert plan.cluster > 1
    owner = {j: r for r in range(plan.cluster) for j in plan.cols(r)}
    assert all(owner[j] != owner[j + 200] for j in range(200))


def test_ties_take_the_lowest_index_as_the_jax_kernel():
    """The plain block against the JAX kernel in interpret mode, as
    ``test_single_matches_jax_kernel`` runs it and to its bars."""
    from accbpg_and_fw_tpu.ops.pallas_dopt import dopt_fw_pallas

    V = _tie_design()
    x0 = np.full(TIE_SHAPE[1], 1.0 / TIE_SHAPE[1])
    ref = dopt_fw_pallas(V, x0, EPS, TIE_BUDGET, away=True, verbose=False,
                         chunk=256, interpret=True)
    x, F, SP, SN, _ = dd.dopt_fw_dense(V, x0, EPS, TIE_BUDGET, away=True,
                                       verbose=False, chunk=256,
                                       device="cpu")
    _assert_matches_jax((x.numpy(), F, SP, SN), ref[:4])
    # a Frank-Wolfe step's argmax is a tie between j and j + 200: always j
    Vs, Hs, xs, ws = _fresh(V[None])
    assert torch.equal(ws[0, :200], ws[0, 200:])
    blk = dd.dense_block_reference(Vs, Hs, xs, ws, eps=EPS, kmax=TIE_BUDGET)
    tau, v = blk.hist[0, 0], blk.hist[0, 4]
    assert int((tau > 0).sum()) > 10
    assert bool((v[tau > 0] < 200).all())
    # an away step's argmin too, while x_j is still in the support
    assert bool((v[:5] < 200).all())


def _assert_blocks_agree(out, ref):
    misc, misc_ref = out.misc.cpu(), ref.misc.cpu()
    assert torch.equal(misc, misc_ref)
    h, h_ref = out.hist.cpu(), ref.hist.cpu()
    assert torch.equal(h[:, 4], h_ref[:, 4]), "pivot sequences differ"
    for got, want in ((out.x, ref.x), (out.w, ref.w), (out.H, ref.H)):
        got, want = got.cpu(), want.cpu()
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=STATE_RTOL,
                                   atol=STATE_RTOL * scale)
    torch.testing.assert_close(h[:, :4], h_ref[:, :4], rtol=0,
                               atol=HIST_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,eps,done", [
    ((4, 30, 1000), 1e-8, None),
    ((1, 30, 1000), 1e-8, None),
    ((3, 8, 64), 1e-3, [False, True, False]),   # stops and a frozen entry
    ((2, 200, 700), 1e-8, None),                # H in global memory
    ((1, 165, 1000), 1e-8, None),               # H in shared, V streamed
    ((32, 30, 1000), 1e-8, None),               # the sweep's clusters of 4
    ((3, 30, 1003), 1e-6, [False, False, True]),  # ragged last panel
    ((1, 100, 1000), 1e-8, None),
], ids=["4x30x1000", "1x30x1000", "stop-and-frozen", "H-global",
        "V-streamed", "32x30x1000", "ragged-and-frozen", "1x100x1000"])
def test_kernel_matches_plain_version_on_card(cuda_dev, shape, eps, done):
    Vs, Hs, xs, ws = _fresh(_design(shape, seed=11), cuda_dev)
    ref = dd.dense_block_reference(Vs, Hs, xs, ws, eps=eps, kmax=256,
                                   done=done)
    before = dd.LAUNCHES
    out = dd.dense_block(Vs, Hs, xs, ws, eps=eps, kmax=256, done=done)
    torch.cuda.synchronize()
    assert dd.LAUNCHES == before + 1
    _assert_blocks_agree(out, ref)


@pytest.mark.cuda
def test_kernel_on_cuda_never_takes_the_plain_path(cuda_dev, monkeypatch):
    Vs, Hs, xs, ws = _fresh(_design((2, 12, 160)), cuda_dev)
    ref = dd.dense_block_reference(Vs, Hs, xs, ws, eps=1e-8, kmax=128)

    def plain_taken(*args, **kwargs):
        raise AssertionError("dense_block ran the plain version on CUDA")

    monkeypatch.setattr(dd, "dense_block_reference", plain_taken)
    monkeypatch.setattr(dd, "_dense_one", plain_taken)
    out = dd.dense_block(Vs, Hs, xs, ws, eps=1e-8, kmax=128)
    torch.cuda.synchronize()
    _assert_blocks_agree(out, ref)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(cuda_dev):
    V = _design((12, 160))
    x0 = np.full(160, 1.0 / 160)
    x, F, SP, SN, T = dd.dopt_fw_dense(V, x0, 1e-8, 600, verbose=False,
                                       chunk=128, device=cuda_dev)
    xc, Fc, *_ = dd.dopt_fw_dense(V, x0, 1e-8, 600, verbose=False,
                                  chunk=128, device="cpu")
    assert x.device.type == "cuda" and len(F) == len(Fc)
    np.testing.assert_allclose(F, Fc, rtol=1e-9)
    np.testing.assert_allclose(x.cpu().numpy(), xc.numpy(), rtol=0,
                               atol=X_ATOL)


@pytest.mark.cuda
def test_kernel_breaks_ties_across_panels_as_plain_version(cuda_dev):
    """Equal w in different CTAs' panels: the kernel's pivots are the
    plain version's, row for row."""
    Vs, Hs, xs, ws = _fresh(_tie_design()[None], cuda_dev)
    plan, _ = dd.device_plan(1, *TIE_SHAPE, cuda_dev.index or 0)
    assert plan.cluster > 1
    ref = dd.dense_block_reference(Vs, Hs, xs, ws, eps=EPS, kmax=TIE_BUDGET)
    out = dd.dense_block(Vs, Hs, xs, ws, eps=EPS, kmax=TIE_BUDGET)
    torch.cuda.synchronize()
    _assert_blocks_agree(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 30, 1000), (32, 30, 1000),
                                   (1, 165, 1000), (2, 200, 700),
                                   (3, 30, 1003)],
                         ids=["1x30x1000", "32x30x1000", "V-streamed",
                              "H-global", "ragged"])
def test_two_launches_give_the_same_bits(cuda_dev, shape):
    Vs, Hs, xs, ws = _fresh(_design(shape, seed=13), cuda_dev)
    a = dd.dense_block(Vs, Hs, xs, ws, eps=EPS, kmax=192)
    b = dd.dense_block(Vs, Hs, xs, ws, eps=EPS, kmax=192)
    torch.cuda.synchronize()
    for got, again in zip(a, b):
        assert torch.equal(got, again)
