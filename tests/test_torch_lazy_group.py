"""Launch-block groups of the port's lazy-H engine (``ops/dopt_lazy.py``:
``dopt_fw_lazy(group=G)`` and ``dopt_fw_lazy_batch(group=G)``) against the
JAX package's multi-block dispatch (``dopt_fw_pallas_lazy(interpret=True,
group=G)`` and its batch engine, as tests/test_pallas_lazy.py runs them).

On the CPU the blocks run their plain version behind the kernel's
interface, with the same slots and the stop flag carried from block to
block.  Bars:

* the iteration count exactly;
* x at 1e-12 against JAX's exact FP64 engine (the port's lazy engine is
  FP64 throughout), and against the JAX lazy kernel no farther than JAX's
  exact engine is from that kernel, plus 1e-12 (the kernel carries
  double-single state, ~1e-11 from exact over a thousand iterations);
* F rtol 1e-9, SP and SN atol 1e-9 plus half a float32 ulp: the JAX lazy
  kernel's own bars (its slacks are float32 roundings);
* G=1, 2 and 4 of the port bit for bit (x, F, SP, SN), and one host read
  per group with no block enqueued past the budget;
* the lookahead on the blocks in flight: a stop inside a longer group is
  seen ``_LOOKAHEAD`` blocks late, as on the card, so ``_LOOKAHEAD - 1``
  frozen blocks follow it, the rest of the group is skipped, and the bits
  are ``group=1``'s.

The tests marked ``cuda`` hold the same on the card: a group of kernel
launches against ``group=1`` bit for bit, the frozen launches of a stop
inside a group (at most ``_LOOKAHEAD - 1`` of them under the default
group of 256 blocks), and the stop flag carried on the card.
"""

import numpy as np
import pytest
import torch

from accbpg_and_fw_tpu_torch.ops import dopt_common as dc
from accbpg_and_fw_tpu_torch.ops import dopt_lazy as dl

from test_torch_lazy import keep_jax_exec_cache  # noqa: F401 (autouse)

torch.set_num_threads(1)

EPS = 1e-8
SP_ATOL, F_RTOL, X_ATOL = 1e-9, 1e-9, 1e-12
F32_HALF_ULP = 2.0 ** -24
# 12x160 from seed 3 stops by eps at row 1068 (block 5 of 256 rows); a
# budget of 1060 ends in block 5 without a stop; under a budget of 100000
# the default group is 256 blocks
STOP_ROWS = 1069
BUDGETS = (1060, 1500)
BIG_BUDGET = 100000


@pytest.fixture(scope="module")
def design():
    V = np.random.default_rng(3).standard_normal((12, 160))
    return V, np.full(160, 1.0 / 160)


@pytest.fixture(scope="module")
def jax_runs(design):
    """The JAX lazy kernel (interpret mode) and exact engine, memoized."""
    import accbpg_and_fw_tpu as acc
    from accbpg_and_fw_tpu.ops.pallas_dopt_lazy import dopt_fw_pallas_lazy

    V, x0 = design
    cache = {}

    def lazy(budget, group):
        if ("lazy", budget, group) not in cache:
            cache["lazy", budget, group] = dopt_fw_pallas_lazy(
                V, x0, EPS, budget, verbose=False, interpret=True,
                group=group)
        return cache["lazy", budget, group]

    def exact(budget):
        if ("exact", budget) not in cache:
            cache["exact", budget] = acc.D_opt_FW_away(
                V, x0, EPS, budget, verbose=False, u_mode="exact",
                chunk=2000)
        return cache["exact", budget]

    return lazy, exact


class _Counts:
    """Counts the plain blocks' launches and host reads."""

    def __init__(self, monkeypatch):
        self.runs = self.reads = 0
        run, rows = dl._PlainBlocks.run, dl._PlainBlocks.host_rows

        def counted_run(obj, *a, **kw):
            self.runs += 1
            return run(obj, *a, **kw)

        def counted_rows(obj, *a, **kw):
            self.reads += 1
            return rows(obj, *a, **kw)

        monkeypatch.setattr(dl._PlainBlocks, "run", counted_run)
        monkeypatch.setattr(dl._PlainBlocks, "host_rows", counted_rows)


def _blocks(rows_or_budget):
    return -(-rows_or_budget // dl._KR)


def _assert_near_jax(out, ref, ref_exact):
    x, F, SP, SN, _ = out
    xj, Fj, SPj, SNj, _ = (np.asarray(a) for a in ref)
    xe = np.asarray(ref_exact[0])
    assert len(F) == len(Fj) == len(ref_exact[1])
    np.testing.assert_allclose(x.numpy(), xe, rtol=0, atol=X_ATOL)
    np.testing.assert_allclose(x.numpy(), xj, rtol=0,
                               atol=np.abs(xj - xe).max() + X_ATOL)
    np.testing.assert_allclose(F, Fj, rtol=F_RTOL)
    for a, b in ((SP, SPj), (SN, SNj)):
        np.testing.assert_allclose(a.astype(np.float32).astype(np.float64),
                                   b.astype(np.float64), rtol=F32_HALF_ULP,
                                   atol=SP_ATOL)


@pytest.mark.parametrize("budget", BUDGETS, ids=["budget", "stop-in-group"])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_group_matches_jax_lazy(design, jax_runs, monkeypatch, group, budget):
    """Budgets that cross group boundaries (5 blocks), one ending by the
    budget and one by eps inside a group (for G = 2 and 4 the group's next
    block enters stopped and leaves at once)."""
    V, x0 = design
    counts = _Counts(monkeypatch)
    out = dl.dopt_fw_lazy(V, x0, EPS, budget, verbose=False, device="cpu",
                          group=group)
    lazy, exact = jax_runs
    _assert_near_jax(out, lazy(budget, group), exact(budget))
    rows = len(out[1])
    assert rows == min(budget, STOP_ROWS)
    groups = -(-_blocks(rows) // group)
    assert counts.reads == groups
    assert counts.runs == min(groups * group, _blocks(budget))


@pytest.mark.parametrize("budget", BUDGETS + (BIG_BUDGET,),
                         ids=["budget", "stop-in-group", "stop-in-256"])
def test_groups_agree_bit_for_bit(design, budget):
    V, x0 = design
    runs = [dl.dopt_fw_lazy(V, x0, EPS, budget, verbose=False, device="cpu",
                            group=g) for g in (1, 2, 4, None)]
    for other in runs[1:]:
        assert torch.equal(other[0], runs[0][0])
        for a, b in zip(other[1:4], runs[0][1:4]):
            np.testing.assert_array_equal(a, b)
        assert len(other[4]) == len(runs[0][4])


def test_default_group_is_jax_rule():
    """JAX's rule (``pallas_dopt_lazy.py:763-:779``): the budget's blocks
    rounded up to a power of two of at least 8, at most 256, at most the
    refresh cadence's, at most 32 under a checkpoint; the batch at most
    32."""
    assert dl._group_size(20741, 0, False, 256) == 128
    assert dl._group_size(300, 0, False, 256) == 8
    assert dl._group_size(10 ** 6, 0, False, 256) == 256
    assert dl._group_size(20741, 4096, False, 256) == 16
    assert dl._group_size(20741, 0, True, 256) == 32
    assert dl._group_size(20000, 0, False, 32) == 32
    assert dl._group_size(20000, 4096, False, 32) == 16


def test_default_group_reads_once(design, monkeypatch):
    """Under the default group the whole budget is one group: one read."""
    V, x0 = design
    counts = _Counts(monkeypatch)
    dl.dopt_fw_lazy(V, x0, EPS, 1500, verbose=False, device="cpu")
    assert counts.reads == 1 and counts.runs == _blocks(1500)


@pytest.mark.parametrize("group", [4, 8, 16, None])
def test_stop_seen_lookahead_late(design, monkeypatch, group):
    """A stop flag that the host reads ``_LOOKAHEAD`` blocks late (after
    enqueuing block b, the flag after block b + 1 - ``_LOOKAHEAD``) leaves
    the blocks up to the stop and ``_LOOKAHEAD - 1`` frozen ones where the
    group holds them, the rest of the group skipped, one read a group,
    and the bits of ``group=1`` (the default group: 8 blocks enqueued of
    256, 3 frozen, 248 skipped)."""
    V, x0 = design
    ref = dl.dopt_fw_lazy(V, x0, EPS, BIG_BUDGET, verbose=False,
                          device="cpu", group=1)
    counts = _Counts(monkeypatch)
    frozen, skipped = dl.FROZEN_BLOCKS, dl.SKIPPED_BLOCKS
    out = dl.dopt_fw_lazy(V, x0, EPS, BIG_BUDGET, verbose=False,
                          device="cpu", group=group)
    assert torch.equal(out[0], ref[0])
    for a, b in zip(out[1:4], ref[1:4]):
        np.testing.assert_array_equal(a, b)
    G = 256 if group is None else group
    useful = _blocks(STOP_ROWS)
    # the stop's group: blocks from its first to the stop, then frozen
    first = (useful - 1) // G * G
    runs = first + min(G, useful - first + dl._LOOKAHEAD - 1)
    assert counts.runs == runs
    assert counts.reads == -(-useful // G)
    assert dl.FROZEN_BLOCKS - frozen == runs - useful
    assert dl.SKIPPED_BLOCKS - skipped == first + G - runs


def test_plain_blocks_see_the_stop_lookahead_late():
    """``seen_stop`` after each block of a group: a stop in the group's
    first block is seen after block ``_LOOKAHEAD`` - 1, not before."""
    V, x = _stopping_design()
    H0, w, _ = dc.factorize(V, x)
    blocks = dl._prepared(V, slots=dl._LOOKAHEAD + 1)
    seen = []
    for slot in range(dl._LOOKAHEAD + 1):
        blk = blocks.run(H0, x, w, eps=1e-3, kmax=dl._KR, away=True,
                         xtol=dc.XTOL, slot=slot)
        x, w = blk.x, blk.w
        seen.append(blocks.seen_stop(slot))
    assert seen == [False] * (dl._LOOKAHEAD - 1) + [True, True]


def test_refresh_at_group_boundaries(design, monkeypatch):
    """``refresh_every`` refactorizes at the first group boundary at or
    past every R iterations: R=300 with groups of 2 blocks refreshes after
    512 and 1024 rows."""
    V, x0 = design
    calls = []
    real = dl.factorize

    def spy(V_, x_):
        calls.append(1)
        return real(V_, x_)

    monkeypatch.setattr(dl, "factorize", spy)
    x, F, *_ = dl.dopt_fw_lazy(V, x0, EPS, 1500, verbose=False,
                               refresh_every=300, group=2, device="cpu")
    assert len(F) == STOP_ROWS and len(calls) == 3


def test_checkpoint_at_group_boundary_resumes(design, tmp_path):
    """A run cut at the end of its first group (512 rows) and resumed from
    its checkpoint gives, bit for bit, the uninterrupted run that
    refactorizes at that boundary (a resume refactorizes from the saved
    iterate; both then refactorize 512 rows later)."""
    V, x0 = design
    ck = str(tmp_path / "lazy.npz")
    first = dl.dopt_fw_lazy(V, x0, EPS, 512, verbose=False, checkpoint=ck,
                            group=2, device="cpu")
    with np.load(ck) as z:
        assert int(z["__k"]) == 512
    resumed = dl.dopt_fw_lazy(V, x0, EPS, 1500, verbose=False,
                              checkpoint=ck, refresh_every=512, group=2,
                              device="cpu")
    whole = dl.dopt_fw_lazy(V, x0, EPS, 1500, verbose=False,
                            refresh_every=512, group=2, device="cpu")
    assert len(resumed[1]) == STOP_ROWS
    np.testing.assert_array_equal(resumed[1][:512], first[1])
    assert torch.equal(resumed[0], whole[0])
    for a, b in zip(resumed[1:4], whole[1:4]):
        np.testing.assert_array_equal(a, b)


def test_jax_checkpoint_resumes_in_port(design, jax_runs, tmp_path):
    """A checkpoint the JAX lazy engine wrote at a group boundary resumes
    in the port: JAX's rows first, then the port's run from JAX's iterate
    (a fresh factorization there) to the same stop, at the bars above."""
    from accbpg_and_fw_tpu.ops.pallas_dopt_lazy import dopt_fw_pallas_lazy

    V, x0 = design
    ck = str(tmp_path / "jax_lazy.npz")
    jf = dopt_fw_pallas_lazy(V, x0, EPS, 512, verbose=False, interpret=True,
                             group=2, checkpoint=ck)
    resumed = dl.dopt_fw_lazy(V, x0, EPS, 1500, verbose=False,
                              checkpoint=ck, group=2, device="cpu")
    np.testing.assert_array_equal(resumed[1][:512], np.asarray(jf[1]))
    lazy, exact = jax_runs
    _assert_near_jax(resumed, lazy(1500, 2), exact(1500))


# ---- the batch engine -------------------------------------------------------

@pytest.fixture(scope="module")
def batch_design():
    """K=3 of 12x96: two random designs that stop by eps at rows 719 and
    616, and one frozen from the start (Q tiled, Q orthogonal: every column
    has leverage m at the uniform start, which is optimal)."""
    rng = np.random.default_rng(21)
    Vs = rng.standard_normal((3, 12, 96))
    Q, _ = np.linalg.qr(rng.standard_normal((12, 12)))
    Vs[2] = np.tile(Q, (1, 8))
    return Vs, np.full((3, 96), 1.0 / 96)


@pytest.fixture(scope="module")
def jax_batch(batch_design):
    from accbpg_and_fw_tpu.ops.pallas_dopt_lazy import (
        dopt_fw_pallas_lazy_batch,
    )

    Vs, x0s = batch_design
    cache = {}

    def run(group):
        if group not in cache:
            cache[group] = dopt_fw_pallas_lazy_batch(
                Vs, x0s, EPS, 1500, interpret=True, group=group)
        return cache[group]

    return run


@pytest.mark.parametrize("group", [1, 2, 4])
def test_batch_group_matches_jax(batch_design, jax_batch, monkeypatch,
                                 group):
    """The live instances against the JAX batch engine at the same group;
    the frozen one (out of parity, ROADMAP queue C: the JAX engine's rows
    for a converged start) holds its start's values and its iterate."""
    import accbpg_and_fw_tpu as acc

    Vs, x0s = batch_design
    counts = _Counts(monkeypatch)
    x, F, SP, SN = dl.dopt_fw_lazy_batch(Vs, x0s, EPS, 1500, device="cpu",
                                         group=group)
    xj, Fj, SPj, SNj = (np.asarray(a, np.float64) for a in jax_batch(group))
    assert F.shape == Fj.shape == (3, 719)
    for k in (0, 1):
        rows = int(np.argmax((SP[k] <= EPS) & (SN[k] <= EPS))) + 1
        np.testing.assert_allclose(F[k], Fj[k], rtol=F_RTOL,
                                   atol=F_RTOL * np.abs(Fj[k]).max())
        for a, b in ((SP[k], SPj[k]), (SN[k], SNj[k])):
            np.testing.assert_allclose(a, b, rtol=F32_HALF_ULP, atol=SP_ATOL)
        xe = np.asarray(acc.D_opt_FW_away(Vs[k], x0s[k], EPS, rows,
                                          verbose=False, u_mode="exact",
                                          chunk=2000)[0])
        np.testing.assert_allclose(x[k].numpy(), xe, rtol=0, atol=X_ATOL)
        np.testing.assert_allclose(x[k].numpy(), xj[k], rtol=0,
                                   atol=np.abs(xj[k] - xe).max() + X_ATOL)
    assert torch.equal(x[2], torch.as_tensor(x0s[2]))
    assert (SP[2] <= EPS).all() and (SN[2] <= EPS).all()
    assert (F[2] == F[2, 0]).all()
    groups = -(-_blocks(719) // group)
    assert counts.reads == groups
    assert counts.runs == min(groups * group, _blocks(1500))


def test_batch_groups_agree_bit_for_bit(batch_design):
    Vs, x0s = batch_design
    runs = [dl.dopt_fw_lazy_batch(Vs, x0s, EPS, 1500, device="cpu",
                                  group=g) for g in (1, 4, None)]
    for other in runs[1:]:
        assert torch.equal(other[0], runs[0][0])
        for a, b in zip(other[1:], runs[0][1:]):
            np.testing.assert_array_equal(a, b)


def test_masked_fold_skips_rows_past_nrun():
    """The fold masks the rows at and past ``nrun`` on the device: garbage
    there (NaN) leaves no trace, and ``nrun`` = 0 leaves H0 as it was."""
    rng = np.random.default_rng(2)
    H0 = torch.as_tensor(rng.standard_normal((5, 5)))
    C = torch.as_tensor(rng.standard_normal((dl._KR, 5)))
    beta = torch.as_tensor(rng.standard_normal(dl._KR))
    C[7:] = torch.nan
    beta[7:] = torch.nan
    got = dl._lazy_refresh(H0, C, beta, torch.tensor(1.5), torch.tensor(7.0))
    want = 1.5 * H0 + (C[:7].T * beta[:7]) @ C[:7]
    torch.testing.assert_close(got, want, rtol=1e-14, atol=1e-14)
    same = dl._lazy_refresh(H0, C, beta, torch.tensor(1.0),
                            torch.tensor(0.0))
    assert torch.equal(same, H0)
    Hs = torch.stack([H0, 2 * H0])
    out = dl._lazy_refresh_batch(Hs, torch.stack([C, C]),
                                 torch.stack([beta, beta]),
                                 torch.tensor([1.5, 1.0]),
                                 torch.tensor([7.0, 0.0]))
    torch.testing.assert_close(out[0], want, rtol=1e-14, atol=1e-14)
    assert torch.equal(out[1], 2 * H0)


def _stopping_design(device="cpu"):
    """8x64 from seed 11: stops by eps 1e-3 inside its first block."""
    V = torch.as_tensor(np.random.default_rng(11).standard_normal((8, 64)),
                        device=device)
    return V, torch.full((64,), 1.0 / 64, dtype=torch.float64, device=device)


def test_plain_blocks_carry_the_stop():
    """The plain version behind the kernel's interface: a block after a
    stop enters stopped, records no row and hands x and w through."""
    V, x = _stopping_design()
    H0, w, _ = dc.factorize(V, x)
    blocks = dl._prepared(V, slots=2)
    b0 = blocks.run(H0, x, w, eps=1e-3, kmax=dl._KR, away=True,
                    xtol=dc.XTOL, slot=0)
    assert float(b0.misc[0]) == 1.0
    b1 = blocks.run(H0, b0.x, b0.w, eps=1e-3, kmax=dl._KR, away=True,
                    xtol=dc.XTOL, slot=1)
    assert b1.misc.tolist() == [1.0, 0.0, 1.0, 0.0]
    assert torch.equal(b1.x, b0.x) and torch.equal(b1.w, b0.w)
    misc, hist = blocks.host_rows(2)
    assert misc.shape == (2, 4) and hist.shape == (2, 5, dl._KR)


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("budget", BUDGETS, ids=["budget", "stop-in-group"])
def test_groups_on_card_bit_for_bit(design, cuda_dev, budget):
    """Kernel launches in groups of 4 against one per round trip: x, F, SP
    and SN bit for bit; a stop inside a group leaves frozen launches."""
    V, x0 = design
    Vc = torch.as_tensor(V, device=cuda_dev)
    before = dl.LAUNCHES
    one = dl.dopt_fw_lazy(Vc, x0, EPS, budget, verbose=False, group=1)
    launches_one = dl.LAUNCHES - before
    four = dl.dopt_fw_lazy(Vc, x0, EPS, budget, verbose=False, group=4)
    launches_four = dl.LAUNCHES - before - launches_one
    assert torch.equal(one[0], four[0])
    for a, b in zip(one[1:4], four[1:4]):
        np.testing.assert_array_equal(a, b)
    assert launches_one == _blocks(len(one[1]))
    assert launches_four == min(-(-launches_one // 4) * 4, _blocks(budget))
    cpu = dl.dopt_fw_lazy(V, x0, EPS, budget, verbose=False, device="cpu")
    assert len(cpu[1]) == len(one[1])
    np.testing.assert_allclose(one[1], cpu[1], rtol=F_RTOL)


@pytest.mark.cuda
def test_stop_inside_default_group_on_card(design, cuda_dev):
    """A stop in block 5 of the default 256-block group on the card: the
    host reads the mirrored flag ``_LOOKAHEAD`` blocks late, so
    ``_LOOKAHEAD - 1`` frozen launches follow the stop and the rest of the
    group is skipped; x, F, SP and SN are ``group=1``'s bit for bit."""
    V, x0 = design
    Vc = torch.as_tensor(V, device=cuda_dev)
    one = dl.dopt_fw_lazy(Vc, x0, EPS, BIG_BUDGET, verbose=False, group=1)
    launches, frozen = dl.LAUNCHES, dl.FROZEN_BLOCKS
    skipped = dl.SKIPPED_BLOCKS
    whole = dl.dopt_fw_lazy(Vc, x0, EPS, BIG_BUDGET, verbose=False)
    assert len(whole[1]) == STOP_ROWS
    assert torch.equal(one[0], whole[0])
    for a, b in zip(one[1:4], whole[1:4]):
        np.testing.assert_array_equal(a, b)
    useful = _blocks(STOP_ROWS)
    assert dl.LAUNCHES - launches == useful + dl._LOOKAHEAD - 1
    assert dl.FROZEN_BLOCKS - frozen == dl._LOOKAHEAD - 1
    assert dl.SKIPPED_BLOCKS - skipped == 256 - useful - dl._LOOKAHEAD + 1


@pytest.mark.cuda
def test_batch_groups_on_card_bit_for_bit(batch_design, cuda_dev):
    Vs, x0s = batch_design
    Vc = torch.as_tensor(Vs, device=cuda_dev)
    one = dl.dopt_fw_lazy_batch(Vc, x0s, EPS, 1500, group=1)
    four = dl.dopt_fw_lazy_batch(Vc, x0s, EPS, 1500, group=4)
    assert torch.equal(one[0], four[0])
    for a, b in zip(one[1:], four[1:]):
        np.testing.assert_array_equal(a, b)
    assert one[1].shape == (3, 719)


@pytest.mark.cuda
def test_kernel_stop_flag_carries_on_card(cuda_dev):
    """A launch that stops sets the flag on the card; the next launch
    enters stopped, leaves x and w as they were and records no row."""
    V, x = _stopping_design(cuda_dev)
    H0, w, _ = dc.factorize(V, x)
    kernel = dl._LazyKernel(V.T.contiguous(), slots=2)
    b0 = kernel.run(H0, x, w, eps=1e-3, kmax=dl._KR, away=True,
                    xtol=dc.XTOL, slot=0)
    x0c, w0c = b0.x.clone(), b0.w.clone()
    b1 = kernel.run(H0, b0.x, b0.w, eps=1e-3, kmax=dl._KR, away=True,
                    xtol=dc.XTOL, slot=1)
    torch.cuda.synchronize()
    misc, _ = kernel.host_rows(2)
    assert misc[0, 0] == 1.0 and 0 < misc[0, 1] < dl._KR
    assert misc[1].tolist() == [1.0, 0.0, 1.0, 0.0]
    assert torch.equal(b1.x, x0c) and torch.equal(b1.w, w0c)
    assert int(kernel._done[0]) == 1
