"""The port's batched sweep path (``parallel/batched.py::dopt_fw_batch``)
against the JAX package, engine by engine, plus ``D_opt_KYinit``.

* The batched FP64 exact engine (``"native"``, ``"mixed"``, ``"ds"``)
  against JAX ``dopt_fw_batch(precision="native")`` in float64: x, F, SP
  and SN to atol 1e-12 (the two differ only in the order of BLAS sums).
* The lazy-H batch engine (``"pallas_lazy"``) against
  ``dopt_fw_pallas_lazy_batch(interpret=True)``: the same row counts, SP
  and SN atol 1e-9 plus half a float32 ulp (the JAX slacks are float32
  roundings of values within ~1e-12 of the port's), F rtol 1e-9 scaled
  by the run's largest |F| (the JAX tau pairs are double-single; the
  error accumulates along the run, so it is relative to the run's scale,
  not to an F row that crosses zero).  Its x is held against the JAX exact
  engine run per instance, at x atol 1e-11: the JAX kernel's own
  double-single x drifts ~1e-11 from exact over a few hundred iterations,
  the port's FP64 x does not.
* The dense batch engine (``"pallas"``) is held against its JAX kernel in
  tests/test_torch_dense.py; here only its route.

The tests marked ``cuda`` need a card: they hold the instance-partitioned
Hopper kernel against the plain version over one block (identical pivots;
x, w, C rtol 1e-11 scaled by each array's max-abs; tau, tau (w_v - 1), SP,
SN atol 1e-12) and skip without one.  JAX is imported inside fixtures, so
they run with ``python -m pytest --noconftest -m cuda
tests/test_torch_batch.py``.
"""

import numpy as np
import pytest
import torch

import accbpg_and_fw_tpu_torch as port
from accbpg_and_fw_tpu_torch.ops import dopt_dense as dd
from accbpg_and_fw_tpu_torch.ops import dopt_lazy as dl
from accbpg_and_fw_tpu_torch.ops.dopt_common import factorize
from accbpg_and_fw_tpu_torch.parallel import batched as pb

from test_torch_lazy import keep_jax_exec_cache  # noqa: F401 (autouse)

torch.set_num_threads(1)

EXACT_ATOL = 1e-12
SP_ATOL, X_ATOL, F_RTOL = 1e-9, 1e-11, 1e-9
F32_HALF_ULP = 2.0 ** -24
STATE_RTOL, HIST_ATOL = 1e-11, 1e-12


def _designs(K, m, n, seed):
    return (np.random.default_rng(seed).standard_normal((K, m, n)),
            np.full((K, n), 1.0 / n))


@pytest.fixture(scope="module")
def lazy_pair():
    Vs, x0s = _designs(2, 12, 160, seed=5)
    return Vs, x0s


@pytest.fixture(scope="module")
def jax_lazy_batch():
    """``dopt_fw_pallas_lazy_batch(interpret=True)``, memoized per call."""
    from accbpg_and_fw_tpu.ops.pallas_dopt_lazy import (
        dopt_fw_pallas_lazy_batch,
    )

    cache = {}

    def run(Vs, x0s, eps, num_iters, **kw):
        key = (Vs.tobytes(), eps, num_iters, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = dopt_fw_pallas_lazy_batch(
                Vs, x0s, eps, num_iters, interpret=True, **kw)
        return cache[key]

    return run


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")



def _assert_lazy_matches(got, ref, Vs, x0s, eps):
    import accbpg_and_fw_tpu as acc

    x, F, SP, SN = got
    xj, Fj, SPj, SNj = (np.asarray(a, np.float64) for a in ref)
    assert F.shape == Fj.shape
    for a, b in ((SP, SPj), (SN, SNj)):
        np.testing.assert_allclose(a, b, rtol=F32_HALF_ULP, atol=SP_ATOL)
    np.testing.assert_allclose(F, Fj, rtol=F_RTOL,
                               atol=F_RTOL * np.abs(Fj).max())
    for k in range(len(Vs)):
        rows = int(((SP[k] > eps) | (SN[k] > eps)).sum()) + 1
        xe, *_ = acc.D_opt_FW_away(Vs[k], x0s[k], eps, min(rows, F.shape[1]),
                                   verbose=False, chunk=1000)
        np.testing.assert_allclose(x[k].numpy(), np.asarray(xe), rtol=0,
                                   atol=X_ATOL)


# ---- the lazy-H batch engine -----------------------------------------------

@pytest.mark.parametrize("refresh", [0, 256], ids=["no-refresh", "refresh"])
def test_lazy_batch_matches_jax(lazy_pair, jax_lazy_batch, refresh):
    """Blocks of 256 over a 300 budget; with refresh_every=256 and one
    block per round (group=1) the w-only refresh runs after the first
    block, as in the JAX engine."""
    Vs, x0s = lazy_pair
    kw = dict(refresh_every=refresh, group=1) if refresh else {}
    before = dl.BATCH_LAUNCHES
    got = dl.dopt_fw_lazy_batch(Vs, x0s, 1e-8, 300, device="cpu", **kw)
    assert dl.BATCH_LAUNCHES == before  # CPU tensors take the plain block
    assert got[1].shape == (2, 300)
    _assert_lazy_matches(got, jax_lazy_batch(Vs, x0s, 1e-8, 300, **kw),
                         Vs, x0s, 1e-8)


def test_lazy_batch_refresh_cadence(lazy_pair, monkeypatch):
    """The JAX rule: blocks per round = min(next_pow2(ceil(600/256)), 32)
    = 8, capped at next_pow2(ceil(300/256)) = 8 (next_pow2 is never below
    8), so a 600 budget (3 blocks) ends inside the first round and never
    refreshes; with group=1 every round of one block refreshes."""
    Vs, x0s = lazy_pair
    calls = []
    real = dl._fresh_w

    def spy(H0s, Vs_):
        calls.append(1)
        return real(H0s, Vs_)

    monkeypatch.setattr(dl, "_fresh_w", spy)
    dl.dopt_fw_lazy_batch(Vs, x0s, 1e-8, 600, refresh_every=300, device="cpu")
    assert calls == []
    dl.dopt_fw_lazy_batch(Vs, x0s, 1e-8, 600, refresh_every=300, group=1,
                          device="cpu")
    # rounds end at 256, 512, 600: refreshes once 300 accumulated, after
    # 512; the last round ends the run
    assert len(calls) == 1


def test_lazy_batch_early_stop_in_one_instance(lazy_pair, jax_lazy_batch):
    Vs, x0s = lazy_pair
    got = dl.dopt_fw_lazy_batch(Vs, x0s, 1e-6, 1000, device="cpu")
    x, F, SP, SN = got
    stops = [int(np.argmax((SP[k] <= 1e-6) & (SN[k] <= 1e-6)))
             for k in range(2)]
    assert stops[0] < stops[1] == F.shape[1] - 1
    s = stops[0]
    assert (F[0, s:] == F[0, s]).all() and (SN[0, s:] == SN[0, s]).all()
    _assert_lazy_matches(got, jax_lazy_batch(Vs, x0s, 1e-6, 1000),
                         Vs, x0s, 1e-6)


def test_lazy_batch_of_one_is_the_single_engine(lazy_pair):
    Vs, x0s = lazy_pair
    xb, Fb, SPb, SNb = dl.dopt_fw_lazy_batch(Vs[:1], x0s[:1], 1e-6, 1000,
                                             device="cpu")
    x1, F1, SP1, SN1, _ = dl.dopt_fw_lazy(Vs[0], x0s[0], 1e-6, 1000,
                                          verbose=False, device="cpu")
    assert Fb.shape == (1, len(F1))
    np.testing.assert_array_equal(SPb[0], SP1)
    np.testing.assert_array_equal(SNb[0], SN1)
    np.testing.assert_allclose(Fb[0], F1, rtol=1e-13)
    np.testing.assert_allclose(xb[0].numpy(), x1.numpy(), rtol=0,
                               atol=1e-15)


def test_lazy_batch_converged_start_holds_its_initial_rows():
    """An instance already at eps at its start stops at row 0 and its rows
    repeat the start's values (a square V: the uniform x is optimal).  The
    zero-row case, which the JAX engine left as rows of zeros, is held by
    ``_pad_rows``: the initial iterate's value throughout."""
    rng = np.random.default_rng(7)
    Vs = np.stack([rng.standard_normal((6, 6)),
                   rng.standard_normal((6, 6))])
    Vs[1, :, :] = rng.standard_normal((6, 6)) * 3.0
    x0s = np.full((2, 6), 1.0 / 6)
    x0s[1] = rng.random(6) + 0.5
    x0s[1] /= x0s[1].sum()
    x, F, SP, SN = dl.dopt_fw_lazy_batch(Vs, x0s, 1e-8, 100, device="cpu")
    _, ld0 = np.linalg.slogdet((Vs[0] / 6.0) @ Vs[0].T)
    assert F.shape[1] > 1
    np.testing.assert_allclose(F[0], -ld0, rtol=1e-12)
    assert (SP[0] <= 1e-8).all() and (SN[0] <= 1e-8).all()
    assert torch.equal(x[0], torch.as_tensor(x0s[0]))
    np.testing.assert_array_equal(dl._pad_rows([], 4, -1.5), [-1.5] * 4)
    np.testing.assert_array_equal(
        dl._pad_rows([np.array([3.0, 2.0])], 4, -1.5), [3.0, 2.0, 2.0, 2.0])


def test_lazy_block_batch_on_cpu_is_the_plain_version(lazy_pair):
    Vs, x0s = lazy_pair
    V = torch.as_tensor(Vs)
    x = torch.as_tensor(x0s)
    parts = [factorize(V[k], x[k]) for k in range(2)]
    H0 = torch.stack([p[0] for p in parts])
    w = torch.stack([p[1] for p in parts])
    out = dl.lazy_block_batch(V, H0, x, w, eps=1e-8, kmax=[40, 0],
                              done=[False, False])
    one = dl.lazy_block_reference(V[0], H0[0], x[0], w[0], eps=1e-8,
                                  kmax=40)
    for a, b in zip(out, one):
        assert torch.equal(a[0], b)
    assert out.misc[1].tolist() == [0.0, 0.0, 1.0, 0.0]
    assert torch.equal(out.x[1], x[1]) and torch.equal(out.w[1], w[1])
    # the batched fold leaves the instance that ran nothing bit for bit
    H1 = dl._lazy_refresh_batch(H0, out.C, out.beta, out.misc[:, 2], [40, 0])
    assert torch.equal(H1[1], H0[1])
    torch.testing.assert_close(
        H1[0], dl._lazy_refresh(H0[0], out.C[0, :40], out.beta[0, :40],
                                out.misc[0, 2]), rtol=1e-14, atol=1e-14)
    with pytest.raises(ValueError, match="one entry per instance"):
        dl.lazy_block_batch(V, H0, x, w, eps=1e-8, kmax=[4])


def test_fresh_w_is_the_factorization_w(lazy_pair):
    Vs, x0s = lazy_pair
    V = torch.as_tensor(Vs)
    xr = torch.as_tensor(np.random.default_rng(2).random((2, 160)))
    parts = [factorize(V[k], xr[k]) for k in range(2)]
    H0 = torch.stack([p[0] for p in parts])
    w = torch.stack([p[1] for p in parts])
    torch.testing.assert_close(dl._fresh_w(H0, V), w, rtol=1e-12,
                               atol=1e-12)


# ---- the batched exact engine ----------------------------------------------

@pytest.fixture(scope="module")
def exact_problem():
    return _designs(3, 10, 120, seed=2)


@pytest.mark.parametrize("refresh", [0, 90], ids=["no-refresh", "refresh"])
@pytest.mark.parametrize("away", [True, False], ids=["away", "plain"])
def test_exact_engine_matches_jax_native(exact_problem, refresh, away):
    from accbpg_and_fw_tpu.parallel.batched import dopt_fw_batch as jax_batch

    Vs, x0s = exact_problem
    eps = 1e-3 if away else 1e-8  # away: one instance stops at row 231
    xj, Fj, SPj, SNj = jax_batch(Vs, x0s, eps, 250, away=away,
                                 refresh_every=refresh, precision="native")
    x, F, SP, SN = port.dopt_fw_batch(Vs, x0s, eps, 250, away=away,
                                      refresh_every=refresh, device="cpu")
    assert isinstance(x, torch.Tensor) and x.shape == (3, 120)
    assert F.shape == np.shape(Fj) == (3, 250)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0,
                               atol=EXACT_ATOL)
    for a, b in ((F, Fj), (SP, SPj), (SN, SNj)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=EXACT_ATOL)
    stopped = [bool(((SP[k] <= eps) & (SN[k] <= eps)).any())
               for k in range(3)]
    assert stopped == ([False, True, False] if away else [False] * 3)


def test_exact_engine_frozen_after_all_stop(exact_problem, monkeypatch):
    """Once every instance has stopped the engine takes no more steps, and
    the rows still run to the budget (refreshed at each boundary)."""
    Vs, x0s = exact_problem
    monkeypatch.setattr(pb, "_EXIT_EVERY", 64)
    a = pb.dopt_fw_batch_exact(Vs, x0s, 1e-2, 600, refresh_every=200,
                               device="cpu")
    monkeypatch.setattr(pb, "_EXIT_EVERY", 2048)
    b = pb.dopt_fw_batch_exact(Vs, x0s, 1e-2, 600, refresh_every=200,
                               device="cpu")
    assert a[1].shape == (3, 600)
    assert torch.equal(a[0], b[0])
    for i in (1, 2, 3):
        np.testing.assert_array_equal(a[i], b[i])


def test_exact_engine_zero_budget(exact_problem):
    Vs, x0s = exact_problem
    x, F, SP, SN = port.dopt_fw_batch(Vs, x0s, 1e-8, 0, device="cpu")
    assert F.shape == SP.shape == SN.shape == (3, 0)
    np.testing.assert_array_equal(x.numpy(), x0s)


# ---- routing ----------------------------------------------------------------

@pytest.mark.parametrize("precision", ["mixed", "ds", "auto"])
def test_precision_aliases_run_the_exact_engine(exact_problem, precision):
    Vs, x0s = exact_problem
    ref = port.dopt_fw_batch(Vs, x0s, 1e-6, 60, device="cpu")
    got = port.dopt_fw_batch(Vs, x0s, 1e-6, 60, precision=precision,
                             device="cpu")
    assert torch.equal(got[0], ref[0])
    for i in (1, 2, 3):
        np.testing.assert_array_equal(got[i], ref[i])


@pytest.mark.parametrize("precision,engine", [
    ("pallas", "dopt_fw_dense_batch"), ("pallas_lazy", "dopt_fw_lazy_batch")])
def test_kernel_precisions_route_to_their_engines(exact_problem, monkeypatch,
                                                  precision, engine):
    Vs, x0s = exact_problem
    seen = []
    real = getattr(pb, engine)

    def spy(*args, **kwargs):
        seen.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(pb, engine, spy)
    got = port.dopt_fw_batch(Vs, x0s, 1e-6, 60, refresh_every=30,
                             precision=precision, device="cpu")
    assert len(seen) == 1 and seen[0]["refresh_every"] == 30
    mod = dd if precision == "pallas" else dl
    want = getattr(mod, engine)(Vs, x0s, 1e-6, 60, refresh_every=30,
                                device="cpu")
    assert torch.equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("device,m,expected", [
    ("cuda", 64, "pallas_lazy"), ("cuda", 63, "native"),
    ("cpu", 1000, "native")])
def test_auto_batch_rule(device, m, expected):
    Vs = torch.empty((3, m, 500), dtype=torch.float64, device="meta")
    assert pb._resolve_auto_batch_precision(Vs, torch.device(device)) \
        == expected


def test_unknown_precision_raises(exact_problem):
    Vs, x0s = exact_problem
    with pytest.raises(ValueError, match="unknown precision"):
        port.dopt_fw_batch(Vs, x0s, 1e-6, 10, precision="f32", device="cpu")


# ---- D_opt_KYinit -----------------------------------------------------------

@pytest.mark.parametrize("shape", [(6, 40), (10, 15)], ids=["KY", "uniform"])
def test_kyinit_bit_for_bit(shape):
    import accbpg_and_fw_tpu as acc

    np.random.seed(4)
    V = np.random.randn(*shape)
    state = np.random.get_state()
    want = np.asarray(acc.D_opt_KYinit(V))
    np.random.set_state(state)
    got = port.D_opt_KYinit(V, device="cpu")
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    # both drew the same count of numbers from the global stream
    after_port = np.random.rand()
    np.random.set_state(state)
    acc.D_opt_KYinit(V)
    assert np.random.rand() == after_port


# ---- on the card ------------------------------------------------------------

def _fresh_batch(Vs, device):
    V = torch.as_tensor(Vs, dtype=torch.float64, device=device)
    K, m, n = V.shape
    x = torch.full((K, n), 1.0 / n, dtype=torch.float64, device=device)
    parts = [factorize(V[k], x[k]) for k in range(K)]
    return (V, torch.stack([p[0] for p in parts]), x,
            torch.stack([p[1] for p in parts]))


def _assert_lazy_blocks_agree(out, ref):
    misc, misc_ref = out.misc.cpu(), ref.misc.cpu()
    assert torch.equal(misc[:, [0, 1, 3]], misc_ref[:, [0, 1, 3]])
    for k in range(misc.shape[0]):
        iters, nrun = int(misc[k, 1]), int(misc[k, 3])
        h, h_ref = out.hist[k, :, :iters].cpu(), ref.hist[k, :, :iters].cpu()
        assert torch.equal(h[4], h_ref[4]), f"instance {k}: pivots differ"
        for got, want in ((out.x[k], ref.x[k]), (out.w[k], ref.w[k]),
                          (out.C[k, :nrun], ref.C[k, :nrun]),
                          (out.beta[k, :nrun], ref.beta[k, :nrun]),
                          (misc[k, 2:3], misc_ref[k, 2:3])):
            got, want = got.cpu(), want.cpu()
            scale = float(want.abs().max()) if want.numel() else 0.0
            torch.testing.assert_close(got, want, rtol=STATE_RTOL,
                                       atol=STATE_RTOL * scale)
        torch.testing.assert_close(h[:4], h_ref[:4], rtol=0, atol=HIST_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,eps,kmax,done", [
    ((3, 100, 1000), 1e-8, [256, 256, 256], None),
    ((3, 8, 64), 1e-3, [256, 100, 256], [False, False, True]),
    ((300, 12, 160), 1e-8, [64] * 300, None),      # more instances than CTAs
], ids=["3x100x1000", "stop-budget-done", "waves"])
def test_batch_kernel_matches_plain_version_on_card(cuda_dev, shape, eps,
                                                    kmax, done):
    V, H0, x, w = _fresh_batch(
        np.random.default_rng(11).standard_normal(shape), cuda_dev)
    ref = dl.lazy_block_batch_reference(V, H0, x, w, eps=eps, kmax=kmax,
                                        done=done)
    before = dl.BATCH_LAUNCHES
    out = dl.lazy_block_batch(V, H0, x, w, eps=eps, kmax=kmax, done=done)
    torch.cuda.synchronize()
    assert dl.BATCH_LAUNCHES > before
    _assert_lazy_blocks_agree(out, ref)


@pytest.mark.cuda
def test_batch_kernel_never_takes_the_plain_path(cuda_dev, monkeypatch):
    V, H0, x, w = _fresh_batch(
        np.random.default_rng(3).standard_normal((2, 12, 160)), cuda_dev)
    ref = dl.lazy_block_batch_reference(V, H0, x, w, eps=1e-8,
                                        kmax=[dl._KR] * 2)

    def plain_taken(*args, **kwargs):
        raise AssertionError("lazy_block_batch ran the plain version")

    monkeypatch.setattr(dl, "lazy_block_batch_reference", plain_taken)
    monkeypatch.setattr(dl, "lazy_block_reference", plain_taken)
    out = dl.lazy_block_batch(V, H0, x, w, eps=1e-8, kmax=[dl._KR] * 2)
    torch.cuda.synchronize()
    _assert_lazy_blocks_agree(out, ref)


@pytest.mark.cuda
def test_batch_of_one_kernel_is_the_single_kernel(cuda_dev):
    V, H0, x, w = _fresh_batch(
        np.random.default_rng(3).standard_normal((1, 30, 300)), cuda_dev)
    one = dl.lazy_block(V[0], H0[0], x[0], w[0], eps=1e-8, kmax=dl._KR)
    out = dl.lazy_block_batch(V, H0, x, w, eps=1e-8, kmax=[dl._KR])
    torch.cuda.synchronize()
    for a, b in zip(out, one):
        assert torch.equal(a[0], b)


@pytest.mark.cuda
def test_sweep_on_card_matches_cpu(cuda_dev, lazy_pair):
    Vs, x0s = lazy_pair
    got = port.dopt_fw_batch(Vs, x0s, 1e-6, 1000, precision="pallas_lazy",
                             device=cuda_dev)
    want = port.dopt_fw_batch(Vs, x0s, 1e-6, 1000, precision="pallas_lazy",
                              device="cpu")
    assert got[1].shape == want[1].shape
    np.testing.assert_allclose(got[1], want[1], rtol=1e-9)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               rtol=0, atol=X_ATOL)
