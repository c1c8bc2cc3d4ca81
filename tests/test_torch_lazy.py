"""The port's lazy-H block engine (``ops/dopt_lazy.py``) against the JAX
package.

On the CPU ``lazy_block`` runs its plain PyTorch version.  Bars:

* against the JAX lazy kernel run in interpret mode
  (``dopt_fw_pallas_lazy(..., interpret=True, group=1)``, as
  tests/test_pallas_lazy.py runs it): SP atol 1e-9 and x atol 1e-11, that
  kernel's own bars against the DS engine.  Its SP history is float32, so
  the port's float64 SP is compared after the same rounding;
* against the JAX exact f64 engine: F rtol 1e-9, x atol 1e-11.

The tests marked ``cuda`` need a card: they hold the Hopper kernel against
the plain version (x, w, C rtol 1e-11 scaled by each array's max-abs; SP,
SN, tau, tau (w_v - 1) atol 1e-12) and skip without one.  JAX is imported
inside fixtures so that, on a machine with a card and without JAX, the
card tests run with ``python -m pytest --noconftest -m cuda
tests/test_torch_lazy.py``.
"""

import sys

import numpy as np
import pytest
import torch

from accbpg_and_fw_tpu_torch import D_opt_FW_away
from accbpg_and_fw_tpu_torch.ops import dopt_lazy as dl
from accbpg_and_fw_tpu_torch.ops.dopt_common import factorize

torch.set_num_threads(1)

SP_ATOL, X_ATOL, F_RTOL = 1e-9, 1e-11, 1e-9
STATE_RTOL, HIST_ATOL = 1e-11, 1e-12


@pytest.fixture(scope="module", autouse=True)
def keep_jax_exec_cache():
    """Put the JAX drivers' bounded executable cache (64 entries) back as
    the module found it.  The JAX runs of the port's parity tests would
    otherwise fill it on a shared xdist worker, and a later test there that
    counts its entries (``test_checkpoint.py::test_executable_cache_reuse``)
    would see an eviction instead of a new entry.  Every port test file
    that runs JAX drivers imports this fixture.  JAX is never imported
    here, so the card tests run without it."""
    name = "accbpg_and_fw_tpu.algorithms.driver"
    before = sys.modules.get(name)
    saved = list(before._EXEC_CACHE.items()) if before else []
    yield
    driver = sys.modules.get(name)
    if driver is not None:
        driver._EXEC_CACHE.clear()
        driver._EXEC_CACHE.update(saved)


@pytest.fixture(scope="module")
def acc():
    import accbpg_and_fw_tpu

    return accbpg_and_fw_tpu


@pytest.fixture(scope="module")
def jax_lazy():
    from accbpg_and_fw_tpu.ops.pallas_dopt_lazy import dopt_fw_pallas_lazy

    return dopt_fw_pallas_lazy


@pytest.fixture(scope="module")
def problem():
    V = np.random.default_rng(3).standard_normal((12, 160))
    return V, np.full(160, 1.0 / 160)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _fresh(V, device="cpu"):
    V = torch.as_tensor(V, dtype=torch.float64, device=device)
    n = V.shape[1]
    x = torch.full((n,), 1.0 / n, dtype=torch.float64, device=device)
    H0, w, _ = factorize(V, x)
    return V, H0, x, w


def _assert_blocks_agree(out, ref):
    misc, misc_ref = out.misc.cpu(), ref.misc.cpu()
    assert misc[[0, 1, 3]].tolist() == misc_ref[[0, 1, 3]].tolist()
    iters, nrun = int(misc[1]), int(misc[3])
    h, h_ref = out.hist[:, :iters].cpu(), ref.hist[:, :iters].cpu()
    assert torch.equal(h[4], h_ref[4]), "pivot sequences differ"
    for got, want in ((out.x, ref.x), (out.w, ref.w),
                      (out.C[:nrun], ref.C[:nrun]),
                      (out.beta[:nrun], ref.beta[:nrun]),
                      (misc[2:3], misc_ref[2:3])):
        got, want = got.cpu(), want.cpu()
        scale = float(want.abs().max()) if want.numel() else 0.0
        torch.testing.assert_close(got, want, rtol=STATE_RTOL,
                                   atol=STATE_RTOL * scale)
    torch.testing.assert_close(h[:4], h_ref[:4], rtol=0, atol=HIST_ATOL)


def test_matches_jax_lazy_kernel_and_exact(problem, acc, jax_lazy):
    V, x0 = problem
    x, F, SP, SN, T = dl.dopt_fw_lazy(V, x0, 1e-8, 60, verbose=False,
                                      device="cpu")
    xl, Fl, SPl, SNl, _ = jax_lazy(V, x0, 1e-8, 60, verbose=False,
                                   interpret=True, group=1)
    assert len(F) == len(Fl) == 60
    np.testing.assert_allclose(SP.astype(np.float32).astype(np.float64),
                               np.asarray(SPl, np.float64), rtol=0,
                               atol=SP_ATOL)
    np.testing.assert_allclose(x.numpy(), np.asarray(xl), rtol=0,
                               atol=X_ATOL)
    xe, Fe, SPe, SNe, _ = acc.D_opt_FW_away(V, x0, 1e-8, 60, verbose=False,
                                            chunk=60)
    np.testing.assert_allclose(F, Fe, rtol=F_RTOL)
    np.testing.assert_allclose(x.numpy(), np.asarray(xe), rtol=0,
                               atol=X_ATOL)


def test_plain_fw_variant(problem, acc, jax_lazy):
    """away=False: the same row count as the JAX lazy kernel, and the exact
    engine's F and x (the JAX kernel's own double-single x sits ~1e-11
    from the exact engine here, the port ~1e-16)."""
    V, x0 = problem
    x, F, SP, SN, T = dl.dopt_fw_lazy(V, x0, 1e-8, 50, away=False,
                                      verbose=False, device="cpu")
    _, Fl, *_ = jax_lazy(V, x0, 1e-8, 50, away=False, verbose=False,
                         interpret=True, group=1)
    xe, Fe, SPe, SNe, _ = acc.D_opt_FW(V, x0, 1e-8, 50, verbose=False,
                                       chunk=50)
    assert len(F) == len(Fl) == len(Fe) == 50
    np.testing.assert_allclose(F, Fe, rtol=F_RTOL)
    np.testing.assert_allclose(SP, SPe, rtol=0, atol=SP_ATOL)
    np.testing.assert_allclose(SN, SNe, rtol=0, atol=SP_ATOL)
    np.testing.assert_allclose(x.numpy(), np.asarray(xe), rtol=0,
                               atol=X_ATOL)


def test_budget_exact_mid_block(problem):
    V, x0 = problem
    x, F, SP, SN, T = dl.dopt_fw_lazy(V, x0, 1e-8, 37, verbose=False,
                                      device="cpu")
    assert len(F) == len(SP) == len(SN) == len(T) == 37


@pytest.mark.parametrize("kr", [16, 32])
def test_multi_block_chain(problem, acc, monkeypatch, kr):
    """A budget of 70 over blocks of 16 or 32: folds between blocks keep
    the trajectory on the exact engine's."""
    V, x0 = problem
    monkeypatch.setattr(dl, "_KR", kr)
    launches = dl.LAUNCHES
    x, F, *_ = dl.dopt_fw_lazy(V, x0, 1e-8, 70, verbose=False, device="cpu")
    assert dl.LAUNCHES == launches  # CPU tensors never launch the kernel
    xe, Fe, *_ = acc.D_opt_FW_away(V, x0, 1e-8, 70, verbose=False, chunk=70)
    assert len(F) == len(Fe) == 70
    np.testing.assert_allclose(F, Fe, rtol=F_RTOL)
    np.testing.assert_allclose(x.numpy(), np.asarray(xe), rtol=0,
                               atol=X_ATOL)


def test_budget_above_one_block(acc):
    """300 iterations at the production block size: two blocks."""
    V = np.random.default_rng(4).standard_normal((10, 120))
    x0 = np.full(120, 1.0 / 120)
    x, F, *_ = dl.dopt_fw_lazy(V, x0, 1e-10, 300, verbose=False, device="cpu")
    xe, Fe, *_ = acc.D_opt_FW_away(V, x0, 1e-10, 300, verbose=False,
                                   chunk=300)
    assert len(F) == len(Fe)
    np.testing.assert_allclose(F, Fe, rtol=F_RTOL)
    np.testing.assert_allclose(x.numpy(), np.asarray(xe), rtol=0,
                               atol=X_ATOL)


def test_early_stop_truncation(acc):
    V = np.random.default_rng(11).standard_normal((8, 64))
    x0 = np.full(64, 1.0 / 64)
    eps = 1e-3
    x, F, SP, SN, T = dl.dopt_fw_lazy(V, x0, eps, 200, verbose=False,
                                      device="cpu")
    _, Fe, *_ = acc.D_opt_FW_away(V, x0, eps, 200, verbose=False)
    assert len(F) == len(Fe) < 200
    assert SP[-1] <= eps and SN[-1] <= eps
    assert not ((SP[:-1] <= eps) & (SN[:-1] <= eps)).any()
    xs = np.maximum(x.numpy(), 0.0)
    xs /= xs.sum()
    G = (V * xs) @ V.T
    w = np.einsum("ij,ij->j", V, np.linalg.solve(G, V))
    assert w.max() / V.shape[0] - 1.0 <= 2e-3


def test_away_drop_is_exact_zero(acc):
    """A boundary away step zeroes x_j exactly; the exact engine leaves a
    ~1e-17 residual at the same coordinates."""
    f, h, L, x0 = acc.D_opt_design(30, 300, randseed=10)
    V = np.asarray(f.H)
    x, F, *_ = dl.dopt_fw_lazy(V, np.asarray(x0), 1e-8, 256, verbose=False,
                               device="cpu")
    xe, Fe, *_ = acc.D_opt_FW_away(V, np.asarray(x0), 1e-8, 256,
                                   verbose=False)
    zeros = x.numpy() == 0.0
    assert zeros.sum() > 0
    np.testing.assert_array_equal(zeros, np.abs(np.asarray(xe)) < 1e-15)
    np.testing.assert_allclose(F, Fe, rtol=F_RTOL)


def test_refresh_every_rounds_up_to_blocks(problem, acc, monkeypatch):
    V, x0 = problem
    monkeypatch.setattr(dl, "_KR", 16)
    calls = []
    real = dl.factorize

    def spy(V_, x_):
        calls.append(1)
        return real(V_, x_)

    monkeypatch.setattr(dl, "factorize", spy)
    x, F, *_ = dl.dopt_fw_lazy(V, x0, 1e-8, 64, verbose=False,
                               refresh_every=20, device="cpu", group=1)
    # one block per round trip: blocks end at 16, 32, 48, 64, refreshes
    # after 32 and 64 (20 rounded up to a block boundary), plus the
    # initial factorization.  The default group (8 blocks, JAX's rule)
    # rounds up to group boundaries instead.
    assert len(calls) == 3
    xe, Fe, *_ = acc.D_opt_FW_away(V, x0, 1e-8, 64, verbose=False)
    np.testing.assert_allclose(F, Fe, rtol=F_RTOL)
    np.testing.assert_allclose(x.numpy(), np.asarray(xe), rtol=0,
                               atol=X_ATOL)


def test_checkpoint_resume(problem, tmp_path):
    V, x0 = problem
    ck = str(tmp_path / "lazy.npz")
    a = dl.dopt_fw_lazy(V, x0, 1e-8, 40, verbose=False, checkpoint=ck,
                        device="cpu")
    b = dl.dopt_fw_lazy(V, x0, 1e-8, 80, verbose=False, checkpoint=ck,
                        device="cpu")
    full = dl.dopt_fw_lazy(V, x0, 1e-8, 80, verbose=False, device="cpu")
    assert len(b[1]) == 80
    np.testing.assert_array_equal(b[2][:40], a[2])  # saved rows verbatim
    # resume = a refactorization at the interruption point
    np.testing.assert_allclose(b[1], full[1], rtol=F_RTOL)
    np.testing.assert_allclose(b[0].numpy(), full[0].numpy(), rtol=0,
                               atol=X_ATOL)


def test_verbose_rows(problem, capsys):
    V, x0 = problem
    dl.dopt_fw_lazy(V, x0, 1e-8, 10, verbose=True, verbskip=5, device="cpu")
    out = capsys.readouterr().out
    assert "lazy-H block kernel" in out
    rows = [ln for ln in out.splitlines() if ln[:6].strip().isdigit()]
    assert [int(r[:6]) for r in rows] == [0, 5]


def test_d_opt_entry_routes_pallas_lazy(problem):
    """u_mode="pallas_lazy" through the public entry point is this engine
    (the plain block on the CPU)."""
    V, x0 = problem
    a = D_opt_FW_away(V, x0, 1e-8, 45, verbose=False, u_mode="pallas_lazy",
                      device="cpu")
    b = dl.dopt_fw_lazy(V, x0, 1e-8, 45, verbose=False, device="cpu")
    assert torch.equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_lazy_block_on_cpu_is_the_plain_version(problem):
    V, H0, x, w = _fresh(problem[0])
    before = dl.LAUNCHES
    out = dl.lazy_block(V, H0, x, w, eps=1e-8, kmax=40)
    ref = dl.lazy_block_reference(V, H0, x, w, eps=1e-8, kmax=40)
    assert dl.LAUNCHES == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert out.misc.tolist()[1] == 40 and out.misc.tolist()[3] == 40
    # the lazy factor reproduces a fresh factorization of the new iterate
    Hb = out.misc[2] * H0 + (out.C[:40].T * out.beta[:40]) @ out.C[:40]
    H_new, w_new, _ = factorize(V, out.x)
    torch.testing.assert_close(Hb, H_new, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(out.w, w_new, rtol=1e-10, atol=0)


def test_lazy_block_done_input_runs_nothing(problem):
    V, H0, x, w = _fresh(problem[0])
    out = dl.lazy_block(V, H0, x, w, eps=1e-8, kmax=10, done=True)
    assert out.misc.tolist()[:2] == [1.0, 0.0] and out.misc.tolist()[3] == 0
    assert torch.equal(out.x, x) and torch.equal(out.w, w)


def test_lazy_block_rejects_bad_arguments(problem):
    V, H0, x, w = _fresh(problem[0])
    with pytest.raises(TypeError, match="float64"):
        dl.lazy_block(V.float(), H0, x, w, eps=1e-8, kmax=4)
    with pytest.raises(ValueError, match="contiguous"):
        dl.lazy_block(V, H0.T, x, w, eps=1e-8, kmax=4)
    with pytest.raises(ValueError, match="shape"):
        dl.lazy_block(V, H0, x[:-1], w, eps=1e-8, kmax=4)
    with pytest.raises(ValueError, match="kmax"):
        dl.lazy_block(V, H0, x, w, eps=1e-8, kmax=dl._KR + 1)


SMS, SMEM_LIMIT = 132, 232448  # one H100: SMs, opt-in shared memory per CTA


@pytest.mark.parametrize("m,n,K", [
    (12, 160, 1),
    (1000, 5000, 1),       # the main path
    (1000, 2000, 3),       # the large-m sweep
    (1000, 50, 1),         # fewer columns than CTAs
    (dl._MAX_M, 20000, 1),  # the largest m: no column fits beside g
    (100, 1000, 200),      # more instances than SMs: waves of one CTA each
    (77, 1234, 5),         # ragged everywhere
], ids=["12x160", "1000x5000", "K3-1000x2000", "n<CTAs", "max-m", "K>SMs",
        "ragged"])
def test_launch_plan_covers_the_design(m, n, K):
    """The kernel's launch plan: every column of V and every row of H0
    owned by exactly one CTA of the group, the rows' segments covering m,
    the shared memory within the card's limit, and at least one CTA per
    instance."""
    plan = dl.launch_plan(m, n, dl._KR, K, SMS, SMEM_LIMIT)
    G = plan.group
    assert G >= 1 and 1 <= plan.wave <= min(K, SMS)
    assert G * plan.wave <= SMS            # one persistent CTA per SM
    assert plan.waves * plan.wave >= K > (plan.waves - 1) * plan.wave
    cols = [j for b in range(G) for j in plan.cols(b)]
    rows = [i for b in range(G) for i in plan.rows(b)]
    assert cols == list(range(n)) and rows == list(range(m))
    sizes = [len(plan.cols(b)) for b in range(G)]
    assert max(sizes) - min(sizes) <= 1
    assert plan.seg_len % 32 == 0 and plan.segs * plan.seg_len >= m
    assert (plan.segs - 1) * plan.seg_len < m or plan.segs == 1
    # shared memory: one length-m vector, the segment sums, H0 v and beta of
    # the CTA's rows, then the resident columns with their w and x
    own_rows = plan.row_base + 1 + -(-dl._KR // G)
    fixed = 8 * (m + own_rows * plan.segs + own_rows)
    assert plan.smem_bytes == fixed + 8 * plan.resident * (m + 2)
    assert plan.smem_bytes + dl._STATIC_SMEM <= SMEM_LIMIT
    assert 0 <= plan.resident <= max(sizes)
    # no room is left unused while a column still streams
    if plan.resident < max(sizes):
        assert plan.smem_bytes + 8 * (m + 2) + dl._STATIC_SMEM > SMEM_LIMIT
    assert plan.dwords >= m + dl._KR + 3 * G
    assert plan.iwords % 32 == 0 and plan.iwords >= 32 + 2 * G


def test_launch_plan_known_splits():
    """The splits at the shapes the card runs: 27 of a CTA's 37-38 columns
    resident at 1000x5000, none at the largest m, groups of 44 CTAs for
    three instances, and one CTA per instance in two waves for 200."""
    main = dl.launch_plan(1000, 5000, 256, 1, SMS, SMEM_LIMIT)
    assert (main.group, main.wave, main.waves) == (132, 1, 1)
    assert (main.col_base, main.col_extra) == (37, 116)
    assert (main.row_base, main.row_extra, main.segs) == (7, 76, 2)
    assert main.resident == 27
    assert dl.launch_plan(dl._MAX_M, 20000, 256, 1, SMS,
                          SMEM_LIMIT).resident == 0
    sweep = dl.launch_plan(1000, 2000, 256, 3, SMS, SMEM_LIMIT)
    assert (sweep.group, sweep.wave, sweep.waves) == (44, 3, 1)
    many = dl.launch_plan(100, 1000, 256, 200, SMS, SMEM_LIMIT)
    assert (many.group, many.wave, many.waves) == (1, 132, 2)
    assert many.resident == 274  # of 1000: what 227 KB holds at m = 100


def test_launch_plan_rejects_what_cannot_run():
    with pytest.raises(ValueError, match="positive"):
        dl.launch_plan(0, 10, 256, 1, SMS, SMEM_LIMIT)
    with pytest.raises(ValueError, match="shared memory"):
        dl.launch_plan(1000, 5000, 256, 1, SMS, 8000)


@pytest.mark.cuda
def test_lazy_block_on_cuda_never_takes_the_plain_path(problem, cuda_dev,
                                                       monkeypatch):
    V, H0, x, w = _fresh(problem[0], cuda_dev)
    ref = dl.lazy_block_reference(V, H0, x, w, eps=1e-8, kmax=dl._KR)

    def plain_taken(*args, **kwargs):
        raise AssertionError("lazy_block ran the plain version on CUDA")

    monkeypatch.setattr(dl, "lazy_block_reference", plain_taken)
    before = dl.LAUNCHES
    out = dl.lazy_block(V, H0, x, w, eps=1e-8, kmax=dl._KR)
    torch.cuda.synchronize()
    assert dl.LAUNCHES == before + 1
    _assert_blocks_agree(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,eps,away", [
    ((30, 300), 1e-8, True),
    ((30, 300), 1e-8, False),
    ((77, 1234), 1e-8, True),      # ragged panels of columns and rows
    ((8, 64), 1e-3, True),         # stops inside the block
    ((120, 133), 1e-8, True),      # one or two columns per CTA
    ((600, 1300), 1e-8, True),     # every column resident, 3 row segments
    ((2049, 4200), 1e-8, True),    # 13 of 32 columns resident, long rows
    ((5, 5000), 1e-8, False),      # m below a warp, fewer rows than CTAs
], ids=["30x300", "30x300-plain", "77x1234", "stop-in-block", "120x133",
        "600x1300", "2049x4200", "5x5000-plain"])
def test_kernel_matches_plain_version_on_card(cuda_dev, shape, eps, away):
    V, H0, x, w = _fresh(np.random.default_rng(11).standard_normal(shape),
                         cuda_dev)
    ref = dl.lazy_block_reference(V, H0, x, w, eps=eps, kmax=dl._KR,
                                  away=away)
    out = dl.lazy_block(V, H0, x, w, eps=eps, kmax=dl._KR, away=away)
    torch.cuda.synchronize()
    _assert_blocks_agree(out, ref)
    if eps == 1e-3:
        assert out.misc[0].item() == 1.0 and out.misc[1] < dl._KR


@pytest.mark.cuda
def test_prepared_kernel_chains_blocks_on_card(cuda_dev):
    """A kernel prepared once, as the drivers use it: the second block
    starts from the first's x and w (its own output buffers), and a block
    of no iterations hands its state through."""
    V, H0, x, w = _fresh(np.random.default_rng(5).standard_normal((64, 2000)),
                         cuda_dev)
    run = dict(eps=1e-8, done=False, away=True, xtol=dl.XTOL)
    kernel = dl._LazyKernel(V.T.contiguous())
    b1 = kernel.run(H0, x, w, kmax=dl._KR, **run)
    H1 = dl._lazy_refresh(H0, b1.C, b1.beta, b1.misc[2])
    r1 = dl.lazy_block_reference(V, H0, x, w, eps=1e-8, kmax=dl._KR)
    Hr = dl._lazy_refresh(H0, r1.C, r1.beta, r1.misc[2])
    b2 = kernel.run(H1, b1.x, b1.w, kmax=100, **run)
    r2 = dl.lazy_block_reference(V, Hr, r1.x, r1.w, eps=1e-8, kmax=100)
    torch.cuda.synchronize()
    _assert_blocks_agree(b2, r2)
    x2, w2 = b2.x.clone(), b2.w.clone()
    b3 = kernel.run(H1, b2.x, b2.w, kmax=0, **run)
    torch.cuda.synchronize()
    assert b3.misc.cpu().tolist() == [0.0, 0.0, 1.0, 0.0]
    assert torch.equal(b3.x, x2) and torch.equal(b3.w, w2)


@pytest.mark.cuda
def test_kernels_of_two_designs_interleave_on_card(cuda_dev):
    """Preparing a kernel for a small design does not take the shared
    memory of one prepared earlier for a large design."""
    rng = np.random.default_rng(7)
    big = _fresh(rng.standard_normal((1000, 3000)), cuda_dev)
    small = _fresh(rng.standard_normal((12, 160)), cuda_dev)
    run = dict(eps=1e-8, kmax=40, done=False, away=True, xtol=dl.XTOL)
    kernels = [dl._LazyKernel(s[0].T.contiguous()) for s in (big, small)]
    assert kernels[0].plan.smem_bytes > kernels[1].plan.smem_bytes
    for kernel, (V, H0, x, w) in zip(kernels, (big, small)):
        out = kernel.run(H0, x, w, **run)
        torch.cuda.synchronize()
        _assert_blocks_agree(out, dl.lazy_block_reference(
            V, H0, x, w, eps=1e-8, kmax=40))


@pytest.mark.cuda
def test_kernel_done_input_runs_nothing_on_card(problem, cuda_dev):
    V, H0, x, w = _fresh(problem[0], cuda_dev)
    out = dl.lazy_block(V, H0, x, w, eps=1e-8, kmax=10, done=True)
    torch.cuda.synchronize()
    assert out.misc.cpu().tolist() == [1.0, 0.0, 1.0, 0.0]
    assert torch.equal(out.x, x) and torch.equal(out.w, w)


@pytest.mark.cuda
def test_exact_engine_on_card_matches_cpu(problem, cuda_dev):
    V, x0 = problem
    x, F, SP, SN, T = D_opt_FW_away(V, x0, 1e-8, 200, verbose=False,
                                    u_mode="exact", device=cuda_dev)
    xc, Fc, SPc, SNc, _ = D_opt_FW_away(V, x0, 1e-8, 200, verbose=False,
                                        u_mode="exact", device="cpu")
    assert x.device.type == "cuda" and len(F) == len(Fc)
    np.testing.assert_allclose(F, Fc, rtol=0, atol=1e-12)
    np.testing.assert_allclose(SP, SPc, rtol=0, atol=1e-12)
    np.testing.assert_allclose(x.cpu().numpy(), xc.numpy(), rtol=0,
                               atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("eps,budget", [(1e-8, 200), (1e-3, 400)],
                         ids=["budget", "early-stop"])
def test_engine_on_card_matches_cpu(problem, cuda_dev, monkeypatch, eps,
                                    budget):
    """Multi-block solve through the kernel against the CPU plain path."""
    V, x0 = problem
    monkeypatch.setattr(dl, "_KR", 32)
    before = dl.LAUNCHES
    x, F, SP, SN, T = dl.dopt_fw_lazy(V, x0, eps, budget, verbose=False,
                                      device=cuda_dev, group=1)
    assert dl.LAUNCHES - before == -(-len(F) // 32)
    xc, Fc, *_ = dl.dopt_fw_lazy(V, x0, eps, budget, verbose=False,
                                 device="cpu")
    assert len(F) == len(Fc)
    if eps == 1e-3:
        assert len(F) < budget and SP[-1] <= eps and SN[-1] <= eps
    np.testing.assert_allclose(F, Fc, rtol=F_RTOL)
    np.testing.assert_allclose(x.cpu().numpy(), xc.numpy(), rtol=0,
                               atol=X_ATOL)
