"""The nuclear-norm ball's vertex in one kernel: the top singular pair of
a matrix, ``outer(u1, v1)``.

``top_singular_pair(g)`` returns ``s = outer(u1, v1)`` for the largest
singular value of the m x n float64 matrix g, what JAX's
``lmo_nuclear_norm_ball`` (``accbpg_and_fw_tpu/ops/lmo.py:16-25``) takes
from ``jnp.linalg.svd`` inside its compiled chunk.  No TPU kernel: the
port needs one because no library call on the card computes a top
singular pair inside a CUDA graph (cuSOLVER's SVD checks its ``info`` on
the host, and a capture refuses it).

The algorithm is one-sided (Hestenes) Jacobi on the p x k matrix A, A = g
(or g^T where m < n; p = max(m, n), k = min(m, n)), V = I (k x k):

* a sweep visits every pair of columns (i < j) once, in rounds of a
  round-robin tournament (``rounds``): the k/2 pairs of a round touch
  distinct columns, so they rotate at once.  A pair with
  |<a_i, a_j>| > tol ||a_i|| ||a_j|| (``tolerance``), neither column
  negligible (``negligible``), is rotated to orthogonality, A and V
  alike: zeta = (||a_j||^2 - ||a_i||^2) /
  (2 <a_i, a_j>), t = sign(zeta) / (|zeta| + hypot(1, zeta)),
  c = 1 / sqrt(1 + t^2), s = c t, a_i <- c a_i - s a_j, a_j <- s a_i +
  c a_j;
* the sweeps end after one that rotated no pair, or after
  ``MAX_SWEEPS`` (a solve that ends there is counted on the card);
* then A = U diag(sigma) and g V = A (or g^T V = A): the top index is the
  largest column norm, the first on ties; sigma_1 its norm, u1 =
  a_top / sigma_1, v1 = V[:, top].  ``outer(u1, v1)`` (``outer(v1, u1)``
  where A = g^T) does not depend on the rotations' signs.  sigma_1 = 0
  gives ``outer(e1, e1)``, what JAX's SVD of a zero matrix gives.

It works on g itself, not on g^T g, so its accuracy is an SVD's.

On a CUDA tensor ``top_singular_pair`` launches the Hopper kernel
``csrc/top_singular.cu`` (a warp a pair: one CTA with A and V in shared
memory where ``svd_plan`` fits them, else a cooperative grid of CTAs over
a global scratch) and counts the launch in ``LAUNCHES`` on the host and,
from inside the kernel, on the card (``device_stats``: the launches, the
solves that reached ``MAX_SWEEPS`` and the most sweeps a solve took; a
graph's replays count there).  On a CPU tensor it runs
``top_singular_pair_reference``, the plain version, which repeats the
algorithm in torch operations.  Any other device raises, and a failed
build or launch raises: nothing falls back to the plain version or to
``torch.linalg.svd`` on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

# The sweeps a solve may take.  One-sided Jacobi converges quadratically
# once the columns are nearly orthogonal: 6-10 sweeps at the shapes of the
# tests and of chip_smoke.py's phase 3.
MAX_SWEEPS = 40

# Kernel launches made by ``top_singular_pair`` on a CUDA tensor (never by
# the plain version), counted on the host when the wrapper runs (under a
# capture, once per captured launch) ...
LAUNCHES = 0
# ... and on the card: per device an int64 triple that the kernel updates,
# (launches, solves that reached MAX_SWEEPS, the most sweeps of a solve).
_DEVICE_STATS: dict = {}

_WARPS = 32          # at most a resident CTA's warps, one a pair
_GRID_WARPS = 4      # a streamed CTA's warps
_STATIC_SMEM = 1024  # room left for the kernel's static shared memory


def tolerance(p):
    """The rotation threshold for columns of length ``p``: a pair counts as
    orthogonal once |<a_i, a_j>| <= tol ||a_i|| ||a_j||, with tol =
    sqrt(p) eps (LAPACK's one-sided Jacobi, ``dgesvj``, takes the same)."""
    return max(p, 1) ** 0.5 * torch.finfo(torch.float64).eps


def negligible(g):
    """The squared column norm at or below which a column counts as zero:
    eps^2 ||g||_F^2.  Such a column is rounding noise of the others; its
    angle to them is noise too, and rotating it against them (the columns
    a rank-deficient g leaves) never settles: a rank-1 7x5 took the whole
    sweep bound without this rule."""
    return torch.finfo(torch.float64).eps ** 2 * (g * g).sum()


def rounds(k):
    """The pairs ``(i, j)``, i < j < k, of each round of a sweep: the
    round-robin tournament of kk = k rounded up to even players, the last
    one fixed, the others turning one seat a round; a pair with the extra
    player of an odd k is left out.  kk - 1 rounds of kk / 2 pairs cover
    every pair once."""
    kk = k + (k % 2)
    out = []
    for r in range(kk - 1):
        pairs = []
        for q in range(kk // 2):
            if q == 0:
                a, b = kk - 1, r
            else:
                a, b = (r + q) % (kk - 1), (r - q) % (kk - 1)
            i, j = min(a, b), max(a, b)
            if j < k:
                pairs.append((i, j))
        out.append(pairs)
    return out


class SvdPlan(NamedTuple):
    """How one solve is laid out (see ``svd_plan``)."""
    m: int
    n: int
    p: int            # the rows of A
    k: int            # the columns of A
    transposed: bool  # A = g^T (m < n)
    layout: str       # "resident": A, V and the norms in one CTA's shared
    #                   memory; "streamed": in a global scratch, over a
    #                   cooperative grid
    warps: int        # warps of a CTA, one a pair of a round
    ctas: int         # CTAs (1 where resident)
    work_bytes: int   # the bytes of A, V and the column norms (and, where
    #                   streamed, a partial sum a CTA and two flags)


def svd_plan(m, n, smem_limit, sms=None):
    """The layout of one solve of an m x n matrix on a card whose CTAs may
    take ``smem_limit`` bytes of shared memory and which has ``sms``
    multiprocessors (None: no cap).  Resident where A (p x k), V (k x k)
    and the k column norms fit in shared memory beside the kernel's
    static shared memory: one CTA, a warp for each pair of a round, at
    most ``_WARPS``.  Else streamed: the same in a global scratch, and a
    warp for each pair over CTAs of ``_GRID_WARPS`` warps, at most one a
    multiprocessor (a round's barrier is grid-wide, so every CTA must be
    on the card at once)."""
    if m < 1 or n < 1:
        raise ValueError(f"svd_plan needs a nonempty matrix, got {m}x{n}")
    p, k = max(m, n), min(m, n)
    pairs = max(1, (k + 1) // 2)
    work = 8 * (p * k + k * k + k)
    if work <= smem_limit - _STATIC_SMEM:
        return SvdPlan(m, n, p, k, m < n, "resident", min(_WARPS, pairs), 1,
                       work)
    warps = min(_GRID_WARPS, pairs)
    ctas = -(-pairs // warps)
    if sms is not None:
        ctas = min(ctas, sms)
    return SvdPlan(m, n, p, k, m < n, "streamed", warps, ctas,
                   work + 8 * (ctas + 2))


def _jacobi_reference(g):
    """The plain version's sweeps: ``(A, V, sweeps)``."""
    m, n = g.shape
    A = (g if m >= n else g.T).clone()
    p, k = A.shape
    V = torch.eye(k, dtype=g.dtype, device=g.device)
    tol, small = tolerance(p), negligible(g)
    schedule = [(torch.tensor([i for i, _ in r], device=g.device),
                 torch.tensor([j for _, j in r], device=g.device))
                for r in rounds(k) if r]
    sweeps = 0
    while sweeps < MAX_SWEEPS:
        sweeps += 1
        rotated = torch.zeros((), dtype=torch.bool, device=g.device)
        for I, J in schedule:
            ai, aj = A[:, I], A[:, J]
            alpha, beta = (ai * ai).sum(0), (aj * aj).sum(0)
            gamma = (ai * aj).sum(0)
            rot = ((alpha > small) & (beta > small)
                   & (gamma.abs() > tol * torch.sqrt(alpha)
                      * torch.sqrt(beta)))
            zeta = (beta - alpha) / torch.where(rot, 2.0 * gamma, 1.0)
            t = (torch.copysign(torch.ones_like(zeta), zeta)
                 / (zeta.abs() + torch.hypot(torch.ones_like(zeta), zeta)))
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = c * t
            for M in (A, V):
                mi, mj = M[:, I], M[:, J]
                M[:, I] = torch.where(rot, c * mi - s * mj, mi)
                M[:, J] = torch.where(rot, s * mi + c * mj, mj)
            rotated = rotated | rot.any()
        if not bool(rotated):
            break
    return A, V, sweeps


def _vertex(g, A, V):
    """``outer(u1, v1)`` from the rotated columns A and their rotations V
    (``outer(e1, e1)`` where sigma_1 = 0)."""
    m, n = g.shape
    norms = torch.sqrt((A * A).sum(0))
    top = torch.argmax(norms)  # the first index of the largest
    sigma = norms[top]
    if not bool(sigma > 0):
        s = torch.zeros_like(g)
        s[0, 0] = 1.0
        return s
    u, v = A[:, top] / sigma, V[:, top]
    return torch.outer(u, v) if m >= n else torch.outer(v, u)


def top_singular_pair_reference(g):
    """The plain version: the same sweeps in torch operations, a host read
    of the "rotated" flag after each sweep (``_jacobi_reference`` gives
    their count)."""
    _check(g)
    A, V, _ = _jacobi_reference(g)
    return _vertex(g, A, V)


def _check(g):
    if not (isinstance(g, torch.Tensor) and g.dim() == 2
            and g.dtype == torch.float64 and g.numel()):
        raise ValueError("top_singular_pair takes a nonempty float64 "
                         "matrix")


def top_singular_pair(g):
    """``outer(u1, v1)`` of g's top singular pair: the kernel on CUDA, the
    plain version on the CPU (see the module docstring)."""
    _check(g)
    if g.device.type == "cpu":
        return top_singular_pair_reference(g)
    if g.device.type != "cuda":
        raise ValueError(f"top_singular_pair runs on cpu or cuda, not "
                         f"{g.device}")
    global LAUNCHES
    s, _ = _launch_cuda(g)
    LAUNCHES += 1
    return s


# ---- the kernel -------------------------------------------------------------


class _Kernel(NamedTuple):
    run: object
    smem_limit: object
    error_string: object


@functools.lru_cache(maxsize=None)
def _kernel_lib():
    from . import _build

    lib = _build.load("top_singular")
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.top_singular_run.argtypes = [p, i, i, i, i, i, ctypes.c_longlong, d,
                                     i, p, p, p, p, i, p]
    lib.top_singular_run.restype = i
    lib.top_singular_smem_limit.argtypes = [i, ctypes.POINTER(i)]
    lib.top_singular_smem_limit.restype = i
    lib.top_singular_error_string.argtypes = [i]
    lib.top_singular_error_string.restype = ctypes.c_char_p
    return _Kernel(lib.top_singular_run, lib.top_singular_smem_limit,
                   lib.top_singular_error_string)


def _check_err(err, what):
    if err:
        raise RuntimeError(f"top_singular {what} failed: "
                           + _kernel_lib().error_string(err).decode())


def _index(device_index):
    """A CUDA device's index, the current device's for None (the index of
    ``torch.device("cuda")``)."""
    return (torch.cuda.current_device() if device_index is None
            else int(device_index))


@functools.lru_cache(maxsize=None)
def _smem_limit(device_index):
    out = ctypes.c_int()
    _check_err(_kernel_lib().smem_limit(device_index, ctypes.byref(out)),
               "set-up")
    return out.value


def smem_limit(device_index=None):
    """The shared bytes a CTA may take on CUDA device ``device_index``."""
    return _smem_limit(_index(device_index))


@functools.lru_cache(maxsize=None)
def _sms(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def device_plan(m, n, device_index=None):
    """``svd_plan`` on CUDA device ``device_index``."""
    index = _index(device_index)
    return svd_plan(m, n, smem_limit(index), _sms(index))


def _stats(device):
    stats = _DEVICE_STATS.get(device.index)
    if stats is None:
        stats = torch.zeros(3, dtype=torch.int64, device=device)
        _DEVICE_STATS[device.index] = stats
    return stats


def device_stats():
    """``(launches, solves at MAX_SWEEPS, most sweeps)`` the cards counted
    since the last reset (one read)."""
    got = [s.tolist() for s in _DEVICE_STATS.values()]
    return (sum(s[0] for s in got), sum(s[1] for s in got),
            max((s[2] for s in got), default=0))


def reset_device_stats():
    for s in _DEVICE_STATS.values():
        s.zero_()


def _launch_cuda(g, plan=None):
    """One launch on ``g``'s device; ``plan``: a layout in place of
    ``device_plan``'s (``svd_plan`` with another limit, to run the
    streamed layout at a shape that fits).  Returns ``(s, sweeps)``, the
    sweeps a 0-d int64 tensor on the card."""
    dev = g.device
    g = g.contiguous()
    m, n = g.shape
    if plan is None:
        plan = device_plan(m, n, dev.index)
    elif (plan.m, plan.n) != (m, n):
        raise ValueError(f"the plan is for {plan.m}x{plan.n}, not {m}x{n}")
    s = torch.empty_like(g)
    sweeps = torch.empty((), dtype=torch.int64, device=dev)
    scratch = (torch.empty(plan.work_bytes // 8, dtype=torch.float64,
                           device=dev)
               if plan.layout == "streamed" else None)
    err = _kernel_lib().run(
        g.data_ptr(), m, n, plan.warps, plan.ctas,
        int(plan.layout == "resident"),
        plan.work_bytes, tolerance(plan.p), MAX_SWEEPS,
        None if scratch is None else scratch.data_ptr(), s.data_ptr(),
        sweeps.data_ptr(), _stats(dev).data_ptr(), dev.index,
        torch._C._cuda_getCurrentRawStream(dev.index))
    _check_err(err, "kernel launch")
    return s, sweeps
