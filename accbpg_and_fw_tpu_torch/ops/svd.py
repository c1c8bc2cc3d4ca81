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
``csrc/top_singular.cu`` in the layout ``svd_plan`` chooses by shape:
"resident" (one CTA with A and V in its shared memory, a warp a pair),
"ring" (CTAs that each keep a run of pairs' columns in shared memory and
pass the columns that leave a run to the neighbouring CTA each round, as
``ring_rounds`` models; in one cluster where its CTAs hold A and V, else
spread over the card) or "streamed" (a cooperative grid of CTAs over a
global scratch, a warp a pair), and counts the launch in ``LAUNCHES`` on
the host and,
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

_WARPS = 32          # at most a resident CTA's warps
_RING_WARPS = 16     # at most a ring CTA's warps
_GRID_WARPS = 4      # a streamed CTA's warps
_STATIC_SMEM = 1024  # room left for the kernel's static shared memory
_MAX_CLUSTER = 16

# The stages of a round that a timed launch clocks for thread 0 of CTA 0
# (``_launch_cuda(prof=...)``), then the rounds and the sweeps it ran and
# the rotations of all its CTAs (PROF_LEN int64 in all).
STAGES = ("dots", "rotation", "send", "wait", "sweep test")
PROF_LEN = len(STAGES) + 3


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


def ring_layout(c, C, Q, np_):
    """CTA c's share of the ring (``csrc/top_singular.cu::ring_layout``):
    ``(q0, q1, arcs, fixed)``, its pairs [q0, q1), its arcs as ``(t0, n,
    nb, base, in, out)`` and the fixed column's buffer (None: not held).

    The columns go round one cycle of L = 2 Q - 1 positions: second[0],
    second[1], ..., second[Q-1], first[Q-1], ..., first[1] (pair q's
    second column at position q, its first at 2 Q - 1 - q; first[0] is
    the fixed column).  From one round to the next each column moves one
    position on.  Arc position u (0 <= u < n) is cycle position (t0 + u)
    mod L and lives in buffer base + (u - R) mod nb in round R: a slot
    map, no copy.  An open arc takes its u = 0 column from CTA ``in`` and
    gives its u = n - 1 column to CTA ``out`` each round; its nb = n + 2
    buffers keep the buffer a neighbour writes for round R + 1 clear of
    the columns in use and of the one sent at the start of round R."""
    L = 2 * Q - 1
    q0, q1 = c * np_, min(Q, (c + 1) * np_)
    if C == 1:
        return q0, q1, [(0, L, L, 0, -1, -1)], L
    if c == 0:
        n = 2 * q1 - 1
        return q0, q1, [((2 * Q - q1) % L, n, n + 2, 0, 1, 1)], n + 2
    if c == C - 1:
        n = 2 * (Q - q0)
        return q0, q1, [(q0, n, n + 2, 0, c - 1, c - 1)], None
    n = q1 - q0
    return q0, q1, [(q0, n, n + 2, 0, c - 1, c + 1),
                    (2 * Q - q1, n, n + 2, n + 2, c + 1, c - 1)], None


def ring_buffers(Q, np_, C):
    """The column buffers a ring CTA holds at most (``ring_layout``)."""
    if C == 1:
        return 2 * Q
    return 2 * np_ + (2 if C == 2 else 4)


def ring_rounds(k, np_, sweeps=1):
    """A plain model of the ring's exchange: the pairs of k columns placed
    on CTAs of ``np_`` pairs each (``ring_layout``), each CTA's buffers
    loaded with the columns of round 0, and at the start of each round
    the column that left an arc in the round before sent into the
    neighbour's buffer for this round, as the kernel sends it.  A CTA
    sends once it has finished the round before, so its neighbour is at
    most a round behind.  Returns each round's pairs ``(i, j)`` as the
    CTAs' slots hold them, in the pairs' order: ``rounds(k)`` once a
    sweep.  Raises AssertionError where a slot holds another column than
    the schedule's, or a send lands in a buffer the neighbour may still
    use in the round before: a column of it, or the buffer it sent from
    at its start."""
    kk = k + k % 2
    Q, L = kk // 2, kk - 1
    C = -(-Q // np_)
    lay = [ring_layout(c, C, Q, np_) for c in range(C)]
    bufs = [[None] * ring_buffers(Q, np_, C) for _ in range(C)]

    def buf(arc, u, R):
        t0, n, nb, base, _, _ = arc
        return base + (u - R) % nb

    for c, (_, _, arcs, fixed) in enumerate(lay):
        for arc in arcs:
            for u in range(arc[1]):
                bufs[c][buf(arc, u, 0)] = -((arc[0] + u) % L) % L
        if fixed is not None:
            bufs[c][fixed] = kk - 1

    def slot(c, t, R):
        for arc in lay[c][2]:
            u = (t - arc[0]) % L
            if u < arc[1]:
                return buf(arc, u, R)
        raise AssertionError(f"CTA {c} holds no position {t}")

    out = []
    for R in range(sweeps * L):
        if R > 0:
            sent = []
            for c, (_, _, arcs, _) in enumerate(lay):
                for arc in arcs:
                    if arc[5] >= 0:
                        sent.append((arc[5], c,
                                     bufs[c][buf(arc, arc[1] - 1, R - 1)]))
            for d, c, col in sent:
                arcs = lay[d][2]
                arc = arcs[1] if 0 < d < C - 1 and c == d + 1 else arcs[0]
                assert arc[4] == c, (d, c)
                dst = buf(arc, 0, R)
                busy = set()
                for a2 in arcs:
                    busy |= {buf(a2, u, R - 1) for u in range(a2[1])}
                    if a2[5] >= 0:
                        busy.add(buf(a2, a2[1] - 1, R - 2))
                assert dst not in busy, (R, c, d, dst)
                bufs[d][dst] = col
        pairs = []
        for c, (q0, q1, _, fixed) in enumerate(lay):
            for q in range(q0, q1):
                b = bufs[c][slot(c, q, R)]
                a = (bufs[c][fixed] if q == 0 else
                     bufs[c][slot(c, 2 * Q - 1 - q, R)])
                assert b == (R - q) % L and a == (
                    kk - 1 if q == 0 else (R + q) % L), (R, q, a, b)
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
    #                   memory; "ring": a run of pairs' columns in each
    #                   CTA's shared memory; "streamed": in a global
    #                   scratch, over a cooperative grid
    warps: int        # warps of a CTA
    ctas: int         # CTAs (1 where resident)
    work_bytes: int   # global scratch (streamed: A, V, the norms, a partial
    #                   sum a CTA and two flags; ring: ``ring_work_bytes``);
    #                   resident: the shared bytes of A, V and the norms
    pairs: int = 1    # pairs of a round a CTA holds (ring)
    pair_warps: int = 1  # warps a pair (ring; else 1)
    cluster: int = 1  # CTAs a cluster (ring; 1: neighbours meet through
    #                   mailboxes in global memory)
    smem_bytes: int = 0  # dynamic shared bytes a CTA


def colstride(p, k):
    """Doubles of a ring column buffer: A's column and V's, even."""
    return (p + k + 1) & ~1


def ring_work_bytes(p, k, ring_ctas, ctas):
    """The ring's global scratch: a mailbox column and an 8-byte flag for
    each of a ring CTA's two sides and two round parities, a partial sum
    and a best norm (value and index) a CTA, and the top column (at a
    16-byte boundary)."""
    cs = colstride(p, k)
    head = ring_ctas * 4 * (cs + 1) + 3 * ctas
    return 8 * (head + head % 2 + cs)


def ring_plan(m, n, pairs, pair_warps, cluster=1, smem_limit=None):
    """The ring layout of an m x n solve with ``pairs`` pairs a CTA,
    ``pair_warps`` warps a pair and clusters of ``cluster`` CTAs (the grid
    padded to whole clusters with CTAs that hold no pair); raises
    ValueError where the kernel cannot take it (more than ``_RING_WARPS``
    warps a CTA, a cluster past ``_MAX_CLUSTER``, or more shared bytes
    than ``smem_limit`` less the static allowance)."""
    p, k = max(m, n), min(m, n)
    Q = (k + k % 2) // 2
    C = -(-Q // pairs)
    warps = pairs * pair_warps
    ctas = -(-C // cluster) * cluster
    smem = 8 * colstride(p, k) * ring_buffers(Q, pairs, C)
    if not (1 <= pairs and 1 <= pair_warps and warps <= _RING_WARPS
            and 1 <= cluster <= _MAX_CLUSTER):
        raise ValueError(f"no ring of {pairs} pairs x {pair_warps} warps "
                         f"in clusters of {cluster}")
    if smem_limit is not None and smem > smem_limit - _STATIC_SMEM:
        raise ValueError(f"a ring CTA of {m}x{n} at {pairs} pairs needs "
                         f"{smem} shared bytes")
    return SvdPlan(m, n, p, k, m < n, "ring", warps, ctas,
                   ring_work_bytes(p, k, C, ctas), pairs, pair_warps,
                   cluster, smem)


def ring_pair_warps(p, pairs, warps):
    """The warps a ring pair takes: a power of two, at most ``warps`` a CTA
    in all and a warp for every 128 rows of A."""
    w = 1
    while 2 * w * pairs <= warps and 2 * w * 128 <= p:
        w *= 2
    return w


# A ring CTA's warps in all: in one cluster (whose CTAs hold several pairs
# each, and whose shared memory passes bound a round) and spread over the
# card with mailboxes; from the sweep of `chip_smoke.py --svd` ([svd sweep]).
_CLUSTER_RING_WARPS = 4
_SPREAD_RING_WARPS = 8


def svd_plan(m, n, smem_limit, sms=None):
    """The layout of one solve of an m x n matrix on a card whose CTAs may
    take ``smem_limit`` bytes of shared memory and which has ``sms``
    multiprocessors (None: no cap), chosen by shape:

    * "resident" where A (p x k), V (k x k) and the k column norms fit in
      shared memory beside the kernel's static shared memory: one CTA, a
      warp for each pair of a round, at most ``_WARPS``;
    * "ring" in one cluster where ``_MAX_CLUSTER`` CTAs hold A and V: the
      fewest pairs a CTA for that, the cluster the power of two that takes
      the CTAs, the neighbours' columns passed through shared memory;
    * "ring" spread over the card where its CTAs hold A and V: the fewest
      pairs a CTA that leave a CTA a multiprocessor, no cluster (mailboxes
      between all CTAs);
    * "streamed" past that: A, V and the norms in a global scratch, and a
      warp for each pair over CTAs of ``_GRID_WARPS`` warps, at most one a
      multiprocessor (a round's barrier is grid-wide, so every CTA must be
      on the card at once).

    Warps a pair: ``ring_pair_warps`` within ``_CLUSTER_RING_WARPS`` or
    ``_SPREAD_RING_WARPS`` a CTA."""
    if m < 1 or n < 1:
        raise ValueError(f"svd_plan needs a nonempty matrix, got {m}x{n}")
    p, k = max(m, n), min(m, n)
    pairs = max(1, (k + 1) // 2)
    work = 8 * (p * k + k * k + k)
    if work <= smem_limit - _STATIC_SMEM:
        return SvdPlan(m, n, p, k, m < n, "resident", min(_WARPS, pairs), 1,
                       work, smem_bytes=work)
    per = -(-pairs // _MAX_CLUSTER)
    ctas = -(-pairs // per)
    cluster = 2
    while cluster < ctas:
        cluster *= 2
    if ctas > 1 and cluster <= _MAX_CLUSTER and per <= _RING_WARPS:
        try:
            return ring_plan(
                m, n, per, ring_pair_warps(p, per, _CLUSTER_RING_WARPS),
                cluster, smem_limit)
        except ValueError:
            pass
    per = 1 if sms is None else -(-pairs // sms)
    if per <= _RING_WARPS:
        try:
            return ring_plan(
                m, n, per, ring_pair_warps(p, per, _SPREAD_RING_WARPS), 1,
                smem_limit)
        except ValueError:
            pass
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
    info: object
    active_clusters: object
    error_string: object


_KINDS = {"resident": 0, "streamed": 1, "ring": 2}


@functools.lru_cache(maxsize=None)
def _kernel_lib():
    from . import _build

    lib = _build.load("top_singular")
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    ip = ctypes.POINTER(i)
    lib.top_singular_run.argtypes = [p, i, i, ip, ctypes.c_longlong, d, i,
                                     p, p, p, p, p, p, i, p]
    lib.top_singular_run.restype = i
    lib.top_singular_smem_limit.argtypes = [i, ip]
    lib.top_singular_smem_limit.restype = i
    lib.top_singular_info.argtypes = [i, ip]
    lib.top_singular_info.restype = i
    lib.top_singular_active_clusters.argtypes = [i, i, i, i, ip]
    lib.top_singular_active_clusters.restype = i
    lib.top_singular_stages.restype = i
    if lib.top_singular_stages() != len(STAGES):
        raise RuntimeError("csrc/top_singular.cu clocks other stages than "
                           "ops/svd.py names")
    lib.top_singular_error_string.argtypes = [i]
    lib.top_singular_error_string.restype = ctypes.c_char_p
    return _Kernel(lib.top_singular_run, lib.top_singular_smem_limit,
                   lib.top_singular_info, lib.top_singular_active_clusters,
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


def kernel_info(device_index=None):
    """The three kernels as compiled: ``{layout: (registers a thread,
    static shared bytes, local (spill) bytes a thread)}``."""
    out = (ctypes.c_int * 9)()
    _check_err(_kernel_lib().info(_index(device_index), out), "info")
    return {name: tuple(out[3 * i:3 * i + 3])
            for i, name in enumerate(("resident", "streamed", "ring"))}


def active_clusters(plan, device_index=None):
    """The clusters of ``plan`` (a ring) the card holds at once."""
    out = ctypes.c_int()
    _check_err(_kernel_lib().active_clusters(
        _index(device_index), plan.cluster, 32 * plan.warps,
        plan.smem_bytes, ctypes.byref(out)), "occupancy query")
    return out.value


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


# Per device the ring's barrier words (count, generation, sum, result as
# four uint32), zero when made; every barrier returns them to zero count
# and sum, so launches on one stream reuse them.
_SYNC: dict = {}


def _sync(device):
    words = _SYNC.get(device.index)
    if words is None:
        words = torch.zeros(2, dtype=torch.int64, device=device)
        _SYNC[device.index] = words
    return words


def _launch_cuda(g, plan=None, prof=None):
    """One launch on ``g``'s device; ``plan``: a layout in place of
    ``device_plan``'s (``svd_plan`` with another limit, or ``ring_plan``,
    to run another layout at a shape); ``prof``: an int64 tensor of
    ``PROF_LEN`` zeros on the card for the timed instance of a ring or
    streamed launch, which adds thread 0 of CTA 0's clocks per stage, the
    rounds, the sweeps and the rotations to it (a resident launch adds
    only the rotations).  Returns ``(s, sweeps)``, the sweeps a 0-d int64
    tensor on the card."""
    dev = g.device
    g = g.contiguous()
    m, n = g.shape
    if plan is None:
        plan = device_plan(m, n, dev.index)
    elif (plan.m, plan.n) != (m, n):
        raise ValueError(f"the plan is for {plan.m}x{plan.n}, not {m}x{n}")
    if prof is not None and (prof.dtype != torch.int64
                             or prof.numel() != PROF_LEN):
        raise ValueError(f"prof takes {PROF_LEN} int64")
    s = torch.empty_like(g)
    sweeps = torch.empty((), dtype=torch.int64, device=dev)
    scratch = (torch.empty(plan.work_bytes // 8, dtype=torch.float64,
                           device=dev)
               if plan.layout != "resident" else None)
    layout = (ctypes.c_int * 7)(
        _KINDS[plan.layout], plan.warps, plan.ctas, plan.pairs,
        plan.pair_warps, plan.cluster, plan.smem_bytes)
    err = _kernel_lib().run(
        g.data_ptr(), m, n, layout, plan.work_bytes, tolerance(plan.p),
        MAX_SWEEPS, None if scratch is None else scratch.data_ptr(),
        _sync(dev).data_ptr(), s.data_ptr(), sweeps.data_ptr(),
        _stats(dev).data_ptr(), None if prof is None else prof.data_ptr(),
        dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    _check_err(err, "kernel launch")
    return s, sweeps
