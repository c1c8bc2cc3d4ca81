// The top singular pair of an m x n FP64 matrix g as outer(u1, v1), in one
// launch for Hopper (sm_90a): the vertex of the unit nuclear-norm ball that
// lmo_nuclear_norm_ball returns.
//
// No TPU kernel: JAX's lmo_nuclear_norm_ball (accbpg_and_fw_tpu/ops/lmo.py
// :16-25) calls jnp.linalg.svd, which XLA compiles into the chunk.  On the
// card no library call computes a top singular pair inside a CUDA graph:
// cuSOLVER's SVD checks its info on the host, and a capture refuses it.
// This kernel reads nothing back, so a graph captures it as one node.  The
// port's plain version is accbpg_and_fw_tpu_torch/ops/svd.py::
// top_singular_pair_reference, which repeats the algorithm in torch
// operations.
//
// Algorithm: one-sided (Hestenes) Jacobi on the p x k matrix A = g, or g^T
// where m < n (p = max(m, n), k = min(m, n)), with V = I (k x k):
//   * a sweep visits every pair i < j once, in the kk - 1 rounds of a
//     round-robin tournament of kk = k rounded up to even columns (the
//     last fixed, the others turning a seat a round; a pair with the extra
//     column of an odd k is left out).  The pairs of a round touch distinct
//     columns, so they rotate at once;
//   * a pair with |<a_i,a_j>| > tol ||a_i|| ||a_j||, neither column at or
//     below eps ||g||_F (rounding noise of the others: rotated against
//     them it never settles), is rotated to orthogonality, in A and V: zeta = (||a_j||^2 - ||a_i||^2) / (2
//     <a_i,a_j>), t = sign(zeta) / (|zeta| + hypot(1, zeta)), c = 1 /
//     sqrt(1 + t^2), s = c t, a_i <- c a_i - s a_j, a_j <- s a_i + c a_j;
//   * the sweeps end after one that rotated no pair, or after max_sweeps;
//   * the top index is the largest column norm, the first on ties; sigma_1
//     is its norm, u1 = a_top / sigma_1, v1 = V[:, top], and s = outer(u1,
//     v1) (outer(v1, u1) where A = g^T), which does not depend on the
//     rotations' signs.  sigma_1 = 0 gives outer(e1, e1), as JAX's SVD of
//     a zero matrix does.
// It works on g, not on g^T g, so its accuracy is an SVD's.
//
// What bounds it: a round's rotations depend on the round before through
// the columns they share, so a sweep is kk - 1 dependent steps, each three
// dot products of length p a pair (6 p FP64 operations) and the rotation
// of two columns of A and V (6 (p + k)).  At 1000 x 1000 a solve is ~16
// sweeps of 999 rounds, ~0.2 TFLOP in all: ~3 ms of the card's FP64
// rate, against a chain of ~16,000 rounds.  The chain is the time: what a
// round costs beyond its arithmetic (a barrier, a trip to the L2 and
// back) is paid 16,000 times.  Three layouts, chosen by shape
// (ops/svd.py::svd_plan):
//   * "resident" (A, V and the column norms fit in one CTA's shared
//     memory: p k + k^2 + k doubles): one CTA of up to 32 warps, a warp a
//     pair, a round ending at a block barrier;
//   * "ring" (A and V fit in the shared memory of the CTAs the card holds
//     at once): each CTA keeps a contiguous run of pairs, their columns of
//     A and V resident in its shared memory, a pair over one or more
//     warps.  The round-robin schedule moves every column by at most one
//     pair a round (pair q's first column comes from pair q + 1, its
//     second from pair q - 1, the fixed column stays at pair 0, the last
//     pair takes back its own second column): the columns go round one
//     cycle of kk - 1 positions (second[0], ..., second[Q-1], first[Q-1],
//     ..., first[1]; Q = kk / 2 pairs), and a CTA holds one or two arcs of
//     it.  Within a CTA the shift is a slot map (a circular buffer per
//     arc); only an arc's end leaves the CTA, to the neighbouring CTA: two
//     columns a CTA a round, sent at the start of the next round.  Inside
//     a cluster they go by st.async into the peer's shared memory, counted
//     on its mbarrier (cluster.cuh's send16); between clusters through a
//     mailbox in global memory, double-buffered by round parity, with a
//     release/acquire flag that only the neighbour waits on.  No grid
//     barrier in a round: only the sweep's "rotated" test, the start's
//     ||g||_F and the end's top column meet at a barrier of the grid.
//     (A staged exchange, the column sent unrotated a round ahead and its
//     rotation once known, rebuilt by the neighbour from a kept partner,
//     was measured too and was no faster: the chain of rounds is the dot
//     products, the rotation's scalars and the columns' passes, not the
//     column's trip; PERF.md);
//   * "streamed" (past that): A, V and the norms in a global scratch that
//     the L2 holds, and a cooperative grid of CTAs of a few warps, a warp a
//     pair across the SMs, a round ending at a grid barrier.
// In all three a pair's sums end in an xor butterfly, and the partial sums
// of a pair split over warps are added in the warps' order: every warp of
// the pair gets the same bits, so the rotate-or-not branch is uniform and
// the kernel is deterministic (a graph's rows equal the eager loop's).
// Thread 0 of the first CTA adds to three device int64s: the launches (a
// graph's replays count there), the solves that ended at max_sweeps, and
// the most sweeps a solve took; each launch also writes its sweep count.
// The ring and streamed layouts have a timed instance: thread 0 of CTA 0
// adds its clocks per stage of a round (the dot products, the rotation,
// the sends, the wait for the neighbours' columns or the grid barrier, and
// once a sweep the sweep's test) to `prof`, then the rounds and sweeps;
// every CTA adds the rotations it made (a resident launch given `prof`
// counts only those).
//
// Interface: plain C, loaded with ctypes.  The wrapper allocates the output
// and the scratch with torch.empty, and once per device the ring's four
// barrier words with torch.zeros (they return to their start at each
// barrier); the kernel launches on the caller's stream.  Two launches of
// the ring on one device must not run at once (they share those words).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDevices = 64;
constexpr int kMaxWarps = 32;      // a resident CTA's warps
constexpr int kRingWarps = 16;     // a ring CTA's warps
constexpr int kInFlight = 8;       // mailbox loads a thread issues at once
constexpr int kGridWarps = 4;      // a streamed CTA's warps
constexpr int kMaxCluster = 16;
constexpr unsigned kFull = 0xffffffffu;

enum Kind { kResident = 0, kStreamed = 1, kRing = 2 };

// The stages of a round that thread 0 of CTA 0 clocks in a timed launch.
enum Stage {
  kDots,      // the three dot products of its pair (and the block barrier
              // after them, where a pair spans warps)
  kRotate,    // the rotation of its pair's columns, to the round's barrier
  kSend,      // ring: the columns that leave the CTA, sent
  kWait,      // ring: the neighbours' columns awaited (and copied from a
              // mailbox); streamed: the grid barrier
  kSweep,     // once a sweep: the "rotated" test
  kStages
};

template <bool kTimed>
struct Clock {
  long long* slots;  // kStages sums in shared memory
  long long last;
  bool on;
  __device__ __forceinline__ void tick(int stage) {
    if (kTimed && on) {
      const long long t = clock64();
      slots[stage] += t - last;
      last = t;
    }
  }
};

struct Params {
  const double* g;          // m x n, row-major
  int m, n, p, k;
  int transposed;           // A = g^T
  double tol;
  int max_sweeps;
  double* work;             // streamed: A, V, norms, partial sums, flags;
                            // ring: mailbox columns and flags, partial
                            // sums, the CTAs' best norms, the top column
  double* s;                // m x n, row-major
  long long* sweeps_out;
  unsigned long long* stats;  // launches, solves at the bound, most sweeps
  // ring
  int pairs;                // pairs a CTA
  int pair_warps;           // warps a pair
  int cluster;              // CTAs a cluster (1: mailboxes only)
  int ring_ctas;            // CTAs that hold pairs (the rest only meet)
  int colstride;            // doubles a column buffer: p + k, even
  unsigned* sync;           // the ring's barrier: count, generation, sum,
                            // result
  long long* prof;          // timed: kStages clock sums, rounds, sweeps,
                            // rotations
};

// A CTA's rotations into the timed launch's count.
__device__ __forceinline__ void add_rotations(const Params& P,
                                              unsigned long long n) {
  atomicAdd(reinterpret_cast<unsigned long long*>(P.prof + kStages + 2), n);
}

// Products and sums rounded one by one, as the plain version's tensor
// operations round them: contracted into fused multiply-adds, the rounding
// left a rank-1 matrix's zero columns rotating against each other until the
// sweep bound on an H100; rounded apart, and with the negligible columns
// left out of the rotations (below), they settle in 2 sweeps.
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The streamed layout's columns change between rounds on other SMs: read
// and write them at the L2 (no stale L1 line is read after a grid barrier).
template <bool kL2>
__device__ __forceinline__ double ld(const double* p) {
  if constexpr (kL2) return __ldcg(p);
  return *p;
}
template <bool kL2>
__device__ __forceinline__ void st(double* p, double v) {
  if constexpr (kL2) __stcg(p, v);
  else *p = v;
}

// The columns (i, j) of pair q of round r in a sweep of kk columns;
// false for a pair with the extra column of an odd k.
__device__ __forceinline__ bool pair_of(int r, int q, int kk, int k, int* i,
                                        int* j) {
  int a = kk - 1, b = r;
  if (q > 0) {
    a = (r + q) % (kk - 1);
    b = (r - q + (kk - 1)) % (kk - 1);
  }
  *i = a < b ? a : b;
  *j = a < b ? b : a;
  return *j < k;
}

// A column pass of one lane: its elements t = start, start + step, ... of
// [0, len), kBatch at a time: the batch's loads are issued together, then
// applied in t's order, so the sums round as a plain loop's would.
constexpr int kBatch = 8;

// The lane's partial sums (<ci, ci>, <cj, cj>, <ci, cj>) over its elements.
template <bool kL2>
__device__ __forceinline__ void dots(const double* ci, const double* cj,
                                     int len, int start, int step,
                                     double* al, double* be, double* ga) {
  int t = start;
  for (; t + step * (kBatch - 1) < len; t += step * kBatch) {
    double x[kBatch], y[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      x[u] = ld<kL2>(ci + t + step * u);
      y[u] = ld<kL2>(cj + t + step * u);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      *al = add(*al, mul(x[u], x[u]));
      *be = add(*be, mul(y[u], y[u]));
      *ga = add(*ga, mul(x[u], y[u]));
    }
  }
  for (; t < len; t += step) {
    const double x = ld<kL2>(ci + t), y = ld<kL2>(cj + t);
    *al = add(*al, mul(x, x));
    *be = add(*be, mul(y, y));
    *ga = add(*ga, mul(x, y));
  }
}

// (ci, cj) <- (c ci - s cj, s ci + c cj) over the lane's elements.
template <bool kL2>
__device__ __forceinline__ void rotate_columns(double* ci, double* cj,
                                               int len, int start, int step,
                                               double c, double s) {
  int t = start;
  for (; t + step * (kBatch - 1) < len; t += step * kBatch) {
    double x[kBatch], y[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      x[u] = ld<kL2>(ci + t + step * u);
      y[u] = ld<kL2>(cj + t + step * u);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      st<kL2>(ci + t + step * u, sub(mul(c, x[u]), mul(s, y[u])));
      st<kL2>(cj + t + step * u, add(mul(s, x[u]), mul(c, y[u])));
    }
  }
  for (; t < len; t += step) {
    const double x = ld<kL2>(ci + t), y = ld<kL2>(cj + t);
    st<kL2>(ci + t, sub(mul(c, x), mul(s, y)));
    st<kL2>(cj + t, add(mul(s, x), mul(c, y)));
  }
}

// Whether a pair with sums (al, be, ga) is rotated, and its (c, s).
__device__ __forceinline__ bool rotation(double al, double be, double ga,
                                         double tol, double small, double* c,
                                         double* s) {
  if (!(al > small && be > small && fabs(ga) > tol * sqrt(al) * sqrt(be)))
    return false;
  const double zeta = (be - al) / (2.0 * ga);
  const double tn = copysign(1.0, zeta) / (fabs(zeta) + hypot(1.0, zeta));
  *c = 1.0 / sqrt(add(1.0, mul(tn, tn)));
  *s = mul(*c, tn);
  return true;
}

// One warp's pair: rotates columns i < j of A (p long) and V (k long) to
// orthogonality where they are not yet; true if it rotated.
template <bool kL2, bool kTimed>
__device__ bool rotate_pair(double* A, double* V, int p, int k, int i, int j,
                            int lane, double tol, double small,
                            Clock<kTimed>& clk) {
  double* ai = A + (size_t)i * p;
  double* aj = A + (size_t)j * p;
  double al = 0.0, be = 0.0, ga = 0.0;
  dots<kL2>(ai, aj, p, lane, 32, &al, &be, &ga);
  al = warp_sum(al);
  be = warp_sum(be);
  ga = warp_sum(ga);
  clk.tick(kDots);
  double c, s;
  if (!rotation(al, be, ga, tol, small, &c, &s)) return false;
  rotate_columns<kL2>(ai, aj, p, lane, 32, c, s);
  rotate_columns<kL2>(V + (size_t)i * k, V + (size_t)j * k, k, lane, 32, c,
                      s);
  clk.tick(kRotate);
  return true;
}

// Column j's norm, by one warp.
template <bool kL2>
__device__ __forceinline__ double column_norm(const double* aj, int p,
                                              int lane) {
  double nrm = 0.0;
  for (int t = lane; t < p; t += 32) {
    const double x = ld<kL2>(aj + t);
    nrm = add(nrm, mul(x, x));
  }
  return sqrt(warp_sum(nrm));
}

// A[row, col] of A = g (or g^T).
__device__ __forceinline__ double a_element(const Params& P, int row,
                                            int col) {
  return P.transposed ? P.g[(size_t)col * P.n + row]
                      : P.g[(size_t)row * P.n + col];
}

// Element idx of g into A (A = g^T keeps g's layout).
template <bool kL2>
__device__ __forceinline__ double load_element(const Params& P, double* A,
                                               long long idx) {
  const double x = P.g[idx];
  if (P.transposed) {
    st<kL2>(A + idx, x);
  } else {
    const long long r = idx / P.n, c = idx % P.n;
    st<kL2>(A + c * P.p + r, x);
  }
  return x;
}

// Element idx of s = outer(u1, v1) (outer(e1, e1) where sigma_1 = 0), u
// the top column of A (p long) and v of V (k long).
template <bool kL2>
__device__ __forceinline__ void store_vertex(const Params& P, const double* u,
                                             const double* v, double sigma,
                                             long long idx) {
  const long long r = idx / P.n, c = idx % P.n;
  double val;
  if (sigma > 0.0)
    val = P.transposed ? ld<kL2>(v + r) * (ld<kL2>(u + c) / sigma)
                       : (ld<kL2>(u + r) / sigma) * ld<kL2>(v + c);
  else
    val = idx == 0 ? 1.0 : 0.0;
  P.s[idx] = val;
}

__device__ __forceinline__ void count_solve(const Params& P, int sweeps,
                                            bool converged) {
  *P.sweeps_out = sweeps;
  atomicAdd(&P.stats[0], 1ull);
  if (!converged) atomicAdd(&P.stats[1], 1ull);
  atomicMax(&P.stats[2], (unsigned long long)sweeps);
}

// The first index of the largest value over a CTA: each thread's (v, i)
// in, thread 0's result out (the same rule as argmax: ties to the first).
__device__ __forceinline__ void better(double ov, int oi, double* bv,
                                       int* bi) {
  if (ov > *bv || (ov == *bv && oi < *bi)) {
    *bv = ov;
    *bi = oi;
  }
}

// The resident layout: one CTA, A, V and the norms in shared memory.
__global__ void __launch_bounds__(kMaxWarps * 32)
top_singular_kernel(Params P) {
  extern __shared__ double smem[];
  __shared__ int rotated;
  __shared__ int top_s;
  __shared__ double warp_sq[kMaxWarps];
  __shared__ double small_s;
  __shared__ unsigned long long rot_count;
  const int p = P.p, k = P.k;
  double* A = smem;                     // column j at A + j p
  double* V = A + (size_t)p * k;        // column j at V + j k
  double* norms = V + (size_t)k * k;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long mn = (long long)P.m * P.n;
  Clock<false> clk{nullptr, 0, false};

  // A from g, V = I, and ||g||_F^2 summed in a fixed order
  double sq = 0.0;
  for (long long idx = tid; idx < mn; idx += blockDim.x) {
    const double x = load_element<false>(P, A, idx);
    sq = add(sq, mul(x, x));
  }
  for (long long idx = tid; idx < (long long)k * k; idx += blockDim.x)
    V[idx] = (idx / k == idx % k) ? 1.0 : 0.0;
  sq = warp_sum(sq);
  if (lane == 0) warp_sq[warp] = sq;
  if (tid == 0) {
    rotated = 0;
    rot_count = 0;
  }
  __syncthreads();
  if (tid == 0) {
    double fro2 = 0.0;
    for (int w = 0; w < nwarps; ++w) fro2 = add(fro2, warp_sq[w]);
    small_s = ldexp(fro2, -104);  // eps^2 ||g||_F^2, eps = 2^-52
  }
  __syncthreads();
  const double small = small_s;

  const int kk = k + (k & 1);
  int sweeps = 0;
  bool converged = false;
  while (sweeps < P.max_sweeps) {
    ++sweeps;
    for (int r = 0; r < kk - 1; ++r) {
      for (int q = warp; q < kk / 2; q += nwarps) {
        int i, j;
        if (pair_of(r, q, kk, k, &i, &j) &&
            rotate_pair<false>(A, V, p, k, i, j, lane, P.tol, small, clk) &&
            lane == 0) {
          rotated = 1;
          if (P.prof) atomicAdd(&rot_count, 1ull);
        }
      }
      __syncthreads();
    }
    const int any = rotated;
    __syncthreads();
    if (!any) {
      converged = true;
      break;
    }
    if (tid == 0) rotated = 0;
    __syncthreads();
  }

  for (int j = warp; j < k; j += nwarps) {
    const double nrm = column_norm<false>(A + (size_t)j * p, p, lane);
    if (lane == 0) norms[j] = nrm;
  }
  __syncthreads();
  if (tid == 0) {
    int top = 0;
    for (int j = 1; j < k; ++j)
      if (norms[j] > norms[top]) top = j;
    top_s = top;
    count_solve(P, sweeps, converged);
    if (P.prof) add_rotations(P, rot_count);
  }
  __syncthreads();
  const int top = top_s;
  for (long long idx = tid; idx < mn; idx += blockDim.x)
    store_vertex<false>(P, A + (size_t)top * p, V + (size_t)top * k,
                        norms[top], idx);
}

// The streamed layout: a cooperative grid, A, V, the norms, one partial
// sum of ||g||_F^2 a CTA and two "rotated" flags (one a sweep, by parity)
// in the scratch P.work; a round ends at a grid barrier.
template <bool kTimed>
__global__ void __launch_bounds__(kGridWarps * 32)
top_singular_grid_kernel(Params P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double warp_sq[kGridWarps];
  __shared__ double small_s;
  __shared__ int any_s;
  __shared__ double best_v[kGridWarps];
  __shared__ int best_i[kGridWarps];
  __shared__ int top_s;
  __shared__ long long s_prof[kStages];
  __shared__ unsigned long long rot_count;
  const int p = P.p, k = P.k;
  double* A = P.work;
  double* V = A + (size_t)p * k;
  double* norms = V + (size_t)k * k;
  double* partial = norms + k;
  unsigned* flags = reinterpret_cast<unsigned*>(partial + gridDim.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long mn = (long long)P.m * P.n;
  const long long gtid = (long long)blockIdx.x * blockDim.x + tid;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const int gwarp = blockIdx.x * nwarps + warp, gwarps = gridDim.x * nwarps;
  Clock<kTimed> clk{s_prof, 0, kTimed && blockIdx.x == 0 && tid == 0};

  double sq = 0.0;
  for (long long idx = gtid; idx < mn; idx += nthreads) {
    const double x = load_element<true>(P, A, idx);
    sq = add(sq, mul(x, x));
  }
  for (long long idx = gtid; idx < (long long)k * k; idx += nthreads)
    __stcg(V + idx, (idx / k == idx % k) ? 1.0 : 0.0);
  sq = warp_sum(sq);
  if (lane == 0) warp_sq[warp] = sq;
  if (gtid < 2) atomicExch(flags + gtid, 0u);
  if (tid == 0) rot_count = 0;
  __syncthreads();
  if (tid == 0) {
    double part = 0.0;
    for (int w = 0; w < nwarps; ++w) part = add(part, warp_sq[w]);
    __stcg(partial + blockIdx.x, part);
  }
  grid.sync();
  if (tid == 0) {
    double fro2 = 0.0;
    for (int b = 0; b < (int)gridDim.x; ++b)
      fro2 = add(fro2, __ldcg(partial + b));
    small_s = ldexp(fro2, -104);  // eps^2 ||g||_F^2, eps = 2^-52
  }
  __syncthreads();
  const double small = small_s;
  if (clk.on) {
    for (int q = 0; q < kStages; ++q) s_prof[q] = 0;
    clk.last = clock64();
  }

  const int kk = k + (k & 1);
  int sweeps = 0;
  bool converged = false;
  while (sweeps < P.max_sweeps) {
    ++sweeps;
    unsigned* flag = flags + (sweeps & 1);  // zero at the sweep's start
    for (int r = 0; r < kk - 1; ++r) {
      for (int q = gwarp; q < kk / 2; q += gwarps) {
        int i, j;
        if (pair_of(r, q, kk, k, &i, &j) &&
            rotate_pair<true>(A, V, p, k, i, j, lane, P.tol, small, clk) &&
            lane == 0) {
          atomicExch(flag, 1u);
          if (kTimed) atomicAdd(&rot_count, 1ull);
        }
      }
      clk.tick(kRotate);  // a pair not rotated: its test
      grid.sync();
      clk.tick(kWait);
    }
    if (tid == 0) any_s = (int)atomicAdd(flag, 0u);
    __syncthreads();
    if (!any_s) {  // the same in every CTA: no write since the barrier
      converged = true;
      break;
    }
    grid.sync();  // every CTA has read the flag: clear it for sweep + 2
    if (gtid == 0) atomicExch(flag, 0u);
    clk.tick(kSweep);
  }
  clk.tick(kSweep);

  for (int j = gwarp; j < k; j += gwarps) {
    const double nrm = column_norm<true>(A + (size_t)j * p, p, lane);
    if (lane == 0) __stcg(norms + j, nrm);
  }
  grid.sync();
  // the first index of the largest norm, in every CTA
  double bv = -1.0;
  int bi = 0;
  for (int j = tid; j < k; j += blockDim.x) {
    const double v = __ldcg(norms + j);
    if (v > bv) {
      bv = v;
      bi = j;
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const double ov = __shfl_xor_sync(kFull, bv, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    better(ov, oi, &bv, &bi);
  }
  if (lane == 0) {
    best_v[warp] = bv;
    best_i[warp] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < nwarps; ++w) better(best_v[w], best_i[w], &bv, &bi);
    top_s = bi;
    if (blockIdx.x == 0) count_solve(P, sweeps, converged);
  }
  __syncthreads();
  const int top = top_s;
  const double sigma = __ldcg(norms + top);
  for (long long idx = gtid; idx < mn; idx += nthreads)
    store_vertex<true>(P, A + (size_t)top * p, V + (size_t)top * k, sigma,
                       idx);
  if (clk.on) {
    for (int q = 0; q < kStages; ++q) P.prof[q] += s_prof[q];
    P.prof[kStages] += (long long)sweeps * (kk - 1);
    P.prof[kStages + 1] += sweeps;
  }
  if (kTimed && tid == 0) add_rotations(P, rot_count);
}

// ---- the ring layout --------------------------------------------------------

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned long long ld_acquire64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release64(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}
// The grid barrier's spin reads relaxed and orders what follows once, by
// a fence after the value it waited for.
__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void fence_acquire() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// A wait that lasts past kStallNs traps: the launch fails with an error
// instead of holding the card (a ring whose CTAs are not all on the card,
// or a fault in the exchange).
constexpr unsigned long long kStallNs = 10000000000ull;

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct Stall {
  unsigned long long start = 0;
  unsigned spins = 0;
  __device__ __forceinline__ void check() {
    if ((++spins & 1023u) == 0) {
      const unsigned long long t = now_ns();
      if (start == 0) start = t;
      else if (t - start > kStallNs) __trap();
    }
  }
};

// mbarrier_wait (cluster.cuh) with the stall check.
__device__ __forceinline__ void mbarrier_wait_checked(uint32_t bar,
                                                      int parity) {
  Stall stall;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    stall.check();
  }
}

// A barrier of the whole grid on four words that return to their start
// (count 0, sum 0) at each barrier: count, generation, sum, result.  Each
// CTA adds `add` to the sum; every CTA returns the total.  Its CTAs must
// all be on the card at once.
__device__ unsigned grid_barrier(unsigned* sync, unsigned add_in,
                                 unsigned* shared) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = ld_acquire(sync + 1);  // before this CTA arrives
    if (add_in) atomicAdd(sync + 2, add_in);
    __threadfence();
    if (atomicAdd(sync, 1u) == gridDim.x - 1) {
      __threadfence();
      const unsigned total = atomicExch(sync + 2, 0u);
      atomicExch(sync, 0u);
      atomicExch(sync + 3, total);
      __threadfence();
      st_release(sync + 1, gen + 1);
    } else {
      Stall stall;
      while (ld_relaxed(sync + 1) == gen) {
        __nanosleep(32);
        stall.check();
      }
      fence_acquire();
    }
    *shared = ld_acquire(sync + 3);
  }
  __syncthreads();
  return *shared;
}

// A run of positions of the cycle that a CTA holds: arc position u (0 <= u
// < n) is cycle position (t0 + u) mod L; it lives in buffer base + (u - R)
// mod nb in round R, so the shift is a slot map.  An open arc takes its
// column u = 0 from CTA `in` and gives its column u = n - 1 to CTA `out`.
// nb = n + 2 buffers: the buffer a neighbour writes for round R + 1 is
// neither one in use nor the one sent at the start of round R, whose
// reads may still be in flight (ops/svd.py::ring_rounds models the
// exchange and these lifetimes).
struct Arc {
  int t0, n, nb, base, in, out;
};
struct Layout {
  int q0, q1, narcs, fixed;  // pairs [q0, q1); the fixed column's buffer
  Arc arc[2];
};

// CTA c's arcs of a ring of C CTAs of np pairs over Q pairs (the cycle's
// length L = 2 Q - 1).  Middle CTAs hold two arcs: the second columns of
// their pairs (in from the left, out to the right) and the first columns
// (in from the right, out to the left); the first CTA one arc, its first
// columns then its second ones, with the fixed column beside it; the last
// CTA one arc, its second columns then its first ones.  One CTA holds the
// whole cycle as a closed arc.
__device__ __forceinline__ Layout ring_layout(int c, int C, int Q, int np) {
  const int L = 2 * Q - 1;
  Layout y;
  y.q0 = c * np;
  y.q1 = min(Q, y.q0 + np);
  y.fixed = -1;
  y.narcs = 1;
  if (C == 1) {
    y.arc[0] = Arc{0, L, L, 0, -1, -1};
    y.fixed = L;
  } else if (c == 0) {
    const int n = 2 * y.q1 - 1;
    y.arc[0] = Arc{(2 * Q - y.q1) % L, n, n + 2, 0, 1, 1};
    y.fixed = n + 2;
  } else if (c == C - 1) {
    const int n = 2 * (Q - y.q0);
    y.arc[0] = Arc{y.q0, n, n + 2, 0, c - 1, c - 1};
  } else {
    const int n = y.q1 - y.q0;
    y.arc[0] = Arc{y.q0, n, n + 2, 0, c - 1, c + 1};
    y.arc[1] = Arc{2 * Q - y.q1, n, n + 2, n + 2, c + 1, c - 1};
    y.narcs = 2;
  }
  return y;
}

// The arc of CTA d that takes the columns CTA c sends it.
__device__ __forceinline__ int recv_arc(int d, int c, int C) {
  return (d > 0 && d < C - 1 && c == d + 1) ? 1 : 0;
}

__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// The arc and arc position of cycle position t in `y` (false: not held).
__device__ __forceinline__ bool locate(const Layout& y, int t, int L, int* a,
                                       int* u) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i >= y.narcs) break;
    const int uu = wrap(t - y.arc[i].t0, L);
    if (uu < y.arc[i].n) {
      *a = i;
      *u = uu;
      return true;
    }
  }
  return false;
}

// The buffer of arc position u of arc a in the round whose arcs' shifts are
// rm0, rm1 (selects, so that the layout stays in registers).
__device__ __forceinline__ int buffer_of(const Layout& y, int a, int u,
                                         int rm0, int rm1) {
  return a == 0 ? y.arc[0].base + wrap(u - rm0, y.arc[0].nb)
                : y.arc[1].base + wrap(u - rm1, y.arc[1].nb);
}

// A CTA's slot: an arc position (its buffer and column move with the
// round) or the fixed column.
struct Slot {
  int arc, u, t;  // arc -1: the fixed column
};

// Mailbox of CTA c toward its neighbour on side dir (1: right) for round
// R: a slot by the round's parity (a neighbour is at most one round
// behind the sender).
__device__ __forceinline__ int mailbox(int c, int dir, int R) {
  return (c * 2 + dir) * 2 + (R & 1);
}

// A column of this CTA's shared memory to global memory, at the L2 (its
// reader is another SM).
__device__ __forceinline__ void store_column(double* dst, const double* src,
                                             int chunks) {
  double2* d = reinterpret_cast<double2*>(dst);
  const double2* s = reinterpret_cast<const double2*>(src);
  for (int ch = threadIdx.x; ch < chunks; ch += blockDim.x)
    __stcg(d + ch, s[ch]);
}

// Up to two mailbox columns into their buffers, every thread's loads of a
// batch issued before its stores (one trip to the L2, not one a chunk).
__device__ __forceinline__ void fetch(double* d0, const double* s0,
                                      double* d1, const double* s1,
                                      int chunks) {
  const double2* a = reinterpret_cast<const double2*>(s0);
  const double2* b = reinterpret_cast<const double2*>(s1);
  double2* x = reinterpret_cast<double2*>(d0);
  double2* y = reinterpret_cast<double2*>(d1);
  for (int base = threadIdx.x; base < chunks;
       base += blockDim.x * kInFlight) {
    double2 va[kInFlight], vb[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int ch = base + u * blockDim.x;
      if (ch < chunks) {
        va[u] = __ldcg(a + ch);
        if (b) vb[u] = __ldcg(b + ch);
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int ch = base + u * blockDim.x;
      if (ch < chunks) {
        x[ch] = va[u];
        if (b) y[ch] = vb[u];
      }
    }
  }
}

// The ring layout (see the header): each CTA's arcs of columns in its
// shared memory, the columns that leave an arc in round R - 1 sent at the
// start of round R, into the peer's buffer (st.async, counted on its
// mbarrier for the round's parity) inside a cluster or through a mailbox
// (a slot by the round's parity and a flag the neighbour polls) between
// clusters.
template <bool kTimed>
__global__ void __launch_bounds__(kRingWarps * 32)
top_singular_ring_kernel(Params P) {
  extern __shared__ __align__(16) double ring_smem[];
  double* smem = ring_smem;
  __shared__ double part[kRingWarps * 3];
  __shared__ __align__(8) unsigned long long mbar[2];
  __shared__ int rot_s;
  __shared__ unsigned red_s;
  __shared__ double warp_sq[kRingWarps];
  __shared__ double small_s, sigma_s;
  __shared__ double best_v[kRingWarps];
  __shared__ int best_i[kRingWarps], best_b[kRingWarps];
  __shared__ int top_b, winner_s;
  __shared__ long long s_prof[kStages];
  __shared__ unsigned long long rot_count;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int c = blockIdx.x, G = gridDim.x;
  const int p = P.p, k = P.k, kk = k + (k & 1), Q = kk / 2, L = kk - 1;
  const int np = P.pairs, wp = P.pair_warps, Cr = P.ring_ctas;
  const int cs = P.colstride, cl = P.cluster, chunks = cs / 2;
  const bool in_ring = c < Cr;
  const int poller = blockDim.x > 32 ? 32 : 0;
  double* mbox = P.work;
  unsigned long long* flags =
      reinterpret_cast<unsigned long long*>(mbox + (size_t)Cr * 4 * cs);
  double* fro = reinterpret_cast<double*>(flags + (size_t)Cr * 4);
  double* best = fro + G;
  // 16-byte aligned: it is copied in double2
  double* topcol =
      mbox + (((size_t)Cr * 4 * (cs + 1) + 3 * G + 1) & ~(size_t)1);
  Clock<kTimed> clk{s_prof, 0, kTimed && c == 0 && tid == 0};

  const Layout y = ring_layout(c, Cr, Q, np);
  const int pw = warp / wp, sub = warp % wp;
  const int q = y.q0 + pw;
  const bool has_pair = in_ring && q < y.q1;
  Slot ss{-1, 0, 0}, sf{-1, 0, 0};
  if (has_pair) {
    ss.t = q;
    locate(y, q, L, &ss.arc, &ss.u);
    if (q > 0) {
      sf.t = 2 * Q - 1 - q;
      locate(y, sf.t, L, &sf.arc, &sf.u);
    }
  }

  double sq = 0.0;
  if (in_ring) {
    const int held = y.arc[0].n + (y.narcs > 1 ? y.arc[1].n : 0);
    const int cols = held + ((y.fixed >= 0 && kk - 1 < k) ? 1 : 0);
    for (int e = 0; e < cols; ++e) {
      int b, col;
      if (e < held) {
        const int a = e < y.arc[0].n ? 0 : 1;
        const int u = a ? e - y.arc[0].n : e;
        b = buffer_of(y, a, u, 0, 0);
        col = wrap(-(((a ? y.arc[1].t0 : y.arc[0].t0) + u) % L), L);
      } else {
        b = y.fixed;
        col = kk - 1;
      }
      double* dst = smem + (size_t)b * cs;
      for (int t = tid; t < cs; t += blockDim.x) {
        double x;
        if (t < p) {
          x = a_element(P, t, col);
          sq = add(sq, mul(x, x));
        } else {
          x = (t - p == col) ? 1.0 : 0.0;
        }
        dst[t] = x;
      }
    }
    if (tid < 4) atomicExch(flags + mailbox(c, tid >> 1, tid), 0ull);
  }
  sq = warp_sum(sq);
  if (lane == 0) warp_sq[warp] = sq;
  if (tid == 0) {
    rot_s = 0;
    rot_count = 0;
    if (cl > 1) {
      mbarrier_init(smem_address(&mbar[0]));
      mbarrier_init(smem_address(&mbar[1]));
      mbarrier_init_fence();
    }
  }
  __syncthreads();
  if (tid == 0) {
    double part_sq = 0.0;
    for (int w = 0; w < nwarps; ++w) part_sq = add(part_sq, warp_sq[w]);
    __stcg(fro + c, part_sq);
  }
  if (cl > 1) cluster_sync();
  grid_barrier(P.sync, 0u, &red_s);
  if (tid == 0) {
    double fro2 = 0.0;
    for (int b = 0; b < G; ++b) fro2 = add(fro2, __ldcg(fro + b));
    small_s = ldexp(fro2, -104);
  }
  __syncthreads();
  const double small = small_s;
  if (clk.on) {
    for (int s = 0; s < kStages; ++s) s_prof[s] = 0;
    clk.last = clock64();
  }

  int R = 0, Rl = 0, rm0 = 0, rm1 = 0;
  int sweeps = 0;
  bool converged = false;
  while (sweeps < P.max_sweeps) {
    ++sweeps;
    for (int r = 0; in_ring && r < L; ++r, ++R) {
      if (R > 0) {
        __syncthreads();
        clk.tick(kRotate);
        bool mail = false;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          if (a >= y.narcs || y.arc[a].out < 0) continue;
          const int d = y.arc[a].out;
          const double* src =
              smem + (size_t)buffer_of(y, a, y.arc[a].n - 1, rm0, rm1) * cs;
          if (cl > 1 && d / cl == c / cl) {
            const Layout yd = ring_layout(d, Cr, Q, np);
            const bool second = recv_arc(d, c, Cr);
            const int dbase = second ? yd.arc[1].base : yd.arc[0].base;
            const int dnb = second ? yd.arc[1].nb : yd.arc[0].nb;
            const int slot = dbase + wrap(-(R % dnb), dnb);
            const uint32_t dst =
                peer_address(smem_address(smem + (size_t)slot * cs), d % cl);
            const uint32_t bar =
                peer_address(smem_address(&mbar[R & 1]), d % cl);
            const double2* s2 = reinterpret_cast<const double2*>(src);
            for (int ch = tid; ch < chunks; ch += blockDim.x) {
              const double2 v = s2[ch];
              send16(dst + 16u * ch, bar, __double_as_longlong(v.x),
                     __double_as_longlong(v.y));
            }
          } else {
            store_column(mbox + (size_t)mailbox(c, d > c, R) * cs, src,
                         chunks);
            mail = true;
          }
        }
        if (mail) {
          __syncthreads();
          if (tid == 0) {
#pragma unroll
            for (int a = 0; a < 2; ++a) {
              const int d = a < y.narcs ? y.arc[a].out : -1;
              if (d >= 0 && !(cl > 1 && d / cl == c / cl))
                st_release64(flags + mailbox(c, d > c, R),
                             (unsigned long long)R);
            }
          }
        }
        clk.tick(kSend);
        Rl = Rl + 1 == L ? 0 : Rl + 1;
        rm0 = rm0 + 1 == y.arc[0].nb ? 0 : rm0 + 1;
        if (y.narcs > 1) rm1 = rm1 + 1 == y.arc[1].nb ? 0 : rm1 + 1;
        int bytes = 0;
        double *d0 = nullptr, *d1 = nullptr;
        const double *s0 = nullptr, *s1 = nullptr;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int e = a < y.narcs ? y.arc[a].in : -1;
          if (e < 0) continue;
          if (cl > 1 && e / cl == c / cl) {
            bytes += cs * 8;
          } else {
            const int box = mailbox(e, c > e, R);
            if (tid == poller) {
              Stall stall;
              while (ld_acquire64(flags + box) != (unsigned long long)R)
                stall.check();
            }
            double* d = smem + (size_t)buffer_of(y, a, 0, rm0, rm1) * cs;
            if (d0 == nullptr) {
              d0 = d;
              s0 = mbox + (size_t)box * cs;
            } else {
              d1 = d;
              s1 = mbox + (size_t)box * cs;
            }
          }
        }
        if (bytes) {
          const uint32_t bar = smem_address(&mbar[R & 1]);
          if (tid == 0) mbarrier_expect(bar, bytes);
          mbarrier_wait_checked(bar, ((R - 1) >> 1) & 1);
        }
        if (d0) {
          __syncthreads();
          fetch(d0, s0, d1, s1, chunks);
        }
        __syncthreads();
        clk.tick(kWait);
      }
      double *ci = nullptr, *cj = nullptr;
      bool live = false;
      if (has_pair) {
        const int bs = buffer_of(y, ss.arc, ss.u, rm0, rm1);
        const int cols = wrap(Rl - ss.t, L);
        int bf, colf;
        if (sf.arc < 0) {
          bf = y.fixed;
          colf = kk - 1;
        } else {
          bf = buffer_of(y, sf.arc, sf.u, rm0, rm1);
          colf = wrap(Rl - sf.t, L);
        }
        live = (cols < colf ? colf : cols) < k;
        ci = smem + (size_t)(cols < colf ? bs : bf) * cs;
        cj = smem + (size_t)(cols < colf ? bf : bs) * cs;
      }
      double al = 0.0, be = 0.0, ga = 0.0;
      if (live) {
        dots<false>(ci, cj, p, sub * 32 + lane, wp * 32, &al, &be, &ga);
        al = warp_sum(al);
        be = warp_sum(be);
        ga = warp_sum(ga);
        if (lane == 0) {
          part[warp * 3] = al;
          part[warp * 3 + 1] = be;
          part[warp * 3 + 2] = ga;
        }
      }
      if (wp > 1) __syncthreads();
      clk.tick(kDots);
      if (live) {
        if (wp > 1) {
          const int w0 = pw * wp;
          al = part[w0 * 3];
          be = part[w0 * 3 + 1];
          ga = part[w0 * 3 + 2];
          for (int s = 1; s < wp; ++s) {
            al = add(al, part[(w0 + s) * 3]);
            be = add(be, part[(w0 + s) * 3 + 1]);
            ga = add(ga, part[(w0 + s) * 3 + 2]);
          }
        }
        double cr, sr;
        if (rotation(al, be, ga, P.tol, small, &cr, &sr)) {
          rotate_columns<false>(ci, cj, p + k, sub * 32 + lane, wp * 32, cr,
                                sr);
          if (lane == 0 && sub == 0) {
            rot_s = 1;
            if (kTimed) atomicAdd(&rot_count, 1ull);
          }
        }
      }
    }
    __syncthreads();
    clk.tick(kRotate);
    const unsigned total = grid_barrier(P.sync, rot_s ? 1u : 0u, &red_s);
    if (tid == 0) rot_s = 0;
    clk.tick(kSweep);
    if (total == 0) {
      converged = true;
      break;
    }
  }

  double bv = -1.0;
  int bi = 0, bb = 0;
  if (in_ring) {
    const int held = y.arc[0].n + (y.narcs > 1 ? y.arc[1].n : 0);
    const int cols = held + ((y.fixed >= 0 && kk - 1 < k) ? 1 : 0);
    for (int e = warp; e < cols; e += nwarps) {
      int b, col;
      if (e < held) {
        const int a = e < y.arc[0].n ? 0 : 1;
        const int u = a ? e - y.arc[0].n : e;
        b = buffer_of(y, a, u, rm0, rm1);
        col = wrap(Rl - ((a ? y.arc[1].t0 : y.arc[0].t0) + u) % L, L);
      } else {
        b = y.fixed;
        col = kk - 1;
      }
      const double nrm = column_norm<false>(smem + (size_t)b * cs, p, lane);
      if (nrm > bv || (nrm == bv && col < bi)) {
        bv = nrm;
        bi = col;
        bb = b;
      }
    }
  }
  if (lane == 0) {
    best_v[warp] = bv;
    best_i[warp] = bi;
    best_b[warp] = bb;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < nwarps; ++w)
      if (best_v[w] > bv || (best_v[w] == bv && best_i[w] < bi)) {
        bv = best_v[w];
        bi = best_i[w];
        bb = best_b[w];
      }
    top_b = bb;
    __stcg(best + 2 * c, bv);
    __stcg(best + 2 * c + 1, (double)bi);
  }
  grid_barrier(P.sync, 0u, &red_s);
  if (tid == 0) {
    double gv = -1.0;
    int gi = 0, gw = 0;
    for (int b = 0; b < G; ++b) {
      const double v = __ldcg(best + 2 * b);
      const int i = (int)__ldcg(best + 2 * b + 1);
      if (v > gv || (v == gv && i < gi)) {
        gv = v;
        gi = i;
        gw = b;
      }
    }
    sigma_s = gv;
    winner_s = gw;
    if (c == 0) count_solve(P, sweeps, converged);
  }
  __syncthreads();
  if (c == winner_s)
    store_column(topcol, smem + (size_t)top_b * cs, chunks);
  grid_barrier(P.sync, 0u, &red_s);
  const double sigma = sigma_s;
  const long long mn = (long long)P.m * P.n;
  for (long long idx = (long long)c * blockDim.x + tid; idx < mn;
       idx += (long long)G * blockDim.x)
    store_vertex<true>(P, topcol, topcol + p, sigma, idx);
  if (clk.on) {
    for (int s = 0; s < kStages; ++s) P.prof[s] += s_prof[s];
    P.prof[kStages] += (long long)R;
    P.prof[kStages + 1] += sweeps;
  }
  if (kTimed && tid == 0) add_rotations(P, rot_count);
  if (cl > 1) cluster_meet();
}

using Kernel = void (*)(Params);

struct DeviceState {
  bool ready = false;
  int optin = 0;      // the dynamic shared bytes every kernel may take
  int grid_max = 0;   // the streamed CTAs that fit on the card at once
  int sms = 0;
  cudaFuncAttributes attr[3];  // resident, streamed, ring (untimed)
};
DeviceState g_state[kMaxDevices];

cudaError_t prepare_device(int dev) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceState& st = g_state[dev];
  if (st.ready) return cudaSuccess;
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const Kernel kernels[3] = {top_singular_kernel,
                             top_singular_grid_kernel<false>,
                             top_singular_ring_kernel<false>};
  int statics = 0;
  for (int i = 0; i < 3; ++i) {
    if ((e = cudaFuncGetAttributes(&st.attr[i], kernels[i])) != cudaSuccess)
      return e;
    if ((int)st.attr[i].sharedSizeBytes > statics)
      statics = (int)st.attr[i].sharedSizeBytes;
  }
  cudaFuncAttributes timed;
  if ((e = cudaFuncGetAttributes(&timed, top_singular_ring_kernel<true>)) !=
      cudaSuccess)
    return e;
  if ((int)timed.sharedSizeBytes > statics)
    statics = (int)timed.sharedSizeBytes;
  st.optin = optin - statics;
  const Kernel dynamic[3] = {top_singular_kernel,
                             top_singular_ring_kernel<false>,
                             top_singular_ring_kernel<true>};
  for (int i = 0; i < 3; ++i) {
    if ((e = cudaFuncSetAttribute(
             dynamic[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
             st.optin)) != cudaSuccess)
      return e;
    if (i > 0 &&
        (e = cudaFuncSetAttribute(
             dynamic[i], cudaFuncAttributeNonPortableClusterSizeAllowed,
             1)) != cudaSuccess)
      return e;
  }
  int per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&st.sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, top_singular_grid_kernel<false>, kGridWarps * 32, 0)) !=
      cudaSuccess)
    return e;
  st.grid_max = st.sms * per_sm;
  st.ready = true;
  return cudaSuccess;
}

// The ring's column buffers a CTA may hold (the middle CTAs' two open arcs
// of np + 2, the first CTA's arc of 2 np + 1 and its fixed column, the
// whole cycle and the fixed column on one CTA).
long long ring_buffers(int Q, int np, int C) {
  if (C == 1) return 2LL * Q;
  return C == 2 ? 2LL * np + 2 : 2LL * np + 4;
}

}  // namespace

extern "C" {

// The dynamic shared bytes a CTA of any layout may take into *out.
int top_singular_smem_limit(int device, int* out) {
  return (int)on_device(device, prepare_device, [&]() {
    *out = g_state[device].optin;
    return cudaSuccess;
  });
}

// The kernels as compiled: for the resident, streamed and ring kernels in
// turn, registers per thread, static shared bytes and local (spill) bytes
// per thread (9 ints).
int top_singular_info(int device, int* info) {
  return (int)on_device(device, prepare_device, [&]() {
    for (int i = 0; i < 3; ++i) {
      const cudaFuncAttributes& a = g_state[device].attr[i];
      info[3 * i] = a.numRegs;
      info[3 * i + 1] = (int)a.sharedSizeBytes;
      info[3 * i + 2] = (int)a.localSizeBytes;
    }
    return cudaSuccess;
  });
}

// How many ring clusters of `cluster` CTAs of `threads` threads and
// `smem` dynamic shared bytes the card holds at once, into *active.
int top_singular_active_clusters(int device, int cluster, int threads,
                                 int smem, int* active) {
  return (int)on_device(device, prepare_device, [&]() {
    if (smem > g_state[device].optin) return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(cfg, attr, cluster, cluster, threads, (size_t)smem,
                   nullptr);
    return cudaOccupancyMaxActiveClusters(
        active, top_singular_ring_kernel<false>, &cfg);
  });
}

// One solve of the m x n matrix g, laid out by `layout`: kind (0 resident,
// 1 streamed, 2 ring), warps a CTA, CTAs, pairs a CTA, warps a pair, CTAs
// a cluster, dynamic shared bytes a CTA.  Resident: one CTA, A, V and the
// norms in its shared memory.  Streamed: a cooperative grid of CTAs of at
// most kGridWarps warps over `scratch`, work_bytes long: A, V, the norms,
// a partial sum a CTA and two 8-byte flags.  Ring: the CTAs' columns in
// their shared memory, `scratch` the mailboxes (4 columns a CTA of the
// ring), their flags, a partial sum and a best norm a CTA and the top
// column; `sync` the barrier's four words, zero before the first launch;
// a cooperative grid where the cluster is 1, else a cluster launch that
// the card must hold at once.  `prof`, if not null, takes the timed
// instance of a streamed or ring launch: kStages + 3 int64 (the stages'
// clocks, the rounds, the sweeps, the rotations) that it adds to; a
// resident launch adds only the rotations.
int top_singular_run(const void* g, int m, int n, const int* layout,
                     long long work_bytes, double tol, int max_sweeps,
                     void* scratch, void* sync, void* s_out,
                     void* sweeps_out, void* stats, void* prof, int device,
                     void* stream) {
  const int kind = layout[0], warps = layout[1], ctas = layout[2];
  const int np = layout[3], wp = layout[4], cl = layout[5];
  const long long smem = layout[6];
  if (m < 1 || n < 1 || warps < 1 || ctas < 1 || max_sweeps < 1 ||
      kind < kResident || kind > kRing)
    return (int)cudaErrorInvalidValue;
  const int p = m > n ? m : n, k = m < n ? m : n;
  const int kk = k + (k & 1), Q = kk / 2;
  const int cs = (p + k + 1) & ~1;
  int ring_ctas = 0;
  if (kind == kResident) {
    if (warps > kMaxWarps || ctas != 1 ||
        smem < 8LL * ((long long)p * k + (long long)k * k + k))
      return (int)cudaErrorInvalidValue;
  } else if (kind == kStreamed) {
    if (warps > kGridWarps || scratch == nullptr ||
        work_bytes < 8LL * ((long long)p * k + (long long)k * k + k + ctas +
                            2))
      return (int)cudaErrorInvalidValue;
  } else {
    if (np < 1 || wp < 1 || warps != np * wp || warps > kRingWarps ||
        cl < 1 || cl > kMaxCluster || ctas % cl != 0 || scratch == nullptr ||
        sync == nullptr)
      return (int)cudaErrorInvalidValue;
    ring_ctas = (Q + np - 1) / np;
    if (ring_ctas > ctas || smem < 8LL * cs * ring_buffers(Q, np, ring_ctas) ||
        work_bytes < 8LL * ((((long long)ring_ctas * 4 * (cs + 1) +
                              3LL * ctas + 1) & ~1LL) + cs))
      return (int)cudaErrorInvalidValue;
  }
  return (int)on_device(device, prepare_device, [&]() {
    const DeviceState& ds = g_state[device];
    if (smem > ds.optin) return cudaErrorInvalidValue;
    if (kind == kStreamed && ctas > ds.grid_max)
      return cudaErrorCooperativeLaunchTooLarge;
    Params P{static_cast<const double*>(g), m, n, p, k, m < n ? 1 : 0, tol,
             max_sweeps, static_cast<double*>(scratch),
             static_cast<double*>(s_out),
             static_cast<long long*>(sweeps_out),
             static_cast<unsigned long long*>(stats), np, wp, cl, ring_ctas,
             cs, static_cast<unsigned*>(sync),
             static_cast<long long*>(prof)};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (kind == kResident) {
      top_singular_kernel<<<1, warps * 32, (size_t)smem, st>>>(P);
      return cudaGetLastError();
    }
    void* args[] = {&P};
    if (kind == kStreamed)
      return cudaLaunchCooperativeKernel(
          reinterpret_cast<void*>(prof ? top_singular_grid_kernel<true>
                                       : top_singular_grid_kernel<false>),
          dim3(ctas), dim3(warps * 32), args, 0, st);
    const Kernel kern = prof ? top_singular_ring_kernel<true>
                             : top_singular_ring_kernel<false>;
    if (cl == 1)
      return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern),
                                         dim3(ctas), dim3(warps * 32), args,
                                         (size_t)smem, st);
    // every CTA waits on its neighbours: the card must hold the whole grid
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(cfg, attr, ctas, cl, warps * 32, (size_t)smem, stream);
    int active = 0;
    cudaError_t e = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
    if (e != cudaSuccess) return e;
    if (active * cl < ctas) return cudaErrorCooperativeLaunchTooLarge;
    return cudaLaunchKernelEx(&cfg, kern, P);
  });
}

// The stages a timed launch clocks.
int top_singular_stages() { return kStages; }

const char* top_singular_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
