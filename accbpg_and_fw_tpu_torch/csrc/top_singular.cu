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
//     columns, so they rotate at once, one warp a pair;
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
// dot products of length p over a warp's lanes, a butterfly, and two
// column updates, behind a barrier.  At SymNMF's 200 x 20 (the nuclear
// ball's problem in chip_smoke.py) a solve is ~8 sweeps of 19 rounds, ~6 p
// FP64 operations a pair for the dots and 6 p for the rotation: ~2 MFLOP,
// ~0.03 us of the card's FP64 rate, and 32 KB to read.  The chain of rounds
// and barriers is the time.  Two layouts:
//   * "resident" (where A, V and the column norms fit in one CTA's shared
//     memory: p k + k^2 + k doubles): one CTA of up to 32 warps, so a
//     round ends at a block barrier and its passes read no global memory;
//   * "streamed" (past that): A, V and the norms in a global scratch that
//     the L2 holds, and a cooperative grid of CTAs of a few warps, a warp a
//     pair across the SMs, a round ending at a grid barrier.  One CTA's
//     L2 traffic would bound a large g: at 1000 x 1000 a round moves 32 MB.
// In both the warp's three sums are an xor butterfly: every lane ends with
// the same bits, so the rotate-or-not branch is uniform in the warp and
// the kernel is deterministic (a graph's rows equal the eager loop's); a
// pair's arithmetic is the same in both layouts.
// Thread 0 of the first CTA adds to three device int64s: the launches (a
// graph's replays count there), the solves that ended at max_sweeps, and
// the most sweeps a solve took; each launch also writes its sweep count.
//
// Interface: plain C, loaded with ctypes.  The wrapper allocates the output
// and the scratch with torch.empty; the kernel launches on the caller's
// stream.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cmath>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDevices = 64;
constexpr int kMaxWarps = 32;      // a resident CTA's warps
constexpr int kGridWarps = 4;      // a streamed CTA's warps
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const double* g;          // m x n, row-major
  int m, n, p, k;
  int transposed;           // A = g^T
  double tol;
  int max_sweeps;
  double* work;             // streamed: A, V, norms, partial sums, flags
  double* s;                // m x n, row-major
  long long* sweeps_out;
  unsigned long long* stats;  // launches, solves at the bound, most sweeps
};

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

// A column pass of one warp's lane: its elements t = lane, lane + 32, ...
// of [0, len), kBatch at a time: the batch's loads are issued together,
// then applied in t's order, so the sums round as a plain loop's would.
constexpr int kBatch = 8;

// (ci, cj) <- (c ci - s cj, s ci + c cj) over [0, len), by one warp.
template <bool kL2>
__device__ __forceinline__ void rotate_columns(double* ci, double* cj,
                                               int len, int lane, double c,
                                               double s) {
  int t = lane;
  for (; t + 32 * (kBatch - 1) < len; t += 32 * kBatch) {
    double x[kBatch], y[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      x[u] = ld<kL2>(ci + t + 32 * u);
      y[u] = ld<kL2>(cj + t + 32 * u);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      st<kL2>(ci + t + 32 * u, sub(mul(c, x[u]), mul(s, y[u])));
      st<kL2>(cj + t + 32 * u, add(mul(s, x[u]), mul(c, y[u])));
    }
  }
  for (; t < len; t += 32) {
    const double x = ld<kL2>(ci + t), y = ld<kL2>(cj + t);
    st<kL2>(ci + t, sub(mul(c, x), mul(s, y)));
    st<kL2>(cj + t, add(mul(s, x), mul(c, y)));
  }
}

// One warp's pair: rotates columns i < j of A (p long) and V (k long) to
// orthogonality where they are not yet; true if it rotated.
template <bool kL2>
__device__ bool rotate_pair(double* A, double* V, int p, int k, int i, int j,
                            int lane, double tol, double small) {
  double* ai = A + (size_t)i * p;
  double* aj = A + (size_t)j * p;
  double al = 0.0, be = 0.0, ga = 0.0;
  int t = lane;
  for (; t + 32 * (kBatch - 1) < p; t += 32 * kBatch) {
    double x[kBatch], y[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      x[u] = ld<kL2>(ai + t + 32 * u);
      y[u] = ld<kL2>(aj + t + 32 * u);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      al = add(al, mul(x[u], x[u]));
      be = add(be, mul(y[u], y[u]));
      ga = add(ga, mul(x[u], y[u]));
    }
  }
  for (; t < p; t += 32) {
    const double x = ld<kL2>(ai + t), y = ld<kL2>(aj + t);
    al = add(al, mul(x, x));
    be = add(be, mul(y, y));
    ga = add(ga, mul(x, y));
  }
  al = warp_sum(al);
  be = warp_sum(be);
  ga = warp_sum(ga);
  if (!(al > small && be > small && fabs(ga) > tol * sqrt(al) * sqrt(be)))
    return false;
  const double zeta = (be - al) / (2.0 * ga);
  const double tn = copysign(1.0, zeta) / (fabs(zeta) + hypot(1.0, zeta));
  const double c = 1.0 / sqrt(add(1.0, mul(tn, tn)));
  const double s = mul(c, tn);
  rotate_columns<kL2>(ai, aj, p, lane, c, s);
  rotate_columns<kL2>(V + (size_t)i * k, V + (size_t)j * k, k, lane, c, s);
  return true;
}

// Column j's norm, by one warp.
template <bool kL2>
__device__ __forceinline__ double column_norm(const double* A, int p, int j,
                                              int lane) {
  const double* aj = A + (size_t)j * p;
  double nrm = 0.0;
  for (int t = lane; t < p; t += 32) {
    const double x = ld<kL2>(aj + t);
    nrm = add(nrm, mul(x, x));
  }
  return sqrt(warp_sum(nrm));
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

// Element idx of s = outer(u1, v1) (outer(e1, e1) where sigma_1 = 0).
template <bool kL2>
__device__ __forceinline__ void store_vertex(const Params& P, const double* A,
                                             const double* V, int top,
                                             double sigma, long long idx) {
  const long long r = idx / P.n, c = idx % P.n;
  const double* u = A + (size_t)top * P.p;
  const double* v = V + (size_t)top * P.k;
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

// The resident layout: one CTA, A, V and the norms in shared memory.
__global__ void __launch_bounds__(kMaxWarps * 32)
top_singular_kernel(Params P) {
  extern __shared__ double smem[];
  __shared__ int rotated;
  __shared__ int top_s;
  __shared__ double warp_sq[kMaxWarps];
  __shared__ double small_s;
  const int p = P.p, k = P.k;
  double* A = smem;                     // column j at A + j p
  double* V = A + (size_t)p * k;        // column j at V + j k
  double* norms = V + (size_t)k * k;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long mn = (long long)P.m * P.n;

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
  if (tid == 0) rotated = 0;
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
            rotate_pair<false>(A, V, p, k, i, j, lane, P.tol, small) &&
            lane == 0)
          rotated = 1;
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
    const double nrm = column_norm<false>(A, p, j, lane);
    if (lane == 0) norms[j] = nrm;
  }
  __syncthreads();
  if (tid == 0) {
    int top = 0;
    for (int j = 1; j < k; ++j)
      if (norms[j] > norms[top]) top = j;
    top_s = top;
    count_solve(P, sweeps, converged);
  }
  __syncthreads();
  const int top = top_s;
  for (long long idx = tid; idx < mn; idx += blockDim.x)
    store_vertex<false>(P, A, V, top, norms[top], idx);
}

// The streamed layout: a cooperative grid, A, V, the norms, one partial
// sum of ||g||_F^2 a CTA and two "rotated" flags (one a sweep, by parity)
// in the scratch P.work; a round ends at a grid barrier.
__global__ void __launch_bounds__(kGridWarps * 32)
top_singular_grid_kernel(Params P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double warp_sq[kGridWarps];
  __shared__ double small_s;
  __shared__ int any_s;
  __shared__ double best_v[kGridWarps];
  __shared__ int best_i[kGridWarps];
  __shared__ int top_s;
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
            rotate_pair<true>(A, V, p, k, i, j, lane, P.tol, small) &&
            lane == 0)
          atomicExch(flag, 1u);
      }
      grid.sync();
    }
    if (tid == 0) any_s = (int)atomicAdd(flag, 0u);
    __syncthreads();
    if (!any_s) {  // the same in every CTA: no write since the barrier
      converged = true;
      break;
    }
    grid.sync();  // every CTA has read the flag: clear it for sweep + 2
    if (gtid == 0) atomicExch(flag, 0u);
  }

  for (int j = gwarp; j < k; j += gwarps) {
    const double nrm = column_norm<true>(A, p, j, lane);
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
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    best_v[warp] = bv;
    best_i[warp] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < nwarps; ++w)
      if (best_v[w] > bv || (best_v[w] == bv && best_i[w] < bi)) {
        bv = best_v[w];
        bi = best_i[w];
      }
    top_s = bi;
    if (blockIdx.x == 0) count_solve(P, sweeps, converged);
  }
  __syncthreads();
  const int top = top_s;
  const double sigma = __ldcg(norms + top);
  for (long long idx = gtid; idx < mn; idx += nthreads)
    store_vertex<true>(P, A, V, top, sigma, idx);
}

struct DeviceState {
  bool ready = false;
  int optin = 0;  // the shared bytes a CTA may opt in to
  int grid_max = 0;  // the streamed CTAs that fit on the card at once
};
DeviceState g_state[kMaxDevices];

cudaError_t prepare_device(int dev) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceState& st = g_state[dev];
  if (st.ready) return cudaSuccess;
  cudaError_t e = cudaDeviceGetAttribute(
      &st.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  if ((e = cudaFuncGetAttributes(&attr, top_singular_kernel)) != cudaSuccess)
    return e;
  e = cudaFuncSetAttribute(top_singular_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           st.optin - (int)attr.sharedSizeBytes);
  if (e != cudaSuccess) return e;
  st.optin -= (int)attr.sharedSizeBytes;
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, top_singular_grid_kernel, kGridWarps * 32, 0)) !=
      cudaSuccess)
    return e;
  st.grid_max = sms * per_sm;
  st.ready = true;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The dynamic shared bytes a resident CTA may take into *out.
int top_singular_smem_limit(int device, int* out) {
  return (int)on_device(device, prepare_device, [&]() {
    *out = g_state[device].optin;
    return cudaSuccess;
  });
}

// One solve of the m x n matrix g.  Resident: one CTA of `warps` warps,
// A, V and the norms in its shared memory (work_bytes of them).  Streamed:
// a cooperative grid of `ctas` CTAs of `warps` warps (at most kGridWarps)
// over `scratch`, work_bytes long: A, V, the norms, a partial sum a CTA
// and two 8-byte flags.
int top_singular_run(const void* g, int m, int n, int warps, int ctas,
                     int resident, long long work_bytes, double tol,
                     int max_sweeps, void* scratch, void* s_out,
                     void* sweeps_out, void* stats, int device,
                     void* stream) {
  if (m < 1 || n < 1 || warps < 1 || ctas < 1 || max_sweeps < 1 ||
      warps > (resident ? kMaxWarps : kGridWarps) ||
      (resident && ctas != 1) || (!resident && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const int p = m > n ? m : n, k = m < n ? m : n;
  const long long need = 8ll * ((long long)p * k + (long long)k * k + k +
                                (resident ? 0 : ctas + 2));
  if (work_bytes < need) return (int)cudaErrorInvalidValue;
  return (int)on_device(device, prepare_device, [&]() {
    if (resident && work_bytes > g_state[device].optin)
      return cudaErrorInvalidValue;
    if (!resident && ctas > g_state[device].grid_max)
      return cudaErrorCooperativeLaunchTooLarge;
    Params P{static_cast<const double*>(g), m, n, p, k, m < n ? 1 : 0, tol,
             max_sweeps, resident ? nullptr : static_cast<double*>(scratch),
             static_cast<double*>(s_out),
             static_cast<long long*>(sweeps_out),
             static_cast<unsigned long long*>(stats)};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (resident) {
      top_singular_kernel<<<1, warps * 32, (size_t)work_bytes, st>>>(P);
      return cudaGetLastError();
    }
    void* args[] = {&P};
    return cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(top_singular_grid_kernel), dim3(ctas),
        dim3(warps * 32), args, 0, st);
  });
}

const char* top_singular_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
