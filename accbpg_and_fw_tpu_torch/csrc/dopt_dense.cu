// Dense launch block of the D-optimal design Frank-Wolfe(-away) solver, for
// B independent instances, in FP64 for Hopper (sm_90a).
//
// Replaces the TPU kernels accbpg_and_fw_tpu/ops/pallas_dopt.py ::
// _fw_kernel_body (one instance) and _fw_kernel_body_b (B instances in
// lockstep).  One launch runs up to kmax iterations per instance on the
// full inverse H: pivots, slack stop test, step sizes, g = H V[:,v],
// u = g^T V with the pin u[v] = w[v], w <- (w - c u^2) / (1 - tau),
// H <- (H - c g g^T) / (1 - tau), the x step with an exact zero on an away
// drop, and per-row tau, tau (w_v - 1), SP, SN and pivot.  An instance
// that stops (or entered done) is frozen: its remaining rows repeat its
// slacks with tau = 0.  The plain PyTorch version is
// ops/dopt_dense.py::dense_block_reference.
//
// What bounds it: an iteration is O(m n + m^2) work behind a chain of
// dependent steps (pivots -> column v -> g -> u -> next pivots), so at the
// sweep sizes (m ~ 30-160, n ~ 1000) the chain's latency sets the time,
// not the bytes.  The TPU ran the B instances in lockstep only because of
// its vector layout; here they are independent, and the design keeps every
// step of the chain on the SMs that run the instance:
//
// * a thread-block cluster of C CTAs per instance (the grid is B clusters;
//   the layout comes from ops/dopt_dense.py::dense_plan).  CTA r owns
//   columns [r chunk, (r + 1) chunk) of V for the whole launch and keeps
//   them, with their w and x, in its shared memory; they go to global
//   memory once, at the end;
// * every CTA keeps its own copy of H and computes g = H v and the rank-1
//   update itself, in the same fixed order: the same bits in every CTA,
//   and no exchange of g;
// * one exchange per iteration, in one stage: every warp sends its pivot
//   candidates (max pair, min pair and x at its argmin) into a slot of
//   every CTA's shared memory (st.async through distributed shared memory,
//   which counts the bytes on the receiver's transaction barrier; a round
//   takes about 500 clocks, where a write followed by the cluster barrier
//   with release and acquire takes 1500 to 2000).  Every thread waits on
//   its CTA's barrier, merges the C W slots by an xor butterfly (ties at
//   the lowest index) and computes the step scalars redundantly.  Two sets
//   of slots and barriers are used in turn.  A stop is seen by every CTA
//   of the cluster in the same iteration: they leave together, after a
//   last cluster barrier;
// * the columns of both pivot candidates are read from their owners'
//   panels through distributed shared memory (no round trip to the L2) as
//   soon as the merge names them, so that the loads overlap the divisions
//   that decide which of the two the step takes;
// * g = H v gives a row to a group of lanes (a power of two, so that all
//   rows take one round at m = 30); the same thread updates the elements
//   of H it read; u walks a column of the panel with four running sums;
// * no floating-point atomics: pivots carry (value, index) and break ties
//   at the lowest index, every sum has a fixed order.
//
// Where H and a panel do not fit together (m toward 165), the plan keeps
// one CTA per instance with H in shared memory and V streamed from the L2
// (u by __ldg, column v from the V^T copy); beyond that H stays in global
// memory too.
//
// Interface: plain C, loaded with ctypes.  The wrapper allocates every
// buffer with torch.empty; the kernel allocates nothing and launches on
// the caller's stream.  The function attributes (the dynamic shared memory
// opt-in, at the device's maximum, and the cluster sizes above 8) are set
// once per device.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 16;
constexpr int kMaxSlots = 64;  // warps of a cluster (threads * cluster / 32)
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// A CTA's (or a warp's) pivot candidates: the largest w and the smallest
// eligible w with their column indices, and x at the latter.
struct alignas(16) Cand {
  double vmax, vmin, xmin;
  int imax, imin;
};
static_assert(sizeof(Cand) == 32, "a candidate travels as two 16-byte sends");

// The larger (smaller) value wins; on a tie the lower index, as
// torch.argmax/argmin and jnp.argmax/argmin do.  Indices are distinct, so
// the merge gives the same answer in any order.
__device__ __forceinline__ void merge(Cand& a, double vmax, int imax,
                                      double vmin, int imin, double xmin) {
  if (vmax > a.vmax || (vmax == a.vmax && imax < a.imax)) {
    a.vmax = vmax;
    a.imax = imax;
  }
  if (vmin < a.vmin || (vmin == a.vmin && imin < a.imin)) {
    a.vmin = vmin;
    a.imin = imin;
    a.xmin = xmin;
  }
}

// The merge of the 32 lanes' candidates, into every lane.  Only the two
// values go through the xor butterfly; the indices follow by one integer
// reduction each (the lowest index among the lanes that hold the winning
// value) and x by one shuffle from the lane that holds the argmin.
__device__ __forceinline__ void warp_merge(Cand& a) {
  double vmax = a.vmax, vmin = a.vmin;
  for (int off = 16; off > 0; off >>= 1) {
    const double hi = __shfl_xor_sync(kFull, vmax, off);
    const double lo = __shfl_xor_sync(kFull, vmin, off);
    vmax = hi > vmax ? hi : vmax;
    vmin = lo < vmin ? lo : vmin;
  }
  const int imax = __reduce_min_sync(kFull, a.vmax == vmax ? a.imax : INT_MAX);
  const int imin = __reduce_min_sync(kFull, a.vmin == vmin ? a.imin : INT_MAX);
  const unsigned holders =
      __ballot_sync(kFull, a.vmin == vmin && a.imin == imin);
  a.xmin = __shfl_sync(kFull, a.xmin, __ffs(holders) - 1);
  a.vmax = vmax;
  a.imax = imax;
  a.vmin = vmin;
  a.imin = imin;
}

// One IEEE division for up to three independent quotients: lane q < 3
// divides its own pair and every lane gets the three results.  FP64
// division is a software sequence of about 130 clocks that does not
// overlap with another one in the same thread (and far longer on its slow
// path, which a zero numerator takes: an unused pair is 1 / 1).
__device__ __forceinline__ void divide3(int lane, double n0, double d0,
                                        double n1, double d1, double n2,
                                        double d2, double& q0, double& q1,
                                        double& q2) {
  const double num = lane == 1 ? n1 : (lane == 2 ? n2 : n0);
  const double den = lane == 1 ? d1 : (lane == 2 ? d2 : d0);
  const double q = num / den;
  q0 = __shfl_sync(kFull, q, 0);
  q1 = __shfl_sync(kFull, q, 1);
  q2 = __shfl_sync(kFull, q, 2);
}

struct Params {
  const double* V;      // (B, m, n) row-major
  const double* VT;     // (B, n, m), V^T per instance (read when streamed)
  const double* H_in;   // (B, m, m)
  const double* x_in;   // (B, n)
  const double* w_in;   // (B, n)
  const int* done_in;   // (B) instance entered done
  double* x;            // (B, n) out
  double* w;            // (B, n) out
  double* H;            // (B, m, m) out (the working H when not in smem)
  double* misc;         // (B, 3) out: done, iters, nrun
  double* hist;         // (B, 5, kmax) out: tau, tau (w_v - 1), SP, SN, v
  double eps, xtol;
  int m, n, kmax, away;
  int cluster;          // CTAs per instance
  int chunk;            // CTA r owns columns [r chunk, (r + 1) chunk)
  int h_in_smem;
  int row_lanes;        // lanes that share a row of H in g = H v
  long long* prof;      // kPhases sums of CTA 0's clocks (timed kernel)
};

// The phases that thread 0 of CTA 0 clocks when Params::prof is given.
enum Phase {
  kScan,      // the thread's columns and the merge of its warp
  kExchange,  // the candidates to every CTA, until all have landed
  kMerge,     // the merge of the cluster's candidates
  kScalars,   // the candidates' columns asked for, slacks and step scalars
  kColumns,   // the columns staged, the block barrier
  kG,         // g = H v, the block barrier
  kUpdate,    // H, u, w and x
  kPhases
};

// kResident: the plan keeps H, the panel, w and x in shared memory (every
// pointer to them is then a shared-memory pointer for the compiler).
// kTimed: thread 0 of CTA 0 clocks the phases into Params::prof.
template <bool kResident, bool kTimed>
__global__ void __launch_bounds__(kMaxThreads)
dopt_dense_kernel(Params p) {
  extern __shared__ double smem[];
  // two sets, used in turn, of one slot per warp of the cluster and of
  // the transaction barrier that counts what has landed in them
  __shared__ Cand s_slot[2][kMaxSlots];
  __shared__ alignas(8) unsigned long long s_barrier[2];
  __shared__ long long s_prof[kPhases];
  const int C = kResident ? p.cluster : 1;  // a streamed layout is one CTA
  const int rank = (int)blockIdx.x % C, b = (int)blockIdx.x / C;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, W = T >> 5;
  const int m = p.m, n = p.n, K = p.kmax;
  const size_t mm = (size_t)m * m;
  const double m_f = (double)m;
  cg::cluster_group cluster = cg::this_cluster();

  // this CTA's columns: [col0, col0 + nown)
  const int col0 = rank * p.chunk;
  const int nown = max(0, min(p.chunk, n - col0));
  const int ncp = p.chunk | 1;  // the panel's row stride: odd, so that a
                                // column's elements fall in distinct banks

  const double* V = p.V + (size_t)b * m * n;
  const double* VT = p.VT + (size_t)b * n * m;
  double* Hout = p.H + (size_t)b * mm;
  double* hist = p.hist + (size_t)b * 5 * K;
  double* s_cols = smem;     // the columns of the two pivot candidates
  double* s_g = smem + 2 * m;  // g = H v
  double* H = smem + 3 * m;
  double* panel = H + mm;    // rows of this CTA's columns, stride ncp
  double* w = panel + (size_t)m * ncp;  // indexed by the local column
  double* x = w + p.chunk;
  if (!kResident) {
    if (!p.h_in_smem) H = Hout;
    w = p.w + (size_t)b * n;
    x = p.x + (size_t)b * n;
  }

  for (int lj = tid; lj < nown; lj += T) {
    x[lj] = p.x_in[(size_t)b * n + col0 + lj];
    w[lj] = p.w_in[(size_t)b * n + col0 + lj];
  }
  for (size_t e = tid; e < mm; e += T) H[e] = p.H_in[(size_t)b * mm + e];
  if (kResident)
    for (int s = 0; s < m; ++s)
      for (int lj = tid; lj < nown; lj += T)
        panel[(size_t)s * ncp + lj] = V[(size_t)s * n + col0 + lj];
  const int slots = C * W;  // a power of two
  uint32_t peer_slot = 0, peer_barrier = 0;  // lane r < C: in CTA r
  if (C > 1) {
    if (tid == 0) {
      mbarrier_init(smem_address(&s_barrier[0]));
      mbarrier_init(smem_address(&s_barrier[1]));
      mbarrier_init_fence();
    }
    if (lane < C) {
      peer_slot = peer_address(smem_address(&s_slot[0][rank * W + warp]),
                               lane);
      peer_barrier = peer_address(smem_address(&s_barrier[0]), lane);
    }
  }
  __syncthreads();
  if (C > 1) cluster_sync();  // every peer's barriers are ready

  // g = H v: a group of G lanes shares a row, T / G rows make a round
  const int G = p.row_lanes, sub = tid & (G - 1), row_in_round = tid / G;
  const int rows_per_round = T / G;

  // phase clocks: one thread's view, the barriers' waits included
  const bool timed = kTimed && blockIdx.x == 0 && tid == 0;
  long long clock = 0;
  if (timed) {
    for (int q = 0; q < kPhases; ++q) s_prof[q] = 0;
    clock = clock64();
  }
  auto tick = [&](Phase phase) {
    if (kTimed && timed) {
      const long long now = clock64();
      s_prof[phase] += now - clock;
      clock = now;
    }
  };

  const bool entered = p.done_in[b] != 0;
  bool done = entered;
  double sp = 0.0, sn = 0.0;
  int k = 0;
  while (k < K) {
    const int set = k & 1;
    // ---- pivots: this thread's columns, its warp, the CTA, the cluster ---
    Cand best = {-INFINITY, INFINITY, 0.0, INT_MAX, INT_MAX};
    for (int lj = tid; lj < nown; lj += T) {
      const double wj = w[lj], xj = x[lj];
      const bool live = p.away ? (xj > p.xtol) : (xj > 0.0);
      merge(best, wj, col0 + lj, live ? wj : INFINITY,
            live ? col0 + lj : INT_MAX, xj);
    }
    warp_merge(best);
    tick(kScan);
    if (C == 1) {
      if (lane == 0) s_slot[set][warp] = best;
      __syncthreads();
    } else {
      const uint32_t barrier = smem_address(&s_barrier[set]);
      if (tid == 0) mbarrier_expect(barrier, (int)sizeof(Cand) * slots);
      if (lane < C) {
        const uint32_t to = peer_slot + set * (uint32_t)sizeof(s_slot[0]);
        const uint32_t bar =
            peer_barrier + set * (uint32_t)sizeof(s_barrier[0]);
        send16(to, bar, __double_as_longlong(best.vmax),
               __double_as_longlong(best.vmin));
        send16(to + 16, bar, __double_as_longlong(best.xmin),
               (long long)(unsigned)best.imax |
                   ((long long)best.imin << 32));
      }
      mbarrier_wait(barrier, (k >> 1) & 1);
    }
    tick(kExchange);
    // the slots are a power of two: the 32 lanes hold them all (more than
    // once where they are fewer), so every lane of the cluster ends with
    // the same merge
    best = s_slot[set][lane & (slots - 1)];
    for (int q = lane + 32; q < slots; q += 32) {
      const Cand o = s_slot[set][q];
      merge(best, o.vmax, o.imax, o.vmin, o.imin, o.xmin);
    }
    warp_merge(best);
    tick(kMerge);
    const double vmax = best.vmax, vmin = best.vmin;
    const int imax = best.imax, imin = best.imin;

    // ---- the columns of both candidates, from their owners' panels or from
    // the V^T copy, before the step is known: element s of the two columns
    // end to end.  A thread's first element waits in a register while the
    // divisions below run -----------------------------------------------------
    auto candidate_element = [&](int s) {
      const int col = s < m ? imax : imin, row = s < m ? s : s - m;
      if (col == INT_MAX) return 0.0;
      const int owner = col / p.chunk, lc = col - owner * p.chunk;
      const double* src =
          C > 1 ? cluster.map_shared_rank(panel, (unsigned)owner) : panel;
      return src[(size_t)row * ncp + lc];
    };
    double ahead = 0.0;
    if (kResident && tid < 2 * m) ahead = candidate_element(tid);

    // ---- slacks and step scalars (every warp, same bits): the seven
    // quotients in three rounds of one division each --------------------------
    const double xj = imin == INT_MAX ? 0.0 : best.xmin;
    double a1, a2, fw, unused;
    divide3(lane, vmax - m_f, m_f, m_f - vmin, m_f, xj, 1.0 - xj, sp, sn, a2);
    if (done || (sp <= p.eps && sn <= p.eps)) {
      done = true;  // uniform: every thread of the cluster merged the same
      break;
    }
    divide3(lane, sp, vmax - 1.0, sn, vmin - 1.0, 1.0, 1.0, fw, a1, unused);
    int v = imax;
    double wv = vmax, tau = fw;
    bool drop = false;
    if (p.away && !(sp >= sn)) {
      const bool use_a1 = a1 < a2;
      v = imin;
      wv = vmin;
      tau = -(use_a1 ? a1 : a2);
      drop = !use_a1;
    }
    const double wvm1 = wv - 1.0;
    double c, r;
    divide3(lane, tau, 1.0 + tau * wvm1, 1.0, 1.0 - tau, 1.0, 1.0, c, r,
            unused);
    if (rank == 0 && tid == 0) {
      hist[k] = tau;
      hist[K + k] = tau * wvm1;
      hist[2 * K + k] = sp;
      hist[3 * K + k] = sn;
      hist[4 * K + k] = (double)v;
    }

    tick(kScalars);
    const double* s_v = s_cols;  // column v of V
    if (kResident) {
      if (tid < 2 * m) s_cols[tid] = ahead;
      for (int s = tid + T; s < 2 * m; s += T)
        s_cols[s] = candidate_element(s);
      if (v != imax) s_v += m;
    } else {  // a streamed layout reads the one column from the V^T copy
      for (int s = tid; s < m; s += T) s_cols[s] = VT[(size_t)v * m + s];
    }
    __syncthreads();  // the columns are staged; the last iteration's H and
                      // s_g are settled
    tick(kColumns);

    // ---- g = H v ------------------------------------------------------------
    for (int row0 = 0; row0 < m; row0 += rows_per_round) {
      const int row = row0 + row_in_round;
      double acc = 0.0;
      if (row < m) {
        const double* Hr = H + (size_t)row * m;
        for (int s = sub; s < m; s += G) acc += Hr[s] * s_v[s];
      }
      for (int off = G >> 1; off > 0; off >>= 1)
        acc += __shfl_xor_sync(kFull, acc, off);
      if (row < m && sub == 0) s_g[row] = acc;
    }
    __syncthreads();
    tick(kG);

    // ---- H <- (H - c g g^T) r: a thread updates the elements it read ------
    for (int row = row_in_round; row < m; row += rows_per_round) {
      double* Hr = H + (size_t)row * m;
      const double gr = s_g[row];
      for (int s = sub; s < m; s += G)
        Hr[s] = (Hr[s] - c * (gr * s_g[s])) * r;
    }

    // ---- u = g^T V and the w/x update of the columns this thread owns ----
    for (int lj = tid; lj < nown; lj += T) {
      double u0 = 0.0, u1 = 0.0, u2 = 0.0, u3 = 0.0;
      int rr = 0;
      if (kResident) {
        const double* vp = panel + lj;
        for (; rr + 4 <= m; rr += 4, vp += 4 * (size_t)ncp) {
          u0 += s_g[rr] * vp[0];
          u1 += s_g[rr + 1] * vp[ncp];
          u2 += s_g[rr + 2] * vp[2 * (size_t)ncp];
          u3 += s_g[rr + 3] * vp[3 * (size_t)ncp];
        }
        for (; rr < m; ++rr, vp += ncp) u0 += s_g[rr] * vp[0];
      } else {
        const double* vp = V + lj;
#pragma unroll 8  // eight loads from the L2 in flight
        for (; rr < m; ++rr, vp += n) u0 += s_g[rr] * __ldg(vp);
      }
      double u = (u0 + u1) + (u2 + u3);
      const bool is_v = col0 + lj == v;
      if (is_v) u = wv;
      w[lj] = (w[lj] - c * (u * u)) * r;
      const double xs = x[lj] * (1.0 - tau);
      x[lj] = is_v ? (drop ? 0.0 : xs + tau) : xs;
    }
    tick(kUpdate);
    ++k;  // a thread scans the columns it has just updated itself
  }
  if (timed)
    for (int q = 0; q < kPhases; ++q) p.prof[q] += s_prof[q];

  if (done && rank == 0)  // frozen from row k on
    for (int q = k + tid; q < K; q += T) {
      hist[q] = 0.0;
      hist[K + q] = 0.0;
      hist[2 * K + q] = sp;
      hist[3 * K + q] = sn;
      hist[4 * K + q] = -1.0;
    }
  __syncthreads();
  if (kResident)
    for (int lj = tid; lj < nown; lj += T) {
      p.x[(size_t)b * n + col0 + lj] = x[lj];
      p.w[(size_t)b * n + col0 + lj] = w[lj];
    }
  if (p.h_in_smem && rank == 0)
    for (size_t e = tid; e < mm; e += T) Hout[e] = H[e];
  if (rank == 0 && tid == 0) {
    p.misc[3 * b] = done ? 1.0 : 0.0;
    p.misc[3 * b + 1] = entered ? 0.0 : (double)(done ? k + 1 : k);
    p.misc[3 * b + 2] = (double)k;
  }
  // no CTA leaves while a peer may still read a column of its panel
  if (C > 1) cluster_meet();
}

// What a device needs once: the dynamic shared memory opt-in, set to the
// most the device gives (the attribute is the function's for the whole
// process, so a small launch never lowers it under a larger one), and the
// cluster sizes above the portable 8.
struct DeviceState {
  bool ready;
  int max_dynamic;  // bytes of dynamic shared memory a CTA may ask for
  cudaFuncAttributes attr;  // of the resident kernel, which the paths run
};
DeviceState g_state[kMaxDevices];

// A resident kernel launches as clusters; a streamed one never does.
template <bool kResident, bool kTimed>
cudaError_t prepare_kernel(int optin, int* max_dynamic) {
  cudaFuncAttributes attr;
  cudaError_t e =
      cudaFuncGetAttributes(&attr, dopt_dense_kernel<kResident, kTimed>);
  if (e != cudaSuccess) return e;
  // the opt-in at the most this kernel may have; a launch may ask for what
  // every kernel of the family may have
  const int most = optin - (int)attr.sharedSizeBytes;
  if (most < *max_dynamic) *max_dynamic = most;
  e = cudaFuncSetAttribute(dopt_dense_kernel<kResident, kTimed>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (e != cudaSuccess) return e;
  if (!kResident) return cudaSuccess;  // a streamed layout never clusters
  return cudaFuncSetAttribute(dopt_dense_kernel<kResident, kTimed>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

cudaError_t prepare_device(int dev) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceState& st = g_state[dev];
  if (st.ready) return cudaSuccess;
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncGetAttributes(&st.attr, dopt_dense_kernel<true, false>);
  if (e != cudaSuccess) return e;
  st.max_dynamic = optin;
  e = prepare_kernel<true, false>(optin, &st.max_dynamic);
  if (e != cudaSuccess) return e;
  e = prepare_kernel<true, true>(optin, &st.max_dynamic);
  if (e != cudaSuccess) return e;
  e = prepare_kernel<false, false>(optin, &st.max_dynamic);
  if (e != cudaSuccess) return e;
  e = prepare_kernel<false, true>(optin, &st.max_dynamic);
  if (e != cudaSuccess) return e;
  st.ready = true;
  return cudaSuccess;
}

// The layout a launch is given (ops/dopt_dense.py::dense_plan), in the
// order the C entries take it.
struct Layout {
  int cluster, threads, chunk, resident, h_in_smem, smem_bytes;
};

// A layout the kernel can run on an (m, n) design: the chunks cover the
// columns, only a one-CTA instance streams V or keeps H in global memory,
// and the shared memory it names holds what the kernel puts there.
bool layout_ok(const Layout& L, int m, int n) {
  const int warps = L.threads / 32;
  if (L.cluster < 1 || L.cluster > kMaxCluster ||
      (L.cluster & (L.cluster - 1)) != 0 || L.threads < 32 ||
      L.threads > kMaxThreads || L.threads % 32 != 0 ||
      (warps & (warps - 1)) != 0 || L.chunk < 1 ||
      (long long)L.chunk * L.cluster < n || L.cluster * warps > kMaxSlots)
    return false;
  if (L.cluster > 1 && !(L.resident && L.h_in_smem)) return false;
  if (L.resident && !L.h_in_smem) return false;
  long long need = 3LL * m;
  if (L.h_in_smem) need += (long long)m * m;
  if (L.resident) need += (long long)m * (L.chunk | 1) + 2LL * L.chunk;
  return 8 * need <= L.smem_bytes;
}

}  // namespace

extern "C" {

// The kernel as compiled and the device's limits, after the once-per-device
// set-up: info = registers per thread, static shared bytes, local (spill)
// bytes per thread, dynamic shared bytes a CTA may ask for.
int dopt_dense_info(int device, int* info) {
  return (int)on_device(device, prepare_device, [&]() {
    const DeviceState& st = g_state[device];
    info[0] = st.attr.numRegs;
    info[1] = (int)st.attr.sharedSizeBytes;
    info[2] = (int)st.attr.localSizeBytes;
    info[3] = st.max_dynamic;
    return cudaSuccess;
  });
}

// How many clusters of this layout the device can hold at once into
// *active (0: the card does not schedule such a cluster).
int dopt_dense_active_clusters(int device, int cluster, int threads,
                               int smem_bytes, int* active) {
  return (int)on_device(device, prepare_device, [&]() {
    if (smem_bytes > g_state[device].max_dynamic)
      return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(cfg, attr, cluster, cluster, threads, (size_t)smem_bytes,
                   nullptr);
    return cudaOccupancyMaxActiveClusters(
        active, dopt_dense_kernel<true, false>, &cfg);
  });
}

// One launch block for B instances on `stream` of `device`, laid out by
// `layout` (cluster, threads, chunk, resident, h_in_smem, smem_bytes).
// `prof` is null or dopt_dense_phases() zeroed int64 that thread 0 of CTA
// 0 adds its clocks per phase to.
// Returns the launch's cudaError_t (0 when the kernel was enqueued).
int dopt_dense_run(const void* V, const void* VT, const void* H_in,
                   const void* x_in, const void* w_in, const void* done_in,
                   void* x, void* w, void* H, void* misc, void* hist,
                   double eps, double xtol, int B, int m, int n, int kmax,
                   int away, const int* layout, void* prof, int device,
                   void* stream) {
  if (B < 1 || m < 1 || n < 1 || kmax < 0) return (int)cudaErrorInvalidValue;
  const Layout L = {layout[0], layout[1], layout[2],
                    layout[3], layout[4], layout[5]};
  if (!layout_ok(L, m, n)) return (int)cudaErrorInvalidValue;
  return (int)on_device(device, prepare_device, [&]() {
    if (L.smem_bytes > g_state[device].max_dynamic)
      return cudaErrorInvalidValue;
    Params p;
    p.V = static_cast<const double*>(V);
    p.VT = static_cast<const double*>(VT);
    p.H_in = static_cast<const double*>(H_in);
    p.x_in = static_cast<const double*>(x_in);
    p.w_in = static_cast<const double*>(w_in);
    p.done_in = static_cast<const int*>(done_in);
    p.x = static_cast<double*>(x);
    p.w = static_cast<double*>(w);
    p.H = static_cast<double*>(H);
    p.misc = static_cast<double*>(misc);
    p.hist = static_cast<double*>(hist);
    p.eps = eps;
    p.xtol = xtol;
    p.m = m;
    p.n = n;
    p.kmax = kmax;
    p.away = away;
    p.cluster = L.cluster;
    p.chunk = L.chunk;
    p.h_in_smem = L.h_in_smem;
    p.prof = static_cast<long long*>(prof);
    // a streamed layout gives a warp a row of H (its loads coalesce); a
    // resident one as few lanes as make all rows one round
    p.row_lanes = 32;
    while (L.resident && p.row_lanes > 1 && L.threads / p.row_lanes < m)
      p.row_lanes >>= 1;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(cfg, attr, (unsigned)B * L.cluster, L.cluster, L.threads,
                   (size_t)L.smem_bytes, stream);
    cudaError_t e = cudaSuccess;
    if (L.resident)
      e = p.prof == nullptr
              ? cudaLaunchKernelEx(&cfg, dopt_dense_kernel<true, false>, p)
              : cudaLaunchKernelEx(&cfg, dopt_dense_kernel<true, true>, p);
    else if (p.prof == nullptr)  // one CTA per instance: a plain launch
      dopt_dense_kernel<false, false><<<cfg.gridDim, cfg.blockDim,
                                        cfg.dynamicSmemBytes, cfg.stream>>>(p);
    else
      dopt_dense_kernel<false, true><<<cfg.gridDim, cfg.blockDim,
                                       cfg.dynamicSmemBytes, cfg.stream>>>(p);
    return e != cudaSuccess ? e : cudaGetLastError();
  });
}

int dopt_dense_phases() { return kPhases; }

const char* dopt_dense_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
