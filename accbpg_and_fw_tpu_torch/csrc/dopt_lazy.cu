// Lazy-H launch block of the D-optimal design Frank-Wolfe(-away) solver,
// in FP64 for Hopper (sm_90a).
//
// Replaces the TPU kernel accbpg_and_fw_tpu/ops/pallas_dopt_lazy.py ::
// _lazy_kernel_body.  One launch runs up to kmax (<= kr) iterations on the
// lazy inverse H = alpha H0 + C diag(beta) C^T: pivots, slack stop test,
// step sizes, g = H V[:,v], u = g^T V with the pin u[v] = w[v], the w/x
// update with an exact zero on an away drop, the append of g as row k of C
// with beta_k = -c, and the rescale of alpha and beta by 1/(1 - tau).  The
// plain PyTorch version is ops/dopt_lazy.py::lazy_block_reference.
//
// What bounds it: every iteration reads all of V (m x n, 40 MB at
// 1000x5000) for u = g^T V and all of H0 (m x m, 8 MB) for H0 v; the rest
// is O(n + kr m).  It is bandwidth-bound, and V + H0 sit right at the
// H100's 50 MB L2.  The TPU kernel kept V in VMEM; here no SM can hold it,
// so the design streams it once per iteration from L2/HBM with every SM
// taking part, and keeps everything else small:
//
// * one persistent cooperative kernel per block: as many CTAs as can be
//   co-resident (at most 2 per SM), launched with
//   cudaLaunchCooperativeKernel so a grid-wide barrier is safe.  The
//   barrier is a generation counter on integer atomics, so no relocatable
//   device code is needed.  Four barriers per iteration separate the phases
//   (1) pivots -> H0 v and C v, (2) -> g, (3) -> u partials,
//   (4) -> w/x update + next pivots.
// * every CTA reduces the previous phase's per-CTA pivot partials itself
//   and computes the step scalars redundantly (same inputs, same order, so
//   every CTA gets the same bits), which saves a barrier;
// * the pivot column is read from V^T (a row: 8 KB, coalesced) instead of
//   a strided gather from V;
// * H0 v and C v: one warp per row, coalesced along the row; g: tiles of 32
//   rows x 16 k-slices reduced in shared memory; u = g^T V: threads own
//   columns and loop over a chunk of rows, so loads are coalesced along V's
//   rows, and the row chunks' partial sums are added in a fixed order in
//   phase 4.
// * no floating-point atomics: every sum has a fixed order, so a launch
//   gives the same bits every run.  Pivot reductions carry (value, index)
//   and break ties by the lowest index, as jnp.argmax/argmin do.
//
// The batch entry (dopt_lazy_batch_run) replaces the TPU kernel
// pallas_dopt_lazy.py :: _build_lazy_chunk_fn_batch, the same body over
// grid=(K,).  The TPU ran its grid steps one after another; here the
// instances run side by side in ONE cooperative launch of K groups x G
// CTAs (two cooperative launches that each fill the card could not be
// co-resident).  A CTA works on instance blockIdx.x / G as CTA
// blockIdx.x % G of G, with the instance's own pointers, kmax, done flag,
// scratch and barrier word (in its own 128-byte line), so the groups
// never wait on each other.  G is floor(co-resident CTAs / K); when K
// exceeds the co-resident CTAs the instances run in waves of launches.
// The single-instance entry (dopt_lazy_run) is the K = 1 instantiation,
// with the whole grid as its group.
//
// Interface: plain C, loaded with ctypes.  The wrapper allocates every
// buffer with torch.empty (the integer scratch with torch.zeros); the
// kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

#include "pivots.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 32;                  // g phase: rows per tile
constexpr int kSlices = kThreads / kTileRows;  // g phase: k-slices
constexpr int kMaxBlocksPerSM = 2;

constexpr int kBarWords = 32;                 // one 128-byte line

struct Params {
  const double* V;    // (K, m, n) row-major
  const double* VT;   // (K, n, m) row-major, V^T per instance
  const double* H0;   // (K, m, m)
  const double* x_in;
  const double* w_in;
  double* x;          // (K, n) out
  double* w;          // (K, n) out
  double* C;          // (K, kr, m) out: g rows
  double* beta;       // (K, kr) out
  double* misc;       // (K, 4) out: done, iters, alpha, nrun
  double* hist;       // (K, 5, kr) out: tau, tau (w_v - 1), SP, SN, pivot v
  double* dscr;       // double scratch, dwords per instance, layout in Plan
  int* iscr;          // int scratch (zeroed), iwords per instance: barrier
                      // line, pivot indices
  const int* kmax_b;  // (K) batch entry: per-instance kmax and done flag
  const int* done_b;
  double eps, xtol;
  int m, n, kr, kmax, done, away;
  int rchunks, rows_per_chunk, ctiles, pblocks;
  int group;                 // CTAs per instance
  long long dwords, iwords;  // scratch per instance
};

struct Plan {
  int grid, group, wave, rchunks, rows_per_chunk, ctiles, pblocks;
  size_t smem;
  long long dwords, iwords;
};

// One instance's view of the launch: its pointers, kmax and done flag,
// and this CTA's index b among the G CTAs of its group.
struct Inst {
  const double *V, *VT, *H0, *x_in, *w_in;
  double *x, *w, *C, *beta, *misc, *hist, *dscr;
  int* iscr;
  int b, G, kmax, done;
};

template <bool kBatch>
__device__ __forceinline__ Inst instance(const Params& p) {
  const size_t k = kBatch ? blockIdx.x / p.group : 0;
  const size_t mn = (size_t)p.m * p.n, n = p.n, m = p.m, kr = p.kr;
  Inst q;
  q.b = kBatch ? blockIdx.x % p.group : blockIdx.x;
  q.G = kBatch ? p.group : gridDim.x;
  q.V = p.V + k * mn;
  q.VT = p.VT + k * mn;
  q.H0 = p.H0 + k * m * m;
  q.x_in = p.x_in + k * n;
  q.w_in = p.w_in + k * n;
  q.x = p.x + k * n;
  q.w = p.w + k * n;
  q.C = p.C + k * kr * m;
  q.beta = p.beta + k * kr;
  q.misc = p.misc + k * 4;
  q.hist = p.hist + k * 5 * kr;
  q.dscr = p.dscr + k * p.dwords;
  q.iscr = p.iscr + k * p.iwords;
  q.kmax = kBatch ? p.kmax_b[k] : p.kmax;
  q.done = kBatch ? p.done_b[k] : p.done;
  return q;
}

// Barrier over the G CTAs of one group: arrival counter + generation, on
// integer atomics.  Co-residency of all CTAs is guaranteed by the
// cooperative launch.
__device__ __forceinline__ void grid_sync(int* bar, int G) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile int* gen = bar + 1;
    const int g0 = *gen;
    __threadfence();
    if (atomicAdd(bar, 1) == G - 1) {
      atomicExch(bar, 0);
      __threadfence();
      atomicAdd(bar + 1, 1);
    } else {
      while (*gen == g0) {
        __nanosleep(20);
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// Phase 4 (and the prologue): columns owned by this CTA.  update == false
// copies x_in/w_in into x/w; update == true reduces u from the row-chunk
// partials in a fixed order, pins u[v] = w[v] and updates w and x.  Then
// the CTA's pivot partials of the new (w, x) are written.
__device__ void wx_phase(const Params& p, const Inst& q, bool update,
                         const double* upart,
                         double* pval, int* pidx, double c, double r,
                         double tau, int v, double wv, bool drop) {
  const int G = q.G;
  if (q.b >= p.pblocks) return;
  double vmax = -INFINITY, vmin = INFINITY;
  int imax = INT_MAX, imin = INT_MAX;
  for (int j0 = q.b * kThreads; j0 < p.n; j0 += G * kThreads) {
    const int j = j0 + threadIdx.x;
    if (j >= p.n) continue;
    double wj, xj;
    if (!update) {
      wj = q.w_in[j];
      xj = q.x_in[j];
    } else {
      double u = 0.0;
      for (int rc = 0; rc < p.rchunks; ++rc)
        u += __ldcg(upart + (size_t)rc * p.n + j);
      if (j == v) u = wv;
      wj = (__ldcg(q.w + j) - c * (u * u)) * r;
      const double xs = __ldcg(q.x + j) * (1.0 - tau);
      xj = (j == v) ? (drop ? 0.0 : xs + tau) : xs;
    }
    q.w[j] = wj;
    q.x[j] = xj;
    max_pair(vmax, imax, wj, j);
    const bool in_support = p.away ? (xj > p.xtol) : (xj > 0.0);
    if (in_support) min_pair(vmin, imin, wj, j);
  }
  block_pivots<kWarps>(vmax, imax, vmin, imin);
  if (threadIdx.x == 0) {
    pval[q.b] = vmax; pidx[q.b] = imax;
    pval[G + q.b] = vmin; pidx[G + q.b] = imin;
  }
}

template <bool kBatch>
__global__ void __launch_bounds__(kThreads)
dopt_lazy_kernel(Params p) {
  const Inst I = instance<kBatch>(p);
  extern __shared__ double s_vec[];  // column v of V, then g
  __shared__ double s_red[kSlices][kTileRows];

  const int G = I.G, b = I.b, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int m = p.m, n = p.n, kr = p.kr;
  const double m_f = (double)m;

  double* h0v = I.dscr;
  double* z = h0v + m;
  double* g = z + kr;
  double* upart = g + m;
  double* pval = upart + (size_t)p.rchunks * n;
  int* bar = I.iscr;
  int* pidx = bar + kBarWords;

  wx_phase(p, I, false, upart, pval, pidx, 0.0, 1.0, 0.0, -1, 0.0, false);
  grid_sync(bar, G);

  double alpha = 1.0;
  bool done = I.done != 0;
  int k = 0;
  while (k < I.kmax && !done) {
    // ---- pivots (every CTA, redundantly) --------------------------------
    double vmax = -INFINITY, vmin = INFINITY;
    int imax = INT_MAX, imin = INT_MAX;
    for (int q = tid; q < p.pblocks; q += kThreads) {
      max_pair(vmax, imax, __ldcg(pval + q), __ldcg(pidx + q));
      min_pair(vmin, imin, __ldcg(pval + G + q), __ldcg(pidx + G + q));
    }
    block_pivots<kWarps>(vmax, imax, vmin, imin);
    const int i = imax, j = imin;
    const double wi = vmax, wj = vmin;
    const double sp = (wi - m_f) / m_f;
    const double sn = (m_f - wj) / m_f;
    const bool stop = (sp <= p.eps) && (sn <= p.eps);
    const bool rec = (b == 0 && tid == 0);
    if (rec) {
      I.hist[2 * kr + k] = sp;
      I.hist[3 * kr + k] = sn;
    }
    if (stop) {
      if (rec) {
        I.hist[k] = 0.0;
        I.hist[kr + k] = 0.0;
        I.hist[4 * kr + k] = -1.0;
      }
      done = true;
      ++k;
      break;  // uniform: every CTA computed the same stop
    }

    // ---- step scalars ----------------------------------------------------
    int v = i;
    double wv = wi, tau = sp / (wi - 1.0);
    bool drop = false;
    if (p.away && !(sp >= sn)) {
      const double xj = __ldcg(I.x + j);
      const double a1 = sn / (wj - 1.0);
      const double a2 = xj / (1.0 - xj);
      const bool use_a1 = a1 < a2;
      v = j;
      wv = wj;
      tau = -(use_a1 ? a1 : a2);
      drop = !use_a1;
    }
    const double wvm1 = wv - 1.0;
    const double c = tau / (1.0 + tau * wvm1);
    const double r = 1.0 / (1.0 - tau);
    if (rec) {
      I.hist[k] = tau;
      I.hist[kr + k] = tau * wvm1;
      I.hist[4 * kr + k] = (double)v;
    }

    // ---- phase 1: H0 v and z_q = beta_q (C_q . v), one warp per row ------
    for (int s = tid; s < m; s += kThreads)
      s_vec[s] = I.VT[(size_t)v * m + s];
    __syncthreads();
    for (int t = b * kWarps + warp; t < m + k; t += G * kWarps) {
      double acc = 0.0;
      if (t < m) {
        const double* row = I.H0 + (size_t)t * m;
        for (int s = lane; s < m; s += 32) acc += __ldg(row + s) * s_vec[s];
      } else {
        const double* row = I.C + (size_t)(t - m) * m;
        for (int s = lane; s < m; s += 32) acc += __ldcg(row + s) * s_vec[s];
      }
      acc = warp_sum(acc);
      if (lane == 0) {
        if (t < m) h0v[t] = acc;
        else z[t - m] = __ldcg(I.beta + (t - m)) * acc;
      }
    }
    grid_sync(bar, G);

    // ---- phase 2: g = alpha H0 v + sum_q z_q C_q; append g as row k -----
    {
      const int tx = tid % kTileRows, ty = tid / kTileRows;
      for (int tile = b; tile * kTileRows < m; tile += G) {
        const int row = tile * kTileRows + tx;
        double acc = 0.0;
        if (row < m)
          for (int q = ty; q < k; q += kSlices)
            acc += __ldcg(z + q) * __ldcg(I.C + (size_t)q * m + row);
        s_red[ty][tx] = acc;
        __syncthreads();
        if (ty == 0 && row < m) {
          double s = 0.0;
          for (int q = 0; q < kSlices; ++q) s += s_red[q][tx];
          const double gr = alpha * __ldcg(h0v + row) + s;
          g[row] = gr;
          I.C[(size_t)k * m + row] = gr;
        }
        __syncthreads();
      }
      // beta_k = -c, then beta *= r and alpha *= r (beta was last read in
      // phase 1, and is next read after three more barriers)
      if (b == 0)
        for (int q = tid; q <= k; q += kThreads)
          I.beta[q] = (q == k ? -c : __ldcg(I.beta + q)) * r;
      alpha *= r;
    }
    grid_sync(bar, G);

    // ---- phase 3: u partials, threads own columns ------------------------
    for (int s = tid; s < m; s += kThreads) s_vec[s] = __ldcg(g + s);
    __syncthreads();
    for (int unit = b; unit < p.rchunks * p.ctiles; unit += G) {
      const int rc = unit / p.ctiles, ct = unit % p.ctiles;
      const int col = ct * kThreads + tid;
      const int r0 = rc * p.rows_per_chunk;
      const int r1 = min(m, r0 + p.rows_per_chunk);
      if (col < n) {
        double acc = 0.0;
        const double* vp = I.V + (size_t)r0 * n + col;
#pragma unroll 4
        for (int rr = r0; rr < r1; ++rr, vp += n) acc += s_vec[rr] * __ldg(vp);
        upart[(size_t)rc * n + col] = acc;
      }
    }
    grid_sync(bar, G);

    // ---- phase 4: w/x update and the next pivots -------------------------
    wx_phase(p, I, true, upart, pval, pidx, c, r, tau, v, wv, drop);
    grid_sync(bar, G);
    ++k;
  }

  if (b == 0 && tid == 0) {
    // only the stop row records without running
    const bool stopped_here = done && !I.done;
    I.misc[0] = done ? 1.0 : 0.0;
    I.misc[1] = (double)k;
    I.misc[2] = alpha;
    I.misc[3] = (double)(stopped_here ? k - 1 : k);
  }
}

// Launch plan for K instances on the current device: one wave holds
// `wave` instances of `group` CTAs each (the whole co-resident grid for
// K = 1).
template <bool kBatch>
cudaError_t make_plan(int m, int n, int kr, int K, Plan* pl) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int coop = 0, sms = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  pl->smem = (size_t)m * sizeof(double);
  e = cudaFuncSetAttribute(dopt_lazy_kernel<kBatch>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)pl->smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dopt_lazy_kernel<kBatch>, kThreads, pl->smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (per_sm > kMaxBlocksPerSM) per_sm = kMaxBlocksPerSM;
  const int resident = per_sm * sms;
  pl->wave = K < resident ? K : resident;
  const int G = resident / pl->wave;
  pl->group = G;
  pl->grid = G * pl->wave;
  // u phase: ctiles column tiles x rchunks row chunks, one unit per CTA
  pl->ctiles = (n + kThreads - 1) / kThreads;
  int R = G / pl->ctiles;
  if (R < 1) R = 1;
  if (R > m) R = m;
  pl->rows_per_chunk = (m + R - 1) / R;
  pl->rchunks = (m + pl->rows_per_chunk - 1) / pl->rows_per_chunk;
  // w/x phase: CTAs that own columns (grid-stride over column tiles)
  pl->pblocks = pl->ctiles < G ? pl->ctiles : G;
  // per instance: h0v[m], z[kr], g[m], upart[rchunks * n], pivot values[2 G]
  pl->dwords = 2LL * m + kr + (long long)pl->rchunks * n + 2LL * G;
  // per instance: barrier line, pivot indices[2 G]; instances start on
  // their own 128-byte line
  pl->iwords = (kBarWords + 2LL * G + kBarWords - 1) / kBarWords * kBarWords;
  return cudaSuccess;
}

Params make_params(const Plan& pl, const void* V, const void* VT,
                   const void* H0, const void* x_in, const void* w_in,
                   void* x, void* w, void* C, void* beta, void* misc,
                   void* hist, void* dscr, void* iscr, double eps,
                   double xtol, int m, int n, int kr, int away) {
  Params p;
  p.V = static_cast<const double*>(V);
  p.VT = static_cast<const double*>(VT);
  p.H0 = static_cast<const double*>(H0);
  p.x_in = static_cast<const double*>(x_in);
  p.w_in = static_cast<const double*>(w_in);
  p.x = static_cast<double*>(x);
  p.w = static_cast<double*>(w);
  p.C = static_cast<double*>(C);
  p.beta = static_cast<double*>(beta);
  p.misc = static_cast<double*>(misc);
  p.hist = static_cast<double*>(hist);
  p.dscr = static_cast<double*>(dscr);
  p.iscr = static_cast<int*>(iscr);
  p.kmax_b = nullptr;
  p.done_b = nullptr;
  p.eps = eps;
  p.xtol = xtol;
  p.m = m;
  p.n = n;
  p.kr = kr;
  p.kmax = 0;
  p.done = 0;
  p.away = away;
  p.rchunks = pl.rchunks;
  p.rows_per_chunk = pl.rows_per_chunk;
  p.ctiles = pl.ctiles;
  p.pblocks = pl.pblocks;
  p.group = pl.group;
  p.dwords = pl.dwords;
  p.iwords = pl.iwords;
  return p;
}

template <bool kBatch>
cudaError_t launch(Params& p, int grid, size_t smem, void* stream) {
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)dopt_lazy_kernel<kBatch>, dim3(grid), dim3(kThreads), args,
      smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch sizes (in doubles and ints) for an (m, n) design with a kr-row
// rank buffer on the current device.
int dopt_lazy_scratch(int m, int n, int kr, long long* dwords,
                      long long* iwords) {
  Plan pl;
  cudaError_t e = make_plan<false>(m, n, kr, 1, &pl);
  if (e != cudaSuccess) return (int)e;
  *dwords = pl.dwords;
  *iwords = pl.iwords;
  return 0;
}

// One launch block on `stream`.  Returns the launch's cudaError_t (0 when
// the kernel was enqueued).
int dopt_lazy_run(const void* V, const void* VT, const void* H0,
                  const void* x_in, const void* w_in, void* x, void* w,
                  void* C, void* beta, void* misc, void* hist, void* dscr,
                  void* iscr, double eps, double xtol, int m, int n, int kr,
                  int kmax, int done, int away, void* stream) {
  Plan pl;
  cudaError_t e = make_plan<false>(m, n, kr, 1, &pl);
  if (e != cudaSuccess) return (int)e;
  if (kmax < 0 || kmax > kr) return (int)cudaErrorInvalidValue;
  Params p = make_params(pl, V, VT, H0, x_in, w_in, x, w, C, beta, misc,
                         hist, dscr, iscr, eps, xtol, m, n, kr, away);
  p.kmax = kmax;
  p.done = done;
  return (int)launch<false>(p, pl.grid, pl.smem, stream);
}

// Scratch sizes per instance, and the launches (waves) that K instances
// of an (m, n) design take on the current device.
int dopt_lazy_batch_scratch(int m, int n, int kr, int K, long long* dwords,
                            long long* iwords, int* waves) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  Plan pl;
  cudaError_t e = make_plan<true>(m, n, kr, K, &pl);
  if (e != cudaSuccess) return (int)e;
  *dwords = pl.dwords;
  *iwords = pl.iwords;
  *waves = (K + pl.wave - 1) / pl.wave;
  return 0;
}

// One launch block for each of K instances (stacked along a leading axis;
// per-instance kmax and done flags in the device int arrays kmax_b and
// done_b), in waves of cooperative launches on `stream`.  Returns the
// first failing launch's cudaError_t, or 0.
int dopt_lazy_batch_run(const void* V, const void* VT, const void* H0,
                        const void* x_in, const void* w_in, void* x, void* w,
                        void* C, void* beta, void* misc, void* hist,
                        void* dscr, void* iscr, const void* kmax_b,
                        const void* done_b, double eps, double xtol, int m,
                        int n, int kr, int K, int away, void* stream) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  Plan pl;
  cudaError_t e = make_plan<true>(m, n, kr, K, &pl);
  if (e != cudaSuccess) return (int)e;
  const size_t mn = (size_t)m * n, mm = (size_t)m * m;
  for (int k0 = 0; k0 < K; k0 += pl.wave) {
    const int kw = K - k0 < pl.wave ? K - k0 : pl.wave;
    Params p = make_params(
        pl, static_cast<const double*>(V) + k0 * mn,
        static_cast<const double*>(VT) + k0 * mn,
        static_cast<const double*>(H0) + k0 * mm,
        static_cast<const double*>(x_in) + (size_t)k0 * n,
        static_cast<const double*>(w_in) + (size_t)k0 * n,
        static_cast<double*>(x) + (size_t)k0 * n,
        static_cast<double*>(w) + (size_t)k0 * n,
        static_cast<double*>(C) + (size_t)k0 * kr * m,
        static_cast<double*>(beta) + (size_t)k0 * kr,
        static_cast<double*>(misc) + (size_t)k0 * 4,
        static_cast<double*>(hist) + (size_t)k0 * 5 * kr,
        static_cast<double*>(dscr) + k0 * pl.dwords,
        static_cast<int*>(iscr) + k0 * pl.iwords, eps, xtol, m, n, kr,
        away);
    p.kmax_b = static_cast<const int*>(kmax_b) + k0;
    p.done_b = static_cast<const int*>(done_b) + k0;
    e = launch<true>(p, kw * pl.group, pl.smem, stream);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

const char* dopt_lazy_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
