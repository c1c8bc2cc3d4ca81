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
// Interface: plain C, loaded with ctypes.  The wrapper allocates every
// buffer with torch.empty (the integer scratch with torch.zeros); the
// kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 32;                  // g phase: rows per tile
constexpr int kSlices = kThreads / kTileRows;  // g phase: k-slices
constexpr int kMaxBlocksPerSM = 2;

struct Params {
  const double* V;    // (m, n) row-major
  const double* VT;   // (n, m) row-major, V^T
  const double* H0;   // (m, m)
  const double* x_in;
  const double* w_in;
  double* x;          // (n) out
  double* w;          // (n) out
  double* C;          // (kr, m) out: g rows
  double* beta;       // (kr) out
  double* misc;       // (4) out: done, iters, alpha, nrun
  double* hist;       // (5, kr) out: tau, tau (w_v - 1), SP, SN, pivot v
  double* dscr;       // double scratch, layout in Plan
  int* iscr;          // int scratch (zeroed): barrier, pivot indices
  double eps, xtol;
  int m, n, kr, kmax, done, away;
  int rchunks, rows_per_chunk, ctiles, pblocks;
};

struct Plan {
  int grid, rchunks, rows_per_chunk, ctiles, pblocks;
  size_t smem;
  long long dwords, iwords;
};

// Grid-wide barrier: arrival counter + generation, on integer atomics.
// Co-residency of all CTAs is guaranteed by the cooperative launch.
__device__ __forceinline__ void grid_sync(int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile int* gen = bar + 1;
    const int g0 = *gen;
    __threadfence();
    if (atomicAdd(bar, 1) == (int)gridDim.x - 1) {
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

// (value, index) pairs: the larger value wins; on a tie the lower index.
__device__ __forceinline__ void max_pair(double& v, int& i, double ov,
                                         int oi) {
  if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
}
__device__ __forceinline__ void min_pair(double& v, int& i, double ov,
                                         int oi) {
  if (ov < v || (ov == v && oi < i)) { v = ov; i = oi; }
}

// Block-wide reduction of (max, argmax) and (min, argmin); every thread
// gets the result.  Fixed order, so every CTA that reduces the same inputs
// gets the same answer.
__device__ void block_pivots(double& vmax, int& imax, double& vmin,
                             int& imin) {
  __shared__ double s_v[2][kWarps];
  __shared__ int s_i[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    max_pair(vmax, imax, __shfl_down_sync(0xffffffffu, vmax, off),
             __shfl_down_sync(0xffffffffu, imax, off));
    min_pair(vmin, imin, __shfl_down_sync(0xffffffffu, vmin, off),
             __shfl_down_sync(0xffffffffu, imin, off));
  }
  if (lane == 0) {
    s_v[0][warp] = vmax; s_i[0][warp] = imax;
    s_v[1][warp] = vmin; s_i[1][warp] = imin;
  }
  __syncthreads();
  vmax = s_v[0][0]; imax = s_i[0][0];
  vmin = s_v[1][0]; imin = s_i[1][0];
  for (int q = 1; q < kWarps; ++q) {
    max_pair(vmax, imax, s_v[0][q], s_i[0][q]);
    min_pair(vmin, imin, s_v[1][q], s_i[1][q]);
  }
  __syncthreads();  // s_v/s_i are reused by the next call
}

__device__ __forceinline__ double warp_sum(double a) {
  for (int off = 16; off > 0; off >>= 1)
    a += __shfl_down_sync(0xffffffffu, a, off);
  return a;  // complete in lane 0
}

// Phase 4 (and the prologue): columns owned by this CTA.  update == false
// copies x_in/w_in into x/w; update == true reduces u from the row-chunk
// partials in a fixed order, pins u[v] = w[v] and updates w and x.  Then
// the CTA's pivot partials of the new (w, x) are written.
__device__ void wx_phase(const Params& p, bool update, const double* upart,
                         double* pval, int* pidx, double c, double r,
                         double tau, int v, double wv, bool drop) {
  const int G = gridDim.x;
  if ((int)blockIdx.x >= p.pblocks) return;
  double vmax = -INFINITY, vmin = INFINITY;
  int imax = INT_MAX, imin = INT_MAX;
  for (int j0 = blockIdx.x * kThreads; j0 < p.n; j0 += G * kThreads) {
    const int j = j0 + threadIdx.x;
    if (j >= p.n) continue;
    double wj, xj;
    if (!update) {
      wj = p.w_in[j];
      xj = p.x_in[j];
    } else {
      double u = 0.0;
      for (int rc = 0; rc < p.rchunks; ++rc)
        u += __ldcg(upart + (size_t)rc * p.n + j);
      if (j == v) u = wv;
      wj = (__ldcg(p.w + j) - c * (u * u)) * r;
      const double xs = __ldcg(p.x + j) * (1.0 - tau);
      xj = (j == v) ? (drop ? 0.0 : xs + tau) : xs;
    }
    p.w[j] = wj;
    p.x[j] = xj;
    max_pair(vmax, imax, wj, j);
    const bool in_support = p.away ? (xj > p.xtol) : (xj > 0.0);
    if (in_support) min_pair(vmin, imin, wj, j);
  }
  block_pivots(vmax, imax, vmin, imin);
  if (threadIdx.x == 0) {
    pval[blockIdx.x] = vmax; pidx[blockIdx.x] = imax;
    pval[G + blockIdx.x] = vmin; pidx[G + blockIdx.x] = imin;
  }
}

__global__ void __launch_bounds__(kThreads)
dopt_lazy_kernel(Params p) {
  extern __shared__ double s_vec[];  // column v of V, then g
  __shared__ double s_red[kSlices][kTileRows];

  const int G = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int m = p.m, n = p.n, kr = p.kr;
  const double m_f = (double)m;

  double* h0v = p.dscr;
  double* z = h0v + m;
  double* g = z + kr;
  double* upart = g + m;
  double* pval = upart + (size_t)p.rchunks * n;
  int* bar = p.iscr;
  int* pidx = bar + 2;

  wx_phase(p, false, upart, pval, pidx, 0.0, 1.0, 0.0, -1, 0.0, false);
  grid_sync(bar);

  double alpha = 1.0;
  bool done = p.done != 0;
  int k = 0;
  while (k < p.kmax && !done) {
    // ---- pivots (every CTA, redundantly) --------------------------------
    double vmax = -INFINITY, vmin = INFINITY;
    int imax = INT_MAX, imin = INT_MAX;
    for (int q = tid; q < p.pblocks; q += kThreads) {
      max_pair(vmax, imax, __ldcg(pval + q), __ldcg(pidx + q));
      min_pair(vmin, imin, __ldcg(pval + G + q), __ldcg(pidx + G + q));
    }
    block_pivots(vmax, imax, vmin, imin);
    const int i = imax, j = imin;
    const double wi = vmax, wj = vmin;
    const double sp = (wi - m_f) / m_f;
    const double sn = (m_f - wj) / m_f;
    const bool stop = (sp <= p.eps) && (sn <= p.eps);
    const bool rec = (b == 0 && tid == 0);
    if (rec) {
      p.hist[2 * kr + k] = sp;
      p.hist[3 * kr + k] = sn;
    }
    if (stop) {
      if (rec) {
        p.hist[k] = 0.0;
        p.hist[kr + k] = 0.0;
        p.hist[4 * kr + k] = -1.0;
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
      const double xj = __ldcg(p.x + j);
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
      p.hist[k] = tau;
      p.hist[kr + k] = tau * wvm1;
      p.hist[4 * kr + k] = (double)v;
    }

    // ---- phase 1: H0 v and z_q = beta_q (C_q . v), one warp per row ------
    for (int s = tid; s < m; s += kThreads)
      s_vec[s] = p.VT[(size_t)v * m + s];
    __syncthreads();
    for (int t = b * kWarps + warp; t < m + k; t += G * kWarps) {
      double acc = 0.0;
      if (t < m) {
        const double* row = p.H0 + (size_t)t * m;
        for (int s = lane; s < m; s += 32) acc += __ldg(row + s) * s_vec[s];
      } else {
        const double* row = p.C + (size_t)(t - m) * m;
        for (int s = lane; s < m; s += 32) acc += __ldcg(row + s) * s_vec[s];
      }
      acc = warp_sum(acc);
      if (lane == 0) {
        if (t < m) h0v[t] = acc;
        else z[t - m] = __ldcg(p.beta + (t - m)) * acc;
      }
    }
    grid_sync(bar);

    // ---- phase 2: g = alpha H0 v + sum_q z_q C_q; append g as row k -----
    {
      const int tx = tid % kTileRows, ty = tid / kTileRows;
      for (int tile = b; tile * kTileRows < m; tile += G) {
        const int row = tile * kTileRows + tx;
        double acc = 0.0;
        if (row < m)
          for (int q = ty; q < k; q += kSlices)
            acc += __ldcg(z + q) * __ldcg(p.C + (size_t)q * m + row);
        s_red[ty][tx] = acc;
        __syncthreads();
        if (ty == 0 && row < m) {
          double s = 0.0;
          for (int q = 0; q < kSlices; ++q) s += s_red[q][tx];
          const double gr = alpha * __ldcg(h0v + row) + s;
          g[row] = gr;
          p.C[(size_t)k * m + row] = gr;
        }
        __syncthreads();
      }
      // beta_k = -c, then beta *= r and alpha *= r (beta was last read in
      // phase 1, and is next read after three more barriers)
      if (b == 0)
        for (int q = tid; q <= k; q += kThreads)
          p.beta[q] = (q == k ? -c : __ldcg(p.beta + q)) * r;
      alpha *= r;
    }
    grid_sync(bar);

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
        const double* vp = p.V + (size_t)r0 * n + col;
#pragma unroll 4
        for (int rr = r0; rr < r1; ++rr, vp += n) acc += s_vec[rr] * __ldg(vp);
        upart[(size_t)rc * n + col] = acc;
      }
    }
    grid_sync(bar);

    // ---- phase 4: w/x update and the next pivots -------------------------
    wx_phase(p, true, upart, pval, pidx, c, r, tau, v, wv, drop);
    grid_sync(bar);
    ++k;
  }

  if (b == 0 && tid == 0) {
    // only the stop row records without running
    const bool stopped_here = done && !p.done;
    p.misc[0] = done ? 1.0 : 0.0;
    p.misc[1] = (double)k;
    p.misc[2] = alpha;
    p.misc[3] = (double)(stopped_here ? k - 1 : k);
  }
}

cudaError_t make_plan(int m, int n, int kr, Plan* pl) {
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
  e = cudaFuncSetAttribute(dopt_lazy_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)pl->smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dopt_lazy_kernel,
                                                    kThreads, pl->smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (per_sm > kMaxBlocksPerSM) per_sm = kMaxBlocksPerSM;
  const int G = per_sm * sms;
  pl->grid = G;
  // u phase: ctiles column tiles x rchunks row chunks, one unit per CTA
  pl->ctiles = (n + kThreads - 1) / kThreads;
  int R = G / pl->ctiles;
  if (R < 1) R = 1;
  if (R > m) R = m;
  pl->rows_per_chunk = (m + R - 1) / R;
  pl->rchunks = (m + pl->rows_per_chunk - 1) / pl->rows_per_chunk;
  // w/x phase: CTAs that own columns (grid-stride over column tiles)
  pl->pblocks = pl->ctiles < G ? pl->ctiles : G;
  // h0v[m], z[kr], g[m], upart[rchunks * n], pivot values[2 G]
  pl->dwords = 2LL * m + kr + (long long)pl->rchunks * n + 2LL * G;
  // barrier[2], pivot indices[2 G]
  pl->iwords = 2 + 2LL * G;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Scratch sizes (in doubles and ints) for an (m, n) design with a kr-row
// rank buffer on the current device.
int dopt_lazy_scratch(int m, int n, int kr, long long* dwords,
                      long long* iwords) {
  Plan pl;
  cudaError_t e = make_plan(m, n, kr, &pl);
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
  cudaError_t e = make_plan(m, n, kr, &pl);
  if (e != cudaSuccess) return (int)e;
  if (kmax < 0 || kmax > kr) return (int)cudaErrorInvalidValue;
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
  p.eps = eps;
  p.xtol = xtol;
  p.m = m;
  p.n = n;
  p.kr = kr;
  p.kmax = kmax;
  p.done = done;
  p.away = away;
  p.rchunks = pl.rchunks;
  p.rows_per_chunk = pl.rows_per_chunk;
  p.ctiles = pl.ctiles;
  p.pblocks = pl.pblocks;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)dopt_lazy_kernel,
                                  dim3(pl.grid), dim3(kThreads), args,
                                  pl.smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* dopt_lazy_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
