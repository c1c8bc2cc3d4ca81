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
// What bounds it: an iteration is O(m n + m^2) work with a chain of
// dependent reductions (pivots -> g -> u -> next pivots), so at the sweep
// sizes (m ~ 30-160, n ~ 1000) it is latency-bound, not bandwidth-bound.
// The TPU ran the B instances in lockstep only because of its vector
// layout; here they are independent:
//
// * one CTA per instance (grid = B), no grid barrier, no lockstep: a CTA
//   whose instance stops fills its frozen rows and exits;
// * H (m x m) stays in dynamic shared memory when it fits (m <= ~165,
//   about 220 KB of the 227 KB a block can use), else in global memory;
// * V streams from L2 (32 instances of 30x1000 are 7.7 MB); the pivot
//   column is read from a V^T copy (one contiguous row) instead of a
//   strided gather;
// * u = g^T V: each thread owns columns j = tid + q * blockDim and walks
//   the rows, so a warp's loads coalesce along V's rows; the w/x update of
//   a column follows in the same thread, so it needs no barrier;
// * g = H v: one warp per row of H; the rank-1 update: one warp per row;
// * no floating-point atomics: pivots carry (value, index) and break ties
//   at the lowest index, every sum has a fixed order.
//
// At medium m a single instance uses one SM of 132.  Splitting an instance
// over a cluster is later work.
//
// Interface: plain C, loaded with ctypes.  The wrapper allocates every
// buffer with torch.empty; the kernel allocates nothing and launches on
// the caller's stream.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

#include "pivots.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Params {
  const double* V;      // (B, m, n) row-major
  const double* VT;     // (B, n, m), V^T per instance
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
  int m, n, kmax, away, h_in_smem;
};

__global__ void __launch_bounds__(kThreads)
dopt_dense_kernel(Params p) {
  extern __shared__ double smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int m = p.m, n = p.n, K = p.kmax;
  const size_t mm = (size_t)m * m;
  const double m_f = (double)m;

  const double* V = p.V + (size_t)b * m * n;
  const double* VT = p.VT + (size_t)b * n * m;
  double* x = p.x + (size_t)b * n;
  double* w = p.w + (size_t)b * n;
  double* Hout = p.H + (size_t)b * mm;
  double* hist = p.hist + (size_t)b * 5 * K;
  double* s_v = smem;        // column v of V
  double* s_g = smem + m;    // g = H v
  double* H = p.h_in_smem ? smem + 2 * m : Hout;

  for (int j = tid; j < n; j += kThreads) {
    x[j] = p.x_in[(size_t)b * n + j];
    w[j] = p.w_in[(size_t)b * n + j];
  }
  for (size_t e = tid; e < mm; e += kThreads) H[e] = p.H_in[(size_t)b * mm + e];
  __syncthreads();

  const bool entered = p.done_in[b] != 0;
  bool done = entered;
  double sp = 0.0, sn = 0.0;
  int k = 0;
  while (k < K) {
    // ---- pivots over the columns this thread owns, then the block -------
    double vmax = -INFINITY, vmin = INFINITY;
    int imax = INT_MAX, imin = INT_MAX;
    for (int j = tid; j < n; j += kThreads) {
      const double wj = w[j], xj = x[j];
      max_pair(vmax, imax, wj, j);
      if (p.away ? (xj > p.xtol) : (xj > 0.0)) min_pair(vmin, imin, wj, j);
    }
    block_pivots<kWarps>(vmax, imax, vmin, imin);
    sp = (vmax - m_f) / m_f;
    sn = (m_f - vmin) / m_f;
    if (done || (sp <= p.eps && sn <= p.eps)) {
      done = true;  // uniform: every thread reduced the same pivots
      break;
    }

    // ---- step scalars (every thread, same bits) --------------------------
    int v = imax;
    double wv = vmax, tau = sp / (vmax - 1.0);
    bool drop = false;
    if (p.away && !(sp >= sn)) {
      const double xj = imin == INT_MAX ? 0.0 : x[imin];
      const double a1 = sn / (vmin - 1.0);
      const double a2 = xj / (1.0 - xj);
      const bool use_a1 = a1 < a2;
      v = imin;
      wv = vmin;
      tau = -(use_a1 ? a1 : a2);
      drop = !use_a1;
    }
    const double wvm1 = wv - 1.0;
    const double c = tau / (1.0 + tau * wvm1);
    const double r = 1.0 / (1.0 - tau);
    if (tid == 0) {
      hist[k] = tau;
      hist[K + k] = tau * wvm1;
      hist[2 * K + k] = sp;
      hist[3 * K + k] = sn;
      hist[4 * K + k] = (double)v;
    }

    // ---- g = H v, one warp per row ----------------------------------------
    for (int s = tid; s < m; s += kThreads) s_v[s] = VT[(size_t)v * m + s];
    __syncthreads();  // also orders every read of x[imin] before the update
    for (int row = warp; row < m; row += kWarps) {
      const double* Hr = H + (size_t)row * m;
      double acc = 0.0;
      for (int s = lane; s < m; s += 32) acc += Hr[s] * s_v[s];
      acc = warp_sum(acc);
      if (lane == 0) s_g[row] = acc;
    }
    __syncthreads();

    // ---- H <- (H - c g g^T) r, one warp per row ----------------------------
    for (int row = warp; row < m; row += kWarps) {
      double* Hr = H + (size_t)row * m;
      const double gr = s_g[row];
      for (int s = lane; s < m; s += 32)
        Hr[s] = (Hr[s] - c * (gr * s_g[s])) * r;
    }

    // ---- u = g^T V and the w/x update of the columns this thread owns ----
    for (int j = tid; j < n; j += kThreads) {
      double u = 0.0;
      const double* vp = V + j;
#pragma unroll 4
      for (int rr = 0; rr < m; ++rr, vp += n) u += s_g[rr] * __ldg(vp);
      if (j == v) u = wv;
      w[j] = (w[j] - c * (u * u)) * r;
      const double xs = x[j] * (1.0 - tau);
      x[j] = (j == v) ? (drop ? 0.0 : xs + tau) : xs;
    }
    ++k;  // the next pivots' barriers order these writes before any read
  }

  if (done)  // frozen from row k on
    for (int q = k + tid; q < K; q += kThreads) {
      hist[q] = 0.0;
      hist[K + q] = 0.0;
      hist[2 * K + q] = sp;
      hist[3 * K + q] = sn;
      hist[4 * K + q] = -1.0;
    }
  if (p.h_in_smem) {
    __syncthreads();
    for (size_t e = tid; e < mm; e += kThreads) Hout[e] = H[e];
  }
  if (tid == 0) {
    p.misc[3 * b] = done ? 1.0 : 0.0;
    p.misc[3 * b + 1] = entered ? 0.0 : (double)(done ? k + 1 : k);
    p.misc[3 * b + 2] = (double)k;
  }
}

}  // namespace

extern "C" {

// One launch block for B instances on `stream`.  Returns the launch's
// cudaError_t (0 when the kernel was enqueued).
int dopt_dense_run(const void* V, const void* VT, const void* H_in,
                   const void* x_in, const void* w_in, const void* done_in,
                   void* x, void* w, void* H, void* misc, void* hist,
                   double eps, double xtol, int B, int m, int n, int kmax,
                   int away, void* stream) {
  if (B < 1 || m < 1 || n < 1 || kmax < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  // 1 KB left for the reductions' static shared memory
  const size_t vec = 2 * (size_t)m * sizeof(double);
  const size_t full = vec + (size_t)m * m * sizeof(double);
  const bool h_in_smem = full + 1024 <= (size_t)optin;
  const size_t smem = h_in_smem ? full : vec;
  if (smem + 1024 > (size_t)optin) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(dopt_dense_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
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
  p.h_in_smem = h_in_smem ? 1 : 0;
  dopt_dense_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}

const char* dopt_dense_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
