// Burg-simplex multiplier: solve sum_i 1/(gg_i + c) = 1 for c, in FP64 for
// Hopper (sm_90a).
//
// Replaces the TPU kernel accbpg_and_fw_tpu/ops/pallas_kernels.py ::
// _simplex_kernel (built by simplex_inv_multiplier_pallas).  Same
// algorithm: cmin = -min(gg); up to 64 bisection steps from cmin + 1 toward
// cmin while the residual sum 1/(gg + c) - 1 is negative; then up to 24
// Newton steps that freeze once an update stalls (c_new == c or
// |resid| <= 1e-8).  A +inf entry contributes exactly 0.  The TPU kernel
// ran in float32 (Mosaic has no f64); this one runs in FP64.  The plain
// PyTorch version is ops/simplex.py::simplex_multiplier_reference.
//
// What bounds it: the work is a chain of dependent block reductions over
// gg with a scalar update between them; at the sizes of the Bregman
// drivers (n ~ 1e3-1e5) each pass is a few microseconds of latency, not
// bandwidth.  So:
//
// * one CTA of 1024 threads; gg is staged once in dynamic shared memory
//   when it fits (n up to about 29,000), else read from global memory on
//   every pass (it stays in L2);
// * each pass sums 1/(gg + c) and -1/(gg + c)^2 together, in a fixed order
//   (a thread's strided elements in turn, an xor butterfly per warp, warp 0
//   over the warp sums), so the result is the same run to run;
// * every thread computes the scalar update redundantly, so no broadcast
//   is needed and the loops exit uniformly;
// * the loops stop early where the TPU kernel's state is frozen, which
//   changes no bit: a bisection step whose residual is >= 0 never moves c
//   again, and a stalled Newton step repeats itself forever.  At the
//   drivers' inputs the first bisection residual is already >= 0, so a call
//   costs one min pass, one bisection pass and one pass per Newton step;
// * c goes to a one-element device buffer: no host read.
//
// Interface: plain C, loaded with ctypes.  The wrapper allocates the output
// with torch.empty; the kernel launches on the caller's stream.

#include <cuda_runtime.h>
#include <cmath>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBisectIters = 64;
constexpr int kNewtonIters = 24;
constexpr double kStall = 1e-8;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kWarps == 32, "the second reduction stage uses one warp");

struct Reducer {
  double part[2 * kWarps];
  double out[2];
};

// NaN-propagating min, like torch.min and jnp.min.
__device__ __forceinline__ double min_nan(double a, double b) {
  return (a != a || a < b) ? a : b;
}

// Block-wide sums of (a, b); every thread returns the same bits.  Two
// barriers: a warp writes its partials for the next call only after the
// next call's butterfly, by which time warp 0 has read these (it passed
// the second barrier), and out[] is rewritten only after the next call's
// first barrier, which every reader of this out[] has passed.
__device__ __forceinline__ void block_sum2(double& a, double& b,
                                           Reducer& r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(kFull, a, off);
    b += __shfl_xor_sync(kFull, b, off);
  }
  if (lane == 0) {
    r.part[warp] = a;
    r.part[kWarps + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = r.part[lane];
    b = r.part[kWarps + lane];
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(kFull, a, off);
      b += __shfl_xor_sync(kFull, b, off);
    }
    if (lane == 0) {
      r.out[0] = a;
      r.out[1] = b;
    }
  }
  __syncthreads();
  a = r.out[0];
  b = r.out[1];
}

__device__ __forceinline__ double block_min(double a, Reducer& r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    a = min_nan(a, __shfl_xor_sync(kFull, a, off));
  if (lane == 0) r.part[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = r.part[lane];
    for (int off = 16; off > 0; off >>= 1)
      a = min_nan(a, __shfl_xor_sync(kFull, a, off));
    if (lane == 0) r.out[0] = a;
  }
  __syncthreads();
  return r.out[0];
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
simplex_mult_kernel(const double* __restrict__ gg_in, int n, double* c_out) {
  extern __shared__ double staged[];
  __shared__ Reducer red;
  const int tid = threadIdx.x;

  if (kStaged) {
    for (int i = tid; i < n; i += kThreads) staged[i] = gg_in[i];
    __syncthreads();
  }
  const double* gg = kStaged ? staged : gg_in;

  double mn = INFINITY;
  for (int i = tid; i < n; i += kThreads) mn = min_nan(mn, gg[i]);
  const double cmin = -block_min(mn, red);

  // one pass: s1 = sum 1/(gg + c), s2 = sum -1/(gg + c)^2
  double s1, s2;
  auto sums = [&](double c) {
    double a = 0.0, b = 0.0;
    for (int i = tid; i < n; i += kThreads) {
      const double t = gg[i] + c;
      a += 1.0 / t;
      b += -1.0 / (t * t);
    }
    block_sum2(a, b, red);
    s1 = a;
    s2 = b;
  };

  // Phase 1: bisect from cmin + 1 toward cmin while resid < 0.  Once
  // resid >= 0 the TPU kernel's later steps leave c where it is.
  double c = cmin + 1.0;
  sums(c);
  for (int it = 0; it < kBisectIters && s1 - 1.0 < 0.0; ++it) {
    c = 0.5 * (cmin + c);
    sums(c);
  }

  // Phase 2: Newton; a stalled step is frozen for good, so stop there.
  double fc = s1 - 1.0, fpc = s2;
  for (int it = 0; it < kNewtonIters; ++it) {
    const double c_new = c - fc / fpc;
    if (c_new == c || fabs(fc) <= kStall) break;
    sums(c_new);
    c = c_new;
    fc = s1 - 1.0;
    fpc = s2;
  }
  if (tid == 0) c_out[0] = c;
}

}  // namespace

extern "C" {

// The multiplier of gg[0..n) into c[0], on `stream`.  Returns the launch's
// cudaError_t (0 when the kernel was enqueued).
int simplex_mult_run(const void* gg, int n, void* c, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  const auto* g = static_cast<const double*>(gg);
  auto* out = static_cast<double*>(c);
  auto s = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)n * sizeof(double);
  if (bytes + sizeof(Reducer) + 1024 <= (size_t)optin) {
    e = cudaFuncSetAttribute(simplex_mult_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    simplex_mult_kernel<true><<<1, kThreads, bytes, s>>>(g, n, out);
  } else {
    simplex_mult_kernel<false><<<1, kThreads, 0, s>>>(g, n, out);
  }
  return (int)cudaGetLastError();
}

const char* simplex_mult_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
