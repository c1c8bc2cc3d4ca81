// The dual prox's inner loop in one launch, in FP64 for Hopper (sm_90a):
// SumOf2nd4thPowersDualProxMap.div_prox_map, the prox of the quartic
// kernel over {X >= 0, ||X|| <= radius} by a primal-dual extragradient
// loop of up to num_iters steps with a gap test after each.
//
// No TPU kernel: the JAX package writes this loop as one lax.while_loop
// (accbpg_and_fw_tpu/ops/h_oracles.py:476-507) that XLA compiles into the
// chunk.  The port's plain version is the torch loop of
// accbpg_and_fw_tpu_torch/ops/dual_prox.py::dual_prox_reference, which
// reads its exit flag once per block of steps; this kernel runs the whole
// loop on the card and reads nothing back, so a CUDA graph captures it as
// one node.  A step, with G = g + grad h(y) and eta = eta_base / (it + 1):
//
//   gX     = G - L (alpha <X,X> X + sigma X) - lam          (grads(X, lam))
//   X_mid  = P(X + eta gX),      lam_mid  = max(lam + eta X, 0)
//   X_new  = P(X + eta gXm),     lam_new  = max(lam + eta X_mid, 0)
//   X_cand = P(X_new + eta gX),  lam_cand = max(lam_new + eta X, 0)
//   gap    = f(X_cand, lam_new) - f(X_new, lam_cand),
//   f(X, lam) = <G, X - y> - L (alpha/4 <X,X>^2 + sigma/2 <X,X>) - <lam, X>
//
// with P the projection Xp = max(X, 0), X if ||Xp|| <= radius else
// (radius / ||Xp||) Xp, and the exit it < num_iters and (it <= 1 or gap >=
// tol).  Every product and sum is rounded as the plain version's tensor
// operations round it (no contraction into fused multiply-adds; a number
// over a tensor is its reciprocal times the number, as torch computes it);
// only the dot products' order of summation differs.
//
// What bounds it: a step is five reductions in a chain, with about 60
// FP64 operations an element between them; at the primal-dual study's
// 400 x 10 that work on one SM (64 FP64 operations a clock) and the
// reductions' latency are the time.  So:
//
// * one thread-block cluster of C CTAs runs the loop (the layout comes
//   from ops/dual_prox.py::dual_prox_plan: a cluster toward 256 elements
//   a CTA, one a thread, so that the FP64 work spreads over up to 16
//   SMs; at 400 x 10, 16 CTAs of 256 threads took 6.9 us a step against
//   10.1 us on one CTA of 1024).  CTA r
//   owns elements [r chunk, (r + 1) chunk) and keeps, for each, X, lam, gX
//   and X_mid in its shared memory (in a global scratch past what shared
//   memory holds); every other value of a step is recomputed where it is
//   used, in the same operations;
// * a step's dot products are fused into the five reductions the data
//   dependences allow: ||max(X + eta gX, 0)||, <X_mid, X_mid>,
//   ||max(X + eta gXm, 0)||, then the four sums of X_new (its projection's
//   norm for X_cand, and f(X_new, lam_cand)'s three), then f(X_cand,
//   lam_new)'s three.  <X_new, X_new> is the next step's <X, X>;
// * a reduction is an xor butterfly per warp, one block barrier, the same
//   butterfly over the warps' sums, then (C > 1) csrc/cluster.cuh's
//   exchange: warp 0 sends the CTA's sums into a slot of every peer's
//   shared memory by st.async and every CTA adds the C slots by the same
//   butterfly.  All threads of all CTAs hold the same bits, so they take
//   the same exit without a broadcast.  The partial sums, slots and
//   barriers come in two sets used in turn;
// * X and the step count go to device buffers; thread 0 of CTA 0 adds one
//   to a device int64, the launch count that a graph's replays add to.
//
// Interface: plain C, loaded with ctypes; L is a device scalar (a line
// search's trial value), the oracle's constants are the launch's
// arguments.  The wrapper allocates outputs and scratch with torch.empty;
// the kernel launches on the caller's stream.

#include <cuda_runtime.h>
#include <cmath>

#include "cluster.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 64;
constexpr int kSums = 4;    // values a reduction carries at most
constexpr int kArrays = 4;  // X, lam, gX, X_mid per element
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
// torch.clamp_min(a, 0): NaN stays NaN
__device__ __forceinline__ double pos(double a) { return a < 0.0 ? 0.0 : a; }
// a number over a tensor, as torch computes it: the reciprocal times it
__device__ __forceinline__ double over(double num, double t) {
  return mul(__drcp_rn(t), num);
}

struct Exchange {
  double part[2][kSums][kMaxWarps];
  alignas(16) double slot[2][kMaxCluster][kSums];
  alignas(8) unsigned long long barrier[2];
};

struct Launch {
  uint32_t peer_slots;    // lane r < C of warp 0: CTA r's slot[0][rank]
  uint32_t peer_barrier;  // ... and CTA r's barrier[0]
  int warps, cluster, rank, pass;
};

// Sum v[0..V) over every thread of the cluster; every thread of every CTA
// returns the same bits (xor butterflies over lanes, warps and CTAs, whose
// counts are powers of two).
template <int V>
__device__ __forceinline__ void reduce(double (&v)[V], Launch& L,
                                       Exchange& ex) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int set = L.pass & 1, parity = (L.pass >> 1) & 1;
  ++L.pass;
#pragma unroll
  for (int q = 0; q < V; ++q)
    for (int off = 16; off > 0; off >>= 1)
      v[q] = add(v[q], __shfl_xor_sync(kFull, v[q], off));
  if (L.warps > 1) {
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < V; ++q) ex.part[set][q][warp] = v[q];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < V; ++q) {
      v[q] = ex.part[set][q][lane & (L.warps - 1)];
      for (int off = L.warps >> 1; off > 0; off >>= 1)
        v[q] = add(v[q], __shfl_xor_sync(kFull, v[q], off));
    }
  }
  if (L.cluster > 1) {
    const uint32_t barrier = smem_address(&ex.barrier[set]);
    if (warp == 0) {
      if (lane == 0) mbarrier_expect(barrier, 8 * kSums * L.cluster);
      if (lane < L.cluster) {
        double w[kSums] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int q = 0; q < V; ++q) w[q] = v[q];
        const uint32_t to = L.peer_slots + set * (uint32_t)sizeof(ex.slot[0]);
        const uint32_t bar =
            L.peer_barrier + set * (uint32_t)sizeof(ex.barrier[0]);
        send16(to, bar, __double_as_longlong(w[0]),
               __double_as_longlong(w[1]));
        send16(to + 16, bar, __double_as_longlong(w[2]),
               __double_as_longlong(w[3]));
      }
    }
    mbarrier_wait(barrier, parity);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      v[q] = ex.slot[set][lane & (L.cluster - 1)][q];
      for (int off = L.cluster >> 1; off > 0; off >>= 1)
        v[q] = add(v[q], __shfl_xor_sync(kFull, v[q], off));
    }
  }
}

struct Params {
  double alpha, sigma, eta_base, tol, radius;
  int num_iters;
};

// P(a) of one element, given the norm of max(a, 0) over all of them
__device__ __forceinline__ double project(double a, double norm,
                                          double scale, double radius) {
  return norm <= radius ? a : mul(scale, pos(a));
}

// G - L (alpha n2 X + sigma X) - lam, in the plain version's order
__device__ __forceinline__ double grad_x(double g, double Lv, double an2,
                                         double sigma, double x,
                                         double lam) {
  return sub(sub(g, mul(Lv, add(mul(an2, x), mul(sigma, x)))), lam);
}

// L (alpha/4 n2 n2 + sigma/2 n2)
__device__ __forceinline__ double quartic(double Lv, double n2,
                                          const Params& p) {
  return mul(Lv, add(mul(mul(p.alpha / 4.0, n2), n2),
                     mul(p.sigma / 2.0, n2)));
}

__global__ void __launch_bounds__(kMaxThreads)
dual_prox_kernel(const double* __restrict__ G, const double* __restrict__ y,
                 const double* __restrict__ L_in, Params p, long long n,
                 int chunk, int resident, double* __restrict__ scratch,
                 double* __restrict__ x_out, double* __restrict__ steps_out,
                 long long* count) {
  extern __shared__ double staged[];
  __shared__ Exchange ex;
  const int tid = threadIdx.x, threads = blockDim.x;

  Launch L;
  L.peer_slots = L.peer_barrier = 0;
  L.warps = threads >> 5;
  L.cluster = (int)gridDim.x;  // the grid is one cluster
  L.rank = (int)blockIdx.x;
  L.pass = 0;
  if (L.cluster > 1) {
    if (tid == 0) {
      mbarrier_init(smem_address(&ex.barrier[0]));
      mbarrier_init(smem_address(&ex.barrier[1]));
      mbarrier_init_fence();
    }
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    if (tid < L.cluster) {
      L.peer_slots = peer_address(smem_address(&ex.slot[0][L.rank][0]), tid);
      L.peer_barrier = peer_address(smem_address(&ex.barrier[0]), tid);
    }
  }

  // this CTA's elements [lo, lo + count): its arrays in shared memory, or
  // in its part of the global scratch
  const long long lo = (long long)L.rank * chunk;
  const int count_here = (int)max(0LL, min((long long)chunk, n - lo));
  double* arr = resident ? staged : scratch + (long long)kArrays * lo;
  const int stride = resident ? chunk : count_here;
  double* X = arr;
  double* lam = arr + stride;
  double* gX = arr + 2 * stride;
  double* Xm = arr + 3 * stride;
  const double* Gh = G + lo;
  const double* yh = y + lo;
  const double Lv = *L_in;

  for (int j = tid; j < count_here; j += threads) {
    X[j] = 0.0;
    lam[j] = 0.0;
  }
  if (L.cluster > 1)
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");

  double it = 0.0, gap = INFINITY, n2 = 0.0;
  while (it < (double)p.num_iters && (it <= 1.0 || gap >= p.tol)) {
    const double eta = over(p.eta_base, add(it, 1.0));
    // A: gX and ||max(X + eta gX, 0)||
    double sa[1] = {0.0};
    const double an2 = mul(p.alpha, n2);
    for (int j = tid; j < count_here; j += threads) {
      const double g = grad_x(Gh[j], Lv, an2, p.sigma, X[j], lam[j]);
      gX[j] = g;
      const double a = pos(add(X[j], mul(eta, g)));
      sa[0] = add(sa[0], mul(a, a));
    }
    reduce<1>(sa, L, ex);
    const double norm_a = sqrt(sa[0]);
    const double scale_a = over(p.radius, norm_a);
    // B: X_mid and <X_mid, X_mid>
    double sb[1] = {0.0};
    for (int j = tid; j < count_here; j += threads) {
      const double xm = project(add(X[j], mul(eta, gX[j])), norm_a, scale_a,
                                p.radius);
      Xm[j] = xm;
      sb[0] = add(sb[0], mul(xm, xm));
    }
    reduce<1>(sb, L, ex);
    const double an2m = mul(p.alpha, sb[0]);
    // C: ||max(X + eta gXm, 0)||
    double sc[1] = {0.0};
    for (int j = tid; j < count_here; j += threads) {
      const double lm = pos(sub(lam[j], mul(eta, -X[j])));
      const double gm = grad_x(Gh[j], Lv, an2m, p.sigma, Xm[j], lm);
      const double d = pos(add(X[j], mul(eta, gm)));
      sc[0] = add(sc[0], mul(d, d));
    }
    reduce<1>(sc, L, ex);
    const double norm_d = sqrt(sc[0]);
    const double scale_d = over(p.radius, norm_d);
    // D: X_new, lam_new (stored), ||max(X_new + eta gX, 0)|| and
    // f(X_new, lam_cand)'s sums
    double sd[4] = {0.0, 0.0, 0.0, 0.0};
    for (int j = tid; j < count_here; j += threads) {
      const double x = X[j], l = lam[j], xm = Xm[j];
      const double lm = pos(sub(l, mul(eta, -x)));
      const double gm = grad_x(Gh[j], Lv, an2m, p.sigma, xm, lm);
      const double xn = project(add(x, mul(eta, gm)), norm_d, scale_d,
                                p.radius);
      const double ln = pos(sub(l, mul(eta, -xm)));
      const double e = pos(add(xn, mul(eta, gX[j])));
      const double lc = pos(sub(ln, mul(eta, -x)));
      sd[0] = add(sd[0], mul(e, e));
      sd[1] = add(sd[1], mul(Gh[j], sub(xn, yh[j])));
      sd[2] = add(sd[2], mul(xn, xn));
      sd[3] = add(sd[3], mul(lc, xn));
      X[j] = xn;
      lam[j] = ln;
    }
    reduce<4>(sd, L, ex);
    const double norm_e = sqrt(sd[0]);
    const double scale_e = over(p.radius, norm_e);
    // E: f(X_cand, lam_new)'s sums
    double se[3] = {0.0, 0.0, 0.0};
    for (int j = tid; j < count_here; j += threads) {
      const double xc = project(add(X[j], mul(eta, gX[j])), norm_e, scale_e,
                                p.radius);
      se[0] = add(se[0], mul(Gh[j], sub(xc, yh[j])));
      se[1] = add(se[1], mul(xc, xc));
      se[2] = add(se[2], mul(lam[j], xc));
    }
    reduce<3>(se, L, ex);
    const double f_cand = sub(sub(se[0], quartic(Lv, se[1], p)), se[2]);
    const double f_new = sub(sub(sd[1], quartic(Lv, sd[2], p)), sd[3]);
    gap = sub(f_cand, f_new);
    it = add(it, 1.0);
    n2 = sd[2];
  }
  for (int j = tid; j < count_here; j += threads) x_out[lo + j] = X[j];
  if (L.rank == 0 && tid == 0) {
    *steps_out = it;
    *count += 1;
  }
  // no CTA leaves while a peer may still send into its slots
  if (L.cluster > 1) cluster_meet();
}

struct DeviceState {
  bool ready;
  int max_dynamic;  // bytes of dynamic shared memory a CTA may ask for
  cudaFuncAttributes attr;
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
  e = cudaFuncGetAttributes(&st.attr, dual_prox_kernel);
  if (e != cudaSuccess) return e;
  st.max_dynamic = optin - (int)st.attr.sharedSizeBytes;
  e = cudaFuncSetAttribute(dual_prox_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           st.max_dynamic);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(dual_prox_kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  st.ready = true;
  return cudaSuccess;
}

size_t smem_bytes(int chunk, int resident) {
  return resident ? (size_t)kArrays * chunk * sizeof(double) : 0;
}

bool layout_ok(long long n, int cluster, int threads, int chunk) {
  return n >= 1 && cluster >= 1 && cluster <= kMaxCluster &&
         (cluster & (cluster - 1)) == 0 && threads >= 32 &&
         threads <= kMaxThreads && threads % 32 == 0 &&
         ((threads / 32) & (threads / 32 - 1)) == 0 && chunk >= 1 &&
         (long long)chunk * cluster >= n;
}

}  // namespace

extern "C" {

// The kernel as compiled and the device's limit, after the once-per-device
// set-up: registers per thread, static shared bytes, local (spill) bytes
// per thread, dynamic shared bytes a CTA may ask for.
int dual_prox_info(int device, int* info) {
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
int dual_prox_active_clusters(int device, int cluster, int threads,
                              int chunk, int resident, int* active) {
  return (int)on_device(device, prepare_device, [&]() {
    const size_t smem = smem_bytes(chunk, resident);
    if (smem > (size_t)g_state[device].max_dynamic)
      return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(cfg, attr, cluster, cluster, threads, smem, nullptr);
    return cudaOccupancyMaxActiveClusters(active, dual_prox_kernel, &cfg);
  });
}

// The prox of G (= g + grad h(y)) and y, n elements each, with L = *L_in:
// X into x_out[0..n) and the steps taken into steps_out[0], as one cluster
// of `cluster` CTAs of `threads` threads; CTA r owns `chunk` elements from
// r chunk, its four arrays in shared memory if `resident`, else in
// scratch[4 n].  `count` is the device's launch count.  Returns the
// launch's cudaError_t (0 when the kernel was enqueued).
int dual_prox_run(const void* G, const void* y, const void* L_in, double alpha,
                  double sigma, double eta_base, double tol, double radius,
                  int num_iters, long long n, int cluster, int threads,
                  int chunk, int resident, void* scratch, void* x_out,
                  void* steps_out, void* count, int device, void* stream) {
  if (!layout_ok(n, cluster, threads, chunk) || num_iters < 0 ||
      (!resident && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)on_device(device, prepare_device, [&]() {
    const size_t smem = smem_bytes(chunk, resident);
    if (smem > (size_t)g_state[device].max_dynamic)
      return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(cfg, attr, cluster, cluster, threads, smem, stream);
    Params p{alpha, sigma, eta_base, tol, radius, num_iters};
    cudaError_t e = cudaLaunchKernelEx(
        &cfg, dual_prox_kernel, static_cast<const double*>(G),
        static_cast<const double*>(y), static_cast<const double*>(L_in), p,
        n, chunk, resident, static_cast<double*>(scratch),
        static_cast<double*>(x_out), static_cast<double*>(steps_out),
        static_cast<long long*>(count));
    return e != cudaSuccess ? e : cudaGetLastError();
  });
}

const char* dual_prox_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
