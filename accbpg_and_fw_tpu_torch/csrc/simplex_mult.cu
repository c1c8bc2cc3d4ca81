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
// What bounds it: the work is a chain of dependent reductions over gg (one
// min pass, then ten to fifteen passes at the Bregman solvers' inputs)
// with a scalar update between them.  A pass costs the reciprocals of the
// elements plus a reduction's latency.  IEEE FP64 division is a software
// sequence on this card that one SM completes about once per clock, so one
// SM's arithmetic set the time from about a thousand elements on; a
// reduction across CTAs through the cluster barrier with release and
// acquire costs 1500 to 2000 clocks, more than a small pass itself.  So:
//
// * a thread-block cluster of C CTAs runs one solve (the layout comes from
//   ops/simplex.py::simplex_plan).  CTA r owns elements [r chunk,
//   (r + 1) chunk) and stages the first `resident` of them in its shared
//   memory once; what does not fit is read from global memory every pass;
// * a small input takes one small CTA: fewer warps, a shorter second
//   stage, nothing to exchange;
// * one reciprocal per element feeds both sums, s1 += inv and
//   s2 -= inv * inv, and it is the hardware's approximation refined by two
//   Newton steps (five instructions without a branch, so four of them
//   overlap in a thread; it agreed with IEEE division on every one of a
//   million random inputs);
// * a pass: a thread's strided elements, four at a time, an xor butterfly
//   per warp, one block barrier, then every warp adds the warp sums in the
//   same butterfly order.  Warp 0 sends the CTA's two sums into a slot of
//   every peer's shared memory (st.async through distributed shared
//   memory, which counts the bytes on the peer's transaction barrier),
//   every CTA waits on its own barrier and adds the C slots by the same
//   butterfly.  All CTAs hold the same bits, update c alike and leave the
//   loops together: no broadcast, no global memory, no atomics, no fence.
//   The warp sums, the slots and the barriers come in two sets used in
//   turn;
// * the loops stop early where the TPU kernel's state is frozen, which
//   changes no bit: a bisection step whose residual is >= 0 never moves c
//   again, and a stalled Newton step repeats itself forever;
// * c goes to a one-element device buffer: no host read.
//
// Interface: plain C, loaded with ctypes.  The wrapper allocates the output
// with torch.empty; the kernel launches on the caller's stream.  The
// function attributes (the dynamic shared memory opt-in, at the device's
// maximum, and the cluster sizes above 8) are set once per device.

#include <cuda_runtime.h>
#include <cmath>

#include "cluster.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 64;
constexpr int kBisectIters = 64;
constexpr int kNewtonIters = 24;
constexpr double kStall = 1e-8;
constexpr unsigned kFull = 0xffffffffu;

// Two sets, used in turn, of the warps' partial results, of the slots that
// the CTAs of the cluster send their results into, and of the transaction
// barriers that count what has landed in the slots.
struct Exchange {
  double part[2][2][kMaxWarps];
  alignas(16) double slot[2][kMaxCluster][2];
  alignas(8) unsigned long long barrier[2];
};

struct Sum {
  __device__ static double op(double a, double b) { return a + b; }
};

// NaN-propagating min, like torch.min and jnp.min.
struct Min {
  __device__ static double op(double a, double b) {
    return (a != a || a < b) ? a : b;
  }
};

// 1 / t for t > 0: the hardware's approximation and two Newton steps; +inf
// gives exactly 0.
__device__ __forceinline__ double reciprocal(double t) {
  double x;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(x) : "d"(t));
  double e = fma(-t, x, 1.0);
  x = fma(x, e, x);
  e = fma(-t, x, 1.0);
  x = fma(x, e, x);
  return t == INFINITY ? 0.0 : x;
}

// The stages of a pass that thread 0 of CTA 0 clocks when the launch is
// given `prof`; after them prof holds the number of passes.
enum Stage {
  kElements,  // the scalar update of c and the thread's elements
  kLanes,     // the butterfly over the lanes of a warp
  kWarps,     // the block barrier and the butterfly over the warps
  kExchange,  // the sums to every CTA, until all have landed
  kCluster,   // the butterfly over the CTAs
  kStages
};

// The clock of the timed kernel; the untimed one compiles to nothing.
template <bool kTimed>
struct StageClock {
  long long* prof;  // null unless this thread is the one clocked
  long long last;

  __device__ __forceinline__ void start(long long* to) {
    if (kTimed) {
      prof = (blockIdx.x == 0 && threadIdx.x == 0) ? to : nullptr;
      last = clock64();
    }
  }
  __device__ __forceinline__ void tick(Stage stage) {
    if (kTimed && prof != nullptr) {
      const long long now = clock64();
      prof[stage] += now - last;
      last = now;
    }
  }
  __device__ __forceinline__ void finish(int passes) {
    if (kTimed && prof != nullptr) prof[kStages] += passes;
  }
};

struct Launch {
  uint32_t peer_slots;    // lane r < C of warp 0: CTA r's slot[0][rank]
  uint32_t peer_barrier;  // ... and CTA r's barrier[0]
  int warps, cluster, rank, pass;
};

// Reduce (a, b) over every thread of the cluster with Op; every thread of
// every CTA returns the same bits.  The order is fixed: lanes by an xor
// butterfly, then warps and then CTAs by the same butterfly (their counts
// are powers of two, so every group of that many lanes holds all the
// partial results and every lane ends with the same bits).
template <class Op, class Clock>
__device__ __forceinline__ void reduce2(double& a, double& b, Launch& L,
                                        Exchange& ex, Clock& clock) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int set = L.pass & 1, parity = (L.pass >> 1) & 1;
  ++L.pass;
  clock.tick(kElements);
  for (int off = 16; off > 0; off >>= 1) {
    a = Op::op(a, __shfl_xor_sync(kFull, a, off));
    b = Op::op(b, __shfl_xor_sync(kFull, b, off));
  }
  clock.tick(kLanes);
  if (L.warps > 1) {
    if (lane == 0) {
      ex.part[set][0][warp] = a;
      ex.part[set][1][warp] = b;
    }
    __syncthreads();
    a = ex.part[set][0][lane & (L.warps - 1)];
    b = ex.part[set][1][lane & (L.warps - 1)];
    for (int off = L.warps >> 1; off > 0; off >>= 1) {
      a = Op::op(a, __shfl_xor_sync(kFull, a, off));
      b = Op::op(b, __shfl_xor_sync(kFull, b, off));
    }
  }
  clock.tick(kWarps);
  if (L.cluster > 1) {
    const uint32_t barrier = smem_address(&ex.barrier[set]);
    if (warp == 0) {
      if (lane == 0) mbarrier_expect(barrier, 16 * L.cluster);
      if (lane < L.cluster)
        send16(L.peer_slots + set * (uint32_t)sizeof(ex.slot[0]),
               L.peer_barrier + set * (uint32_t)sizeof(ex.barrier[0]),
               __double_as_longlong(a), __double_as_longlong(b));
    }
    mbarrier_wait(barrier, parity);
    clock.tick(kExchange);
    a = ex.slot[set][lane & (L.cluster - 1)][0];
    b = ex.slot[set][lane & (L.cluster - 1)][1];
    for (int off = L.cluster >> 1; off > 0; off >>= 1) {
      a = Op::op(a, __shfl_xor_sync(kFull, a, off));
      b = Op::op(b, __shfl_xor_sync(kFull, b, off));
    }
    clock.tick(kCluster);
  }
}

template <bool kTimed>
__global__ void __launch_bounds__(kMaxThreads)
simplex_mult_kernel(const double* __restrict__ gg_in, int n, int chunk,
                    int resident, double* c_out, long long* prof) {
  extern __shared__ double staged[];
  __shared__ Exchange ex;
  const int tid = threadIdx.x, threads = blockDim.x;

  Launch L;
  L.peer_slots = L.peer_barrier = 0;
  L.warps = threads >> 5;
  L.cluster = (int)gridDim.x;  // the grid is one cluster
  L.rank = (int)blockIdx.x;
  L.pass = 0;
  StageClock<kTimed> clock;
  clock.start(prof);
  if (L.cluster > 1) {
    if (tid == 0) {
      mbarrier_init(smem_address(&ex.barrier[0]));
      mbarrier_init(smem_address(&ex.barrier[1]));
      mbarrier_init_fence();
    }
    // every peer's barriers are ready once the cluster has met; that is
    // waited for only before the first send
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    if (tid < L.cluster) {
      L.peer_slots = peer_address(smem_address(&ex.slot[0][L.rank][0]), tid);
      L.peer_barrier = peer_address(smem_address(&ex.barrier[0]), tid);
    }
  }

  // this CTA's elements: [lo, lo + count), the first `held` of them staged
  const long long lo = (long long)L.rank * chunk;
  const int count = (int)max(0LL, min((long long)chunk, (long long)n - lo));
  const int held = min(count, resident);
  const double* rest = gg_in + lo;
  // a thread stages the elements it reads in every pass: no barrier
  for (int i = tid; i < held; i += threads) staged[i] = rest[i];

  double mn = INFINITY, unused = INFINITY;
  for (int i = tid; i < held; i += threads) mn = Min::op(mn, staged[i]);
  for (int i = held + tid; i < count; i += threads) mn = Min::op(mn, rest[i]);
  if (L.cluster > 1)
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  reduce2<Min>(mn, unused, L, ex, clock);
  const double cmin = -mn;

  // one pass: s1 = sum 1/(gg + c), s2 = sum -1/(gg + c)^2.  A thread takes
  // four of its elements at a time, without a branch between them so that
  // their reciprocals overlap (a missing one is read from a valid address
  // and counts as +inf, which adds exactly 0), and adds them in their order
  double s1, s2;
  auto four = [&](const double* from, int i, int end, double c, double& a,
                  double& b) {
    double inv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = i + q * threads;
      const double g = from[min(j, end - 1)];
      inv[q] = reciprocal((j < end ? g : INFINITY) + c);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a += inv[q];
      b -= inv[q] * inv[q];
    }
  };
  auto sums = [&](double c) {
    double a = 0.0, b = 0.0;
    for (int i = tid; i < held; i += 4 * threads)
      four(staged, i, held, c, a, b);
    for (int i = held + tid; i < count; i += 4 * threads)
      four(rest, i, count, c, a, b);
    reduce2<Sum>(a, b, L, ex, clock);
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
  if (L.rank == 0 && tid == 0) c_out[0] = c;
  clock.finish(L.pass);
  // no CTA leaves while a peer may still send into its slots
  if (L.cluster > 1) cluster_meet();
}

// What a device needs once: the dynamic shared memory opt-in, set to the
// most the device gives (the attribute is the function's for the whole
// process, so a small launch never lowers it under a larger one), and the
// cluster sizes above the portable 8.
struct DeviceState {
  bool ready;
  int max_dynamic;  // bytes of dynamic shared memory a CTA may ask for
  cudaFuncAttributes attr;
};
DeviceState g_state[kMaxDevices];

template <bool kTimed>
cudaError_t prepare_kernel(int optin, int* max_dynamic) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, simplex_mult_kernel<kTimed>);
  if (e != cudaSuccess) return e;
  // the opt-in at the most this kernel may have; a launch may ask for what
  // every kernel of the family may have
  const int most = optin - (int)attr.sharedSizeBytes;
  if (most < *max_dynamic) *max_dynamic = most;
  e = cudaFuncSetAttribute(simplex_mult_kernel<kTimed>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(simplex_mult_kernel<kTimed>,
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
  e = cudaFuncGetAttributes(&st.attr, simplex_mult_kernel<false>);
  if (e != cudaSuccess) return e;
  st.max_dynamic = optin;
  e = prepare_kernel<false>(optin, &st.max_dynamic);
  if (e != cudaSuccess) return e;
  e = prepare_kernel<true>(optin, &st.max_dynamic);
  if (e != cudaSuccess) return e;
  st.ready = true;
  return cudaSuccess;
}

bool layout_ok(int n, int cluster, int threads, int chunk, int resident) {
  return n >= 1 && cluster >= 1 && cluster <= kMaxCluster &&
         (cluster & (cluster - 1)) == 0 && threads >= 32 &&
         threads <= kMaxThreads && threads % 32 == 0 &&
         ((threads / 32) & (threads / 32 - 1)) == 0 && chunk >= 1 &&
         (long long)chunk * cluster >= n && resident >= 0 && resident <= chunk;
}

}  // namespace

extern "C" {

// The kernel as compiled and the device's limits, after the once-per-device
// set-up: info = registers per thread, static shared bytes, local (spill)
// bytes per thread, dynamic shared bytes a CTA may ask for.
int simplex_mult_info(int device, int* info) {
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
int simplex_mult_active_clusters(int device, int cluster, int threads,
                                 int resident, int* active) {
  return (int)on_device(device, prepare_device, [&]() {
    if ((long long)resident * 8 > g_state[device].max_dynamic)
      return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(cfg, attr, cluster, cluster, threads,
                   (size_t)resident * sizeof(double), nullptr);
    return cudaOccupancyMaxActiveClusters(active, simplex_mult_kernel<false>,
                                          &cfg);
  });
}

// The multiplier of gg[0..n) into c[0], on `stream` of `device`, as one
// cluster of `cluster` CTAs of `threads` threads: CTA r owns `chunk`
// elements from r * chunk and keeps the first `resident` in shared memory.
// `prof` is null or simplex_mult_stages() + 1 zeroed int64: thread 0 of CTA
// 0 adds its clocks per stage of a pass, then the number of passes.
// Returns the launch's cudaError_t (0 when the kernel was enqueued).
int simplex_mult_run(const void* gg, int n, void* c, int cluster, int threads,
                     int chunk, int resident, void* prof, int device,
                     void* stream) {
  if (!layout_ok(n, cluster, threads, chunk, resident))
    return (int)cudaErrorInvalidValue;
  return (int)on_device(device, prepare_device, [&]() {
    if ((long long)resident * 8 > g_state[device].max_dynamic)
      return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(cfg, attr, cluster, cluster, threads,
                   (size_t)resident * sizeof(double), stream);
    const auto* in = static_cast<const double*>(gg);
    auto* out = static_cast<double*>(c);
    auto* clocks = static_cast<long long*>(prof);
    cudaError_t e =
        clocks == nullptr
            ? cudaLaunchKernelEx(&cfg, simplex_mult_kernel<false>, in, n,
                                 chunk, resident, out, clocks)
            : cudaLaunchKernelEx(&cfg, simplex_mult_kernel<true>, in, n,
                                 chunk, resident, out, clocks);
    return e != cudaSuccess ? e : cudaGetLastError();
  });
}

int simplex_mult_stages() { return kStages; }

const char* simplex_mult_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
