// Latencies of the primitives that the cluster kernels are built from, in
// clocks of one thread, on the card: a stand-alone program.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o micro_cluster micro_cluster.cu && ./micro_cluster
//
// (`python3 chip_smoke.py --micro` builds and runs it.)  It prints, for
// clusters of 1 to 16 CTAs of 32 and 256 threads, one round of an exchange
// of a double per CTA: written into every peer's shared memory and made
// visible by the cluster barrier with release and acquire, or sent with
// st.async and waited for on a transaction barrier (cluster.cuh).  Then the
// latency of one IEEE FP64 division, of four independent ones, of the
// reciprocal by the hardware's approximation and two Newton steps (one and
// four independent), and how many of 2^20 random inputs that reciprocal
// rounds differently from IEEE division.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdio>
#include <cstdlib>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kIters = 4000;

__device__ __forceinline__ double reciprocal(double t) {
  double x;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(x) : "d"(t));
  double e = fma(-t, x, 1.0);
  x = fma(x, e, x);
  e = fma(-t, x, 1.0);
  x = fma(x, e, x);
  return t == INFINITY ? 0.0 : x;
}

enum Mode { kAsync, kBarrier, kDivide, kDivide4, kReciprocal, kReciprocal4 };

template <int kMode>
__global__ void __launch_bounds__(1024)
measure(long long* clocks, double* sink) {
  __shared__ alignas(16) double slot[2][16][2];  // two sets, one per rank
  __shared__ alignas(8) unsigned long long barrier[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbarrier_init(smem_address(&barrier[0]));
    mbarrier_init(smem_address(&barrier[1]));
    mbarrier_init_fence();
  }
  __syncthreads();
  cluster_sync();
  double a = 1.0 + tid * 1e-9, b = a + 1.0, c = a + 2.0, d = a + 3.0;
  const long long start = clock64();
  for (int it = 0; it < kIters; ++it) {
    const int set = it & 1;
    if (kMode == kAsync) {
      const uint32_t bar = smem_address(&barrier[set]);
      if (tid == 0) mbarrier_expect(bar, 16 * C);
      if (tid < C)
        send16(peer_address(smem_address(&slot[set][rank][0]), tid),
               peer_address(bar, tid), __double_as_longlong(a), 0);
      mbarrier_wait(bar, (it >> 1) & 1);
    } else if (kMode == kBarrier) {
      if (tid < C)
        *cluster.map_shared_rank(&slot[set][rank][0], (unsigned)tid) = a;
      cluster_sync();
    }
    if (kMode == kAsync || kMode == kBarrier) {
      double s = slot[set][0][0];
      for (int r = 1; r < C; ++r) s += slot[set][r][0];
      a = s * 0.25;
    }
    if (kMode == kDivide || kMode == kDivide4) a = 1.5 / (a + 1.0);
    if (kMode == kDivide4) {
      b = 1.5 / (b + 1.0);
      c = 1.5 / (c + 1.0);
      d = 1.5 / (d + 1.0);
    }
    if (kMode == kReciprocal || kMode == kReciprocal4)
      a = reciprocal(a + 1.0);
    if (kMode == kReciprocal4) {
      b = reciprocal(b + 1.0);
      c = reciprocal(c + 1.0);
      d = reciprocal(d + 1.0);
    }
  }
  const long long stop = clock64();
  if (tid == 0 && blockIdx.x == 0) clocks[0] = stop - start;
  if (a + b + c + d == 12345.678) sink[0] = a;
  cluster_sync();
}

__global__ void reciprocals(const double* in, double* out, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    out[i] = reciprocal(in[i]);
}

void check(cudaError_t e, const char* what) {
  if (e != cudaSuccess) {
    std::printf("%s failed: %s\n", what, cudaGetErrorString(e));
    std::exit(1);
  }
}

template <int kMode>
void run(const char* name, bool clustered, long long* clocks, double* sink) {
  check(cudaFuncSetAttribute(measure<kMode>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1), "cluster size opt-in");
  for (int C : {1, 2, 4, 8, 16})
    for (int T : {32, 256}) {
      if (!clustered && (C > 1 || T > 32)) continue;
      cudaLaunchConfig_t cfg;
      cudaLaunchAttribute attr;
      cluster_config(cfg, attr, C, C, T, 0, nullptr);
      for (int rep = 0; rep < 2; ++rep) {
        check(cudaLaunchKernelEx(&cfg, measure<kMode>, clocks, sink),
              "launch");
        check(cudaDeviceSynchronize(), name);
      }
      if (clustered)
        std::printf("%s, %2d CTAs x %3d threads: %.0f clocks a round\n", name,
                    C, T, (double)clocks[0] / kIters);
      else
        std::printf("%s: %.0f clocks\n", name, (double)clocks[0] / kIters);
    }
}

}  // namespace

int main() {
  long long* clocks;
  double *sink, *in, *out;
  const int n = 1 << 20;
  check(cudaMallocManaged(&clocks, sizeof(long long)), "alloc");
  check(cudaMalloc(&sink, sizeof(double)), "alloc");
  check(cudaMallocManaged(&in, sizeof(double) * n), "alloc");
  check(cudaMallocManaged(&out, sizeof(double) * n), "alloc");
  run<kAsync>("exchange by st.async and a transaction barrier", true, clocks,
              sink);
  run<kBarrier>("exchange by a store and the cluster barrier", true, clocks,
                sink);
  run<kDivide>("one IEEE FP64 division (and an add)", false, clocks, sink);
  run<kDivide4>("four independent IEEE divisions", false, clocks, sink);
  run<kReciprocal>("one Newton reciprocal (and an add)", false, clocks, sink);
  run<kReciprocal4>("four independent Newton reciprocals", false, clocks,
                    sink);
  std::srand(1);
  for (int i = 0; i < n; ++i)
    in[i] = std::ldexp((std::rand() + 1.0) / RAND_MAX + 0.5,
                       std::rand() % 80 - 30);
  reciprocals<<<128, 256>>>(in, out, n);
  check(cudaDeviceSynchronize(), "reciprocals");
  int differ = 0;
  for (int i = 0; i < n; ++i) differ += out[i] != 1.0 / in[i];
  std::printf("Newton reciprocal against IEEE 1/x: %d of %d random inputs "
              "differ\n", differ, n);
  return 0;
}
