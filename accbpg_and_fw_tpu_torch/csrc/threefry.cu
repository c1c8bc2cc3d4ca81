// The noise stream's hash: JAX's threefry2x32 in its partitionable counter
// layout, in CUDA C++ for Hopper (sm_90a).
//
// No TPU kernel: the JAX package draws its noise through jax.random, which
// XLA compiles into the chunk (accbpg_and_fw_tpu/algorithms/extras.py,
// bpg.py, fw.py and ops/f_oracles.py call jax.random.split, uniform and
// normal).  This kernel computes the same bits on the card, so that a
// driver's key chain is device tensors and a CUDA graph captures its draws.
// The plain PyTorch version, the same arithmetic in int64 tensor
// operations, is accbpg_and_fw_tpu_torch/_rng.py (threefry2x32_reference,
// split_reference, _draw_reference).
//
// * threefry2x32: 20 rounds of add, rotate and xor on two 32-bit words, the
//   key injected every four rounds (JAX's _threefry2x32_lowering).
// * split(key): the hashes of the counters (0, 0) and (0, 1), the next key
//   and the draw key (jax.random.split with jax_threefry_partitionable).
// * uniform(sub): the 64-bit word of counter (0, 0), hi << 32 | lo, its top
//   52 bits over 2^52 (JAX's mantissa of a float in [1, 2), minus 1; exact).
// * a draw of n values: element i hashes the counter (i >> 32, i mod 2^32);
//   a normal maps its uniform onto (nextafter(-1, 0), 1) and takes
//   sqrt(2) erfinv (jax.random.normal).  The map's multiply and add are
//   rounded separately, as the plain version's two tensor operations, so
//   the uniforms agree bit for bit; CUDA's erfinv is not torch's, so the
//   normals agree to the last bits.
//
// What bounds it: a split is one thread and three hashes, so a launch's
// latency (a few microseconds) is all of it; a draw of n values is n
// hashes of 20 rounds each (about 100 integer operations) and 8n bytes
// written, far below the card's rates at the solvers' n (up to 10^5): the
// launch dominates again.  Its design is to be one node of a graph and to
// read nothing back: one launch per split (the inexact drivers' uniform
// comes with it), one per draw, a grid-stride loop of one thread per
// counter.  Thread 0 of block 0 adds one to a device int64, the launch
// count that a graph's replays keep adding to.
//
// Interface: plain C, loaded with ctypes; the key is an int64[2] tensor
// holding the two words.  The wrapper allocates the outputs with
// torch.empty; the kernel launches on the caller's stream.

#include <cuda_runtime.h>
#include <cstdint>

#include "cluster.cuh"

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;
// jax.random.normal's interval: nextafter(-1, 0), and 1 - that, which
// rounds to 2
constexpr double kNormalLo = -0x1.fffffffffffffp-1;
constexpr double kNormalScale = 2.0;
constexpr double kSqrt2 = 1.4142135623730951;

// what a draw writes: the kernel's modes, as ops' _rng._MODES
enum Mode { kUniform = 0, kNormal = 1, kBits = 2 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32 of the counter (x0, x1) under the key (k0, k1), in place.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// [0, 1) from the 64-bit word hi << 32 | lo: its top 52 bits over 2^52.
__device__ __forceinline__ double unit(uint32_t hi, uint32_t lo) {
  const unsigned long long mant =
      ((unsigned long long)hi << 20) | (unsigned long long)(lo >> 12);
  return __dmul_rn(__ull2double_rn(mant), 0x1p-52);
}

__global__ void threefry_split_kernel(const long long* __restrict__ key,
                                      long long* __restrict__ out,
                                      double* __restrict__ u,
                                      long long* count) {
  const uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
  uint32_t n0 = 0, n1 = 0, s0 = 0, s1 = 1;
  threefry2x32(k0, k1, n0, n1);
  threefry2x32(k0, k1, s0, s1);
  out[0] = n0;
  out[1] = n1;
  out[2] = s0;
  out[3] = s1;
  uint32_t w0 = 0, w1 = 0;
  threefry2x32(s0, s1, w0, w1);
  *u = unit(w0, w1);
  *count += 1;
}

__global__ void __launch_bounds__(kThreads)
threefry_draw_kernel(const long long* __restrict__ key, long long n, int mode,
                     double* __restrict__ out, long long* __restrict__ words,
                     long long* count) {
  const uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t x0 = (uint32_t)(i >> 32), x1 = (uint32_t)i;
    threefry2x32(k0, k1, x0, x1);
    if (mode == kBits) {
      words[i] = x0;
      words[n + i] = x1;
      continue;
    }
    double v = unit(x0, x1);
    if (mode == kNormal) {
      v = fmax(__dadd_rn(__dmul_rn(v, kNormalScale), kNormalLo), kNormalLo);
      v = __dmul_rn(kSqrt2, erfinv(v));
    }
    out[i] = v;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *count += 1;
}

cudaError_t no_preparation(int) { return cudaSuccess; }

}  // namespace

extern "C" {

// split(key) into out[0..2) (the next key) and out[2..4) (the draw key),
// and uniform(draw key) into u[0]; one thread on `stream` of `device`.
// `count` is the device's launch count.  Returns the launch's cudaError_t.
int threefry_split_run(const void* key, void* out, void* u, void* count,
                       int device, void* stream) {
  return (int)on_device(device, no_preparation, [&]() {
    threefry_split_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(key), static_cast<long long*>(out),
        static_cast<double*>(u), static_cast<long long*>(count));
    return cudaGetLastError();
  });
}

// n draws of the key: mode 0 uniforms and 1 normals into out[0..n), mode 2
// the two words of each counter into words[0..n) and words[n..2n).
int threefry_draw_run(const void* key, long long n, int mode, void* out,
                      void* words, void* count, int device, void* stream) {
  if (n < 1 || mode < kUniform || mode > kBits ||
      (mode == kBits ? words == nullptr : out == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)on_device(device, no_preparation, [&]() {
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    threefry_draw_kernel<<<(unsigned)blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(key), n, mode,
        static_cast<double*>(out), static_cast<long long*>(words),
        static_cast<long long*>(count));
    return cudaGetLastError();
  });
}

const char* threefry_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
