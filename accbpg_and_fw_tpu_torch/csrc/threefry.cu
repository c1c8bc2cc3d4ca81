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
// split_reference, _draw_reference, split_noise_reference).
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
// Two entries.  threefry_split_run: one link of the chain and the draw
// key's uniform, times a scale read from the card where one is given (the
// inexact drivers' noise * uniform(sub), JAX's one rounding).
// threefry_draw_run: n uniforms, normals or raw words of a draw key, or,
// in the noise mode, what a stochastic oracle's gradient adds in JAX's
// fused expression: from the CHAIN key, the split, the n normals of the
// draw key, and base + (normal - shift) * scale, each operation rounded on
// its own (__dsub_rn, __dmul_rn, __dadd_rn: no contraction), so the values
// are bit for bit those of the split, the normal draw and the three tensor
// operations they replace, in one launch.
//
// What bounds it: a split is one thread and three dependent hashes; a draw
// of n values is n hashes of 20 rounds (79 integer operations each), an
// erfinv each for normals, and 8n bytes written (16n with a base read).
// At the solvers' n (4000, up to 10^5) both are far below the card's
// rates, so a launch's latency is all of it, and a graph node's floor is
// most of that (chip_smoke.py [threefry walls]: 2.2 us a node at 400x10
// beside an empty kernel's 0.8-1.0 us, on an H100 80GB HBM3 at 700 W).
// The design is to be as few nodes as the JAX expression is, and to read
// nothing back.  In the noise mode every warp derives the draw key from
// the chain key itself (lane 0 hashes the counter (0, 0), the next key,
// the other lanes (0, 1), the draw key, and lane 1's words are broadcast
// with __shfl_sync: one hash's latency, the same instructions the warp
// would issue for one lane), so no block waits for another; lanes 0 and 1
// of block 0 write the two keys.  A thread hashes C counters at once (two
// independent chains in flight for C = 2).  Thread 0 of block 0 adds one to
// the entry's device int64, the launch count that a graph's replays keep
// adding to.
//
// Interface: plain C, loaded with ctypes; the key is an int64[2] tensor
// holding the two words.  The wrapper allocates each call's outputs with
// one torch.empty; the kernel launches on the caller's stream.

#include <cuda_runtime.h>
#include <cstdint>

#include "cluster.cuh"

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr int kMaxThreads = 256;
constexpr long long kMaxBlocks = 4096;
// jax.random.normal's interval: nextafter(-1, 0), and 1 - that, which
// rounds to 2
constexpr double kNormalLo = -0x1.fffffffffffffp-1;
constexpr double kNormalScale = 2.0;
constexpr double kSqrt2 = 1.4142135623730951;

// what a draw writes: the kernel's modes, as _rng._MODES
enum Mode { kUniform = 0, kNormal = 1, kBits = 2, kNoise = 3 };

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

// jax.random.normal of the 64-bit word: its uniform mapped onto
// (nextafter(-1, 0), 1), then sqrt(2) erfinv.
__device__ __forceinline__ double normal(uint32_t hi, uint32_t lo) {
  const double v =
      fmax(__dadd_rn(__dmul_rn(unit(hi, lo), kNormalScale), kNormalLo),
           kNormalLo);
  return __dmul_rn(kSqrt2, erfinv(v));
}

__global__ void threefry_split_kernel(const long long* __restrict__ key,
                                      long long* __restrict__ out,
                                      const double* __restrict__ scale,
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
  const double u = unit(w0, w1);
  reinterpret_cast<double*>(out)[4] =
      scale == nullptr ? u : __dmul_rn(*scale, u);
  *count += 1;
}

// One draw of n values; C counters a thread, a grid-stride loop.  In the
// noise mode `key` is the chain key, out[0..4) (as int64 words) gets the
// next key and the draw key, and the values follow them.
template <int C>
__global__ void __launch_bounds__(kMaxThreads)
threefry_draw_kernel(const long long* __restrict__ key, long long n, int mode,
                     double shift, double scale,
                     const double* __restrict__ base, double* __restrict__ out,
                     long long* count) {
  uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
  if (mode == kNoise) {
    const unsigned lane = threadIdx.x & 31u;
    uint32_t x0 = 0, x1 = lane != 0;
    threefry2x32(k0, k1, x0, x1);
    if (blockIdx.x == 0 && threadIdx.x < 2) {
      long long* keys = reinterpret_cast<long long*>(out);
      keys[2 * threadIdx.x] = x0;
      keys[2 * threadIdx.x + 1] = x1;
    }
    k0 = __shfl_sync(0xffffffffu, x0, 1);
    k1 = __shfl_sync(0xffffffffu, x1, 1);
    out += 4;
  }
  const long long tile = (long long)blockDim.x * C;
  for (long long t = (long long)blockIdx.x * tile + threadIdx.x; t < n;
       t += (long long)gridDim.x * tile) {
    uint32_t hi[C], lo[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const long long i = t + (long long)c * blockDim.x;
      hi[c] = (uint32_t)(i >> 32);
      lo[c] = (uint32_t)i;
      threefry2x32(k0, k1, hi[c], lo[c]);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const long long i = t + (long long)c * blockDim.x;
      if (i >= n) break;
      if (mode == kBits) {
        long long* words = reinterpret_cast<long long*>(out);
        words[i] = hi[c];
        words[n + i] = lo[c];
      } else if (mode == kUniform) {
        out[i] = unit(hi[c], lo[c]);
      } else if (mode == kNormal) {
        out[i] = normal(hi[c], lo[c]);
      } else {
        double v = __dmul_rn(__dsub_rn(normal(hi[c], lo[c]), shift), scale);
        out[i] = base == nullptr ? v : __dadd_rn(base[i], v);
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *count += 1;
}

cudaError_t no_preparation(int) { return cudaSuccess; }

}  // namespace

extern "C" {

// split(key) into out[0..2) (the next key) and out[2..4) (the draw key),
// and uniform(draw key), times *scale where scale is not null, into out[4]
// as a double; one thread on `stream` of `device`.  `count` is the
// device's launch count.  Returns the launch's cudaError_t.
int threefry_split_run(const void* key, void* out, const void* scale,
                       void* count, int device, void* stream) {
  return (int)on_device(device, no_preparation, [&]() {
    threefry_split_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(key), static_cast<long long*>(out),
        static_cast<const double*>(scale), static_cast<long long*>(count));
    return cudaGetLastError();
  });
}

// n draws of `key`, `threads` threads a block (a multiple of 32 up to 256)
// and `per_thread` (1 or 2) counters a thread: mode 0 uniforms and 1
// normals into out[0..n), mode 2 the two words of each counter into
// out[0..n) and out[n..2n) as int64; mode 3 (`key` the chain key) the next
// key and the draw key into out[0..4) as int64 words and base[i] +
// (normal_i - shift) * scale (no base where it is null) into out[4..n+4).
int threefry_draw_run(const void* key, long long n, int mode, double shift,
                      double scale, const void* base, void* out, void* count,
                      int threads, int per_thread, int device, void* stream) {
  if (n < (mode == kNoise ? 0 : 1) || mode < kUniform || mode > kNoise ||
      out == nullptr || threads < 32 || threads > kMaxThreads ||
      threads % 32 || (per_thread != 1 && per_thread != 2))
    return (int)cudaErrorInvalidValue;
  return (int)on_device(device, no_preparation, [&]() {
    const long long tile = (long long)threads * per_thread;
    long long blocks = (n + tile - 1) / tile;
    if (blocks < 1) blocks = 1;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    auto kernel = per_thread == 2 ? threefry_draw_kernel<2>
                                  : threefry_draw_kernel<1>;
    kernel<<<(unsigned)blocks, threads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(key), n, mode, shift, scale,
        static_cast<const double*>(base), static_cast<double*>(out),
        static_cast<long long*>(count));
    return cudaGetLastError();
  });
}

const char* threefry_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
