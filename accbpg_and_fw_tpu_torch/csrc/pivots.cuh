// Deterministic reductions shared by the D-opt block kernels.
//
// Pivot reductions carry (value, index) pairs and break ties at the lowest
// index, as jnp.argmax/argmin and torch.argmax/argmin do; every sum has a
// fixed order, so a launch gives the same bits on every run.

#pragma once

#include <cuda_runtime.h>

// (value, index) pairs: the larger value wins; on a tie the lower index.
__device__ __forceinline__ void max_pair(double& v, int& i, double ov,
                                         int oi) {
  if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
}
__device__ __forceinline__ void min_pair(double& v, int& i, double ov,
                                         int oi) {
  if (ov < v || (ov == v && oi < i)) { v = ov; i = oi; }
}

// Block-wide reduction of (max, argmax) and (min, argmin) over kWarps
// warps; every thread gets the result.  Fixed order, so every CTA that
// reduces the same inputs gets the same answer.
template <int kWarps>
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
