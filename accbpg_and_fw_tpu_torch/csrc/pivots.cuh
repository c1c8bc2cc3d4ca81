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

__device__ __forceinline__ double warp_sum(double a) {
  for (int off = 16; off > 0; off >>= 1)
    a += __shfl_down_sync(0xffffffffu, a, off);
  return a;  // complete in lane 0
}
