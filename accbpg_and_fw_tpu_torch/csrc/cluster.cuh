// Thread-block cluster primitives shared by the cluster kernels: the
// hardware barrier, and an exchange through distributed shared memory in
// which the data and its completion signal travel together.
//
// The exchange: every CTA of a cluster keeps a transaction barrier
// (mbarrier) beside a set of slots in its shared memory.  A sender writes
// into a peer's slot with st.async, which also counts the bytes it
// delivered on the peer's barrier; the receiver tells its own barrier how
// many bytes to expect and waits on it.  No fence and no cluster-wide
// barrier is involved: on an H100 a round of it takes about 500 cycles for
// 4 CTAs and 850 for 16, against 1500 to 2000 for a write followed by the
// cluster barrier with release and acquire.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

// The cluster's hardware barrier, with release and acquire: a write into a
// peer's shared memory made before it is visible to the peer after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The same barrier ordering execution only, for a meeting that hands over
// no data (no CTA leaves while a peer may still reach into it).
__device__ __forceinline__ void cluster_meet() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// The shared-memory address of a generic pointer into this CTA's shared
// memory, and the same location in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ uint32_t peer_address(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// A transaction barrier that one thread of its CTA arrives on per phase.
// Initialise it before the cluster's first barrier, so that every peer
// sees it ready.
__device__ __forceinline__ void mbarrier_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbarrier_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The one arrival of a phase, which also names the bytes the phase waits
// for.  Bytes that land before it are counted all the same.
__device__ __forceinline__ void mbarrier_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` is complete; what the senders
// wrote is then visible to this thread.
__device__ __forceinline__ void mbarrier_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n"
      "@done bra DONE_%=;\n"
      "bra WAIT_%=;\n"
      "DONE_%=:\n"
      "}" :: "r"(bar), "r"(parity) : "memory");
}

// Write 16 bytes to `addr` in a peer's shared memory and count them on the
// peer's barrier `bar` (both addresses from peer_address).
__device__ __forceinline__ void send16(uint32_t addr, uint32_t bar,
                                       long long a, long long b) {
  asm volatile(
      "st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.v2.b64 "
      "[%0], {%1, %2}, [%3];"
      :: "r"(addr), "l"(a), "l"(b), "r"(bar) : "memory");
}

// ---- host side --------------------------------------------------------------

// The launch configuration of `grid` CTAs of `threads` threads in clusters
// of `cluster`, with `smem` bytes of dynamic shared memory, on `stream`.
// `attr` must live as long as `cfg` is used.
inline void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                           unsigned grid, int cluster, int threads,
                           size_t smem, void* stream) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

// Runs `body` with device `dev` current and prepared (`prepare(dev)` makes
// a kernel's once-per-device set-up and is cheap after the first time),
// then restores the caller's device.
template <class Prepare, class Body>
cudaError_t on_device(int dev, Prepare prepare, Body body) {
  int cur = 0;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  if (cur != dev && (e = cudaSetDevice(dev)) != cudaSuccess) return e;
  e = prepare(dev);
  if (e == cudaSuccess) e = body();
  if (cur != dev) cudaSetDevice(cur);
  return e;
}
