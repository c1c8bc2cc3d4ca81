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
// tol).  Every elementwise product and sum is rounded as the plain
// version's tensor operations round it (no contraction into fused
// multiply-adds; a number over a tensor is its reciprocal times the
// number, as torch computes it); the dot products are summed in another
// order, and two of them are folded (below).
//
// What bounds it: a step is a chain of dependent cluster reductions with
// about 60 FP64 operations an element between them; at the primal-dual
// study's 400 x 10 the FP64 work spread over 16 SMs is ~0.1 us, and the
// reductions' latency is the step.  Clocked on the five-reduction design
// this replaces (16 CTAs of 256 threads, 6.9 us a step on an H100): the
// reductions took 70% of a step's clocks (lanes 11%, the block barrier
// and the warps 18%, the exchange 17%, the butterfly over CTAs 24%), the
// passes over the elements, which read shared and global memory, 19%, and
// the scalar tail 11%.  So:
//
// * three reductions a step, not five.  Whether P is active decides two
//   folds, and every thread of every CTA holds the norm that decides it
//   bit for bit, so the branch is uniform:
//     - <X_mid, X_mid> is sum a^2 (a = X + eta gX, summed beside
//       ||max(a, 0)||^2) where P is inactive, and radius^2 where it is;
//     - f(X_cand, lam_new) needs no pass of its own: with e = X_new + eta
//       gX, its sums are sum G (e - y), sum e^2 and sum lam_new e where P
//       is inactive, and s sum G max(e, 0) - sum G y, radius^2 and s sum
//       lam_new max(e, 0), s = radius / ||max(e, 0)||, where it is; the
//       pass over X_new (reduction D) sums all of them beside its own
//       four, and sum G y is one reduction before the loop.
//   That leaves A (||max(a, 0)||^2, sum a^2), C (||max(X + eta gXm,
//   0)||^2) and D (nine sums).  <X_new, X_new> is the next step's <X, X>;
// * each thread owns E elements (E a template parameter: 1, 2, 4, 8; the
//   layout comes from ops/dual_prox.py::dual_prox_plan) and keeps their
//   G, y, X and lam, and a step's gX, X_mid and X + eta gXm, in registers
//   across the loop: no pass reads memory.  Past what registers hold
//   (E = 0) the five per-element arrays live in shared memory or in a
//   global scratch, and G and y are read from global memory;
// * a reduction has no block barrier and no butterfly over CTAs
//   (reduce): each warp sums its lanes' values column by column through a
//   table in shared memory, its lanes send the column sums by st.async
//   into the warp's slot of every CTA of the cluster (csrc/cluster.cuh),
//   counted on each CTA's transaction barrier, and each warp sums the C x
//   warps slots column by column.  Every CTA sums the same slots in the
//   same order, so every thread of every CTA holds the same bits and
//   takes the same branches and exit without a broadcast.  On one CTA the
//   warps write their slots behind one block barrier.  The slots and
//   barriers come in two sets used in turn: a warp sends pass p + 2 only
//   after the slots of pass p + 1 came from every warp, each of which had
//   read its pass-p slots before sending.
//   At the study's plan (16 CTAs of 64 threads, 4 elements a thread) a
//   step took 3.0 us on an H100: the three reductions 55% of its clocks
//   (a warp's table 14%, the exchange 19%, the slots 22%), the passes
//   28%, the tail (sqrt, reciprocals, the gap) 17%;
// * X and the step count go to device buffers; thread 0 of CTA 0 adds one
//   to a device int64, the launch count that a graph's replays add to.
//   The timed instance of each layout also clocks thread 0 of CTA 0's
//   stages of a step (Stage below) into a device int64 array.
//
// Interface: plain C, loaded with ctypes; L is a device scalar (a line
// search's trial value), the oracle's constants are the launch's
// arguments.  The wrapper allocates outputs and scratch with torch.empty;
// the kernel launches on the caller's stream.

#include <cuda_runtime.h>
#include <cmath>

#include "cluster.cuh"

namespace {

constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 64;
constexpr int kSlot = 10;    // doubles a warp's sums take in a slot
constexpr int kRow = 11;     // ... a lane's in its warp's table (odd: no
                             // two lanes of a half-warp share a bank)
constexpr int kArrays = 5;   // E = 0: X, lam, gX, a | X_mid, d an element
constexpr unsigned kFull = 0xffffffffu;

// The most threads a CTA of each layout takes: the registers E elements
// need (65536 a CTA of one per SM); with the arrays in memory (E = 0), few
// enough that the warps' tables leave shared memory to the arrays.
__host__ __device__ constexpr int max_threads(int E) {
  return E >= 8 || E == 0 ? 256 : E >= 2 ? 512 : 1024;
}

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

// The stages of a step that thread 0 of CTA 0 clocks in the timed kernel.
enum Stage {
  kElementwise,  // the passes over the elements
  kWarp,         // each reduction's sum over a warp's lanes
  kBlock,        // ... on one CTA: the block barrier
  kExchange,     // ... the sends to the peers and the wait for theirs
  kCombine,      // ... the sum over the slots and the shuffle out
  kTail,         // the scalars: sqrt, reciprocals, the gap, the exit test
  kStages
};

template <bool kTimed>
struct Clock {
  long long* slots;  // kStages sums in shared memory
  long long last;
  bool on;
  __device__ __forceinline__ void tick(int stage) {
    if (kTimed && on) {
      const long long t = clock64();
      slots[stage] += t - last;
      last = t;
    }
  }
};

// Where a reduction's sums go.
struct Net {
  double* table;      // this warp's [32][kRow] lane sums
  double* slots;      // [2][S][kSlot]: the warps' sums, slot rank W + warp
  uint32_t own_slot;  // this warp's slot [0][rank W + warp] (a peer's: mapa)
  uint32_t bar;       // this CTA's barrier[0]
  int lane, warp, S, C, pass;  // S = C x warps slots, a power of two
};

// Write 8 bytes to `addr` in a peer's shared memory and count them on the
// peer's barrier `bar`.
__device__ __forceinline__ void send8(uint32_t addr, uint32_t bar,
                                      long long a) {
  asm volatile(
      "st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.b64 "
      "[%0], %1, [%2];" :: "r"(addr), "l"(a), "r"(bar) : "memory");
}

// Column q of rows [0, rows) of a table with `stride` doubles a row, in
// one fixed order: eight partial sums of every eighth row, then a tree
// over the eight.
__device__ __forceinline__ double column_sum(const double* t, int stride,
                                             int rows, int q) {
  double part[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) part[i] = i < rows ? t[i * stride + q] : 0.0;
  for (int r = 8; r < rows; r += 8)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      part[i] = add(part[i], t[(r + i) * stride + q]);
#pragma unroll
  for (int w = 4; w > 0; w >>= 1)
#pragma unroll
    for (int i = 0; i < w; ++i) part[i] = add(part[i], part[i + w]);
  return part[0];
}

// Sum v[0..V) over every thread of the cluster, transposed: the lanes
// write their sums into the warp's table and lane l sums its column q = l
// % V; lanes in groups of V send their column's sum into the warp's slot
// of every peer (group g to peers g, g + 32 / V, ...); each warp sums
// column q of the slots, and a shuffle from lane q hands every lane sum
// q.  Every warp of every CTA sums the same slots in the same order, so
// every thread returns the same bits.
template <int V, bool kTimed>
__device__ __forceinline__ void reduce(double (&v)[V], Net& net,
                                       Clock<kTimed>& clk) {
  const int q = net.lane % V;
#pragma unroll
  for (int c = 0; c < V; ++c) net.table[net.lane * kRow + c] = v[c];
  __syncwarp();
  double t = column_sum(net.table, kRow, 32, q);
  clk.tick(kWarp);
  if (net.S > 1) {
    const int set = net.pass & 1, parity = (net.pass >> 1) & 1;
    ++net.pass;
    if (net.C > 1) {
      const uint32_t bar = net.bar + set * 8;
      if (threadIdx.x == 0) mbarrier_expect(bar, 8 * V * net.S);
      constexpr int kGroups = 32 / V;
      const int group = net.lane / V;
      if (group < kGroups) {
        const uint32_t to = net.own_slot + (set * net.S * kSlot + q) * 8;
        for (int r = group; r < net.C; r += kGroups)
          send8(peer_address(to, r), peer_address(bar, r),
                __double_as_longlong(t));
      }
      mbarrier_wait(bar, parity);
      clk.tick(kExchange);
    } else {
      if (net.lane < V)
        net.slots[(set * net.S + net.warp) * kSlot + net.lane] = t;
      __syncthreads();
      clk.tick(kBlock);
    }
    t = column_sum(net.slots + set * net.S * kSlot, kSlot, net.S, q);
  }
#pragma unroll
  for (int c = 0; c < V; ++c) v[c] = __shfl_sync(kFull, t, c);
  clk.tick(kCombine);
}

struct Params {
  const double* G;
  const double* y;
  const double* L_in;
  double alpha, sigma, eta_base, tol, radius;
  long long n;
  int num_iters;
  int chunk;       // CTA r owns elements [r chunk, (r + 1) chunk) below n
  int smem_arrays; // E = 0: the arrays in shared memory (else scratch)
  double* scratch; // E = 0 and !smem_arrays: kArrays n doubles
  double* x_out;
  double* steps_out;
  long long* count;
  long long* prof;  // timed kernel: kStages clock sums, then the steps
};

// A step's scalars: the same bits in every thread.
struct StepScalars {
  double Lv, sigma, eta, an2, an2m;
  bool in_a, in_d;  // P inactive on a, on d
  double scale_a, scale_d;
};

// G - L (alpha n2 X + sigma X) - lam, in the plain version's order
__device__ __forceinline__ double grad_x(double g, double Lv, double an2,
                                         double sigma, double x,
                                         double lam) {
  return sub(sub(g, mul(Lv, add(mul(an2, x), mul(sigma, x)))), lam);
}

// L (alpha/4 n2 n2 + sigma/2 n2)
__device__ __forceinline__ double quartic(double Lv, double n2, double alpha,
                                          double sigma) {
  return mul(Lv, add(mul(mul(alpha / 4.0, n2), n2), mul(sigma / 2.0, n2)));
}

// A, one element: gX, a = X + eta gX; ||max(a, 0)||^2 and sum a^2
__device__ __forceinline__ void pass_a(const StepScalars& s, double g,
                                       double x, double l, double& gx,
                                       double& a, double (&sum)[2]) {
  gx = grad_x(g, s.Lv, s.an2, s.sigma, x, l);
  a = add(x, mul(s.eta, gx));
  const double ap = pos(a);
  sum[0] = add(sum[0], mul(ap, ap));
  sum[1] = add(sum[1], mul(a, a));
}

// C, one element: X_mid = P(a) (into a), d = X + eta gXm; ||max(d, 0)||^2
__device__ __forceinline__ void pass_c(const StepScalars& s, double g,
                                       double x, double l, double& a,
                                       double& d, double (&sum)[1]) {
  const double xm = s.in_a ? a : mul(s.scale_a, pos(a));
  a = xm;
  const double lm = pos(sub(l, mul(s.eta, -x)));
  const double gm = grad_x(g, s.Lv, s.an2m, s.sigma, xm, lm);
  d = add(x, mul(s.eta, gm));
  const double dp = pos(d);
  sum[0] = add(sum[0], mul(dp, dp));
}

// D, one element: X_new = P(d), lam_new into x, l; e = X_new + eta gX;
// ||max(e, 0)||^2, f(X_new, lam_cand)'s three sums, f(X_cand, lam_new)'s
// three where P is inactive on e, and its two where it is active
__device__ __forceinline__ void pass_d(const StepScalars& s, double g,
                                       double yv, double& x, double& l,
                                       double gx, double xm, double d,
                                       double (&sum)[9]) {
  const double xn = s.in_d ? d : mul(s.scale_d, pos(d));
  const double ln = pos(sub(l, mul(s.eta, -xm)));
  const double e = add(xn, mul(s.eta, gx));
  const double lc = pos(sub(ln, mul(s.eta, -x)));
  const double ep = pos(e);
  sum[0] = add(sum[0], mul(ep, ep));
  sum[1] = add(sum[1], mul(g, sub(xn, yv)));
  sum[2] = add(sum[2], mul(xn, xn));
  sum[3] = add(sum[3], mul(lc, xn));
  sum[4] = add(sum[4], mul(g, sub(e, yv)));
  sum[5] = add(sum[5], mul(e, e));
  sum[6] = add(sum[6], mul(ln, e));
  sum[7] = add(sum[7], mul(g, ep));
  sum[8] = add(sum[8], mul(ln, ep));
  x = xn;
  l = ln;
}

// E > 0: each thread's elements k T + tid (k < E) of its CTA's chunk in
// registers; E = 0: every T-th element from tid in the arrays.
template <int E, bool kTimed>
__global__ void __launch_bounds__(max_threads(E), 1)
dual_prox_kernel(Params p) {
  extern __shared__ __align__(16) double smem[];
  __shared__ alignas(8) unsigned long long s_bar[2];
  __shared__ long long s_prof[kStages];
  const int tid = threadIdx.x, T = blockDim.x;
  Clock<kTimed> clk{s_prof, 0, kTimed && blockIdx.x == 0 && tid == 0};
  if (clk.on)
    for (int q = 0; q < kStages; ++q) s_prof[q] = 0;

  Net net;
  net.lane = tid & 31;
  net.warp = tid >> 5;
  net.C = (int)gridDim.x;  // the grid is one cluster
  net.S = net.C * (T >> 5);
  net.pass = 0;
  net.slots = smem;
  net.table = smem + (net.S > 1 ? 2 * net.S * kSlot : 0) +
              net.warp * 32 * kRow;
  const int rank = (int)blockIdx.x;
  net.own_slot = smem_address(smem + (rank * (T >> 5) + net.warp) * kSlot);
  net.bar = smem_address(&s_bar[0]);
  if (net.C > 1) {
    if (tid == 0) {
      mbarrier_init(smem_address(&s_bar[0]));
      mbarrier_init(smem_address(&s_bar[1]));
      mbarrier_init_fence();
    }
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  }

  // this CTA's elements [lo, lo + cnt)
  const long long lo = (long long)rank * p.chunk;
  const int cnt = (int)max(0LL, min((long long)p.chunk, p.n - lo));
  const double* Gh = p.G + lo;
  const double* yh = p.y + lo;
  StepScalars s;
  s.Lv = *p.L_in;
  s.sigma = p.sigma;
  const double r2 = mul(p.radius, p.radius);

  // E > 0: the elements in registers
  double g[E > 0 ? E : 1], yv[E > 0 ? E : 1], x[E > 0 ? E : 1],
      l[E > 0 ? E : 1], gx[E > 0 ? E : 1], a[E > 0 ? E : 1],
      d[E > 0 ? E : 1];
  // E = 0: the arrays
  double *X = nullptr, *lam = nullptr, *gX = nullptr, *A = nullptr,
         *D = nullptr;
  double sy[1] = {0.0};
  if (E > 0) {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int j = k * T + tid;
      const bool own = j < cnt;
      g[k] = own ? Gh[j] : 0.0;
      yv[k] = own ? yh[j] : 0.0;
      x[k] = l[k] = gx[k] = a[k] = d[k] = 0.0;
      if (own) sy[0] = add(sy[0], mul(g[k], yv[k]));
    }
  } else {
    const int stride = p.smem_arrays ? p.chunk : cnt;
    X = p.smem_arrays ? smem + (net.S > 1 ? 2 * net.S * kSlot : 0) +
                            (T >> 5) * 32 * kRow
                      : p.scratch + (long long)kArrays * lo;
    lam = X + stride;
    gX = X + 2 * stride;
    A = X + 3 * stride;
    D = X + 4 * stride;
    for (int j = tid; j < cnt; j += T) {
      X[j] = lam[j] = gX[j] = A[j] = D[j] = 0.0;
      sy[0] = add(sy[0], mul(Gh[j], yh[j]));
    }
  }
  if (net.C > 1)
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  reduce<1>(sy, net, clk);  // sum G y, for f(X_cand, lam_new) under P
  const double Gy = sy[0];

  if (clk.on) {  // the clocks count the loop's steps only
    for (int q = 0; q < kStages; ++q) s_prof[q] = 0;
    clk.last = clock64();
  }
  double it = 0.0, gap = INFINITY, n2 = 0.0;
  while (it < (double)p.num_iters && (it <= 1.0 || gap >= p.tol)) {
    s.eta = over(p.eta_base, add(it, 1.0));
    s.an2 = mul(p.alpha, n2);
    clk.tick(kTail);
    // A: gX, ||max(X + eta gX, 0)||^2 and <X + eta gX, X + eta gX>
    double sa[2] = {0.0, 0.0};
    if (E > 0) {
#pragma unroll
      for (int k = 0; k < E; ++k)
        if (k * T + tid < cnt) pass_a(s, g[k], x[k], l[k], gx[k], a[k], sa);
    } else {
      for (int j = tid; j < cnt; j += T) {
        double gj, aj;
        pass_a(s, Gh[j], X[j], lam[j], gj, aj, sa);
        gX[j] = gj;
        A[j] = aj;
      }
    }
    clk.tick(kElementwise);
    reduce<2>(sa, net, clk);
    const double norm_a = sqrt(sa[0]);
    s.in_a = norm_a <= p.radius;
    s.scale_a = s.in_a ? 0.0 : over(p.radius, norm_a);
    s.an2m = mul(p.alpha, s.in_a ? sa[1] : r2);  // alpha <X_mid, X_mid>
    clk.tick(kTail);
    // C: X_mid, ||max(X + eta gXm, 0)||^2
    double sc[1] = {0.0};
    if (E > 0) {
#pragma unroll
      for (int k = 0; k < E; ++k)
        if (k * T + tid < cnt) pass_c(s, g[k], x[k], l[k], a[k], d[k], sc);
    } else {
      for (int j = tid; j < cnt; j += T) {
        double aj = A[j], dj;
        pass_c(s, Gh[j], X[j], lam[j], aj, dj, sc);
        A[j] = aj;
        D[j] = dj;
      }
    }
    clk.tick(kElementwise);
    reduce<1>(sc, net, clk);
    const double norm_d = sqrt(sc[0]);
    s.in_d = norm_d <= p.radius;
    s.scale_d = s.in_d ? 0.0 : over(p.radius, norm_d);
    clk.tick(kTail);
    // D: X_new, lam_new, and the nine sums
    double sd[9] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    if (E > 0) {
#pragma unroll
      for (int k = 0; k < E; ++k)
        if (k * T + tid < cnt)
          pass_d(s, g[k], yv[k], x[k], l[k], gx[k], a[k], d[k], sd);
    } else {
      for (int j = tid; j < cnt; j += T) {
        double xj = X[j], lj = lam[j];
        pass_d(s, Gh[j], yh[j], xj, lj, gX[j], A[j], D[j], sd);
        X[j] = xj;
        lam[j] = lj;
      }
    }
    clk.tick(kElementwise);
    reduce<9>(sd, net, clk);
    const double norm_e = sqrt(sd[0]);
    const double f_new =
        sub(sub(sd[1], quartic(s.Lv, sd[2], p.alpha, p.sigma)), sd[3]);
    double f_cand;
    if (norm_e <= p.radius) {
      f_cand = sub(sub(sd[4], quartic(s.Lv, sd[5], p.alpha, p.sigma)), sd[6]);
    } else {
      const double scale_e = over(p.radius, norm_e);
      f_cand = sub(sub(sub(mul(scale_e, sd[7]), Gy),
                       quartic(s.Lv, r2, p.alpha, p.sigma)),
                   mul(scale_e, sd[8]));
    }
    gap = sub(f_cand, f_new);
    it = add(it, 1.0);
    n2 = sd[2];
    clk.tick(kTail);
  }
  if (E > 0) {
#pragma unroll
    for (int k = 0; k < E; ++k)
      if (k * T + tid < cnt) p.x_out[lo + k * T + tid] = x[k];
  } else {
    for (int j = tid; j < cnt; j += T) p.x_out[lo + j] = X[j];
  }
  if (rank == 0 && tid == 0) {
    *p.steps_out = it;
    *p.count += 1;
  }
  if (clk.on) {
    for (int q = 0; q < kStages; ++q) p.prof[q] += s_prof[q];
    p.prof[kStages] += (long long)it;
  }
  // no CTA leaves while a peer may still send into its slots
  if (net.C > 1) cluster_meet();
}

using Kernel = void (*)(Params);

// The kernel of a layout (E elements a thread; 0: the arrays in memory).
template <bool kTimed>
Kernel kernel_of(int E) {
  switch (E) {
    case 0: return dual_prox_kernel<0, kTimed>;
    case 1: return dual_prox_kernel<1, kTimed>;
    case 2: return dual_prox_kernel<2, kTimed>;
    case 4: return dual_prox_kernel<4, kTimed>;
    case 8: return dual_prox_kernel<8, kTimed>;
    default: return nullptr;
  }
}
constexpr int kLayouts[] = {0, 1, 2, 4, 8};

struct DeviceState {
  bool ready;
  int max_dynamic;  // bytes of dynamic shared memory every kernel may take
  cudaFuncAttributes attr[5];  // the untimed kernels, by kLayouts
};
DeviceState g_state[kMaxDevices];

int layout_index(int E) {
  for (int i = 0; i < 5; ++i)
    if (kLayouts[i] == E) return i;
  return -1;
}

cudaError_t set_attributes(Kernel k, int max_dynamic) {
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, max_dynamic);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(
      k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

cudaError_t prepare_device(int dev) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceState& st = g_state[dev];
  if (st.ready) return cudaSuccess;
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  // every kernel's static shared memory (the timed ones' clock slots too)
  int static_max = 0;
  for (int i = 0; i < 5; ++i) {
    cudaFuncAttributes timed;
    if ((e = cudaFuncGetAttributes(&st.attr[i], kernel_of<false>(
             kLayouts[i]))) != cudaSuccess ||
        (e = cudaFuncGetAttributes(&timed, kernel_of<true>(kLayouts[i]))) !=
            cudaSuccess)
      return e;
    for (size_t bytes : {st.attr[i].sharedSizeBytes, timed.sharedSizeBytes})
      if ((int)bytes > static_max) static_max = (int)bytes;
  }
  st.max_dynamic = optin - static_max;
  for (int E : kLayouts)
    for (Kernel k : {kernel_of<false>(E), kernel_of<true>(E)})
      if ((e = set_attributes(k, st.max_dynamic)) != cudaSuccess) return e;
  st.ready = true;
  return cudaSuccess;
}

size_t smem_bytes(int cluster, int threads, int chunk, int smem_arrays) {
  const int S = cluster * (threads / 32);
  return (S > 1 ? (size_t)2 * S * kSlot * sizeof(double) : 0) +
         (size_t)(threads / 32) * 32 * kRow * sizeof(double) +
         (smem_arrays ? (size_t)kArrays * chunk * sizeof(double) : 0);
}

bool layout_ok(long long n, int cluster, int threads, int chunk, int E,
               int smem_arrays) {
  const int warps = threads / 32;
  return n >= 1 && cluster >= 1 && cluster <= kMaxCluster &&
         (cluster & (cluster - 1)) == 0 && layout_index(E) >= 0 &&
         threads >= 32 && threads <= max_threads(E) && threads % 32 == 0 &&
         (warps & (warps - 1)) == 0 && chunk >= 1 &&
         (long long)chunk * cluster >= n &&
         (E == 0 || (long long)E * threads >= chunk) &&
         (E == 0 || !smem_arrays);
}

}  // namespace

extern "C" {

// The kernel of layout E (elements a thread; 0: arrays in memory) as
// compiled and the device's limit, after the once-per-device set-up:
// registers per thread, static shared bytes, local (spill) bytes per
// thread, dynamic shared bytes a CTA may ask for.
int dual_prox_info(int device, int per_thread, int* info) {
  const int i = layout_index(per_thread);
  if (i < 0) return (int)cudaErrorInvalidValue;
  return (int)on_device(device, prepare_device, [&]() {
    const DeviceState& st = g_state[device];
    info[0] = st.attr[i].numRegs;
    info[1] = (int)st.attr[i].sharedSizeBytes;
    info[2] = (int)st.attr[i].localSizeBytes;
    info[3] = st.max_dynamic;
    return cudaSuccess;
  });
}

// How many clusters of this layout the device can hold at once into
// *active (0: the card does not schedule such a cluster).
int dual_prox_active_clusters(int device, int cluster, int threads,
                              int chunk, int per_thread, int smem_arrays,
                              int* active) {
  if (layout_index(per_thread) < 0) return (int)cudaErrorInvalidValue;
  return (int)on_device(device, prepare_device, [&]() {
    const size_t smem = smem_bytes(cluster, threads, chunk, smem_arrays);
    if (smem > (size_t)g_state[device].max_dynamic)
      return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(cfg, attr, cluster, cluster, threads, smem, nullptr);
    return cudaOccupancyMaxActiveClusters(
        active, kernel_of<false>(per_thread), &cfg);
  });
}

// The prox of G (= g + grad h(y)) and y, n elements each, with L = *L_in:
// X into x_out[0..n) and the steps taken into steps_out[0], as one cluster
// of `cluster` CTAs of `threads` threads; CTA r owns `chunk` elements from
// r chunk, `per_thread` (1, 2, 4, 8) a thread in registers, or (0) in five
// arrays in shared memory if `smem_arrays`, else in scratch[5 n].
// `count` is the device's launch count; `prof`, if not null, kStages + 1
// int64 that thread 0 of CTA 0 adds its clocks per stage and the steps to
// (the timed kernel).  Returns the launch's cudaError_t (0 when the kernel
// was enqueued).
int dual_prox_run(const void* G, const void* y, const void* L_in, double alpha,
                  double sigma, double eta_base, double tol, double radius,
                  int num_iters, long long n, int cluster, int threads,
                  int chunk, int per_thread, int smem_arrays, void* scratch,
                  void* x_out, void* steps_out, void* count, void* prof,
                  int device, void* stream) {
  if (!layout_ok(n, cluster, threads, chunk, per_thread, smem_arrays) ||
      num_iters < 0 ||
      (per_thread == 0 && !smem_arrays && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)on_device(device, prepare_device, [&]() {
    const size_t smem = smem_bytes(cluster, threads, chunk, smem_arrays);
    if (smem > (size_t)g_state[device].max_dynamic)
      return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(cfg, attr, cluster, cluster, threads, smem, stream);
    Params p{static_cast<const double*>(G), static_cast<const double*>(y),
             static_cast<const double*>(L_in), alpha, sigma, eta_base, tol,
             radius, n, num_iters, chunk, smem_arrays,
             static_cast<double*>(scratch), static_cast<double*>(x_out),
             static_cast<double*>(steps_out),
             static_cast<long long*>(count), static_cast<long long*>(prof)};
    const Kernel k = prof ? kernel_of<true>(per_thread)
                          : kernel_of<false>(per_thread);
    cudaError_t e = cudaLaunchKernelEx(&cfg, k, p);
    return e != cudaSuccess ? e : cudaGetLastError();
  });
}

int dual_prox_stages() { return kStages; }

const char* dual_prox_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
