// Lazy-H launch block of the D-optimal design Frank-Wolfe(-away) solver,
// in FP64 for Hopper (sm_90a).
//
// Replaces the TPU kernel accbpg_and_fw_tpu/ops/pallas_dopt_lazy.py ::
// _lazy_kernel_body (and, through the batch entry, the same body over
// grid=(K,) of _build_lazy_chunk_fn_batch).  One launch runs up to kmax
// (<= kr) iterations on the lazy inverse H = alpha H0 + C diag(beta) C^T:
// pivots, slack stop test, step sizes, g = H V[:,v], u = g^T V with the
// pin u[v] = w[v], the w/x update with an exact zero on an away drop, the
// append of g as row k of C with beta_k = -c, and the rescale of alpha and
// beta by 1/(1 - tau).  The plain PyTorch version is
// ops/dopt_lazy.py::lazy_block_reference.
//
// What bounds it on this card.  The inputs are read once per launch in
// principle (V 40 MB and H0 8 MB at 1000x5000: about 0.015 ms of HBM
// time), and an iteration does 2 m n + 2 m^2 + 4 k m FP64 operations
// (12.5 MFLOP: under a microsecond).  What an iteration really costs is
// (a) touching V, H0 and C again, because every iteration needs all of
// them and no SM can hold them, and (b) a chain of dependent steps across
// the whole card: u needs the whole g, g needs the whole z = beta (C v),
// and the next pivot needs every w, so there are three grid-wide barriers
// and, after each, a round trip to the L2 for what the others wrote.  The
// TPU kernel kept V in VMEM; the H100 has no memory of that size, but its
// 132 SMs together hold 30 MB of shared memory and its L2 holds 50 MB.
// The design puts V where it never has to come from HBM again, and keeps
// the chain short:
//
// * column ownership.  A CTA owns a fixed panel of V's columns for the
//   whole launch (the share of its instance's n columns among the G CTAs
//   of its group; 37-38 columns at 1000x5000 on 132 SMs).  With the whole
//   g in shared memory it computes the complete u_j of its own columns
//   (lanes along the rows, a fixed-order butterfly sum), pins u[v], updates
//   w_j and x_j and forms its pivot candidates without leaving the CTA.
//   There are no partial sums of u in device memory and no separate
//   update phase: every SM works in every phase.
// * V resident on chip.  One persistent CTA per SM takes the dynamic
//   shared memory up to the opt-in limit (227 KB) and loads as many of its
//   columns as fit, once per launch, with cp.async from the V^T copy (a
//   column is contiguous there, so a warp reads it without bank
//   conflicts), and keeps their w and x beside them.  A warp takes up to
//   three resident columns at a time and reads g once for them: this part
//   is bound by the shared memory's bandwidth.  The columns that do not
//   fit are streamed from V^T each iteration, one per warp at a time with
//   16 loads in flight per lane; with H0 and C they fit the L2.  Half of
//   the warps stream first and half take their resident columns first, so
//   the two limits overlap.  The split follows from m and the
//   shared-memory limit (ops/dopt_lazy.py::launch_plan), down to no
//   resident column at the largest m.
// * H0 v and C v with every warp busy.  The rows of H0 are split over the
//   CTAs once, the rows of C round-robin; a CTA cuts each of its rows into
//   segments so that its warps all have work, and adds the segment sums in
//   a fixed order.  g is then formed by the CTA that owns the row, 8 rows
//   x 64 slices of C at a time; H0 v stays in the CTA's shared memory and
//   the beta of a row of C with the CTA that owns the row.
// * loads ahead of their use.  What does not depend on the step is
//   fetched into registers before the step is known: a warp's piece of H0
//   (or C) before the pivots, its piece of a streamed column before g is
//   formed.  Every staging loop issues all its loads before its first
//   store.  A round trip to the L2 costs about 0.4 us here, as much as the
//   arithmetic of a phase.
// * three grid barriers per iteration: after H0 v / z, after g, after the
//   w/x update.  The barrier is one counter that only grows: an arrival is
//   a release-add without a return value, the wait an acquire-load (no
//   fence, no relocatable device code), safe because the launch is
//   cooperative: all CTAs are co-resident or the launch is refused.
// * warp 0 of every CTA merges the per-CTA pivot candidates and computes
//   the step scalars (same inputs, same order, so the same bits in every
//   CTA), which saves a barrier; the candidate of the away pivot carries
//   x_j.  The other warps wait: the seven FP64 divisions are a serial
//   chain, and 16 copies of it would only take issue slots.
// * no floating-point atomics: every sum has a fixed order, so a launch
//   gives the same bits on every run.  Pivot reductions carry (value,
//   index) and break ties by the lowest index, as jnp.argmax/argmin do.
//
// The batch entry runs K instances side by side in ONE cooperative launch
// of K groups x G CTAs (two cooperative launches that each fill the card
// could not be co-resident).  A CTA works on instance blockIdx.x / G as
// CTA blockIdx.x % G of G, with the instance's own pointers, kmax, done
// flag, scratch and barrier word (in its own 128-byte line), so the groups
// never wait on each other; when K exceeds the SM count the instances run
// in waves of launches.  The single-instance entry is the K = 1
// instantiation with the whole grid as its group.
//
// Interface: plain C, loaded with ctypes.  The launch plan (group size,
// column and row split, resident columns, shared-memory bytes, scratch
// sizes) is made in Python (ops/dopt_lazy.py::launch_plan) and handed in
// as an int array; dopt_lazy_prepare checks it against the device once.
// The wrapper allocates every buffer; the kernel allocates nothing and
// launches on the caller's stream.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

#include "pivots.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 8;                   // g phase: rows per tile
constexpr int kSlices = kThreads / kTileRows;  // g phase: slices of C's rows
constexpr int kCols = 3;   // u phase: resident columns a warp takes at a time
constexpr int kCand = 5;   // pivots: candidates a lane loads at a time
constexpr int kPre = 16;   // loads a lane keeps in flight for streamed data
constexpr int kBarWords = 32;  // one 128-byte line
constexpr int kProfSlots = 8;  // profile: the prologue, the pivots, and the
                               // work and the barrier wait of three phases
constexpr unsigned kFull = 0xffffffffu;

// The launch plan's fields, in the order ops/dopt_lazy.py packs them.
enum PlanField {
  kGroup, kWave, kColBase, kColExtra, kRowBase, kRowExtra, kResident,
  kSegs, kSegLen, kSmemBytes, kDwords, kIwords, kPlanLen
};

struct Params {
  const double* VT;   // (K, n, m) row-major, V^T per instance
  const double* H0;   // (K, m, m)
  const double* x_in;
  const double* w_in;
  double* x;          // (K, n) out
  double* w;          // (K, n) out
  double* C;          // (K, kr, m) out: g rows
  double* beta;       // (K, kr) out
  double* misc;       // (K, 4) out: done, iters, alpha, nrun
  double* hist;       // (K, 5, kr) out: tau, tau (w_v - 1), SP, SN, pivot v
  double* dscr;       // double scratch, dwords per instance
  int* iscr;          // int scratch, iwords per instance: barrier line (the
                      // entries zero it), pivot indices
  long long* prof;    // optional: CTA 0's clocks per phase (8 slots)
  const int* kmax_b;  // (K) batch entry: per-instance kmax
  int* done_io;       // (K) stop flags, read at entry and written at exit,
                      // so a launch hands its stop to the next on the card
  double eps, xtol;
  int m, n, kr, kmax, away;
  int group;                 // CTAs per instance
  int col_base, col_extra;   // CTA b owns col_base + (b < col_extra) columns
  int row_base, row_extra;   // and row_base + (b < row_extra) rows of H0
  int resident;              // columns a CTA keeps in shared memory, at most
  int segs, seg_len;         // H0 v phase: segments per row, their length
  int dwords, iwords;        // scratch per instance
};

// One instance's view of the launch: its pointers and kmax,
// and this CTA's index b among the G CTAs of its group.
struct Inst {
  const double *VT, *H0, *x_in, *w_in;
  double *x, *w, *C, *beta, *misc, *hist, *dscr;
  int* iscr;
  int b, G, kmax;
};

template <bool kBatch>
__device__ __forceinline__ Inst instance(const Params& p) {
  const size_t k = kBatch ? blockIdx.x / p.group : 0;
  const size_t mn = (size_t)p.m * p.n, n = p.n, m = p.m, kr = p.kr;
  Inst q;
  q.b = kBatch ? blockIdx.x % p.group : blockIdx.x;
  q.G = p.group;
  q.VT = p.VT + k * mn;
  q.H0 = p.H0 + k * m * m;
  q.x_in = p.x_in + k * n;
  q.w_in = p.w_in + k * n;
  q.x = p.x + k * n;
  q.w = p.w + k * n;
  q.C = p.C + k * kr * m;
  q.beta = p.beta + k * kr;
  q.misc = p.misc + k * 4;
  q.hist = p.hist + k * 5 * kr;
  q.dscr = p.dscr + k * p.dwords;
  q.iscr = p.iscr + k * p.iwords;
  q.kmax = kBatch ? p.kmax_b[k] : p.kmax;
  return q;
}

// First element of share b when `base * G + extra` elements are split over
// G owners, the first `extra` of which take one more.
__device__ __forceinline__ int split_start(int b, int base, int extra) {
  return b * base + min(b, extra);
}

// A launch whose instance enters with its stop flag set (the rest of a
// group after a stop by eps): this CTA hands x and w of its columns
// through, CTA 0 writes the empty block's misc, and none waits at a
// barrier.  The kernel tests the flag first, before it forms any of the
// instance's pointers, and this path is inlined: the body then compiles as
// it does without the test.  Tested inside the body, the exit changed the
// body's register allocation and slowed every block on an H100; as a call
// that is not inlined, far more.
template <bool kBatch>
__device__ __forceinline__ void enter_stopped(const Params& p) {
  const size_t k = kBatch ? blockIdx.x / p.group : 0;
  const int b = kBatch ? blockIdx.x % p.group : blockIdx.x;
  const int c0 = split_start(b, p.col_base, p.col_extra);
  const int pc = p.col_base + (b < p.col_extra ? 1 : 0);
  const size_t off = k * p.n + c0;
  for (int c = threadIdx.x; c < pc; c += kThreads) {
    p.x[off + c] = p.x_in[off + c];
    p.w[off + c] = p.w_in[off + c];
  }
  if (b == 0 && threadIdx.x == 0) {
    double* misc = p.misc + k * 4;
    misc[0] = 1.0;
    misc[1] = 0.0;
    misc[2] = 1.0;
    misc[3] = 0.0;
  }
}

// Barrier over the G CTAs of one group: one counter that only grows.  A
// CTA adds one (a release, so what it wrote before is visible to whoever
// sees the count) and waits until the count reaches G times the number of
// barriers so far (an acquire).  No fence and no atomic with a return
// value stands in the way of the arrival.  The entry zeroes the counter
// before each launch; co-residency of all CTAs is guaranteed by the
// cooperative launch.
__device__ __forceinline__ void grid_sync(int* bar, int& target, int G) {
  __syncthreads();
  if (threadIdx.x == 0) {
    target += G;
    asm volatile("red.release.gpu.global.add.s32 [%0], 1;" ::"l"(bar)
                 : "memory");
    int seen;
    do {
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(bar)
                   : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

__device__ __forceinline__ void cp_async8(double* smem_dst,
                                          const double* gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Pivot candidates: (max w, argmax) over all columns and (min w, argmin,
// x at the argmin) over the support; ties go to the lowest index.
struct Piv {
  double vmax, vmin, xmin;
  int imax, imin;
};

__device__ __forceinline__ Piv piv_identity() {
  Piv p;
  p.vmax = -INFINITY; p.imax = INT_MAX;
  p.vmin = INFINITY; p.imin = INT_MAX; p.xmin = 0.0;
  return p;
}

__device__ __forceinline__ void piv_min(Piv& p, double v, int i, double x) {
  if (v < p.vmin || (v == p.vmin && i < p.imin)) {
    p.vmin = v; p.imin = i; p.xmin = x;
  }
}

__device__ __forceinline__ void piv_merge(Piv& p, const Piv& o) {
  max_pair(p.vmax, p.imax, o.vmax, o.imax);
  piv_min(p, o.vmin, o.imin, o.xmin);
}

// Warp-wide merge; every lane gets the result.  The values go through a
// max/min butterfly, the indices through the warp's integer min over the
// lanes that hold the winning value, and x comes from the winning lane.
__device__ __forceinline__ Piv warp_piv(const Piv& p) {
  Piv o;
  o.vmax = p.vmax;
  o.vmin = p.vmin;
  for (int off = 16; off > 0; off >>= 1) {
    o.vmax = fmax(o.vmax, __shfl_xor_sync(kFull, o.vmax, off));
    o.vmin = fmin(o.vmin, __shfl_xor_sync(kFull, o.vmin, off));
  }
  o.imax = __reduce_min_sync(kFull, p.vmax == o.vmax ? p.imax : INT_MAX);
  o.imin = __reduce_min_sync(kFull, p.vmin == o.vmin ? p.imin : INT_MAX);
  const unsigned who =
      __ballot_sync(kFull, p.vmin == o.vmin && p.imin == o.imin);
  o.xmin = __shfl_sync(kFull, p.xmin, who ? __ffs(who) - 1 : 0);
  return o;
}

// One iteration's step, computed by warp 0 and read by every thread.
struct Step {
  double wv, tau, c, r;
  int v, drop, stop;
};

// dst[0:m] (shared) = src[0:m] (device memory, read past the L1) by the
// whole CTA, every load of a pass in flight before its first store.
__device__ __forceinline__ void stage(double* dst, const double* src, int m) {
  for (int s0 = threadIdx.x; s0 < m; s0 += 4 * kThreads) {
    double t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + i * kThreads;
      t[i] = s < m ? __ldcg(src + s) : 0.0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + i * kThreads;
      if (s < m) dst[s] = t[i];
    }
  }
}

// acc + <src[s0:s1], vec[s0:s1]> over a warp's lanes, src in device memory
// (read past the L1: it may have been written in this launch), kPre loads
// in flight per lane.
__device__ __forceinline__ double dot_stream(const double* src,
                                             const double* vec, int s0,
                                             int s1, int lane, double acc) {
  for (; s0 < s1; s0 += 32 * kPre) {
    double buf[kPre];
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      const int s = s0 + lane + 32 * i;
      buf[i] = s < s1 ? __ldcg(src + s) : 0.0;
    }
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      const int s = s0 + lane + 32 * i;
      if (s < s1) acc = fma(buf[i], vec[s], acc);
    }
  }
  return acc;
}

// u_i = <column i, g> for NC columns at once (g is read once for them);
// every lane gets every sum, in a fixed order.
template <int NC>
__device__ __forceinline__ void col_dots(const double* const* col,
                                         const double* g, int m, int lane,
                                         double* u) {
  double acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.0;
#pragma unroll 4
  for (int s = lane; s < m; s += 32) {
    const double gs = g[s];
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[i] = fma(col[i][s], gs, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    for (int off = 16; off > 0; off >>= 1)
      acc[i] += __shfl_xor_sync(kFull, acc[i], off);
    u[i] = acc[i];
  }
}

template <bool kBatch>
__global__ void __launch_bounds__(kThreads, 1)
dopt_lazy_kernel(Params p) {
  // the stop flag is read before this CTA's first barrier arrival, which
  // CTA 0's write of it at the end follows
  if (p.done_io[kBatch ? blockIdx.x / p.group : 0]) {
    enter_stopped<kBatch>(p);
    return;
  }
  const Inst I = instance<kBatch>(p);
  extern __shared__ __align__(16) double smem[];
  __shared__ double s_red[kWarps][kTileRows];
  __shared__ Piv s_piv[kWarps];
  __shared__ Step s_step;

  const int G = I.G, b = I.b, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int m = p.m, kr = p.kr;
  const double m_f = (double)m;

  // this CTA's columns of V and rows of H0
  const int c0 = split_start(b, p.col_base, p.col_extra);
  const int pc = p.col_base + (b < p.col_extra ? 1 : 0);
  const int r0 = split_start(b, p.row_base, p.row_extra);
  const int pr = p.row_base + (b < p.row_extra ? 1 : 0);
  const int nres = min(pc, p.resident);

  // shared memory: column v of V, then g; the segment sums of phase 1;
  // the resident columns of V with their w and x; H0 v and the beta of
  // this CTA's rows
  double* s_vec = smem;
  double* s_part = s_vec + m;
  double* s_V = s_part + (p.row_base + 1 + (kr + G - 1) / G) * p.segs;
  double* s_w = s_V + (size_t)p.resident * m;  // w, x of the resident columns
  double* s_x = s_w + p.resident;
  double* s_h0v = s_x + p.resident;  // H0 v on this CTA's rows
  double* s_beta = s_h0v + p.row_base + 1;  // beta of this CTA's rows of C

  double* z = I.dscr;
  double* g = z + kr;
  double* pval = g + m;  // [G] max w, [G] min w, [G] x at the min
  int* bar = I.iscr;
  int target = 0;  // the barrier's count after the next arrival of all
  int* pidx = bar + kBarWords;

  // optional profile: thread 0 of CTA 0 adds its clocks since the last lap
  // to a slot in shared memory (a read of device memory here would stall
  // it for a round trip) and writes the slots out at the end
  __shared__ long long s_prof[kProfSlots];
  const bool prof = p.prof != nullptr && blockIdx.x == 0 && tid == 0;
  if (prof)
    for (int i = 0; i < kProfSlots; ++i) s_prof[i] = 0;
  long long t_last = prof ? clock64() : 0;
  auto lap = [&](int slot) {
    if (prof) {
      const long long t = clock64();
      s_prof[slot] += t - t_last;
      t_last = t;
    }
  };

  // ---- prologue: resident columns, the state, the first candidates -------
  {
    const double* src = I.VT + (size_t)c0 * m;
    const int count = nres * m;  // contiguous in V^T
    for (int s = tid; s < count; s += kThreads) cp_async8(s_V + s, src + s);
  }
  // The CTA's candidates, merged in a fixed order (lanes, then warps, by
  // warp 0 alone: the other warps have nothing to add) and written where
  // every CTA reads them after the barrier.
  auto publish = [&](Piv cand) {
    cand = warp_piv(cand);
    if (lane == 0) s_piv[warp] = cand;
    __syncthreads();
    if (warp == 0) {
      cand = warp_piv(s_piv[lane % kWarps]);
      if (lane == 0) {
        pval[b] = cand.vmax; pidx[b] = cand.imax;
        pval[G + b] = cand.vmin; pidx[G + b] = cand.imin;
        pval[2 * G + b] = cand.xmin;
      }
    }
  };
  auto consider = [&](Piv& cand, double wj, double xj, int j) {
    max_pair(cand.vmax, cand.imax, wj, j);
    const bool in_support = p.away ? (xj > p.xtol) : (xj > 0.0);
    if (in_support) piv_min(cand, wj, j, xj);
  };
  {
    Piv cand = piv_identity();
    for (int c = tid; c < pc; c += kThreads) {
      const int j = c0 + c;
      const double wj = I.w_in[j], xj = I.x_in[j];
      I.w[j] = wj;
      I.x[j] = xj;
      if (c < nres) {
        s_w[c] = wj;
        s_x[c] = xj;
      }
      consider(cand, wj, xj, j);
    }
    publish(cand);
  }
  // this warp's first streamed column, if it has one
  const int j_str = c0 + nres + warp;
  const bool str_live = nres + warp < pc;
  cp_async_wait_all();
  grid_sync(bar, target, G);
  lap(0);

  double alpha = 1.0;
  bool done = false;
  int k = 0;
  while (k < I.kmax && !done) {
    // ---- phase 1, ahead of its inputs ------------------------------------
    // rows of C: q = b, b + G, ... < k
    const int ncr = k > b ? (k - b + G - 1) / G : 0;
    const int nunits = (pr + ncr) * p.segs;
    auto unit_row = [&](int unit, int& s0, int& s1) -> const double* {
      const int t = unit / p.segs, seg = unit - t * p.segs;
      s0 = seg * p.seg_len;
      s1 = min(m, s0 + p.seg_len);
      return t < pr ? I.H0 + (size_t)(r0 + t) * m
                    : I.C + (size_t)(b + (t - pr) * G) * m;
    };
    // the first piece of this warp's first row of H0 or C goes into
    // registers now, so that its round trip to the L2 runs under the pivots
    // and the fetch of column v
    double pre[kPre];
    const bool pre_live = warp < nunits;
    if (pre_live) {
      int s0, s1;
      const double* row = unit_row(warp, s0, s1);
#pragma unroll
      for (int i = 0; i < kPre; ++i) {
        const int s = s0 + lane + 32 * i;
        pre[i] = s < s1 ? __ldcg(row + s) : 0.0;
      }
    }

    // ---- pivots and step scalars: warp 0 of every CTA, redundantly (the
    //      same inputs in the same order give every CTA the same bits).
    //      The other warps only wait: 16 warps doing this serial arithmetic
    //      would spend the SM's issue slots on copies of it ------------------
    if (warp == 0) {
      // every load of a pass is in flight before the first merge: one round
      // trip for up to 32 kCand CTAs
      Piv pv = piv_identity();
      for (int q0 = lane; q0 < G; q0 += 32 * kCand) {
        Piv o[kCand];
#pragma unroll
        for (int i = 0; i < kCand; ++i) {
          const int q = q0 + 32 * i;
          o[i] = piv_identity();
          if (q < G) {
            o[i].vmax = __ldcg(pval + q); o[i].imax = __ldcg(pidx + q);
            o[i].vmin = __ldcg(pval + G + q);
            o[i].imin = __ldcg(pidx + G + q);
            o[i].xmin = __ldcg(pval + 2 * G + q);
          }
        }
#pragma unroll
        for (int i = 0; i < kCand; ++i) piv_merge(pv, o[i]);
      }
      pv = warp_piv(pv);
      const double wi = pv.vmax, wj = pv.vmin;
      const double sp = (wi - m_f) / m_f;
      const double sn = (m_f - wj) / m_f;
      Step st;
      st.stop = (sp <= p.eps) && (sn <= p.eps);
      st.v = pv.imax;
      st.wv = wi;
      st.tau = sp / (wi - 1.0);
      st.drop = 0;
      if (p.away && !(sp >= sn)) {
        const double xj = pv.xmin;
        const double a1 = sn / (wj - 1.0);
        const double a2 = xj / (1.0 - xj);
        const bool use_a1 = a1 < a2;
        st.v = pv.imin;
        st.wv = wj;
        st.tau = -(use_a1 ? a1 : a2);
        st.drop = !use_a1;
      }
      const double wvm1 = st.wv - 1.0;
      st.c = st.tau / (1.0 + st.tau * wvm1);
      st.r = 1.0 / (1.0 - st.tau);
      if (lane == 0) {
        s_step = st;
        if (b == 0) {  // the row's record; the stop row holds slacks only
          I.hist[k] = st.stop ? 0.0 : st.tau;
          I.hist[kr + k] = st.stop ? 0.0 : st.tau * wvm1;
          I.hist[2 * kr + k] = sp;
          I.hist[3 * kr + k] = sn;
          I.hist[4 * kr + k] = st.stop ? -1.0 : (double)st.v;
        }
      }
    }
    __syncthreads();
    if (s_step.stop) {
      done = true;
      ++k;
      break;  // uniform: every CTA computed the same stop
    }
    const int v = s_step.v;
    const bool drop = s_step.drop != 0;
    const double wv = s_step.wv, tau = s_step.tau, c = s_step.c,
                 r = s_step.r;
    lap(1);

    // ---- phase 1: H0 v and z_q = beta_q (C_q . v) over this CTA's rows ---
    {
      stage(s_vec, I.VT + (size_t)v * m, m);
      __syncthreads();
      for (int unit = warp; unit < nunits; unit += kWarps) {
        int s0, s1;
        const double* row = unit_row(unit, s0, s1);
        double acc = 0.0;
        if (unit == warp && pre_live) {
#pragma unroll
          for (int i = 0; i < kPre; ++i) {
            const int s = s0 + lane + 32 * i;
            if (s < s1) acc = fma(pre[i], s_vec[s], acc);
          }
          s0 += 32 * kPre;
        }
        acc = dot_stream(row, s_vec, s0, s1, lane, acc);
        acc = warp_sum(acc);
        if (lane == 0) s_part[unit] = acc;
      }
      __syncthreads();
      for (int t = tid; t < pr + ncr; t += kThreads) {
        double s = 0.0;
        for (int seg = 0; seg < p.segs; ++seg) s += s_part[t * p.segs + seg];
        if (t < pr) {
          s_h0v[t] = s;  // read by this CTA alone, in phase 2
        } else {
          // z_q, then this row's beta *= r
          const double bq = s_beta[t - pr];
          z[b + (t - pr) * G] = bq * s;
          s_beta[t - pr] = bq * r;
        }
      }
      // row k of C will be this CTA's when k = b (mod G): beta_k = -c r
      if (tid == 0 && k % G == b) s_beta[k / G] = -c * r;
    }
    lap(2);
    grid_sync(bar, target, G);
    lap(3);

    // ---- phase 3, ahead of its inputs: the first piece of this warp's
    //      first streamed column, and that column's w and x, go into
    //      registers now; the round trip runs under phase 2 -----------------
    double w_str = 0.0, x_str = 0.0;
    if (str_live) {
      const double* col = I.VT + (size_t)j_str * m;
#pragma unroll
      for (int i = 0; i < kPre; ++i) {
        const int s = lane + 32 * i;
        pre[i] = s < m ? __ldg(col + s) : 0.0;
      }
      if (lane == 0) {
        w_str = __ldcg(I.w + j_str);
        x_str = __ldcg(I.x + j_str);
      }
    }

    // ---- phase 2: g = alpha H0 v + sum_q z_q C_q on this CTA's rows;
    //      append g as row k of C -------------------------------------------
    {
      const int tx = tid % kTileRows, ty = tid / kTileRows;
      for (int t0 = 0; t0 < pr; t0 += kTileRows) {
        const int row = r0 + t0 + tx;
        const bool live = t0 + tx < pr;
        double acc = 0.0;
        if (live) {
          // four slices' loads in flight at once
          for (int q0 = ty; q0 < k; q0 += 4 * kSlices) {
            double zq[4], cq[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int q = q0 + i * kSlices;
              zq[i] = q < k ? __ldcg(z + q) : 0.0;
              cq[i] = q < k ? __ldcg(I.C + (size_t)q * m + row) : 0.0;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) acc = fma(zq[i], cq[i], acc);
          }
        }
        // lanes 8 and 16 apart hold the same row
        acc += __shfl_xor_sync(kFull, acc, 8);
        acc += __shfl_xor_sync(kFull, acc, 16);
        if (lane < kTileRows) s_red[warp][lane] = acc;
        __syncthreads();
        if (tid < kTileRows && live) {
          double s = 0.0;
          for (int q = 0; q < kWarps; ++q) s += s_red[q][tid];
          const double gr = alpha * s_h0v[t0 + tid] + s;
          g[row] = gr;
          I.C[(size_t)k * m + row] = gr;
        }
        __syncthreads();
      }
      alpha *= r;
    }
    lap(4);
    grid_sync(bar, target, G);
    lap(5);

    // ---- phase 3: u, w and x on this CTA's columns; the next candidates --
    {
      stage(s_vec, g, m);
      __syncthreads();
      Piv cand = piv_identity();
      auto update = [&](int j, double uj, double& wj, double& xj) {
        if (j == v) uj = wv;  // consistency pin u[v] = w[v]
        wj = (wj - c * (uj * uj)) * r;
        const double xs = xj * (1.0 - tau);
        xj = (j == v) ? (drop ? 0.0 : xs + tau) : xs;
        I.w[j] = wj;
        I.x[j] = xj;
        consider(cand, wj, xj, j);
      };
      // Streaming is bound by the L2 and the resident columns by shared
      // memory, so half of the warps take each first.
      auto streamed_cols = [&]() {
        // streamed columns, one at a time, kPre loads in flight per lane:
        // warp w takes nres + w, nres + w + kWarps, ...
        for (int ci = nres + warp; ci < pc; ci += kWarps) {
          const int j = c0 + ci;
          const double* col = I.VT + (size_t)j * m;
          double acc = 0.0, wj_old = w_str, xj_old = x_str;
          int s0 = 0;
          if (j == j_str) {
#pragma unroll
            for (int i = 0; i < kPre; ++i) {
              const int s = lane + 32 * i;
              if (s < m) acc = fma(pre[i], s_vec[s], acc);
            }
            s0 = 32 * kPre;
          } else if (lane == 0) {
            wj_old = __ldcg(I.w + j);
            xj_old = __ldcg(I.x + j);
          }
          acc = dot_stream(col, s_vec, s0, m, lane, acc);
          for (int off = 16; off > 0; off >>= 1)
            acc += __shfl_xor_sync(kFull, acc, off);
          if (lane == 0) update(j, acc, wj_old, xj_old);
        }
      };
      auto resident_cols = [&]() {
        // resident columns, up to kCols at a time (g is read once for them):
        // warp w takes w, w + kWarps, ...
        for (int cb = warp; cb < nres; cb += kCols * kWarps) {
          const int nc = min(kCols, (nres - cb + kWarps - 1) / kWarps);
          const double* col[kCols];
#pragma unroll
          for (int i = 0; i < kCols; ++i)
            col[i] = s_V + (size_t)(i < nc ? cb + i * kWarps : cb) * m;
          double u[kCols] = {0.0, 0.0, 0.0};
          if (nc == 3) col_dots<3>(col, s_vec, m, lane, u);
          else if (nc == 2) col_dots<2>(col, s_vec, m, lane, u);
          else col_dots<1>(col, s_vec, m, lane, u);
          if (lane < nc) {  // lane i updates column i
            const int ci = cb + lane * kWarps;
            update(c0 + ci, lane == 0 ? u[0] : (lane == 1 ? u[1] : u[2]),
                   s_w[ci], s_x[ci]);
          }
        }
      };
      if (warp & 1) {
        resident_cols();
        streamed_cols();
      } else {
        streamed_cols();
        resident_cols();
      }
      publish(cand);
    }
    lap(6);
    grid_sync(bar, target, G);
    lap(7);
    ++k;
  }

  // beta of this CTA's rows of C (the threads that kept them write them)
  for (int i = tid; b + i * G < k - (done ? 1 : 0); i += kThreads)
    I.beta[b + i * G] = s_beta[i];
  if (prof)
    for (int i = 0; i < kProfSlots; ++i) p.prof[i] = s_prof[i];
  if (b == 0 && tid == 0) {
    // only the stop row records without running
    I.misc[0] = done ? 1.0 : 0.0;
    I.misc[1] = (double)k;
    I.misc[2] = alpha;
    I.misc[3] = (double)(done ? k - 1 : k);
    // the pointer comes from the launch parameters again: an instance's
    // own would hold two registers through the loop
    p.done_io[kBatch ? blockIdx.x / p.group : 0] = done ? 1 : 0;
  }
}

Params make_params(const int* plan, const void* VT, const void* H0,
                   const void* x_in, const void* w_in, void* x, void* w,
                   void* C, void* beta, void* misc, void* hist, void* dscr,
                   void* iscr, double eps, double xtol, int m, int n, int kr,
                   int away) {
  Params p;
  p.VT = static_cast<const double*>(VT);
  p.H0 = static_cast<const double*>(H0);
  p.x_in = static_cast<const double*>(x_in);
  p.w_in = static_cast<const double*>(w_in);
  p.x = static_cast<double*>(x);
  p.w = static_cast<double*>(w);
  p.C = static_cast<double*>(C);
  p.beta = static_cast<double*>(beta);
  p.misc = static_cast<double*>(misc);
  p.hist = static_cast<double*>(hist);
  p.dscr = static_cast<double*>(dscr);
  p.iscr = static_cast<int*>(iscr);
  p.prof = nullptr;
  p.kmax_b = nullptr;
  p.done_io = nullptr;
  p.eps = eps;
  p.xtol = xtol;
  p.m = m;
  p.n = n;
  p.kr = kr;
  p.kmax = 0;
  p.away = away;
  p.group = plan[kGroup];
  p.col_base = plan[kColBase];
  p.col_extra = plan[kColExtra];
  p.row_base = plan[kRowBase];
  p.row_extra = plan[kRowExtra];
  p.resident = plan[kResident];
  p.segs = plan[kSegs];
  p.seg_len = plan[kSegLen];
  p.dwords = plan[kDwords];
  p.iwords = plan[kIwords];
  return p;
}

// A plan the kernel can run: the splits cover n columns and m rows, and
// the shared memory it names holds what the kernel puts there.
bool plan_ok(const int* plan, int m, int n, int kr) {
  const long long G = plan[kGroup];
  if (G < 1 || plan[kWave] < 1 || plan[kSegs] < 1 || plan[kResident] < 0 ||
      plan[kSegLen] < 1 || plan[kSegLen] % 32 != 0)
    return false;
  if (plan[kColBase] * G + plan[kColExtra] != n || plan[kColExtra] >= G ||
      plan[kColExtra] < 0 || plan[kRowBase] * G + plan[kRowExtra] != m ||
      plan[kRowExtra] >= G || plan[kRowExtra] < 0)
    return false;
  if ((long long)plan[kSegs] * plan[kSegLen] < m) return false;
  const long long part = (plan[kRowBase] + 1 + (kr + G - 1) / G) * plan[kSegs];
  const long long need =
      8LL * (m + part + plan[kRowBase] + 1 + (kr + G - 1) / G +
             (long long)plan[kResident] * (m + 2));
  return need <= plan[kSmemBytes] && plan[kDwords] >= m + kr + 3 * G &&
         plan[kIwords] >= kBarWords + 2 * G;
}

template <bool kBatch>
cudaError_t launch(Params& p, int grid, int smem, void* stream) {
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)dopt_lazy_kernel<kBatch>, dim3(grid), dim3(kThreads), args,
      (size_t)smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool kBatch>
cudaError_t prepare(const int* plan, int* info) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int coop = 0, sms = 0, optin = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, dopt_lazy_kernel<kBatch>);
  if (e != cudaSuccess) return e;
  // The attribute is the function's for the whole process, so it is set to
  // the most the device gives (the same value for every plan): preparing a
  // small design never lowers it under a larger one that is still in use.
  const int most = optin - (int)attr.sharedSizeBytes;
  if (plan[kSmemBytes] > most) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(dopt_lazy_kernel<kBatch>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dopt_lazy_kernel<kBatch>, kThreads, (size_t)plan[kSmemBytes]);
  if (e != cudaSuccess) return e;
  info[0] = attr.numRegs;
  info[1] = (int)attr.sharedSizeBytes;
  info[2] = per_sm;
  info[3] = sms;
  if ((long long)per_sm * sms < (long long)plan[kGroup] * plan[kWave])
    return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Number of ints in a launch plan, and the kernel's static shared memory
// is reported by dopt_lazy_prepare.
int dopt_lazy_plan_len() { return kPlanLen; }

// Checks a plan against the current device, once per solve: cooperative
// launch support, the dynamic shared memory opt-in, and that one wave's
// grid is co-resident.  info: registers per thread, static shared bytes,
// CTAs per SM at this shared-memory size, SMs.  Returns a cudaError_t.
int dopt_lazy_prepare(const int* plan, int m, int n, int kr, int batch,
                      int* info) {
  if (!plan_ok(plan, m, n, kr)) return (int)cudaErrorInvalidValue;
  return (int)(batch ? prepare<true>(plan, info) : prepare<false>(plan, info));
}

// One launch block on `stream` under a prepared plan.  `done_io` is a
// device int: the launch leaves at once, handing x and w through, when it
// is set at entry, and holds the launch's stop flag at exit.  `misc` and
// `hist` may point into any slot of a larger buffer, so the blocks of a
// group keep their rows apart.  `prof` is null or 8 zeroed int64 that CTA
// 0 adds its clocks per phase to.  Returns the launch's cudaError_t (0
// when the kernel was enqueued).
int dopt_lazy_run(const int* plan, const void* VT, const void* H0,
                  const void* x_in, const void* w_in, void* x, void* w,
                  void* C, void* beta, void* misc, void* hist, void* dscr,
                  void* iscr, void* done_io, void* prof, double eps,
                  double xtol, int m, int n, int kr, int kmax, int away,
                  void* stream) {
  if (!plan_ok(plan, m, n, kr) || plan[kWave] != 1 || kmax < 0 || kmax > kr)
    return (int)cudaErrorInvalidValue;
  Params p = make_params(plan, VT, H0, x_in, w_in, x, w, C, beta, misc, hist,
                         dscr, iscr, eps, xtol, m, n, kr, away);
  cudaError_t e = cudaMemsetAsync(iscr, 0, sizeof(int) * plan[kIwords],
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  p.prof = static_cast<long long*>(prof);
  p.kmax = kmax;
  p.done_io = static_cast<int*>(done_io);
  return (int)launch<false>(p, plan[kGroup], plan[kSmemBytes], stream);
}

// One launch block for each of K instances (stacked along a leading axis;
// per-instance kmax in the device int array kmax_b, stop flags in and out
// in done_io as for dopt_lazy_run), in waves of plan[kWave] instances, one
// cooperative launch each, on `stream`.  Returns the first failing
// launch's cudaError_t, or 0.
int dopt_lazy_batch_run(const int* plan, const void* VT, const void* H0,
                        const void* x_in, const void* w_in, void* x, void* w,
                        void* C, void* beta, void* misc, void* hist,
                        void* dscr, void* iscr, const void* kmax_b,
                        void* done_io, double eps, double xtol, int m,
                        int n, int kr, int K, int away, void* stream) {
  if (!plan_ok(plan, m, n, kr) || K < 1) return (int)cudaErrorInvalidValue;
  const size_t mn = (size_t)m * n, mm = (size_t)m * m;
  const int wave = plan[kWave];
  cudaError_t e = cudaMemsetAsync(iscr, 0, sizeof(int) * plan[kIwords] * K,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  for (int k0 = 0; k0 < K; k0 += wave) {
    const int kw = K - k0 < wave ? K - k0 : wave;
    Params p = make_params(
        plan, static_cast<const double*>(VT) + k0 * mn,
        static_cast<const double*>(H0) + k0 * mm,
        static_cast<const double*>(x_in) + (size_t)k0 * n,
        static_cast<const double*>(w_in) + (size_t)k0 * n,
        static_cast<double*>(x) + (size_t)k0 * n,
        static_cast<double*>(w) + (size_t)k0 * n,
        static_cast<double*>(C) + (size_t)k0 * kr * m,
        static_cast<double*>(beta) + (size_t)k0 * kr,
        static_cast<double*>(misc) + (size_t)k0 * 4,
        static_cast<double*>(hist) + (size_t)k0 * 5 * kr,
        static_cast<double*>(dscr) + (size_t)k0 * plan[kDwords],
        static_cast<int*>(iscr) + (size_t)k0 * plan[kIwords], eps, xtol, m, n,
        kr, away);
    p.kmax_b = static_cast<const int*>(kmax_b) + k0;
    p.done_io = static_cast<int*>(done_io) + k0;
    e = launch<true>(p, kw * plan[kGroup], plan[kSmemBytes], stream);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

const char* dopt_lazy_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
