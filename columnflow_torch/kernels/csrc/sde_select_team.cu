// The adaptive SDE step-size selection of the column network as Hopper
// thread-block-cluster teams: a cluster of C blocks per lane. Plain C entry
// points, loaded with ctypes by columnflow_torch/kernels/_build.py; each
// returns cudaGetLastError().
//
// Replaces (columnflow/solvers/sde_adaptive.py):
//   cf_sde_select_team   <- _make_sde_adaptive_kernel (B5): the whole SRA1
//                           step-doubling PI selection loop of one lane on
//                           the krng tree (B5t: on prepare_premixed_split's
//                           three terms); and, on the jax.random tree, the
//                           XLA selection (_adaptive_pass, no Pallas kernel)
//   cf_sde_attempt_team  <- the same body, one controller attempt per record
//                           (a test entry)
//   cf_sde_select_plan, cf_sde_select_max_clusters
//                        the teams' plan (plan_sel) and how many of a
//                        kernel's clusters the card holds at once, for the
//                        wrapper's route to be held against
// network_sde.cu's one-block kernel (sde_select_kernel, route "block")
// stays as the yardstick. The drifts
// here: select16 (bf16 weights: rec = bf16(fr) W16, e = bf16(ext) iwT16),
// float32 (rec = fr wT, e = ext iwT) and the three-term split (kSplit3).
//
// What bounds them on this card: a serial chain of ~10^4 controller
// attempts per lane over the second, each 5 drift evaluations (a (P, P)
// matrix-vector product each) and the Brownian data of two tree queries.
// The one-block kernel runs a lane on one SM and reads the weights from L2
// at every product, converting each to float64: ~300 us an attempt at 104
// columns. Here each lane's work is spread over a cluster of C blocks (16
// where 16 divides P, else 8; 8 also where B clusters of 16 would not all
// be resident at once, by the wrapper's route), launched with
// cudaLaunchKernelEx:
//   Block r owns populations [r nc, (r+1) nc), nc = P / C: thread i < nc
// holds population r nc + i's three state components and every stage
// vector of the attempt in registers. It keeps the columns [r nc, (r+1) nc)
// of the selection weights in shared memory, packed by the wrapper
// (sde_select_pack) into (P, rw) 32-bit words: two bf16 a word (select16;
// the split: a word of each of its three terms per column pair) or one
// float32 a word, each row padded so that a warp's rows fall in distinct
// banks. TMA bulk copies on mbarriers fill the slice once where it fits (at
// 104 columns and C = 16: 86.5 KB of bf16, 173 KB of float32), else it
// streams through tma_ring.cuh's ring of tiles (the split's 260 KB there).
//   A drift: each owner computes its rate (and its bf16 rounding, or its
// three bf16 terms) and writes it as the float64 x 2^896 into row r nc + i
// of the exchange slot;
// the block copies its rows into every other block's slot (distributed
// shared memory, 16-byte stores by consecutive threads); one cluster
// barrier; each block forms its columns' products over all P rows: thread
// (j, l) holds the column pair j and sums the rows k = l mod L in order, a
// butterfly of shuffles over the L lanes. (The one-block kernel sums the
// rows in order, and cuBLAS, under the plain version's float64 matmul, in
// an order of its own: the three float64 sums of a rec part in their last
// bits, and where its terms cancel one of them can round to another float32,
// rarely on states along a selection. Rows in order here took 55 us an
// attempt at 104 columns against 30: PERF.md.) A product needs no conversion:
// the weight's bits placed in a double make w 2^-896 exactly (t3_w,
// t3_w32), and the product with x 2^896 is x w, exactly. Then the stimulus
// term in float64 and the current, in network_sde.cu drift<kMode>'s order.
// Exchange slots and the stimulus are double buffered (one cluster barrier
// per drift).
//   The Brownian data: every block draws the same W(tm), W(te) and
// interval normals itself from the same key words (sde_select.cuh
// draw_noise: each tree level's normal on a thread of its own, then one
// thread per query combines them). The error norm: each block's float64
// sum of its owned q^2 (block_sum.cuh), then the C blocks' sums in rank
// order, the same double in every block, so every block takes the same
// control() decision and leaves the loop at the same iteration. Rank 0
// writes the accepted times and the stats; a last cluster barrier precedes
// the exit, so no block's shared memory goes while another reads it.
//
// Precision: float32 elementwise code with full-precision functions and
// IEEE division, compiled with -fmad=false, rounding as the plain PyTorch
// version (kernels/network_sde.py attempt_plain); each product sum is
// float64 of exact products, rounded to float32 once, as the plain
// version's float64 matmul (the two orders of summation differ only in
// the last bits of a float64). A state so large that x 2^896 overflows
// (|x| >= 2^128) would differ; no finite float32 rate reaches it.

#include <cooperative_groups.h>
#include <stdint.h>

#include "network_drift.cuh"
#include "sde_select.cuh"
#include "split3_drift.cuh"
#include "tma_ring.cuh"

namespace {

namespace cgo = cooperative_groups;

// The selection drifts' codes (network_sde.cu's Mode): select16, float32,
// and the three-term split of the in-kernel pass (B5t: rec = x_hi W_lo +
// x_mid W_mid + x_lo W_hi + x_hi W_mid + x_mid W_hi + x_hi W_hi, each
// product's sum rounded to float32 and added left to right; e = ext iwT).
enum SelMode { kSel16 = 0, kF32 = 2, kSplit3 = 3 };

// A team's shape, computed alike on the host (launch, shared-memory bytes)
// and in the kernel (carving, thread mappings); kernels/network_sde.py
// sde_select_plan repeats it and cf_sde_select_plan reports it.
struct PlanS {
  int C;        // blocks per lane (the cluster size)
  int nc;       // populations a block owns
  int mode;     // kSel16 (bf16, two a word), kF32 (one a word), kSplit3 (three bf16 terms)
  int np;       // column pairs of a block, (nc + 1) / 2
  int wpt;      // words of a pair in a packed row (1, 2 float32 or 3 terms)
  int xw;       // exchanged float64 values of a row (1, or the 3 terms)
  int L;        // lanes per pair: thread (j, l) sums the rows k = l mod L
  int rw;       // words of a packed row: np wpt, padded to v times an odd number,
                // v = (32 / L) wpt, the consecutive words a warp reads in a row
  int stream;   // 0: the slice is resident; 1: streamed in tiles
  int R, T, S;  // rows per tile, tiles per pass, stages (resident: P, 1, 1)
  int fits;     // 0: no shape of this design fits a block (the route is "block")
  size_t fixed, bytes;  // shared-memory bytes before the weights, in all
};

__host__ __device__ inline size_t sel_fixed(int P, int nc, int C, int n_in, int xw) {
  return t2_align(8 * 2 * (size_t)xw * P)                   // exchange slots (x 2^896)
         + t2_align(4 * (size_t)nc)                         // the own columns' rec sums
         + t2_align(4 * 2 * (size_t)n_in)                   // the stimulus, double buffered
         + t2_align(4 * (size_t)kMaxKnots * n_in)           // the lane's knot values
         + t2_align(4 * (size_t)(n_in + 2) * nc)            // own iw columns, bg, adapt
         + t2_align(4 * (size_t)(8 + 2 * (kMaxDepth + 1)))  // scalars, the trees' normals
         + t2_align(8 * (size_t)(kThreads / 32 + 2 * C))    // block and team sums
         + t2_align(8 * (size_t)(1 + 2 * kT2MaxStages));    // mbarriers
}

__host__ __device__ inline PlanS plan_sel(int P, int n_in, int mode, int C, int want_stream) {
  PlanS p;
  p.C = C;
  p.nc = P / C;
  p.mode = mode;
  p.np = (p.nc + 1) / 2;
  p.wpt = mode == kF32 ? 2 : (mode == kSplit3 ? 3 : 1);
  p.xw = mode == kSplit3 ? 3 : 1;
  p.L = 32;
  while (p.L > 1 && p.np * p.L > kThreads) p.L /= 2;
  const int v = (32 / p.L) * p.wpt;
  p.rw = (p.np * p.wpt + v - 1) / v * v;
  if ((p.rw / v) % 2 == 0) p.rw += v;
  p.fits = p.nc <= kThreads;
  p.fixed = sel_fixed(P, p.nc, C, n_in, p.xw);
  const size_t row = 4 * (size_t)p.rw;
  if (!want_stream && p.fixed + row * P <= kT2SmemLimit) {
    p.stream = 0;
    p.R = P;
    p.T = 1;
    p.S = 1;
    p.bytes = p.fixed + row * P;
    return p;
  }
  // Streamed: tiles of R rows, R the first power of two from r0 down (a
  // multiple of L, so that row k stays with lane k mod L) that leaves
  // S >= 2 stages.
  p.stream = 1;
  const int r0 = 16 * p.L > kT2MinTileRows ? 16 * p.L : kT2MinTileRows;
  const int rmin = p.L > 8 ? p.L : 8;
  const size_t room = p.fixed < kT2SmemLimit ? kT2SmemLimit - p.fixed : 0;
  for (int R = r0; R >= rmin; R /= 2) {
    const int T = (P + R - 1) / R;
    size_t s = room / (row * R);
    if (s > (size_t)kT2MaxStages) s = kT2MaxStages;
    if (s > (size_t)T) s = T;
    if ((int)s >= (T < 2 ? T : 2)) {
      p.R = R;
      p.T = T;
      p.S = (int)s;
      p.bytes = p.fixed + row * R * s;
      return p;
    }
  }
  p.fits = 0;
  p.R = P;
  p.T = 1;
  p.S = 0;
  p.bytes = p.fixed;
  return p;
}

// The plan of a launch, or an error where the shape is not taken.
int sel_plan(int P, int n_in, int K, int mode, int C, int stream, PlanS* p) {
  if (int e = check_shape(P, n_in, K)) return e;
  if ((mode != kSel16 && mode != kF32 && mode != kSplit3) || (C != 8 && C != 16) || P % C
      || P % 8)
    return (int)cudaErrorInvalidValue;
  *p = plan_sel(P, n_in, mode, C, stream);
  return p->fits ? 0 : (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// One block's share of a lane's team
// ---------------------------------------------------------------------------

struct TeamS {
  PlanS p;
  int rank, c0;          // this block owns populations [c0, c0 + nc)
  int par, rpar;         // exchange slot and team-sum buffer in use
  double* X;             // exchange slot 0 ((P, xw) values x 2^896); slot 1 at X + xw P
  float* recs;           // (nc) the own columns' rec sums
  float* ext;            // (2, n_in) the stimulus
  float* kvs;            // (K, n_in) the lane's knot values
  float* iwc;            // (n_in, nc) the own columns of iw
  float *bg, *ad;        // (nc) the own populations' background current and adaptation
  float *scal, *zb;      // broadcast scalars (8), the trees' normals (2 (kMaxDepth + 1))
  double *red, *cred;    // block sum (kThreads / 32), team sums (2, C)
  uint64_t* mbar;        // tma_ring.cuh
  uint32_t* w;           // the resident slice, or stage 0 of the ring
  const uint32_t* src;   // this block's packed slice in device memory
  int used, limit;       // tiles consumed so far; the ring's bound
};

// Carve the shared memory, copy what the drift reads of the own populations
// and of lane b's stimulus, start the weights' copies, and make sure every
// block of the cluster has started before any writes into another's shared
// memory.
template <int kMode>
__device__ __forceinline__ void sel_init(TeamS& T, unsigned char* sm, const Net& n, int C,
                                         int stream, int b, const uint32_t* wpk,
                                         const void* iw) {
  const int P = n.P, NI = n.n_in;
  T.p = plan_sel(P, NI, kMode, C, stream);
  const PlanS& p = T.p;
  T.rank = (int)cgo::this_cluster().block_rank();
  T.c0 = T.rank * p.nc;
  T.par = T.rpar = 0;
  unsigned char* q = sm;
  T.X = reinterpret_cast<double*>(q);
  q += t2_align(8 * 2 * (size_t)p.xw * P);
  T.recs = reinterpret_cast<float*>(q);
  q += t2_align(4 * (size_t)p.nc);
  T.ext = reinterpret_cast<float*>(q);
  q += t2_align(4 * 2 * (size_t)NI);
  T.kvs = reinterpret_cast<float*>(q);
  q += t2_align(4 * (size_t)kMaxKnots * NI);
  T.iwc = reinterpret_cast<float*>(q);
  T.bg = T.iwc + (size_t)NI * p.nc;
  T.ad = T.bg + p.nc;
  q += t2_align(4 * (size_t)(NI + 2) * p.nc);
  T.scal = reinterpret_cast<float*>(q);
  T.zb = T.scal + 8;
  q += t2_align(4 * (size_t)(8 + 2 * (kMaxDepth + 1)));
  T.red = reinterpret_cast<double*>(q);
  T.cred = T.red + kThreads / 32;
  q += t2_align(8 * (size_t)(kThreads / 32 + 2 * C));
  T.mbar = reinterpret_cast<uint64_t*>(q);
  T.w = reinterpret_cast<uint32_t*>(sm + p.fixed);
  T.src = wpk + (size_t)T.rank * P * p.rw;
  T.used = 0;
  T.limit = 0x7fffffff;
  for (int j = threadIdx.x; j < n.K * NI; j += blockDim.x) {
    const int k = j / NI, m = j - k * NI;
    T.kvs[j] = n.kv[((size_t)k * n.B + b) * NI + m];
  }
  for (int j = threadIdx.x; j < NI * p.nc; j += blockDim.x) {
    const int m = j / p.nc;
    const size_t at = (size_t)m * P + T.c0 + (j - m * p.nc);
    T.iwc[j] = kMode == kSel16 ? __bfloat162float(static_cast<const bf16*>(iw)[at])
                               : static_cast<const float*>(iw)[at];
  }
  for (int j = threadIdx.x; j < p.nc; j += blockDim.x) {
    T.bg[j] = n.bg[T.c0 + j];
    T.ad[j] = n.adapt[T.c0 + j];
  }
  if (threadIdx.x == 0) {
    t2_mbar_init(T.mbar, 1);
    for (int s = 0; s < kT2MaxStages; ++s) {
      t2_mbar_init(T.mbar + 1 + s, 1);
      t2_mbar_init(T.mbar + 1 + kT2MaxStages + s, kThreads / 32);
    }
    t2_mbar_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (!p.stream) {
      t2_bulk_load(T.w, T.src, (uint32_t)(4 * (size_t)P * p.rw), T.mbar);
    } else {
      for (int g = 0; g < p.S; ++g) t2_fetch(T, g, P);
    }
  }
  cgo::this_cluster().sync();
  if (!p.stream) t2_mbar_wait(T.mbar, 0);
}

// Sum of v over every thread of the team, the same double in every block:
// the block's sum, then the C blocks' sums in rank order.
__device__ __forceinline__ double sel_sum(TeamS& T, double v) {
  cgo::cluster_group cl = cgo::this_cluster();
  const double tot = block_sum(v, T.red);
  const int C = T.p.C;
  double* const cred = T.cred + T.rpar * C;
  const int rank = T.rank;
  if (threadIdx.x == 0)
    for (int q = 0; q < C; ++q) cl.map_shared_rank(cred, q)[rank] = tot;
  cl.sync();
  double all = 0.0;
  for (int q = 0; q < C; ++q) all += cred[q];
  T.rpar ^= 1;
  return all;
}

// ext[m] of the lane at time t from its knot values in shared memory:
// network_drift.cuh's knot_interp, operation for operation.
__device__ __forceinline__ float sel_knot(const Net& n, const TeamS& T, int m, float t) {
  const int NI = n.n_in;
  float out = T.kvs[m];
  for (int k = 1; k < n.K; ++k) {
    const float frac = fminf(fmaxf((t - n.kc0[k - 1]) / n.kd[k - 1], 0.0f), 1.0f);
    out = out + frac * (T.kvs[k * NI + m] - T.kvs[(k - 1) * NI + m]);
  }
  return out;
}

// The products of a drift evaluation: for every own column j, rec = the
// float64 sum over all rows k of x_k W[k, j], rounded to float32 (the
// three-term split: its six such sums, each rounded, added left to right)
// -> recs[j]. Thread (o, l) holds the column pair o and sums the rows k = l
// mod L in order; a butterfly of shuffles over the L lanes.
template <int kMode, bool kStream>
__device__ __forceinline__ void sel_products(TeamS& T, int P, const double* __restrict__ X) {
  constexpr int NP = kMode == kSplit3 ? 6 : 1;
  const PlanS& p = T.p;
  const int L = p.L, rw = p.rw, R = p.R, NTl = p.T, nc = p.nc;
  const int o = threadIdx.x / L, l = threadIdx.x - o * L;
  const bool act = o < p.np;
  double acc[2][NP];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int r = 0; r < NP; ++r) acc[j][r] = 0.0;
  }
  for (int m = 0; m < NTl; ++m) {
    const int gg = T.used + m;
    const uint32_t* tile = t2_acquire<kStream>(T, gg, P);
    const int k0 = m * R, k1 = min(P, k0 + R);
    if (act) {
      const uint32_t* col = tile + o * p.wpt;
#pragma unroll 4
      for (int k = k0 + l; k < k1; k += L) {
        const uint32_t* row = col + (size_t)(k - k0) * rw;
        if constexpr (kMode == kSplit3) {
          const double xa = X[3 * k], xb = X[3 * k + 1], xc = X[3 * k + 2];
          const uint32_t uh = row[0], um = row[1], ul = row[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const double wh = t3_w(j ? uh >> 16 : uh), wm = t3_w(j ? um >> 16 : um);
            const double wl = t3_w(j ? ul >> 16 : ul);
            acc[j][0] = fma(xa, wl, acc[j][0]);
            acc[j][1] = fma(xb, wm, acc[j][1]);
            acc[j][2] = fma(xc, wh, acc[j][2]);
            acc[j][3] = fma(xa, wm, acc[j][3]);
            acc[j][4] = fma(xb, wh, acc[j][4]);
            acc[j][5] = fma(xa, wh, acc[j][5]);
          }
        } else {
          const double x = X[k];
          double w0, w1;
          if constexpr (kMode == kF32) {
            const uint2 u = *reinterpret_cast<const uint2*>(row);
            w0 = t3_w32(u.x);
            w1 = t3_w32(u.y);
          } else {
            const uint32_t u = row[0];
            w0 = t3_w(u);
            w1 = t3_w(u >> 16);
          }
          acc[0][0] = fma(x, w0, acc[0][0]);
          acc[1][0] = fma(x, w1, acc[1][0]);
        }
      }
    }
    t2_release<kStream>(T, gg);
  }
  if (kStream) T.used += NTl;
  for (int off = L / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int r = 0; r < NP; ++r) acc[j][r] += __shfl_xor_sync(0xffffffffu, acc[j][r], off);
    }
  }
  if (act && l == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float rec = (float)acc[j][0];
#pragma unroll
      for (int r = 1; r < NP; ++r) rec = rec + (float)acc[j][r];
      if (2 * o + j < nc) T.recs[2 * o + j] = rec;
    }
  }
}

// One drift evaluation of the lane at time t: the owner thread's state s
// -> out; every thread of the block calls it.
template <int kMode, bool kStream>
__device__ __forceinline__ void sel_drift(const Net& n, TeamS& T, float t, const float (&s)[3],
                                          float (&out)[3]) {
  cgo::cluster_group cl = cgo::this_cluster();
  const PlanS& p = T.p;
  const int P = n.P, nc = p.nc, NI = n.n_in, C = p.C, c0 = T.c0, rank = T.rank;
  constexpr int XW = kMode == kSplit3 ? 3 : 1;
  double* const X = T.X + (size_t)T.par * XW * P;
  float* const ext = T.ext + T.par * NI;
  const bool own = threadIdx.x < nc;
  float fr = 0.0f;
  if (own) {
    fr = firing_rate(s[0] - s[1]);
    if constexpr (kMode == kSplit3) {
      float hi, mid, lo;
      split3(fr, hi, mid, lo);
      double* xr = X + 3 * (size_t)(c0 + threadIdx.x);
      xr[0] = (double)hi * kT3Scale;
      xr[1] = (double)mid * kT3Scale;
      xr[2] = (double)lo * kT3Scale;
    } else {
      const float x = kMode == kF32 ? fr : bf16r(fr);
      X[c0 + threadIdx.x] = (double)x * kT3Scale;
    }
  }
  if (threadIdx.x < NI) {
    const float e = sel_knot(n, T, threadIdx.x, t);
    ext[threadIdx.x] = kMode == kSel16 ? bf16r(e) : e;
  }
  __syncthreads();
  // The own rows, contiguous in X, to every other block, consecutive
  // threads on consecutive addresses.
  const int nx = XW * nc;  // own values, from X + XW c0
  if (nx % 2 == 0) {
    const int nv = nx / 2;
    const uint4* src = reinterpret_cast<const uint4*>(X + XW * c0);
    for (int idx = threadIdx.x; idx < C * nv; idx += blockDim.x) {
      const int r = idx / nv, v = idx - r * nv;
      if (r != rank) cl.map_shared_rank(const_cast<uint4*>(src), r)[v] = src[v];
    }
  } else {
    const double* src = X + XW * c0;
    for (int idx = threadIdx.x; idx < C * nx; idx += blockDim.x) {
      const int r = idx / nx, v = idx - r * nx;
      if (r != rank) cl.map_shared_rank(const_cast<double*>(src), r)[v] = src[v];
    }
  }
  cl.sync();
  sel_products<kMode, kStream>(T, P, X);
  __syncthreads();
  if (own) {
    const int i = threadIdx.x;
    const float rec = T.recs[i];
    double e = 0.0;
    for (int m = 0; m < NI; ++m) e = fma((double)ext[m], (double)T.iwc[m * nc + i], e);
    const float current = (rec + (float)e) + T.bg[i];
    const float total = current * n.tau_s;
    out[0] = (-s[0] + total * n.R) / n.tau_m;
    out[1] = (-s[1] + T.ad[i] * fr) / n.tau_a;
    out[2] = (-s[2] + fr) / n.tau_s;
  } else {
    out[0] = out[1] = out[2] = 0.0f;
  }
  T.par ^= 1;
}

// h2 = (y + (0.75 h) f) + (1.5 i10h) sigma, component by component.
__device__ __forceinline__ void sel_stage2(const float (&y)[3], const float (&f)[3], float h,
                                           float i10h, float sigma, float (&out)[3]) {
  const float a = 0.75f * h, k = 1.5f * i10h;
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = (y[c] + a * f[c]) + k * sigma;
}

// One step-doubling attempt from (t, y) with step h and W(t) = w0
// (network_sde.cu attempt, on the owner's components): the two-half-step
// solution into yn; returns the scaled RMS error over the lane's 3P states
// and W(t + h) in w1_out.
template <int kTree, int kMode, bool kStream>
__device__ __forceinline__ float sel_attempt(const Net& n, TeamS& T, const Sel& sel,
                                             const uint32_t* kw, float t, float h, float w0,
                                             const float (&y)[3], float (&yn)[3],
                                             float& w1_out) {
  const int S = 3 * n.P;
  const float tm = t + 0.5f * h;
  const float te = t + h;
  const float hh = 0.5f * h;
  draw_noise<kTree>(sel, kw, t, tm, te, T.scal, T.zb);
  const float wm = T.scal[0], w1 = T.scal[1], za = T.scal[2], zb = T.scal[3];
  w1_out = w1;
  const float dw_a = wm - w0, dw_b = w1 - wm;
  const float sq = sqrtf(hh / 12.0f);
  const float i10_a = hh * (0.5f * dw_a + sq * za);
  const float i10_b = hh * (0.5f * dw_b + sq * zb);
  const float i10_f = (i10_a + i10_b) + hh * dw_a;
  const float sg = n.sigma;
  float f1[3], f[3], g1[3], hst[3], yf[3], yh[3];

  // Full step.
  sel_drift<kMode, kStream>(n, T, t, y, f1);
  const float i10h_f = i10_f / (h > 0.0f ? h : 1.0f);
  sel_stage2(y, f1, h, i10h_f, sg, hst);
  sel_drift<kMode, kStream>(n, T, t + 0.75f * h, hst, f);
  const float dw_f = dw_a + dw_b;
#pragma unroll
  for (int c = 0; c < 3; ++c) yf[c] = sra1_final(y[c], f1[c], f[c], h, dw_f, i10h_f, sg);
  // First half step (shares f1).
  const float i10h_a = i10_a / (hh > 0.0f ? hh : 1.0f);
  sel_stage2(y, f1, hh, i10h_a, sg, hst);
  sel_drift<kMode, kStream>(n, T, t + 0.75f * hh, hst, f);
#pragma unroll
  for (int c = 0; c < 3; ++c) yh[c] = sra1_final(y[c], f1[c], f[c], hh, dw_a, i10h_a, sg);
  // Second half step from t + h/2.
  const float th = t + 0.5f * h;
  sel_drift<kMode, kStream>(n, T, th, yh, g1);
  const float i10h_b = i10_b / (hh > 0.0f ? hh : 1.0f);
  sel_stage2(yh, g1, hh, i10h_b, sg, hst);
  sel_drift<kMode, kStream>(n, T, th + 0.75f * hh, hst, f);
  double acc = 0.0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    yn[c] = sra1_final(yh[c], g1[c], f[c], hh, dw_b, i10h_b, sg);
    const float q = (yn[c] - yf[c]) / (sel.atol + sel.rtol * fmaxf(fabsf(y[c]), fabsf(yn[c])));
    if (threadIdx.x < T.p.nc) acc += (double)(q * q);
  }
  const float mean = (float)sel_sum(T, acc) / (float)S;
  return sqrtf(mean);
}

// The whole selection loop of lane blockIdx.x / C: st (B, M + 1) the
// accepted times (t_end past the last), stats (B, 3) = (naccept, nreject,
// success).
template <int kTree, int kMode, bool kStream>
__global__ void __launch_bounds__(kThreads, 1)
sde_select_team_kernel(Net n, Sel sel, int C, const uint32_t* __restrict__ wpk,
                       const void* __restrict__ iw, const int* __restrict__ words,
                       const float* __restrict__ y0, float* __restrict__ st,
                       int* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smt[];
  TeamS T;
  const int b = blockIdx.x / C;
  sel_init<kMode>(T, smt, n, C, kStream, b, wpk, iw);
  const int P = n.P, S = 3 * P, M = sel.max_steps;
  const bool lead = T.rank == 0;
  uint32_t kw[4];
  for (int j = 0; j < 4; ++j) kw[j] = (uint32_t)words[b * 4 + j];
  float* st_b = st + (size_t)b * (M + 1);
  if (lead)
    for (int i = threadIdx.x; i <= M; i += blockDim.x) st_b[i] = i == 0 ? sel.t_start : sel.t_end;
  const bool own = threadIdx.x < T.p.nc;
  const size_t col = (size_t)b * S + T.c0 + threadIdx.x;
  float y[3], yn[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) y[c] = own ? y0[col + (size_t)c * P] : 0.0f;
  if (threadIdx.x == 0) T.scal[4] = lane_w<kTree>(sel, kw, sel.t_start);
  __syncthreads();
  float w_t1 = T.scal[4];
  float t1 = sel.t_start, h = sel.h0, err_prev = 1.0f;
  int na = 0, nr = 0;
  while (t1 < sel.t_end && na + nr < M) {
    float hc = fminf(h, sel.t_end - t1);
    hc = (t1 + hc) - t1;
    float w1;
    const float err = sel_attempt<kTree, kMode, kStream>(n, T, sel, kw, t1, hc, w_t1, y, yn, w1);
    const Control c = control(sel, err, hc, err_prev);
    const float t_new = c.accept ? t1 + hc : t1;
    na += c.accept ? 1 : 0;
    nr += c.accept ? 0 : 1;
    if (lead && threadIdx.x == 0) st_b[na] = t_new;
    if (c.accept) {
#pragma unroll
      for (int q = 0; q < 3; ++q) y[q] = yn[q];
      err_prev = c.err_c;
      w_t1 = w1;
    }
    h = c.h_next;
    t1 = t_new;
  }
  if (lead && threadIdx.x == 0) {
    stats[b * 3 + 0] = na;
    stats[b * 3 + 1] = nr;
    stats[b * 3 + 2] = t1 >= sel.t_end ? 1 : 0;
  }
  if (kStream) t2_drain(T);
  cgo::this_cluster().sync();
}

// One controller attempt per record r = blockIdx.x / C (whose knot values
// are lane r's), from (t1, y1, h, err_prev, W(t1)): rec[r] = (err, accept,
// h used, h next, t new, W(t + h)), y_new[r] = the two-half-step solution.
template <int kTree, int kMode, bool kStream>
__global__ void __launch_bounds__(kThreads, 1)
sde_attempt_team_kernel(Net n, Sel sel, int C, const uint32_t* __restrict__ wpk,
                        const void* __restrict__ iw, const int* __restrict__ words,
                        const float* __restrict__ t1s, const float* __restrict__ y1,
                        const float* __restrict__ hs, const float* __restrict__ err_prev,
                        const float* __restrict__ w_t1, float* __restrict__ y_new,
                        float* __restrict__ rec) {
  extern __shared__ __align__(16) unsigned char smt[];
  TeamS T;
  const int r = blockIdx.x / C;
  sel_init<kMode>(T, smt, n, C, kStream, r, wpk, iw);
  const int P = n.P, S = 3 * P;
  uint32_t kw[4];
  for (int j = 0; j < 4; ++j) kw[j] = (uint32_t)words[r * 4 + j];
  const bool own = threadIdx.x < T.p.nc;
  const size_t col = (size_t)r * S + T.c0 + threadIdx.x;
  float y[3], yn[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) y[c] = own ? y1[col + (size_t)c * P] : 0.0f;
  const float t1 = t1s[r];
  float hc = fminf(hs[r], sel.t_end - t1);
  hc = (t1 + hc) - t1;
  float w1;
  const float err = sel_attempt<kTree, kMode, kStream>(n, T, sel, kw, t1, hc, w_t1[r], y, yn, w1);
  const Control c = control(sel, err, hc, err_prev[r]);
  if (own) {
#pragma unroll
    for (int q = 0; q < 3; ++q) y_new[col + (size_t)q * P] = yn[q];
  }
  if (T.rank == 0 && threadIdx.x == 0) {
    float* o = rec + (size_t)r * 6;
    o[0] = err;
    o[1] = c.accept ? 1.0f : 0.0f;
    o[2] = hc;
    o[3] = c.h_next;
    o[4] = c.accept ? t1 + hc : t1;
    o[5] = w1;
  }
  if (kStream) t2_drain(T);
  cgo::this_cluster().sync();
}

// Launch L<kTree, kMode, kStream> for the tree (kKrng, kJax), drift (kSel16,
// kF32; kSplit3 on the krng tree only, the in-kernel pass's) and weight
// route the host asks for; anything else is an invalid value.
template <template <int, int, bool> class L, typename... A>
int dispatch_team(int tree, int mode, int stream, A... a) {
  if (tree == kKrng && mode == kSel16)
    return stream ? L<kKrng, kSel16, true>::run(a...) : L<kKrng, kSel16, false>::run(a...);
  if (tree == kKrng && mode == kF32)
    return stream ? L<kKrng, kF32, true>::run(a...) : L<kKrng, kF32, false>::run(a...);
  if (tree == kJax && mode == kSel16)
    return stream ? L<kJax, kSel16, true>::run(a...) : L<kJax, kSel16, false>::run(a...);
  if (tree == kJax && mode == kF32)
    return stream ? L<kJax, kF32, true>::run(a...) : L<kJax, kF32, false>::run(a...);
  if (tree == kKrng && mode == kSplit3)
    return stream ? L<kKrng, kSplit3, true>::run(a...) : L<kKrng, kSplit3, false>::run(a...);
  return (int)cudaErrorInvalidValue;
}

template <int kTree, int kMode, bool kStream>
struct SelectTeam {
  static int run(const PlanS& p, int B, cudaStream_t s, Net n, Sel sel, const uint32_t* w,
                 const void* iw, const int* words, const float* y0, float* st, int* stats) {
    return team2_launch(sde_select_team_kernel<kTree, kMode, kStream>, p, B, s, n, sel, p.C, w,
                        iw, words, y0, st, stats);
  }
};

template <int kTree, int kMode, bool kStream>
struct AttemptTeam {
  static int run(const PlanS& p, int N, cudaStream_t s, Net n, Sel sel, const uint32_t* w,
                 const void* iw, const int* words, const float* t1, const float* y1,
                 const float* h, const float* err_prev, const float* w_t1, float* y_new,
                 float* rec) {
    return team2_launch(sde_attempt_team_kernel<kTree, kMode, kStream>, p, N, s, n, sel, p.C, w,
                        iw, words, t1, y1, h, err_prev, w_t1, y_new, rec);
  }
};

template <int kTree, int kMode, bool kStream>
struct ClustersTeam {
  static int run(const PlanS& p, int* out) {
    return team2_max_clusters(sde_select_team_kernel<kTree, kMode, kStream>, p, out);
  }
};

}  // namespace

extern "C" {

// The selection of B lanes as B teams of C blocks. hc, hs, tree, mode, bg,
// adapt, kv, words, y0, st, stats as network_sde.cu's cf_sde_select (mode 0
// select16, 2 float32; iw bf16 or float32 (n_in, P)); wpk: the selection
// weights packed per block (sde_select_pack in kernels/network_sde.py:
// (C, P, rw) 32-bit words, the plan's layout); stream: 1 streams the slices
// through the ring even where they fit.
int cf_sde_select_team(int B, int P, int n_in, int K, const float* hc, const float* hs,
                       int max_steps, int depth, int tree, int mode, int C, int stream,
                       const float* bg, const float* adapt, const void* wpk, const void* iw,
                       const float* kv, const int* words, const float* y0, float* st,
                       int* stats, void* cstream) {
  PlanS p;
  if (int e = sel_plan(P, n_in, K, mode, C, stream, &p)) return e;
  if (int e = check_depth(depth)) return e;
  const Net n = make_net(B, P, n_in, K, hc, bg, adapt, kv);
  const Sel sel = make_sel(hs, max_steps, depth);
  const uint32_t* w = (const uint32_t*)wpk;
  const cudaStream_t s = (cudaStream_t)cstream;
  return dispatch_team<SelectTeam>(tree, mode, p.stream, p, B, s, n, sel, w, iw, words, y0, st,
                                   stats);
}

// One attempt per record (N records, each a team), as cf_sde_attempt.
int cf_sde_attempt_team(int N, int P, int n_in, int K, const float* hc, const float* hs,
                        int depth, int tree, int mode, int C, int stream, const float* bg,
                        const float* adapt, const void* wpk, const void* iw, const float* kv,
                        const int* words, const float* t1, const float* y1, const float* h,
                        const float* err_prev, const float* w_t1, float* y_new, float* rec,
                        void* cstream) {
  PlanS p;
  if (int e = sel_plan(P, n_in, K, mode, C, stream, &p)) return e;
  if (int e = check_depth(depth)) return e;
  const Net n = make_net(N, P, n_in, K, hc, bg, adapt, kv);
  const Sel sel = make_sel(hs, 0, depth);
  const uint32_t* w = (const uint32_t*)wpk;
  const cudaStream_t s = (cudaStream_t)cstream;
  return dispatch_team<AttemptTeam>(tree, mode, p.stream, p, N, s, n, sel, w, iw, words, t1, y1,
                                    h, err_prev, w_t1, y_new, rec);
}

// The team plan (PlanS, in order: C, nc, mode, np, wpt, xw, L, rw, stream,
// R, T, S, fits, fixed bytes, bytes) of mode at P with clusters of C, for
// the wrapper's own reckoning to be held against.
int cf_sde_select_plan(int P, int n_in, int mode, int C, int stream, long long* out) {
  if (P <= 0 || P % 8 || n_in < 0 || n_in > kMaxInputs
      || (mode != kSel16 && mode != kF32 && mode != kSplit3) || (C != 8 && C != 16) || P % C)
    return (int)cudaErrorInvalidValue;
  const PlanS p = plan_sel(P, n_in, mode, C, stream);
  const long long v[15] = {p.C, p.nc, p.mode, p.np, p.wpt, p.xw, p.L, p.rw, p.stream, p.R,
                           p.T, p.S, p.fits, (long long)p.fixed, (long long)p.bytes};
  for (int j = 0; j < 15; ++j) out[j] = v[j];
  return 0;
}

// cudaOccupancyMaxActiveClusters of the selection kernel of (tree, mode) at
// P with clusters of C (stream as cf_sde_select_team's): how many lanes'
// teams run at once.
int cf_sde_select_max_clusters(int P, int n_in, int tree, int mode, int C, int stream,
                               int* out) {
  PlanS p;
  if (int e = sel_plan(P, n_in, 1, mode, C, stream, &p)) return e;
  return dispatch_team<ClustersTeam>(tree, mode, p.stream, p, out);
}

}  // extern "C"
