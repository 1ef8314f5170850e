// The dopri5 selection (B6) and the emit-mode reverse sweep (B8' on the
// two-term split, B8't on the three-term one) as Hopper thread-block-cluster
// teams: network_ode.cu's cf_ode_select, cf_ode_attempt,
// cf_ode_replay_bwd_emit and cf_ode_replay_bwd_emit_split3. Included once;
// the definitions live in an unnamed namespace.
//
// Replaces (columnflow/solvers/fused.py):
//   ode_select16_kernel  <- _make_adaptive_kernel (B6): Hairer's initial
//                           step, the accept/reject loop and the accepted
//                           times, on prepare_premixed_split's three terms
//   ode_attempt16_kernel <- one iteration of that loop (a test entry)
//   ode_emit16_kernel    <- _make_bwd_chunk_kernel(emit_steps=True) (B8',
//                           B8't): the state cotangent alone and each
//                           step's output cotangent
//
// What bounds them on this card: serial chains (~1.3 * 10^4 selection
// attempts over the second at 104 columns, ~1.2 * 10^4 accepted steps),
// each attempt six drift evaluations and each sweep step six drifts and
// seven drift VJPs, every one a (B, P) x (P, P) product on each term of the
// split. The work of one is a few MFLOP; what costs is its latency. The
// teams they replace (team.cuh, 8 blocks) read the bf16 terms from L2 in
// every product and kept the states in global memory.
//
// This design follows B3/B4's (replay2_team.cuh). A team is a cluster of C
// blocks (16 where 16 divides P, else 8; launched with cudaLaunchKernelEx):
// ONE team for the selection's batch (its controller's error ratio is an
// RMS over every lane, so every block must see the same sum, which a
// cluster barrier gives and a launch of several clusters does not), one per
// lane for the sweep. Block r owns the populations [r nc, (r+1) nc), nc =
// P / C, of every lane it holds, and keeps the columns [r nc, (r+1) nc) of
// the NT bf16 terms of wT, packed by the wrapper (ode_team_pack) into one
// (P, rw) slice of 32-bit words: row k holds the hi, mid (and lo) bf16 of
// the block's columns, two a word, then pad words. A product needs no
// conversion: the bf16's bits placed in a double's sign, exponent and
// mantissa make the exact float64 w 2^-896 (t3_w), the other operand is
// held scaled by 2^896, and the product is exact (B3's and B4's products
// convert at ~7.5 bf16 -> float64 a cycle, PERF.md; each weight held as its
// float64 high word would need no bit operations but streams twice the
// bytes, which measured slower at 104 columns). The slice is copied by TMA
// bulk copies on mbarriers: once,
// where it fits (13 and 32 columns, and the two-term sweep at 104), else
// through tma_ring.cuh's ring of tiles.
//   The state of an owned (lane, population) lives in the registers of the
// thread that owns it (item q of thread x: e = x + q * kThreads, lane e /
// nc, population r nc + e mod nc; at most two items a thread). A drift
// evaluation: each owner computes its rate, splits it into the NT bf16 terms
// and writes the high words of the terms times 2^896 (float64, low word 0)
// into its rows of X[k][lane group][lane][term]; the block copies its rows
// into every block of the cluster (distributed shared memory) in 16-byte
// stores, consecutive threads on consecutive addresses. One cluster
// barrier; then each block forms the NP products (6 for three terms, 3 for
// two) of its own columns for every lane over all P rows: thread (g, j, l)
// holds lane group g (LB = 4 lanes, so each weight word loaded serves four
// lanes), column j, and sums the rows k = l mod L in order; a butterfly of
// shuffles over the L lanes; the NP sums of a lane round to float32 and add
// in matmul_split's order. A VJP (the sweep): with the slice of columns it
// holds, block r forms for EVERY row k the partial sums over its own columns
// of the current's cotangent against each term (Lv lanes per row, a
// butterfly), stores them into the row owner's exchange slot, one cluster
// barrier, and the owner adds the C partials in rank order. No transposed
// copy of the weights is needed. Exchange slots are double buffered (team.cuh's
// argument: one cluster barrier per exchange) where two fit; where only one
// does (16 lanes at 104 columns) a second cluster barrier precedes each
// exchange's stores.
//   Rows are padded so that a warp's loads fall in distinct banks: rw is
// max(1, u / 2) times an odd number, u = 32 / L = Lv; a warp of the forward
// products reads L rows of 32 / L consecutive columns, one of the VJP 32 /
// Lv rows of Lv columns.
//   Every product term is exact in float64 and every sum is float64
// (explicit fma), rounded to float32 once; the float32 elementwise code
// rounds as the plain version's (-fmad=false). The error norm and the
// initial step's norms are block sums (block_sum.cuh), then the C blocks'
// sums in rank order, the same double in every block, so every block takes
// the same accept decision.

#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "dopri5.cuh"
#include "network_drift.cuh"
#include "tma_ring.cuh"

namespace {

namespace cgo = cooperative_groups;

constexpr int kT3MaxItems = 2;  // owned (lane, population) items a thread holds at most

// A team's shape, computed alike on the host (launch, shared-memory bytes)
// and in the kernel (carving, thread mappings); kernels/network_ode.py
// ode_team_plan repeats it and cf_ode_team_plan reports it.
struct Plan3 {
  int C;        // blocks per team (the cluster size)
  int nc;       // populations a block owns
  int NT, NB;   // terms of the split; lanes the team holds
  int LB, G;    // forward products: lanes per thread (the sweep 1, the selection 4; 2 where
                // a thread owns two items, for registers), lane groups
  int gw, xs;   // exchange words of a lane group, of a row k (even)
  int L, Lv;    // forward products: lanes per (group, column); VJP: lanes per row
  int rw;       // 32-bit words of a packed row: NT nc bf16 and pad (max(1, Lv / 2) times odd)
  int ipt;      // owned items per thread
  int slots;    // exchange slots (2: double buffered)
  int stream;   // 0: the slice is resident; 1: streamed in tiles
  int R, T, S;  // rows per tile, tiles per pass, stages (resident: P, 1, 1)
  int fits;     // 0: no shape of this design fits a block, or a thread would own more than
                // kT3MaxItems items (the route takes team8)
  size_t slot, fixed, bytes;  // bytes of an exchange slot, before the weights, in all
};

__host__ __device__ inline size_t t3_fixed(const Plan3& p, int n_in, int slots) {
  return (size_t)slots * p.slot
         + t2_align(4 * (size_t)p.NB * p.nc)                   // the lanes' rec sums
         + t2_align(8 * (size_t)p.nc)                          // the VJP's own cotangents
         + t2_align(4 * 2 * (size_t)p.NB * n_in)               // the stimulus, double buffered
         + t2_align(4 * (size_t)kMaxKnots * p.NB * n_in)       // the lanes' knot values
         + t2_align(4 * (size_t)(n_in + 2) * p.nc)             // own iwT columns, bg, adapt
         + t2_align(8 * (size_t)(kThreads / 32 + 2 * p.C))     // block and team sums
         + t2_align(8 * (size_t)(1 + 2 * kT2MaxStages));       // mbarriers
}

__host__ __device__ inline Plan3 plan3(int P, int n_in, int NB, int NT, int sweep,
                                       int want_stream) {
  Plan3 p;
  p.C = P % 16 == 0 ? 16 : 8;
  p.nc = P / p.C;
  p.NT = NT;
  p.NB = NB;
  p.ipt = (NB * p.nc + kThreads - 1) / kThreads;
  p.LB = sweep ? 1 : (p.ipt == 1 ? 4 : 2);
  p.G = (NB + p.LB - 1) / p.LB;
  p.gw = (p.LB * NT + 1) / 2 * 2;
  p.xs = p.G * p.gw;
  p.L = 32;
  while (p.L > 1 && p.G * p.nc * p.L > kThreads) p.L /= 2;
  p.Lv = 32 / p.L;
  // A row's NT nc bf16, two a word, padded to v times an odd number of
  // words, v = max(1, u / 2) for the u = 32 / L (= Lv) consecutive columns
  // a warp reads in a row: the warp's rows then fall in distinct banks.
  const int v = p.Lv > 1 ? p.Lv / 2 : 1;
  p.rw = ((NT * p.nc + 1) / 2 + v - 1) / v * v;
  if ((p.rw / v) % 2 == 0) p.rw += v;
  const size_t xb = 4 * (size_t)P * p.xs, vb = sweep ? 8 * (size_t)NT * P : 0;
  p.slot = t2_align(xb > vb ? xb : vb);
  const size_t row = 4 * (size_t)p.rw;
  p.fits = p.ipt <= kT3MaxItems;
  const size_t f2 = t3_fixed(p, n_in, 2);
  if (!want_stream && f2 + row * P <= kT2SmemLimit) {
    p.slots = 2;
    p.stream = 0;
    p.R = P;
    p.T = 1;
    p.S = 1;
    p.fixed = f2;
    p.bytes = f2 + row * P;
    return p;
  }
  // Streamed: tiles of R rows, R the first power of two from r0 down (a
  // multiple of L; the sweep's VJP takes kThreads / Lv rows a pass) that
  // leaves S >= 2 stages. (Smaller tiles in more stages, which keep more
  // rows in flight, made B6 slower at 104 columns: 264 against 223 us an
  // attempt, PERF.md.)
  p.stream = 1;
  const int r0 = 16 * p.L > kT2MinTileRows ? 16 * p.L : kT2MinTileRows;
  const int rmin = p.L > 8 ? p.L : 8;
  for (int slots = 2; slots >= 1; --slots) {
    const size_t f = t3_fixed(p, n_in, slots);
    const size_t room = f < kT2SmemLimit ? kT2SmemLimit - f : 0;
    for (int R = r0; R >= rmin; R /= 2) {
      const int T = (P + R - 1) / R;
      size_t s = room / (row * R);
      if (s > (size_t)kT2MaxStages) s = kT2MaxStages;
      if (s > (size_t)T) s = T;
      if ((int)s >= (T < 2 ? T : 2)) {
        p.slots = slots;
        p.R = R;
        p.T = T;
        p.S = (int)s;
        p.fixed = f;
        p.bytes = f + row * R * s;
        return p;
      }
    }
  }
  p.fits = 0;
  p.slots = 1;
  p.R = P;
  p.T = 1;
  p.S = 0;
  p.fixed = t3_fixed(p, n_in, 1);
  p.bytes = p.fixed;
  return p;
}

// The team plan of a launch, or an error where the shape is not taken.
int team3_plan(int B, int P, int n_in, int K, int NB, int NT, int sweep, int stream,
               Plan3* p) {
  if (int e = check_shape(P, n_in, K)) return e;
  if (P % 8 || B < 1) return (int)cudaErrorInvalidValue;
  *p = plan3(P, n_in, NB, NT, sweep, stream);
  return p->fits ? 0 : (int)cudaErrorInvalidValue;
}

// The high word of x 2^896 (x a bf16 value: its low word is 0).
__device__ __forceinline__ uint32_t t3_hiword(float x) {
  return (uint32_t)__double2hiint((double)x * kT3Scale);
}
// An exchanged term from its high word.
__device__ __forceinline__ double t3_x(uint32_t hi) { return __hiloint2double((int)hi, 0); }

// ---------------------------------------------------------------------------
// One block's share of a team
// ---------------------------------------------------------------------------

struct Team3 {
  Plan3 p;
  int rank, c0;          // this block owns populations [c0, c0 + nc)
  int b0;                // the team's first lane of the knot table
  int par, rpar;         // exchange slot and team-sum buffer in use
  unsigned char* ex;     // exchange slot 0: X (P, xs) words, or (NT, C, nc) VJP partials
  size_t exs;            // bytes from slot 0 to slot 1 (0: one slot)
  float* recs;           // (NB, nc) the lanes' rec sums of the own columns
  double* cvec;          // (nc) the VJP's cotangent of the own populations
  float* ext;            // (2, NB, n_in) the stimulus
  float* kvs;            // (K, NB, n_in) the lanes' knot values
  float* iwc;            // (n_in, nc) the own columns of iwT
  float *bg, *ad;        // (nc) the own populations' background current and adaptation
  double *red, *cred;    // block sum (kThreads / 32), team sums (2, C)
  uint64_t* mbar;        // tma_ring.cuh
  uint32_t* w;           // the resident slice, or stage 0 of the ring
  const uint32_t* src;   // this block's packed slice in device memory
  int used, limit;       // tiles consumed so far; the ring's bound
};

// The exchange slot in use. (A slot address from arithmetic, not from an
// array indexed at run time: that would put the team's state in local
// memory.)
__device__ __forceinline__ unsigned char* t3_slot(const Team3& T) {
  return T.ex + (size_t)T.par * T.exs;
}

// Carve the shared memory, copy what the drift reads of the own populations
// and of the lanes' stimulus, start the weights' copies, and make sure every
// block of the cluster has started before any writes into another's shared
// memory. NB lanes from b0 of the knot table; sweep: the emit-mode sweep's
// plan (one lane, with VJPs).
__device__ __forceinline__ void team3_init(Team3& T, unsigned char* sm, const Net& n, int NB, int NT, int sweep,
                           int b0, const uint32_t* wpk, const float* __restrict__ iw,
                           int stream) {
  const int P = n.P, NI = n.n_in;
  T.p = plan3(P, NI, NB, NT, sweep, stream);
  const Plan3& p = T.p;
  T.rank = (int)cgo::this_cluster().block_rank();
  T.c0 = T.rank * p.nc;
  T.b0 = b0;
  T.par = T.rpar = 0;
  unsigned char* q = sm;
  T.ex = q;
  T.exs = p.slots == 2 ? p.slot : 0;
  q += p.slots * p.slot;
  T.recs = reinterpret_cast<float*>(q);
  q += t2_align(4 * (size_t)NB * p.nc);
  T.cvec = reinterpret_cast<double*>(q);
  q += t2_align(8 * (size_t)p.nc);
  T.ext = reinterpret_cast<float*>(q);
  q += t2_align(4 * 2 * (size_t)NB * NI);
  T.kvs = reinterpret_cast<float*>(q);
  q += t2_align(4 * (size_t)kMaxKnots * NB * NI);
  T.iwc = reinterpret_cast<float*>(q);
  T.bg = T.iwc + (size_t)NI * p.nc;
  T.ad = T.bg + p.nc;
  q += t2_align(4 * (size_t)(NI + 2) * p.nc);
  T.red = reinterpret_cast<double*>(q);
  T.cred = T.red + kThreads / 32;
  q += t2_align(8 * (size_t)(kThreads / 32 + 2 * p.C));
  T.mbar = reinterpret_cast<uint64_t*>(q);
  T.w = reinterpret_cast<uint32_t*>(sm + p.fixed);
  T.src = wpk + (size_t)T.rank * P * p.rw;
  T.used = 0;
  T.limit = 0x7fffffff;
  uint32_t* ex32 = reinterpret_cast<uint32_t*>(sm);
  for (size_t j = threadIdx.x; j < p.slots * p.slot / 4; j += blockDim.x) ex32[j] = 0u;
  for (int j = threadIdx.x; j < n.K * NB * NI; j += blockDim.x) {
    const int k = j / (NB * NI), r = j - k * NB * NI, bb = r / NI, m = r - bb * NI;
    T.kvs[j] = n.kv[((size_t)k * n.B + b0 + bb) * NI + m];
  }
  for (int j = threadIdx.x; j < NI * p.nc; j += blockDim.x) {
    const int m = j / p.nc;
    T.iwc[j] = iw[(size_t)m * P + T.c0 + (j - m * p.nc)];
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
__device__ __forceinline__ double team3_sum(Team3& T, double v) {
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

// ext[m] of the team's lane bb at time t from its knot values in shared
// memory: network_drift.cuh's knot_interp, operation for operation.
__device__ __forceinline__ float t3_knot(const Net& n, const Team3& T, int bb, int m, float t) {
  const int NB = T.p.NB, NI = n.n_in;
  float out = T.kvs[bb * NI + m];
  for (int k = 1; k < n.K; ++k) {
    const float frac = fminf(fmaxf((t - n.kc0[k - 1]) / n.kd[k - 1], 0.0f), 1.0f);
    out = out + frac * (T.kvs[(k * NB + bb) * NI + m] - T.kvs[((k - 1) * NB + bb) * NI + m]);
  }
  return out;
}

// The forward products of a drift evaluation: for every lane b and own
// column j, rec = the NP product sums over all rows k rounded to float32 and
// added left to right (three terms: x_hi W_lo, x_mid W_mid, x_lo W_hi,
// x_hi W_mid, x_mid W_hi, x_hi W_hi; two: x_hi W_hi, x_hi W_mid,
// x_mid W_hi) -> recs[b nc + j]. Thread (g, j, l), g the lane group, sums
// the rows k = l mod L in order; a butterfly of shuffles over the L lanes.
template <int NT, int LB, bool kStream>
__device__ __forceinline__ void t3_fwd_products(Team3& T, int P, const uint32_t* __restrict__ X) {
  constexpr int NP = NT == 3 ? 6 : 3;
  constexpr int GW = (LB * NT + 1) / 2 * 2;
  const Plan3& p = T.p;
  const int nc = p.nc, L = p.L, rw = p.rw, xs = p.xs, NB = p.NB, R = p.R, NTl = p.T;
  float* const recs = T.recs;
  const int o = threadIdx.x / L, l = threadIdx.x - o * L;
  const bool act = o < p.G * nc;
  const int g = act ? o / nc : 0, j = act ? o - g * nc : 0;
  double acc[LB][NP];
#pragma unroll
  for (int q = 0; q < LB; ++q) {
#pragma unroll
    for (int r = 0; r < NP; ++r) acc[q][r] = 0.0;
  }
  const uint32_t* xg = X + g * GW;
  for (int m = 0; m < NTl; ++m) {
    const int gg = T.used + m;
    const uint32_t* tile = t2_acquire<kStream>(T, gg, P);
    const int k0 = m * R, k1 = min(P, k0 + R);
    if (act) {
#pragma unroll 2
      for (int k = k0 + l; k < k1; k += L) {
        const uint16_t* row = reinterpret_cast<const uint16_t*>(tile + (size_t)(k - k0) * rw) + j;
        const double wh = t3_w(row[0]), wm = t3_w(row[nc]);
        double wl = 0.0;
        if constexpr (NT == 3) wl = t3_w(row[2 * nc]);
        uint32_t xw[GW];
        if constexpr (GW % 4 == 0) {
          const uint4* x4 = reinterpret_cast<const uint4*>(xg + (size_t)k * xs);
#pragma unroll
          for (int v = 0; v < GW / 4; ++v) {
            const uint4 u = x4[v];
            xw[4 * v] = u.x;
            xw[4 * v + 1] = u.y;
            xw[4 * v + 2] = u.z;
            xw[4 * v + 3] = u.w;
          }
        } else {
          const uint2* x2 = reinterpret_cast<const uint2*>(xg + (size_t)k * xs);
#pragma unroll
          for (int v = 0; v < GW / 2; ++v) {
            const uint2 u = x2[v];
            xw[2 * v] = u.x;
            xw[2 * v + 1] = u.y;
          }
        }
#pragma unroll
        for (int q = 0; q < LB; ++q) {
          const double a = t3_x(xw[q * NT]), c = t3_x(xw[q * NT + 1]);
          if constexpr (NT == 3) {
            const double d = t3_x(xw[q * NT + 2]);
            acc[q][0] = fma(a, wl, acc[q][0]);
            acc[q][1] = fma(c, wm, acc[q][1]);
            acc[q][2] = fma(d, wh, acc[q][2]);
            acc[q][3] = fma(a, wm, acc[q][3]);
            acc[q][4] = fma(c, wh, acc[q][4]);
            acc[q][5] = fma(a, wh, acc[q][5]);
          } else {
            acc[q][0] = fma(a, wh, acc[q][0]);
            acc[q][1] = fma(a, wm, acc[q][1]);
            acc[q][2] = fma(c, wh, acc[q][2]);
          }
        }
      }
    }
    t2_release<kStream>(T, gg);
  }
  if (kStream) T.used += NTl;
  for (int off = L / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < LB; ++q) {
#pragma unroll
      for (int r = 0; r < NP; ++r) acc[q][r] += __shfl_xor_sync(0xffffffffu, acc[q][r], off);
    }
  }
  if (act && l == 0) {
#pragma unroll
    for (int q = 0; q < LB; ++q) {
      const int b = g * LB + q;
      if (b < NB) {
        float rec = (float)acc[q][0];
#pragma unroll
        for (int r = 1; r < NP; ++r) rec = rec + (float)acc[q][r];
        recs[b * nc + j] = rec;
      }
    }
  }
}

// A VJP's products (one lane a team): for every row k, the sums over this
// block's columns j of cvec[j] W_t[k, j] for each term t (Lv lanes per row,
// lane l summing the columns j = l mod Lv in order, then a butterfly),
// stored into slot (t, rank, k mod nc) of the exchange slot of k's owner.
template <int NT, bool kStream>
__device__ __forceinline__ void t3_vjp_products(Team3& T, int P) {
  const Plan3& p = T.p;
  cgo::cluster_group cl = cgo::this_cluster();
  const int nc = p.nc, Lv = p.Lv, rw = p.rw, C = p.C, R = p.R, NTl = p.T, rank = T.rank;
  const int RR = kThreads / Lv, rr = threadIdx.x / Lv, l = threadIdx.x - rr * Lv;
  const double* cv = T.cvec;
  double* slot = reinterpret_cast<double*>(t3_slot(T));
  for (int m = 0; m < NTl; ++m) {
    const int g = T.used + m;
    const uint32_t* tile = t2_acquire<kStream>(T, g, P);
    const int k0 = m * R, rows = min(R, P - k0);
    for (int r0 = 0; r0 < rows; r0 += RR) {
      const int r = r0 + rr;
      const bool ok = r < rows;
      double d[NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) d[t] = 0.0;
      if (ok) {
        const uint16_t* row = reinterpret_cast<const uint16_t*>(tile + (size_t)r * rw);
#pragma unroll 2
        for (int j = l; j < nc; j += Lv) {
          const double c = cv[j];
          d[0] = fma(c, t3_w(row[j]), d[0]);
          d[1] = fma(c, t3_w(row[nc + j]), d[1]);
          if constexpr (NT == 3) d[2] = fma(c, t3_w(row[2 * nc + j]), d[2]);
        }
      }
      for (int off = Lv / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int t = 0; t < NT; ++t) d[t] += __shfl_xor_sync(0xffffffffu, d[t], off);
      }
      if (ok && l == 0) {
        const int k = k0 + r, owner = k / nc;
        double* dst = cl.map_shared_rank(slot, owner);
#pragma unroll
        for (int t = 0; t < NT; ++t) dst[(t * C + rank) * nc + (k - owner * nc)] = d[t];
      }
    }
    t2_release<kStream>(T, g);
  }
  if (kStream) T.used += NTl;
}

// One drift evaluation of the team's lanes at time t: the owned items'
// states s -> out (owner threads); every thread of the block calls it.
template <int NT, int LB, int IPT, bool kStream>
__device__ __forceinline__ void t3_drift(const Net& n, Team3& T, float t, const float (&s)[IPT][3],
                                         float (&out)[IPT][3]) {
  cgo::cluster_group cl = cgo::this_cluster();
  const Plan3& p = T.p;
  const int nc = p.nc, NI = n.n_in, NB = p.NB, own = NB * nc, C = p.C, xs = p.xs, gw = p.gw;
  const int c0 = T.c0;
  uint32_t* X = reinterpret_cast<uint32_t*>(t3_slot(T));
  float* ext = T.ext + T.par * NB * NI;
  const float* recs = T.recs;
  const float *iwc = T.iwc, *bg = T.bg, *ad = T.ad;
  if (p.slots == 1) cl.sync();  // every block has read the slot's last exchange
  float fr[IPT];
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
    const int e = threadIdx.x + q * kThreads;
    fr[q] = 0.0f;
    if (e < own) {
      const int b = e / nc, i = e - b * nc;
      fr[q] = firing_rate(s[q][0] - s[q][1]);
      const float hi = bf16r(fr[q]);
      uint32_t wd[NT];
      wd[0] = t3_hiword(hi);
      if constexpr (NT == 2) {
        wd[1] = t3_hiword(bf16r(fr[q] - hi));
      } else {
        const float r = fr[q] - hi, mid = bf16r(r);
        wd[1] = t3_hiword(mid);
        wd[2] = t3_hiword(bf16r(r - mid));
      }
      uint32_t* dst = X + (size_t)(c0 + i) * xs + (b / LB) * gw + (b % LB) * NT;
#pragma unroll
      for (int u = 0; u < NT; ++u) dst[u] = wd[u];
    }
  }
  for (int idx = threadIdx.x; idx < NB * NI; idx += blockDim.x) {
    const int bb = idx / NI, m = idx - bb * NI;
    ext[idx] = t3_knot(n, T, bb, m, t);
  }
  __syncthreads();
  // The own rows, contiguous in X, to every other block in 16- (or 8-)
  // byte stores, consecutive threads on consecutive addresses: a warp's
  // stores fill whole segments of the remote shared memory.
  if ((nc * xs) % 4 == 0) {
    const int nv = nc * xs / 4;
    const uint4* src = reinterpret_cast<const uint4*>(X + (size_t)c0 * xs);
    for (int idx = threadIdx.x; idx < C * nv; idx += blockDim.x) {
      const int r = idx / nv, v = idx - r * nv;
      if (r != T.rank) cl.map_shared_rank(const_cast<uint4*>(src), r)[v] = src[v];
    }
  } else {
    const int nv = nc * xs / 2;
    const uint2* src = reinterpret_cast<const uint2*>(X + (size_t)c0 * xs);
    for (int idx = threadIdx.x; idx < C * nv; idx += blockDim.x) {
      const int r = idx / nv, v = idx - r * nv;
      if (r != T.rank) cl.map_shared_rank(const_cast<uint2*>(src), r)[v] = src[v];
    }
  }
  cl.sync();
  t3_fwd_products<NT, LB, kStream>(T, n.P, X);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
    const int e = threadIdx.x + q * kThreads;
    if (e < own) {
      const int b = e / nc, i = e - b * nc;
      const float rec = recs[b * nc + i];
      double ex = 0.0;
      for (int m = 0; m < NI; ++m)
        ex = fma((double)ext[b * NI + m], (double)iwc[m * nc + i], ex);
      const float current = (rec + (float)ex) + bg[i];
      const float total = current * n.tau_s;
      out[q][0] = (-s[q][0] + total * n.R) / n.tau_m;
      out[q][1] = (-s[q][1] + ad[i] * fr[q]) / n.tau_a;
      out[q][2] = (-s[q][2] + fr[q]) / n.tau_s;
    } else {
      out[q][0] = out[q][1] = out[q][2] = 0.0f;
    }
  }
  T.par ^= 1;
}

// The state cotangent of one drift evaluation (one lane a team) at the own
// state y for the output cotangent ct -> out (owner threads), with jax.vjp's
// rounding points (team.cuh vjp_out). The stimulus is data: no time enters.
template <int NT, bool kStream>
__device__ __forceinline__ void t3_vjp(const Net& n, Team3& T, const float (&y)[3],
                                       const float (&ct)[3], float (&out)[3]) {
  const int i = threadIdx.x, nc = T.p.nc, C = T.p.C;
  const float* ad = T.ad;
  double* const cvec = T.cvec;
  float frp = 0.0f;
  if (i < nc) {
    float fr;
    fr_and_grad(y[0] - y[1], fr, frp);
    cvec[i] = (double)(((ct[0] / n.tau_m) * n.R) * n.tau_s) * kT3Scale;
  }
  __syncthreads();
  t3_vjp_products<NT, kStream>(T, n.P);
  cgo::this_cluster().sync();
  if (i < nc) {
    const double* slot = reinterpret_cast<const double*>(t3_slot(T));
    double d[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) d[t] = 0.0;
#pragma unroll 4
    for (int r = 0; r < C; ++r) {  // each term's partials in rank order
#pragma unroll
      for (int t = 0; t < NT; ++t) d[t] += slot[(t * C + r) * nc + i];
    }
    const float m = bf16r((float)d[0]), q = bf16r((float)d[1]);
    float xbar;
    if constexpr (NT == 2) {
      xbar = m + bf16r(bf16r(m + q) - m);
    } else {
      const float lo = bf16r((float)d[2]);
      const float u = bf16r(m + q);
      const float r = m + bf16r(u - m);
      xbar = r + bf16r(bf16r(u + lo) + bf16r(-r));
    }
    const float cv = ct[0], ca = ct[1], cr = ct[2];
    const float c_fr = (xbar + ad[i] * (ca / n.tau_a)) + cr / n.tau_s;
    const float c_x = frp * c_fr;
    out[0] = -(cv / n.tau_m) + c_x;
    out[1] = -(ca / n.tau_a) - c_x;
    out[2] = -(cr / n.tau_s);
  }
  T.par ^= 1;
}

// ---------------------------------------------------------------------------
// B6: the selection, one team for the batch
// ---------------------------------------------------------------------------

// The owned items' step state: y, the stage derivatives k[c][0..6] (k0 =
// f(t, y)), the fifth-order solution y1.
template <int IPT>
struct SelState {
  float y[IPT][3], k[IPT][3][kStages], y1[IPT][3];
};

__device__ __forceinline__ bool t3_owned(const Team3& T, int q) {
  return threadIdx.x + q * kThreads < T.p.NB * T.p.nc;
}

// Offset of item q's component c in a (B, 3P) state.
__device__ __forceinline__ size_t t3_off(const Team3& T, int P, int q, int c) {
  const int e = threadIdx.x + q * kThreads, b = e / T.p.nc, i = e - b * T.p.nc;
  return (size_t)b * 3 * P + (size_t)c * P + T.c0 + i;
}

// One controller attempt from (t, y, k0) with step h: y1, k6 = f(t + h,
// y1), and the error ratio over the whole batch state (N entries).
template <int IPT, bool kStream>
__device__ __forceinline__ float t3_attempt(const Net& n, Team3& T, const Sel& sel, int N, float t, float h,
                            SelState<IPT>& u) {
  float ys[IPT][3], f[IPT][3];
#pragma unroll
  for (int i = 1; i < kStages; ++i) {
#pragma unroll
    for (int q = 0; q < IPT; ++q) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v = stage(i, h, u.y[q][c], u.k[q][c]);
        if (i == kStages - 1) u.y1[q][c] = v;
        ys[q][c] = v;
      }
    }
    t3_drift<3, IPT == 1 ? 4 : 2, IPT, kStream>(n, T, t + kC[i] * h, ys, f);
#pragma unroll
    for (int q = 0; q < IPT; ++q) {
#pragma unroll
      for (int c = 0; c < 3; ++c) u.k[q][c][i] = f[q][c];
    }
  }
  double acc = 0.0;
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
    if (t3_owned(T, q)) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float err = weighted(kBErr, h, u.k[q][c]);
        const float r = err / (sel.atol + sel.rtol * fmaxf(fabsf(u.y[q][c]), fabsf(u.y1[q][c])));
        acc += (double)(r * r);
      }
    }
  }
  return sqrtf((float)team3_sum(T, acc) / (float)N);
}

template <int IPT, bool kStream>
__device__ __forceinline__ float t3_initial_step(const Net& n, Team3& T, const Sel& sel, int N, float t0,
                                 SelState<IPT>& u) {
  double a0 = 0.0, a1 = 0.0;
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
    if (t3_owned(T, q)) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float scale = sel.atol + sel.rtol * fabsf(u.y[q][c]);
        const float q0 = u.y[q][c] / scale, q1 = u.k[q][c][0] / scale;
        a0 += (double)(q0 * q0);
        a1 += (double)(q1 * q1);
      }
    }
  }
  const float d0 = sqrtf((float)team3_sum(T, a0) / (float)N);
  const float d1 = sqrtf((float)team3_sum(T, a1) / (float)N);
  const float h0 = (d0 < 1e-5f || d1 < 1e-5f) ? 1e-6f : (0.01f * d0) / d1;
  float ys[IPT][3], f1[IPT][3];
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
#pragma unroll
    for (int c = 0; c < 3; ++c) ys[q][c] = u.y[q][c] + h0 * u.k[q][c][0];
  }
  t3_drift<3, IPT == 1 ? 4 : 2, IPT, kStream>(n, T, t0 + h0, ys, f1);
  double a2 = 0.0;
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
    if (t3_owned(T, q)) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float scale = sel.atol + sel.rtol * fabsf(u.y[q][c]);
        const float r = (f1[q][c] - u.k[q][c][0]) / scale;
        a2 += (double)(r * r);
      }
    }
  }
  const float d2 = sqrtf((float)team3_sum(T, a2) / (float)N) / h0;
  const float h1 = (d1 <= 1e-15f && d2 <= 1e-15f)
                       ? fmaxf(h0 * 1e-3f, 1e-6f)
                       : expf((float)(1.0 / 5) * logf(0.01f / fmaxf(d1, d2)));
  return nan_min(100.0f * h0, h1);
}

// B6: the whole selection of the batch on the three-term split, one team of
// C blocks. st (M + 1) the accepted times (t_end past the last), stats
// (naccept, nreject, success).
template <int IPT, bool kStream>
__global__ void __launch_bounds__(kThreads, 1)
ode_select16_kernel(Net n, Sel sel, const uint32_t* __restrict__ wpk,
                    const float* __restrict__ iw, const float* __restrict__ y0,
                    float* __restrict__ st, int* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smt[];
  Team3 T;
  team3_init(T, smt, n, n.B, 3, 0, 0, wpk, iw, kStream);
  const int P = n.P, N = n.B * 3 * P, M = sel.max_steps;
  const bool lead = T.rank == 0;
  if (lead)
    for (int i = threadIdx.x; i <= M; i += blockDim.x) st[i] = i == 0 ? sel.t_start : sel.t_end;
  SelState<IPT> u;
  float f[IPT][3];
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
#pragma unroll
    for (int c = 0; c < 3; ++c) u.y[q][c] = t3_owned(T, q) ? y0[t3_off(T, P, q, c)] : 0.0f;
  }
  float t = sel.t_start;
  t3_drift<3, IPT == 1 ? 4 : 2, IPT, kStream>(n, T, t, u.y, f);
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
#pragma unroll
    for (int c = 0; c < 3; ++c) u.k[q][c][0] = f[q][c];
  }
  float h = sel.use_initial ? t3_initial_step<IPT, kStream>(n, T, sel, N, t, u) : sel.dt0;
  h = nan_min(h, sel.span);
  int na = 0, nr = 0;
  while (t < sel.t_end && na < M && nr < 4 * M + 64) {
    h = nan_min(h, sel.t_end - t);
    const float ratio = t3_attempt<IPT, kStream>(n, T, sel, N, t, h, u);
    if (ratio <= 1.0f) {
      t = t + h;
#pragma unroll
      for (int q = 0; q < IPT; ++q) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          u.y[q][c] = u.y1[q][c];
          u.k[q][c][0] = u.k[q][c][kStages - 1];
        }
      }
      ++na;
    } else {
      ++nr;
    }
    if (lead && threadIdx.x == 0) st[na] = t;
    h = next_step(h, ratio);
  }
  if (lead && threadIdx.x == 0) {
    stats[0] = na;
    stats[1] = nr;
    stats[2] = t >= sel.t_end ? 1 : 0;
  }
  if (kStream) t2_drain(T);
}

// One attempt of that kernel's loop: y1, f1 = k6, rec = (ratio, h, next h).
template <int IPT, bool kStream>
__global__ void __launch_bounds__(kThreads, 1)
ode_attempt16_kernel(Net n, Sel sel, const uint32_t* __restrict__ wpk,
                     const float* __restrict__ iw, const float* __restrict__ t_in,
                     const float* __restrict__ h_in, const float* __restrict__ y,
                     const float* __restrict__ f0, float* __restrict__ y1,
                     float* __restrict__ f1, float* __restrict__ rec) {
  extern __shared__ __align__(16) unsigned char smt[];
  Team3 T;
  team3_init(T, smt, n, n.B, 3, 0, 0, wpk, iw, kStream);
  const int P = n.P, N = n.B * 3 * P;
  SelState<IPT> u;
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
    const bool own = t3_owned(T, q);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      u.y[q][c] = own ? y[t3_off(T, P, q, c)] : 0.0f;
      u.k[q][c][0] = own ? f0[t3_off(T, P, q, c)] : 0.0f;
    }
  }
  const float t = t_in[0];
  const float h = nan_min(h_in[0], sel.t_end - t);
  const float ratio = t3_attempt<IPT, kStream>(n, T, sel, N, t, h, u);
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
    if (t3_owned(T, q)) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        y1[t3_off(T, P, q, c)] = u.y1[q][c];
        f1[t3_off(T, P, q, c)] = u.k[q][c][kStages - 1];
      }
    }
  }
  if (T.rank == 0 && threadIdx.x == 0) {
    rec[0] = ratio;
    rec[1] = h;
    rec[2] = next_step(h, ratio);
  }
  if (kStream) t2_drain(T);
}

// ---------------------------------------------------------------------------
// B8' / B8't: the emit-mode sweep, one team per lane
// ---------------------------------------------------------------------------

// Lane blockIdx.x / C over steps n-1..0: per step k it first writes
// ybar_steps[k] = the cotangent on the step's output from the later steps,
// rebuilds the stage states Y0..Y6 from ys[k] (drifts k0..k5), then
//   r3bar = c3 - c4;  dybar = (c2 + c4) - r3bar;  y1bar = ybar + dybar
//   kbar_j = (h d_j) c5;  kbar_6 -= h c4;  kbar_0 += h r3bar
//   kbar_j += (h b_j) y1bar;  ysum = (c1 - dybar) + y1bar
//   for s = 6..0:  g = f^T|_{Y_s} kbar_s;  ysum += g;  kbar_j += (h a_sj) g
// and ybar = ysum (network_ode.cu ode_replay_bwd_kernel, without the weight
// cotangents). NT = 2: B8'; NT = 3: B8't.
template <int NT, bool kStream>
__global__ void __launch_bounds__(kThreads, 1)
ode_emit16_kernel(Net n, int n_steps, const uint32_t* __restrict__ wpk,
                  const float* __restrict__ iw, const float* __restrict__ st,
                  const float* __restrict__ ys, const float* __restrict__ cobar,
                  float* __restrict__ ybar_out, float* __restrict__ ybar_steps) {
  extern __shared__ __align__(16) unsigned char smt[];
  Team3 T;
  const int b = blockIdx.x / (n.P % 16 == 0 ? 16 : 8);
  team3_init(T, smt, n, 1, NT, 1, b, wpk, iw, kStream);
  const int P = n.P, S = 3 * P, B = n.B;
  const size_t N = (size_t)B * S;
  const bool own = threadIdx.x < T.p.nc;
  const size_t col = (size_t)b * S + T.c0 + threadIdx.x;
  float Y[kStages][1][3], kk[3][kStages], ysum[3] = {0.0f, 0.0f, 0.0f};
  float yn[3] = {0.0f, 0.0f, 0.0f};
  float f[1][3], g[3];
  if (own && n_steps > 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) yn[c] = ys[(size_t)(n_steps - 1) * N + col + c * P];
  }
  for (int k = n_steps - 1; k >= 0; --k) {
    const float t0 = st[k], h = st[k + 1] - t0;
#pragma unroll
    for (int c = 0; c < 3; ++c) Y[0][0][c] = yn[c];
    if (own) {
      float* sk = ybar_steps + (size_t)k * N;
#pragma unroll
      for (int c = 0; c < 3; ++c) sk[col + c * P] = ysum[c];
    }
    if (own && k >= 1) {  // the next step's state, one step ahead
#pragma unroll
      for (int c = 0; c < 3; ++c) yn[c] = ys[(size_t)(k - 1) * N + col + c * P];
    }
    t3_drift<NT, 1, 1, kStream>(n, T, t0, Y[0], f);
#pragma unroll
    for (int c = 0; c < 3; ++c) kk[c][0] = f[0][c];
#pragma unroll
    for (int i = 1; i < kStages; ++i) {
#pragma unroll
      for (int c = 0; c < 3; ++c) Y[i][0][c] = stage(i, h, Y[0][0][c], kk[c]);
      if (i < kStages - 1) {
        t3_drift<NT, 1, 1, kStream>(n, T, t0 + kC[i] * h, Y[i], f);
#pragma unroll
        for (int c = 0; c < 3; ++c) kk[c][i] = f[0][c];
      }
    }
    float cc[5][3];
#pragma unroll
    for (int r = 0; r < 5; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        cc[r][c] = own ? cobar[((size_t)k * 5 + r) * N + col + c * P] : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float c1 = cc[0][c], c2 = cc[1][c], c3 = cc[2][c], c4 = cc[3][c], c5 = cc[4][c];
      const float r3bar = c3 - c4;
      const float dybar = (c2 + c4) - r3bar;
      const float y1bar = ysum[c] + dybar;
#pragma unroll
      for (int j = 0; j < kStages; ++j) {
        float v = kD[j] != 0.0f ? (h * kD[j]) * c5 : 0.0f;
        if (j == kStages - 1) v = v - h * c4;
        if (j == 0) v = v + h * r3bar;
        if (kB[j] != 0.0f) v = v + (h * kB[j]) * y1bar;
        kk[c][j] = v;
      }
      ysum[c] = (c1 - dybar) + y1bar;
    }
#pragma unroll
    for (int s = kStages - 1; s >= 0; --s) {
      const float ct[3] = {kk[0][s], kk[1][s], kk[2][s]};
      t3_vjp<NT, kStream>(n, T, Y[s][0], ct, g);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        ysum[c] = ysum[c] + g[c];
#pragma unroll
        for (int j = 0; j < s; ++j) {
          const float a = kA[s][j];
          if (a != 0.0f) kk[c][j] = kk[c][j] + (h * a) * g[c];
        }
      }
    }
  }
  if (own) {
#pragma unroll
    for (int c = 0; c < 3; ++c) ybar_out[col + c * P] = ysum[c];
  }
  if (kStream) t2_drain(T);
}

}  // namespace
