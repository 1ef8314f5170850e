// The dopri5 selection (B6), the forward replay over the frozen grid (B7t-team
// on the three-term split, B7 split2 on the two-term one), the emit-mode
// reverse sweep (B8' on the two-term split, B8't on the three-term one) and
// the kernel-mode reverse sweep (B8 and B8t-team: the exact engine's sweep
// with its weight cotangents, one team for the batch) as Hopper
// thread-block-cluster teams: cf_ode_select, cf_ode_attempt
// (ode_select_team.cu), cf_ode_replay_fwd_team, cf_ode_replay_fwd_split2
// (ode_replay_team.cu), cf_ode_replay_bwd_emit,
// cf_ode_replay_bwd_emit_split3 (ode_emit_team.cu) and
// cf_ode_replay_bwd_ksweep (ode_ksweep_team.cu). Its team functions
// (team3_init, t3_drift, t3_vjp) also carry the three-term SDE replay and
// its emit-mode sweep (sde3_replay_team.cu). Included once per source; the
// definitions live in an unnamed namespace.
//
// Replaces (columnflow/solvers/fused.py):
//   ode_select16_kernel  <- _make_adaptive_kernel (B6): Hairer's initial
//                           step, the accept/reject loop and the accepted
//                           times, on prepare_premixed_split's three terms
//   ode_attempt16_kernel <- one iteration of that loop (a test entry)
//   ode_replay16_kernel  <- _make_replay_chunk_kernel (B7t-team, B7 split2):
//                           per step the step-start state and the six-stage
//                           step's five dense-output rows
//   ode_emit16_kernel    <- _make_bwd_chunk_kernel(emit_steps=True) (B8',
//                           B8't): the state cotangent alone and each
//                           step's output cotangent
//   ode_ksweep16_kernel  <- _make_bwd_chunk_kernel, kernel mode (B8,
//                           B8t-team): the state cotangent and the weight
//                           cotangents d wT, d iwT, the batch on one team
//
// What bounds them on this card: serial chains (~1.3 * 10^4 selection
// attempts over the second at 104 columns, ~1.2 * 10^4 accepted steps),
// each attempt six drift evaluations, each replay step seven and each sweep
// step six drifts and seven drift VJPs, every one a (B, P) x (P, P) product
// on each term of the split. The work of one is a few MFLOP; what costs is
// its latency. The teams they replace (team.cuh, 8 blocks) read the bf16
// terms from L2 in every product and kept the states in global memory.
//
// This design follows B3/B4's (replay2_team.cuh). A team is a cluster of C
// blocks (16 where 16 divides P, else 8; the replay also takes 8 where the
// card cannot hold a cluster of 16 for every lane at once; launched with
// cudaLaunchKernelEx): ONE team for the selection's batch (its controller's
// error ratio is an RMS over every lane, so every block must see the same
// sum, which a cluster barrier gives and a launch of several clusters does
// not), one per lane for the replay and the sweep. Block r owns the
// populations [r nc, (r+1) nc), nc = P / C, of every lane it holds, and
// keeps the columns [r nc, (r+1) nc) of the NT bf16 terms of wT, packed by
// the wrapper (ode_team_pack) into one (P, rw) slice of 32-bit words: row k
// holds the hi, mid (and lo) bf16 of the block's columns, two a word, then
// pad words. A product needs no
// conversion: the bf16's bits placed in a double's sign, exponent and
// mantissa make the exact float64 w 2^-896 (t3_w), the other operand is
// held scaled by 2^896, and the product is exact (B3's and B4's products
// convert at ~7.5 bf16 -> float64 a cycle, PERF.md; each weight held as its
// float64 high word would need no bit operations but streams twice the
// bytes, which measured slower at 104 columns). The slice is copied by TMA
// bulk copies on mbarriers: once, where it fits (13 and 32 columns, and the
// two-term replay and sweep at 104), else through tma_ring.cuh's ring of
// tiles, whose tile sequence runs on across drifts and steps.
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
// exchange's stores. The replay has no VJP: its plan (LB = 1, no VJP slot)
// gives what that frees to the slice; its products sum in the 8-block
// team's order (t3_chunks: contiguous chunks of rows, a thread for each
// chunk and column), so that it equals that team bit for bit; where the
// three bf16 terms would stream and the float32 wT fits (104 columns), the
// slice holds wT, split as it is read (t3_split_w); and its owners write
// each step's rows to device memory from registers after the next drift's
// cluster barrier, so that the barrier's release does not wait for the
// stores.
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
#include "split_acc.cuh"
#include "tma_ring.cuh"

namespace {

namespace cgo = cooperative_groups;

constexpr int kT3MaxItems = 2;  // owned (lane, population) items a thread holds at most

// The uses of a team's plan (Plan3): the selection (the batch, forward
// products only), the emit-mode sweep (one lane, drifts and VJPs), the
// replay (one lane, drifts only), the SDE's emit-mode sweep (B4t,
// sde3_replay_team.cu: one lane, drifts in the replay's sum order and
// VJPs), and the kernel-mode sweep (the batch, drifts in the replay's sum
// order, VJPs and their weight cotangents: plan3k).
constexpr int kT3Select = 0, kT3Sweep = 1, kT3Replay = 2, kT3SdeSweep = 3, kT3KSweep = 4;

// The uses whose drifts sum in team8's order (t3_fwd_chunks), and which may
// keep the float32 wT as their slice.
__host__ __device__ inline bool t3_chunked(int use) {
  return use == kT3Replay || use == kT3SdeSweep;
}

// A team's shape, computed alike on the host (launch, shared-memory bytes)
// and in the kernel (carving, thread mappings); kernels/network_ode.py
// ode_team_plan repeats it and cf_ode_team_plan reports it.
struct Plan3 {
  int C;        // blocks per team (the cluster size)
  int nc;       // populations a block owns
  int NT, NB;   // terms of the split; lanes the team holds
  int LB, G;    // forward products: lanes per thread (the sweep and the replay 1, the
                // selection 4; 2 where a thread owns two items, for registers), lane groups
  int gw, xs;   // exchange words of a lane group, of a row k (even)
  int L, Lv;    // forward products: lanes per (group, column); VJP: lanes per row
  int rw;       // 32-bit words of a packed row: NT nc bf16 (f32: nc float32) and pad (max(1,
                // Lv / 2) times odd; f32: Lv times odd)
  int ipt;      // owned items per thread
  int slots;    // exchange slots (2: double buffered)
  int stream;   // 0: the slice is resident; 1: streamed in tiles
  int R, T, S;  // rows per tile, tiles per pass, stages (resident: P, 1, 1)
  int fits;     // 0: no shape of this design fits a block, or a thread would own more than
                // kT3MaxItems items (the route takes team8)
  size_t slot, fixed, bytes;  // bytes of an exchange slot, before the weights, in all
  int f32;      // 1: the slice holds the float32 wT, split as it is read (t3_split_w)
  int accs;     // the kernel-mode sweep: 1 keeps the step's weight-cotangent accumulators
                // and the own columns' d wT in shared memory, 0 in device memory
};

// Words of a packed row, padded so that a warp's loads fall in distinct
// banks: NT nc bf16, two a word (f32: nc float32, one a word), padded to v
// times an odd number of words, v = max(1, u / 2) (f32: u) for the u = 32 /
// L (= Lv) consecutive columns a warp reads in a row.
__host__ __device__ inline int t3_row_words(int nc, int NT, int Lv, bool f32) {
  const int v = f32 ? Lv : (Lv > 1 ? Lv / 2 : 1);
  int rw = ((f32 ? nc : (NT * nc + 1) / 2) + v - 1) / v * v;
  if ((rw / v) % 2 == 0) rw += v;
  return rw;
}

// The replay's forward products take the 8-block team's sum order
// (team.cuh drift_team, team8): the P rows in G contiguous chunks of kc
// (G from split_of of team8's P / 8 columns a block: 4 at 104 columns, 8
// through 64, 1 at 312), each chunk summed in order, the chunks' sums added
// in chunk order, so that its float64 sums, and its rows, are team8's bit
// for bit. (The selection's order, rows k = l mod L and a butterfly, parts
// from cuBLAS's in the float32 rounding of a sum a little more often: one
// element of phase 47's 104-column windows, PERF.md.) Thread (g, j) sums
// chunk g of column j for all the products, so that each weight is read and
// split once.
__host__ __device__ inline int t3_chunks(int P) {
  const int nc8 = P / 8;
  return 2 * nc8 <= kThreads ? (kThreads / nc8 < 8 ? kThreads / nc8 : 8) : 1;
}

// The VJP's own cotangents (nc float64; the kernel-mode sweep's NB nc,
// double buffered), or the replay's chunk sums (G NP nc; the SDE sweep's
// VJPs use their first nc).
__host__ __device__ inline size_t t3_cvec(const Plan3& p, int use) {
  if (use == kT3KSweep) return t2_align(8 * 2 * (size_t)p.NB * p.nc);
  const size_t np = p.NT == 3 ? 6 : 3;
  return t2_align(8 * (t3_chunked(use) ? t3_chunks(p.C * p.nc) * np : 1) * (size_t)p.nc);
}

__host__ __device__ inline size_t t3_fixed(const Plan3& p, int n_in, int slots, int use) {
  return (size_t)slots * p.slot
         + t2_align(4 * (size_t)p.NB * p.nc)                   // the lanes' rec sums
         + t3_cvec(p, use)
         + t2_align(4 * 2 * (size_t)p.NB * n_in)               // the stimulus, double buffered
         + t2_align(4 * (size_t)kMaxKnots * p.NB * n_in)       // the lanes' knot values
         + t2_align(4 * (size_t)(n_in + 2) * p.nc)             // own iwT columns, bg, adapt
         + t2_align(8 * (size_t)(kThreads / 32 + 2 * p.C))     // block and team sums
         + t2_align(8 * (size_t)(1 + 2 * kT2MaxStages));       // mbarriers
}

// The kernel-mode sweep's shared memory past t3_fixed: the current's
// cotangent of the own populations (float32, double buffered), the step's
// d iwT sum and the own columns' d iwT, and with accs the step's NT
// weight-cotangent accumulators and the own columns' d wT (P nc each).
__host__ __device__ inline size_t t3k_extra(const Plan3& p, int n_in, int accs) {
  return t2_align(4 * 2 * (size_t)p.NB * p.nc) + t2_align(4 * 2 * (size_t)n_in * p.nc)
         + (accs ? t2_align(4 * (size_t)(p.NT + 1) * (p.C * p.nc) * p.nc) : 0);
}

// The kernel-mode sweep's exchange slot: the forward's rate words X (P, xs)
// or the VJP's rate terms (P, NB) as bf16 bits (two words: hi | mid << 16,
// lo), then the VJP's partials (C, nc, NB, NT float64) or the forward's
// chunk sums (G, NP, NB, nc float64).
__host__ __device__ inline size_t t3k_xbytes(const Plan3& p) {
  const size_t P = (p.C * p.nc), x = 4 * P * p.xs, v = 8 * P * p.NB;
  return t2_align(x > v ? x : v);
}

__host__ __device__ inline size_t t3k_slot(const Plan3& p) {
  const size_t np = p.NT == 3 ? 6 : 3, a = (size_t)p.NT * p.C, b = t3_chunks((p.C * p.nc)) * np;
  return t3k_xbytes(p) + t2_align(8 * (size_t)p.NB * p.nc * (a > b ? a : b));
}

// The kernel-mode sweep (ode_ksweep16_kernel): the batch of NB lanes on one
// cluster of C blocks (16 where 16 divides P, else 8), block r owning
// populations [r nc, (r+1) nc) of every lane, one (lane, population) item a
// thread. Its forward products take the replay's sum order (t3_chunks: G
// chunks of rows, a thread for each chunk and column) for LB lanes a thread
// (1, or 4 where the G nc threads of a lane group cannot give every lane its
// own: kThreads / (G nc) groups); its VJP products take Lv lanes a row, Lv
// the largest power of two up to 32 with kThreads / Lv rows covering P. Two
// exchange slots and the accumulators in shared memory where they fit, else
// one slot, else the accumulators in device memory; the slice resident
// where it fits, else streamed. fits is 0 for NT != 3 (only the three-term
// split is built), more than one item a thread, or more than four lanes a
// thread.
__host__ __device__ inline Plan3 plan3k(int P, int n_in, int NB, int NT, int want_stream) {
  Plan3 p;
  p.C = P % 16 == 0 ? 16 : 8;
  p.nc = P / p.C;
  p.NT = NT;
  p.NB = NB;
  p.ipt = (NB * p.nc + kThreads - 1) / kThreads;
  const int groups = kThreads / (t3_chunks(P) * p.nc);
  const int lt = groups > 0 ? (NB + groups - 1) / groups : kThreads;
  p.LB = lt == 1 ? 1 : 4;
  p.G = (NB + p.LB - 1) / p.LB;
  p.gw = (p.LB * NT + 1) / 2 * 2;
  p.xs = p.G * p.gw;
  p.Lv = 32;
  while (p.Lv > 1 && kThreads / p.Lv < P) p.Lv /= 2;
  p.L = 32 / p.Lv;
  p.rw = t3_row_words(p.nc, NT, p.Lv, false);
  p.f32 = 0;
  p.fits = NT == 3 && p.ipt == 1 && lt <= 4;
  p.slot = t3k_slot(p);
  const size_t row = 4 * (size_t)p.rw;
  for (int slots = 2; slots >= 1; --slots) {
    for (int accs = 1; accs >= 0; --accs) {
      const size_t f = t3_fixed(p, n_in, slots, kT3KSweep) + t3k_extra(p, n_in, accs);
      if (!want_stream && f + row * P <= kT2SmemLimit) {
        p.slots = slots;
        p.accs = accs;
        p.stream = 0;
        p.R = P;
        p.T = 1;
        p.S = 1;
        p.fixed = f;
        p.bytes = f + row * P;
        return p;
      }
    }
  }
  // Streamed: tiles of R rows, R the first power of two from kThreads / Lv
  // (one VJP pass a tile) down that leaves S >= 2 stages.
  p.stream = 1;
  const int r0 = kThreads / p.Lv > kT2MinTileRows ? kThreads / p.Lv : kT2MinTileRows;
  for (int slots = 2; slots >= 1; --slots) {
    for (int accs = 1; accs >= 0; --accs) {
      const size_t f = t3_fixed(p, n_in, slots, kT3KSweep) + t3k_extra(p, n_in, accs);
      const size_t room = f < kT2SmemLimit ? kT2SmemLimit - f : 0;
      for (int R = r0; R >= 8; R /= 2) {
        const int T = (P + R - 1) / R;
        size_t s = room / (row * R);
        if (s > (size_t)kT2MaxStages) s = kT2MaxStages;
        if (s > (size_t)T) s = T;
        if ((int)s >= (T < 2 ? T : 2)) {
          p.slots = slots;
          p.accs = accs;
          p.R = R;
          p.T = T;
          p.S = (int)s;
          p.fixed = f;
          p.bytes = f + row * R * s;
          return p;
        }
      }
    }
  }
  p.fits = 0;
  p.slots = 1;
  p.accs = 0;
  p.R = P;
  p.T = 1;
  p.S = 0;
  p.fixed = t3_fixed(p, n_in, 1, kT3KSweep) + t3k_extra(p, n_in, 0);
  p.bytes = p.fixed;
  return p;
}

// The plan of a use at P populations; C the cluster size (0: 16 where 16
// divides P, else 8; the caller has checked that C divides P).
__host__ __device__ inline Plan3 plan3(int P, int n_in, int NB, int NT, int use,
                                       int want_stream, int C = 0) {
  if (use == kT3KSweep) return plan3k(P, n_in, NB, NT, want_stream);
  Plan3 p;
  p.accs = 0;
  p.C = C > 0 ? C : (P % 16 == 0 ? 16 : 8);
  p.nc = P / p.C;
  p.NT = NT;
  p.NB = NB;
  p.ipt = (NB * p.nc + kThreads - 1) / kThreads;
  p.LB = use != kT3Select ? 1 : (p.ipt == 1 ? 4 : 2);
  p.G = (NB + p.LB - 1) / p.LB;
  p.gw = (p.LB * NT + 1) / 2 * 2;
  p.xs = p.G * p.gw;
  p.L = 32;
  while (p.L > 1 && p.G * p.nc * p.L > kThreads) p.L /= 2;
  p.Lv = 32 / p.L;
  p.rw = t3_row_words(p.nc, NT, p.Lv, false);
  const size_t xb = 4 * (size_t)P * p.xs;
  const size_t vb = use == kT3Sweep || use == kT3SdeSweep ? 8 * (size_t)NT * P : 0;
  p.slot = t2_align(xb > vb ? xb : vb);
  p.fits = p.ipt <= kT3MaxItems;
  const size_t f2 = t3_fixed(p, n_in, 2, use);
  // The three-term replays (dopri5 and SDE) and the SDE sweep keep the
  // float32 wT instead where that slice stays resident and the three bf16
  // terms' would not (4 bytes a weight against 6: 90-104 columns with
  // clusters of 16, 63-72 with clusters of 8 for the replays): splitting
  // each weight as it is read costs more than the ring saves where the
  // terms stream anyway (312 columns), and the same where they fit
  // (PERF.md).
  const int rw32 = t3_row_words(p.nc, NT, p.Lv, true);
  p.f32 = t3_chunked(use) && NT == 3 && f2 + 4 * (size_t)p.rw * P > kT2SmemLimit &&
          f2 + 4 * (size_t)rw32 * P <= kT2SmemLimit;
  if (p.f32) p.rw = rw32;
  const size_t row = 4 * (size_t)p.rw;
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
    const size_t f = t3_fixed(p, n_in, slots, use);
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
  p.fixed = t3_fixed(p, n_in, 1, use);
  p.bytes = p.fixed;
  return p;
}

// The team plan of a launch, or an error where the shape is not taken.
int team3_plan(int B, int P, int n_in, int K, int NB, int NT, int use, int stream, Plan3* p,
               int C = 0) {
  if (int e = check_shape(P, n_in, K)) return e;
  if (P % 8 || B < 1 || (C != 0 && C != 8 && C != 16) || (C && P % C))
    return (int)cudaErrorInvalidValue;
  *p = plan3(P, n_in, NB, NT, use, stream, C);
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
  double* cvec;          // (nc) the VJP's cotangent of the own populations; the replay:
                         // (G, NP, nc) the own columns' chunk sums (t3_fwd_chunks)
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
// memory. NB lanes from b0 of the knot table; use: kT3Select, kT3Sweep,
// kT3Replay or kT3SdeSweep; C: the cluster size (0: the default).
__device__ __forceinline__ void team3_init_plan(Team3& T, unsigned char* sm, const Net& n,
                                                int NB, int use, int b0, const uint32_t* wpk,
                                                const float* __restrict__ iw, const Plan3& plan) {
  const int P = n.P, NI = n.n_in;
  T.p = plan;
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
  q += t3_cvec(p, use);
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

__device__ __forceinline__ void team3_init(Team3& T, unsigned char* sm, const Net& n, int NB,
                                           int NT, int use, int b0, const uint32_t* wpk,
                                           const float* __restrict__ iw, int stream, int C = 0) {
  team3_init_plan(T, sm, n, NB, use, b0, wpk, iw, plan3(n.P, n.n_in, NB, NT, use, stream, C));
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

// A float32 weight (its bits u) split as split_f32 splits it (hi = bf16(w),
// mid = bf16(w - hi), lo = bf16((w - hi) - mid), each rounded to nearest),
// each term as the float64 t3_w gives its bf16.
__device__ __forceinline__ void t3_split_w(uint32_t u, double& wh, double& wm, double& wl) {
  const float w = __uint_as_float(u);
  const bf16 h = __float2bfloat16_rn(w);
  const float r = w - __bfloat162float(h);
  const bf16 m = __float2bfloat16_rn(r);
  const bf16 l = __float2bfloat16_rn(r - __bfloat162float(m));
  wh = t3_w(__bfloat16_as_ushort(h));
  wm = t3_w(__bfloat16_as_ushort(m));
  wl = t3_w(__bfloat16_as_ushort(l));
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

// The replay's forward products (one lane a team) in team8's sum order
// (t3_chunks): thread (g, j) walks the tiles in order, summing the rows of
// chunk g in each for every product of column j, stores its chunk sums,
// and after a block barrier the owner of column j adds the G chunks' sums
// of each product in chunk order, rounds each to float32 and adds them in
// matmul_split's order (three terms: x_hi W_lo, x_mid W_mid, x_lo W_hi,
// x_hi W_mid, x_mid W_hi, x_hi W_hi; two: x_hi W_hi, x_hi W_mid,
// x_mid W_hi) -> recs[j]. A warp's threads take consecutive columns of one
// row: consecutive words of the slice, the rates' row a broadcast. kF32:
// the slice holds the float32 wT, split as it is read.
template <int NT, bool kStream, bool kF32>
__device__ __forceinline__ void t3_fwd_chunks(Team3& T, int P, const uint32_t* __restrict__ X) {
  constexpr int NP = NT == 3 ? 6 : 3;
  const Plan3& p = T.p;
  const int G = t3_chunks(P), kc = (P + G - 1) / G;
  const int nc = p.nc, rw = p.rw, xs = p.xs, R = p.R, NTl = p.T;
  const int o = threadIdx.x, j = o % nc, g = o / nc;
  const bool act = g < G;
  const int c0 = g * kc, c1 = min(P, c0 + kc);
  double acc[NP];
#pragma unroll
  for (int r = 0; r < NP; ++r) acc[r] = 0.0;
  for (int m = 0; m < NTl; ++m) {
    const int gg = T.used + m;
    const uint32_t* tile = t2_acquire<kStream>(T, gg, P);
    const int tk0 = m * R, k0 = max(tk0, c0), k1 = min(min(P, tk0 + R), c1);
    if (act) {
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        double wh, wm, wl = 0.0;
        if constexpr (kF32) {
          t3_split_w(tile[(size_t)(k - tk0) * rw + j], wh, wm, wl);
        } else {
          const uint16_t* row =
              reinterpret_cast<const uint16_t*>(tile + (size_t)(k - tk0) * rw) + j;
          wh = t3_w(row[0]);
          wm = t3_w(row[nc]);
          if constexpr (NT == 3) wl = t3_w(row[2 * nc]);
        }
        if constexpr (NT == 3) {
          const uint4 u = *reinterpret_cast<const uint4*>(X + (size_t)k * xs);
          const double a = t3_x(u.x), c = t3_x(u.y), d = t3_x(u.z);
          acc[0] = fma(a, wl, acc[0]);
          acc[1] = fma(c, wm, acc[1]);
          acc[2] = fma(d, wh, acc[2]);
          acc[3] = fma(a, wm, acc[3]);
          acc[4] = fma(c, wh, acc[4]);
          acc[5] = fma(a, wh, acc[5]);
        } else {
          const uint2 u = *reinterpret_cast<const uint2*>(X + (size_t)k * xs);
          const double a = t3_x(u.x), c = t3_x(u.y);
          acc[0] = fma(a, wh, acc[0]);
          acc[1] = fma(a, wm, acc[1]);
          acc[2] = fma(c, wh, acc[2]);
        }
      }
    }
    t2_release<kStream>(T, gg);
  }
  if (kStream) T.used += NTl;
  double* const part = T.cvec;  // (G, NP, nc)
  if (act) {
#pragma unroll
    for (int r = 0; r < NP; ++r) part[((size_t)g * NP + r) * nc + j] = acc[r];
  }
  __syncthreads();
  if (o < nc) {
    float rec = 0.0f;
#pragma unroll
    for (int r = 0; r < NP; ++r) {
      double q = part[(size_t)r * nc + o];
      for (int gc = 1; gc < G; ++gc) q += part[((size_t)gc * NP + r) * nc + o];
      rec = r == 0 ? (float)q : rec + (float)q;
    }
    T.recs[o] = rec;
  }
}

// A VJP's products (one lane a team): for every row k, the sums over this
// block's columns j of cvec[j] W_t[k, j] for each term t (Lv lanes per row,
// lane l summing the columns j = l mod Lv in order, then a butterfly),
// stored into slot (t, rank, k mod nc) of the exchange slot of k's owner.
// kF32: the slice holds the float32 wT, each weight split as it is read.
template <int NT, bool kStream, bool kF32 = false>
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
        if constexpr (kF32) {
          const uint32_t* row = tile + (size_t)r * rw;
#pragma unroll 2
          for (int j = l; j < nc; j += Lv) {
            const double c = cv[j];
            double wh, wm, wl;
            t3_split_w(row[j], wh, wm, wl);
            d[0] = fma(c, wh, d[0]);
            d[1] = fma(c, wm, d[1]);
            d[2] = fma(c, wl, d[2]);
          }
        } else {
          const uint16_t* row = reinterpret_cast<const uint16_t*>(tile + (size_t)r * rw);
#pragma unroll 2
          for (int j = l; j < nc; j += Lv) {
            const double c = cv[j];
            d[0] = fma(c, t3_w(row[j]), d[0]);
            d[1] = fma(c, t3_w(row[nc + j]), d[1]);
            if constexpr (NT == 3) d[2] = fma(c, t3_w(row[2 * nc + j]), d[2]);
          }
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

struct T3NoOp {
  __device__ __forceinline__ void operator()() const {}
};

template <int NT, int LT, bool kStream>
__device__ __forceinline__ void t3k_fwd_chunks(Team3& T, int P, const uint32_t* __restrict__ X);

// One drift evaluation of the team's lanes at time t: the owned items'
// states s -> out (owner threads); every thread of the block calls it.
// kChunks 1: the replay's products in team8's order (t3_fwd_chunks; one
// lane), kF32 its slice the float32 wT; 2: the same order for the NB lanes
// of the kernel-mode sweep, LB a thread (t3k_fwd_chunks).
// after_barrier() runs in every thread right after the exchange's cluster
// barrier (the replay stores its previous step's rows there).
template <int NT, int LB, int IPT, bool kStream, bool kF32 = false, int kChunks = 0,
          class Mid = T3NoOp>
__device__ __forceinline__ void t3_drift(const Net& n, Team3& T, float t, const float (&s)[IPT][3],
                                         float (&out)[IPT][3], Mid after_barrier = Mid()) {
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
  after_barrier();
  if constexpr (kChunks == 2)
    t3k_fwd_chunks<NT, LB, kStream>(T, n.P, X);
  else if constexpr (kChunks == 1)
    t3_fwd_chunks<NT, kStream, kF32>(T, n.P, X);
  else
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
// kF32: the slice holds the float32 wT (t3_vjp_products).
template <int NT, bool kStream, bool kF32 = false>
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
  t3_vjp_products<NT, kStream, kF32>(T, n.P);
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
  team3_init(T, smt, n, n.B, 3, kT3Select, 0, wpk, iw, kStream);
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
  team3_init(T, smt, n, n.B, 3, kT3Select, 0, wpk, iw, kStream);
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
// B7t-team / B7 split2: the replay over the frozen grid, one team per lane
// ---------------------------------------------------------------------------

// Lane blockIdx.x / C over steps 0..n-1: per step k, from the step-start
// state y at t0 = st[k] with h = st[k+1] - t0, the stages k0 = f(t0, y)
// and k_i = f(t0 + c_i h, Y_i), Y_i = y + sum_j (h a_ij) k_j (Y_6 = y1),
// then ys[k] = y and the five dense rows
//   r1 = y, r2 = dy = y1 - y, r3 = h k0 - dy, r4 = (dy - h k6) - r3,
//   r5 = sum_j (h d_j) k_j
// (network_ode.cu ode_replay_fwd_kernel, operation for operation), y = y1.
// The owners keep y and the seven stage derivatives in registers and write
// a step's six rows after the next step's first cluster barrier (the last
// step's at the end). NT = 3: B7t-team; NT = 2: B7 split2. kF32: the
// slice holds the float32 wT (Plan3 f32).
template <int NT, bool kStream, bool kF32>
__global__ void __launch_bounds__(kThreads, 1)
ode_replay16_kernel(Net n, int C, int n_steps, const uint32_t* __restrict__ wpk,
                    const float* __restrict__ iw, const float* __restrict__ st,
                    const float* __restrict__ y0, float* __restrict__ ys,
                    float* __restrict__ coeffs) {
  extern __shared__ __align__(16) unsigned char smt[];
  Team3 T;
  const int b = blockIdx.x / C;
  team3_init(T, smt, n, 1, NT, kT3Replay, b, wpk, iw, kStream, C);
  const int P = n.P;
  const size_t N = (size_t)n.B * 3 * P;  // a (B, 3P) row of ys or coeffs
  const bool own = threadIdx.x < T.p.nc;
  const size_t col = (size_t)b * 3 * P + T.c0 + threadIdx.x;
  float y[1][3], Y[1][3], f[1][3], kk[3][kStages];
  float rows[5][3];  // the step's dense rows, written after the next barrier
  int done = -1;     // the step whose rows are pending
#pragma unroll
  for (int c = 0; c < 3; ++c) y[0][c] = own ? y0[col + c * P] : 0.0f;
  float ta = n_steps > 0 ? st[0] : 0.0f, tb = n_steps > 0 ? st[1] : 0.0f;
  auto store = [&]() {
    if (own && done >= 0) {
      float* yk = ys + (size_t)done * N + col;
      float* ck = coeffs + (size_t)done * 5 * N + col;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        yk[c * P] = rows[0][c];
#pragma unroll
        for (int r = 0; r < 5; ++r) ck[r * N + c * P] = rows[r][c];
      }
    }
  };
  for (int k = 0; k < n_steps; ++k) {
    const float t0 = ta, h = tb - t0;
    const float tc = k + 2 <= n_steps ? st[k + 2] : 0.0f;  // the next step's end, early
    t3_drift<NT, 1, 1, kStream, kF32, true>(n, T, t0, y, f, store);
#pragma unroll
    for (int c = 0; c < 3; ++c) kk[c][0] = f[0][c];
#pragma unroll
    for (int i = 1; i < kStages; ++i) {
#pragma unroll
      for (int c = 0; c < 3; ++c) Y[0][c] = stage(i, h, y[0][c], kk[c]);
      t3_drift<NT, 1, 1, kStream, kF32, true>(n, T, t0 + kC[i] * h, Y, f);
#pragma unroll
      for (int c = 0; c < 3; ++c) kk[c][i] = f[0][c];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {  // Y holds y1 = Y_6
      const float dy = Y[0][c] - y[0][c];
      const float r3 = h * kk[c][0] - dy;
      rows[0][c] = y[0][c];
      rows[1][c] = dy;
      rows[2][c] = r3;
      rows[3][c] = (dy - h * kk[c][kStages - 1]) - r3;
      rows[4][c] = weighted(kD, h, kk[c]);
      y[0][c] = Y[0][c];
    }
    done = k;
    ta = tb;
    tb = tc;
  }
  store();
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
  team3_init(T, smt, n, 1, NT, kT3Sweep, b, wpk, iw, kStream);
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

// ---------------------------------------------------------------------------
// B8 / B8t-team: the kernel-mode sweep, one team for the batch
// ---------------------------------------------------------------------------

// The kernel-mode sweep's exchange slot in use: the rates (forward: X words;
// VJP: (P, NB) uint2 of the NT terms' bf16 bits), then the float64 region
// (the VJP's (C, nc, NB, NT) partials, or the forward's (G, NP, NB, nc)
// chunk sums): t3k_part.
__device__ __forceinline__ double* t3k_part(const Team3& T) {
  return reinterpret_cast<double*>(t3_slot(T) + t3k_xbytes(T.p));
}

// The forward products of the NB lanes in the replay's sum order
// (t3_fwd_chunks, for every lane): thread o = j + nc (g + G lg) sums chunk g
// of column j for the lanes [LT lg, LT lg + LT) of the batch, reading each
// weight once for its LT lanes and the lanes' rate words as LT NT words of
// lane group lg (t3_drift's X layout with LB = LT); its chunk sums go to the
// slot's float64 region, and after a block barrier the owner of (lane b,
// column j) adds the G chunks' sums of each product in chunk order, rounds
// each to float32 and adds them in matmul_split's order -> recs[b nc + j].
template <int NT, int LT, bool kStream>
__device__ __forceinline__ void t3k_fwd_chunks(Team3& T, int P, const uint32_t* __restrict__ X) {
  constexpr int NP = NT == 3 ? 6 : 3;
  constexpr int GW = (LT * NT + 1) / 2 * 2;
  const Plan3& p = T.p;
  const int G = t3_chunks(P), kc = (P + G - 1) / G;
  const int nc = p.nc, rw = p.rw, xs = p.xs, R = p.R, NTl = p.T, NB = p.NB;
  const int o = threadIdx.x, j = o % nc, g = (o / nc) % G, lg = o / (nc * G);
  const int b0 = lg * LT;
  const bool act = b0 < NB;
  const int c0 = g * kc, c1 = min(P, c0 + kc);
  double acc[LT][NP];
#pragma unroll
  for (int q = 0; q < LT; ++q) {
#pragma unroll
    for (int r = 0; r < NP; ++r) acc[q][r] = 0.0;
  }
  const uint32_t* xg = X + lg * GW;
  for (int m = 0; m < NTl; ++m) {
    const int gg = T.used + m;
    const uint32_t* tile = t2_acquire<kStream>(T, gg, P);
    const int tk0 = m * R, k0 = max(tk0, c0), k1 = min(min(P, tk0 + R), c1);
    if (act) {
#pragma unroll 2
      for (int k = k0; k < k1; ++k) {
        const uint16_t* row = reinterpret_cast<const uint16_t*>(tile + (size_t)(k - tk0) * rw) + j;
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
        for (int q = 0; q < LT; ++q) {
          if (LT == 1 || b0 + q < NB) {
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
    }
    t2_release<kStream>(T, gg);
  }
  if (kStream) T.used += NTl;
  double* const part = t3k_part(T);  // (G, NP, NB, nc)
  if (act) {
#pragma unroll
    for (int q = 0; q < LT; ++q) {
      if (LT == 1 || b0 + q < NB) {
#pragma unroll
        for (int r = 0; r < NP; ++r) part[(((size_t)g * NP + r) * NB + b0 + q) * nc + j] = acc[q][r];
      }
    }
  }
  __syncthreads();
  if (o < NB * nc) {
    float rec = 0.0f;
#pragma unroll
    for (int r = 0; r < NP; ++r) {
      double s = part[(size_t)r * NB * nc + o];
#pragma unroll
      for (int gc = 1; gc < 8; ++gc) {  // t3_chunks gives at most 8
        if (gc < G) s += part[((size_t)gc * NP + r) * NB * nc + o];
      }
      rec = r == 0 ? (float)s : rec + (float)s;
    }
    T.recs[o] = rec;
  }
}

// The VJP products of the NB lanes: for every row k and lane b, the sums
// over this block's columns j of cv[b][j] W_t[k, j] (cv: the cotangents
// times 2^896) for each term t (Lv threads a row, thread l summing the
// columns j = l mod Lv in order, then a butterfly), four lanes at a time,
// stored as (rank, k mod nc, b, t) into the float64 region of the
// exchange slot of k's owner.
template <int NT, bool kStream>
__device__ __forceinline__ void t3k_vjp_products(Team3& T, int P, const double* cv) {
  constexpr int KL = 4;
  const Plan3& p = T.p;
  cgo::cluster_group cl = cgo::this_cluster();
  const int nc = p.nc, Lv = p.Lv, rw = p.rw, R = p.R, NTl = p.T, rank = T.rank, NB = p.NB;
  const int RR = kThreads / Lv, rr = threadIdx.x / Lv, l = threadIdx.x - rr * Lv;
  double* const part = t3k_part(T);
  for (int m = 0; m < NTl; ++m) {
    const int g = T.used + m;
    const uint32_t* tile = t2_acquire<kStream>(T, g, P);
    const int k0 = m * R, rows = min(R, P - k0);
    for (int r0 = 0; r0 < rows; r0 += RR) {
      const int r = r0 + rr;
      const bool ok = r < rows;
      const uint16_t* row = reinterpret_cast<const uint16_t*>(tile + (size_t)(ok ? r : 0) * rw);
      for (int bb = 0; bb < NB; bb += KL) {
        double d[KL][NT];
#pragma unroll
        for (int q = 0; q < KL; ++q) {
#pragma unroll
          for (int t = 0; t < NT; ++t) d[q][t] = 0.0;
        }
        if (ok) {
#pragma unroll 2
          for (int j = l; j < nc; j += Lv) {
            double w[NT];
#pragma unroll
            for (int t = 0; t < NT; ++t) w[t] = t3_w(row[t * nc + j]);
#pragma unroll
            for (int q = 0; q < KL; ++q) {
              if (bb + q < NB) {
                const double c = cv[(bb + q) * nc + j];
#pragma unroll
                for (int t = 0; t < NT; ++t) d[q][t] = fma(c, w[t], d[q][t]);
              }
            }
          }
        }
        for (int off = Lv / 2; off > 0; off >>= 1) {
#pragma unroll
          for (int q = 0; q < KL; ++q) {
#pragma unroll
            for (int t = 0; t < NT; ++t) d[q][t] += __shfl_xor_sync(0xffffffffu, d[q][t], off);
          }
        }
        if (ok && l == 0) {
          const int k = k0 + r, owner = k / nc;
          double* dst = cl.map_shared_rank(part, owner) +
                        (((size_t)rank * nc + (k - owner * nc)) * NB + bb) * NT;
          if (NB % 2 == 0) {  // an even count of doubles from an even offset
            double2* d2 = reinterpret_cast<double2*>(dst);
#pragma unroll
            for (int v = 0; v < KL * NT / 2; ++v) {
              if (2 * v < (NB - bb) * NT)
                d2[v] = make_double2(d[(2 * v) / NT][(2 * v) % NT],
                                     d[(2 * v + 1) / NT][(2 * v + 1) % NT]);
            }
          } else {
#pragma unroll
            for (int q = 0; q < KL; ++q) {
              if (bb + q < NB) {
#pragma unroll
                for (int t = 0; t < NT; ++t) dst[q * NT + t] = d[q][t];
              }
            }
          }
        }
      }
    }
    t2_release<kStream>(T, g);
  }
  if (kStream) T.used += NTl;
}

// A block's share of the kernel-mode sweep's weight cotangents: the entries
// (i, j) of its own columns j = c0 .. c0 + nc - 1, every row i, at q = (j -
// c0) P + i; thread x takes the rows i = x mod R (mod R) and in each the
// columns j - c0 = x / R (mod Lw), Lw = max(1, kThreads / P) threads a row,
// R = kThreads / Lw (t3k_entries), in every pass that touches them:
// consecutive threads touch consecutive words.
// Call f(i, j0, Lw) for the rows i of this thread's weight-cotangent
// entries (KAcc): its columns are j0, j0 + Lw, ... below nc.
template <class F>
__device__ __forceinline__ void t3k_entries(int P, int nc, F&& f) {
  const int Lw = kThreads / P > 1 ? kThreads / P : 1, R = kThreads / Lw;
  const int j0 = threadIdx.x / R;
  if (j0 >= nc || j0 >= Lw) return;
  for (int i = threadIdx.x - j0 * R; i < P; i += R) f(i, j0, Lw);
}

struct KAcc {
  float* acc;   // (NT, nc, P) the step's bf16 accumulators (hi, mid[, lo])
  float* dw;    // (nc, P) d wT of the own columns, the float32 sum over the steps so far
  float* cown;  // (2, NB, nc) the current's cotangent of the own populations
  float* aiw;   // (n_in, nc) the step's d iwT sum of the own columns
  float* dwi;   // (n_in, nc) d iwT of the own columns over the steps so far
};

// Carve KAcc past t3_fixed: in shared memory, or with the plan's accs 0 the
// accumulators and d wT in this block's (NT + 1) P nc floats of work.
__device__ __forceinline__ KAcc t3k_carve(const Team3& T, unsigned char* sm, const Net& n,
                                          float* work) {
  const Plan3& p = T.p;
  const size_t Pnc = (size_t)n.P * p.nc;
  unsigned char* q = sm + t3_fixed(p, n.n_in, p.slots, kT3KSweep);
  KAcc A;
  A.cown = reinterpret_cast<float*>(q);
  q += t2_align(4 * 2 * (size_t)p.NB * p.nc);
  A.aiw = reinterpret_cast<float*>(q);
  A.dwi = A.aiw + (size_t)n.n_in * p.nc;
  q += t2_align(4 * 2 * (size_t)n.n_in * p.nc);
  A.acc = p.accs ? reinterpret_cast<float*>(q) : work + (size_t)T.rank * (p.NT + 1) * Pnc;
  A.dw = A.acc + (size_t)p.NT * Pnc;
  return A;
}

// One drift VJP of the team's NB lanes (one item a thread) at the own
// states y for the output cotangents ct -> out (owner threads), with
// jax.vjp's rounding points (t3_vjp), and its weight cotangents added to
// the step's accumulators (``first``: stage 6's VJP, which opens them). The
// owners put their rates' NT bf16 terms (as bits) into every block beside
// the VJP products' partials: one cluster barrier. Then the owners add the
// C partials in rank order, and every block contracts the entries of its
// own columns over the lanes in float64, in lane order, rounds to bf16 and
// adds to its accumulators (team.cuh wx_cot, acc_add): no value crosses a
// block in a sum. A weight-cotangent product needs no conversion: the
// term's bits placed in a double (t3_w) times the cotangent held times
// 2^896 (the VJP products' own operand, double buffered as the slot is, so
// the next VJP's owners may write theirs while this pass still reads).
template <int NT, bool kStream>
__device__ __forceinline__ void t3k_vjp(const Net& n, Team3& T, const KAcc& A, float t,
                                        bool first, const float (&y)[3], const float (&ct)[3],
                                        float (&out)[3]) {
  cgo::cluster_group cl = cgo::this_cluster();
  const Plan3& p = T.p;
  const int P = n.P, nc = p.nc, C = p.C, NB = p.NB, NI = n.n_in, own = NB * nc, c0 = T.c0;
  const int e = threadIdx.x;
  uint2* const xr = reinterpret_cast<uint2*>(t3_slot(T));  // (P, NB): the rates' bf16 terms
  float* const ext = T.ext + T.par * NB * NI;
  float* const cown = A.cown + T.par * own;
  double* const cv = T.cvec + T.par * own;
  if (p.slots == 1) cl.sync();  // every block is done with the slot's last exchange
  float frp = 0.0f;
  if (e < own) {
    const int b = e / nc, i = e - b * nc;
    float fr;
    fr_and_grad(y[0] - y[1], fr, frp);
    const float cc = ((ct[0] / n.tau_m) * n.R) * n.tau_s;
    cv[e] = (double)cc * kT3Scale;
    cown[e] = cc;
    const bf16 bh = __float2bfloat16_rn(fr);
    const float r = fr - __bfloat162float(bh);
    const bf16 bm = __float2bfloat16_rn(r);
    uint32_t lo = 0u;
    if constexpr (NT == 3) lo = __bfloat16_as_ushort(__float2bfloat16_rn(r - __bfloat162float(bm)));
    xr[(size_t)(c0 + i) * NB + b] =
        make_uint2((uint32_t)__bfloat16_as_ushort(bh) | ((uint32_t)__bfloat16_as_ushort(bm) << 16),
                   lo);
  }
  for (int idx = threadIdx.x; idx < NB * NI; idx += blockDim.x) {
    const int bb = idx / NI, m = idx - bb * NI;
    ext[idx] = t3_knot(n, T, bb, m, t);
  }
  __syncthreads();
  {  // the own rows of the rates' terms to every other block, 8 bytes a store
    const int nv = nc * NB;
    const uint2* src = xr + (size_t)c0 * NB;
    for (int idx = threadIdx.x; idx < C * nv; idx += blockDim.x) {
      const int r = idx / nv, v = idx - r * nv;
      if (r != T.rank) cl.map_shared_rank(const_cast<uint2*>(src), r)[v] = src[v];
    }
  }
  t3k_vjp_products<NT, kStream>(T, P, cv);
  cl.sync();
  if (e < own) {
    const int b = e / nc, i = e - b * nc;
    const double* part = t3k_part(T);
    double d[NT];
#pragma unroll
    for (int q = 0; q < NT; ++q) d[q] = 0.0;
#pragma unroll 4
    for (int r = 0; r < C; ++r) {  // each term's partials in rank order
      const double* s = part + (((size_t)r * nc + i) * NB + b) * NT;
#pragma unroll
      for (int q = 0; q < NT; ++q) d[q] += s[q];
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
    const float c_fr = (xbar + T.ad[i] * (ca / n.tau_a)) + cr / n.tau_s;
    const float c_x = frp * c_fr;
    out[0] = -(cv / n.tau_m) + c_x;
    out[1] = -(ca / n.tau_a) - c_x;
    out[2] = -(cr / n.tau_s);
  }
  // The weight cotangents of the own columns, every row.
  const size_t Pnc = (size_t)P * nc;
  t3k_entries(P, nc, [&](int i, int j0, int Lw) {
    constexpr int KL = 4;
    double xd[KL][NT];  // row i's terms of lanes 0..3, placed once for the row's columns
    if (NB <= KL) {
#pragma unroll
      for (int b = 0; b < KL; ++b) {
        const uint2 x = b < NB ? xr[(size_t)i * NB + b] : make_uint2(0u, 0u);
        xd[b][0] = t3_w(x.x & 0xffffu);
        xd[b][1] = t3_w(x.x >> 16);
        if constexpr (NT == 3) xd[b][2] = t3_w(x.y);
      }
    }
#pragma unroll 2
    for (int j = j0; j < nc; j += Lw) {
      double s[NT];
#pragma unroll
      for (int u = 0; u < NT; ++u) s[u] = 0.0;
      if (NB <= KL) {  // each product exact: x 2^-896 times c 2^896, in lane order
#pragma unroll
        for (int b = 0; b < KL; ++b) {
          if (b < NB) {
            const double c = cv[b * nc + j];
#pragma unroll
            for (int u = 0; u < NT; ++u) s[u] = fma(xd[b][u], c, s[u]);
          }
        }
      } else {
        for (int b = 0; b < NB; ++b) {
          const uint2 x = xr[(size_t)i * NB + b];
          const double c = cv[b * nc + j];
          s[0] = fma(t3_w(x.x & 0xffffu), c, s[0]);
          s[1] = fma(t3_w(x.x >> 16), c, s[1]);
          if constexpr (NT == 3) s[2] = fma(t3_w(x.y), c, s[2]);
        }
      }
      const size_t q = (size_t)j * P + i;
      float d[NT], a[NT];
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        d[u] = bf16r((float)s[u]);
        a[u] = first ? 0.0f : A.acc[u * Pnc + q];
      }
      acc_add<NT>(a, d, first);
#pragma unroll
      for (int u = 0; u < NT; ++u) A.acc[u * Pnc + q] = a[u];
    }
  });
  for (int q = threadIdx.x; q < NI * nc; q += kThreads) {
    const int m = q / nc, j = q - m * nc;
    double s = 0.0;
    for (int b = 0; b < NB; ++b) s += (double)ext[b * NI + m] * (double)cown[b * nc + j];
    A.aiw[q] = first ? (float)s : A.aiw[q] + (float)s;
  }
  T.par ^= 1;
}

// B8 / B8t-team: the kernel-mode reverse sweep over steps n-1..0 of the
// batch (n.B lanes) on one team. Per step k it rebuilds the stage states
// Y0..Y6 from ys[k] (drifts k0..k5 in the replay's sum order, t3k_fwd_chunks:
// the stage states B7, B7t-team and team8 form), then
//   r3bar = c3 - c4;  dybar = (c2 + c4) - r3bar;  y1bar = ybar + dybar
//   kbar_j = (h d_j) c5;  kbar_6 -= h c4;  kbar_0 += h r3bar
//   kbar_j += (h b_j) y1bar;  ysum = (c1 - dybar) + y1bar
//   for s = 6..0:  g = f^T|_{Y_s} kbar_s;  ysum += g;  kbar_j += (h a_sj) g
// and ybar = ysum (network_ode.cu ode_replay_bwd_kernel, operation for
// operation); each VJP's weight cotangents add into the step's NT bf16
// accumulators of the block's own columns (t3k_vjp), folded once a step
// through the split into d wT, the d iwT sums added, both written once at
// the end. plan: the host's plan3k (a kernel parameter, so the compiler
// reads its fields from the constant bank instead of holding them in
// registers). work: with the plan's accs 0, (C, NT + 1, nc, P) floats. NT = 3:
// the f32-exact engine (prepare_premixed_split); LT: the forward products'
// lanes a thread (the plan's LB, 1 or 4).
template <int NT, int LT, bool kStream>
__global__ void __launch_bounds__(kThreads, 1)
ode_ksweep16_kernel(Net n, const Plan3 plan, int n_steps, const uint32_t* __restrict__ wpk,
                    const float* __restrict__ iw, const float* __restrict__ st,
                    const float* __restrict__ ys, const float* __restrict__ cobar,
                    float* __restrict__ ybar_out, float* __restrict__ d_wT,
                    float* __restrict__ d_iwT, float* work) {
  extern __shared__ __align__(16) unsigned char smt[];
  Team3 T;
  team3_init_plan(T, smt, n, n.B, kT3KSweep, 0, wpk, iw, plan);
  const KAcc A = t3k_carve(T, smt, n, work);
  const int P = n.P, S = 3 * P, nc = T.p.nc, NI = n.n_in, c0 = T.c0;
  const size_t N = (size_t)n.B * S, Pnc = (size_t)P * nc;
  const int e = threadIdx.x;
  const bool own = e < n.B * nc;
  const int b = own ? e / nc : 0;
  const size_t col = (size_t)b * S + c0 + (e - b * nc);
  t3k_entries(P, nc, [&](int i, int j0, int Lw) {
    for (int j = j0; j < nc; j += Lw) A.dw[(size_t)j * P + i] = 0.0f;
  });
  for (int q = threadIdx.x; q < NI * nc; q += kThreads) A.dwi[q] = 0.0f;
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
    if (own && k >= 1) {  // the next step's state, one step ahead
#pragma unroll
      for (int c = 0; c < 3; ++c) yn[c] = ys[(size_t)(k - 1) * N + col + c * P];
    }
    t3_drift<NT, LT, 1, kStream, false, 2>(n, T, t0, Y[0], f);
#pragma unroll
    for (int c = 0; c < 3; ++c) kk[c][0] = f[0][c];
#pragma unroll
    for (int i = 1; i < kStages; ++i) {
#pragma unroll
      for (int c = 0; c < 3; ++c) Y[i][0][c] = stage(i, h, Y[0][0][c], kk[c]);
      if (i < kStages - 1) {
        t3_drift<NT, LT, 1, kStream, false, 2>(n, T, t0 + kC[i] * h, Y[i], f);
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
      t3k_vjp<NT, kStream>(n, T, A, s ? t0 + kC[s] * h : t0, s == kStages - 1, Y[s][0], ct, g);
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
    // The step's accumulators through the split once, into the own columns'
    // sums (each entry by the thread that formed it).
    t3k_entries(P, nc, [&](int i, int j0, int Lw) {
      for (int j = j0; j < nc; j += Lw) {
        const size_t q = (size_t)j * P + i;
        float a[NT];
#pragma unroll
        for (int u = 0; u < NT; ++u) a[u] = A.acc[u * Pnc + q];
        A.dw[q] = A.dw[q] + acc_fold<NT>(a);
      }
    });
    for (int q = threadIdx.x; q < NI * nc; q += kThreads) A.dwi[q] = A.dwi[q] + A.aiw[q];
  }
  if (own) {
#pragma unroll
    for (int c = 0; c < 3; ++c) ybar_out[col + c * P] = ysum[c];
  }
  t3k_entries(P, nc, [&](int i, int j0, int Lw) {
    for (int j = j0; j < nc; j += Lw) d_wT[(size_t)i * P + c0 + j] = A.dw[(size_t)j * P + i];
  });
  for (int q = threadIdx.x; q < NI * nc; q += kThreads) {
    const int m = q / nc;
    d_iwT[(size_t)m * P + c0 + (q - m * nc)] = A.dwi[q];
  }
  if (kStream) t2_drain(T);
}

}  // namespace
