// The split2 replay (B3) and its emit-mode reverse sweep (B4) as Hopper
// thread-block-cluster teams, one team per lane: network_sde.cu's
// cf_sde_replay_fwd and cf_sde_replay_bwd. Included once per source; every
// source is its own library, so the definitions live in an unnamed
// namespace.
//
// Replaces (columnflow/solvers/fused.py), on the two-term split of
// prepare_premixed_split2 and each lane's own step grid:
//   sde2_fwd_kernel <- _make_sde_chunk_kernel, variable_h="lanes" (B3)
//   sde2_bwd_kernel <- _make_sde_bwd_chunk_kernel, emit_steps, lanes (B4)
//
// What bounds them on this card: a serial chain of ~2 * 10^4 half steps per
// lane, each two drift evaluations (B3) or a drift and two drift VJPs (B4),
// every one a (P,) x (P, P) product on each of the split's terms. The work
// of a step is a few MFLOP; what costs is each step's latency. One thread
// block per lane (the first design) walked all P rows of the weights from
// L2 in every product: ~170 cycles of L2 latency a row, and 4 M float64
// operations a drift on one SM.
//
// This design spreads one lane over a cluster of C blocks (16 where 16
// divides P, else 8; 16 is a non-portable cluster size, launched with
// cudaLaunchKernelEx). Block r owns the populations [r nc, (r+1) nc), nc =
// P / C, and keeps the columns [r nc, (r+1) nc) of both terms of wT in its
// shared memory, packed by the wrapper into one contiguous (P, rw) slice of
// 32-bit words per block (hi: nw words, mid: nw words, one pad word; rw
// odd, so threads on neighbouring rows hit different banks). The slice is
// copied from device memory by TMA bulk copies (cp.async.bulk, completion
// on an mbarrier): once, where it fits beside the exchange buffers (every
// width through 79 columns, even ones through 110: 176 KB of the block's
// 206 KB at 104), else streamed in tiles of R rows
// through a ring of S stages, refilled by thread 0 one tile behind the
// consumers (full and empty mbarriers per stage), the tile sequence running
// on across product passes so that the next pass's first tiles load while
// the team synchronises (tma_ring.cuh, shared with ode_team.cuh).
//   The state of a population lives in the registers of the thread that
// owns it (thread i of block r: population r nc + i), so every elementwise
// operation of a step is thread-private. A drift evaluation: each owner
// computes its rate, splits it (x_hi = bf16(fr), x_mid = bf16(fr - x_hi))
// and stores the pair as float64 into every block of the cluster
// (distributed shared memory), one cluster barrier, then each block forms
// the three products of its own columns over all P rows: L lanes per
// column pair, each summing every L-th row in order, then a butterfly of
// shuffles over the L lanes. A VJP needs no exchange before its products:
// with the slice of columns it holds, block r forms for EVERY row k the
// partial sums over its own columns of the current's cotangent against the
// transposed terms (Lv lanes per row, a butterfly), stores them into the
// block that owns k, one cluster barrier, and each owner adds the C
// partials in rank order. So B4 reads the same slice as B3, and no
// transposed copy of the weights is made. The exchange buffers are double
// buffered (team.cuh's argument): one cluster barrier per exchange.
//   Every product term is a bf16 times a bf16 or a float32, exact in
// float64, and every sum is float64 (explicit fma), rounded to float32
// once; the float32 elementwise code rounds as the plain version's
// (-fmad=false). A float64 sum in another order than the plain version's
// (cuBLAS's) rounds to the same float32 bits apart from rare ties, as the
// one-block kernel's serial order did.

#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "network_drift.cuh"
#include "sde_select.cuh"
#include "tma_ring.cuh"

namespace {

namespace cgt = cooperative_groups;

// A team's shape at P populations and n_in inputs, computed alike on the
// host (launch, shared-memory bytes) and in the kernel (carving, thread
// mappings); kernels/network_sde.py sde2_replay_plan repeats it.
struct Plan2 {
  int C;        // blocks per lane (the cluster size)
  int nc;       // populations a block owns
  int nw;       // 32-bit words of one term's row in a block's slice (nc bf16, padded to even)
  int rw;       // words of one packed row: hi (nw), mid (nw), one pad word
  int L;        // forward products: lanes per column pair
  int Lv;       // VJP products: lanes per row
  int stream;   // 0: the slice is resident in shared memory; 1: streamed in tiles
  int R, T, S;  // rows per tile, tiles per product pass, stages (resident: P, 1, 1)
  size_t fixed, bytes;  // bytes before the weights; all of a block's shared memory
};

__host__ __device__ inline Plan2 plan2(int P, int n_in, int want_stream) {
  Plan2 p;
  p.C = P % 16 == 0 ? 16 : 8;
  p.nc = P / p.C;
  p.nw = (p.nc + 1) / 2;
  p.rw = 2 * p.nw + 1;
  p.L = 32;
  while (p.L > 1 && p.nw * p.L > kThreads) p.L /= 2;
  p.Lv = 1;
  while (p.Lv < 32 && 16 * p.Lv < p.nw) p.Lv *= 2;
  while (p.Lv < 32 && p.Lv < p.nw && P * p.Lv < kThreads) p.Lv *= 2;
  p.fixed = t2_align(2 * 2 * sizeof(double) * (size_t)P)   // two exchange slots
            + t2_align(3 * sizeof(double) * (size_t)p.nc)  // the own columns' product sums
            + t2_align(2 * sizeof(double) * (size_t)p.nw)  // the VJP's own cotangents
            + t2_align(2 * sizeof(float) * (size_t)n_in)   // the stimulus, double buffered
            + t2_align(sizeof(float) * (size_t)kMaxKnots * n_in)     // the lane's knot values
            + t2_align(sizeof(float) * (size_t)(n_in + 2) * p.nc)   // own iwT columns, bg, adapt
            + t2_align(sizeof(uint64_t) * (1 + 2 * kT2MaxStages));
  const size_t row = 4 * (size_t)p.rw;
  if (!want_stream && p.fixed + row * P <= kT2SmemLimit) {
    p.stream = 0;
    p.R = P;
    p.T = 1;
    p.S = 1;
    p.bytes = p.fixed + row * P;
    return p;
  }
  p.stream = 1;
  const int rr = kThreads / p.Lv;
  p.R = kT2MinTileRows;
  if (p.L > p.R) p.R = p.L;
  if (rr > p.R) p.R = rr;
  p.T = (P + p.R - 1) / p.R;
  const size_t room = p.fixed < kT2SmemLimit ? kT2SmemLimit - p.fixed : 0;
  size_t s = room / (row * p.R);
  if (s > (size_t)kT2MaxStages) s = kT2MaxStages;
  if (s > (size_t)p.T) s = p.T;
  p.S = (int)s;
  p.bytes = p.fixed + row * p.R * p.S;
  return p;
}

// The two bf16 of a packed word as float64 (exact).
__device__ __forceinline__ double t2_lo(uint32_t w) { return (double)__uint_as_float(w << 16); }
__device__ __forceinline__ double t2_hi(uint32_t w) {
  return (double)__uint_as_float(w & 0xffff0000u);
}

// ---------------------------------------------------------------------------
// One block's share of a team
// ---------------------------------------------------------------------------

struct Team2 {
  Plan2 p;
  int rank, c0;         // this block owns populations [c0, c0 + nc)
  int par;              // exchange slot in use
  double2* ex[2];       // exchange slots: (P) rate terms, or (C, nc) VJP partials by source
  double* sums;         // (nc, 3) the own columns' forward product sums
  double* cvec;         // (2 nw) the VJP's cotangent of the own populations (padding 0)
  float* ext;           // (2, n_in) the stimulus
  float* kvs;           // (K, n_in) the lane's knot values
  float* iwc;           // (n_in, nc) the own columns of iwT
  float *bg, *ad;       // (nc) the own populations' background current and adaptation
  uint64_t* mbar;       // [0] resident load, [1 + s] stage s full, [1 + kT2MaxStages + s] empty
  uint32_t* w;          // the resident slice, or stage 0 of the ring
  const uint32_t* src;  // this block's packed slice in device memory
  int used, limit;      // streamed tiles consumed so far; tiles the kernel consumes in all
};

// Carve the shared memory, copy what the drift reads of this block's
// populations and of its lane's stimulus, start the weights' copies, and
// make sure every block of the cluster has started before any writes into
// another's shared memory. passes: the product passes the kernel runs in all.
__device__ void team2_init(Team2& T, unsigned char* sm, const Net& n, const uint32_t* wpk,
                           const float* __restrict__ iw, int passes, int stream) {
  const int P = n.P;
  T.p = plan2(P, n.n_in, stream);
  T.rank = (int)cgt::this_cluster().block_rank();
  T.c0 = T.rank * T.p.nc;
  T.par = 0;
  unsigned char* q = sm;
  T.ex[0] = reinterpret_cast<double2*>(q);
  T.ex[1] = T.ex[0] + P;
  q += t2_align(2 * 2 * sizeof(double) * (size_t)P);
  T.sums = reinterpret_cast<double*>(q);
  q += t2_align(3 * sizeof(double) * (size_t)T.p.nc);
  T.cvec = reinterpret_cast<double*>(q);
  q += t2_align(2 * sizeof(double) * (size_t)T.p.nw);
  T.ext = reinterpret_cast<float*>(q);
  q += t2_align(2 * sizeof(float) * (size_t)n.n_in);
  T.kvs = reinterpret_cast<float*>(q);
  q += t2_align(sizeof(float) * (size_t)kMaxKnots * n.n_in);
  T.iwc = reinterpret_cast<float*>(q);
  T.bg = T.iwc + (size_t)n.n_in * T.p.nc;
  T.ad = T.bg + T.p.nc;
  q += t2_align(sizeof(float) * (size_t)(n.n_in + 2) * T.p.nc);
  T.mbar = reinterpret_cast<uint64_t*>(q);
  T.w = reinterpret_cast<uint32_t*>(sm + T.p.fixed);
  T.src = wpk + (size_t)T.rank * P * T.p.rw;
  T.used = 0;
  T.limit = passes * T.p.T;
  for (int j = threadIdx.x; j < 2 * T.p.nw; j += blockDim.x) T.cvec[j] = 0.0;
  const int b = blockIdx.x / T.p.C;
  for (int j = threadIdx.x; j < n.K * n.n_in; j += blockDim.x) {
    const int k = j / n.n_in, m = j - k * n.n_in;
    T.kvs[j] = n.kv[((size_t)k * n.B + b) * n.n_in + m];
  }
  for (int j = threadIdx.x; j < n.n_in * T.p.nc; j += blockDim.x) {
    const int m = j / T.p.nc;
    T.iwc[j] = iw[(size_t)m * P + T.c0 + (j - m * T.p.nc)];
  }
  for (int j = threadIdx.x; j < T.p.nc; j += blockDim.x) {
    T.bg[j] = n.bg[T.c0 + j];
    T.ad[j] = n.adapt[T.c0 + j];
  }
  if (threadIdx.x == 0) {
    t2_mbar_init(T.mbar, 1);
    for (int s = 0; s < kT2MaxStages; ++s) {
      t2_mbar_init(T.mbar + 1 + s, 1);
      t2_mbar_init(T.mbar + 1 + kT2MaxStages + s, kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (!T.p.stream) {
      t2_bulk_load(T.w, T.src, (uint32_t)(4 * (size_t)P * T.p.rw), T.mbar);
    } else {
      for (int g = 0; g < T.p.S && g < T.limit; ++g) t2_fetch(T, g, P);
    }
  }
  cgt::this_cluster().sync();
  if (!T.p.stream) t2_mbar_wait(T.mbar, 0);
}

// The own columns' three product sums of a drift evaluation, with the rate
// terms X (P) of every population: sums[j] = (x_hi W_hi, x_hi W_mid,
// x_mid W_hi) at column c0 + j. Lane l of a column pair sums the rows k =
// l mod L in order; the L lanes' sums meet in a butterfly of shuffles.
template <bool kStream>
__device__ void t2_fwd_products(Team2& T, int P, const double2* X) {
  const Plan2& p = T.p;
  const int pr = threadIdx.x / p.L, l = threadIdx.x - pr * p.L;
  const bool act = pr < p.nw;
  double a0 = 0.0, a1 = 0.0, b0 = 0.0, b1 = 0.0, e0 = 0.0, e1 = 0.0;
  for (int m = 0; m < p.T; ++m) {
    const int g = T.used + m;
    const uint32_t* tile = t2_acquire<kStream>(T, g, P);
    const int k0 = m * p.R, k1 = min(P, k0 + p.R);
    if (act) {
#pragma unroll 4
      for (int k = k0 + l; k < k1; k += p.L) {
        const uint32_t* row = tile + (size_t)(k - k0) * p.rw;
        const uint32_t wh = row[pr], wm = row[p.nw + pr];
        const double2 x = X[k];
        const double h0 = t2_lo(wh), h1 = t2_hi(wh);
        a0 = fma(x.x, h0, a0);
        a1 = fma(x.x, h1, a1);
        b0 = fma(x.x, t2_lo(wm), b0);
        b1 = fma(x.x, t2_hi(wm), b1);
        e0 = fma(x.y, h0, e0);
        e1 = fma(x.y, h1, e1);
      }
    }
    t2_release<kStream>(T, g);
  }
  if (kStream) T.used += p.T;
  for (int off = p.L / 2; off > 0; off >>= 1) {
    a0 += __shfl_xor_sync(0xffffffffu, a0, off);
    a1 += __shfl_xor_sync(0xffffffffu, a1, off);
    b0 += __shfl_xor_sync(0xffffffffu, b0, off);
    b1 += __shfl_xor_sync(0xffffffffu, b1, off);
    e0 += __shfl_xor_sync(0xffffffffu, e0, off);
    e1 += __shfl_xor_sync(0xffffffffu, e1, off);
  }
  if (act && l == 0) {
    const int j = 2 * pr;
    T.sums[3 * j] = a0;
    T.sums[3 * j + 1] = b0;
    T.sums[3 * j + 2] = e0;
    if (j + 1 < p.nc) {
      T.sums[3 * j + 3] = a1;
      T.sums[3 * j + 4] = b1;
      T.sums[3 * j + 5] = e1;
    }
  }
}

// A VJP's products: for every row k, the sums over this block's columns j of
// cvec[j] W_hi[k, j] and cvec[j] W_mid[k, j] (Lv lanes per row, lane l
// summing the words j / 2 = l mod Lv in order, then a butterfly), stored
// into slot (rank, k mod nc) of the exchange buffer of k's owner.
template <bool kStream>
__device__ void t2_vjp_products(Team2& T, int P) {
  const Plan2& p = T.p;
  cgt::cluster_group cl = cgt::this_cluster();
  const int RR = kThreads / p.Lv, rr = threadIdx.x / p.Lv, l = threadIdx.x - rr * p.Lv;
  const double* cv = T.cvec;
  double2* slot = T.ex[T.par];
  for (int m = 0; m < p.T; ++m) {
    const int g = T.used + m;
    const uint32_t* tile = t2_acquire<kStream>(T, g, P);
    const int k0 = m * p.R, rows = min(p.R, P - k0);
    for (int r0 = 0; r0 < rows; r0 += RR) {
      const int r = r0 + rr;
      const bool ok = r < rows;
      double dh = 0.0, dm = 0.0;
      if (ok) {
        const uint32_t* row = tile + (size_t)r * p.rw;
        for (int q = l; q < p.nw; q += p.Lv) {
          const uint32_t wh = row[q], wm = row[p.nw + q];
          const double c0 = cv[2 * q], c1 = cv[2 * q + 1];
          dh = fma(c0, t2_lo(wh), dh);
          dh = fma(c1, t2_hi(wh), dh);
          dm = fma(c0, t2_lo(wm), dm);
          dm = fma(c1, t2_hi(wm), dm);
        }
      }
      for (int off = p.Lv / 2; off > 0; off >>= 1) {
        dh += __shfl_xor_sync(0xffffffffu, dh, off);
        dm += __shfl_xor_sync(0xffffffffu, dm, off);
      }
      if (ok && l == 0) {
        const int k = k0 + r, owner = k / p.nc;
        cl.map_shared_rank(slot, owner)[T.rank * p.nc + (k - owner * p.nc)] = make_double2(dh, dm);
      }
    }
    t2_release<kStream>(T, g);
  }
  if (kStream) T.used += p.T;
}

// ext[m] at time t from the lane's knot values in shared memory:
// network_drift.cuh's knot_interp, operation for operation.
__device__ __forceinline__ float t2_knot(const Net& n, const Team2& T, int m, float t) {
  float out = T.kvs[m];
  for (int k = 1; k < n.K; ++k) {
    const float frac = fminf(fmaxf((t - n.kc0[k - 1]) / n.kd[k - 1], 0.0f), 1.0f);
    out = out + frac * (T.kvs[k * n.n_in + m] - T.kvs[(k - 1) * n.n_in + m]);
  }
  return out;
}

// One drift evaluation of the team's lane at time t: the own population's
// state y (v, a, r) -> out (owner threads, threadIdx.x < nc); every thread
// of the block calls it. The split2 drift: rec = (x_hi W_hi + x_hi W_mid) +
// x_mid W_hi, e = ext iwT, each product rounded to float32 once.
template <bool kStream>
__device__ void t2_drift(const Net& n, Team2& T, float t, const float* y, float* out) {
  cgt::cluster_group cl = cgt::this_cluster();
  const int P = n.P, i = threadIdx.x;
  double2* X = T.ex[T.par];
  float* ext = T.ext + T.par * n.n_in;
  float fr = 0.0f;
  if (i < T.p.nc) {
    fr = firing_rate(y[0] - y[1]);
    const float hi = bf16r(fr);
    const double2 v = make_double2((double)hi, (double)bf16r(fr - hi));
    for (int q = 0; q < T.p.C; ++q) cl.map_shared_rank(X, q)[T.c0 + i] = v;
  }
  if (i < n.n_in) ext[i] = t2_knot(n, T, i, t);
  cl.sync();
  t2_fwd_products<kStream>(T, P, X);
  __syncthreads();
  if (i < T.p.nc) {
    const double* s = T.sums + 3 * i;
    const float rec = ((float)s[0] + (float)s[1]) + (float)s[2];
    double e = 0.0;
    for (int m = 0; m < n.n_in; ++m) e = fma((double)ext[m], (double)T.iwc[m * T.p.nc + i], e);
    const float current = (rec + (float)e) + T.bg[i];
    const float total = current * n.tau_s;
    out[0] = (-y[0] + total * n.R) / n.tau_m;
    out[1] = (-y[1] + T.ad[i] * fr) / n.tau_a;
    out[2] = (-y[2] + fr) / n.tau_s;
  }
  T.par ^= 1;
}

// The state cotangent of one split2 drift evaluation at the own state y for
// the output cotangent ct -> out (owner threads), with jax.vjp's bf16
// rounding points: m = bf16(c W_hi^T), q = bf16(c W_mid^T), x_bar = m +
// bf16(bf16(m + q) - m). The stimulus is data: no time enters.
template <bool kStream>
__device__ void t2_vjp(const Net& n, Team2& T, const float* y, const float* ct, float* out) {
  const int i = threadIdx.x;
  float frp = 0.0f;
  if (i < T.p.nc) {
    float fr;
    fr_and_grad(y[0] - y[1], fr, frp);
    T.cvec[i] = (double)(((ct[0] / n.tau_m) * n.R) * n.tau_s);
  }
  __syncthreads();
  t2_vjp_products<kStream>(T, n.P);
  cgt::this_cluster().sync();
  if (i < T.p.nc) {
    const double2* slot = T.ex[T.par];
    double dh = 0.0, dm = 0.0;
    for (int r = 0; r < T.p.C; ++r) {
      const double2 v = slot[r * T.p.nc + i];
      dh += v.x;
      dm += v.y;
    }
    const float m = bf16r((float)dh), q = bf16r((float)dm);
    const float xbar = m + bf16r(bf16r(m + q) - m);
    const float cv = ct[0], ca = ct[1], cr = ct[2];
    const float c_fr = (xbar + T.ad[i] * (ca / n.tau_a)) + cr / n.tau_s;
    const float c_x = frp * c_fr;
    out[0] = -(cv / n.tau_m) + c_x;
    out[1] = -(ca / n.tau_a) - c_x;
    out[2] = -(cr / n.tau_s);
  }
  T.par ^= 1;
}

// The step grids: t0s, hs, i1, i10 (n_steps, B), each lane's own.
struct Replay2 {
  int n_steps, n_real, stride;  // stride: truncation every stride steps (0: none)
  const float *t0s, *hs, *i1, *i10;
};

// B3: SRA1 over lane b's frozen half-step grid. ys[0] = y0, ys[k + 1] after
// step k; rows past n_real hold the carried state (h == 0 padding is a no-op).
template <bool kStream>
__global__ void __launch_bounds__(kThreads, 1)
sde2_fwd_kernel(Net n, Replay2 rp, const uint32_t* __restrict__ wpk,
                const float* __restrict__ iw, const float* __restrict__ y0,
                float* __restrict__ ys) {
  extern __shared__ __align__(16) unsigned char smt[];
  Team2 T;
  team2_init(T, smt, n, wpk, iw, 2 * rp.n_real, kStream);
  const int P = n.P, S = 3 * P, B = n.B, b = blockIdx.x / T.p.C;
  const bool own = threadIdx.x < T.p.nc;
  const int col = T.c0 + threadIdx.x;
  float y[3] = {0.0f, 0.0f, 0.0f}, f1[3] = {0.0f, 0.0f, 0.0f}, f2[3] = {0.0f, 0.0f, 0.0f},
        h2[3];
  if (own) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      y[c] = y0[(size_t)b * S + c * P + col];
      ys[(size_t)b * S + c * P + col] = y[c];
    }
  }
  float t0n = 0.0f, hn = 0.0f, i1n = 0.0f, i10n = 0.0f;
  if (rp.n_real > 0) {
    t0n = rp.t0s[b], hn = rp.hs[b], i1n = rp.i1[b], i10n = rp.i10[b];
  }
  for (int k = 0; k < rp.n_real; ++k) {
    const float t0 = t0n, h = hn, di1 = i1n, i10 = i10n;
    if (k + 1 < rp.n_real) {
      const size_t kb = (size_t)(k + 1) * B + b;
      t0n = rp.t0s[kb], hn = rp.hs[kb], i1n = rp.i1[kb], i10n = rp.i10[kb];
    }
    const float i10h = i10 / (h > 0.0f ? h : 1.0f);
    t2_drift<kStream>(n, T, t0, y, f1);
    const float a = 0.75f * h, kk = 1.5f * i10h;
#pragma unroll
    for (int c = 0; c < 3; ++c) h2[c] = (y[c] + a * f1[c]) + kk * n.sigma;
    t2_drift<kStream>(n, T, t0 + 0.75f * h, h2, f2);
    if (own) {
      float* out = ys + ((size_t)(k + 1) * B + b) * S;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        y[c] = sra1_final(y[c], f1[c], f2[c], h, di1, i10h, n.sigma);
        out[c * P + col] = y[c];
      }
    }
  }
  if (own) {
    for (int k = rp.n_real; k < rp.n_steps; ++k) {
      float* out = ys + ((size_t)(k + 1) * B + b) * S;
#pragma unroll
      for (int c = 0; c < 3; ++c) out[c * P + col] = y[c];
    }
  }
}

// B4: the emit-mode reverse sweep. Over steps n_real-1..0, with c = ybar +
// ysbar[k] written to seeds[k] (the total cotangent on step k's output) and
// lane b's t0, h, i10h, recompute f1 and h2 from ys_prev[k], then
//   c_f2 = ((h c)/3) 2;   c_h2 = f^T|_{h2} c_f2
//   c_f1 = (h c)/3 + (0.75 h) c_h2;   c_y = f^T|_y c_f1
//   ybar = (c + c_h2) + c_y,  zeroed after every step k with k % stride == 0.
// Steps from n_real on carry zero cotangents: their seeds are written 0.
template <bool kStream>
__global__ void __launch_bounds__(kThreads, 1)
sde2_bwd_kernel(Net n, Replay2 rp, const uint32_t* __restrict__ wpk,
                const float* __restrict__ iw, const float* __restrict__ ys_prev,
                const float* __restrict__ ysbar, float* __restrict__ ybar_out,
                float* __restrict__ seeds) {
  extern __shared__ __align__(16) unsigned char smt[];
  Team2 T;
  team2_init(T, smt, n, wpk, iw, 3 * rp.n_real, kStream);
  const int P = n.P, S = 3 * P, B = n.B, b = blockIdx.x / T.p.C;
  const bool own = threadIdx.x < T.p.nc;
  const int col = T.c0 + threadIdx.x;
  if (own) {
    for (int k = rp.n_real; k < rp.n_steps; ++k) {
#pragma unroll
      for (int c = 0; c < 3; ++c) seeds[((size_t)k * B + b) * S + c * P + col] = 0.0f;
    }
  }
  float yb[3] = {0.0f, 0.0f, 0.0f}, yn[3] = {0.0f, 0.0f, 0.0f}, sn[3] = {0.0f, 0.0f, 0.0f};
  float f1[3] = {0.0f, 0.0f, 0.0f}, h2[3], cw[3], ch2[3] = {0.0f, 0.0f, 0.0f},
        cy[3] = {0.0f, 0.0f, 0.0f};
  float t0n = 0.0f, hn = 0.0f, i10n = 0.0f;
  // Step k's inputs, one step ahead of their use.
  auto fetch = [&](int k) {
    const size_t kb = (size_t)k * B + b;
    t0n = rp.t0s[kb], hn = rp.hs[kb], i10n = rp.i10[kb];
    if (own) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        yn[c] = ys_prev[kb * S + c * P + col];
        sn[c] = ysbar[kb * S + c * P + col];
      }
    }
  };
  if (rp.n_real > 0) fetch(rp.n_real - 1);
  for (int k = rp.n_real - 1; k >= 0; --k) {
    const float t0 = t0n, h = hn, i10 = i10n;
    float y[3], c[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      y[j] = yn[j];
      c[j] = yb[j] + sn[j];
    }
    if (k >= 1) fetch(k - 1);
    if (own) {
      float* sk = seeds + ((size_t)k * B + b) * S;
#pragma unroll
      for (int j = 0; j < 3; ++j) sk[j * P + col] = c[j];
    }
    const float i10h = i10 / (h > 0.0f ? h : 1.0f);
    t2_drift<kStream>(n, T, t0, y, f1);
    const float a = 0.75f * h, kk = 1.5f * i10h;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      h2[j] = (y[j] + a * f1[j]) + kk * n.sigma;
      cw[j] = ((h * c[j]) / 3.0f) * 2.0f;
    }
    t2_vjp<kStream>(n, T, h2, cw, ch2);
#pragma unroll
    for (int j = 0; j < 3; ++j) cw[j] = (h * c[j]) / 3.0f + a * ch2[j];
    t2_vjp<kStream>(n, T, y, cw, cy);
    const bool cut = rp.stride > 0 && k % rp.stride == 0;
#pragma unroll
    for (int j = 0; j < 3; ++j) yb[j] = cut ? 0.0f : (c[j] + ch2[j]) + cy[j];
  }
  if (own) {
#pragma unroll
    for (int j = 0; j < 3; ++j) ybar_out[(size_t)b * S + j * P + col] = yb[j];
  }
}

}  // namespace
