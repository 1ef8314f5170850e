// Teams of thread blocks: one thread-block cluster of kCluster blocks runs
// the drift evaluations and drift VJPs of one lane (or of one batch) of the
// column network at widths where a step does not fit one block. What the
// dopri5 kernels (network_ode.cu: B6 at any width, B7 and B8' on either
// split, B8t-team) and the three-term SDE sweeps (network_sde.cu: B3t-team,
// B4t, B4't-team) share.
// Included once per source; every source is its own library, so the
// definitions live in an unnamed namespace.

#pragma once

#include <cooperative_groups.h>

#include "network_drift.cuh"
#include "split_acc.cuh"
#include "split3_drift.cuh"

namespace {

// At P = 832 (104 columns) nothing of a step fits one block: the three-term
// matrices are 4.15 MB, the two-term ones 2.77 MB, and the selection's ten
// batch states 400 KB. So a drift evaluation is spread over the kCluster
// blocks of one thread-block cluster (a "team"): block r owns the
// populations [r P/kCluster, (r+1) P/kCluster) of every lane it holds,
// i.e. their v, a and r entries, and every elementwise operation of the
// step on them. The state vectors live in global memory (L2), each block
// touching only its own entries, so a block barrier orders them. Per drift
// evaluation a block computes the rates of its populations, splits them
// into bf16 terms and stores those into every block's shared memory
// (distributed shared memory), one cluster barrier, then each block runs
// the (P, P) products for its own output columns, reading the matrices
// from global memory (L2-resident: the card has 50 MB). A VJP exchanges
// the current's cotangent the same way and runs the transposed products on
// transposed copies of the split's matrices. The exchange buffers are
// double-buffered: a block writes buffer p of exchange n only after the
// barrier of exchange n-1, which every block reaches after its products of
// exchange n-2, the last reads of buffer p. The selection's error norm is
// a block sum per block, stored into every block and summed in rank order,
// so every block takes the same accept decision from the same bits.
//
// Where the time goes: each product is a matrix-vector product per lane
// (2 P^2 operations, 0.7-1.4 MB of bf16 weights from L2), so a step is
// latency- and L2-bound on 8 SMs per team; the four lanes of the replay and
// its reverse sweep run as four teams (32 SMs). The sums are float64
// (bf16 times bf16 or float32 terms are exact in float64), split
// over up to kMaxSplit thread groups along k when a block has fewer output
// columns than threads; the groups' partial sums add in group order.

namespace cg = cooperative_groups;

constexpr int kCluster = 8;
constexpr int kMaxSplit = 8;

// The weights in global memory.
struct Wg {
  const bf16 *hi, *mid, *lo;     // (P, P) terms of wT (lo: the three-term split only)
  const bf16 *hiT, *midT, *loT;  // their transposes (the reverse sweeps)
  const float* iw;               // (n_in, P)
};

// One block's share of a team, and its shared memory.
struct Team {
  int rank, c0, nc;     // this block owns populations [c0, c0 + nc)
  int nb, b0, S;        // lanes b0 .. b0 + nb - 1 of the knot table; S = 3P
  int par, rpar;        // exchange and reduction buffer in use
  unsigned char* ex[2]; // exchange buffers: bf16 terms (term, lane, P) or float (lane, P)
  float* fr;            // (nb, nc) own rates, or their derivative in a VJP
  float* ext;           // (nb, kMaxInputs) stimulus
  double* part;         // (G, output slots, lanes per thread, np) partial sums of the k groups
  double* red;          // (kThreads / 32) block reduction
  double* cred;         // (2, kCluster) team reduction
};

__host__ __device__ inline int split_of(int nout) {
  const int g = kThreads / nout;
  return 2 * nout <= kThreads ? (g < kMaxSplit ? g : kMaxSplit) : 1;
}

__host__ __device__ inline size_t ex_bytes(int P, int nb, int nterms) {
  const size_t t = (size_t)nterms * nb * P * sizeof(bf16), f = (size_t)nb * P * sizeof(float);
  return ((t > f ? t : f) + 15) / 16 * 16;
}

// Output slots of a block's products: a thread computes one population for
// lb lanes (the selection: 4, so one weight load serves four lanes).
__host__ __device__ inline int out_slots(int nb, int nc, int lb) { return (nb + lb - 1) / lb * nc; }

// Bytes of shared memory a team block uses: nterms bf16 terms exchanged per
// drift evaluation, np products per output, lb lanes per thread.
size_t team_smem(int P, int nb, int nterms, int np, int lb) {
  const int nc = P / kCluster, nout = out_slots(nb, nc, lb), G = split_of(nout);
  const size_t d = (G > 1 ? (size_t)G * nout * lb * np : 0) + kThreads / 32 + 2 * kCluster;
  const size_t f = (size_t)nb * nc + (size_t)nb * kMaxInputs;
  return (d * sizeof(double) + f * sizeof(float) + 15) / 16 * 16 + 2 * ex_bytes(P, nb, nterms);
}

__device__ void team_init(Team& T, unsigned char* sm, int P, int nb, int b0, int nterms,
                          int np, int lb) {
  T.rank = (int)cg::this_cluster().block_rank();
  T.nc = P / kCluster;
  T.c0 = T.rank * T.nc;
  T.nb = nb;
  T.b0 = b0;
  T.S = 3 * P;
  T.par = T.rpar = 0;
  const int nout = out_slots(nb, T.nc, lb), G = split_of(nout);
  double* d = reinterpret_cast<double*>(sm);
  T.part = d;
  d += G > 1 ? (size_t)G * nout * lb * np : 0;
  T.red = d;
  d += kThreads / 32;
  T.cred = d;
  d += 2 * kCluster;
  float* f = reinterpret_cast<float*>(d);
  T.fr = f;
  f += nb * T.nc;
  T.ext = f;
  f += nb * kMaxInputs;
  unsigned char* e = sm + ((reinterpret_cast<unsigned char*>(f) - sm) + 15) / 16 * 16;
  T.ex[0] = e;
  T.ex[1] = e + ex_bytes(P, nb, nterms);
  // Every block of the cluster has started before any writes into another's
  // shared memory. (None writes after its last cluster barrier, so a block
  // may leave when it is done.)
  cg::this_cluster().sync();
}

// Offset in a (nb, 3P) state of this block's own element e (0 <= e < 3 nb nc).
__device__ __forceinline__ int own_off(const Team& T, int P, int e) {
  const int per = 3 * T.nc;
  const int b = e / per, r = e - b * per, comp = r / T.nc;
  return b * T.S + comp * P + T.c0 + (r - comp * T.nc);
}

__device__ __forceinline__ int own_count(const Team& T) { return 3 * T.nb * T.nc; }

// Sum of v over every thread of the team, the same double in every block.
__device__ double team_sum(Team& T, double v) {
  cg::cluster_group cl = cg::this_cluster();
  const double tot = block_sum(v, T.red);
  if (threadIdx.x == 0)
    for (int q = 0; q < kCluster; ++q)
      cl.map_shared_rank(T.cred, q)[T.rpar * kCluster + T.rank] = tot;
  cl.sync();
  double all = 0.0;
  for (int q = 0; q < kCluster; ++q) all += T.cred[T.rpar * kCluster + q];
  T.rpar ^= 1;
  return all;
}

__device__ __forceinline__ double bfd(bf16 x) { return (double)__bfloat162float(x); }

// The rates of the own populations of every lane at y, split into NT bf16
// terms and stored into every block's exchange buffer; the stimulus at t
// (or lane b at its own time tl[b]). Ends with the cluster barrier.
template <int NT>
__device__ void share_terms(const Net& n, Team& T, float t, const float* y,
                            const float* tl = nullptr) {
  cg::cluster_group cl = cg::this_cluster();
  const int P = n.P, nb = T.nb;
  bf16* mine = reinterpret_cast<bf16*>(T.ex[T.par]);
  for (int e = threadIdx.x; e < nb * T.nc; e += blockDim.x) {
    const int b = e / T.nc, c = T.c0 + (e - b * T.nc);
    const float fr = firing_rate(y[b * T.S + c] - y[b * T.S + P + c]);
    T.fr[e] = fr;
    bf16 term[NT];
    const float hi = bf16r(fr);
    term[0] = __float2bfloat16_rn(fr);
    if constexpr (NT == 2) {
      term[1] = __float2bfloat16_rn(fr - hi);
    } else {
      const float r = fr - hi;
      const float mid = bf16r(r);
      term[1] = __float2bfloat16_rn(r);
      term[2] = __float2bfloat16_rn(r - mid);
    }
    for (int q = 0; q < kCluster; ++q) {
      bf16* dst = cl.map_shared_rank(mine, q);
#pragma unroll
      for (int j = 0; j < NT; ++j) dst[((size_t)j * nb + b) * P + c] = term[j];
    }
  }
  for (int idx = threadIdx.x; idx < nb * n.n_in; idx += blockDim.x) {
    const int b = idx / n.n_in, m = idx - b * n.n_in;
    T.ext[b * kMaxInputs + m] = knot_interp(n, T.b0 + b, m, tl ? tl[b] : t);
  }
  cl.sync();
}

// The drift's output at own column col of lane b from its product sums p:
// three-term (NP = 6) rec = x_hi W_lo + x_mid W_mid + x_lo W_hi + x_hi W_mid
// + x_mid W_hi + x_hi W_hi, two-term (NP = 3) rec = x_hi W_hi + x_hi W_mid +
// x_mid W_hi, each rounded to float32 and added left to right.
template <int NP>
__device__ void drift_out(const Net& n, const Team& T, int b, int col, int oo, const double* p,
                          const float* y, float* out, const Wg& w) {
  const int P = n.P;
  float rec = (float)p[0];
#pragma unroll
  for (int j = 1; j < NP; ++j) rec = rec + (float)p[j];
  double e = 0.0;
  for (int m = 0; m < n.n_in; ++m)
    e = fma((double)T.ext[b * kMaxInputs + m], (double)w.iw[(size_t)m * P + col], e);
  const float current = (rec + (float)e) + n.bg[col];
  const float total = current * n.tau_s;
  const size_t base = (size_t)b * T.S;
  const float fr = T.fr[oo];
  out[base + col] = (-y[base + col] + total * n.R) / n.tau_m;
  out[base + P + col] = (-y[base + P + col] + n.adapt[col] * fr) / n.tau_a;
  out[base + 2 * P + col] = (-y[base + 2 * P + col] + fr) / n.tau_s;
}

// One drift evaluation of the team's lanes at the shared time t (or lane b
// at tl[b]): y -> out (nb, 3P), both in global memory, own entries only;
// NT = 3: the three-term split, NT = 2: the two-term one. A thread computes
// one population for LB lanes at a time, over one of G groups of k. Ends
// with a block barrier.
template <int NT, int LB>
__device__ void drift_team(const Net& n, Team& T, float t, const float* y, float* out,
                           const Wg& w, const float* tl = nullptr) {
  constexpr int NP = NT == 3 ? 6 : 3;
  share_terms<NT>(n, T, t, y, tl);
  const int P = n.P, nb = T.nb, nout = out_slots(nb, T.nc, LB), G = split_of(nout);
  const int kc = (P + G - 1) / G;
  const bf16* X = reinterpret_cast<const bf16*>(T.ex[T.par]);
  for (int o = threadIdx.x; o < nout * G; o += blockDim.x) {
    const int g = o / nout, oo = o - g * nout, grp = oo / T.nc, col = T.c0 + (oo - grp * T.nc);
    const int b0 = grp * LB, nl = min(LB, nb - b0);
    double p[LB][NP];
#pragma unroll
    for (int l = 0; l < LB; ++l) {
#pragma unroll
      for (int j = 0; j < NP; ++j) p[l][j] = 0.0;
    }
    const int k1 = min(P, (g + 1) * kc);
#pragma unroll 4
    for (int k = g * kc; k < k1; ++k) {
      const size_t at = (size_t)k * P + col;
      const double wh = bfd(w.hi[at]), wm = bfd(w.mid[at]);
      double wl = 0.0;
      if constexpr (NT == 3) wl = bfd(w.lo[at]);
#pragma unroll
      for (int l = 0; l < LB; ++l) {
        if (l < nl) {
          const int b = b0 + l;
          const double a = bfd(X[(size_t)b * P + k]), c = bfd(X[((size_t)nb + b) * P + k]);
          if constexpr (NT == 3) {
            const double d = bfd(X[((size_t)2 * nb + b) * P + k]);
            p[l][0] = fma(a, wl, p[l][0]);
            p[l][1] = fma(c, wm, p[l][1]);
            p[l][2] = fma(d, wh, p[l][2]);
            p[l][3] = fma(a, wm, p[l][3]);
            p[l][4] = fma(c, wh, p[l][4]);
            p[l][5] = fma(a, wh, p[l][5]);
          } else {
            p[l][0] = fma(a, wh, p[l][0]);
            p[l][1] = fma(a, wm, p[l][1]);
            p[l][2] = fma(c, wh, p[l][2]);
          }
        }
      }
    }
    if (G == 1) {
      for (int l = 0; l < nl; ++l)
        drift_out<NP>(n, T, b0 + l, col, (b0 + l) * T.nc + (col - T.c0), p[l], y, out, w);
    } else {
#pragma unroll
      for (int l = 0; l < LB; ++l) {
#pragma unroll
        for (int j = 0; j < NP; ++j) T.part[(((size_t)g * nout + oo) * LB + l) * NP + j] = p[l][j];
      }
    }
  }
  if (G > 1) {
    __syncthreads();
    for (int oo = threadIdx.x; oo < nout; oo += blockDim.x) {
      const int grp = oo / T.nc, col = T.c0 + (oo - grp * T.nc);
      const int b0 = grp * LB, nl = min(LB, nb - b0);
      for (int l = 0; l < nl; ++l) {
        double q[NP];
#pragma unroll
        for (int j = 0; j < NP; ++j) q[j] = T.part[((size_t)oo * LB + l) * NP + j];
        for (int g = 1; g < G; ++g) {
#pragma unroll
          for (int j = 0; j < NP; ++j) q[j] += T.part[(((size_t)g * nout + oo) * LB + l) * NP + j];
        }
        drift_out<NP>(n, T, b0 + l, col, (b0 + l) * T.nc + (col - T.c0), q, y, out, w);
      }
    }
  }
  T.par ^= 1;
  __syncthreads();
}
// The state cotangent at own population k of lane b of one drift evaluation
// for the output cotangent ct -> out, given the float64 sums d[j] of the
// current's cotangent against the transposed terms, with jax.vjp's rounding
// points. Two-term: m = bf16(c W_hi^T), q = bf16(c W_mid^T),
// x_bar = m + bf16(bf16(m + q) - m). Three-term (split3_drift.cuh
// drift_vjp3): with l = bf16(c W_lo^T) too, u = bf16(m + q),
// r = m + bf16(u - m), x_bar = r + bf16(bf16(u + l) + bf16(-r)).
template <int NT>
__device__ void vjp_out(const Net& n, const Team& T, int b, int k, int oo, const double* d,
                        const float* ct, float* out) {
  const int P = n.P;
  const float m = bf16r((float)d[0]), q = bf16r((float)d[1]);
  float xbar;
  if constexpr (NT == 2) {
    xbar = m + bf16r(bf16r(m + q) - m);
  } else {
    const float l = bf16r((float)d[2]);
    const float u = bf16r(m + q);
    const float r = m + bf16r(u - m);
    xbar = r + bf16r(bf16r(u + l) + bf16r(-r));
  }
  const size_t base = (size_t)b * T.S;
  const float cv = ct[base + k], ca = ct[base + P + k], cr = ct[base + 2 * P + k];
  const float c_fr = (xbar + n.adapt[k] * (ca / n.tau_a)) + cr / n.tau_s;
  const float c_x = T.fr[oo] * c_fr;
  out[base + k] = -(cv / n.tau_m) + c_x;
  out[base + P + k] = -(ca / n.tau_a) - c_x;
  out[base + 2 * P + k] = -(cr / n.tau_s);
}

// The transposed products of a drift VJP for the own populations of every
// lane, given the current's cotangent C (nb, P) of every population in this
// block's shared memory and the rates' derivative of the own populations in
// T.fr: the state cotangent -> out (own entries), over up to kMaxSplit groups
// of j. Ends without a barrier after its last writes to out. For VJPs that
// exchange more than C (network_sde.cu's B4't-team); vjp_team keeps the same
// loop inline: calling this from it took the split2 tier's B8' from 108
// registers to 64 with spills and 41% more time per step on the H100.
template <int NT>
__device__ __forceinline__ void vjp_products(const Net& n, Team& T, const float* C,
                                             const float* ct, float* out, const Wg& w) {
  const int P = n.P, nb = T.nb;
  const int nout = nb * T.nc, G = split_of(nout), kc = (P + G - 1) / G;
  for (int o = threadIdx.x; o < nout * G; o += blockDim.x) {
    const int g = o / nout, oo = o - g * nout, b = oo / T.nc, k = T.c0 + (oo - b * T.nc);
    const float* cb = C + (size_t)b * P;
    double d[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) d[j] = 0.0;
    const int j1 = min(P, (g + 1) * kc);
#pragma unroll 4
    for (int j = g * kc; j < j1; ++j) {
      const size_t at = (size_t)j * P + k;
      const double c = cb[j];
      d[0] = fma(c, bfd(w.hiT[at]), d[0]);
      d[1] = fma(c, bfd(w.midT[at]), d[1]);
      if constexpr (NT == 3) d[2] = fma(c, bfd(w.loT[at]), d[2]);
    }
    if (G == 1) {
      vjp_out<NT>(n, T, b, k, oo, d, ct, out);
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) T.part[((size_t)g * nout + oo) * NT + j] = d[j];
    }
  }
  if (G > 1) {
    __syncthreads();
    for (int oo = threadIdx.x; oo < nout; oo += blockDim.x) {
      double d[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) d[j] = T.part[(size_t)oo * NT + j];
      for (int g = 1; g < G; ++g) {
#pragma unroll
        for (int j = 0; j < NT; ++j) d[j] += T.part[((size_t)g * nout + oo) * NT + j];
      }
      const int b = oo / T.nc;
      vjp_out<NT>(n, T, b, T.c0 + (oo - b * T.nc), oo, d, ct, out);
    }
  }
}

// The state cotangent of one drift evaluation of the team's lanes at y for
// the output cotangent ct -> out (own entries; the stimulus is data, so no
// time enters), NT = 2: the two-term split, NT = 3: the three-term one. The
// current's cotangent of the own populations is stored into every block's
// exchange buffer, one cluster barrier, then each block runs the transposed
// products for its own populations over up to kMaxSplit groups of j. Ends
// with a block barrier.
template <int NT>
__device__ void vjp_team(const Net& n, Team& T, const float* y, const float* ct, float* out,
                         const Wg& w) {
  cg::cluster_group cl = cg::this_cluster();
  const int P = n.P, nb = T.nb;
  float* mine = reinterpret_cast<float*>(T.ex[T.par]);
  for (int e = threadIdx.x; e < nb * T.nc; e += blockDim.x) {
    const int b = e / T.nc, c = T.c0 + (e - b * T.nc);
    float fr, frp;
    fr_and_grad(y[b * T.S + c] - y[b * T.S + P + c], fr, frp);
    T.fr[e] = frp;
    const float cc = ((ct[b * T.S + c] / n.tau_m) * n.R) * n.tau_s;
    for (int q = 0; q < kCluster; ++q) cl.map_shared_rank(mine, q)[(size_t)b * P + c] = cc;
  }
  cl.sync();
  const float* C = mine;
  const int nout = nb * T.nc, G = split_of(nout), kc = (P + G - 1) / G;
  for (int o = threadIdx.x; o < nout * G; o += blockDim.x) {
    const int g = o / nout, oo = o - g * nout, b = oo / T.nc, k = T.c0 + (oo - b * T.nc);
    const float* cb = C + (size_t)b * P;
    double d[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) d[j] = 0.0;
    const int j1 = min(P, (g + 1) * kc);
#pragma unroll 4
    for (int j = g * kc; j < j1; ++j) {
      const size_t at = (size_t)j * P + k;
      const double c = cb[j];
      d[0] = fma(c, bfd(w.hiT[at]), d[0]);
      d[1] = fma(c, bfd(w.midT[at]), d[1]);
      if constexpr (NT == 3) d[2] = fma(c, bfd(w.loT[at]), d[2]);
    }
    if (G == 1) {
      vjp_out<NT>(n, T, b, k, oo, d, ct, out);
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) T.part[((size_t)g * nout + oo) * NT + j] = d[j];
    }
  }
  if (G > 1) {
    __syncthreads();
    for (int oo = threadIdx.x; oo < nout; oo += blockDim.x) {
      double d[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) d[j] = T.part[(size_t)oo * NT + j];
      for (int g = 1; g < G; ++g) {
#pragma unroll
        for (int j = 0; j < NT; ++j) d[j] += T.part[((size_t)g * nout + oo) * NT + j];
      }
      const int b = oo / T.nc;
      vjp_out<NT>(n, T, b, T.c0 + (oo - b * T.nc), oo, d, ct, out);
    }
  }
  T.par ^= 1;
  __syncthreads();
}

__device__ void vjp2_team(const Net& n, Team& T, const float* y, const float* ct, float* out,
                          const Wg& w) {
  vjp_team<2>(n, T, y, ct, out, w);
}

__device__ void vjp3_team(const Net& n, Team& T, const float* y, const float* ct, float* out,
                          const Wg& w) {
  vjp_team<3>(n, T, y, ct, out, w);
}

// One drift VJP's exchange for the weight cotangents of the kernel-mode
// sweeps that hold the batch on one team (network_sde.cu's B4't-team,
// network_ode.cu's B8t-team): every block receives every population's
// terms, so each forms the weight-cotangent entries of its own output
// columns by itself.
struct WX {
  bf16* x;     // (3, nb, P) the rates' bf16 terms, every population
  float* c;    // (nb, P) the current's cotangent, every population
  float* ext;  // (nb, kMaxInputs) the stimulus at each lane's time (this block's own copy)
};

__host__ __device__ inline size_t wx_bytes(int P, int nb) {
  const size_t x = ((size_t)3 * nb * P * sizeof(bf16) + 15) / 16 * 16;
  return x + (size_t)nb * (P + kMaxInputs) * sizeof(float);
}

__device__ WX wx_at(unsigned char* p, int P, int nb) {
  WX x;
  x.x = reinterpret_cast<bf16*>(p);
  x.c = reinterpret_cast<float*>(p + ((size_t)3 * nb * P * sizeof(bf16) + 15) / 16 * 16);
  x.ext = x.c + (size_t)nb * P;
  return x;
}

// The state cotangent of one drift evaluation of the team's lanes at y for
// the output cotangent ct -> out (own entries), as vjp_team<NT>, exchanging
// into x both the current's cotangent and the rates' NT bf16 terms of the
// own populations (NT = 3: the three-term split, split3; NT = 2: the
// two-term one, hi = bf16(fr), mid = bf16(fr - hi)), and the stimulus at the
// shared time t (or lane b at its own time tl[b]) for d iwT. Ends with a
// block barrier.
template <int NT>
__device__ void vjp_team_w(const Net& n, Team& T, float t, const float* tl, const float* y,
                           const float* ct, float* out, const Wg& w, const WX& x) {
  cg::cluster_group cl = cg::this_cluster();
  const int P = n.P, nb = T.nb;
  for (int e = threadIdx.x; e < nb * T.nc; e += blockDim.x) {
    const int b = e / T.nc, c = T.c0 + (e - b * T.nc);
    float fr, frp;
    fr_and_grad(y[b * T.S + c] - y[b * T.S + P + c], fr, frp);
    T.fr[e] = frp;
    bf16 term[NT];
    if constexpr (NT == 3) {
      float hi, mid, lo;
      split3(fr, hi, mid, lo);
      term[0] = __float2bfloat16_rn(hi);
      term[1] = __float2bfloat16_rn(mid);
      term[2] = __float2bfloat16_rn(lo);
    } else {
      term[0] = __float2bfloat16_rn(fr);
      term[1] = __float2bfloat16_rn(fr - bf16r(fr));
    }
    const float cc = ((ct[b * T.S + c] / n.tau_m) * n.R) * n.tau_s;
    for (int q = 0; q < kCluster; ++q) {
      bf16* dx = cl.map_shared_rank(x.x, q);
#pragma unroll
      for (int j = 0; j < NT; ++j) dx[((size_t)j * nb + b) * P + c] = term[j];
      cl.map_shared_rank(x.c, q)[(size_t)b * P + c] = cc;
    }
  }
  for (int idx = threadIdx.x; idx < nb * n.n_in; idx += blockDim.x) {
    const int b = idx / n.n_in, m = idx - b * n.n_in;
    x.ext[b * kMaxInputs + m] = knot_interp(n, T.b0 + b, m, tl ? tl[b] : t);
  }
  cl.sync();
  vjp_products<NT>(n, T, x.c, ct, out, w);
  __syncthreads();
}

// The bf16 cotangents of one drift VJP's NT products at weight entry (i, j),
// each contracted over the nb lanes of x in float64, in lane order, and
// rounded: d[0] = bf(x_hi^T c), d[1] = bf(x_mid^T c), d[2] = bf(x_lo^T c).
template <int NT>
__device__ __forceinline__ void wx_cot(const WX& x, int nb, int P, int i, int j, float* d) {
  double s[NT];
#pragma unroll
  for (int q = 0; q < NT; ++q) s[q] = 0.0;
  for (int b = 0; b < nb; ++b) {
    const double c = x.c[(size_t)b * P + j];
#pragma unroll
    for (int q = 0; q < NT; ++q) s[q] += bfd(x.x[((size_t)q * nb + b) * P + i]) * c;
  }
#pragma unroll
  for (int q = 0; q < NT; ++q) d[q] = bf16r((float)s[q]);
}

// Check the shape and request the shared memory of a team kernel for nb
// lanes per team (team_smem's arguments).
template <typename Kern>
int team_prepare(Kern kernel, int P, int n_in, int K, int nb, int nterms, int np, int lb,
                 size_t* bytes) {
  if (int e = check_shape(P, n_in, K)) return e;
  if (P % kCluster) return (int)cudaErrorInvalidValue;
  *bytes = team_smem(P, nb, nterms, np, lb);
  return set_smem(kernel, *bytes);
}

}  // namespace
