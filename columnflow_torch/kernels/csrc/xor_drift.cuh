// The XOR network's drift (columnflow_torch/models/xor.py xor_drift_batched,
// the port of columnflow/models/xor.py) and its VJP (xor_drift_batched_vjp)
// as device functions, shared by xor_ode.cu and xor_sde.cu. Included once per
// source; every source is its own library, so the definitions live in an
// unnamed namespace.
//
// Layout. One thread block holds the whole batch: thread (b, p) = (lane,
// population), B * 24 threads, owns the v, a and r entries of population p
// of lane b in registers. A drift evaluation stores each thread's firing
// rate into shared memory (one barrier), then each thread sums its
// population's recurrent input from its lane's 24 rates and the
// block-diagonal 24 x 24 matrix in shared memory. The VJP stores the
// current's cotangent the same way for the transposed product, and each
// lane's stimulus at that lane's time, and the threads of lane 0 contract
// the feedforward rows' cotangents over the lanes. Every function is called
// by every thread of the block (they hold barriers); threads past B * 24
// compute nothing and store nothing. The selection (xor_sde.cu) runs one
// lane per block in this layout with B = 1.
//
// Precision: float32 elementwise arithmetic with full-precision
// expf/tanhf/logf and IEEE division, compiled with -fmad=false; every sum of
// products takes the products exactly in float64, adds them in the pairwise
// order of models/xor.py tree_sum and rounds once, so the plain PyTorch
// version gives the same bits.

#pragma once

#include "network_drift.cuh"

namespace {

constexpr int kXP = 24;      // populations: columns A, B (area 0), C (area 1)
constexpr int kXS = 72;      // state: v, a, r
constexpr int kXA0 = 16;     // area 0's populations
constexpr int kXIn = 32;     // the two 16-population stimulus slots
constexpr int kXConsts = kXP * kXP + 2 * kXP;  // w24 (row = target), bg24, adapt
constexpr int kXRows = 48;   // w00 (16), w01 (16), w10 (8), w11 (8)
constexpr int kXMaxLanes = 32;
constexpr int kXMaxThreads = kXMaxLanes * kXP;
constexpr float kFFGain = 10.0f;
constexpr int kSrcA = 0, kSrcB = 8;  // the L2/3e populations of columns A and B

// This thread's (lane, population).
struct Me {
  int b, p;
  bool on;
};

__device__ __forceinline__ Me me_of(int B) {
  const int i = (int)threadIdx.x;
  return Me{i / kXP, i % kXP, i < B * kXP};
}

// The block's shared memory.
struct XSh {
  float* w24;    // (24, 24), row i = target population
  float* bg;     // (24)
  float* adapt;  // (24)
  float* rows;   // w00 (16), w01 (16), w10 (8), w11 (8)
  float* fr;     // (B, 24) rates
  float* cc;     // (B, 24) the current's cotangent
  float* ext;    // (B, 32) each lane's stimulus at its own time (the VJP's row contraction)
  double* red;   // (threads) reduction
};

__host__ __device__ size_t xsh_bytes(int B, int threads) {
  const size_t f = kXConsts + kXRows + (size_t)B * (2 * kXP + kXIn);
  return (f * sizeof(float) + 7) / 8 * 8 + (size_t)threads * sizeof(double);
}

// Lay out the shared memory and copy the constants and the rows into it.
// Ends with a barrier.
__device__ XSh xsh_load(unsigned char* sm, int B, const float* __restrict__ consts,
                        const float* __restrict__ rows) {
  XSh s;
  float* f = reinterpret_cast<float*>(sm);
  s.w24 = f;
  s.bg = f + kXP * kXP;
  s.adapt = s.bg + kXP;
  s.rows = s.adapt + kXP;
  s.fr = s.rows + kXRows;
  s.cc = s.fr + B * kXP;
  s.ext = s.cc + B * kXP;
  const size_t used = (size_t)(kXConsts + kXRows + B * (2 * kXP + kXIn)) * sizeof(float);
  s.red = reinterpret_cast<double*>(sm + (used + 7) / 8 * 8);
  for (int i = threadIdx.x; i < kXConsts; i += blockDim.x) f[i] = consts[i];
  for (int i = threadIdx.x; i < kXRows; i += blockDim.x) s.rows[i] = rows[i];
  __syncthreads();
  return s;
}

// Pairwise sum of s[0..N) (models/xor.py tree_sum): neighbours add level by
// level, an odd last entry carries to the next level. Unrolled for a
// compile-time N; s is overwritten.
template <int N>
struct Tree {
  static __device__ __forceinline__ double sum(double* s) {
#pragma unroll
    for (int j = 0; j < N / 2; ++j) s[j] = s[2 * j] + s[2 * j + 1];
    if (N & 1) s[N / 2] = s[N - 1];
    return Tree<(N + 1) / 2>::sum(s);
  }
};

template <>
struct Tree<1> {
  static __device__ __forceinline__ double sum(double* s) { return s[0]; }
};

// The same order for a run-time n <= kXMaxLanes (the contraction over the
// lanes).
__device__ double tree_sum_n(double* s, int n) {
  while (n > 1) {
    for (int j = 0; j < n / 2; ++j) s[j] = s[2 * j] + s[2 * j + 1];
    if (n & 1) s[n / 2] = s[n - 1];
    n = (n + 1) / 2;
  }
  return s[0];
}

// The sum of v over the block's threads, in thread order, in float64; every
// thread gets it. Two barriers.
__device__ double xsum(double v, double* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  double total = 0.0;
  for (int i = 0; i < (int)blockDim.x; ++i) total += red[i];
  __syncthreads();
  return total;
}

// One drift evaluation at time t for this thread's (b, p): y = (v, a, r) ->
// out = (dv, da, dr). Two barriers.
__device__ void xor_drift(const Net& n, const XSh& s, const Me& me, float t, const float* y,
                          float* out) {
  float fr = 0.0f;
  if (me.on) {
    fr = firing_rate(y[0] - y[1]);
    s.fr[me.b * kXP + me.p] = fr;
  }
  __syncthreads();
  if (me.on) {
    const float* frb = s.fr + me.b * kXP;
    const float* w = s.w24 + me.p * kXP;
    double q[kXP];
#pragma unroll
    for (int j = 0; j < kXP; ++j) q[j] = (double)frb[j] * (double)w[j];
    const float rec = (float)Tree<kXP>::sum(q);
    float ff;
    if (me.p < kXA0) {
      ff = knot_interp(n, me.b, me.p, t) * s.rows[me.p]
           + knot_interp(n, me.b, kXA0 + me.p, t) * s.rows[kXA0 + me.p];
    } else {
      const int k = me.p - kXA0;
      ff = kFFGain * (frb[kSrcA] * s.rows[32 + k] + frb[kSrcB] * s.rows[40 + k]);
    }
    const float total = ((ff + s.bg[me.p]) + rec) * n.tau_s;
    out[0] = (-y[0] + total * n.R) / n.tau_m;
    out[1] = (-y[1] + s.adapt[me.p] * fr) / n.tau_a;
    out[2] = (-y[2] + fr) / n.tau_s;
  }
  __syncthreads();
}

// VJP of one drift evaluation at (t, y) for the cotangent ct of its output:
// the state cotangent -> g. The threads of lane 0 get this evaluation's
// cotangents of their population's two feedforward entries, contracted over
// the lanes, in d0 and d1 (p < 16: w00[p], w01[p]; else w10[p-16],
// w11[p-16]); each lane's stimulus enters at that lane's own time t (the
// lanes may step on their own grids). Two barriers.
__device__ void xor_drift_vjp(const Net& n, const XSh& s, const Me& me, float t, const float* y,
                              const float* ct, float* g, float& d0, float& d1) {
  float frp = 0.0f;
  if (me.on) {
    float fr;
    fr_and_grad(y[0] - y[1], fr, frp);
    s.fr[me.b * kXP + me.p] = fr;
    s.cc[me.b * kXP + me.p] = ((ct[0] / n.tau_m) * n.R) * n.tau_s;
    if (me.p < kXA0) {
      s.ext[me.b * kXIn + me.p] = knot_interp(n, me.b, me.p, t);
      s.ext[me.b * kXIn + kXA0 + me.p] = knot_interp(n, me.b, kXA0 + me.p, t);
    }
  }
  __syncthreads();
  if (me.on) {
    const float* ccb = s.cc + me.b * kXP;
    double q[kXP];
#pragma unroll
    for (int i = 0; i < kXP; ++i) q[i] = (double)ccb[i] * (double)s.w24[i * kXP + me.p];
    float x = (float)Tree<kXP>::sum(q);
    if (me.p == kSrcA || me.p == kSrcB) {
      const float* w = s.rows + (me.p == kSrcA ? 32 : 40);
      double r[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) r[k] = (double)(kFFGain * ccb[kXA0 + k]) * (double)w[k];
      x = x + (float)Tree<8>::sum(r);
    }
    const float ca_t = ct[1] / n.tau_a, cr_t = ct[2] / n.tau_s;
    const float c_x = frp * ((x + s.adapt[me.p] * ca_t) + cr_t);
    g[0] = -(ct[0] / n.tau_m) + c_x;
    g[1] = -ca_t - c_x;
    g[2] = -cr_t;
    if (me.b == 0) {
      double e0[kXMaxLanes], e1[kXMaxLanes];
      for (int b = 0; b < n.B; ++b) {
        const float c = s.cc[b * kXP + me.p];
        if (me.p < kXA0) {
          e0[b] = (double)c * (double)s.ext[b * kXIn + me.p];
          e1[b] = (double)c * (double)s.ext[b * kXIn + kXA0 + me.p];
        } else {
          const float sb = kFFGain * c;
          e0[b] = (double)sb * (double)s.fr[b * kXP + kSrcA];
          e1[b] = (double)sb * (double)s.fr[b * kXP + kSrcB];
        }
      }
      d0 = (float)tree_sum_n(e0, n.B);
      d1 = (float)tree_sum_n(e1, n.B);
    }
  }
  __syncthreads();
}

// The rows' cotangents of lane 0's thread for population p into the packed
// (48,) output.
__device__ __forceinline__ void store_rows(const Me& me, float d0, float d1, float* out) {
  if (me.on && me.b == 0) {
    if (me.p < kXA0) {
      out[me.p] = d0;
      out[kXA0 + me.p] = d1;
    } else {
      out[32 + me.p - kXA0] = d0;
      out[40 + me.p - kXA0] = d1;
    }
  }
}

// Offset of component c (0: v, 1: a, 2: r) of this thread in a (B, 72)
// state.
__device__ __forceinline__ int comp(const Me& me, int c) { return me.b * kXS + c * kXP + me.p; }

int xor_threads(int B) { return (B * kXP + 31) / 32 * 32; }

Net make_xor_net(int B, int K, const float* hc, const float* kv) {
  return make_net(B, kXP, kXIn, K, hc, nullptr, nullptr, kv);
}

int check_xor(int B, int K) {
  if (B < 1 || B > kXMaxLanes || K < 1 || K > kMaxKnots) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace
