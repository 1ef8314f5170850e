// WTA column kernels for Hopper (sm_90a): the batched SRA1 rollout, its
// reverse sweep, the batch reduction of the weight cotangent, and one drift
// evaluation. Plain C entry points, loaded with ctypes by
// columnflow_torch/kernels/_build.py; each returns cudaGetLastError().
//
// Replaces (columnflow/kernels/column_step.py):
//   wta_rollout_fwd  <- _rollout_kernel      (B1, the SRA1 forward rollout)
//   wta_rollout_bwd  <- _rollout_bwd_kernel  (B2, the reverse sweep)
//   wta_wbar_reduce  <- the batch sum inside _rollout_bwd_kernel (B2)
//   wta_drift        <- _drift_kernel        (B9, one drift evaluation)
//
// What bounds them on this card: a serial chain of T-1 = 1499 dependent SRA1
// steps. Per training step at 15 lanes the forward does ~61 MFLOP and the
// forward plus backward move ~5.8 MB of trajectory and stimulus; both are
// microseconds of the card's peak, so the time is the latency of one step
// times 1499. What the simple design does about that: nothing yet. One warp
// per rollout lane; lane p < 16 of the warp owns population p's v, a and r
// in registers, keeps row p (and, backward, column p) of the recurrent
// weights in registers, and gathers the 16 firing rates with __shfl_sync.
// Lanes 16-31 mirror lanes 0-15 and store nothing: they stay idle for now
// (splitting the 16-term sums across them is later work). Each step's
// stimulus and noise are loaded one step ahead, so global-memory latency
// overlaps the previous step's arithmetic.
//
// Precision: float32 throughout, full-precision expf/tanhf/division (no
// --use_fast_math). The firing-rate argument xn = 48 x - 981 and the tanh
// argument are rounded as separate operations (__fmul_rn keeps nvcc from
// contracting them into an FMA), so the guard at the removable singularity
// sees the same values as the plain PyTorch version; other multiply-adds
// may contract, which changes the rounding by a few ulp.

#include <cuda_runtime.h>

namespace {

constexpr int kPops = 16;
constexpr int kState = 48;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

constexpr float kGain = 48.0f;
constexpr float kThresh = 981.0f;
constexpr float kD = 0.0089f;
constexpr float kClamp = 80.0f;

struct Scalars {
  float tau_s, tau_m, tau_a, R;
};

// Per-population constants of lane p: background current, feedforward
// weight, adaptation strength, and the diffusion of v, a and r.
struct PopConsts {
  float bg, ffw, ad, gv, ga, gr;
};

__device__ __forceinline__ float firing_rate(float x) {
  const float xn = __fsub_rn(__fmul_rn(kGain, x), kThresh);
  const float e = expf(kClamp * tanhf(__fmul_rn(-kD, xn) / kClamp));
  const float den = 1.0f - e;
  const bool near = fabsf(den) < 1e-12f;
  return near ? 1.0f / kD : xn / (near ? 1.0f : den);
}

// Firing rate and its derivative with respect to x (the Pallas kernel's
// _fr_and_grad): at the removable singularity phi = 1/d and phi' = 48/2.
__device__ __forceinline__ void fr_and_grad(float x, float& fr, float& frp) {
  const float xn = __fsub_rn(__fmul_rn(kGain, x), kThresh);
  const float th = tanhf(__fmul_rn(-kD, xn) / kClamp);
  const float e = expf(kClamp * th);
  const float den = 1.0f - e;
  const bool near = fabsf(den) < 1e-12f;
  const float sden = near ? 1.0f : den;
  fr = near ? 1.0f / kD : xn / sden;
  const float dden = e * kD * (1.0f - th * th);
  const float dfr = near ? 0.5f : (sden - xn * dden) / (sden * sden);
  frp = kGain * dfr;
}

// rec_p = sum_q w[p, q] fr_q with fr_q gathered from lane q.
__device__ __forceinline__ float row_dot(const float (&w_row)[kPops], float fr) {
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < kPops; ++q) acc = fmaf(w_row[q], __shfl_sync(kFull, fr, q), acc);
  return acc;
}

// Drift of population p at (v, a, r) with stimulus s; all 32 lanes call it.
__device__ __forceinline__ void drift_pop(float v, float a, float r, float s,
                                          const float (&w_row)[kPops],
                                          const PopConsts& pc, const Scalars& sc,
                                          float& dv, float& da, float& dr) {
  const float fr = firing_rate(v - a);
  const float rec = row_dot(w_row, fr);
  const float cur = (pc.ffw * s + pc.bg + rec) * sc.tau_s;
  dv = (-v + cur * sc.R) / sc.tau_m;
  da = (-a + pc.ad * fr) / sc.tau_a;
  dr = (-r + fr) / sc.tau_s;
}

// Hand-derived VJP of the drift at (v, a) for the cotangent (cv, ca, cr):
// returns the state cotangent and adds rec_bar_p * fr_q to row p of w_bar.
__device__ __forceinline__ void drift_vjp_pop(float v, float a, float cv, float ca,
                                              float cr, const float (&w_col)[kPops],
                                              const PopConsts& pc, const Scalars& sc,
                                              float (&wacc)[kPops], float& ybv,
                                              float& yba, float& ybr) {
  float fr, frp;
  fr_and_grad(v - a, fr, frp);
  const float rec_bar = cv * (sc.R * sc.tau_s / sc.tau_m);
  // fr_bar_p = sum_q rec_bar_q w[q, p] (the transposed product).
  float tr = 0.0f;
#pragma unroll
  for (int q = 0; q < kPops; ++q) {
    tr = fmaf(__shfl_sync(kFull, rec_bar, q), w_col[q], tr);
    wacc[q] = fmaf(rec_bar, __shfl_sync(kFull, fr, q), wacc[q]);
  }
  const float fr_bar = tr + ca * (pc.ad / sc.tau_a) + cr / sc.tau_s;
  const float x_bar = frp * fr_bar;
  ybv = -cv / sc.tau_m + x_bar;
  yba = -ca / sc.tau_a - x_bar;
  ybr = -cr / sc.tau_s;
}

__device__ __forceinline__ PopConsts load_consts(const float* c, const float* g, int p) {
  return PopConsts{c[p], c[kPops + p], c[2 * kPops + p], g[p], g[kPops + p], g[2 * kPops + p]};
}

__global__ void wta_drift_kernel(int B, Scalars sc, const float* __restrict__ y,
                                 const float* __restrict__ s, const float* __restrict__ w,
                                 const float* __restrict__ c, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int p = lane & (kPops - 1);
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // warp-uniform
  float w_row[kPops];
#pragma unroll
  for (int q = 0; q < kPops; ++q) w_row[q] = w[p * kPops + q];
  const PopConsts pc = PopConsts{c[p], c[kPops + p], c[2 * kPops + p], 0.f, 0.f, 0.f};
  const float* yb = y + (size_t)b * kState;
  float dv, da, dr;
  drift_pop(yb[p], yb[kPops + p], yb[2 * kPops + p], s[(size_t)b * kPops + p], w_row, pc,
            sc, dv, da, dr);
  if (lane < kPops) {
    float* ob = out + (size_t)b * kState;
    ob[p] = dv;
    ob[kPops + p] = da;
    ob[2 * kPops + p] = dr;
  }
}

// Forward SRA1 rollout over the whole horizon (the Pallas _rollout_kernel):
//   f1 = f(y_i, s_i);  h2 = y_i + 0.75 h f1 + 1.5 (I10/h) g
//   f2 = f(h2, s_i + 0.75 (s_{i+1} - s_i));  y_{i+1} = y_i + h (f1/3 + 2 f2/3) + I1 g
// Layouts are time-major: stim (T, B, 16), i1/i10 (T-1, B), out (T, B, 48).
__global__ void wta_rollout_fwd_kernel(int T, int B, float h, Scalars sc,
                                       const float* __restrict__ w,
                                       const float* __restrict__ c,
                                       const float* __restrict__ g,
                                       const float* __restrict__ y0,
                                       const float* __restrict__ stim,
                                       const float* __restrict__ i1,
                                       const float* __restrict__ i10,
                                       float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int p = lane & (kPops - 1);
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // warp-uniform
  const bool writer = lane < kPops;
  float w_row[kPops];
#pragma unroll
  for (int q = 0; q < kPops; ++q) w_row[q] = w[p * kPops + q];
  const PopConsts pc = load_consts(c, g, p);

  float v = y0[(size_t)b * kState + p];
  float a = y0[(size_t)b * kState + kPops + p];
  float r = y0[(size_t)b * kState + 2 * kPops + p];
  if (writer) {
    out[(size_t)b * kState + p] = v;
    out[(size_t)b * kState + kPops + p] = a;
    out[(size_t)b * kState + 2 * kPops + p] = r;
  }
  const int n_steps = T - 1;
  float s0 = stim[(size_t)b * kPops + p];
  float s1 = stim[((size_t)min(1, T - 1) * B + b) * kPops + p];
  float n1 = n_steps > 0 ? i1[b] : 0.0f;
  float n10 = n_steps > 0 ? i10[b] : 0.0f;
  const float h075 = 0.75f * h;
  for (int i = 0; i < n_steps; ++i) {
    // Next step's inputs, loaded now and first read one step later.
    const float s2 = stim[((size_t)min(i + 2, T - 1) * B + b) * kPops + p];
    const int in = min(i + 1, n_steps - 1);
    const float n1_next = i1[(size_t)in * B + b];
    const float n10_next = i10[(size_t)in * B + b];

    const float s_mid = s0 + 0.75f * (s1 - s0);
    const float i10_h = n10 / h;
    float f1v, f1a, f1r;
    drift_pop(v, a, r, s0, w_row, pc, sc, f1v, f1a, f1r);
    const float k = 1.5f * i10_h;
    const float h2v = v + h075 * f1v + k * pc.gv;
    const float h2a = a + h075 * f1a + k * pc.ga;
    const float h2r = r + h075 * f1r + k * pc.gr;
    float f2v, f2a, f2r;
    drift_pop(h2v, h2a, h2r, s_mid, w_row, pc, sc, f2v, f2a, f2r);
    v = v + h * (f1v / 3.0f + 2.0f * f2v / 3.0f) + n1 * pc.gv;
    a = a + h * (f1a / 3.0f + 2.0f * f2a / 3.0f) + n1 * pc.ga;
    r = r + h * (f1r / 3.0f + 2.0f * f2r / 3.0f) + n1 * pc.gr;
    if (writer) {
      float* o = out + ((size_t)(i + 1) * B + b) * kState;
      o[p] = v;
      o[kPops + p] = a;
      o[2 * kPops + p] = r;
    }
    s0 = s1;
    s1 = s2;
    n1 = n1_next;
    n10 = n10_next;
  }
}

// Reverse sweep over K steps (the Pallas _rollout_bwd_kernel). Given
// c = cot(y_{i+1}) it recomputes f1 and h2 from the stored y_i, then
//   f2_bar = (2h/3) c;          (h2_bar, wb2) = f^T|_{h2} f2_bar
//   f1_bar = (h/3) c + 0.75 h h2_bar;  (y_bar, wb1) = f^T|_{y_i} f1_bar
//   cot(y_i) = c + h2_bar + y_bar + ysbar[i]
// stim (K+1, B, 16) (row K is not read: the VJP does not depend on the
// stimulus), i10 (K, B), ys/ysbar (K, B, 48), cin = cot(y_K) (B, 48).
// Writes cout = cot(y_0) (B, 48) and this lane's w_bar partial
// wpart (B, 16, 16), which wta_wbar_reduce sums over the batch.
__global__ void wta_rollout_bwd_kernel(int K, int B, float h, Scalars sc,
                                       const float* __restrict__ w,
                                       const float* __restrict__ c,
                                       const float* __restrict__ g,
                                       const float* __restrict__ stim,
                                       const float* __restrict__ i10,
                                       const float* __restrict__ ys,
                                       const float* __restrict__ ysbar,
                                       const float* __restrict__ cin,
                                       float* __restrict__ cout,
                                       float* __restrict__ wpart) {
  const int lane = threadIdx.x & 31;
  const int p = lane & (kPops - 1);
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // warp-uniform
  float w_row[kPops], w_col[kPops], wacc[kPops];
#pragma unroll
  for (int q = 0; q < kPops; ++q) {
    w_row[q] = w[p * kPops + q];
    w_col[q] = w[q * kPops + p];
    wacc[q] = 0.0f;
  }
  const PopConsts pc = load_consts(c, g, p);
  float cv = cin[(size_t)b * kState + p];
  float ca = cin[(size_t)b * kState + kPops + p];
  float cr = cin[(size_t)b * kState + 2 * kPops + p];
  const float h075 = 0.75f * h;
  const float c2 = 2.0f * h / 3.0f;
  const float c1 = h / 3.0f;

  // Step K-1's inputs; inside the loop the next (earlier) step's are
  // loaded one iteration ahead.
  int k = K - 1;
  size_t row = ((size_t)max(k, 0) * B + b);
  float yv = 0.f, ya = 0.f, yr = 0.f, bv = 0.f, ba = 0.f, br = 0.f, s0 = 0.f, n10 = 0.f;
  if (K > 0) {
    yv = ys[row * kState + p];
    ya = ys[row * kState + kPops + p];
    yr = ys[row * kState + 2 * kPops + p];
    bv = ysbar[row * kState + p];
    ba = ysbar[row * kState + kPops + p];
    br = ysbar[row * kState + 2 * kPops + p];
    s0 = stim[row * kPops + p];
    n10 = i10[row];
  }
  for (; k >= 0; --k) {
    const size_t nrow = (size_t)max(k - 1, 0) * B + b;
    const float yv_n = ys[nrow * kState + p];
    const float ya_n = ys[nrow * kState + kPops + p];
    const float yr_n = ys[nrow * kState + 2 * kPops + p];
    const float bv_n = ysbar[nrow * kState + p];
    const float ba_n = ysbar[nrow * kState + kPops + p];
    const float br_n = ysbar[nrow * kState + 2 * kPops + p];
    const float s0_n = stim[nrow * kPops + p];
    const float n10_n = i10[nrow];

    // Recompute the first stage and the second stage's state.
    const float i10_h = n10 / h;
    float f1v, f1a, f1r;
    drift_pop(yv, ya, yr, s0, w_row, pc, sc, f1v, f1a, f1r);
    const float kk = 1.5f * i10_h;
    const float h2v = yv + h075 * f1v + kk * pc.gv;
    const float h2a = ya + h075 * f1a + kk * pc.ga;

    float h2bv, h2ba, h2br;
    drift_vjp_pop(h2v, h2a, c2 * cv, c2 * ca, c2 * cr, w_col, pc, sc, wacc, h2bv, h2ba,
                  h2br);
    float ybv, yba, ybr;
    drift_vjp_pop(yv, ya, c1 * cv + h075 * h2bv, c1 * ca + h075 * h2ba,
                  c1 * cr + h075 * h2br, w_col, pc, sc, wacc, ybv, yba, ybr);
    cv = cv + h2bv + ybv + bv;
    ca = ca + h2ba + yba + ba;
    cr = cr + h2br + ybr + br;

    yv = yv_n; ya = ya_n; yr = yr_n;
    bv = bv_n; ba = ba_n; br = br_n;
    s0 = s0_n; n10 = n10_n;
  }
  if (lane < kPops) {
    cout[(size_t)b * kState + p] = cv;
    cout[(size_t)b * kState + kPops + p] = ca;
    cout[(size_t)b * kState + 2 * kPops + p] = cr;
    float* wp = wpart + ((size_t)b * kPops + p) * kPops;
#pragma unroll
    for (int q = 0; q < kPops; ++q) wp[q] = wacc[q];
  }
}

// w_bar[p, q] = sum_b wpart[b, p, q], summed in lane order b = 0..B-1 by one
// thread per entry: deterministic, no atomics.
__global__ void wta_wbar_reduce_kernel(int B, const float* __restrict__ wpart,
                                       float* __restrict__ wbar) {
  const int e = threadIdx.x;
  float acc = 0.0f;
  for (int b = 0; b < B; ++b) acc += wpart[(size_t)b * kPops * kPops + e];
  wbar[e] = acc;
}

inline int blocks_for(int B) { return (B + kWarpsPerBlock - 1) / kWarpsPerBlock; }

}  // namespace

extern "C" {

int cf_wta_drift(int B, float tau_s, float tau_m, float tau_a, float R, const float* y,
                 const float* s, const float* w, const float* c, float* out, void* stream) {
  const Scalars sc{tau_s, tau_m, tau_a, R};
  wta_drift_kernel<<<blocks_for(B), 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
      B, sc, y, s, w, c, out);
  return (int)cudaGetLastError();
}

int cf_wta_rollout_fwd(int T, int B, float h, float tau_s, float tau_m, float tau_a, float R,
                       const float* w, const float* c, const float* g, const float* y0,
                       const float* stim, const float* i1, const float* i10, float* out,
                       void* stream) {
  const Scalars sc{tau_s, tau_m, tau_a, R};
  wta_rollout_fwd_kernel<<<blocks_for(B), 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
      T, B, h, sc, w, c, g, y0, stim, i1, i10, out);
  return (int)cudaGetLastError();
}

int cf_wta_rollout_bwd(int K, int B, float h, float tau_s, float tau_m, float tau_a, float R,
                       const float* w, const float* c, const float* g, const float* stim,
                       const float* i10, const float* ys, const float* ysbar, const float* cin,
                       float* cout, float* wpart, void* stream) {
  const Scalars sc{tau_s, tau_m, tau_a, R};
  wta_rollout_bwd_kernel<<<blocks_for(B), 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
      K, B, h, sc, w, c, g, stim, i10, ys, ysbar, cin, cout, wpart);
  return (int)cudaGetLastError();
}

int cf_wta_wbar_reduce(int B, const float* wpart, float* wbar, void* stream) {
  wta_wbar_reduce_kernel<<<1, kPops * kPops, 0, (cudaStream_t)stream>>>(B, wpart, wbar);
  return (int)cudaGetLastError();
}

}  // extern "C"
