// Column-network SDE kernels for Hopper (sm_90a): the adaptive step-size
// selection pass, the replay over the frozen step grids, and the replay's
// reverse sweep of the state cotangent. Plain C entry points, loaded with
// ctypes by columnflow_torch/kernels/_build.py; each returns
// cudaGetLastError().
//
// Replaces (columnflow/solvers/):
//   cf_sde_select      <- sde_adaptive.py _make_sde_adaptive_kernel (B5): the
//                         whole selection while-loop of one lane on the krng
//                         tree; and, on the jax.random tree, the XLA
//                         selection (_adaptive_pass, no Pallas kernel). One
//                         block per lane: the wrapper's route "block", the
//                         yardstick of sde_select_team.cu's cluster teams
//   cf_sde_attempt     <- the same body, one controller attempt per record
//                         (a second entry point, for testing the body)
//   cf_sde_replay_fwd  <- fused.py _make_sde_chunk_kernel, variable_h="lanes"
//                         (B3): SRA1 over each lane's frozen half-step grid,
//                         a cluster team per lane (replay2_team.cuh)
//   cf_sde_replay_bwd  <- fused.py _make_sde_bwd_chunk_kernel, emit_steps,
//                         lanes (B4): the step VJP w.r.t. the state, emitting
//                         each step's total cotangent (seed), the same teams
//   cf_sde2_fwd_team8, cf_sde2_bwd_team8
//                      <- B3 and B4 as B3t-team's and B4t's bodies on the
//                         two-term split (teams of 8 blocks, the terms in
//                         L2): a yardstick for the cluster teams, on no path
//   cf_sde3_fwd        <- _make_sde_chunk_kernel on the three-term split,
//                         lanes or the uniform grid (B3t)
//   cf_sde3_bwd        <- _make_sde_bwd_chunk_kernel in kernel mode on the
//                         three-term split (B4't): the state cotangent and the
//                         wT / iwT cotangents in the kernel
//   cf_sde3_fwd_team   <- B3t as a team of blocks per lane (B3t-team), for
//                         widths whose three-term weights do not fit a block
//   cf_sde3_bwd_emit   <- _make_sde_bwd_chunk_kernel, emit_steps, on the
//                         three-term split (B4t): the state cotangent alone
//                         and each step's total output cotangent (seed), a
//                         team of blocks per lane
//   cf_sde3_bwd_team   <- B4't as one team of blocks for the whole batch
//                         (B4't-team), for widths whose three-term weights and
//                         batch do not fit a block (through 63 columns)
//   cf_sde2_bwd        <- _make_sde_bwd_chunk_kernel in kernel mode on the
//                         two-term split (B4s: prepare_premixed_split2 without
//                         the gradbf16 substitute, through 63 columns), the
//                         same team kernel
// and cf_sde_select / cf_sde_attempt on the three-term split (kSplit3, B5t):
// _make_sde_adaptive_kernel with select_prepare=prepare_premixed_split.
// The JAX kernels trace any drift; these are written for the premixed
// column-network drift (network_drift_premixed) with a knot stimulus and
// constant diffusion: select16 (bf16) or float32 weights in the selection,
// the split2 weights (bf16 hi + mid) in the replay and its emit-mode sweep,
// the three-term split (split3_drift.cuh) in B3t and B4't.
//
// What bounds them on this card: long serial chains. The selection runs
// ~10^4 controller attempts per lane, each 5 drift evaluations (one
// (P, P) bf16 matrix-vector product each) and 2 Brownian-tree walks; the
// replay ~1.4 * 10^4 half steps of 2 drift evaluations (3 products each),
// the reverse sweep 7 products per half step. The work per step is a few
// MFLOP, microseconds of the card's peak, and each step waits for the
// previous one. The selection runs one thread block per lane, 512 threads,
// the state and every intermediate in shared memory, the weights read from
// L2 at every product; lanes run in parallel on separate SMs. The split2
// replay and its emit-mode sweep spread each lane over a cluster of 8 or 16
// blocks, each holding its columns of the two terms in shared memory
// (replay2_team.cuh). The three-term sweeps serve the small
// widths (13 columns: 2 * 10^3 to 10^4 steps of 104 populations): the
// split weights in shared memory (65 KB at P = 104), B3t one block per
// lane, B4't the batch in one block, because jax.vjp contracts each
// product's weight cotangent over the lanes before rounding it to bf16.
// From ~24 columns the three-term weights (6 P^2 bytes) no longer fit a
// block: B3t-team and B4t run each lane on a team of 8 blocks (team.cuh),
// the six bf16 (P, P) terms and transposes streamed from L2 (8.3 MB at
// P = 832), the lane's state vectors in global memory. B4t forms no weight
// cotangent, so its lanes are independent: the weight gradients are taken
// outside the kernel from the seeds it emits (solvers/fused.py
// outer_arg_grads_split3). Where the weights hold at most 1 MiB (through 63
// columns) the JAX package forms them in the sweep: past one block's
// capacity (~20 columns at 4 lanes) B4't-team runs the batch on one team,
// each block forming the weight cotangents of its own output columns.
//
// Precision. Elementwise arithmetic is float32 with full-precision
// expf/tanhf/logf/sqrtf and IEEE division, compiled with -fmad=false so
// that every operation rounds as in the plain PyTorch version (and in the
// JAX package): no multiply-add contracts. Time arithmetic in particular
// must round exactly as the replay's does, since a time's float32 value
// keys the interval normals. Every matrix product is summed in float64 and
// rounded to float32 once; its products of bf16 (or float32) operands are
// exact in float64, so the kernel's value and the plain version's
// (torch float64 matmul) agree bit for bit apart from rare ties, and the
// bf16 roundings of the reverse sweep's cotangents round the same way.

#include "replay2_team.cuh"
#include "sde_select.cuh"
#include "split3_drift.cuh"
#include "team.cuh"

namespace {

// Shared-memory scratch of one drift evaluation.
struct Scratch {
  float* fr;   // (P) rates
  float* xa;   // (P) bf16(rates), or split3's hi term
  float* xb;   // (P) split3's mid term
  float* aux;  // (P) split3's lo term
  float* ext;  // (n_in) stimulus
  double* red; // (kThreads / 32) reduction partials
  float* scal; // (8) broadcast scalars
  float* zb;   // (2 (kMaxDepth + 1)) the jax tree's normals of two queries
};

// The selection drift's weight formats: the bf16 copy (select16: rec =
// bf16(fr) W16, e = bf16(ext) iwT16), float32 weights (the f32 selection
// drift network_drift_premixed: rec = fr wT, e = ext iwT), and the
// three-term split (split3: w0 holds the bf16 terms hi, mid, lo of
// prepare_premixed_split one after the other; rec = x_hi W_lo + x_mid W_mid
// + x_lo W_hi + x_hi W_mid + x_mid W_hi + x_hi W_hi, left to right, the
// order of split3_drift.cuh's drift3; e = ext iwT). Code 1 was the replay's
// two-term split, now replay2_team.cuh's.
enum Mode { kSel16 = 0, kF32 = 2, kSplit3 = 3 };

// One drift evaluation of lane b at time t, state y -> out (all 3P), by the
// whole block, with the weights w0 and iw in kMode's format. Ends with a
// barrier.
template <int kMode>
__device__ void drift(const Net& n, int b, float t, const float* y, float* out,
                      const void* __restrict__ w0, const void* __restrict__ iw,
                      const Scratch& s) {
  const int P = n.P;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const float fr = firing_rate(y[i] - y[P + i]);
    s.fr[i] = fr;
    if (kMode == kF32) {
      s.xa[i] = fr;
    } else if (kMode == kSplit3) {
      split3(fr, s.xa[i], s.xb[i], s.aux[i]);
    } else {
      s.xa[i] = bf16r(fr);
    }
  }
  if (threadIdx.x < n.n_in) {
    const float e = knot_interp(n, b, threadIdx.x, t);
    s.ext[threadIdx.x] = kMode == kSel16 ? bf16r(e) : e;
  }
  __syncthreads();
  const size_t PP2 = (size_t)P * (P / 2);  // bf16 pairs of one (P, P) term
  for (int c = threadIdx.x; c < P / 2; c += blockDim.x) {
    double p1a = 0.0, p1b = 0.0, p2a = 0.0, p2b = 0.0, p3a = 0.0, p3b = 0.0;
    double p4a = 0.0, p4b = 0.0, p5a = 0.0, p5b = 0.0, p6a = 0.0, p6b = 0.0;
    const __nv_bfloat162* wr0 = reinterpret_cast<const __nv_bfloat162*>(w0) + c;
    const __nv_bfloat162* wr1 = wr0 + PP2;      // split3's mid term
    const __nv_bfloat162* wr2 = wr0 + 2 * PP2;  // split3's lo term
    const float2* wf = reinterpret_cast<const float2*>(w0) + c;
    for (int k = 0; k < P; ++k) {
      const float2 wh = kMode == kF32 ? wf[(size_t)k * (P / 2)]
                                      : __bfloat1622float2(wr0[(size_t)k * (P / 2)]);
      const double xa = s.xa[k];
      if (kMode == kSplit3) {
        const float2 wm = __bfloat1622float2(wr1[(size_t)k * (P / 2)]);
        const float2 wl = __bfloat1622float2(wr2[(size_t)k * (P / 2)]);
        const double xb = s.xb[k], xc = s.aux[k];
        p1a += xa * (double)wl.x;
        p1b += xa * (double)wl.y;
        p2a += xb * (double)wm.x;
        p2b += xb * (double)wm.y;
        p3a += xc * (double)wh.x;
        p3b += xc * (double)wh.y;
        p4a += xa * (double)wm.x;
        p4b += xa * (double)wm.y;
        p5a += xb * (double)wh.x;
        p5b += xb * (double)wh.y;
        p6a += xa * (double)wh.x;
        p6b += xa * (double)wh.y;
        continue;
      }
      p1a += xa * (double)wh.x;
      p1b += xa * (double)wh.y;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = 2 * c + j;
      float rec = (float)(j ? p1b : p1a);
      if (kMode == kSplit3)
        rec = (((((float)(j ? p1b : p1a) + (float)(j ? p2b : p2a)) + (float)(j ? p3b : p3a))
                + (float)(j ? p4b : p4a)) + (float)(j ? p5b : p5a)) + (float)(j ? p6b : p6a);
      double e = 0.0;
      for (int m = 0; m < n.n_in; ++m) {
        const float w = kMode == kSel16
                            ? __bfloat162float(static_cast<const bf16*>(iw)[(size_t)m * P + col])
                            : static_cast<const float*>(iw)[(size_t)m * P + col];
        e += (double)s.ext[m] * (double)w;
      }
      const float current = (rec + (float)e) + n.bg[col];
      const float total = current * n.tau_s;
      out[col] = (-y[col] + total * n.R) / n.tau_m;
      out[P + col] = (-y[P + col] + n.adapt[col] * s.fr[col]) / n.tau_a;
      out[2 * P + col] = (-y[2 * P + col] + s.fr[col]) / n.tau_s;
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The selection: SRA1 step doubling, RMS error, PI controller
// ---------------------------------------------------------------------------

struct SelBuf {
  float *y, *f1, *g1, *hst, *f, *yf, *yh, *yn;  // (3P) each
};

// h2 = (y + (0.75 h) f) + (1.5 i10h) sigma
__device__ __forceinline__ void stage2_state(int S, const float* y, const float* f, float h,
                                             float i10h, float sigma, float* out) {
  const float a = 0.75f * h, k = 1.5f * i10h;
  for (int i = threadIdx.x; i < S; i += blockDim.x) out[i] = (y[i] + a * f[i]) + k * sigma;
}

// One step-doubling attempt from (t, y) with step h and W(t) = w0: writes the
// two-half-step solution into buf.yn, returns the scaled RMS error and W(t+h).
template <int kTree, int kMode>
__device__ float attempt(const Net& n, const Sel& sel, int b, const uint32_t* kw, float t, float h,
                         float w0, const void* w, const void* iw, const SelBuf& u,
                         const Scratch& s, float& w1_out) {
  const int S = 3 * n.P;
  const float tm = t + 0.5f * h;
  const float te = t + h;
  const float hh = 0.5f * h;
  draw_noise<kTree>(sel, kw, t, tm, te, s.scal, s.zb);
  const float wm = s.scal[0], w1 = s.scal[1], za = s.scal[2], zb = s.scal[3];
  __syncthreads();
  w1_out = w1;
  const float dw_a = wm - w0, dw_b = w1 - wm;
  const float sq = sqrtf(hh / 12.0f);
  const float i10_a = hh * (0.5f * dw_a + sq * za);
  const float i10_b = hh * (0.5f * dw_b + sq * zb);
  const float i10_f = (i10_a + i10_b) + hh * dw_a;
  const float sg = n.sigma;

  // Full step.
  drift<kMode>(n, b, t, u.y, u.f1, w, iw, s);
  const float i10h_f = i10_f / (h > 0.0f ? h : 1.0f);
  stage2_state(S, u.y, u.f1, h, i10h_f, sg, u.hst);
  __syncthreads();
  drift<kMode>(n, b, t + 0.75f * h, u.hst, u.f, w, iw, s);
  const float dw_f = dw_a + dw_b;
  for (int i = threadIdx.x; i < S; i += blockDim.x)
    u.yf[i] = sra1_final(u.y[i], u.f1[i], u.f[i], h, dw_f, i10h_f, sg);
  // First half step (shares f1).
  const float i10h_a = i10_a / (hh > 0.0f ? hh : 1.0f);
  stage2_state(S, u.y, u.f1, hh, i10h_a, sg, u.hst);
  __syncthreads();
  drift<kMode>(n, b, t + 0.75f * hh, u.hst, u.f, w, iw, s);
  for (int i = threadIdx.x; i < S; i += blockDim.x)
    u.yh[i] = sra1_final(u.y[i], u.f1[i], u.f[i], hh, dw_a, i10h_a, sg);
  __syncthreads();
  // Second half step from t + h/2.
  const float th = t + 0.5f * h;
  drift<kMode>(n, b, th, u.yh, u.g1, w, iw, s);
  const float i10h_b = i10_b / (hh > 0.0f ? hh : 1.0f);
  stage2_state(S, u.yh, u.g1, hh, i10h_b, sg, u.hst);
  __syncthreads();
  drift<kMode>(n, b, th + 0.75f * hh, u.hst, u.f, w, iw, s);
  double acc = 0.0;
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const float yn = sra1_final(u.yh[i], u.g1[i], u.f[i], hh, dw_b, i10h_b, sg);
    u.yn[i] = yn;
    const float q = (yn - u.yf[i]) / (sel.atol + sel.rtol * fmaxf(fabsf(u.y[i]), fabsf(yn)));
    acc += (double)(q * q);
  }
  const float mean = (float)block_sum(acc, s.red) / (float)S;
  return sqrtf(mean);
}

__device__ void carve(float* sm, int P, int n_in, SelBuf* u, Scratch* s) {
  const int S = 3 * P;
  float* p = sm;
  if (u) {
    u->y = p; p += S;
    u->f1 = p; p += S;
    u->g1 = p; p += S;
    u->hst = p; p += S;
    u->f = p; p += S;
    u->yf = p; p += S;
    u->yh = p; p += S;
    u->yn = p; p += S;
  }
  s->fr = p; p += P;
  s->xa = p; p += P;
  s->xb = p; p += P;
  s->aux = p; p += P;
  s->ext = p; p += kMaxInputs;
  s->scal = p; p += 8;
  s->zb = p; p += 2 * (kMaxDepth + 1);
  s->red = reinterpret_cast<double*>(p + ((uintptr_t)p & 4 ? 1 : 0));
}

size_t scratch_bytes(int P) {
  return sizeof(float) * (4 * (size_t)P + kMaxInputs + 8 + 2 * (kMaxDepth + 1) + 1)
         + sizeof(double) * (kThreads / 32);
}

// B5 (and the XLA selection): the whole selection loop of lane blockIdx.x.
template <int kTree, int kMode>
__global__ void __launch_bounds__(kThreads)
sde_select_kernel(Net n, Sel sel, const void* __restrict__ w, const void* __restrict__ iw,
                  const int* __restrict__ words, const float* __restrict__ y0,
                  float* __restrict__ st, int* __restrict__ stats) {
  extern __shared__ float sm[];
  SelBuf u;
  Scratch s;
  carve(sm, n.P, n.n_in, &u, &s);
  const int b = blockIdx.x, S = 3 * n.P, M = sel.max_steps;
  uint32_t kw[4];
  for (int j = 0; j < 4; ++j) kw[j] = (uint32_t)words[b * 4 + j];
  float* st_b = st + (size_t)b * (M + 1);
  for (int i = threadIdx.x; i <= M; i += blockDim.x) st_b[i] = sel.t_end;
  for (int i = threadIdx.x; i < S; i += blockDim.x) u.y[i] = y0[(size_t)b * S + i];
  if (threadIdx.x == 0) {
    st_b[0] = sel.t_start;
    s.scal[4] = lane_w<kTree>(sel, kw, sel.t_start);
  }
  __syncthreads();
  float w_t1 = s.scal[4];
  float t1 = sel.t_start, h = sel.h0, err_prev = 1.0f;
  int na = 0, nr = 0;
  __syncthreads();
  while (t1 < sel.t_end && na + nr < M) {
    float hc = fminf(h, sel.t_end - t1);
    hc = (t1 + hc) - t1;
    float w1;
    const float err = attempt<kTree, kMode>(n, sel, b, kw, t1, hc, w_t1, w, iw, u, s, w1);
    const Control c = control(sel, err, hc, err_prev);
    const float t_new = c.accept ? t1 + hc : t1;
    na += c.accept ? 1 : 0;
    nr += c.accept ? 0 : 1;
    if (threadIdx.x == 0) st_b[na] = t_new;
    if (c.accept) {
      for (int i = threadIdx.x; i < S; i += blockDim.x) u.y[i] = u.yn[i];
      err_prev = c.err_c;
      w_t1 = w1;
    }
    h = c.h_next;
    t1 = t_new;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    stats[b * 3 + 0] = na;
    stats[b * 3 + 1] = nr;
    stats[b * 3 + 2] = t1 >= sel.t_end ? 1 : 0;
  }
}

// One controller attempt per record r = blockIdx.x, from (t1, y1, h,
// err_prev, W(t1)): rec[r] = (err, accept, h used, h next, t new, W(t+h)),
// y_new[r] = the two-half-step solution.
template <int kTree, int kMode>
__global__ void __launch_bounds__(kThreads)
sde_attempt_kernel(Net n, Sel sel, const void* __restrict__ w, const void* __restrict__ iw,
                   const int* __restrict__ words, const float* __restrict__ t1s,
                   const float* __restrict__ y1, const float* __restrict__ hs,
                   const float* __restrict__ err_prev, const float* __restrict__ w_t1,
                   float* __restrict__ y_new, float* __restrict__ rec) {
  extern __shared__ float sm[];
  SelBuf u;
  Scratch s;
  carve(sm, n.P, n.n_in, &u, &s);
  const int r = blockIdx.x, S = 3 * n.P;
  uint32_t kw[4];
  for (int j = 0; j < 4; ++j) kw[j] = (uint32_t)words[r * 4 + j];
  for (int i = threadIdx.x; i < S; i += blockDim.x) u.y[i] = y1[(size_t)r * S + i];
  __syncthreads();
  const float t1 = t1s[r];
  float hc = fminf(hs[r], sel.t_end - t1);
  hc = (t1 + hc) - t1;
  float w1;
  const float err = attempt<kTree, kMode>(n, sel, r, kw, t1, hc, w_t1[r], w, iw, u, s, w1);
  const Control c = control(sel, err, hc, err_prev[r]);
  for (int i = threadIdx.x; i < S; i += blockDim.x) y_new[(size_t)r * S + i] = u.yn[i];
  if (threadIdx.x == 0) {
    float* o = rec + (size_t)r * 6;
    o[0] = err;
    o[1] = c.accept ? 1.0f : 0.0f;
    o[2] = hc;
    o[3] = c.h_next;
    o[4] = c.accept ? t1 + hc : t1;
    o[5] = w1;
  }
}

// ---------------------------------------------------------------------------
// The three-term sweeps: SRA1 on the three-term split over each lane's grid
// (B3t) and its reverse sweep with the weight cotangents in the kernel
// (B4't). The weights are split from the float32 wT into shared memory when
// the kernel starts (split3_drift.cuh), as the f32-exact dopri5 kernels do.
// ---------------------------------------------------------------------------

// The step grid: per lane (lanes: t0s, hs (n, B)) or one for every lane
// (the uniform grid: t0s, hs (n,)); i1, i10 (n, B) per lane.
struct Grid3 {
  int n_steps, n_real, lanes;
  const float *t0s, *hs, *i1, *i10;
  __device__ __forceinline__ size_t at(int k, int b, int B) const {
    return lanes ? (size_t)k * B + b : (size_t)k;
  }
};

// B3t: lane b = blockIdx.x. ys[0] = y0, ys[k + 1] after step k; rows past
// n_real hold the carried state (h == 0 padding is a no-op).
__global__ void __launch_bounds__(kThreads)
sde3_fwd_kernel(Net n, Grid3 g, const float* __restrict__ wT, const float* __restrict__ iwT,
                const float* __restrict__ y0, float* __restrict__ ys) {
  extern __shared__ float sm[];
  W3 w;
  Scr s;
  const int P = n.P, S = 3 * P, B = n.B, b = blockIdx.x;
  Carve c{setup(sm, n, 1, wT, iwT, &w, &s)};
  float* y = c.take(S);
  float* f1 = c.take(S);
  float* h2 = c.take(S);
  float* f2 = c.take(S);
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    y[i] = y0[(size_t)b * S + i];
    ys[(size_t)b * S + i] = y[i];
  }
  __syncthreads();
  for (int k = 0; k < g.n_real; ++k) {
    const float t0 = g.t0s[g.at(k, b, B)], h = g.hs[g.at(k, b, B)];
    const float di1 = g.i1[(size_t)k * B + b];
    const float i10h = g.i10[(size_t)k * B + b] / (h > 0.0f ? h : 1.0f);
    drift3(n, b, 1, t0, y, f1, w, s);
    stage2_state(S, y, f1, h, i10h, n.sigma, h2);
    __syncthreads();
    drift3(n, b, 1, t0 + 0.75f * h, h2, f2, w, s);
    float* out = ys + ((size_t)(k + 1) * B + b) * S;
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      y[i] = sra1_final(y[i], f1[i], f2[i], h, di1, i10h, n.sigma);
      out[i] = y[i];
    }
    __syncthreads();
  }
  for (int k = g.n_real; k < g.n_steps; ++k) {
    float* out = ys + ((size_t)(k + 1) * B + b) * S;
    for (int i = threadIdx.x; i < S; i += blockDim.x) out[i] = y[i];
  }
}

// B4't: the batch in one block (jax.vjp contracts each product's weight
// cotangent over the lanes before its bf16 rounding). Over steps
// n_real-1..0, with c = ybar + ysbar[k] and lane b's t0, h, i10h:
//   f1 = f(t0, y);  h2 = (y + (0.75 h) f1) + (1.5 i10h) sigma
//   c_h2 = f^T|_{t0 + 0.75 h, h2} (((h c) / 3) 2)          (weights: assign)
//   c_y  = f^T|_{t0, y} ((h c) / 3 + (0.75 h) c_h2)         (weights: add)
//   ybar = (c + c_h2) + c_y, zeroed after every step k with k % stride == 0.
// Each step's bf16 accumulators fold through the split once into a float32
// chunk sum; the chunk sum is added to d_wT after the chunk's first step
// (k % chunk == 0), as the JAX kernel sums each chunk's steps and then the
// chunks. The same for d_iwT (float32 throughout).
__global__ void __launch_bounds__(kThreads)
sde3_bwd_kernel(Net n, Grid3 g, int stride, int chunk, const float* __restrict__ wT,
                const float* __restrict__ iwT, const float* __restrict__ ys_prev,
                const float* __restrict__ ysbar, float* __restrict__ ybar_out,
                float* __restrict__ d_wT, float* __restrict__ d_iwT, float* __restrict__ work) {
  extern __shared__ float sm[];
  W3 w;
  Scr s;
  const int P = n.P, B = n.B, S = 3 * P, N = B * S, PP = P * P, NI = n.n_in * P;
  Carve c{setup(sm, n, B, wT, iwT, &w, &s)};
  float* y = c.take(N);
  float* f1 = c.take(N);
  float* h2 = c.take(N);
  float* cc = c.take(N);
  float* cw = c.take(N);
  float* ch2 = c.take(N);
  float* cy = c.take(N);
  float* yb = c.take(N);
  float* tl = c.take(B);   // lane times t0
  float* t2 = c.take(B);   // t0 + 0.75 h
  float* hl = c.take(B);   // h
  float* ih = c.take(B);   // i10 / h
  float* chunk_iw = c.take(NI);
  const WAcc acc{work, work + PP, work + 2 * PP, c.take(NI)};
  float* chunk_w = work + 3 * PP;
  for (int e = threadIdx.x; e < PP; e += blockDim.x) {
    d_wT[e] = 0.0f;
    chunk_w[e] = 0.0f;
  }
  for (int e = threadIdx.x; e < NI; e += blockDim.x) {
    d_iwT[e] = 0.0f;
    chunk_iw[e] = 0.0f;
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x) yb[i] = 0.0f;
  __syncthreads();
  for (int k = g.n_real - 1; k >= 0; --k) {
    if (threadIdx.x < B) {
      const int b = threadIdx.x;
      const float t0 = g.t0s[g.at(k, b, B)], h = g.hs[g.at(k, b, B)];
      tl[b] = t0;
      t2[b] = t0 + 0.75f * h;
      hl[b] = h;
      ih[b] = g.i10[(size_t)k * B + b] / (h > 0.0f ? h : 1.0f);
    }
    const float* yk = ys_prev + (size_t)k * N;
    const float* sbk = ysbar + (size_t)k * N;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      y[i] = yk[i];
      cc[i] = yb[i] + sbk[i];
    }
    __syncthreads();
    drift3(n, 0, B, 0.0f, y, f1, w, s, tl);
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const int b = i / S;
      const float h = hl[b];
      h2[i] = (y[i] + (0.75f * h) * f1[i]) + (1.5f * ih[b]) * n.sigma;
      cw[i] = ((h * cc[i]) / 3.0f) * 2.0f;
    }
    __syncthreads();
    drift_vjp3(n, B, 0.0f, h2, cw, ch2, w, s, acc, true, t2);
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const float h = hl[i / S];
      cw[i] = (h * cc[i]) / 3.0f + (0.75f * h) * ch2[i];
    }
    __syncthreads();
    drift_vjp3(n, B, 0.0f, y, cw, cy, w, s, acc, false, tl);
    const bool cut = stride > 0 && k % stride == 0;
    for (int i = threadIdx.x; i < N; i += blockDim.x) yb[i] = cut ? 0.0f : (cc[i] + ch2[i]) + cy[i];
    const bool fold = k % chunk == 0;
    for (int e = threadIdx.x; e < PP; e += blockDim.x) {
      const float lo = acc.lo[e];
      const float r = lo + bf16r(acc.mid[e] - lo);
      const float sum = chunk_w[e] + (r + bf16r(acc.hi[e] + bf16r(-r)));
      if (fold) d_wT[e] = d_wT[e] + sum;
      chunk_w[e] = fold ? 0.0f : sum;
    }
    for (int e = threadIdx.x; e < NI; e += blockDim.x) {
      const float sum = chunk_iw[e] + acc.iw[e];
      if (fold) d_iwT[e] = d_iwT[e] + sum;
      chunk_iw[e] = fold ? 0.0f : sum;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x) ybar_out[i] = yb[i];
}

// ---------------------------------------------------------------------------
// The three-term sweeps as teams (team.cuh): lane blockIdx.x / kCluster, one
// team of kCluster blocks each, the split's terms in global memory (L2), the
// lane's state vectors in global scratch, each block touching its own
// populations' entries only.
// ---------------------------------------------------------------------------

// B3t-team: the step and the rows of sde3_fwd_kernel. scr: 4 (3P) floats
// per lane (y, f1, h2, f2). NT = 3: B3t-team; NT = 2: the same body on the
// two-term split, a yardstick for B3's cluster teams (cf_sde2_fwd_team8).
template <int NT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
sde3_fwd_team_kernel(Net n, Grid3 g, Wg w, const float* __restrict__ y0, float* scr,
                     float* __restrict__ ys) {
  extern __shared__ __align__(16) unsigned char smt[];
  Team T;
  const int b = blockIdx.x / kCluster;
  team_init(T, smt, n.P, 1, b, NT, NT == 3 ? 6 : 3, 1);
  const int P = n.P, S = T.S, B = n.B;
  float* y = scr + (size_t)b * 4 * S;
  float* f1 = y + S;
  float* h2 = f1 + S;
  float* f2 = h2 + S;
  for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
    const int off = own_off(T, P, e);
    y[off] = y0[(size_t)b * S + off];
    ys[(size_t)b * S + off] = y[off];
  }
  __syncthreads();
  for (int k = 0; k < g.n_real; ++k) {
    const float t0 = g.t0s[g.at(k, b, B)], h = g.hs[g.at(k, b, B)];
    const float di1 = g.i1[(size_t)k * B + b];
    const float i10h = g.i10[(size_t)k * B + b] / (h > 0.0f ? h : 1.0f);
    drift_team<NT, 1>(n, T, t0, y, f1, w);
    const float a = 0.75f * h, kk = 1.5f * i10h;
    for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
      const int off = own_off(T, P, e);
      h2[off] = (y[off] + a * f1[off]) + kk * n.sigma;
    }
    __syncthreads();
    drift_team<NT, 1>(n, T, t0 + 0.75f * h, h2, f2, w);
    float* out = ys + ((size_t)(k + 1) * B + b) * S;
    for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
      const int off = own_off(T, P, e);
      y[off] = sra1_final(y[off], f1[off], f2[off], h, di1, i10h, n.sigma);
      out[off] = y[off];
    }
    __syncthreads();
  }
  for (int k = g.n_real; k < g.n_steps; ++k) {
    float* out = ys + ((size_t)(k + 1) * B + b) * S;
    for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
      const int off = own_off(T, P, e);
      out[off] = y[off];
    }
  }
}

// B4t: the state-only reverse sweep (emit mode). Over steps n_real-1..0,
// with c = ybar + ysbar[k] written to seeds[k] (the total cotangent on step
// k's output) and lane b's t0, h, i10h:
//   f1 = f(t0, y);  h2 = (y + (0.75 h) f1) + (1.5 i10h) sigma
//   c_h2 = f^T|_{h2} (((h c) / 3) 2);  c_y = f^T|_y ((h c) / 3 + (0.75 h) c_h2)
//   ybar = (c + c_h2) + c_y, zeroed after every step k with k % stride == 0,
// the order of step_vjp_split3. Rows of seeds from n_real on are zero, as
// the JAX kernel zero-fills them. scr: 7 (3P) floats per lane. NT = 3: B4t;
// NT = 2: the same body on the two-term split (cf_sde2_bwd_team8).
template <int NT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
sde3_bwd_emit_kernel(Net n, Grid3 g, int stride, Wg w, const float* __restrict__ ys_prev,
                     const float* __restrict__ ysbar, float* scr, float* __restrict__ ybar_out,
                     float* __restrict__ seeds) {
  extern __shared__ __align__(16) unsigned char smt[];
  Team T;
  const int b = blockIdx.x / kCluster;
  team_init(T, smt, n.P, 1, b, NT, NT == 3 ? 6 : 3, 1);
  const int P = n.P, S = T.S, B = n.B;
  float* f1 = scr + (size_t)b * 7 * S;
  float* h2 = f1 + S;
  float* cc = h2 + S;
  float* cw = cc + S;
  float* ch2 = cw + S;
  float* cy = ch2 + S;
  float* yb = cy + S;
  for (int k = g.n_real; k < g.n_steps; ++k) {
    float* o = seeds + ((size_t)k * B + b) * S;
    for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) o[own_off(T, P, e)] = 0.0f;
  }
  for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) yb[own_off(T, P, e)] = 0.0f;
  __syncthreads();
  for (int k = g.n_real - 1; k >= 0; --k) {
    const float t0 = g.t0s[g.at(k, b, B)], h = g.hs[g.at(k, b, B)];
    const float i10h = g.i10[(size_t)k * B + b] / (h > 0.0f ? h : 1.0f);
    const size_t kb = ((size_t)k * B + b) * S;
    const float* y = ys_prev + kb;
    for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
      const int off = own_off(T, P, e);
      cc[off] = yb[off] + ysbar[kb + off];
      seeds[kb + off] = cc[off];
    }
    __syncthreads();
    drift_team<NT, 1>(n, T, t0, y, f1, w);
    const float a = 0.75f * h, kk = 1.5f * i10h;
    for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
      const int off = own_off(T, P, e);
      h2[off] = (y[off] + a * f1[off]) + kk * n.sigma;
      cw[off] = ((h * cc[off]) / 3.0f) * 2.0f;
    }
    __syncthreads();
    vjp_team<NT>(n, T, h2, cw, ch2, w);
    for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
      const int off = own_off(T, P, e);
      cw[off] = (h * cc[off]) / 3.0f + a * ch2[off];
    }
    __syncthreads();
    vjp_team<NT>(n, T, y, cw, cy, w);
    const bool cut = stride > 0 && k % stride == 0;
    for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
      const int off = own_off(T, P, e);
      yb[off] = cut ? 0.0f : (cc[off] + ch2[off]) + cy[off];
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
    const int off = own_off(T, P, e);
    ybar_out[(size_t)b * S + off] = yb[off];
  }
}

// B4't-team: B4't as one team of kCluster blocks for the whole batch, for
// widths whose three-term weights do not fit one block (sde3_bwd_route). The
// split's terms stay in L2, every lane's state vectors live in global scratch,
// block r owns populations [c0, c0 + nc) of every lane. The weight
// cotangents are the design problem: jax.vjp contracts each product's
// weight cotangent over the lanes before its bf16 rounding, so the lanes
// cannot run as independent teams as in B4t. Each block owns the
// weight-cotangent entries of its own OUTPUT populations (columns j) for
// every input row i: both VJPs of a step store the rates' three bf16 terms
// and the current's cotangent of their own populations into every block's
// shared memory (WX, one buffer per VJP), and after the step each block
// contracts, for its entries, the terms of row i against the cotangents of
// column j over the lanes in float64, in lane order, rounds to bf16, opens
// the step's accumulators with the second stage's products and adds the
// first stage's, folds once (split3_fold) and adds the fold to its chunk sum
// (global work). No value crosses a block boundary in a sum, so the result
// is B4't's and the plain version's bit for bit. d_iwT's columns the same
// way, in float32.

// Over steps n_real-1..0, as sde3_bwd_kernel. scr: 7 B 3P floats (f1, h2,
// c, cw, c_h2, c_y, ybar); work: P^2 + n_in P floats (the chunk sums of
// d_wT and d_iwT). team_bytes: the Team's shared memory (team_smem), after
// which lie the two WX buffers and the lanes' step scalars.
// NT = 3: B4't-team (prepare_premixed_split); NT = 2: B4s, the two-term
// split's kernel-mode sweep (prepare_premixed_split2: two bf16 terms of the
// rates, three products per drift, the accumulators hi and mid,
// split2_fold), at every width where the JAX package takes kernel mode
// (through 63 columns at 4 inputs); there is no one-block B4s.
template <int NT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
sde3_bwd_team_kernel(Net n, Grid3 g, int stride, int chunk, Wg w, int team_bytes,
                     const float* __restrict__ ys_prev, const float* __restrict__ ysbar,
                     float* scr, float* __restrict__ ybar_out, float* __restrict__ d_wT,
                     float* __restrict__ d_iwT, float* work) {
  extern __shared__ __align__(16) unsigned char smt[];
  Team T;
  const int B = n.B;
  team_init(T, smt, n.P, B, 0, NT, NT == 3 ? 6 : 3, 1);
  const int P = n.P, S = T.S, N = B * S, nc = T.nc, c0 = T.c0, NI = n.n_in;
  unsigned char* p = smt + team_bytes;
  const WX wx2 = wx_at(p, P, B);  // the second stage's VJP (at h2), met first
  p += wx_bytes(P, B);
  const WX wx1 = wx_at(p, P, B);  // the first stage's VJP (at y)
  p += wx_bytes(P, B);
  float* tl = reinterpret_cast<float*>(p);  // lane times t0
  float* t2 = tl + B;                       // t0 + 0.75 h
  float* hl = t2 + B;                       // h
  float* ih = hl + B;                       // i10 / h
  float* f1 = scr;
  float* h2 = f1 + N;
  float* cc = h2 + N;
  float* cw = cc + N;
  float* ch2 = cw + N;
  float* cy = ch2 + N;
  float* yb = cy + N;
  float* chunk_w = work;
  float* chunk_iw = work + (size_t)P * P;
  for (int e = threadIdx.x; e < P * nc; e += blockDim.x) {
    const int i = e / nc;
    const size_t at = (size_t)i * P + c0 + (e - i * nc);
    d_wT[at] = 0.0f;
    chunk_w[at] = 0.0f;
  }
  for (int e = threadIdx.x; e < NI * nc; e += blockDim.x) {
    const int m = e / nc;
    const size_t at = (size_t)m * P + c0 + (e - m * nc);
    d_iwT[at] = 0.0f;
    chunk_iw[at] = 0.0f;
  }
  for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) yb[own_off(T, P, e)] = 0.0f;
  __syncthreads();
  for (int k = g.n_real - 1; k >= 0; --k) {
    if (threadIdx.x < B) {
      const int b = threadIdx.x;
      const float t0 = g.t0s[g.at(k, b, B)], h = g.hs[g.at(k, b, B)];
      tl[b] = t0;
      t2[b] = t0 + 0.75f * h;
      hl[b] = h;
      ih[b] = g.i10[(size_t)k * B + b] / (h > 0.0f ? h : 1.0f);
    }
    const float* y = ys_prev + (size_t)k * N;
    const float* sbk = ysbar + (size_t)k * N;
    for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
      const int off = own_off(T, P, e);
      cc[off] = yb[off] + sbk[off];
    }
    __syncthreads();
    drift_team<NT, 1>(n, T, 0.0f, y, f1, w, tl);
    for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
      const int off = own_off(T, P, e);
      const int b = off / S;
      const float h = hl[b];
      h2[off] = (y[off] + (0.75f * h) * f1[off]) + (1.5f * ih[b]) * n.sigma;
      cw[off] = ((h * cc[off]) / 3.0f) * 2.0f;
    }
    __syncthreads();
    vjp_team_w<NT>(n, T, 0.0f, t2, h2, cw, ch2, w, wx2);
    for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
      const int off = own_off(T, P, e);
      const float h = hl[off / S];
      cw[off] = (h * cc[off]) / 3.0f + (0.75f * h) * ch2[off];
    }
    __syncthreads();
    vjp_team_w<NT>(n, T, 0.0f, tl, y, cw, cy, w, wx1);
    const bool cut = stride > 0 && k % stride == 0;
    for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
      const int off = own_off(T, P, e);
      yb[off] = cut ? 0.0f : (cc[off] + ch2[off]) + cy[off];
    }
    // The step's weight cotangents of the own columns, every row.
    const bool fold = k % chunk == 0;
    for (int e = threadIdx.x; e < P * nc; e += blockDim.x) {
      const int i = e / nc, j = c0 + (e - i * nc);
      float d[NT], acc[NT];
      wx_cot<NT>(wx2, B, P, i, j, d);
      acc_add<NT>(acc, d, true);
      wx_cot<NT>(wx1, B, P, i, j, d);
      acc_add<NT>(acc, d, false);
      const size_t at = (size_t)i * P + j;
      const float sum = chunk_w[at] + acc_fold<NT>(acc);
      if (fold) d_wT[at] = d_wT[at] + sum;
      chunk_w[at] = fold ? 0.0f : sum;
    }
    for (int e = threadIdx.x; e < NI * nc; e += blockDim.x) {
      const int m = e / nc, j = c0 + (e - m * nc);
      double d2 = 0.0, d1 = 0.0;
      for (int b = 0; b < B; ++b) {
        d2 += (double)wx2.ext[b * kMaxInputs + m] * (double)wx2.c[(size_t)b * P + j];
        d1 += (double)wx1.ext[b * kMaxInputs + m] * (double)wx1.c[(size_t)b * P + j];
      }
      const size_t at = (size_t)m * P + j;
      const float sum = chunk_iw[at] + ((float)d2 + (float)d1);
      if (fold) d_iwT[at] = d_iwT[at] + sum;
      chunk_iw[at] = fold ? 0.0f : sum;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
    const int off = own_off(T, P, e);
    ybar_out[off] = yb[off];
  }
}

// Launch kernel<kTree, kMode> for the tree (kKrng, kJax) and drift (kSel16,
// kF32; kSplit3 on the krng tree only, the in-kernel pass's) the host asks
// for; anything else is an invalid value.
template <template <int, int> class L, typename... A>
int dispatch_select(int tree, int mode, A... a) {
  if (tree == kKrng && mode == kSel16) return L<kKrng, kSel16>::run(a...);
  if (tree == kKrng && mode == kF32) return L<kKrng, kF32>::run(a...);
  if (tree == kJax && mode == kSel16) return L<kJax, kSel16>::run(a...);
  if (tree == kJax && mode == kF32) return L<kJax, kF32>::run(a...);
  if (tree == kKrng && mode == kSplit3) return L<kKrng, kSplit3>::run(a...);
  return (int)cudaErrorInvalidValue;
}

size_t select_bytes(int P) { return sizeof(float) * 8 * 3 * (size_t)P + scratch_bytes(P); }

template <int kTree, int kMode>
struct SelectLaunch {
  static int run(int B, Net n, Sel sel, const void* w, const void* iw, const int* words,
                 const float* y0, float* st, int* stats, cudaStream_t stream) {
    const size_t bytes = select_bytes(n.P);
    if (int e = set_smem(sde_select_kernel<kTree, kMode>, bytes)) return e;
    sde_select_kernel<kTree, kMode><<<B, kThreads, bytes, stream>>>(n, sel, w, iw, words, y0, st,
                                                                     stats);
    return (int)cudaGetLastError();
  }
};

template <int kTree, int kMode>
struct AttemptLaunch {
  static int run(int N, Net n, Sel sel, const void* w, const void* iw, const int* words,
                 const float* t1, const float* y1, const float* h, const float* err_prev,
                 const float* w_t1, float* y_new, float* rec, cudaStream_t stream) {
    const size_t bytes = select_bytes(n.P);
    if (int e = set_smem(sde_attempt_kernel<kTree, kMode>, bytes)) return e;
    sde_attempt_kernel<kTree, kMode><<<N, kThreads, bytes, stream>>>(
        n, sel, w, iw, words, t1, y1, h, err_prev, w_t1, y_new, rec);
    return (int)cudaGetLastError();
  }
};

// The kernel-mode sweep as one team for the batch: NT = 3 (B4't-team) or 2
// (B4s); lo, loT unused at NT = 2.
template <int NT>
int bwd_team(int B, int P, int n_in, int K, const float* hc, int n_steps, int n_real, int lanes,
             int stride, int chunk, const float* bg, const float* adapt, const void* hi,
             const void* mid, const void* lo, const void* hiT, const void* midT, const void* loT,
             const float* iwT, const float* kv, const float* t0s, const float* hs,
             const float* i10, const float* ys_prev, const float* ysbar, float* scr, float* ybar,
             float* d_wT, float* d_iwT, float* work, void* stream) {
  if (int e = check_shape(P, n_in, K)) return e;
  if (P % kCluster || chunk < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const size_t team = team_smem(P, B, NT, NT == 3 ? 6 : 3, 1);
  const size_t bytes = team + 2 * wx_bytes(P, B) + 4 * sizeof(float) * (size_t)B;
  if (int e = set_smem(sde3_bwd_team_kernel<NT>, bytes)) return e;
  const Wg w{(const bf16*)hi, (const bf16*)mid, NT == 3 ? (const bf16*)lo : nullptr,
             (const bf16*)hiT, (const bf16*)midT, NT == 3 ? (const bf16*)loT : nullptr, iwT};
  const Grid3 g{n_steps, n_real, lanes, t0s, hs, nullptr, i10};
  sde3_bwd_team_kernel<NT><<<kCluster, kThreads, bytes, (cudaStream_t)stream>>>(
      make_net(B, P, n_in, K, hc, bg, adapt, kv), g, stride, chunk, w, (int)team, ys_prev,
      ysbar, scr, ybar, d_wT, d_iwT, work);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// hc (host): tau_s, tau_m, tau_a, R, sigma, kc0[K-1], kd[K-1];
// hs (host): t_start, t_end, rtol, atol, h0, dt_min; tree: 0 krng, 1 jax;
// mode: 0 select16 (w, iw bf16), 2 float32 (w, iw float32), 3 split3 (w the
// bf16 terms hi, mid, lo, 3 P^2 values in that order; iw float32; krng only).
int cf_sde_select(int B, int P, int n_in, int K, const float* hc, const float* hs, int max_steps,
                  int depth, int tree, int mode, const float* bg, const float* adapt,
                  const void* w, const void* iw, const float* kv, const int* words,
                  const float* y0, float* st, int* stats, void* stream) {
  if (int e = check_shape(P, n_in, K)) return e;
  if (int e = check_depth(depth)) return e;
  return dispatch_select<SelectLaunch>(tree, mode, B, make_net(B, P, n_in, K, hc, bg, adapt, kv),
                                       make_sel(hs, max_steps, depth), w, iw, words, y0, st,
                                       stats, (cudaStream_t)stream);
}

int cf_sde_attempt(int N, int P, int n_in, int K, const float* hc, const float* hs, int depth,
                   int tree, int mode, const float* bg, const float* adapt, const void* w,
                   const void* iw, const float* kv, const int* words, const float* t1,
                   const float* y1, const float* h, const float* err_prev, const float* w_t1,
                   float* y_new, float* rec, void* stream) {
  if (int e = check_shape(P, n_in, K)) return e;
  if (int e = check_depth(depth)) return e;
  return dispatch_select<AttemptLaunch>(tree, mode, N, make_net(N, P, n_in, K, hc, bg, adapt, kv),
                                        make_sel(hs, 0, depth), w, iw, words, t1, y1, h,
                                        err_prev, w_t1, y_new, rec, (cudaStream_t)stream);
}

// The three-term sweeps. lanes: t0s, hs are (n_steps, B), else (n_steps,);
// i1, i10 (n_steps, B); ys (n_steps + 1, B, 3P); wT (P, P) and iwT (n_in, P)
// float32. A batch too large for one block's shared memory (the reverse
// sweep holds every lane) fails cudaFuncSetAttribute: the wrapper raises.
int cf_sde3_fwd(int B, int P, int n_in, int K, const float* hc, int n_steps, int n_real,
                int lanes, const float* bg, const float* adapt, const float* wT,
                const float* iwT, const float* kv, const float* t0s, const float* hs,
                const float* i1, const float* i10, const float* y0, float* ys, void* stream) {
  if (int e = check_shape(P, n_in, K)) return e;
  const size_t bytes = sizeof(float) * (setup_floats(P, n_in, 1) + 4 * 3 * (size_t)P);
  if (int e = set_smem(sde3_fwd_kernel, bytes)) return e;
  const Grid3 g{n_steps, n_real, lanes, t0s, hs, i1, i10};
  sde3_fwd_kernel<<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      make_net(B, P, n_in, K, hc, bg, adapt, kv), g, wT, iwT, y0, ys);
  return (int)cudaGetLastError();
}

// ys_prev, ysbar (n_steps, B, 3P); ybar (B, 3P); d_wT (P, P), d_iwT (n_in, P);
// work: 4 P^2 floats of device memory (the step's three bf16 accumulators
// and the chunk's float32 sum).
int cf_sde3_bwd(int B, int P, int n_in, int K, const float* hc, int n_steps, int n_real,
                int lanes, int stride, int chunk, const float* bg, const float* adapt,
                const float* wT, const float* iwT, const float* kv, const float* t0s,
                const float* hs, const float* i10, const float* ys_prev, const float* ysbar,
                float* ybar, float* d_wT, float* d_iwT, float* work, void* stream) {
  if (int e = check_shape(P, n_in, K)) return e;
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * (setup_floats(P, n_in, B) + 8 * (size_t)B * 3 * P
                                        + 4 * (size_t)B + 2 * (size_t)n_in * P);
  if (int e = set_smem(sde3_bwd_kernel, bytes)) return e;
  const Grid3 g{n_steps, n_real, lanes, t0s, hs, nullptr, i10};
  sde3_bwd_kernel<<<1, kThreads, bytes, (cudaStream_t)stream>>>(
      make_net(B, P, n_in, K, hc, bg, adapt, kv), g, stride, chunk, wT, iwT, ys_prev, ysbar,
      ybar, d_wT, d_iwT, work);
  return (int)cudaGetLastError();
}

// The three-term sweeps as teams (B3t-team, B4t). hi, mid, lo: the bf16
// (P, P) terms of wT (prepare_premixed_split); hiT, midT, loT their
// transposes; iwT float32 (n_in, P); lanes, t0s, hs, i1, i10 as cf_sde3_fwd;
// scr: global scratch, 4 (fwd) or 7 (bwd) B 3P floats. P must be a
// multiple of 8.
int cf_sde3_fwd_team(int B, int P, int n_in, int K, const float* hc, int n_steps, int n_real,
                     int lanes, const float* bg, const float* adapt, const void* hi,
                     const void* mid, const void* lo, const float* iwT, const float* kv,
                     const float* t0s, const float* hs, const float* i1, const float* i10,
                     const float* y0, float* scr, float* ys, void* stream) {
  size_t bytes;
  if (int e = team_prepare(sde3_fwd_team_kernel<3>, P, n_in, K, 1, 3, 6, 1, &bytes)) return e;
  const Wg w{(const bf16*)hi, (const bf16*)mid, (const bf16*)lo, nullptr, nullptr, nullptr, iwT};
  const Grid3 g{n_steps, n_real, lanes, t0s, hs, i1, i10};
  if (B > 0)
    sde3_fwd_team_kernel<3><<<kCluster * B, kThreads, bytes, (cudaStream_t)stream>>>(
        make_net(B, P, n_in, K, hc, bg, adapt, kv), g, w, y0, scr, ys);
  return (int)cudaGetLastError();
}

// ys_prev, ysbar, seeds (n_steps, B, 3P); ybar (B, 3P); stride: truncation
// every stride steps (0: none).
int cf_sde3_bwd_emit(int B, int P, int n_in, int K, const float* hc, int n_steps, int n_real,
                     int lanes, int stride, const float* bg, const float* adapt, const void* hi,
                     const void* mid, const void* lo, const void* hiT, const void* midT,
                     const void* loT, const float* iwT, const float* kv, const float* t0s,
                     const float* hs, const float* i10, const float* ys_prev,
                     const float* ysbar, float* scr, float* ybar, float* seeds, void* stream) {
  size_t bytes;
  if (int e = team_prepare(sde3_bwd_emit_kernel<3>, P, n_in, K, 1, 3, 6, 1, &bytes)) return e;
  const Wg w{(const bf16*)hi, (const bf16*)mid, (const bf16*)lo, (const bf16*)hiT,
             (const bf16*)midT, (const bf16*)loT, iwT};
  const Grid3 g{n_steps, n_real, lanes, t0s, hs, nullptr, i10};
  if (B > 0)
    sde3_bwd_emit_kernel<3><<<kCluster * B, kThreads, bytes, (cudaStream_t)stream>>>(
        make_net(B, P, n_in, K, hc, bg, adapt, kv), g, stride, w, ys_prev, ysbar, scr, ybar,
        seeds);
  return (int)cudaGetLastError();
}

// B4't-team (the batch on one team: sde3_bwd_kernel's sweep, the terms
// in L2). hi..loT, iwT as cf_sde3_bwd_emit; the rest as cf_sde3_bwd; scr: 7 B
// 3P floats; work: P^2 + n_in P floats. P must be a multiple of 8.
int cf_sde3_bwd_team(int B, int P, int n_in, int K, const float* hc, int n_steps, int n_real,
                     int lanes, int stride, int chunk, const float* bg, const float* adapt,
                     const void* hi, const void* mid, const void* lo, const void* hiT,
                     const void* midT, const void* loT, const float* iwT, const float* kv,
                     const float* t0s, const float* hs, const float* i10,
                     const float* ys_prev, const float* ysbar, float* scr, float* ybar,
                     float* d_wT, float* d_iwT, float* work, void* stream) {
  return bwd_team<3>(B, P, n_in, K, hc, n_steps, n_real, lanes, stride, chunk, bg, adapt, hi,
                     mid, lo, hiT, midT, loT, iwT, kv, t0s, hs, i10, ys_prev, ysbar, scr, ybar,
                     d_wT, d_iwT, work, stream);
}

// B4s (the two-term split's kernel-mode sweep, the same team kernel): hi,
// mid the bf16 terms of prepare_premixed_split2, hiT, midT their
// transposes; the rest as cf_sde3_bwd_team.
int cf_sde2_bwd(int B, int P, int n_in, int K, const float* hc, int n_steps, int n_real,
                int lanes, int stride, int chunk, const float* bg, const float* adapt,
                const void* hi, const void* mid, const void* hiT, const void* midT,
                const float* iwT, const float* kv, const float* t0s, const float* hs,
                const float* i10, const float* ys_prev, const float* ysbar, float* scr,
                float* ybar, float* d_wT, float* d_iwT, float* work, void* stream) {
  return bwd_team<2>(B, P, n_in, K, hc, n_steps, n_real, lanes, stride, chunk, bg, adapt, hi,
                     mid, nullptr, hiT, midT, nullptr, iwT, kv, t0s, hs, i10, ys_prev, ysbar, scr,
                     ybar, d_wT, d_iwT, work, stream);
}

// B3 and B4 (replay2_team.cuh): wpk the two terms of wT packed per block
// (sde2_pack in kernels/network_sde.py: (C, P, rw) 32-bit words, the plan's
// layout); iwT float32 (n_in, P); t0s, hs, i1, i10 (n_steps, B) each lane's
// grid; ys (n_steps + 1, B, 3P). stream: 1 streams the slices through a
// ring of tiles even where they fit (the plan streams them anyway where
// they do not). P must be a multiple of 8.
int cf_sde_replay_fwd(int B, int P, int n_in, int K, const float* hc, int n_steps, int n_real,
                      int stream, const float* bg, const float* adapt, const void* wpk,
                      const float* iwT, const float* kv, const float* t0s, const float* hs,
                      const float* i1, const float* i10, const float* y0, float* ys,
                      void* cstream) {
  if (int e = check_shape(P, n_in, K)) return e;
  if (P % 8) return (int)cudaErrorInvalidValue;
  const Plan2 p = plan2(P, n_in, stream);
  if (p.stream && p.S < 1) return (int)cudaErrorInvalidValue;
  const Net n = make_net(B, P, n_in, K, hc, bg, adapt, kv);
  const Replay2 rp{n_steps, n_real, 0, t0s, hs, i1, i10};
  const uint32_t* w = (const uint32_t*)wpk;
  return p.stream ? team2_launch(sde2_fwd_kernel<true>, p, B, (cudaStream_t)cstream, n, rp, w,
                                 iwT, y0, ys)
                  : team2_launch(sde2_fwd_kernel<false>, p, B, (cudaStream_t)cstream, n, rp, w,
                                 iwT, y0, ys);
}

// ys_prev, ysbar, seeds (n_steps, B, 3P); ybar (B, 3P); stride: truncation
// every stride steps (0: none); the rest as cf_sde_replay_fwd.
int cf_sde_replay_bwd(int B, int P, int n_in, int K, const float* hc, int n_steps, int n_real,
                      int stride, int stream, const float* bg, const float* adapt,
                      const void* wpk, const float* iwT, const float* kv, const float* t0s,
                      const float* hs, const float* i10, const float* ys_prev,
                      const float* ysbar, float* ybar, float* seeds, void* cstream) {
  if (int e = check_shape(P, n_in, K)) return e;
  if (P % 8) return (int)cudaErrorInvalidValue;
  const Plan2 p = plan2(P, n_in, stream);
  if (p.stream && p.S < 1) return (int)cudaErrorInvalidValue;
  const Net n = make_net(B, P, n_in, K, hc, bg, adapt, kv);
  const Replay2 rp{n_steps, n_real, stride, t0s, hs, nullptr, i10};
  const uint32_t* w = (const uint32_t*)wpk;
  return p.stream ? team2_launch(sde2_bwd_kernel<true>, p, B, (cudaStream_t)cstream, n, rp, w,
                                 iwT, ys_prev, ysbar, ybar, seeds)
                  : team2_launch(sde2_bwd_kernel<false>, p, B, (cudaStream_t)cstream, n, rp, w,
                                 iwT, ys_prev, ysbar, ybar, seeds);
}

// The plan of B3 and B4 at P (Plan2, in order: C, nc, nw, rw, L, Lv, stream,
// R, T, S, fixed bytes, bytes), for the wrapper's own reckoning to be held
// against.
int cf_sde2_plan(int P, int n_in, int stream, long long* out) {
  if (P <= 0 || P % 8 || n_in < 0 || n_in > kMaxInputs) return (int)cudaErrorInvalidValue;
  const Plan2 p = plan2(P, n_in, stream);
  const long long v[12] = {p.C, p.nc, p.nw, p.rw, p.L, p.Lv, p.stream, p.R, p.T, p.S,
                           (long long)p.fixed, (long long)p.bytes};
  for (int j = 0; j < 12; ++j) out[j] = v[j];
  return 0;
}

// cudaOccupancyMaxActiveClusters of B3 (bwd 0) or B4 (bwd 1) at P.
int cf_sde2_max_clusters(int P, int n_in, int stream, int bwd, int* out) {
  if (P <= 0 || P % 8 || n_in < 0 || n_in > kMaxInputs) return (int)cudaErrorInvalidValue;
  const Plan2 p = plan2(P, n_in, stream);
  if (bwd)
    return p.stream ? team2_max_clusters(sde2_bwd_kernel<true>, p, out)
                    : team2_max_clusters(sde2_bwd_kernel<false>, p, out);
  return p.stream ? team2_max_clusters(sde2_fwd_kernel<true>, p, out)
                  : team2_max_clusters(sde2_fwd_kernel<false>, p, out);
}

// The yardstick: B3t-team's and B4t's bodies on the two-term split. hi, mid
// the bf16 terms of prepare_premixed_split2, hiT, midT their transposes;
// scr: 4 (fwd) or 7 (bwd) B 3P floats; the rest as cf_sde_replay_fwd/bwd.
int cf_sde2_fwd_team8(int B, int P, int n_in, int K, const float* hc, int n_steps, int n_real,
                      const float* bg, const float* adapt, const void* hi, const void* mid,
                      const float* iwT, const float* kv, const float* t0s, const float* hs,
                      const float* i1, const float* i10, const float* y0, float* scr, float* ys,
                      void* stream) {
  size_t bytes;
  if (int e = team_prepare(sde3_fwd_team_kernel<2>, P, n_in, K, 1, 2, 3, 1, &bytes)) return e;
  const Wg w{(const bf16*)hi, (const bf16*)mid, nullptr, nullptr, nullptr, nullptr, iwT};
  const Grid3 g{n_steps, n_real, 1, t0s, hs, i1, i10};
  if (B > 0)
    sde3_fwd_team_kernel<2><<<kCluster * B, kThreads, bytes, (cudaStream_t)stream>>>(
        make_net(B, P, n_in, K, hc, bg, adapt, kv), g, w, y0, scr, ys);
  return (int)cudaGetLastError();
}

int cf_sde2_bwd_team8(int B, int P, int n_in, int K, const float* hc, int n_steps, int n_real,
                      int stride, const float* bg, const float* adapt, const void* hi,
                      const void* mid, const void* hiT, const void* midT, const float* iwT,
                      const float* kv, const float* t0s, const float* hs, const float* i10,
                      const float* ys_prev, const float* ysbar, float* scr, float* ybar,
                      float* seeds, void* stream) {
  size_t bytes;
  if (int e = team_prepare(sde3_bwd_emit_kernel<2>, P, n_in, K, 1, 2, 3, 1, &bytes)) return e;
  const Wg w{(const bf16*)hi, (const bf16*)mid, nullptr, (const bf16*)hiT, (const bf16*)midT,
             nullptr, iwT};
  const Grid3 g{n_steps, n_real, 1, t0s, hs, nullptr, i10};
  if (B > 0)
    sde3_bwd_emit_kernel<2><<<kCluster * B, kThreads, bytes, (cudaStream_t)stream>>>(
        make_net(B, P, n_in, K, hc, bg, adapt, kv), g, stride, w, ys_prev, ysbar, scr, ybar,
        seeds);
  return (int)cudaGetLastError();
}

}  // extern "C"
