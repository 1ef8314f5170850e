// XOR-network SDE kernels for Hopper (sm_90a): SRA1 on the uniform grid and
// its reverse sweep in kernel mode (the fixed-grid step), and the adaptive
// step's per-lane step-size selection, its lane-batched replay over the
// frozen grids and that replay's reverse sweep in kernel mode. Plain C entry
// points, loaded with ctypes by columnflow_torch/kernels/_build.py; each
// returns cudaGetLastError().
//
// Replaces (columnflow/solvers/, the kernels traced with
// columnflow/models/xor.py xor_drift_batched and the membrane-only diffusion
// sigma = 10, method "srk"/"sra1"):
//   cf_xor_sde_fwd         <- fused.py _make_sde_chunk_kernel, uniform grid
//                             (B3u): the SRA1 steps, each lane's scalar
//                             Brownian integrals (i1, i10) broadcast over its
//                             72 components
//   cf_xor_sde_bwd         <- fused.py _make_sde_bwd_chunk_kernel, kernel mode
//                             (B4'): the VJP of each step through the stored
//                             trajectory (f1 and the second stage's state
//                             recomputed) w.r.t. the state and the four
//                             feedforward rows
//   cf_xor_sde_select      <- sde_adaptive.py _make_sde_adaptive_kernel (B5x,
//                             the krng tree), and the XLA selection
//                             _adaptive_pass on the jax.random tree (no Pallas
//                             kernel): each lane's whole step-doubling
//                             controller loop
//   cf_xor_sde_attempt     <- the same body, one controller attempt per record
//                             (a second entry point, for testing the body)
//   cf_xor_sde_replay_fwd  <- fused.py _make_sde_chunk_kernel, variable_h=
//                             "lanes" (B3xl): SRA1 over each lane's frozen
//                             half-step grid
//   cf_xor_sde_replay_bwd  <- fused.py _make_sde_bwd_chunk_kernel, kernel
//                             mode, lanes (B4'xl)
//
// What bounds them: serial chains of small steps. A step of the (4, 72)
// batch is ~10^4 operations (2 drift evaluations forward; 1 drift and 2
// VJPs backward; an attempt 5 drifts and two Brownian-tree walks of one
// lane), nanoseconds of the card's peak; the time is the latency of one
// step. Design: as xor_ode.cu, one block holds the batch for the sweeps
// (jax.vjp contracts each row's cotangent over the batch inside every drift
// VJP), one thread per (lane, population), state and stage values in
// registers. The selection runs one block of one warp per lane (each lane
// has its own controller), thread p owning population p, the lane's knot
// values copied into shared memory; the trees, the Brownian data and the
// controller are csrc/sde_select.cuh, shared with network_sde.cu. The
// uniform grid's step times t0s come from the host (solvers/fused.py
// uniform_step_times: the JAX kernel's float32 arithmetic per chunk); the
// lanes' step times and sizes are each lane's own frozen grid.
//
// Precision: as xor_drift.cuh; each step rounds as solvers/sde.py _sra1_step
// (and kernels/xor_sde.py xor_sde_step_vjp backward), each attempt as
// kernels/network_sde.py attempt_plain; the error norm is a float64 sum of
// the 72 float32 squares rounded once.

#include "sde_select.cuh"
#include "xor_drift.cuh"

namespace {

// The diffusion of component c: sigma on the membrane block, 0 elsewhere.
__device__ __forceinline__ float sigma_of(int c) { return c == 0 ? 10.0f : 0.0f; }

// Forward: ys[0] = y0; per step i with i10_h = i10 / h,
//   f1 = f(t0, y);  h2 = (y + (0.75 h) f1) + (1.5 i10_h) g
//   f2 = f(t0 + 0.75 h, h2)
//   y <- ((y + h (f1 / 3 + (2 f2) / 3)) + (i1 - i10_h) g) + i10_h g.
__global__ void __launch_bounds__(kXMaxThreads)
xor_sde_fwd_kernel(Net n, int n_steps, float h, const float* __restrict__ consts,
                   const float* __restrict__ rows, const float* __restrict__ t0s,
                   const float* __restrict__ i1, const float* __restrict__ i10,
                   const float* __restrict__ y0, float* __restrict__ ys) {
  extern __shared__ __align__(16) unsigned char sm[];
  const XSh s = xsh_load(sm, n.B, consts, rows);
  const Me me = me_of(n.B);
  const size_t N = (size_t)n.B * kXS;
  const int lane = me.on ? me.b : 0;
  const float h075 = 0.75f * h;
  float y[3], f1[3], f2[3], h2[3];
  for (int c = 0; c < 3; ++c) {
    y[c] = me.on ? y0[comp(me, c)] : 0.0f;
    if (me.on) ys[comp(me, c)] = y[c];
  }
  for (int i = 0; i < n_steps; ++i) {
    const float t0 = t0s[i];
    const float w1 = i1[(size_t)i * n.B + lane], i10_h = i10[(size_t)i * n.B + lane] / h;
    xor_drift(n, s, me, t0, y, f1);
    for (int c = 0; c < 3; ++c) h2[c] = (y[c] + h075 * f1[c]) + (1.5f * i10_h) * sigma_of(c);
    xor_drift(n, s, me, t0 + h075, h2, f2);
    for (int c = 0; c < 3; ++c) {
      const float g = sigma_of(c);
      y[c] = ((y[c] + h * (f1[c] / 3.0f + (2.0f * f2[c]) / 3.0f)) + (w1 - i10_h) * g) + i10_h * g;
      if (me.on) ys[(i + 1) * N + comp(me, c)] = y[c];
    }
  }
}

// Reverse sweep over steps n-1..0, kernel mode. Per step k with the seed
// c = ybar + ysbar[k + 1] on its output: recompute f1 and h2 from ys[k],
//   c3 = (h c) / 3;  (c_h2, rows_2) = f^T|_{t0 + 0.75 h, h2} (2 c3)
//   (c_y, rows_1) = f^T|_{t0, ys[k]} (c3 + (0.75 h) c_h2)
//   ybar = (c + c_h2) + c_y;  rows += rows_2 + rows_1.
// Writes ybar (the cotangent before step 0, without ysbar[0]) and the rows.
__global__ void __launch_bounds__(kXMaxThreads)
xor_sde_bwd_kernel(Net n, int n_steps, float h, const float* __restrict__ consts,
                   const float* __restrict__ rows, const float* __restrict__ t0s,
                   const float* __restrict__ i10, const float* __restrict__ ys,
                   const float* __restrict__ ysbar, float* __restrict__ ybar_out,
                   float* __restrict__ drows) {
  extern __shared__ __align__(16) unsigned char sm[];
  const XSh s = xsh_load(sm, n.B, consts, rows);
  const Me me = me_of(n.B);
  const size_t N = (size_t)n.B * kXS;
  const int lane = me.on ? me.b : 0;
  const float h075 = 0.75f * h;
  float ybar[3] = {0.0f, 0.0f, 0.0f}, y[3], f1[3], h2[3], c[3], ct[3], c_h2[3], c_y[3];
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int k = n_steps - 1; k >= 0; --k) {
    const float t0 = t0s[k], i10_h = i10[(size_t)k * n.B + lane] / h;
    for (int q = 0; q < 3; ++q) {
      const int o = me.on ? comp(me, q) : 0;
      y[q] = ys[k * N + o];
      c[q] = ybar[q] + ysbar[(k + 1) * N + o];
    }
    xor_drift(n, s, me, t0, y, f1);
    for (int q = 0; q < 3; ++q) {
      h2[q] = (y[q] + h075 * f1[q]) + (1.5f * i10_h) * sigma_of(q);
      ct[q] = ((h * c[q]) / 3.0f) * 2.0f;
    }
    float a0 = 0.0f, a1 = 0.0f, b0 = 0.0f, b1 = 0.0f;
    xor_drift_vjp(n, s, me, t0 + h075, h2, ct, c_h2, a0, a1);
    for (int q = 0; q < 3; ++q) ct[q] = (h * c[q]) / 3.0f + h075 * c_h2[q];
    xor_drift_vjp(n, s, me, t0, y, ct, c_y, b0, b1);
    for (int q = 0; q < 3; ++q) ybar[q] = (c[q] + c_h2[q]) + c_y[q];
    acc0 = acc0 + (a0 + b0);
    acc1 = acc1 + (a1 + b1);
  }
  if (me.on)
    for (int q = 0; q < 3; ++q) ybar_out[comp(me, q)] = ybar[q];
  store_rows(me, acc0, acc1, drows);
}

// ---------------------------------------------------------------------------
// The per-lane selection (B5x / the XLA selection), lane = blockIdx.x
// ---------------------------------------------------------------------------

constexpr int kSelThreads = 32;  // one warp: thread p < 24 owns population p

// What the selection keeps in shared memory past the drift's: the lane's
// knot values (K, 1, 32), the broadcast scalars and the jax tree's normals.
struct SelSh {
  float* scal;  // (8)
  float* zb;    // (2 (kMaxDepth + 1))
};

size_t sel_bytes(int K) {
  return xsh_bytes(1, kSelThreads)
         + sizeof(float) * ((size_t)K * kXIn + 8 + 2 * (kMaxDepth + 1));
}

// The lane's drift constants (B = 1, its knot values in shared memory past
// the drift's) and the selection's scratch. Ends with a barrier.
__device__ Net lane_net(const Net& n, int lane, unsigned char* sm, SelSh* u) {
  float* kvl = reinterpret_cast<float*>(sm + xsh_bytes(1, kSelThreads));
  for (int i = threadIdx.x; i < n.K * kXIn; i += blockDim.x)
    kvl[i] = n.kv[((size_t)(i / kXIn) * n.B + lane) * kXIn + i % kXIn];
  u->scal = kvl + n.K * kXIn;
  u->zb = u->scal + 8;
  Net nl = n;
  nl.B = 1;
  nl.kv = kvl;
  __syncthreads();
  return nl;
}

// One step-doubling attempt of the lane from (t, y) with step h and W(t) =
// w0 (network_sde.cu attempt on the XOR drift): the two-half-step solution
// into yn, returns the scaled RMS error and W(t + h) in w1_out.
template <int kTree>
__device__ float attempt(const Net& n, const XSh& s, const Me& me, const Sel& sel,
                         const uint32_t* kw, float t, float h, float w0, const float* y,
                         float* yn, const SelSh& u, float& w1_out) {
  const float tm = t + 0.5f * h;
  const float te = t + h;
  const float hh = 0.5f * h;
  draw_noise<kTree>(sel, kw, t, tm, te, u.scal, u.zb);
  const float wm = u.scal[0], w1 = u.scal[1], za = u.scal[2], zb = u.scal[3];
  __syncthreads();
  w1_out = w1;
  const float dw_a = wm - w0, dw_b = w1 - wm;
  const float sq = sqrtf(hh / 12.0f);
  const float i10_a = hh * (0.5f * dw_a + sq * za);
  const float i10_b = hh * (0.5f * dw_b + sq * zb);
  const float i10_f = (i10_a + i10_b) + hh * dw_a;
  float f1[3], f[3], g1[3], hst[3], yf[3], yh[3];

  // Full step.
  xor_drift(n, s, me, t, y, f1);
  const float i10h_f = i10_f / (h > 0.0f ? h : 1.0f);
  for (int c = 0; c < 3; ++c) hst[c] = (y[c] + (0.75f * h) * f1[c]) + (1.5f * i10h_f) * sigma_of(c);
  xor_drift(n, s, me, t + 0.75f * h, hst, f);
  const float dw_f = dw_a + dw_b;
  for (int c = 0; c < 3; ++c) yf[c] = sra1_final(y[c], f1[c], f[c], h, dw_f, i10h_f, sigma_of(c));
  // First half step (shares f1).
  const float i10h_a = i10_a / (hh > 0.0f ? hh : 1.0f);
  for (int c = 0; c < 3; ++c)
    hst[c] = (y[c] + (0.75f * hh) * f1[c]) + (1.5f * i10h_a) * sigma_of(c);
  xor_drift(n, s, me, t + 0.75f * hh, hst, f);
  for (int c = 0; c < 3; ++c) yh[c] = sra1_final(y[c], f1[c], f[c], hh, dw_a, i10h_a, sigma_of(c));
  // Second half step from t + h/2.
  const float th = t + 0.5f * h;
  xor_drift(n, s, me, th, yh, g1);
  const float i10h_b = i10_b / (hh > 0.0f ? hh : 1.0f);
  for (int c = 0; c < 3; ++c)
    hst[c] = (yh[c] + (0.75f * hh) * g1[c]) + (1.5f * i10h_b) * sigma_of(c);
  xor_drift(n, s, me, th + 0.75f * hh, hst, f);
  double acc = 0.0;
  for (int c = 0; c < 3; ++c) {
    yn[c] = sra1_final(yh[c], g1[c], f[c], hh, dw_b, i10h_b, sigma_of(c));
    const float q = (yn[c] - yf[c]) / (sel.atol + sel.rtol * fmaxf(fabsf(y[c]), fabsf(yn[c])));
    if (me.on) acc += (double)(q * q);
  }
  const float mean = (float)block_sum(acc, s.red) / (float)kXS;
  return sqrtf(mean);
}

// The whole selection loop of lane blockIdx.x: st (B, M + 1) its accepted
// times padded with t_end, stats (B, 3) = (naccept, nreject, success).
template <int kTree>
__global__ void __launch_bounds__(kSelThreads)
xor_sde_select_kernel(Net n, Sel sel, const float* __restrict__ consts,
                      const float* __restrict__ rows, const int* __restrict__ words,
                      const float* __restrict__ y0, float* __restrict__ st,
                      int* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int b = blockIdx.x, M = sel.max_steps;
  const XSh s = xsh_load(sm, 1, consts, rows);
  SelSh u;
  const Net nl = lane_net(n, b, sm, &u);
  const Me me = me_of(1);
  uint32_t kw[4];
  for (int j = 0; j < 4; ++j) kw[j] = (uint32_t)words[b * 4 + j];
  float* st_b = st + (size_t)b * (M + 1);
  for (int i = threadIdx.x; i <= M; i += blockDim.x) st_b[i] = sel.t_end;
  float y[3], yn[3];
  for (int c = 0; c < 3; ++c) y[c] = me.on ? y0[(size_t)b * kXS + c * kXP + me.p] : 0.0f;
  if (threadIdx.x == 0) {
    st_b[0] = sel.t_start;
    u.scal[4] = lane_w<kTree>(sel, kw, sel.t_start);
  }
  __syncthreads();
  float w_t1 = u.scal[4];
  float t1 = sel.t_start, h = sel.h0, err_prev = 1.0f;
  int na = 0, nr = 0;
  __syncthreads();
  while (t1 < sel.t_end && na + nr < M) {
    float hc = fminf(h, sel.t_end - t1);
    hc = (t1 + hc) - t1;
    float w1;
    const float err = attempt<kTree>(nl, s, me, sel, kw, t1, hc, w_t1, y, yn, u, w1);
    const Control c = control(sel, err, hc, err_prev);
    const float t_new = c.accept ? t1 + hc : t1;
    na += c.accept ? 1 : 0;
    nr += c.accept ? 0 : 1;
    if (threadIdx.x == 0) st_b[na] = t_new;
    if (c.accept) {
      for (int q = 0; q < 3; ++q) y[q] = yn[q];
      err_prev = c.err_c;
      w_t1 = w1;
    }
    h = c.h_next;
    t1 = t_new;
  }
  if (threadIdx.x == 0) {
    stats[b * 3 + 0] = na;
    stats[b * 3 + 1] = nr;
    stats[b * 3 + 2] = t1 >= sel.t_end ? 1 : 0;
  }
}

// One controller attempt per record r = blockIdx.x (whose knot values are
// lane r's), from (t1, y1, h, err_prev, W(t1)): rec[r] = (err, accept, h
// used, h next, t new, W(t + h)), y_new[r] = the two-half-step solution.
template <int kTree>
__global__ void __launch_bounds__(kSelThreads)
xor_sde_attempt_kernel(Net n, Sel sel, const float* __restrict__ consts,
                       const float* __restrict__ rows, const int* __restrict__ words,
                       const float* __restrict__ t1s, const float* __restrict__ y1,
                       const float* __restrict__ hs, const float* __restrict__ err_prev,
                       const float* __restrict__ w_t1, float* __restrict__ y_new,
                       float* __restrict__ rec) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int r = blockIdx.x;
  const XSh s = xsh_load(sm, 1, consts, rows);
  SelSh u;
  const Net nl = lane_net(n, r, sm, &u);
  const Me me = me_of(1);
  uint32_t kw[4];
  for (int j = 0; j < 4; ++j) kw[j] = (uint32_t)words[r * 4 + j];
  float y[3], yn[3];
  for (int c = 0; c < 3; ++c) y[c] = me.on ? y1[(size_t)r * kXS + c * kXP + me.p] : 0.0f;
  const float t1 = t1s[r];
  float hc = fminf(hs[r], sel.t_end - t1);
  hc = (t1 + hc) - t1;
  float w1;
  const float err = attempt<kTree>(nl, s, me, sel, kw, t1, hc, w_t1[r], y, yn, u, w1);
  const Control c = control(sel, err, hc, err_prev[r]);
  if (me.on)
    for (int q = 0; q < 3; ++q) y_new[(size_t)r * kXS + q * kXP + me.p] = yn[q];
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
// The lane-batched replay over the frozen grids (B3xl) and its reverse sweep
// in kernel mode (B4'xl): lane b steps on its own times t0s[i, b] and sizes
// hs[i, b] (h == 0 padding steps are exact no-ops); the first n_real steps
// run, the rest carry the state.
// ---------------------------------------------------------------------------

// ys[0] = y0; per step i < n_real with i10_h = i10 / (h > 0 ? h : 1), as
// cf_xor_sde_fwd; ys[i + 1] = ys[n_real] for i >= n_real.
__global__ void __launch_bounds__(kXMaxThreads)
xor_sde_replay_fwd_kernel(Net n, int n_steps, int n_real, const float* __restrict__ consts,
                          const float* __restrict__ rows, const float* __restrict__ t0s,
                          const float* __restrict__ hs, const float* __restrict__ i1,
                          const float* __restrict__ i10, const float* __restrict__ y0,
                          float* __restrict__ ys) {
  extern __shared__ __align__(16) unsigned char sm[];
  const XSh s = xsh_load(sm, n.B, consts, rows);
  const Me me = me_of(n.B);
  const size_t N = (size_t)n.B * kXS;
  const int lane = me.on ? me.b : 0;
  float y[3], f1[3], f2[3], h2[3];
  for (int c = 0; c < 3; ++c) {
    y[c] = me.on ? y0[comp(me, c)] : 0.0f;
    if (me.on) ys[comp(me, c)] = y[c];
  }
  for (int i = 0; i < n_real; ++i) {
    const size_t li = (size_t)i * n.B + lane;
    const float t0 = t0s[li], h = hs[li];
    const float w1 = i1[li], i10_h = i10[li] / (h > 0.0f ? h : 1.0f);
    xor_drift(n, s, me, t0, y, f1);
    for (int c = 0; c < 3; ++c) h2[c] = (y[c] + (0.75f * h) * f1[c]) + (1.5f * i10_h) * sigma_of(c);
    xor_drift(n, s, me, t0 + 0.75f * h, h2, f2);
    for (int c = 0; c < 3; ++c) {
      y[c] = sra1_final(y[c], f1[c], f2[c], h, w1, i10_h, sigma_of(c));
      if (me.on) ys[(i + 1) * N + comp(me, c)] = y[c];
    }
  }
  if (me.on)
    for (int i = n_real; i < n_steps; ++i)
      for (int c = 0; c < 3; ++c) ys[(i + 1) * N + comp(me, c)] = y[c];
}

// Reverse sweep over steps n_real-1..0, kernel mode, as cf_xor_sde_bwd on
// each lane's own step: the seed c = ybar + ysbar[k + 1] on step k's output.
// The rows' cotangents of the steps add within each chunk of ``chunk`` steps
// (from the chunk's last step down), and each chunk's sum adds to the total
// after its first step (k % chunk == 0), as the JAX kernel's chunks do.
__global__ void __launch_bounds__(kXMaxThreads)
xor_sde_replay_bwd_kernel(Net n, int n_real, int chunk, const float* __restrict__ consts,
                          const float* __restrict__ rows, const float* __restrict__ t0s,
                          const float* __restrict__ hs, const float* __restrict__ i10,
                          const float* __restrict__ ys, const float* __restrict__ ysbar,
                          float* __restrict__ ybar_out, float* __restrict__ drows) {
  extern __shared__ __align__(16) unsigned char sm[];
  const XSh s = xsh_load(sm, n.B, consts, rows);
  const Me me = me_of(n.B);
  const size_t N = (size_t)n.B * kXS;
  const int lane = me.on ? me.b : 0;
  float ybar[3] = {0.0f, 0.0f, 0.0f}, y[3], f1[3], h2[3], c[3], ct[3], c_h2[3], c_y[3];
  float acc0 = 0.0f, acc1 = 0.0f, part0 = 0.0f, part1 = 0.0f;
  for (int k = n_real - 1; k >= 0; --k) {
    const size_t lk = (size_t)k * n.B + lane;
    const float t0 = t0s[lk], h = hs[lk];
    const float i10_h = i10[lk] / (h > 0.0f ? h : 1.0f), h075 = 0.75f * h;
    for (int q = 0; q < 3; ++q) {
      const int o = me.on ? comp(me, q) : 0;
      y[q] = ys[k * N + o];
      c[q] = ybar[q] + ysbar[(k + 1) * N + o];
    }
    xor_drift(n, s, me, t0, y, f1);
    for (int q = 0; q < 3; ++q) {
      h2[q] = (y[q] + h075 * f1[q]) + (1.5f * i10_h) * sigma_of(q);
      ct[q] = ((h * c[q]) / 3.0f) * 2.0f;
    }
    float a0 = 0.0f, a1 = 0.0f, b0 = 0.0f, b1 = 0.0f;
    xor_drift_vjp(n, s, me, t0 + h075, h2, ct, c_h2, a0, a1);
    for (int q = 0; q < 3; ++q) ct[q] = (h * c[q]) / 3.0f + h075 * c_h2[q];
    xor_drift_vjp(n, s, me, t0, y, ct, c_y, b0, b1);
    for (int q = 0; q < 3; ++q) ybar[q] = (c[q] + c_h2[q]) + c_y[q];
    part0 = part0 + (a0 + b0);
    part1 = part1 + (a1 + b1);
    if (k % chunk == 0) {
      acc0 = acc0 + part0;
      acc1 = acc1 + part1;
      part0 = part1 = 0.0f;
    }
  }
  if (me.on)
    for (int q = 0; q < 3; ++q) ybar_out[comp(me, q)] = ybar[q];
  store_rows(me, acc0, acc1, drows);
}

template <typename Kern>
int launch_setup(Kern kernel, int B, int K, size_t* bytes, int* threads) {
  if (int e = check_xor(B, K)) return e;
  *threads = xor_threads(B);
  *bytes = xsh_bytes(B, *threads);
  return set_smem(kernel, *bytes);
}

template <int kTree>
struct XSelectLaunch {
  static int run(int B, Net n, Sel sel, const float* consts, const float* rows, const int* words,
                 const float* y0, float* st, int* stats, cudaStream_t stream) {
    const size_t bytes = sel_bytes(n.K);
    if (int e = set_smem(xor_sde_select_kernel<kTree>, bytes)) return e;
    xor_sde_select_kernel<kTree><<<B, kSelThreads, bytes, stream>>>(n, sel, consts, rows, words,
                                                                    y0, st, stats);
    return (int)cudaGetLastError();
  }
};

template <int kTree>
struct XAttemptLaunch {
  static int run(int N, Net n, Sel sel, const float* consts, const float* rows, const int* words,
                 const float* t1, const float* y1, const float* h, const float* err_prev,
                 const float* w_t1, float* y_new, float* rec, cudaStream_t stream) {
    const size_t bytes = sel_bytes(n.K);
    if (int e = set_smem(xor_sde_attempt_kernel<kTree>, bytes)) return e;
    xor_sde_attempt_kernel<kTree><<<N, kSelThreads, bytes, stream>>>(
        n, sel, consts, rows, words, t1, y1, h, err_prev, w_t1, y_new, rec);
    return (int)cudaGetLastError();
  }
};

// Launch L<kTree> for the tree the host asks for (0 krng, 1 jax.random).
template <template <int> class L, typename... A>
int dispatch_tree(int tree, A... a) {
  if (tree == kKrng) return L<kKrng>::run(a...);
  if (tree == kJax) return L<kJax>::run(a...);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// consts: w24 (24 x 24, row = target), bg24 (24), adapt (24); rows: w00, w01
// (16 each), w10, w11 (8 each); kv: knot values (K, B, 32); t0s (n,) the
// step times, h the step; i1, i10 (n, B); ys, ysbar (n + 1, B, 72).
// hc (host): tau_s, tau_m, tau_a, R, sigma, kc0[K-1], kd[K-1].
int cf_xor_sde_fwd(int B, int K, const float* hc, int n_steps, float h, const float* consts,
                   const float* rows, const float* kv, const float* t0s, const float* i1,
                   const float* i10, const float* y0, float* ys, void* stream) {
  size_t bytes;
  int threads;
  if (int e = launch_setup(xor_sde_fwd_kernel, B, K, &bytes, &threads)) return e;
  xor_sde_fwd_kernel<<<1, threads, bytes, (cudaStream_t)stream>>>(
      make_xor_net(B, K, hc, kv), n_steps, h, consts, rows, t0s, i1, i10, y0, ys);
  return (int)cudaGetLastError();
}

int cf_xor_sde_bwd(int B, int K, const float* hc, int n_steps, float h, const float* consts,
                   const float* rows, const float* kv, const float* t0s, const float* i10,
                   const float* ys, const float* ysbar, float* ybar, float* drows,
                   void* stream) {
  size_t bytes;
  int threads;
  if (int e = launch_setup(xor_sde_bwd_kernel, B, K, &bytes, &threads)) return e;
  xor_sde_bwd_kernel<<<1, threads, bytes, (cudaStream_t)stream>>>(
      make_xor_net(B, K, hc, kv), n_steps, h, consts, rows, t0s, i10, ys, ysbar, ybar, drows);
  return (int)cudaGetLastError();
}

// The selection: B lanes, each one block; hs (host): t_start, t_end, rtol,
// atol, h0, dt_min; tree: 0 krng, 1 jax.random; words (B, 4) int32 = (k0,
// k1, j0, j1) per lane; y0 (B, 72); st (B, max_steps + 1); stats (B, 3).
int cf_xor_sde_select(int B, int K, const float* hc, const float* hs, int max_steps, int depth,
                      int tree, const float* consts, const float* rows, const float* kv,
                      const int* words, const float* y0, float* st, int* stats, void* stream) {
  if (int e = check_xor(B, K)) return e;
  if (int e = check_depth(depth)) return e;
  return dispatch_tree<XSelectLaunch>(tree, B, make_xor_net(B, K, hc, kv),
                                      make_sel(hs, max_steps, depth), consts, rows, words, y0,
                                      st, stats, (cudaStream_t)stream);
}

// One attempt per record r < N, record r with lane r's knot values (kv is
// (K, N, 32)); t1, h, err_prev, w_t1 (N,); y1, y_new (N, 72); rec (N, 6).
int cf_xor_sde_attempt(int N, int K, const float* hc, const float* hs, int depth, int tree,
                       const float* consts, const float* rows, const float* kv, const int* words,
                       const float* t1, const float* y1, const float* h, const float* err_prev,
                       const float* w_t1, float* y_new, float* rec, void* stream) {
  if (int e = check_xor(N, K)) return e;
  if (int e = check_depth(depth)) return e;
  return dispatch_tree<XAttemptLaunch>(tree, N, make_xor_net(N, K, hc, kv), make_sel(hs, 0, depth),
                                       consts, rows, words, t1, y1, h, err_prev, w_t1, y_new, rec,
                                       (cudaStream_t)stream);
}

// The lanes' replay: t0s, hs, i1, i10 (n_steps, B); ys (n_steps + 1, B, 72).
int cf_xor_sde_replay_fwd(int B, int K, const float* hc, int n_steps, int n_real,
                          const float* consts, const float* rows, const float* kv,
                          const float* t0s, const float* hs, const float* i1, const float* i10,
                          const float* y0, float* ys, void* stream) {
  if (n_real < 0 || n_real > n_steps) return (int)cudaErrorInvalidValue;
  size_t bytes;
  int threads;
  if (int e = launch_setup(xor_sde_replay_fwd_kernel, B, K, &bytes, &threads)) return e;
  xor_sde_replay_fwd_kernel<<<1, threads, bytes, (cudaStream_t)stream>>>(
      make_xor_net(B, K, hc, kv), n_steps, n_real, consts, rows, t0s, hs, i1, i10, y0, ys);
  return (int)cudaGetLastError();
}

// Its reverse sweep: t0s, hs, i10 (n_steps, B); ys, ysbar (n_steps + 1, B,
// 72) (rows past n_real are not read); ybar (B, 72); drows (48).
int cf_xor_sde_replay_bwd(int B, int K, const float* hc, int n_steps, int n_real, int chunk,
                          const float* consts, const float* rows, const float* kv,
                          const float* t0s, const float* hs, const float* i10, const float* ys,
                          const float* ysbar, float* ybar, float* drows, void* stream) {
  if (n_real < 0 || n_real > n_steps || chunk < 1) return (int)cudaErrorInvalidValue;
  size_t bytes;
  int threads;
  if (int e = launch_setup(xor_sde_replay_bwd_kernel, B, K, &bytes, &threads)) return e;
  xor_sde_replay_bwd_kernel<<<1, threads, bytes, (cudaStream_t)stream>>>(
      make_xor_net(B, K, hc, kv), n_real, chunk, consts, rows, t0s, hs, i10, ys, ysbar, ybar,
      drows);
  return (int)cudaGetLastError();
}

}  // extern "C"
