// XOR-network dopri5 kernels for Hopper (sm_90a): the adaptive step-size
// selection, the dense-output replay over the frozen grid, and the replay's
// reverse sweep in kernel mode. Plain C entry points, loaded with ctypes by
// columnflow_torch/kernels/_build.py; each returns cudaGetLastError().
//
// Replaces (columnflow/solvers/fused.py, the kernels of odeint_dopri5_fused
// traced with columnflow/models/xor.py xor_drift_batched):
//   cf_xor_select      <- _make_adaptive_kernel (B6x): Hairer's initial step,
//                         the whole accept/reject loop under one controller
//                         for the batch state, the accepted times
//   cf_xor_attempt     <- the same body, one controller attempt (a second
//                         entry point, for testing the body)
//   cf_xor_replay_fwd  <- _make_replay_chunk_kernel (B7x): the six-stage step
//                         over the frozen grid with the stage-0 recompute,
//                         step-start states and CONTD5 rows
//   cf_xor_replay_bwd  <- _make_bwd_chunk_kernel, kernel mode (B8x): the VJP
//                         of each step and its dense rows w.r.t. the state and
//                         the four feedforward rows w00, w01, w10, w11
//
// What bounds them: a serial chain of ~1.7e3 accepted steps (the XOR network
// over 1 s at rtol 1e-7), each 6-7 drift evaluations (and 7 VJPs backward)
// of a (4, 72) state with a 24 x 24 block-diagonal matrix: ~10^4 operations
// a step, nanoseconds of the card's peak. The time is the latency of one
// step. Design: one block holds the batch (the controller's error norm is
// one RMS over all 288 components, and jax.vjp contracts each row's
// cotangent over the batch inside every drift VJP), one thread per (lane,
// population) with its v, a, r, the stage derivatives and the stage states
// in registers; the rates (or the current's cotangent) pass through shared
// memory once per drift evaluation (xor_drift.cuh). Nothing reaches device
// memory inside a step but the outputs.
//
// Precision: as xor_drift.cuh; the stage sums, the error norm and the
// cotangent sums round as kernels/network_ode.py's plain versions
// (rk_step, dense_coeffs, _rms, rk_step_vjp): a tableau entry is a double
// rounded to float32 once, h * a_ij is rounded, then (h * a_ij) * k_j. The
// error norm's squares add in float64 in thread order and round once.

#include "dopri5.cuh"
#include "xor_drift.cuh"

namespace {

// Stage state i (1..6) of this thread's three components:
// out = y + sum_j (h a_ij) k_j over the nonzero a_ij, left to right.
__device__ __forceinline__ void stage(int i, float h, const float* y, const float (&k)[kStages][3],
                                      float* out) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = y[c];
    for (int j = 0; j < i; ++j) {
      const float a = kA[i][j];
      if (a != 0.0f) v = v + (h * a) * k[j][c];
    }
    out[c] = v;
  }
}

// sum_j (h w_j) k_j[c] over the nonzero w_j, left to right, from the first
// term alone (network_ode.py _combine(None, ...)).
__device__ __forceinline__ float weighted3(const float* w, float h, const float (&k)[kStages][3],
                                           int c) {
  float v = 0.0f;
  bool first = true;
#pragma unroll
  for (int j = 0; j < kStages; ++j) {
    if (w[j] != 0.0f) {
      const float term = (h * w[j]) * k[j][c];
      v = first ? term : v + term;
      first = false;
    }
  }
  return v;
}

// The RMS of this thread's three values q over the N components of the batch.
__device__ __forceinline__ float rms(const Me& me, const float* q, int N, double* red) {
  double acc = 0.0;
  if (me.on)
    for (int c = 0; c < 3; ++c) acc += (double)(q[c] * q[c]);
  return sqrtf((float)xsum(acc, red) / (float)N);
}

// One attempt from (t, y, k[0] = f(t, y)) with the step h: the stages
// k[1..6], y1 (= the stage-6 state) and the error ratio.
__device__ float attempt(const Net& n, const XSh& s, const Me& me, const Sel& sel, int N, float t,
                         float h, const float* y, float (&k)[kStages][3], float* y1) {
  float ys[3];
#pragma unroll
  for (int i = 1; i < kStages; ++i) {
    float* dst = i == kStages - 1 ? y1 : ys;
    stage(i, h, y, k, dst);
    xor_drift(n, s, me, t + kC[i] * h, dst, k[i]);
  }
  float q[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float err = weighted3(kBErr, h, k, c);
    q[c] = err / (sel.atol + sel.rtol * fmaxf(fabsf(y[c]), fabsf(y1[c])));
  }
  return rms(me, q, N, s.red);
}

// Hairer's initial step (network_ode.py initial_step_size) from (t0, y, f0).
__device__ float initial_step(const Net& n, const XSh& s, const Me& me, const Sel& sel, int N,
                              float t0, const float* y, const float* f0) {
  float q0[3], q1[3], y1[3], f1[3], q2[3];
  for (int c = 0; c < 3; ++c) {
    const float scale = sel.atol + sel.rtol * fabsf(y[c]);
    q0[c] = y[c] / scale;
    q1[c] = f0[c] / scale;
  }
  const float d0 = rms(me, q0, N, s.red), d1 = rms(me, q1, N, s.red);
  const float h0 = (d0 < 1e-5f || d1 < 1e-5f) ? 1e-6f : (0.01f * d0) / d1;
  for (int c = 0; c < 3; ++c) y1[c] = y[c] + h0 * f0[c];
  xor_drift(n, s, me, t0 + h0, y1, f1);
  for (int c = 0; c < 3; ++c) q2[c] = (f1[c] - f0[c]) / (sel.atol + sel.rtol * fabsf(y[c]));
  const float d2 = rms(me, q2, N, s.red) / h0;
  const float h1 = (d1 <= 1e-15f && d2 <= 1e-15f)
                       ? fmaxf(h0 * 1e-3f, 1e-6f)
                       : expf((float)(1.0 / 5) * logf(0.01f / fmaxf(d1, d2)));
  return nan_min(100.0f * h0, h1);
}

__device__ __forceinline__ void load3(const Me& me, const float* src, float* y) {
  for (int c = 0; c < 3; ++c) y[c] = me.on ? src[comp(me, c)] : 0.0f;
}

__device__ __forceinline__ void store3(const Me& me, const float* y, float* dst) {
  if (me.on)
    for (int c = 0; c < 3; ++c) dst[comp(me, c)] = y[c];
}

// B6x: the whole selection of the batch.
__global__ void __launch_bounds__(kXMaxThreads)
xor_select_kernel(Net n, Sel sel, const float* __restrict__ consts, const float* __restrict__ rows,
                  const float* __restrict__ y0, float* __restrict__ st, int* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char sm[];
  const XSh s = xsh_load(sm, n.B, consts, rows);
  const Me me = me_of(n.B);
  const int N = n.B * kXS, M = sel.max_steps;
  for (int i = threadIdx.x; i <= M; i += blockDim.x) st[i] = i == 0 ? sel.t_start : sel.t_end;
  float y[3], k[kStages][3], y1[3];
  load3(me, y0, y);
  float t = sel.t_start;
  xor_drift(n, s, me, t, y, k[0]);
  float h = sel.use_initial ? initial_step(n, s, me, sel, N, t, y, k[0]) : sel.dt0;
  h = nan_min(h, sel.span);
  int na = 0, nr = 0;
  while (t < sel.t_end && na < M && nr < 4 * M + 64) {
    h = nan_min(h, sel.t_end - t);
    const float ratio = attempt(n, s, me, sel, N, t, h, y, k, y1);
    if (ratio <= 1.0f) {
      t = t + h;
      for (int c = 0; c < 3; ++c) {
        y[c] = y1[c];
        k[0][c] = k[kStages - 1][c];
      }
      ++na;
    } else {
      ++nr;
    }
    if (threadIdx.x == 0) st[na] = t;
    h = next_step(h, ratio);
  }
  if (threadIdx.x == 0) {
    stats[0] = na;
    stats[1] = nr;
    stats[2] = t >= sel.t_end ? 1 : 0;
  }
}

// One attempt of that kernel's loop: y1, f1 = k6, rec = (ratio, h, next h).
__global__ void __launch_bounds__(kXMaxThreads)
xor_attempt_kernel(Net n, Sel sel, const float* __restrict__ consts,
                   const float* __restrict__ rows, const float* __restrict__ t_in,
                   const float* __restrict__ h_in, const float* __restrict__ y_in,
                   const float* __restrict__ f0, float* __restrict__ y1_out,
                   float* __restrict__ f1_out, float* __restrict__ rec) {
  extern __shared__ __align__(16) unsigned char sm[];
  const XSh s = xsh_load(sm, n.B, consts, rows);
  const Me me = me_of(n.B);
  float y[3], k[kStages][3], y1[3];
  load3(me, y_in, y);
  load3(me, f0, k[0]);
  const float t = t_in[0];
  const float h = nan_min(h_in[0], sel.t_end - t);
  const float ratio = attempt(n, s, me, sel, n.B * kXS, t, h, y, k, y1);
  store3(me, y1, y1_out);
  store3(me, k[kStages - 1], f1_out);
  if (threadIdx.x == 0) {
    rec[0] = ratio;
    rec[1] = h;
    rec[2] = next_step(h, ratio);
  }
}

// B7x: per step k < n, ys[k] = y, then the step from (st[k], y) with
// h = st[k+1] - st[k] and its five dense rows
//   r1 = y, r2 = dy = y1 - y, r3 = h k0 - dy, r4 = (dy - h k6) - r3,
//   r5 = sum_j (h d_j) k_j.
__global__ void __launch_bounds__(kXMaxThreads)
xor_replay_fwd_kernel(Net n, int n_steps, const float* __restrict__ consts,
                      const float* __restrict__ rows, const float* __restrict__ st,
                      const float* __restrict__ y0, float* __restrict__ ys,
                      float* __restrict__ coeffs) {
  extern __shared__ __align__(16) unsigned char sm[];
  const XSh s = xsh_load(sm, n.B, consts, rows);
  const Me me = me_of(n.B);
  const size_t N = (size_t)n.B * kXS;
  float y[3], k[kStages][3], ys_[3], y1[3];
  load3(me, y0, y);
  for (int kk = 0; kk < n_steps; ++kk) {
    const float t0 = st[kk], h = st[kk + 1] - t0;
    xor_drift(n, s, me, t0, y, k[0]);
#pragma unroll
    for (int i = 1; i < kStages; ++i) {
      float* dst = i == kStages - 1 ? y1 : ys_;
      stage(i, h, y, k, dst);
      xor_drift(n, s, me, t0 + kC[i] * h, dst, k[i]);
    }
    if (me.on) {
      float* yk = ys + kk * N;
      float* ck = coeffs + kk * 5 * N;
      for (int c = 0; c < 3; ++c) {
        const int o = comp(me, c);
        const float dy = y1[c] - y[c];
        const float r3 = h * k[0][c] - dy;
        yk[o] = y[c];
        ck[o] = y[c];
        ck[N + o] = dy;
        ck[2 * N + o] = r3;
        ck[3 * N + o] = (dy - h * k[kStages - 1][c]) - r3;
        ck[4 * N + o] = weighted3(kD, h, k, c);
      }
    }
    for (int c = 0; c < 3; ++c) y[c] = y1[c];
  }
}

// B8x, kernel mode: the reverse sweep over steps n-1..0. Per step, with the
// cotangents ybar (on y1, carried from the later steps) and c1..c5 (on the
// dense rows): rebuild the stage states Y0..Y6 from ys[k], then
//   r3bar = c3 - c4;  dybar = (c2 + c4) - r3bar;  y1bar = ybar + dybar
//   kbar_j = (h d_j) c5;  kbar_6 -= h c4;  kbar_0 += h r3bar
//   kbar_j += (h b_j) y1bar;  ysum = (c1 - dybar) + y1bar
//   for i = 6..0:  g = f^T|_{Y_i} kbar_i;  ysum += g;  kbar_j += (h a_ij) g
// and ybar = ysum. Each drift VJP's row cotangents (contracted over the
// lanes) add from stage 6 down; the step's sums add to the accumulators.
__global__ void __launch_bounds__(kXMaxThreads)
xor_replay_bwd_kernel(Net n, int n_steps, const float* __restrict__ consts,
                      const float* __restrict__ rows, const float* __restrict__ st,
                      const float* __restrict__ ys, const float* __restrict__ cobar,
                      float* __restrict__ ybar_out, float* __restrict__ drows) {
  extern __shared__ __align__(16) unsigned char sm[];
  const XSh s = xsh_load(sm, n.B, consts, rows);
  const Me me = me_of(n.B);
  const size_t N = (size_t)n.B * kXS;
  float Y[kStages][3], kk[kStages][3], ysum[3] = {0.0f, 0.0f, 0.0f}, g[3];
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int k = n_steps - 1; k >= 0; --k) {
    const float t0 = st[k], h = st[k + 1] - t0;
    load3(me, ys + k * N, Y[0]);
    xor_drift(n, s, me, t0, Y[0], kk[0]);
#pragma unroll
    for (int i = 1; i < kStages; ++i) {
      stage(i, h, Y[0], kk, Y[i]);
      if (i < kStages - 1) xor_drift(n, s, me, t0 + kC[i] * h, Y[i], kk[i]);
    }
    const float* ck = cobar + k * 5 * N;
    for (int c = 0; c < 3; ++c) {
      const int o = me.on ? comp(me, c) : 0;
      const float c1 = ck[o], c2 = ck[N + o], c3 = ck[2 * N + o], c4 = ck[3 * N + o],
                  c5 = ck[4 * N + o];
      const float r3bar = c3 - c4;
      const float dybar = (c2 + c4) - r3bar;
      const float y1bar = ysum[c] + dybar;
#pragma unroll
      for (int j = 0; j < kStages; ++j) {
        float v = kD[j] != 0.0f ? (h * kD[j]) * c5 : 0.0f;
        if (j == kStages - 1) v = v - h * c4;
        if (j == 0) v = v + h * r3bar;
        if (kB[j] != 0.0f) v = v + (h * kB[j]) * y1bar;
        kk[j][c] = v;
      }
      ysum[c] = (c1 - dybar) + y1bar;
    }
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int i = kStages - 1; i >= 0; --i) {
      float d0 = 0.0f, d1 = 0.0f;
      xor_drift_vjp(n, s, me, i ? t0 + kC[i] * h : t0, Y[i], kk[i], g, d0, d1);
      s0 = i == kStages - 1 ? d0 : s0 + d0;
      s1 = i == kStages - 1 ? d1 : s1 + d1;
      for (int c = 0; c < 3; ++c) {
        ysum[c] = ysum[c] + g[c];
        for (int j = 0; j < i; ++j) {
          const float a = kA[i][j];
          if (a != 0.0f) kk[j][c] = kk[j][c] + (h * a) * g[c];
        }
      }
    }
    acc0 = acc0 + s0;
    acc1 = acc1 + s1;
  }
  store3(me, ysum, ybar_out);
  store_rows(me, acc0, acc1, drows);
}

template <typename Kern>
int launch_setup(Kern kernel, int B, int K, size_t* bytes, int* threads) {
  if (int e = check_xor(B, K)) return e;
  *threads = xor_threads(B);
  *bytes = xsh_bytes(B, *threads);
  return set_smem(kernel, *bytes);
}

}  // namespace

extern "C" {

// consts: w24 (24 x 24, row = target), bg24 (24), adapt (24); rows: w00, w01
// (16 each), w10, w11 (8 each); kv: knot values (K, B, 32).
// hc (host): tau_s, tau_m, tau_a, R, sigma, kc0[K-1], kd[K-1];
// hs (host): t_start, t_end, rtol, atol, dt0, t_end - t_start.
int cf_xor_select(int B, int K, const float* hc, const float* hs, int use_initial, int max_steps,
                  const float* consts, const float* rows, const float* kv, const float* y0,
                  float* st, int* stats, void* stream) {
  size_t bytes;
  int threads;
  if (int e = launch_setup(xor_select_kernel, B, K, &bytes, &threads)) return e;
  xor_select_kernel<<<1, threads, bytes, (cudaStream_t)stream>>>(
      make_xor_net(B, K, hc, kv), make_sel(hs, use_initial, max_steps), consts, rows, y0, st,
      stats);
  return (int)cudaGetLastError();
}

int cf_xor_attempt(int B, int K, const float* hc, const float* hs, const float* consts,
                   const float* rows, const float* kv, const float* t, const float* h,
                   const float* y, const float* f0, float* y1, float* f1, float* rec,
                   void* stream) {
  size_t bytes;
  int threads;
  if (int e = launch_setup(xor_attempt_kernel, B, K, &bytes, &threads)) return e;
  xor_attempt_kernel<<<1, threads, bytes, (cudaStream_t)stream>>>(
      make_xor_net(B, K, hc, kv), make_sel(hs, 0, 0), consts, rows, t, h, y, f0, y1, f1, rec);
  return (int)cudaGetLastError();
}

int cf_xor_replay_fwd(int B, int K, const float* hc, int n_steps, const float* consts,
                      const float* rows, const float* kv, const float* st, const float* y0,
                      float* ys, float* coeffs, void* stream) {
  size_t bytes;
  int threads;
  if (int e = launch_setup(xor_replay_fwd_kernel, B, K, &bytes, &threads)) return e;
  xor_replay_fwd_kernel<<<1, threads, bytes, (cudaStream_t)stream>>>(
      make_xor_net(B, K, hc, kv), n_steps, consts, rows, st, y0, ys, coeffs);
  return (int)cudaGetLastError();
}

int cf_xor_replay_bwd(int B, int K, const float* hc, int n_steps, const float* consts,
                      const float* rows, const float* kv, const float* st, const float* ys,
                      const float* cobar, float* ybar, float* drows, void* stream) {
  size_t bytes;
  int threads;
  if (int e = launch_setup(xor_replay_bwd_kernel, B, K, &bytes, &threads)) return e;
  xor_replay_bwd_kernel<<<1, threads, bytes, (cudaStream_t)stream>>>(
      make_xor_net(B, K, hc, kv), n_steps, consts, rows, st, ys, cobar, ybar, drows);
  return (int)cudaGetLastError();
}

}  // extern "C"
