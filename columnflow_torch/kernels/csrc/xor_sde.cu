// XOR-network fixed-grid SDE kernels for Hopper (sm_90a): SRA1 on the uniform
// grid and its reverse sweep in kernel mode. Plain C entry points, loaded
// with ctypes by columnflow_torch/kernels/_build.py; each returns
// cudaGetLastError().
//
// Replaces (columnflow/solvers/fused.py, the kernels of sdeint_fused traced
// with columnflow/models/xor.py xor_drift_batched and the membrane-only
// diffusion sigma = 10, method "srk", noise_shape (B, 1)):
//   cf_xor_sde_fwd  <- _make_sde_chunk_kernel, uniform grid (B3u): the SRA1
//                      steps, each lane's scalar Brownian integrals (i1, i10)
//                      broadcast over its 72 components
//   cf_xor_sde_bwd  <- _make_sde_bwd_chunk_kernel, kernel mode (B4'): the
//                      VJP of each step through the stored trajectory (f1 and
//                      the second stage's state recomputed) w.r.t. the state
//                      and the four feedforward rows
//
// What bounds them: a serial chain of 999 steps of 2 drift evaluations
// forward (1 drift and 2 VJPs backward) of a (4, 72) state: ~10^4
// operations a step, nanoseconds of the card's peak; the time is the latency
// of one step. Design: as xor_ode.cu, one block holds the batch (jax.vjp
// contracts each row's cotangent over the batch inside every drift VJP),
// one thread per (lane, population), state and stage values in registers.
// The step times t0s come from the host (solvers/fused.py
// uniform_step_times: the JAX kernel's float32 arithmetic per chunk).
//
// Precision: as xor_drift.cuh; each step rounds as solvers/sde.py _sra1_step
// (and kernels/xor_sde.py xor_sde_step_vjp backward).

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

}  // extern "C"
