// B3t-team and B4t, the column network's SRA1 replay over the frozen
// half-step grids on the three-term split and its emit-mode reverse sweep,
// as Hopper cluster teams, one per lane, on ode_team.cuh's team functions.
//   cf_sde3_fwd_team      <- columnflow/solvers/fused.py _make_sde_chunk_kernel
//                            with prepare_premixed_split (B3t-team), lanes or
//                            the uniform grid
//   cf_sde3_bwd_emit      <- _make_sde_bwd_chunk_kernel(emit_steps=True) with
//                            prepare_premixed_split (B4t): the state cotangent
//                            alone and each step's total output cotangent
//   cf_sde3_max_clusters  how many of either kernel's clusters the card holds
//                         at once (what picks the cluster size)
// Plain C entry points, loaded with ctypes by
// columnflow_torch/kernels/_build.py; each returns cudaGetLastError().
//
// What bounds them on this card: the serial chain of half steps (~2.2 * 10^4
// a lane over the second at 104 columns on the exact engine's grids), each
// two drift evaluations (B3t-team) or one drift and two drift VJPs (B4t),
// every one a (P, P) product on each of the split's three bf16 terms: a few
// MFLOP, whose latency is what costs. The 8-block teams they replace
// (network_sde.cu sde3_fwd_team_kernel / sde3_bwd_emit_kernel, kept as the
// yardstick: cf_sde3_fwd_team_team8, cf_sde3_bwd_emit_team8) read the three
// terms and their transposes from L2 in every product, kept the lane's state
// vectors in global scratch and put a block barrier between every
// elementwise pass.
//
// Design (ode_team.cuh, as B7t-team and B8't): a cluster of C blocks per
// lane (16 where 16 divides P and the card holds a cluster of 16 for every
// lane at once, else 8; the wrapper picks C and passes it). Block r owns
// populations [r nc, (r+1) nc), nc = P / C, whose states live in the
// registers of threads 0..nc-1, and keeps the columns [r nc, (r+1) nc) of
// the split in shared memory: the packed bf16 terms (ode_team_pack), or,
// where those would stream and the float32 wT fits (90-104 columns on
// clusters of 16), the float32 wT, split into its three terms as it is read
// (ode_replay_pack, Plan3 f32); resident where the plan fits it, else
// streamed through tma_ring.cuh's ring of tiles, whose sequence runs on
// across drifts, VJPs and steps. A drift sums its products in the 8-block
// team's order (t3_fwd_chunks: contiguous chunks of rows, the chunks' sums
// in order), so that it equals team8 and the plain version bit for bit; a
// VJP sends each row's partial sums over the block's own columns to the
// row's owner (t3_vjp), so no transposed copy of the weights is made. The
// forward's owners write a step's output row after the next step's first
// cluster barrier, so that the barrier's release does not wait for the
// stores; the sweep reads a step's state and direct cotangent one step
// ahead.
//
// The SRA1 step around the drift, from sde3_fwd_team_kernel and
// sde3_bwd_emit_kernel (which transcribe the plain versions, and through them
// step_vjp_split3), operation for operation in float32 (-fmad=false):
//   i10h = i10 / (h > 0 ? h : 1);  h2 = (y + (0.75 h) f1) + (1.5 i10h) sigma
//   forward: y' = ((y + h (f1 / 3 + (2 f2) / 3)) + (di1 - i10h) sigma)
//                 + i10h sigma, f2 = f(t0 + 0.75 h, h2)
//   sweep:   c = ybar + ysbar[k] (-> seeds[k]); c_h2 = f^T|_{h2} (((h c) / 3) 2)
//            c_y = f^T|_y ((h c) / 3 + (0.75 h) c_h2); ybar = (c + c_h2) + c_y,
//            zeroed after every step k with k % stride == 0.
// Rows past n_real: the forward repeats the last state, the sweep's seeds
// are zero.

#include "dopri5.cuh"
#include "ode_team.cuh"

namespace {

// A lane's half-step grid: t0s, hs (n, B) per lane (lanes 1) or (n,) shared
// by every lane (the uniform grid); i1, i10 (n, B).
struct SdeGrid {
  int n_steps, n_real, lanes;
  const float *t0s, *hs, *i1, *i10;
  __device__ __forceinline__ size_t at(int k, int b, int B) const {
    return lanes ? (size_t)k * B + b : (size_t)k;
  }
};

// One half step's scalars of lane b: t0, h, the Brownian increment and
// i10 / h (h == 0 padding divides by 1).
struct HalfStep {
  float t0, h, di1, i10h;
};

__device__ __forceinline__ HalfStep half_step(const SdeGrid& g, int k, int b, int B) {
  HalfStep s;
  s.t0 = g.t0s[g.at(k, b, B)];
  s.h = g.hs[g.at(k, b, B)];
  s.di1 = g.i1 ? g.i1[(size_t)k * B + b] : 0.0f;
  s.i10h = g.i10[(size_t)k * B + b] / (s.h > 0.0f ? s.h : 1.0f);
  return s;
}

// sde_select.cuh's sra1_final (that header's Sel would clash with
// dopri5.cuh's): the SRA1 update from the two stage drifts.
__device__ __forceinline__ float sra1_update(float y, float f1, float f2, float h, float dw,
                                             float i10h, float sigma) {
  return ((y + h * (f1 / 3.0f + (2.0f * f2) / 3.0f)) + (dw - i10h) * sigma) + i10h * sigma;
}

// B3t-team: lane blockIdx.x / C over steps 0..n_real-1 from y0 (B, 3P);
// ys (n_steps + 1, B, 3P): ys[0] = y0, ys[k + 1] after step k, the rows
// past n_real the carried state. kF32: the slice holds the float32 wT.
template <bool kStream, bool kF32>
__global__ void __launch_bounds__(kThreads, 1)
sde3_replay16_kernel(Net n, int C, SdeGrid g, const uint32_t* __restrict__ wpk,
                     const float* __restrict__ iw, const float* __restrict__ y0,
                     float* __restrict__ ys) {
  extern __shared__ __align__(16) unsigned char smt[];
  Team3 T;
  const int b = blockIdx.x / C;
  team3_init(T, smt, n, 1, 3, kT3Replay, b, wpk, iw, kStream, C);
  const int P = n.P, B = n.B;
  const size_t N = (size_t)B * 3 * P;  // a (B, 3P) row of ys
  const bool own = threadIdx.x < T.p.nc;
  const size_t col = (size_t)b * 3 * P + T.c0 + threadIdx.x;
  float y[1][3], h2[1][3], f1[1][3], f2[1][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) y[0][c] = own ? y0[col + c * P] : 0.0f;
  int done = 0;  // the row of ys that holds y and is still to be written
  auto store = [&]() {
    if (own && done >= 0) {
      float* o = ys + (size_t)done * N + col;
#pragma unroll
      for (int c = 0; c < 3; ++c) o[c * P] = y[0][c];
    }
    done = -1;
  };
  HalfStep nx = g.n_real > 0 ? half_step(g, 0, b, B) : HalfStep{};
  for (int k = 0; k < g.n_real; ++k) {
    const HalfStep s = nx;
    if (k + 1 < g.n_real) nx = half_step(g, k + 1, b, B);  // the next step's, early
    t3_drift<3, 1, 1, kStream, kF32, true>(n, T, s.t0, y, f1, store);
    const float a = 0.75f * s.h, kk = 1.5f * s.i10h;
#pragma unroll
    for (int c = 0; c < 3; ++c) h2[0][c] = (y[0][c] + a * f1[0][c]) + kk * n.sigma;
    t3_drift<3, 1, 1, kStream, kF32, true>(n, T, s.t0 + 0.75f * s.h, h2, f2);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      y[0][c] = sra1_update(y[0][c], f1[0][c], f2[0][c], s.h, s.di1, s.i10h, n.sigma);
    done = k + 1;
  }
  store();
  if (own) {
    for (int k = g.n_real; k < g.n_steps; ++k) {
      float* o = ys + (size_t)(k + 1) * N + col;
#pragma unroll
      for (int c = 0; c < 3; ++c) o[c * P] = y[0][c];
    }
  }
  if (kStream) t2_drain(T);
}

// B4t: lane blockIdx.x / C over steps n_real-1..0: ys_prev, ysbar, seeds
// (n_steps, B, 3P) the step-start states, the direct cotangents on each
// step's output and the total ones (zero from n_real on); ybar_out (B, 3P)
// the cotangent on y0; stride: truncation (0: none). kF32: the slice holds
// the float32 wT.
template <bool kStream, bool kF32>
__global__ void __launch_bounds__(kThreads, 1)
sde3_emit16_kernel(Net n, int C, SdeGrid g, int stride, const uint32_t* __restrict__ wpk,
                   const float* __restrict__ iw, const float* __restrict__ ys_prev,
                   const float* __restrict__ ysbar, float* __restrict__ ybar_out,
                   float* __restrict__ seeds) {
  extern __shared__ __align__(16) unsigned char smt[];
  Team3 T;
  const int b = blockIdx.x / C;
  team3_init(T, smt, n, 1, 3, kT3SdeSweep, b, wpk, iw, kStream, C);
  const int P = n.P, B = n.B;
  const size_t N = (size_t)B * 3 * P;
  const bool own = threadIdx.x < T.p.nc;
  const size_t col = (size_t)b * 3 * P + T.c0 + threadIdx.x;
  if (own) {
    for (int k = g.n_real; k < g.n_steps; ++k) {
#pragma unroll
      for (int c = 0; c < 3; ++c) seeds[(size_t)k * N + col + c * P] = 0.0f;
    }
  }
  float yb[3] = {0.0f, 0.0f, 0.0f}, yn[3] = {0.0f, 0.0f, 0.0f}, sn[3] = {0.0f, 0.0f, 0.0f};
  const int last = g.n_real - 1;
  if (own && last >= 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      yn[c] = ys_prev[(size_t)last * N + col + c * P];
      sn[c] = ysbar[(size_t)last * N + col + c * P];
    }
  }
  HalfStep nx = last >= 0 ? half_step(g, last, b, B) : HalfStep{};
  for (int k = last; k >= 0; --k) {
    const HalfStep s = nx;
    float y[1][3], cc[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      y[0][c] = yn[c];
      cc[c] = yb[c] + sn[c];
    }
    if (own) {
#pragma unroll
      for (int c = 0; c < 3; ++c) seeds[(size_t)k * N + col + c * P] = cc[c];
    }
    if (k >= 1) {  // the next step's state, cotangent and scalars, one step ahead
      nx = half_step(g, k - 1, b, B);
      if (own) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          yn[c] = ys_prev[(size_t)(k - 1) * N + col + c * P];
          sn[c] = ysbar[(size_t)(k - 1) * N + col + c * P];
        }
      }
    }
    float f1[1][3], h2[3], cw[3], ch2[3] = {0.0f, 0.0f, 0.0f}, cy[3] = {0.0f, 0.0f, 0.0f};
    t3_drift<3, 1, 1, kStream, kF32, true>(n, T, s.t0, y, f1);
    const float a = 0.75f * s.h, kk = 1.5f * s.i10h;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      h2[c] = (y[0][c] + a * f1[0][c]) + kk * n.sigma;
      cw[c] = ((s.h * cc[c]) / 3.0f) * 2.0f;
    }
    t3_vjp<3, kStream, kF32>(n, T, h2, cw, ch2);
#pragma unroll
    for (int c = 0; c < 3; ++c) cw[c] = (s.h * cc[c]) / 3.0f + a * ch2[c];
    t3_vjp<3, kStream, kF32>(n, T, y[0], cw, cy);
    const bool cut = stride > 0 && k % stride == 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) yb[c] = cut ? 0.0f : (cc[c] + ch2[c]) + cy[c];
  }
  if (own) {
#pragma unroll
    for (int c = 0; c < 3; ++c) ybar_out[col + c * P] = yb[c];
  }
  if (kStream) t2_drain(T);
}

// The kernel instance of a plan: streamed or resident, the float32 slice or
// the bf16 terms.
template <bool kBwd, class F>
int instance(const Plan3& p, F&& f) {
  if constexpr (kBwd) {
    if (p.f32)
      return p.stream ? f(sde3_emit16_kernel<true, true>) : f(sde3_emit16_kernel<false, true>);
    return p.stream ? f(sde3_emit16_kernel<true, false>) : f(sde3_emit16_kernel<false, false>);
  } else {
    if (p.f32)
      return p.stream ? f(sde3_replay16_kernel<true, true>)
                      : f(sde3_replay16_kernel<false, true>);
    return p.stream ? f(sde3_replay16_kernel<true, false>)
                    : f(sde3_replay16_kernel<false, false>);
  }
}

}  // namespace

extern "C" {

// B3t-team as a cluster team of C blocks per lane (C 16 or 8, dividing P).
// wpk: the three bf16 terms of wT packed per block (ode_team_pack in
// kernels/network_ode.py: (C, P, rw) 32-bit words, the replay plan's
// layout), or where the plan says f32 the float32 wT's (ode_replay_pack);
// iw float32 (n_in, P); stream: 1 streams the slices through the ring even
// where they fit; lanes: t0s, hs are (n_steps, B) per lane (else (n_steps,)
// shared); i1, i10 (n_steps, B); y0 (B, 3P); ys (n_steps + 1, B, 3P). hc:
// the drift's host constants (cf_sde3_fwd's).
int cf_sde3_fwd_team(int B, int P, int n_in, int K, const float* hc, int n_steps, int n_real,
                     int lanes, int C, int stream, const float* bg, const float* adapt,
                     const void* wpk, const float* iw, const float* kv, const float* t0s,
                     const float* hs, const float* i1, const float* i10, const float* y0,
                     float* ys, void* cstream) {
  Plan3 p;
  if (int e = team3_plan(B, P, n_in, K, 1, 3, kT3Replay, stream, &p, C)) return e;
  if (n_real < 0 || n_real > n_steps) return (int)cudaErrorInvalidValue;
  const Net n = make_net(B, P, n_in, K, hc, bg, adapt, kv);
  const SdeGrid g{n_steps, n_real, lanes, t0s, hs, i1, i10};
  const uint32_t* w = (const uint32_t*)wpk;
  const cudaStream_t s = (cudaStream_t)cstream;
  return instance<false>(p, [&](auto kernel) {
    return team2_launch(kernel, p, B, s, n, p.C, g, w, iw, y0, ys);
  });
}

// B4t as a cluster team of C blocks per lane; wpk, iw, stream, lanes, t0s,
// hs and i10 as cf_sde3_fwd_team's (the sweep's plan, kT3SdeSweep);
// ys_prev, ysbar, seeds (n_steps, B, 3P); ybar (B, 3P); stride: truncation
// every stride steps (0: none).
int cf_sde3_bwd_emit(int B, int P, int n_in, int K, const float* hc, int n_steps, int n_real,
                     int lanes, int stride, int C, int stream, const float* bg,
                     const float* adapt, const void* wpk, const float* iw, const float* kv,
                     const float* t0s, const float* hs, const float* i10,
                     const float* ys_prev, const float* ysbar, float* ybar, float* seeds,
                     void* cstream) {
  Plan3 p;
  if (int e = team3_plan(B, P, n_in, K, 1, 3, kT3SdeSweep, stream, &p, C)) return e;
  if (n_real < 0 || n_real > n_steps) return (int)cudaErrorInvalidValue;
  const Net n = make_net(B, P, n_in, K, hc, bg, adapt, kv);
  const SdeGrid g{n_steps, n_real, lanes, t0s, hs, nullptr, i10};
  const uint32_t* w = (const uint32_t*)wpk;
  const cudaStream_t s = (cudaStream_t)cstream;
  return instance<true>(p, [&](auto kernel) {
    return team2_launch(kernel, p, B, s, n, p.C, g, stride, w, iw, ys_prev, ysbar, ybar, seeds);
  });
}

// cudaOccupancyMaxActiveClusters of B3t-team (bwd 0) or B4t (bwd 1) with
// clusters of C blocks (streamed or resident as the plan holds the slice):
// how many lanes' teams run at once.
int cf_sde3_max_clusters(int P, int n_in, int C, int stream, int bwd, int* out) {
  Plan3 p;
  if (int e = team3_plan(1, P, n_in, 1, 1, 3, bwd ? kT3SdeSweep : kT3Replay, stream, &p, C))
    return e;
  const auto clusters = [&](auto kernel) { return team2_max_clusters(kernel, p, out); };
  return bwd ? instance<true>(p, clusters) : instance<false>(p, clusters);
}

}  // extern "C"
