// The dopri5 pieces every dopri5 kernel shares (network_ode.cu, xor_ode.cu,
// hopf_ode.cu): the Dormand-Prince 4(5) tableau with Hairer's CONTD5 weights
// (columnflow_torch/solvers/rk.py), the selection's settings and its I
// controller (kernels/network_ode.py _next_step_size), a component's stage
// state and weighted stage sum as the plain versions round them, and the
// block-wide float64 sum of the error norm (block_sum.cuh). Included once per
// source; every source is its own library, so the definitions live in an
// unnamed namespace.

#pragma once

#include <cuda_runtime.h>

#include "block_sum.cuh"

namespace {

constexpr int kStages = 7;

// Dormand-Prince 4(5) and Hairer's CONTD5 weights (solvers/rk.py), each a
// double expression rounded to float32 once.
#define F(x) ((float)(x))
__constant__ float kC[kStages] = {0.0f, F(1.0 / 5), F(3.0 / 10), F(4.0 / 5), F(8.0 / 9), 1.0f, 1.0f};
__constant__ float kA[kStages][kStages - 1] = {
    {0, 0, 0, 0, 0, 0},
    {F(1.0 / 5), 0, 0, 0, 0, 0},
    {F(3.0 / 40), F(9.0 / 40), 0, 0, 0, 0},
    {F(44.0 / 45), F(-56.0 / 15), F(32.0 / 9), 0, 0, 0},
    {F(19372.0 / 6561), F(-25360.0 / 2187), F(64448.0 / 6561), F(-212.0 / 729), 0, 0},
    {F(9017.0 / 3168), F(-355.0 / 33), F(46732.0 / 5247), F(49.0 / 176), F(-5103.0 / 18656), 0},
    {F(35.0 / 384), 0, F(500.0 / 1113), F(125.0 / 192), F(-2187.0 / 6784), F(11.0 / 84)},
};
__constant__ float kB[kStages] = {F(35.0 / 384), 0, F(500.0 / 1113), F(125.0 / 192),
                                  F(-2187.0 / 6784), F(11.0 / 84), 0};
__constant__ float kBErr[kStages] = {
    F(35.0 / 384 - 5179.0 / 57600), 0, F(500.0 / 1113 - 7571.0 / 16695),
    F(125.0 / 192 - 393.0 / 640), F(-2187.0 / 6784 - -92097.0 / 339200),
    F(11.0 / 84 - 187.0 / 2100), F(0.0 - 1.0 / 40)};
__constant__ float kD[kStages] = {
    F(-12715105075.0 / 11282082432.0), 0, F(87487479700.0 / 32700410799.0),
    F(-10690763975.0 / 1880347072.0), F(701980252875.0 / 199316789632.0),
    F(-1453857185.0 / 822651844.0), F(69997945.0 / 29380423.0)};
#undef F

struct Sel {
  float t_start, t_end, rtol, atol, dt0, span;  // span = t_end - t_start
  int use_initial, max_steps;
};

// The selection's settings; hs (host): t_start, t_end, rtol, atol, dt0,
// t_end - t_start.
Sel make_sel(const float* hs, int use_initial, int max_steps) {
  return Sel{hs[0], hs[1], hs[2], hs[3], hs[4], hs[5], use_initial, max_steps};
}

// min(a, b) that passes a NaN on, as torch.minimum does.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

// The I controller: h * clip(0.9 ratio^(-1/5), 0.2, 10), the power as
// exp(p log x); a NaN factor (ratio 0 gives +inf, clipped) passes through.
__device__ __forceinline__ float next_step(float h, float ratio) {
  float f = 0.9f * expf((float)(-1.0 / 5) * logf(ratio));
  if (f == f) f = fminf(fmaxf(f, 0.2f), 10.0f);
  return h * f;
}

// Stage state i (1..6) of one component:
// y + sum_j (h a_ij) k_j over the nonzero a_ij, left to right.
__device__ __forceinline__ float stage(int i, float h, float y, const float (&k)[kStages]) {
  float v = y;
  for (int j = 0; j < i; ++j) {
    const float a = kA[i][j];
    if (a != 0.0f) v = v + (h * a) * k[j];
  }
  return v;
}

// sum_j (h w_j) k_j of one component over the nonzero w_j, left to right,
// from the first term alone (network_ode.py _combine(None, ...)).
__device__ __forceinline__ float weighted(const float* w, float h, const float (&k)[kStages]) {
  float v = 0.0f;
  bool first = true;
#pragma unroll
  for (int j = 0; j < kStages; ++j) {
    if (w[j] != 0.0f) {
      const float term = (h * w[j]) * k[j];
      v = first ? term : v + term;
      first = false;
    }
  }
  return v;
}

}  // namespace
