// What the column-network kernels share (network_sde.cu, network_ode.cu):
// the drift's constants, the firing rate and its derivative, the knot
// stimulus, bf16 rounding, the block-wide float64 sum (block_sum.cuh), and
// the host-side helpers that fill the constants and size the shared memory. Included once
// per source; every source is its own library, so the definitions live in an
// unnamed namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxKnots = 8;
constexpr int kMaxInputs = 16;

typedef __nv_bfloat16 bf16;

struct Net {
  int P, n_in, K, B;  // populations, inputs, knots, lanes of the knot table
  float tau_s, tau_m, tau_a, R, sigma;
  float kc0[kMaxKnots], kd[kMaxKnots];  // segment k (1..K-1) at index k-1
  const float* bg;
  const float* adapt;
  const float* kv;  // knot values (K, B, n_in)
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---------------------------------------------------------------------------
// Firing rate (ops/transfer.py) and its derivative (models/network.py
// fr_and_grad): at the removable singularity the rate is 1/d and the
// derivative 0, as jax.grad of the guarded function gives.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float firing_rate(float x) {
  const float xn = 48.0f * x - 981.0f;
  const float th = tanhf((-0.0089f * xn) / 80.0f);
  const float e = expf(80.0f * th);
  const float den = 1.0f - e;
  const bool near = fabsf(den) < 1e-12f;
  return near ? (float)(1.0 / 0.0089) : xn / (near ? 1.0f : den);
}

__device__ __forceinline__ void fr_and_grad(float x, float& fr, float& frp) {
  const float xn = 48.0f * x - 981.0f;
  const float th = tanhf((-0.0089f * xn) / 80.0f);
  const float e = expf(80.0f * th);
  const float den = 1.0f - e;
  const bool near = fabsf(den) < 1e-12f;
  const float sden = near ? 1.0f : den;
  fr = near ? (float)(1.0 / 0.0089) : xn / sden;
  const float dden = (e * 0.0089f) * (1.0f - th * th);
  const float dfr = (sden - xn * dden) / (sden * sden);
  frp = near ? 0.0f : 48.0f * dfr;
}

// ext[m] of lane b at time t: interp_knots in its telescoped form.
__device__ __forceinline__ float knot_interp(const Net& n, int b, int m, float t) {
  const float* kv = n.kv;
  float out = kv[(size_t)b * n.n_in + m];
  for (int k = 1; k < n.K; ++k) {
    const float frac = fminf(fmaxf((t - n.kc0[k - 1]) / n.kd[k - 1], 0.0f), 1.0f);
    const float v1 = kv[((size_t)k * n.B + b) * n.n_in + m];
    const float v0 = kv[((size_t)(k - 1) * n.B + b) * n.n_in + m];
    out = out + frac * (v1 - v0);
  }
  return out;
}

Net make_net(int B, int P, int n_in, int K, const float* hc, const float* bg,
             const float* adapt, const float* kv) {
  Net n;
  n.P = P;
  n.n_in = n_in;
  n.K = K;
  n.B = B;
  n.tau_s = hc[0];
  n.tau_m = hc[1];
  n.tau_a = hc[2];
  n.R = hc[3];
  n.sigma = hc[4];
  for (int k = 0; k < kMaxKnots; ++k) {
    n.kc0[k] = k < K - 1 ? hc[5 + k] : 0.0f;
    n.kd[k] = k < K - 1 ? hc[5 + (K - 1) + k] : 1.0f;
  }
  n.bg = bg;
  n.adapt = adapt;
  n.kv = kv;
  return n;
}

int check_shape(int P, int n_in, int K) {
  if (P <= 0 || P % 2 || n_in > kMaxInputs || K < 1 || K > kMaxKnots) return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename Kern>
int set_smem(Kern kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
