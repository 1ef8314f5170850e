// The adaptive SDE selection's device code, shared by network_sde.cu (B5,
// B5t and the XLA selection on the column network's drift) and xor_sde.cu
// (the same on the XOR drift): the selection's settings, the counter-based
// RNG and the two Brownian trees (krng and jax.random), an attempt's
// Brownian data, the SRA1 combination and the PI controller. Included once
// per source; every source is its own library, so the definitions live in
// an unnamed namespace.
//
// Precision: float32 with full-precision expf/logf/sqrtf/log1pf and IEEE
// division, compiled with -fmad=false, so that every operation rounds as
// the plain PyTorch versions (kernels/network_sde.py attempt_plain,
// solvers/krng.py, solvers/jrandom.py, solvers/brownian.py) do.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Sel {
  float t_start, t_end, rtol, atol, h0, dt_min;
  int max_steps, depth;
};

Sel make_sel(const float* hs, int max_steps, int depth) {
  return Sel{hs[0], hs[1], hs[2], hs[3], hs[4], hs[5], max_steps, depth};
}

// ---------------------------------------------------------------------------
// Counter-based RNG and the two Brownian trees, the krng tree
// (solvers/krng.py) and the jax.random tree (solvers/brownian.py
// VirtualBrownianTree over solvers/jrandom.py). The bisection codes on a
// query's path depend only on t, t0 and t1, so an attempt draws each
// level's normal (a Threefry hash and an inverse normal CDF, two hashes
// and an erf_inv on the jax tree) on a thread of its own, and one thread
// per query then combines them in the one-thread walk's order and
// arithmetic (tree_combine), which keeps its bits.
// ---------------------------------------------------------------------------

enum TreeKind { kKrng = 0, kJax = 1 };
constexpr int kMaxDepth = 31;  // bisection codes fit 32 bits

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// Threefry-2x32, 20 rounds: (x0, x1) <- hash of the counter pair under (k0, k1).
__device__ void threefry2(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int r = 0; r < 5; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[r & 1][j]) ^ x0;
    }
    x0 += ks[(r + 1) % 3];
    x1 += ks[(r + 2) % 3] + (uint32_t)(r + 1);
  }
}

__device__ __forceinline__ uint32_t threefry_x0(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1) {
  threefry2(k0, k1, x0, x1);
  return x0;
}

__device__ float ndtri(float p) {
  const float p_tail = p < 0.5f ? p : 1.0f - p;
  const float p_safe = fmaxf(p_tail, 1e-38f);
  const float q = sqrtf(-2.0f * logf(p_safe));
  float num = (((((float)-7.784894002430293e-03 * q + (float)-3.223964580411365e-01) * q
                 + (float)-2.400758277161838e+00) * q + (float)-2.549732539343734e+00) * q
               + (float)4.374664141464968e+00) * q + (float)2.938163982698783e+00;
  float den = ((((float)7.784695709041462e-03 * q + (float)3.224671290700398e-01) * q
                + (float)2.445134137142996e+00) * q + (float)3.754408661907416e+00) * q + 1.0f;
  float x_tail = num / den;
  x_tail = p < 0.5f ? x_tail : -x_tail;
  const float qc = p - 0.5f;
  const float r = qc * qc;
  num = ((((((float)-3.969683028665376e+01 * r + (float)2.209460984245205e+02) * r
            + (float)-2.759285104469687e+02) * r + (float)1.383577518672690e+02) * r
          + (float)-3.066479806614716e+01) * r + (float)2.506628277459239e+00) * qc;
  den = (((((float)-5.447609879822406e+01 * r + (float)1.615858368580409e+02) * r
           + (float)-1.556989798598866e+02) * r + (float)6.680131188771972e+01) * r
         + (float)-1.328068155288572e+01) * r + 1.0f;
  const float x_central = num / den;
  const bool central = (p >= (float)0.02425) && (p <= (float)(1.0 - 0.02425));
  return central ? x_central : x_tail;
}

__device__ float normal2(uint32_t k0, uint32_t k1, uint32_t a, uint32_t b) {
  const uint32_t u = threefry_x0(k0, k1, a, b);
  const float m = (float)(int32_t)(u >> 9);
  return ndtri(m * 1.1920928955078125e-07f + 5.9604644775390625e-08f);
}

__device__ __forceinline__ uint32_t t_code(float t, float t0, float t1) {
  const float span = fmaxf(t1 - t0, 1e-38f);
  const float x = (t - t0) / span;
  return (uint32_t)(int32_t)(x * 1073741824.0f);
}

// The fold_in datum (jax tree) or counter (krng) of a tree's draw lvl for
// time t: 0 for the right end W(t1) (lvl 0), else the code of bisection
// lvl - 1's midpoint on t's path.
__device__ uint32_t jt_code(float t, float t0, float t1, int lvl) {
  if (lvl == 0) return 0u;
  t = fminf(fmaxf(t, t0), t1);
  float tl = t0, tr = t1;
  uint32_t code = 0u;
  for (int d = 0; d < lvl - 1; ++d) {
    const float tm = 0.5f * (tl + tr);
    if (t < tm) {
      tr = tm;
      code = code * 2u + 1u;
    } else {
      tl = tm;
      code = code * 2u + 2u;
    }
  }
  return code * 2u + 1u;
}

// W(t) of a tree from its depth + 1 normals z (lvl order): the one-thread
// walk's arithmetic (the krng tree clamps the span's square root at 0).
template <int kTree>
__device__ float tree_combine(float t, float t0, float t1, int depth, const float* z) {
  t = fminf(fmaxf(t, t0), t1);
  const float w_right = z[0] * sqrtf(kTree == kKrng ? fmaxf(t1 - t0, 0.0f) : t1 - t0);
  float tl = t0, tr = t1, wl = 0.0f, wr = w_right;
  for (int d = 0; d < depth; ++d) {
    const float tm = 0.5f * (tl + tr);
    const float wm = 0.5f * (wl + wr) + (0.5f * sqrtf(tr - tl)) * z[1 + d];
    if (t < tm) {
      tr = tm;
      wr = wm;
    } else {
      tl = tm;
      wl = wm;
    }
  }
  const float frac = tr > tl ? (t - tl) / (tr - tl) : 0.0f;
  return wl + frac * (wr - wl);
}

// The krng tree's draw lvl for time t.
__device__ __forceinline__ float kr_normal(uint32_t k0, uint32_t k1, float t, float t0, float t1,
                                           int lvl) {
  return normal2(k0, k1, jt_code(t, t0, t1, lvl), 0u);
}

// W(t) of the krng tree by one thread.
__device__ float tree_eval(uint32_t k0, uint32_t k1, float t, float t0, float t1, int depth) {
  float z[kMaxDepth + 1];
  for (int l = 0; l <= depth; ++l) z[l] = kr_normal(k0, k1, t, t0, t1, l);
  return tree_combine<kKrng>(t, t0, t1, depth, z);
}

// XLA's float32 erf_inv (Giles): w = -log1p(-x^2), a degree-8 polynomial in
// w - 2.5 (w < 5) or sqrt(w) - 3, times x; +-inf at +-1.
__device__ float erf_inv_xla(float x) {
  const float lt5[9] = {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f, -4.39150654e-06f,
                        0.00021858087f, -0.00125372503f, -0.00417768164f, 0.246640727f,
                        1.50140941f};
  const float ge5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f, -0.00367342844f,
                        0.00573950773f, -0.0076224613f, 0.00943887047f, 1.00167406f,
                        2.83297682f};
  float w = -log1pf(-(x * x));
  const bool lt = w < 5.0f;
  w = lt ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = (lt ? lt5[i] : ge5[i]) + p * w;
  return fabsf(x) == 1.0f ? x * INFINITY : p * x;
}

// jax.random.normal(key, (), float32): the uniform on (nextafter(-1, 0), 1)
// from the xor of the two words hashed from the counter (0, 0), then
// sqrt(2) erf_inv.
__device__ float jax_normal(uint32_t k0, uint32_t k1) {
  uint32_t a = 0u, b = 0u;
  threefry2(k0, k1, a, b);
  const uint32_t bits = a ^ b;
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const float lo = -0.99999994039535522461f;
  return (float)1.4142135623730951 * erf_inv_xla(fmaxf(f * 2.0f + lo, lo));
}

// normal(fold_in(key, d)).
__device__ __forceinline__ float jax_fold_normal(uint32_t k0, uint32_t k1, uint32_t d) {
  uint32_t a = 0u;
  threefry2(k0, k1, a, d);
  return jax_normal(a, d);
}

// _interval_normal: normal(fold_in(fold_in(j, bits(ta)), bits(tb))).
__device__ float jax_interval_normal(uint32_t j0, uint32_t j1, float ta, float tb) {
  uint32_t a = 0u, b = __float_as_uint(ta);
  threefry2(j0, j1, a, b);
  uint32_t c = 0u, d = __float_as_uint(tb);
  threefry2(a, b, c, d);
  return jax_normal(c, d);
}

// W(t) of the jax tree by one thread.
__device__ float jt_eval(uint32_t k0, uint32_t k1, float t, float t0, float t1, int depth) {
  float z[kMaxDepth + 1];
  for (int l = 0; l <= depth; ++l) z[l] = jax_fold_normal(k0, k1, jt_code(t, t0, t1, l));
  return tree_combine<kJax>(t, t0, t1, depth, z);
}

// y1 = ((y + h (f1/3 + (2 f2)/3)) + (dw - i10h) sigma) + i10h sigma
__device__ __forceinline__ float sra1_final(float y, float f1, float f2, float h, float dw,
                                            float i10h, float sigma) {
  return ((y + h * (f1 / 3.0f + (2.0f * f2) / 3.0f)) + (dw - i10h) * sigma) + i10h * sigma;
}

// W(t) of a lane's tree, by one thread (kw: the lane's key words).
template <int kTree>
__device__ float lane_w(const Sel& sel, const uint32_t* kw, float t) {
  return kTree == kKrng ? tree_eval(kw[0], kw[1], t, sel.t_start, sel.t_end, sel.depth)
                        : jt_eval(kw[0], kw[1], t, sel.t_start, sel.t_end, sel.depth);
}

// The Brownian data of an attempt from t, by the whole block: scal[0..3] =
// W(tm), W(te), and the interval normals of [t, tm] and [tm, te]; zb holds
// the tree's 2 (depth + 1) normals of the two queries, drawn a thread each
// (any block of at least 2 threads: the draws stride over the block), then
// combined by threads 0 and 1. Ends with a barrier.
template <int kTree>
__device__ void draw_noise(const Sel& sel, const uint32_t* kw, float t, float tm, float te,
                           float* scal, float* zb) {
  const int nz = sel.depth + 1;
  for (int q = threadIdx.x; q < 2 * nz + 2; q += blockDim.x) {
    if (q < 2 * nz) {
      const int e = q / nz;
      const float tq = e ? te : tm;
      zb[q] = kTree == kKrng ? kr_normal(kw[0], kw[1], tq, sel.t_start, sel.t_end, q - e * nz)
                             : jax_fold_normal(kw[0], kw[1], jt_code(tq, sel.t_start, sel.t_end,
                                                                     q - e * nz));
    } else {
      const float ta = q == 2 * nz ? t : tm, tb = q == 2 * nz ? tm : te;
      scal[q - 2 * nz + 2] =
          kTree == kKrng ? normal2(kw[2], kw[3], t_code(ta, sel.t_start, sel.t_end),
                                   t_code(tb, sel.t_start, sel.t_end))
                         : jax_interval_normal(kw[2], kw[3], ta, tb);
    }
  }
  __syncthreads();
  if (threadIdx.x < 2)
    scal[threadIdx.x] = tree_combine<kTree>(threadIdx.x ? te : tm, sel.t_start, sel.t_end,
                                            sel.depth, zb + threadIdx.x * nz);
  __syncthreads();
}

struct Control {
  bool accept;
  float err_c, h_next;
};

__device__ __forceinline__ Control control(const Sel& sel, float err, float h, float err_prev) {
  Control c;
  c.accept = (err <= 1.0f) || (h <= sel.dt_min);
  c.err_c = fmaxf(err, 1e-10f);
  const float fac_i = 0.9f * expf(-0.5f * logf(c.err_c));
  const float fac_acc = (0.9f * expf(-0.25f * logf(c.err_c))) * expf(0.125f * logf(err_prev));
  float factor = c.accept ? fac_acc : fac_i;
  factor = err <= 0.0f ? 5.0f : fminf(fmaxf(factor, 0.2f), 5.0f);
  c.h_next = fmaxf(h * factor, sel.dt_min);
  return c;
}

int check_depth(int depth) {
  return depth < 1 || depth > kMaxDepth ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace
