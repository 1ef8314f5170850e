// Column-network SDE kernels for Hopper (sm_90a): the adaptive step-size
// selection pass, the replay over the frozen step grids, and the replay's
// reverse sweep of the state cotangent. Plain C entry points, loaded with
// ctypes by columnflow_torch/kernels/_build.py; each returns
// cudaGetLastError().
//
// Replaces (columnflow/solvers/):
//   cf_sde_select      <- sde_adaptive.py _make_sde_adaptive_kernel (B5): the
//                         whole selection while-loop of one lane
//   cf_sde_attempt     <- the same body, one controller attempt per record
//                         (a second entry point, for testing the body)
//   cf_sde_replay_fwd  <- fused.py _make_sde_chunk_kernel, variable_h="lanes"
//                         (B3): SRA1 over each lane's frozen half-step grid
//   cf_sde_replay_bwd  <- fused.py _make_sde_bwd_chunk_kernel, emit_steps,
//                         lanes (B4): the step VJP w.r.t. the state, emitting
//                         each step's total cotangent (seed)
// The JAX kernels trace any drift; these are written for the premixed
// column-network drift (network_drift_premixed) with a knot stimulus and
// constant diffusion: select16 weights (bf16) in the selection, the split2
// weights (bf16 hi + mid) in the replay and its reverse sweep.
//
// What bounds them on this card: long serial chains. The selection runs
// ~10^4 controller attempts per lane, each 5 drift evaluations (one
// (P, P) bf16 matrix-vector product each) and 2 Brownian-tree walks; the
// replay ~1.4 * 10^4 half steps of 2 drift evaluations (3 products each),
// the reverse sweep 7 products per half step. The work per step is a few
// MFLOP, microseconds of the card's peak, and each step waits for the
// previous one. What this first design does about it: one thread block per
// lane, 512 threads, the state and every intermediate in shared memory,
// the weights read from L2 (2.8 MB of bf16 hi + mid stays resident there)
// at every product; lanes run in parallel on separate SMs. Spreading one
// lane's product over the SMs of a cluster (the matrix in distributed
// shared memory) is later work.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

struct Sel {
  float t_start, t_end, rtol, atol, h0, dt_min;
  int max_steps, depth;
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

// Shared-memory scratch of one drift evaluation.
struct Scratch {
  float* fr;   // (P) rates
  float* xa;   // (P) bf16(rates)            (split2: x_hi)
  float* xb;   // (P) bf16(rates - x_hi)      (split2 only)
  float* aux;  // (P) derivative / current cotangent (reverse sweep)
  float* ext;  // (n_in) stimulus
  double* red; // (kThreads / 32) reduction partials
  float* scal; // (8) broadcast scalars
};

// One drift evaluation of lane b at time t, state y -> out (all 3P), by the
// whole block. kSplit2: rec = (x_hi W_hi + x_hi W_mid) + x_mid W_hi and
// e = ext iwT (float32 iwT); otherwise (select16) rec = bf16(fr) W16 and
// e = bf16(ext) iwT16. Ends with a barrier.
template <bool kSplit2>
__device__ void drift(const Net& n, int b, float t, const float* y, float* out,
                      const bf16* __restrict__ w0, const bf16* __restrict__ w1,
                      const void* __restrict__ iw, const Scratch& s) {
  const int P = n.P;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const float fr = firing_rate(y[i] - y[P + i]);
    s.fr[i] = fr;
    const float hi = bf16r(fr);
    s.xa[i] = hi;
    if (kSplit2) s.xb[i] = bf16r(fr - hi);
  }
  if (threadIdx.x < n.n_in) {
    const float e = knot_interp(n, b, threadIdx.x, t);
    s.ext[threadIdx.x] = kSplit2 ? e : bf16r(e);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < P / 2; c += blockDim.x) {
    double p1a = 0.0, p1b = 0.0, p2a = 0.0, p2b = 0.0, p3a = 0.0, p3b = 0.0;
    const __nv_bfloat162* wr0 = reinterpret_cast<const __nv_bfloat162*>(w0) + c;
    const __nv_bfloat162* wr1 = reinterpret_cast<const __nv_bfloat162*>(w1) + c;
    for (int k = 0; k < P; ++k) {
      const float2 wh = __bfloat1622float2(wr0[(size_t)k * (P / 2)]);
      const double xa = s.xa[k];
      p1a += xa * (double)wh.x;
      p1b += xa * (double)wh.y;
      if (kSplit2) {
        const float2 wm = __bfloat1622float2(wr1[(size_t)k * (P / 2)]);
        const double xb = s.xb[k];
        p2a += xa * (double)wm.x;
        p2b += xa * (double)wm.y;
        p3a += xb * (double)wh.x;
        p3b += xb * (double)wh.y;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = 2 * c + j;
      const float rec = kSplit2 ? ((float)(j ? p1b : p1a) + (float)(j ? p2b : p2a))
                                      + (float)(j ? p3b : p3a)
                                : (float)(j ? p1b : p1a);
      double e = 0.0;
      for (int m = 0; m < n.n_in; ++m) {
        const float w = kSplit2 ? static_cast<const float*>(iw)[(size_t)m * P + col]
                                : __bfloat162float(static_cast<const bf16*>(iw)[(size_t)m * P + col]);
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

// State cotangent of one split2 drift evaluation at y for the output
// cotangent ct -> out (all 3P). wT_hi/wT_mid are the TRANSPOSED split
// matrices ((P_out, P_in) row-major), so the transposed product reads rows
// with neighbouring threads on neighbouring columns. The cotangent the
// product sends to the rates keeps jax.vjp's bf16 rounding points:
// m = bf16(c W_hi^T), q = bf16(c W_mid^T), x_bar = m + bf16(bf16(m + q) - m).
__device__ void drift_vjp(const Net& n, const float* y, const float* ct, float* out,
                          const bf16* __restrict__ whT, const bf16* __restrict__ wmT,
                          const Scratch& s) {
  const int P = n.P;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    float fr, frp;
    fr_and_grad(y[i] - y[P + i], fr, frp);
    s.fr[i] = frp;
    s.aux[i] = ((ct[i] / n.tau_m) * n.R) * n.tau_s;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < P / 2; c += blockDim.x) {
    double ma = 0.0, mb = 0.0, qa = 0.0, qb = 0.0;
    const __nv_bfloat162* rh = reinterpret_cast<const __nv_bfloat162*>(whT) + c;
    const __nv_bfloat162* rm = reinterpret_cast<const __nv_bfloat162*>(wmT) + c;
    for (int i = 0; i < P; ++i) {
      const double cc = s.aux[i];
      const float2 wh = __bfloat1622float2(rh[(size_t)i * (P / 2)]);
      const float2 wm = __bfloat1622float2(rm[(size_t)i * (P / 2)]);
      ma += cc * (double)wh.x;
      mb += cc * (double)wh.y;
      qa += cc * (double)wm.x;
      qb += cc * (double)wm.y;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = 2 * c + j;
      const float m = bf16r((float)(j ? mb : ma));
      const float q = bf16r((float)(j ? qb : qa));
      const float xbar = m + bf16r(bf16r(m + q) - m);
      const float cv = ct[k], ca = ct[P + k], cr = ct[2 * P + k];
      const float c_fr = (xbar + n.adapt[k] * (ca / n.tau_a)) + cr / n.tau_s;
      const float c_x = s.fr[k] * c_fr;
      out[k] = -(cv / n.tau_m) + c_x;
      out[P + k] = -(ca / n.tau_a) - c_x;
      out[2 * P + k] = -(cr / n.tau_s);
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Counter-based RNG and Brownian tree (solvers/krng.py), one thread per walk
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

__device__ uint32_t threefry_x0(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1) {
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

__device__ float tree_eval(uint32_t k0, uint32_t k1, float t, float t0, float t1, int depth) {
  t = fminf(fmaxf(t, t0), t1);
  const float w_right = normal2(k0, k1, 0u, 0u) * sqrtf(fmaxf(t1 - t0, 0.0f));
  float tl = t0, tr = t1, wl = 0.0f, wr = w_right;
  uint32_t code = 0u;
  for (int d = 0; d < depth; ++d) {
    const float tm = 0.5f * (tl + tr);
    const uint32_t code_m = code * 2u + 1u;
    const float z = normal2(k0, k1, code_m, 0u);
    const float wm = 0.5f * (wl + wr) + (0.5f * sqrtf(tr - tl)) * z;
    if (t < tm) {
      tr = tm;
      wr = wm;
      code = code_m;
    } else {
      tl = tm;
      wl = wm;
      code = code * 2u + 2u;
    }
  }
  const float frac = tr > tl ? (t - tl) / (tr - tl) : 0.0f;
  return wl + frac * (wr - wl);
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

// y1 = ((y + h (f1/3 + (2 f2)/3)) + (dw - i10h) sigma) + i10h sigma
__device__ __forceinline__ float sra1_final(float y, float f1, float f2, float h, float dw,
                                            float i10h, float sigma) {
  return ((y + h * (f1 / 3.0f + (2.0f * f2) / 3.0f)) + (dw - i10h) * sigma) + i10h * sigma;
}

// Block-wide sum of v over the block, in float64, in a fixed order.
__device__ double block_sum(double v, double* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double total = 0.0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += red[w];
  __syncthreads();
  return total;
}

// One step-doubling attempt from (t, y) with step h and W(t) = w0: writes the
// two-half-step solution into buf.yn, returns the scaled RMS error and W(t+h).
__device__ float attempt(const Net& n, const Sel& sel, int b, const uint32_t* kw, float t, float h,
                         float w0, const bf16* w16, const bf16* iw16, const SelBuf& u,
                         const Scratch& s, float& w1_out) {
  const int S = 3 * n.P;
  const float tm = t + 0.5f * h;
  const float te = t + h;
  const float hh = 0.5f * h;
  if (threadIdx.x < 4) {
    float v;
    if (threadIdx.x == 0) v = tree_eval(kw[0], kw[1], tm, sel.t_start, sel.t_end, sel.depth);
    else if (threadIdx.x == 1) v = tree_eval(kw[0], kw[1], te, sel.t_start, sel.t_end, sel.depth);
    else if (threadIdx.x == 2) v = normal2(kw[2], kw[3], t_code(t, sel.t_start, sel.t_end),
                                           t_code(tm, sel.t_start, sel.t_end));
    else v = normal2(kw[2], kw[3], t_code(tm, sel.t_start, sel.t_end),
                     t_code(te, sel.t_start, sel.t_end));
    s.scal[threadIdx.x] = v;
  }
  __syncthreads();
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
  drift<false>(n, b, t, u.y, u.f1, w16, nullptr, iw16, s);
  const float i10h_f = i10_f / (h > 0.0f ? h : 1.0f);
  stage2_state(S, u.y, u.f1, h, i10h_f, sg, u.hst);
  __syncthreads();
  drift<false>(n, b, t + 0.75f * h, u.hst, u.f, w16, nullptr, iw16, s);
  const float dw_f = dw_a + dw_b;
  for (int i = threadIdx.x; i < S; i += blockDim.x)
    u.yf[i] = sra1_final(u.y[i], u.f1[i], u.f[i], h, dw_f, i10h_f, sg);
  // First half step (shares f1).
  const float i10h_a = i10_a / (hh > 0.0f ? hh : 1.0f);
  stage2_state(S, u.y, u.f1, hh, i10h_a, sg, u.hst);
  __syncthreads();
  drift<false>(n, b, t + 0.75f * hh, u.hst, u.f, w16, nullptr, iw16, s);
  for (int i = threadIdx.x; i < S; i += blockDim.x)
    u.yh[i] = sra1_final(u.y[i], u.f1[i], u.f[i], hh, dw_a, i10h_a, sg);
  __syncthreads();
  // Second half step from t + h/2.
  const float th = t + 0.5f * h;
  drift<false>(n, b, th, u.yh, u.g1, w16, nullptr, iw16, s);
  const float i10h_b = i10_b / (hh > 0.0f ? hh : 1.0f);
  stage2_state(S, u.yh, u.g1, hh, i10h_b, sg, u.hst);
  __syncthreads();
  drift<false>(n, b, th + 0.75f * hh, u.hst, u.f, w16, nullptr, iw16, s);
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
  s->red = reinterpret_cast<double*>(p + ((uintptr_t)p & 4 ? 1 : 0));
}

size_t scratch_bytes(int P) {
  return sizeof(float) * (4 * (size_t)P + kMaxInputs + 8 + 1) + sizeof(double) * (kThreads / 32);
}

// B5: the whole selection loop of lane blockIdx.x.
__global__ void __launch_bounds__(kThreads)
sde_select_kernel(Net n, Sel sel, const bf16* __restrict__ w16, const bf16* __restrict__ iw16,
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
    s.scal[4] = tree_eval(kw[0], kw[1], sel.t_start, sel.t_start, sel.t_end, sel.depth);
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
    const float err = attempt(n, sel, b, kw, t1, hc, w_t1, w16, iw16, u, s, w1);
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
__global__ void __launch_bounds__(kThreads)
sde_attempt_kernel(Net n, Sel sel, const bf16* __restrict__ w16, const bf16* __restrict__ iw16,
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
  const float err = attempt(n, sel, r, kw, t1, hc, w_t1[r], w16, iw16, u, s, w1);
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
// The replay (B3) and its reverse sweep (B4), lane b = blockIdx.x
// ---------------------------------------------------------------------------

struct Replay {
  int n_steps, n_real, stride;  // stride: truncation every stride steps (0: none)
  const float* t0s;  // (n_steps, B)
  const float* hs;   // (n_steps, B)
  const float* i1;   // (n_steps, B)
  const float* i10;  // (n_steps, B)
};

__global__ void __launch_bounds__(kThreads)
sde_replay_fwd_kernel(Net n, Replay rp, const bf16* __restrict__ w_hi,
                      const bf16* __restrict__ w_mid, const float* __restrict__ iwT,
                      const float* __restrict__ y0, float* __restrict__ ys) {
  extern __shared__ float sm[];
  const int P = n.P, S = 3 * P, B = n.B, b = blockIdx.x;
  float* y = sm;
  float* f1 = y + S;
  float* h2 = f1 + S;
  float* f2 = h2 + S;
  Scratch s;
  carve(f2 + S, P, n.n_in, nullptr, &s);
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    y[i] = y0[(size_t)b * S + i];
    ys[(size_t)b * S + i] = y[i];
  }
  __syncthreads();
  for (int k = 0; k < rp.n_real; ++k) {
    const size_t kb = (size_t)k * B + b;
    const float t0 = rp.t0s[kb], h = rp.hs[kb], di1 = rp.i1[kb];
    const float i10h = rp.i10[kb] / (h > 0.0f ? h : 1.0f);
    drift<true>(n, b, t0, y, f1, w_hi, w_mid, iwT, s);
    stage2_state(S, y, f1, h, i10h, n.sigma, h2);
    __syncthreads();
    drift<true>(n, b, t0 + 0.75f * h, h2, f2, w_hi, w_mid, iwT, s);
    float* out = ys + ((size_t)(k + 1) * B + b) * S;
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      y[i] = sra1_final(y[i], f1[i], f2[i], h, di1, i10h, n.sigma);
      out[i] = y[i];
    }
    __syncthreads();
  }
  // Rows past n_real: the carried state (h == 0 padding is a no-op).
  for (int k = rp.n_real; k < rp.n_steps; ++k) {
    float* out = ys + ((size_t)(k + 1) * B + b) * S;
    for (int i = threadIdx.x; i < S; i += blockDim.x) out[i] = y[i];
  }
}

// Reverse sweep. Given c = ybar + ysbar[k] (the total cotangent on step k's
// output, written to seeds[k]), recompute f1 and h2 from ys_prev[k], then
//   c_f2 = ((h c)/3) 2;   c_h2 = f^T|_{h2} c_f2
//   c_f1 = (h c)/3 + (0.75 h) c_h2;   c_y = f^T|_y c_f1
//   ybar = (c + c_h2) + c_y,  zeroed after every step k with k % stride == 0.
// Steps from n_real on carry zero cotangents: their seeds are written 0.
__global__ void __launch_bounds__(kThreads)
sde_replay_bwd_kernel(Net n, Replay rp, const bf16* __restrict__ w_hi,
                      const bf16* __restrict__ w_mid, const bf16* __restrict__ w_hiT,
                      const bf16* __restrict__ w_midT, const float* __restrict__ iwT,
                      const float* __restrict__ ys_prev, const float* __restrict__ ysbar,
                      float* __restrict__ ybar_out, float* __restrict__ seeds) {
  extern __shared__ float sm[];
  const int P = n.P, S = 3 * P, B = n.B, b = blockIdx.x;
  float* y = sm;
  float* f1 = y + S;
  float* h2 = f1 + S;
  float* c = h2 + S;
  float* cw = c + S;
  float* ch2 = cw + S;
  float* cy = ch2 + S;
  float* yb = cy + S;
  Scratch s;
  carve(yb + S, P, n.n_in, nullptr, &s);
  for (int k = rp.n_real; k < rp.n_steps; ++k) {
    float* o = seeds + ((size_t)k * B + b) * S;
    for (int i = threadIdx.x; i < S; i += blockDim.x) o[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < S; i += blockDim.x) yb[i] = 0.0f;
  __syncthreads();
  for (int k = rp.n_real - 1; k >= 0; --k) {
    const size_t kb = (size_t)k * B + b;
    const float t0 = rp.t0s[kb], h = rp.hs[kb];
    const float i10h = rp.i10[kb] / (h > 0.0f ? h : 1.0f);
    const float* yk = ys_prev + kb * S;
    const float* sbk = ysbar + kb * S;
    float* sk = seeds + kb * S;
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      y[i] = yk[i];
      c[i] = yb[i] + sbk[i];
      sk[i] = c[i];
    }
    __syncthreads();
    drift<true>(n, b, t0, y, f1, w_hi, w_mid, iwT, s);
    stage2_state(S, y, f1, h, i10h, n.sigma, h2);
    for (int i = threadIdx.x; i < S; i += blockDim.x) cw[i] = ((h * c[i]) / 3.0f) * 2.0f;
    __syncthreads();
    drift_vjp(n, h2, cw, ch2, w_hiT, w_midT, s);
    const float a = 0.75f * h;
    for (int i = threadIdx.x; i < S; i += blockDim.x) cw[i] = (h * c[i]) / 3.0f + a * ch2[i];
    __syncthreads();
    drift_vjp(n, y, cw, cy, w_hiT, w_midT, s);
    const bool cut = rp.stride > 0 && k % rp.stride == 0;
    for (int i = threadIdx.x; i < S; i += blockDim.x)
      yb[i] = cut ? 0.0f : (c[i] + ch2[i]) + cy[i];
    __syncthreads();
  }
  for (int i = threadIdx.x; i < S; i += blockDim.x) ybar_out[(size_t)b * S + i] = yb[i];
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

Sel make_sel(const float* hs, int max_steps, int depth) {
  return Sel{hs[0], hs[1], hs[2], hs[3], hs[4], hs[5], max_steps, depth};
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

extern "C" {

// hc (host): tau_s, tau_m, tau_a, R, sigma, kc0[K-1], kd[K-1];
// hs (host): t_start, t_end, rtol, atol, h0, dt_min.
int cf_sde_select(int B, int P, int n_in, int K, const float* hc, const float* hs, int max_steps,
                  int depth, const float* bg, const float* adapt, const void* w16,
                  const void* iw16, const float* kv, const int* words, const float* y0,
                  float* st, int* stats, void* stream) {
  if (int e = check_shape(P, n_in, K)) return e;
  const size_t bytes = sizeof(float) * 8 * 3 * (size_t)P + scratch_bytes(P);
  if (int e = set_smem(sde_select_kernel, bytes)) return e;
  sde_select_kernel<<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      make_net(B, P, n_in, K, hc, bg, adapt, kv), make_sel(hs, max_steps, depth),
      (const bf16*)w16, (const bf16*)iw16, words, y0, st, stats);
  return (int)cudaGetLastError();
}

int cf_sde_attempt(int N, int P, int n_in, int K, const float* hc, const float* hs, int depth,
                   const float* bg, const float* adapt, const void* w16, const void* iw16,
                   const float* kv, const int* words, const float* t1, const float* y1,
                   const float* h, const float* err_prev, const float* w_t1, float* y_new,
                   float* rec, void* stream) {
  if (int e = check_shape(P, n_in, K)) return e;
  const size_t bytes = sizeof(float) * 8 * 3 * (size_t)P + scratch_bytes(P);
  if (int e = set_smem(sde_attempt_kernel, bytes)) return e;
  sde_attempt_kernel<<<N, kThreads, bytes, (cudaStream_t)stream>>>(
      make_net(N, P, n_in, K, hc, bg, adapt, kv), make_sel(hs, 0, depth), (const bf16*)w16,
      (const bf16*)iw16, words, t1, y1, h, err_prev, w_t1, y_new, rec);
  return (int)cudaGetLastError();
}

int cf_sde_replay_fwd(int B, int P, int n_in, int K, const float* hc, int n_steps, int n_real,
                      const float* bg, const float* adapt, const void* w_hi, const void* w_mid,
                      const float* iwT, const float* kv, const float* t0s, const float* hs,
                      const float* i1, const float* i10, const float* y0, float* ys,
                      void* stream) {
  if (int e = check_shape(P, n_in, K)) return e;
  const size_t bytes = sizeof(float) * 4 * 3 * (size_t)P + scratch_bytes(P);
  if (int e = set_smem(sde_replay_fwd_kernel, bytes)) return e;
  const Replay rp{n_steps, n_real, 0, t0s, hs, i1, i10};
  sde_replay_fwd_kernel<<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      make_net(B, P, n_in, K, hc, bg, adapt, kv), rp, (const bf16*)w_hi, (const bf16*)w_mid,
      iwT, y0, ys);
  return (int)cudaGetLastError();
}

int cf_sde_replay_bwd(int B, int P, int n_in, int K, const float* hc, int n_steps, int n_real,
                      int stride, const float* bg, const float* adapt, const void* w_hi,
                      const void* w_mid, const void* w_hiT, const void* w_midT,
                      const float* iwT, const float* kv, const float* t0s, const float* hs,
                      const float* i10, const float* ys_prev, const float* ysbar, float* ybar,
                      float* seeds, void* stream) {
  if (int e = check_shape(P, n_in, K)) return e;
  const size_t bytes = sizeof(float) * 8 * 3 * (size_t)P + scratch_bytes(P);
  if (int e = set_smem(sde_replay_bwd_kernel, bytes)) return e;
  const Replay rp{n_steps, n_real, stride, t0s, hs, nullptr, i10};
  sde_replay_bwd_kernel<<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      make_net(B, P, n_in, K, hc, bg, adapt, kv), rp, (const bf16*)w_hi, (const bf16*)w_mid,
      (const bf16*)w_hiT, (const bf16*)w_midT, iwT, ys_prev, ysbar, ybar, seeds);
  return (int)cudaGetLastError();
}

}  // extern "C"
