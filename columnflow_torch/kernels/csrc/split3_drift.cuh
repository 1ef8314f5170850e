// The three-term bf16 split of the column network's drift (prepare_premixed_split /
// matmul_split) and its VJP with jax.vjp's rounding points, on weights held in
// shared memory: what the f32-exact dopri5 kernels (network_ode.cu) and the
// three-term SDE sweeps (network_sde.cu) share. Included once per source;
// every source is its own library, so the definitions live in an unnamed
// namespace.
//
// A drift evaluation or VJP covers the lanes b0 .. b0 + nb - 1 of the knot
// table, at one shared time t or, given tl, lane b at its own time tl[b].

#pragma once

#include "network_drift.cuh"

namespace {

// The three-term split of wT and the float32 iwT, in shared memory.
struct W3 {
  bf16 *hi, *mid, *lo;  // (P, P) each, row k = input population
  float* iw;            // (n_in, P)
};

// Shared-memory scratch of one drift evaluation or drift VJP over nb lanes.
struct Scr {
  float *fr;           // (nb, P) rates; their derivative in the VJP
  float *xh, *xm, *xl; // (nb, P) the rates' three bf16 terms
  float *cc;           // (nb, P) the current's cotangent (VJP)
  float *ext;          // (nb, kMaxInputs) stimulus
  double* red;         // (kThreads / 32) reduction partials
};

__device__ __forceinline__ void split3(float x, float& hi, float& mid, float& lo) {
  hi = bf16r(x);
  const float r = x - hi;
  mid = bf16r(r);
  lo = bf16r(r - mid);
}

// Rates, their bf16 terms (and, for the VJP, the derivative and the
// current's cotangent) and the stimulus of lanes b0..b0+nb-1 at time t
// (or tl[b]).
template <bool kVjp>
__device__ void drift_head(const Net& n, int b0, int nb, float t, const float* y,
                           const float* ct, const Scr& s, const float* tl = nullptr) {
  const int P = n.P, S = 3 * P;
  for (int idx = threadIdx.x; idx < nb * P; idx += blockDim.x) {
    const int b = idx / P, i = idx - b * P;
    const float x = y[b * S + i] - y[b * S + P + i];
    float fr, frp = 0.0f;
    if (kVjp) fr_and_grad(x, fr, frp);
    else fr = firing_rate(x);
    s.fr[idx] = kVjp ? frp : fr;
    split3(fr, s.xh[idx], s.xm[idx], s.xl[idx]);
    if (kVjp) s.cc[idx] = ((ct[b * S + i] / n.tau_m) * n.R) * n.tau_s;
  }
  for (int idx = threadIdx.x; idx < nb * n.n_in; idx += blockDim.x) {
    const int b = idx / n.n_in, m = idx - b * n.n_in;
    s.ext[b * kMaxInputs + m] = knot_interp(n, b0 + b, m, tl ? tl[b] : t);
  }
  __syncthreads();
}

// One drift evaluation of lanes b0..b0+nb-1 at the time t (or tl): y -> out
// (nb, 3P), both in shared memory. rec = x_hi W_lo + x_mid W_mid + x_lo W_hi
// + x_hi W_mid + x_mid W_hi + x_hi W_hi, left to right. Ends with a barrier.
__device__ void drift3(const Net& n, int b0, int nb, float t, const float* y, float* out,
                       const W3& w, const Scr& s, const float* tl = nullptr) {
  const int P = n.P, S = 3 * P;
  drift_head<false>(n, b0, nb, t, y, nullptr, s, tl);
  for (int idx = threadIdx.x; idx < nb * P; idx += blockDim.x) {
    const int b = idx / P, col = idx - b * P;
    const float *xh = s.xh + b * P, *xm = s.xm + b * P, *xl = s.xl + b * P;
    double p1 = 0.0, p2 = 0.0, p3 = 0.0, p4 = 0.0, p5 = 0.0, p6 = 0.0;
    for (int k = 0; k < P; ++k) {
      const double wh = (double)__bfloat162float(w.hi[k * P + col]);
      const double wm = (double)__bfloat162float(w.mid[k * P + col]);
      const double wl = (double)__bfloat162float(w.lo[k * P + col]);
      const double a = xh[k], c = xm[k], d = xl[k];
      p1 += a * wl;
      p2 += c * wm;
      p3 += d * wh;
      p4 += a * wm;
      p5 += c * wh;
      p6 += a * wh;
    }
    const float rec = (((((float)p1 + (float)p2) + (float)p3) + (float)p4) + (float)p5) + (float)p6;
    double e = 0.0;
    for (int m = 0; m < n.n_in; ++m)
      e += (double)s.ext[b * kMaxInputs + m] * (double)w.iw[m * P + col];
    const float current = (rec + (float)e) + n.bg[col];
    const float total = current * n.tau_s;
    const float* yb = y + b * S;
    float* ob = out + b * S;
    const float fr = s.fr[idx];
    ob[col] = (-yb[col] + total * n.R) / n.tau_m;
    ob[P + col] = (-yb[P + col] + n.adapt[col] * fr) / n.tau_a;
    ob[2 * P + col] = (-yb[2 * P + col] + fr) / n.tau_s;
  }
  __syncthreads();
}

// The step's accumulators of the weight cotangents: three (P, P) arrays
// holding bf16 values (global memory), the float32 iwT cotangent of the
// step (shared memory). A thread owns the entries it touches.
struct WAcc {
  float *hi, *mid, *lo;  // (P, P)
  float* iw;             // (n_in, P)
};

// VJP of one drift evaluation over ALL lanes (nb = the batch) at time t (or tl) and
// state y for the output cotangent ct: the state cotangent -> out, and this
// evaluation's weight cotangents added to acc (assigned if first).
//   state:  m = bf(c W_hi^T), q = bf(c W_mid^T), l = bf(c W_lo^T)
//           u = bf(m + q);  r = m + bf(u - m);  x_bar = r + bf(bf(u + l) + bf(-r))
//   weight: a = bf(x_hi^T c), b = bf(x_mid^T c), e = bf(x_lo^T c), contracted
//           over the lanes; hi (+)= a, b, e; mid (+)= a, b; lo (+)= a, in bf16.
__device__ void drift_vjp3(const Net& n, int nb, float t, const float* y, const float* ct,
                           float* out, const W3& w, const Scr& s, const WAcc& acc, bool first,
                           const float* tl = nullptr) {
  const int P = n.P, S = 3 * P;
  drift_head<true>(n, 0, nb, t, y, ct, s, tl);
  for (int idx = threadIdx.x; idx < nb * P; idx += blockDim.x) {
    const int b = idx / P, k = idx - b * P;
    const float* cc = s.cc + b * P;
    double dm = 0.0, dq = 0.0, dl = 0.0;
    for (int j = 0; j < P; ++j) {
      const double c = cc[j];
      dm += c * (double)__bfloat162float(w.hi[k * P + j]);
      dq += c * (double)__bfloat162float(w.mid[k * P + j]);
      dl += c * (double)__bfloat162float(w.lo[k * P + j]);
    }
    const float m = bf16r((float)dm), q = bf16r((float)dq), l = bf16r((float)dl);
    const float u = bf16r(m + q);
    const float r = m + bf16r(u - m);
    const float xbar = r + bf16r(bf16r(u + l) + bf16r(-r));
    const float* cb = ct + b * S;
    float* ob = out + b * S;
    const float cv = cb[k], ca = cb[P + k], cr = cb[2 * P + k];
    const float c_fr = (xbar + n.adapt[k] * (ca / n.tau_a)) + cr / n.tau_s;
    const float c_x = s.fr[idx] * c_fr;
    ob[k] = -(cv / n.tau_m) + c_x;
    ob[P + k] = -(ca / n.tau_a) - c_x;
    ob[2 * P + k] = -(cr / n.tau_s);
  }
  for (int e = threadIdx.x; e < P * P; e += blockDim.x) {
    const int i = e / P, j = e - i * P;
    double da = 0.0, db = 0.0, de = 0.0;
    for (int b = 0; b < nb; ++b) {
      const double c = s.cc[b * P + j];
      da += (double)s.xh[b * P + i] * c;
      db += (double)s.xm[b * P + i] * c;
      de += (double)s.xl[b * P + i] * c;
    }
    const float a = bf16r((float)da), bb = bf16r((float)db), ee = bf16r((float)de);
    if (first) {
      acc.hi[e] = bf16r(bf16r(a + bb) + ee);
      acc.mid[e] = bf16r(a + bb);
      acc.lo[e] = a;
    } else {
      acc.hi[e] = bf16r(bf16r(bf16r(acc.hi[e] + a) + bb) + ee);
      acc.mid[e] = bf16r(bf16r(acc.mid[e] + a) + bb);
      acc.lo[e] = bf16r(acc.lo[e] + a);
    }
  }
  for (int e = threadIdx.x; e < n.n_in * P; e += blockDim.x) {
    const int m = e / P, j = e - m * P;
    double d = 0.0;
    for (int b = 0; b < nb; ++b) d += (double)s.ext[b * kMaxInputs + m] * (double)s.cc[b * P + j];
    acc.iw[e] = first ? (float)d : acc.iw[e] + (float)d;
  }
  __syncthreads();
}

struct Carve {
  float* p;
  __device__ float* take(int nfloat) {
    float* r = p;
    p += nfloat;
    return r;
  }
};

// Lay out the weights and the scratch, split wT into its three terms, copy
// iwT. Returns the first free float. Ends with a barrier.
__device__ float* setup(float* sm, const Net& n, int nb, const float* __restrict__ wT,
                        const float* __restrict__ iwT, W3* w, Scr* s) {
  const int P = n.P;
  bf16* wb = reinterpret_cast<bf16*>(sm);
  w->hi = wb;
  w->mid = wb + P * P;
  w->lo = wb + 2 * P * P;
  Carve c{sm + (3 * P * P + 1) / 2};
  w->iw = c.take(n.n_in * P);
  s->fr = c.take(nb * P);
  s->xh = c.take(nb * P);
  s->xm = c.take(nb * P);
  s->xl = c.take(nb * P);
  s->cc = c.take(nb * P);
  s->ext = c.take(nb * kMaxInputs);
  float* p = c.p;
  p += ((uintptr_t)p & 4) ? 1 : 0;
  s->red = reinterpret_cast<double*>(p);
  p += 2 * (kThreads / 32);
  for (int e = threadIdx.x; e < P * P; e += blockDim.x) {
    float hi, mid, lo;
    const float x = wT[e];
    const bf16 h16 = __float2bfloat16_rn(x);
    hi = __bfloat162float(h16);
    const float r = x - hi;
    const bf16 m16 = __float2bfloat16_rn(r);
    mid = __bfloat162float(m16);
    lo = r - mid;
    w->hi[e] = h16;
    w->mid[e] = m16;
    w->lo[e] = __float2bfloat16_rn(lo);
  }
  for (int e = threadIdx.x; e < n.n_in * P; e += blockDim.x) w->iw[e] = iwT[e];
  __syncthreads();
  return p;
}

// Floats of shared memory that setup() lays out for nb lanes.
size_t setup_floats(int P, int n_in, int nb) {
  return (3 * (size_t)P * P + 1) / 2 + (size_t)n_in * P + 5 * (size_t)nb * P
         + (size_t)nb * kMaxInputs + 1 + 2 * (kThreads / 32);
}

}  // namespace
