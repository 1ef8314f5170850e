// The Hopf MLP dopri5 kernels for Hopper (sm_90a), templated on the hidden
// width: the adaptive step-size selection, the dense-output replay over the
// frozen grid, and the replay's reverse sweep in kernel mode and in emit
// mode. hopf_ode.cu builds the kernel-mode path at width 100, hopf_outer.cu
// the emit-mode sweep at 100 and every kernel at 512, each its own library
// (so nvcc builds the two in parallel) with plain C entry points, loaded with
// ctypes by columnflow_torch/kernels/_build.py; each returns
// cudaGetLastError().
//
// Replaces (columnflow/solvers/fused.py, the kernels of odeint_dopri5_fused
// traced with columnflow/models/hopf.py hopf_mlp_drift and
// columnflow/ops/interp.py interp_at_onehot); entry points cf_hopf_* (width
// 100) and cf_hopf_wide_* (width 512):
//   select          <- _make_adaptive_kernel (B6h; B6h-wide): Hairer's initial
//                      step, the whole accept/reject loop under one controller
//                      for the batch state, the accepted times
//   attempt         <- the same body, one controller attempt (a second entry
//                      point, for testing the body)
//   replay_fwd      <- _make_replay_chunk_kernel (B7h; B7h-wide): the six-stage
//                      step over the frozen grid with the stage-0 recompute,
//                      step-start states and CONTD5 rows
//   replay_bwd      <- _make_bwd_chunk_kernel, kernel mode (B8h, width 100
//                      only): the VJP of each step and its dense rows w.r.t.
//                      the state and the eight parameter tensors
//   replay_bwd_emit <- _make_bwd_chunk_kernel(emit_steps=True) (B8ho;
//                      B8ho-wide): the same sweep w.r.t. the state only,
//                      writing each step's output cotangent
//
// The drift: y (B, 2) and mu(t) (B) -> the MLP 3 -> H -> H -> H -> 2 with
// ReLU (kernels/hopf_ode.py, models/hopf.py), at two hidden widths H: 100 (the
// reference MLP, 83 KB of parameters) and 512 (2.1 MB, past the 1 MiB that
// sends the JAX package's "auto" to outer mode). What bounds the kernels: a
// serial chain of a few hundred steps, each 6-7 drift evaluations (and 7 VJPs
// backward) of 2 B (3 H + 2 H^2 + 2 H) operations; the time is the latency of
// one step. Design: one block of kThreads threads holds the batch. Thread
// c < 2B owns state component c = (lane c / 2, column c % 2) in registers,
// with its stage derivatives and stage states; every layer product is one
// output per thread task between barriers.
//   H = 100: every weight in shared memory (84 KB, rows padded to an odd
//   stride so that both the forward and the transposed products read without
//   bank conflicts), and the activations of a drift evaluation (input, three
//   hidden layers, as doubles holding float32 values) and the VJP's layer
//   cotangents beside them.
//   H = 512: 2.1 MB of weights fit neither a block's 227 KB nor a cluster's
//   shared memory, and one hidden layer of 32 lanes is 128 KB as doubles. So
//   the weights stay in device memory (they stay in the 50 MB L2), read
//   coalesced: the forward products from a transposed copy of the hidden
//   matrices (wt, (k, o)), the VJP's transposed products from the parameters
//   as they are ((o, k)); the activations and cotangents live in a
//   device-memory scratch of the same layout. Shared memory holds only the
//   error norm's warp sums.
// The kernel-mode sweep's parameter cotangents (two sets of the parameters'
// size) do not fit beside the activations: the step's sum and the running
// total live in device memory, each entry written by one thread per phase, so
// their order is fixed without atomics. The emit-mode sweep takes no
// parameter cotangents; it writes the cotangent each step receives from the
// later steps, and the parameter gradients are taken outside
// (solvers/fused.py hopf_outer_arg_grads).
//
// Precision: float32 elementwise arithmetic with IEEE division, compiled with
// -fmad=false. Every sum of products takes the products exactly in float64,
// adds them in the pairwise order of models/xor.py tree_sum (a perfect
// binary tree over the next power of two, absent terms skipped) and rounds
// once to float32; biases add after, in float32. Weight cotangents are
// contracted over the lanes the same way, once per drift VJP, then added in
// float32 over a step's seven VJPs from stage 6 down and over the steps from
// the last back. The stage sums, the error norm and the cotangent sums round
// as kernels/network_ode.py's plain versions (rk_step, dense_coeffs, _rms,
// rk_step_vjp); the error norm's squares add in float64 in block_sum's
// order and round once. Both widths run the same code on other pointers, so
// they round alike.

#pragma once

#include "dopri5.cuh"

namespace {

constexpr int kMaxLanes = 32;
constexpr int kThreads = 512;

// The constants of hidden width H.
template <int H>
struct Width {
  static constexpr bool kShared = H <= 128;        // weights and activations in shared memory
  static constexpr int kWS = kShared ? H + 1 : H;  // row stride of the hidden matrices (o, k)
  // Where the forward's products read element (o, k) of a hidden matrix:
  // o * kFO + k * kFK (the padded rows in shared memory, or the transposed
  // copy in device memory).
  static constexpr int kFO = kShared ? kWS : 1, kFK = kShared ? 1 : H;
  // Offsets of the packed parameters (kernels/hopf_ode.py pack_params: layer
  // by layer, w (dout, din) then b).
  static constexpr int kOffW1 = 0, kOffB1 = kOffW1 + 3 * H, kOffW2 = kOffB1 + H,
                       kOffB2 = kOffW2 + H * H, kOffW3 = kOffB2 + H, kOffB3 = kOffW3 + H * H,
                       kOffW4 = kOffB3 + H, kOffB4 = kOffW4 + 2 * H, kParams = kOffB4 + 2;
};

// The sum over k in [OFF, OFF + N) (N a power of two) of term(k), terms at
// k >= LIMIT absent: tree_sum's order over LIMIT terms.
template <int OFF, int N, int LIMIT, class F>
__device__ __forceinline__ double ptree(const F& term) {
  if constexpr (N == 1) {
    return term(OFF);
  } else if constexpr (OFF + N / 2 >= LIMIT) {
    return ptree<OFF, N / 2, LIMIT>(term);
  } else {
    return ptree<OFF, N / 2, LIMIT>(term) + ptree<OFF + N / 2, N / 2, LIMIT>(term);
  }
}

__host__ __device__ constexpr int pow2ceil(int k) { return k <= 1 ? 1 : 2 * pow2ceil((k + 1) / 2); }

__host__ __device__ constexpr int log2i(int k) { return k <= 1 ? 0 : 1 + log2i(k / 2); }

// tree_sum over the K terms term(0..K-1). Up to 128 terms the tree is
// unrolled whole. A wider power of two (512) is summed by blocks of 32 terms,
// each block's tree unrolled, and the block sums merged as a binary counter
// (after block i, the top two merge while i + 1 has another trailing zero
// bit): the same perfect tree, in a loop, so that nvcc does not unroll 511
// additions at every call site.
template <int K, class F>
__device__ __forceinline__ double tsum(const F& term) {
  if constexpr (K <= 128) {
    return ptree<0, pow2ceil(K), K>(term);
  } else {
    static_assert((K & (K - 1)) == 0, "a wide sum's length is a power of two");
    constexpr int kBlock = 32;
    double stack[log2i(K / kBlock) + 1];
    int depth = 0;
#pragma unroll 1
    for (int i = 0; i < K / kBlock; ++i) {
      const int base = i * kBlock;
      double s = ptree<0, kBlock, kBlock>([&](int k) { return term(base + k); });
      for (int m = i + 1; (m & 1) == 0; m >>= 1) s = stack[--depth] + s;
      stack[depth++] = s;
    }
    return stack[0];
  }
}

// tree_sum over the B <= 32 lanes of term(b): the absent lanes add -0.0,
// which leaves every sum as it is.
template <class F>
__device__ __forceinline__ double lane_sum(int B, const F& term) {
  return ptree<0, kMaxLanes, kMaxLanes>([&](int b) { return b < B ? term(b) : -0.0; });
}

__device__ __forceinline__ float relu(float z) { return (z > 0.0f || z != z) ? z : 0.0f; }

struct Net {
  int B, T;       // lanes, rows of the mu table
  float t0, dt;   // the mu table's grid: t0 + dt * arange(T)
  const float* mu;  // (T, B)
};

// Where a kernel's activations and weights live: shared memory (H = 100) or
// device memory (H = 512).
struct Sh {
  double *inp, *a1, *a2, *a3;  // (B, 3), (B, H) x 3: activations as doubles
  double *dz0, *dz1;           // (B, H) x 2: layer cotangents (reverse sweep only)
  double* red;                 // (kThreads / 32) the error norm's warp sums, shared
  const float *w1, *b1, *w2, *b2, *w3, *b3, *w4, *b4;  // w2, w3 as (o, k), row stride kWS
  const float *w2f, *w3f;      // w2, w3 as the forward's products read them
};

// The doubles of the activations (and, for the sweep, the layer cotangents).
__host__ __device__ constexpr size_t act_doubles(int B, int H, bool bwd) {
  return (size_t)B * (3 + 3 * H) + (bwd ? 2 * (size_t)B * H : 0);
}

template <int H>
size_t sh_bytes(int B, bool bwd) {
  using W = Width<H>;
  if constexpr (!W::kShared) return kThreads / 32 * sizeof(double);
  const size_t d = act_doubles(B, H, bwd) + kThreads / 32;
  const size_t f = 3 * H + H + 2 * (H * W::kWS + H) + 2 * H + 2;
  return d * sizeof(double) + f * sizeof(float);
}

// Lay out the activations after act in order: inp, a1, a2, a3, [dz0, dz1].
__device__ __forceinline__ double* lay_out(Sh& s, double* d, int B, int H, bool bwd) {
  s.inp = d;
  s.a1 = s.inp + B * 3;
  s.a2 = s.a1 + B * H;
  s.a3 = s.a2 + B * H;
  d = s.a3 + B * H;
  s.dz0 = bwd ? d : nullptr;
  s.dz1 = bwd ? d + B * H : nullptr;
  return bwd ? d + 2 * B * H : d;
}

// Lay out the block's memory: for H = 100 copy the parameters into shared
// memory; for H = 512 point at the parameters, their transposed hidden
// matrices wt (w2^T then w3^T, (k, o)) and the device-memory scratch
// (act_doubles(B, H, bwd) doubles). Ends with a barrier.
template <int H>
__device__ Sh sh_load(unsigned char* sm, int B, bool bwd, const float* __restrict__ p,
                      const float* __restrict__ wt, double* scratch) {
  using W = Width<H>;
  Sh s;
  if constexpr (!W::kShared) {
    lay_out(s, scratch, B, H, bwd);
    s.red = reinterpret_cast<double*>(sm);
    s.w1 = p + W::kOffW1;
    s.b1 = p + W::kOffB1;
    s.w2 = p + W::kOffW2;
    s.b2 = p + W::kOffB2;
    s.w3 = p + W::kOffW3;
    s.b3 = p + W::kOffB3;
    s.w4 = p + W::kOffW4;
    s.b4 = p + W::kOffB4;
    s.w2f = wt;
    s.w3f = wt + H * H;
  } else {
    s.red = lay_out(s, reinterpret_cast<double*>(sm), B, H, bwd);
    float* w1 = reinterpret_cast<float*>(s.red + kThreads / 32);
    float* b1 = w1 + 3 * H;
    float* w2 = b1 + H;
    float* b2 = w2 + H * W::kWS;
    float* w3 = b2 + H;
    float* b3 = w3 + H * W::kWS;
    for (int i = threadIdx.x; i < W::kParams; i += blockDim.x) {
      const float v = p[i];
      if (i < W::kOffW2) {
        w1[i] = v;  // w1 then b1, contiguous
      } else if (i < W::kOffB2) {
        const int j = i - W::kOffW2;
        w2[(j / H) * W::kWS + j % H] = v;
      } else if (i < W::kOffW3) {
        b2[i - W::kOffB2] = v;
      } else if (i < W::kOffB3) {
        const int j = i - W::kOffW3;
        w3[(j / H) * W::kWS + j % H] = v;
      } else {
        b3[i - W::kOffB3] = v;  // b3, w4, b4 contiguous
      }
    }
    s.w1 = w1;
    s.b1 = b1;
    s.w2 = w2;
    s.b2 = b2;
    s.w3 = w3;
    s.b3 = b3;
    s.w4 = b3 + H;
    s.b4 = s.w4 + 2 * H;
    s.w2f = w2;
    s.w3f = w3;
  }
  __syncthreads();
  return s;
}

// mu(t) of lane b: the one-hot blend (1 - frac) mu[idx] + frac mu[idx + 1]
// (ops/interp.py interp_at_onehot), pos = (t - t0) / dt by IEEE division.
__device__ __forceinline__ float mu_at(const Net& n, float t, int b) {
  const float pos = fminf(fmaxf((t - n.t0) / n.dt, 0.0f), (float)(n.T - 1));
  const int idx = min(max((int)floorf(pos), 0), n.T - 2);
  const float frac = pos - (float)idx;
  return (1.0f - frac) * n.mu[idx * n.B + b] + frac * n.mu[(idx + 1) * n.B + b];
}

// One hidden layer of width H: out[b, o] = relu(sum_k in[b, k] w(o, k) +
// bias[o]) for the B x H outputs, one per thread task; w(o, k) at
// w[o * SO + k * SK].
template <int H, int K, int SO, int SK>
__device__ __forceinline__ void hidden(int B, const double* in, const float* w, const float* bias,
                                       double* out) {
  for (int e = threadIdx.x; e < B * H; e += blockDim.x) {
    const int b = e / H, o = e % H;
    const double* x = in + b * K;
    const float* wo = w + o * SO;
    const double z = tsum<K>([&](int k) { return x[k] * (double)wo[k * SK]; });
    out[e] = (double)relu((float)z + bias[o]);
  }
}

// The forward up to the last hidden layer at (t, y): this thread's state
// component y_c (c < 2B) and the lanes' mu fill the input, then three
// layers. Leaves inp, a1, a2, a3; ends with a barrier.
template <int H>
__device__ void forward_hidden(const Net& n, const Sh& s, float t, float y_c) {
  using W = Width<H>;
  const int c = threadIdx.x;
  if (c < 2 * n.B) s.inp[(c / 2) * 3 + c % 2] = (double)y_c;
  if (c < n.B) s.inp[c * 3 + 2] = (double)mu_at(n, t, c);
  __syncthreads();
  hidden<H, 3, 3, 1>(n.B, s.inp, s.w1, s.b1, s.a1);
  __syncthreads();
  hidden<H, H, W::kFO, W::kFK>(n.B, s.a1, s.w2f, s.b2, s.a2);
  __syncthreads();
  hidden<H, H, W::kFO, W::kFK>(n.B, s.a2, s.w3f, s.b3, s.a3);
  __syncthreads();
}

// One drift evaluation at (t, y): returns this thread's component of
// f(t, y) (threads c < 2B; the others return 0).
template <int H>
__device__ float drift(const Net& n, const Sh& s, float t, float y_c) {
  forward_hidden<H>(n, s, t, y_c);
  const int c = threadIdx.x;
  if (c >= 2 * n.B) return 0.0f;
  const double* x = s.a3 + (c / 2) * H;
  const float* wo = s.w4 + (c % 2) * H;
  const double z = tsum<H>([&](int k) { return x[k] * (double)wo[k]; });
  return (float)z + s.b4[c % 2];
}

// Add a parameter cotangent entry into the step's sum (the first of a step,
// from stage 6, sets it).
__device__ __forceinline__ void put(float* work, int i, float v, bool first) {
  work[i] = first ? v : work[i] + v;
}

// One layer of the VJP: from the cotangent g (B, O) of a layer's output
// (its input x (B, K), weights w (O, K) with row stride WS): the cotangent
// of x masked by x > 0 into gx (B, K) unless INPUT (the input layer, whose
// first two columns' cotangent goes to the state threads), and, with
// PARAMS, w's and b's cotangents contracted over the lanes into the step's
// sum.
template <int O, int K, int WS, bool INPUT, bool PARAMS>
__device__ float vjp_layer(int B, const double* g, const double* x, const float* w,
                           double* gx, float* work, int off_w, int off_b, bool first) {
  const int nx = INPUT ? 2 * B : B * K;
  const int tasks = PARAMS ? nx + O * K + O : nx;
  float state = 0.0f;
  for (int e = threadIdx.x; e < tasks; e += blockDim.x) {
    if (e < nx) {
      const int b = INPUT ? e / 2 : e / K, k = INPUT ? e % 2 : e % K;
      const double* gb = g + b * O;
      const double d = tsum<O>([&](int o) { return gb[o] * (double)w[o * WS + k]; });
      if (INPUT) {
        state = (float)d;  // e == threadIdx.x: the owner of component e
      } else {
        gx[e] = x[e] > 0.0 ? (double)(float)d : 0.0;
      }
    } else if (e < nx + O * K) {
      const int j = e - nx, o = j / K, k = j % K;
      const double d = lane_sum(B, [&](int b) { return g[b * O + o] * x[b * K + k]; });
      put(work, off_w + j, (float)d, first);
    } else {
      const int o = e - nx - O * K;
      const double d = lane_sum(B, [&](int b) { return g[b * O + o]; });
      put(work, off_b + o, (float)d, first);
    }
  }
  return state;
}

// The drift VJP at (t, y) for the output cotangent kbar: returns this
// thread's component of the state cotangent (threads c < 2B); with PARAMS,
// the eight parameter tensors' cotangents, contracted over the lanes, go
// into the step's sum ``work``. The forward is recomputed here, so the ReLU
// masks are the drift's at this state. Barriers throughout; ends with one.
template <int H, bool PARAMS>
__device__ float drift_vjp(const Net& n, const Sh& s, float t, float y_c, float kbar_c,
                           float* work, bool first) {
  using W = Width<H>;
  const int c = threadIdx.x, B = n.B;
  // The output layer's g = kbar (B, 2), as doubles in dz1 (the barriers of
  // the forward publish it).
  if (c < 2 * B) s.dz1[c] = (double)kbar_c;
  forward_hidden<H>(n, s, t, y_c);
  vjp_layer<2, H, H, false, PARAMS>(B, s.dz1, s.a3, s.w4, s.dz0, work, W::kOffW4, W::kOffB4,
                                    first);
  __syncthreads();
  vjp_layer<H, H, W::kWS, false, PARAMS>(B, s.dz0, s.a2, s.w3, s.dz1, work, W::kOffW3,
                                         W::kOffB3, first);
  __syncthreads();
  vjp_layer<H, H, W::kWS, false, PARAMS>(B, s.dz1, s.a1, s.w2, s.dz0, work, W::kOffW2,
                                         W::kOffB2, first);
  __syncthreads();
  const float g = vjp_layer<H, 3, 3, true, PARAMS>(B, s.dz0, s.inp, s.w1, nullptr, work,
                                                   W::kOffW1, W::kOffB1, first);
  __syncthreads();
  return g;
}

// The RMS of this thread's value q over the N = 2B components (threads
// c >= N add 0): the squares in float64, summed over the block.
__device__ float rms(const Sh& s, float q, int N) {
  const double v = (int)threadIdx.x < N ? (double)(q * q) : 0.0;
  return sqrtf((float)block_sum(v, s.red) / (float)N);
}

// One attempt from (t, y, k[0] = f(t, y)) with the step h: the stages
// k[1..6], y1 (= the stage-6 state) and the error ratio.
template <int H>
__device__ float attempt(const Net& n, const Sh& s, const Sel& sel, float t, float h, float y,
                         float (&k)[kStages], float& y1) {
#pragma unroll
  for (int i = 1; i < kStages; ++i) {
    const float ys = stage(i, h, y, k);
    if (i == kStages - 1) y1 = ys;
    k[i] = drift<H>(n, s, t + kC[i] * h, ys);
  }
  const float err = weighted(kBErr, h, k);
  const float q = err / (sel.atol + sel.rtol * fmaxf(fabsf(y), fabsf(y1)));
  return rms(s, q, 2 * n.B);
}

// Hairer's initial step (network_ode.py initial_step_size) from (t0, y, f0).
template <int H>
__device__ float initial_step(const Net& n, const Sh& s, const Sel& sel, float t0, float y,
                              float f0) {
  const int N = 2 * n.B;
  const float scale = sel.atol + sel.rtol * fabsf(y);
  const float d0 = rms(s, y / scale, N), d1 = rms(s, f0 / scale, N);
  const float h0 = (d0 < 1e-5f || d1 < 1e-5f) ? 1e-6f : (0.01f * d0) / d1;
  const float f1 = drift<H>(n, s, t0 + h0, y + h0 * f0);
  const float d2 = rms(s, (f1 - f0) / scale, N) / h0;
  const float h1 = (d1 <= 1e-15f && d2 <= 1e-15f)
                       ? fmaxf(h0 * 1e-3f, 1e-6f)
                       : expf((float)(1.0 / 5) * logf(0.01f / fmaxf(d1, d2)));
  return nan_min(100.0f * h0, h1);
}

// B6h: the whole selection of the batch.
template <int H>
__global__ void __launch_bounds__(kThreads, 1)
hopf_select_kernel(Net n, Sel sel, const float* __restrict__ params, const float* __restrict__ wt,
                   double* scratch, const float* __restrict__ y0,
                   float* __restrict__ st, int* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char sm[];
  const Sh s = sh_load<H>(sm, n.B, false, params, wt, scratch);
  const int c = threadIdx.x, N = 2 * n.B, M = sel.max_steps;
  for (int i = threadIdx.x; i <= M; i += blockDim.x) st[i] = i == 0 ? sel.t_start : sel.t_end;
  float y = c < N ? y0[c] : 0.0f, k[kStages], y1;
  float t = sel.t_start;
  k[0] = drift<H>(n, s, t, y);
  float h = sel.use_initial ? initial_step<H>(n, s, sel, t, y, k[0]) : sel.dt0;
  h = nan_min(h, sel.span);
  int na = 0, nr = 0;
  while (t < sel.t_end && na < M && nr < 4 * M + 64) {
    h = nan_min(h, sel.t_end - t);
    const float ratio = attempt<H>(n, s, sel, t, h, y, k, y1);
    if (ratio <= 1.0f) {
      t = t + h;
      y = y1;
      k[0] = k[kStages - 1];
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
template <int H>
__global__ void __launch_bounds__(kThreads, 1)
hopf_attempt_kernel(Net n, Sel sel, const float* __restrict__ params, const float* __restrict__ wt,
                    double* scratch, const float* __restrict__ t_in,
                    const float* __restrict__ h_in, const float* __restrict__ y_in,
                    const float* __restrict__ f0, float* __restrict__ y1_out,
                    float* __restrict__ f1_out, float* __restrict__ rec) {
  extern __shared__ __align__(16) unsigned char sm[];
  const Sh s = sh_load<H>(sm, n.B, false, params, wt, scratch);
  const int c = threadIdx.x, N = 2 * n.B;
  float y = c < N ? y_in[c] : 0.0f, k[kStages], y1;
  k[0] = c < N ? f0[c] : 0.0f;
  const float t = t_in[0];
  const float h = nan_min(h_in[0], sel.t_end - t);
  const float ratio = attempt<H>(n, s, sel, t, h, y, k, y1);
  if (c < N) {
    y1_out[c] = y1;
    f1_out[c] = k[kStages - 1];
  }
  if (threadIdx.x == 0) {
    rec[0] = ratio;
    rec[1] = h;
    rec[2] = next_step(h, ratio);
  }
}

// B7h: per step k < n, ys[k] = y, then the step from (st[k], y) with
// h = st[k+1] - st[k] and its five dense rows
//   r1 = y, r2 = dy = y1 - y, r3 = h k0 - dy, r4 = (dy - h k6) - r3,
//   r5 = sum_j (h d_j) k_j.
template <int H>
__global__ void __launch_bounds__(kThreads, 1)
hopf_replay_fwd_kernel(Net n, int n_steps, const float* __restrict__ params,
                       const float* __restrict__ wt, double* scratch,
                       const float* __restrict__ st, const float* __restrict__ y0,
                       float* __restrict__ ys, float* __restrict__ coeffs) {
  extern __shared__ __align__(16) unsigned char sm[];
  const Sh s = sh_load<H>(sm, n.B, false, params, wt, scratch);
  const int c = threadIdx.x, N = 2 * n.B;
  float y = c < N ? y0[c] : 0.0f, k[kStages], y1 = 0.0f;
  for (int kk = 0; kk < n_steps; ++kk) {
    const float t0 = st[kk], h = st[kk + 1] - t0;
    k[0] = drift<H>(n, s, t0, y);
#pragma unroll
    for (int i = 1; i < kStages; ++i) {
      const float yi = stage(i, h, y, k);
      if (i == kStages - 1) y1 = yi;
      k[i] = drift<H>(n, s, t0 + kC[i] * h, yi);
    }
    if (c < N) {
      float* ck = coeffs + (size_t)kk * 5 * N;
      const float dy = y1 - y;
      const float r3 = h * k[0] - dy;
      ys[(size_t)kk * N + c] = y;
      ck[c] = y;
      ck[N + c] = dy;
      ck[2 * N + c] = r3;
      ck[3 * N + c] = (dy - h * k[kStages - 1]) - r3;
      ck[4 * N + c] = weighted(kD, h, k);
    }
    y = y1;
  }
}

// The reverse sweep over steps n-1..0: B8h (kernel mode, EMIT false) and
// B8ho (emit mode). Per step, with the cotangents ybar (on y1, carried from
// the later steps) and c1..c5 (on the dense rows): rebuild the stage states
// Y0..Y6 from ys[k], then
//   r3bar = c3 - c4;  dybar = (c2 + c4) - r3bar;  y1bar = ybar + dybar
//   kbar_j = (h d_j) c5;  kbar_6 -= h c4;  kbar_0 += h r3bar
//   kbar_j += (h b_j) y1bar;  ysum = (c1 - dybar) + y1bar
//   for i = 6..0:  g = f^T|_{Y_i} kbar_i;  ysum += g;  kbar_j += (h a_ij) g
// and ybar = ysum. Kernel mode: each drift VJP's parameter cotangents
// (contracted over the lanes) add into the step's sum ``work`` from stage 6
// down; the step's sum adds into ``acc``. Emit mode: ybar_steps[k] = ybar
// before step k's VJP, and no parameter cotangents.
template <int H, bool EMIT>
__global__ void __launch_bounds__(kThreads, 1)
hopf_replay_bwd_kernel(Net n, int n_steps, const float* __restrict__ params,
                       const float* __restrict__ wt, double* scratch,
                       const float* __restrict__ st, const float* __restrict__ ys,
                       const float* __restrict__ cobar, float* __restrict__ ybar_out,
                       float* __restrict__ ybar_steps, float* __restrict__ acc,
                       float* __restrict__ work) {
  using W = Width<H>;
  extern __shared__ __align__(16) unsigned char sm[];
  const Sh s = sh_load<H>(sm, n.B, true, params, wt, scratch);
  const int c = threadIdx.x, N = 2 * n.B;
  if constexpr (!EMIT) {
    for (int i = threadIdx.x; i < W::kParams; i += blockDim.x) acc[i] = 0.0f;
  }
  float Y[kStages], kk[kStages], ysum = 0.0f;
  for (int k = n_steps - 1; k >= 0; --k) {
    const float t0 = st[k], h = st[k + 1] - t0;
    if constexpr (EMIT) {
      if (c < N) ybar_steps[(size_t)k * N + c] = ysum;
    }
    Y[0] = c < N ? ys[(size_t)k * N + c] : 0.0f;
    kk[0] = drift<H>(n, s, t0, Y[0]);
#pragma unroll
    for (int i = 1; i < kStages; ++i) {
      Y[i] = stage(i, h, Y[0], kk);
      if (i < kStages - 1) kk[i] = drift<H>(n, s, t0 + kC[i] * h, Y[i]);
    }
    const float* ck = cobar + (size_t)k * 5 * N;
    const int o = c < N ? c : 0;
    const float c1 = ck[o], c2 = ck[N + o], c3 = ck[2 * N + o], c4 = ck[3 * N + o],
                c5 = ck[4 * N + o];
    const float r3bar = c3 - c4;
    const float dybar = (c2 + c4) - r3bar;
    const float y1bar = ysum + dybar;
#pragma unroll
    for (int j = 0; j < kStages; ++j) {
      float v = kD[j] != 0.0f ? (h * kD[j]) * c5 : 0.0f;
      if (j == kStages - 1) v = v - h * c4;
      if (j == 0) v = v + h * r3bar;
      if (kB[j] != 0.0f) v = v + (h * kB[j]) * y1bar;
      kk[j] = v;
    }
    ysum = (c1 - dybar) + y1bar;
#pragma unroll
    for (int i = kStages - 1; i >= 0; --i) {
      const float g = drift_vjp<H, !EMIT>(n, s, i ? t0 + kC[i] * h : t0, Y[i], kk[i], work,
                                          i == kStages - 1);
      ysum = ysum + g;
      for (int j = 0; j < i; ++j) {
        const float a = kA[i][j];
        if (a != 0.0f) kk[j] = kk[j] + (h * a) * g;
      }
    }
    if constexpr (!EMIT) {
      for (int i = threadIdx.x; i < W::kParams; i += blockDim.x) acc[i] = acc[i] + work[i];
    }
  }
  if (c < N) ybar_out[c] = ysum;
}

template <typename Kern>
int set_smem(Kern kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int check_hopf(int B, int T) {
  if (B < 1 || B > kMaxLanes || T < 2) return (int)cudaErrorInvalidValue;
  return 0;
}

template <int H, typename Kern>
int launch_setup(Kern kernel, int B, int T, bool bwd, size_t* bytes) {
  if (int e = check_hopf(B, T)) return e;
  *bytes = sh_bytes<H>(B, bwd);
  return set_smem(kernel, *bytes);
}

Net make_hopf_net(int B, int T, const float* hc, const float* mu) {
  return Net{B, T, hc[0], hc[1], mu};
}

// Each entry point's body for hidden width H.
template <int H>
int select_h(int B, int T, const float* hc, const float* hs, int use_initial, int max_steps,
             const float* params, const float* wt, double* scratch, const float* mu,
             const float* y0, float* st, int* stats, void* stream) {
  size_t bytes;
  if (int e = launch_setup<H>(hopf_select_kernel<H>, B, T, false, &bytes)) return e;
  hopf_select_kernel<H><<<1, kThreads, bytes, (cudaStream_t)stream>>>(
      make_hopf_net(B, T, hc, mu), make_sel(hs, use_initial, max_steps), params, wt, scratch, y0,
      st, stats);
  return (int)cudaGetLastError();
}

template <int H>
int attempt_h(int B, int T, const float* hc, const float* hs, const float* params,
              const float* wt, double* scratch, const float* mu, const float* t, const float* h,
              const float* y, const float* f0, float* y1, float* f1, float* rec, void* stream) {
  size_t bytes;
  if (int e = launch_setup<H>(hopf_attempt_kernel<H>, B, T, false, &bytes)) return e;
  hopf_attempt_kernel<H><<<1, kThreads, bytes, (cudaStream_t)stream>>>(
      make_hopf_net(B, T, hc, mu), make_sel(hs, 0, 0), params, wt, scratch, t, h, y, f0, y1, f1,
      rec);
  return (int)cudaGetLastError();
}

template <int H>
int replay_fwd_h(int B, int T, const float* hc, int n_steps, const float* params,
                 const float* wt, double* scratch, const float* mu, const float* st,
                 const float* y0, float* ys, float* coeffs, void* stream) {
  size_t bytes;
  if (int e = launch_setup<H>(hopf_replay_fwd_kernel<H>, B, T, false, &bytes)) return e;
  hopf_replay_fwd_kernel<H><<<1, kThreads, bytes, (cudaStream_t)stream>>>(
      make_hopf_net(B, T, hc, mu), n_steps, params, wt, scratch, st, y0, ys, coeffs);
  return (int)cudaGetLastError();
}

template <int H, bool EMIT>
int replay_bwd_h(int B, int T, const float* hc, int n_steps, const float* params,
                 const float* wt, double* scratch, const float* mu, const float* st,
                 const float* ys, const float* cobar, float* ybar, float* ybar_steps,
                 float* dparams, float* work, void* stream) {
  size_t bytes;
  if (int e = launch_setup<H>(hopf_replay_bwd_kernel<H, EMIT>, B, T, true, &bytes)) return e;
  hopf_replay_bwd_kernel<H, EMIT><<<1, kThreads, bytes, (cudaStream_t)stream>>>(
      make_hopf_net(B, T, hc, mu), n_steps, params, wt, scratch, st, ys, cobar, ybar, ybar_steps,
      dparams, work);
  return (int)cudaGetLastError();
}

}  // namespace
