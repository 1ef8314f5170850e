// Column-network dopri5 kernels for Hopper (sm_90a): the adaptive step-size
// selection, the dense-output replay over the frozen grid, and the replay's
// reverse sweep. Plain C entry points, loaded with ctypes by
// columnflow_torch/kernels/_build.py; each returns cudaGetLastError().
//
// Replaces (columnflow/solvers/fused.py, the kernels of odeint_dopri5_fused):
//   cf_ode_select_team8       <- _make_adaptive_kernel: Hairer's initial step,
//                                the whole accept/reject while-loop, the
//                                accepted times, on the three-term split (the
//                                f32-exact engine's drift, and the split2
//                                tier's select_func), at any width, as one
//                                team of kCluster blocks that reads the
//                                weights from L2 (team.cuh): the yardstick of
//                                the cluster team in ode_select_team.cu, and
//                                the shapes its plan does not take
//   cf_ode_attempt_team8      <- the same body, one controller attempt (a
//                                second entry point, for testing the body)
//   cf_ode_replay_fwd         <- _make_replay_chunk_kernel: the six-stage step
//                                over the frozen grid, step-start states and
//                                CONTD5 rows, three-term split (B7, one block
//                                per lane, through 23 columns at 4 inputs)
//   cf_ode_replay_fwd_team_team8
//                             <- the same as a team of kCluster blocks per
//                                lane that reads the weights from L2 (the
//                                yardstick of B7t-team, the cluster team in
//                                ode_replay_team.cu)
//   cf_ode_replay_bwd         <- _make_bwd_chunk_kernel, kernel mode: the VJP of
//                                the step and its dense rows w.r.t. state, wT
//                                and iwT, three-term split (B8, the batch in
//                                one block, through 17 columns at 4 lanes)
//   cf_ode_replay_bwd_team    <- the same as one team of blocks for the batch
//                                (B8t-team, from 18 through 63 columns)
//   cf_ode_replay_bwd_split2  <- _make_bwd_chunk_kernel, kernel mode, with
//                                prepare_premixed_split2 (B8s: the fused-split2
//                                tier through 63 columns), the same team kernel
//                                on the two-term split
//   cf_ode_block_bytes        the shared memory B7 and B8 ask of one block
//                                (what picks them or the teams)
//   cf_ode_replay_bwd_emit_split3_team8
//                             <- _make_bwd_chunk_kernel(emit_steps=True,
//                                diff_idx=()) on the three-term split (B8't):
//                                the state cotangent alone and each step's
//                                output cotangent, a team of kCluster blocks
//                                per lane that reads the weights and their
//                                transposes from L2 (the yardstick of the
//                                cluster team in ode_emit_team.cu)
//   cf_ode_replay_fwd_split2_team8
//                             <- _make_replay_chunk_kernel with
//                                prepare_premixed_split2 (the fused-split2
//                                tier), the same team (the yardstick of B7
//                                split2 in ode_replay_team.cu)
//   cf_ode_replay_bwd_emit_team8
//                             <- the same on the two-term split (B8'),
//                                prepare_premixed_split2
// The cluster teams that replace B6, B7t-team, B7 split2, B8' and B8't on
// the main paths (ode_team.cuh) are built from ode_select_team.cu,
// ode_replay_team.cu and ode_emit_team.cu, their own sources so that nvcc
// compiles them beside this one.
// The JAX kernels trace any drift; these are written for the premixed
// column-network drift with a knot stimulus and a bf16 split of the
// recurrent matrix: the three-term one (prepare_premixed_split /
// matmul_split) or the two-term one (prepare_premixed_split2 /
// matmul_split2).
//
// Design. These are serial chains: ~2-3 * 10^3 steps of 6-7 drift
// evaluations, each one (B, P) x (P, P) product in six or three bf16 terms,
// and every step waits for the one before. The work per step is
// microseconds of the card's peak. Two designs:
//  - The f32-exact engine's replay and reverse sweep at the reference width
//    (P = 104): one block per lane (replay) or for the batch (sweep), the
//    three bf16 matrices split from the float32 wT into shared memory when
//    the kernel starts. The reverse sweep runs the batch in one block
//    because jax.vjp rounds each product's weight cotangent x_term^T c to
//    bf16 AFTER contracting it over the batch, so per-lane partial sums
//    rounded one by one would be another function. A thread owns its (i, j)
//    entries of the step's three bf16 accumulators and of the float32 sum
//    over steps, so their sum order is fixed and no atomics are needed.
//    Shared memory is requested with cudaFuncSetAttribute; where a block's
//    227 KB do not hold the weights and the states (the replay from 24
//    columns, the sweep from 18 at 4 lanes and 4 inputs) the wrappers take
//    the team kernels instead (network_ode.py ode_fwd_route / ode_bwd_route).
//  - The replays as teams (B7t-team, the split2 tier's B7; the yardstick
//    of ode_replay_team.cu's clusters) and the kernel-mode sweeps as teams
//    (B8t-team, B8s): a team of kCluster blocks (one thread-block cluster)
//    per lane, or for the batch in B8t-team, the weights read from L2, the
//    states in global memory (team.cuh says how).
//    B8t-team holds the batch for the same reason as B8: each block forms
//    the weight-cotangent entries of its own output columns from every
//    lane's exchanged terms.
//  - The selection (B6, both tiers) and the emit-mode sweeps (B8', B8't)
//    as teams of kCluster blocks, the weights from L2 (the yardstick; the
//    main paths run ode_team.cuh's clusters of 16). The selection has ONE
//    controller for the whole (B, 3P) state (the error ratio is an RMS over
//    all lanes), so its team holds every lane and reduces the norm over its
//    blocks in a fixed order.
//
// Precision: as network_sde.cu. float32 elementwise arithmetic with
// full-precision expf/tanhf/logf/sqrtf and IEEE division, compiled with
// -fmad=false so every operation rounds as in the plain PyTorch version.
// A tableau entry is a double constant rounded to float32 once; h * a_ij is
// rounded, then (h * a_ij) * k_j is rounded again, as the JAX package's
// weak-typed scalars round. Every product term is summed in float64 and
// rounded to float32 once; the six terms then add in float32 in
// matmul_split's order. The rounding points of the VJP through the bf16
// casts are those of jax.vjp (columnflow_torch/models/network.py, "the
// three-term split").

#include "dopri5.cuh"
#include "split3_drift.cuh"
#include "team.cuh"

namespace {

// Stage state i (1..6): out = y + sum_j (h a_ij) k_j over the nonzero a_ij,
// left to right. ks[j] are (N) arrays. Ends with a barrier.
__device__ void stage_state(int N, int i, float h, const float* y, float* const* ks, float* out) {
  for (int idx = threadIdx.x; idx < N; idx += blockDim.x) {
    float v = y[idx];
    for (int j = 0; j < i; ++j) {
      const float a = kA[i][j];
      if (a != 0.0f) v = v + (h * a) * ks[j][idx];
    }
    out[idx] = v;
  }
  __syncthreads();
}

// sum_j (h w_j) k_j[idx] over the nonzero w_j, left to right, the first term
// alone where the plain version starts from it.
__device__ __forceinline__ float weighted(const float* w, float h, float* const* ks, int idx) {
  float v = 0.0f;
  bool first = true;
  for (int j = 0; j < kStages; ++j) {
    if (w[j] != 0.0f) {
      const float term = (h * w[j]) * ks[j][idx];
      v = first ? term : v + term;
      first = false;
    }
  }
  return v;
}

// ---------------------------------------------------------------------------
// The step's state vectors and the I controller
// ---------------------------------------------------------------------------

struct SelBuf {
  float* y;            // (B, 3P) the state at t
  float* k[kStages];   // stage derivatives; k[0] = f(t, y)
  float* ys;           // stage state
  float* y1;           // the fifth-order solution
};

__device__ void carve_sel(float* p, int N, SelBuf* u) {
  Carve c{p};
  u->y = c.take(N);
  for (int i = 0; i < kStages; ++i) u->k[i] = c.take(N);
  u->ys = c.take(N);
  u->y1 = c.take(N);
}

// ---------------------------------------------------------------------------
// The replay (one block per lane) and its reverse sweep (one block)
// ---------------------------------------------------------------------------

constexpr int kFwdVectors = 10;

// Per step k < n: ys[k] = y, then the step from (st[k], y) with
// h = st[k+1] - st[k] and its five dense rows
//   r1 = y, r2 = dy = y1 - y, r3 = h k0 - dy, r4 = (dy - h k6) - r3,
//   r5 = sum_j (h d_j) k_j.
__global__ void __launch_bounds__(kThreads)
ode_replay_fwd_kernel(Net n, int n_steps, const float* __restrict__ wT,
                      const float* __restrict__ iwT, const float* __restrict__ st,
                      const float* __restrict__ y0, float* __restrict__ ys,
                      float* __restrict__ coeffs) {
  extern __shared__ float sm[];
  W3 w;
  Scr s;
  SelBuf u;
  const int S = 3 * n.P, B = n.B, b = blockIdx.x;
  carve_sel(setup(sm, n, 1, wT, iwT, &w, &s), S, &u);
  for (int i = threadIdx.x; i < S; i += blockDim.x) u.y[i] = y0[(size_t)b * S + i];
  __syncthreads();
  for (int k = 0; k < n_steps; ++k) {
    const float t0 = st[k], h = st[k + 1] - t0;
    drift3(n, b, 1, t0, u.y, u.k[0], w, s);
    for (int i = 1; i < kStages; ++i) {
      float* dst = i == kStages - 1 ? u.y1 : u.ys;
      stage_state(S, i, h, u.y, u.k, dst);
      drift3(n, b, 1, t0 + kC[i] * h, dst, u.k[i], w, s);
    }
    float* yk = ys + ((size_t)k * B + b) * S;
    float* ck = coeffs + ((size_t)k * 5 * B + b) * S;
    const size_t row = (size_t)B * S;
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      const float y = u.y[i], y1 = u.y1[i];
      const float dy = y1 - y;
      const float r3 = h * u.k[0][i] - dy;
      yk[i] = y;
      ck[i] = y;
      ck[row + i] = dy;
      ck[2 * row + i] = r3;
      ck[3 * row + i] = (dy - h * u.k[kStages - 1][i]) - r3;
      ck[4 * row + i] = weighted(kD, h, u.k, i);
      u.y[i] = y1;
    }
    __syncthreads();
  }
}

constexpr int kBwdVectors = 16;

// Reverse sweep over steps n-1..0. Per step, with the cotangents ybar (on
// y1, carried from the later steps) and c1..c5 (on the dense rows): rebuild
// the stage states Y0..Y6 from ys[k], then
//   r3bar = c3 - c4;  dybar = (c2 + c4) - r3bar;  y1bar = ybar + dybar
//   kbar_j = (h d_j) c5;  kbar_6 -= h c4;  kbar_0 += h r3bar
//   kbar_j += (h b_j) y1bar;  ysum = (c1 - dybar) + y1bar
//   for i = 6..0:  g = f^T|_{Y_i} kbar_i;  ysum += g;  kbar_j += (h a_ij) g
// and ybar = ysum. The drift VJPs' weight cotangents add in bf16 within the
// step and fold through the split once per step into the float32 sums.
__global__ void __launch_bounds__(kThreads)
ode_replay_bwd_kernel(Net n, int n_steps, const float* __restrict__ wT,
                      const float* __restrict__ iwT, const float* __restrict__ st,
                      const float* __restrict__ ys, const float* __restrict__ cobar,
                      float* __restrict__ ybar_out, float* __restrict__ d_wT,
                      float* __restrict__ d_iwT, float* __restrict__ work) {
  extern __shared__ float sm[];
  W3 w;
  Scr s;
  const int P = n.P, B = n.B, N = B * 3 * P;
  Carve c{setup(sm, n, B, wT, iwT, &w, &s)};
  float *Y[kStages], *kk[kStages];
  for (int i = 0; i < kStages; ++i) Y[i] = c.take(N);
  for (int i = 0; i < kStages; ++i) kk[i] = c.take(N);
  float* ysum = c.take(N);
  float* g = c.take(N);
  WAcc acc{work, work + P * P, work + 2 * P * P, c.take(n.n_in * P)};
  for (int e = threadIdx.x; e < P * P; e += blockDim.x) d_wT[e] = 0.0f;
  for (int e = threadIdx.x; e < n.n_in * P; e += blockDim.x) d_iwT[e] = 0.0f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) ysum[i] = 0.0f;  // ybar of the last step
  __syncthreads();
  for (int k = n_steps - 1; k >= 0; --k) {
    const float t0 = st[k], h = st[k + 1] - t0;
    const float* yk = ys + (size_t)k * N;
    const float* ck = cobar + (size_t)k * 5 * N;
    for (int i = threadIdx.x; i < N; i += blockDim.x) Y[0][i] = yk[i];
    __syncthreads();
    drift3(n, 0, B, t0, Y[0], kk[0], w, s);
    for (int i = 1; i < kStages; ++i) {
      stage_state(N, i, h, Y[0], kk, Y[i]);
      if (i < kStages - 1) drift3(n, 0, B, t0 + kC[i] * h, Y[i], kk[i], w, s);
    }
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const float c1 = ck[i], c2 = ck[N + i], c3 = ck[2 * N + i], c4 = ck[3 * N + i],
                  c5 = ck[4 * N + i];
      const float r3bar = c3 - c4;
      const float dybar = (c2 + c4) - r3bar;
      const float y1bar = ysum[i] + dybar;
      for (int j = 0; j < kStages; ++j) {
        float v = kD[j] != 0.0f ? (h * kD[j]) * c5 : 0.0f;
        if (j == kStages - 1) v = v - h * c4;
        if (j == 0) v = v + h * r3bar;
        if (kB[j] != 0.0f) v = v + (h * kB[j]) * y1bar;
        kk[j][i] = v;
      }
      ysum[i] = (c1 - dybar) + y1bar;
    }
    __syncthreads();
    for (int i = kStages - 1; i >= 0; --i) {
      drift_vjp3(n, B, i ? t0 + kC[i] * h : t0, Y[i], kk[i], g, w, s, acc, i == kStages - 1);
      for (int e = threadIdx.x; e < N; e += blockDim.x) {
        const float ge = g[e];
        ysum[e] = ysum[e] + ge;
        for (int j = 0; j < i; ++j) {
          const float a = kA[i][j];
          if (a != 0.0f) kk[j][e] = kk[j][e] + (h * a) * ge;
        }
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < P * P; e += blockDim.x) {
      const float lo = acc.lo[e];
      const float r = lo + bf16r(acc.mid[e] - lo);
      d_wT[e] = d_wT[e] + (r + bf16r(acc.hi[e] + bf16r(-r)));
    }
    for (int e = threadIdx.x; e < n.n_in * P; e += blockDim.x) d_iwT[e] = d_iwT[e] + acc.iw[e];
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x) ybar_out[i] = ysum[i];
}

// Shared memory of the one-block kernels: the replay (sweep 0, one lane per
// block) and the kernel-mode sweep (sweep 1, the batch of B lanes in one
// block, with the step's (n_in, P) iwT sum). cf_ode_block_bytes exports it.
size_t block_bytes(int B, int P, int n_in, int sweep) {
  const int nb = sweep ? B : 1;
  const size_t vectors = sweep ? kBwdVectors : kFwdVectors;
  const size_t extra = sweep ? (size_t)n_in * P : 0;
  return sizeof(float) * (setup_floats(P, n_in, nb) + vectors * nb * 3 * P + extra);
}

template <typename Kern>
int prepare(Kern kernel, int P, int n_in, int K, size_t bytes) {
  if (int e = check_shape(P, n_in, K)) return e;
  return set_smem(kernel, bytes);
}


// ---------------------------------------------------------------------------
// Teams (team.cuh): the selection at any width, the replay and the emit-mode
// sweep on either split, a team of kCluster blocks per lane (per batch in
// the selection and in B8t-team), the weights streamed from L2
// ---------------------------------------------------------------------------

constexpr int kSelLanes = 4;  // lanes per thread in the selection's products

// Stage state i over the own entries: out = y + sum_j (h a_ij) k_j.
__device__ void stage_own(const Team& T, int P, int i, float h, const float* y,
                          float* const* ks, float* out) {
  for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
    const int off = own_off(T, P, e);
    float v = y[off];
    for (int j = 0; j < i; ++j) {
      const float a = kA[i][j];
      if (a != 0.0f) v = v + (h * a) * ks[j][off];
    }
    out[off] = v;
  }
  __syncthreads();
}

__device__ float attempt_team(const Net& n, Team& T, const Sel& sel, int N, float t, float h,
                              const SelBuf& u, const Wg& w) {
  for (int i = 1; i < kStages; ++i) {
    float* dst = i == kStages - 1 ? u.y1 : u.ys;
    stage_own(T, n.P, i, h, u.y, u.k, dst);
    drift_team<3, kSelLanes>(n, T, t + kC[i] * h, dst, u.k[i], w);
  }
  double acc = 0.0;
  for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
    const int off = own_off(T, n.P, e);
    const float err = weighted(kBErr, h, u.k, off);
    const float q = err / (sel.atol + sel.rtol * fmaxf(fabsf(u.y[off]), fabsf(u.y1[off])));
    acc += (double)(q * q);
  }
  return sqrtf((float)team_sum(T, acc) / (float)N);
}

__device__ float initial_step_team(const Net& n, Team& T, const Sel& sel, int N, float t0,
                                   const SelBuf& u, const Wg& w) {
  double a0 = 0.0, a1 = 0.0;
  for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
    const int off = own_off(T, n.P, e);
    const float scale = sel.atol + sel.rtol * fabsf(u.y[off]);
    const float q0 = u.y[off] / scale, q1 = u.k[0][off] / scale;
    a0 += (double)(q0 * q0);
    a1 += (double)(q1 * q1);
  }
  const float d0 = sqrtf((float)team_sum(T, a0) / (float)N);
  const float d1 = sqrtf((float)team_sum(T, a1) / (float)N);
  const float h0 = (d0 < 1e-5f || d1 < 1e-5f) ? 1e-6f : (0.01f * d0) / d1;
  for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
    const int off = own_off(T, n.P, e);
    u.ys[off] = u.y[off] + h0 * u.k[0][off];
  }
  __syncthreads();
  drift_team<3, kSelLanes>(n, T, t0 + h0, u.ys, u.k[1], w);
  double a2 = 0.0;
  for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
    const int off = own_off(T, n.P, e);
    const float scale = sel.atol + sel.rtol * fabsf(u.y[off]);
    const float q = (u.k[1][off] - u.k[0][off]) / scale;
    a2 += (double)(q * q);
  }
  const float d2 = sqrtf((float)team_sum(T, a2) / (float)N) / h0;
  const float h1 = (d1 <= 1e-15f && d2 <= 1e-15f)
                       ? fmaxf(h0 * 1e-3f, 1e-6f)
                       : expf((float)(1.0 / 5) * logf(0.01f / fmaxf(d1, d2)));
  return nan_min(100.0f * h0, h1);
}

// The batch's ten state vectors, in global memory, N floats each.
__device__ void carve_global(float* p, int N, SelBuf* u) {
  u->y = p;
  for (int i = 0; i < kStages; ++i) u->k[i] = p + (size_t)(1 + i) * N;
  u->ys = p + (size_t)8 * N;
  u->y1 = p + (size_t)9 * N;
}

// B6 at any width: the whole selection of the batch on the three-term split,
// one team.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
ode_select_kernel(Net n, Sel sel, Wg w, const float* __restrict__ y0, float* scr,
                     float* __restrict__ st, int* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smt[];
  Team T;
  team_init(T, smt, n.P, n.B, 0, 3, 6, kSelLanes);
  SelBuf u;
  const int N = n.B * T.S, M = sel.max_steps;
  carve_global(scr, N, &u);
  const bool lead = T.rank == 0;
  if (lead)
    for (int i = threadIdx.x; i <= M; i += blockDim.x) st[i] = i == 0 ? sel.t_start : sel.t_end;
  for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
    const int off = own_off(T, n.P, e);
    u.y[off] = y0[off];
  }
  __syncthreads();
  float t = sel.t_start;
  drift_team<3, kSelLanes>(n, T, t, u.y, u.k[0], w);
  float h = sel.use_initial ? initial_step_team(n, T, sel, N, t, u, w) : sel.dt0;
  h = nan_min(h, sel.span);
  int na = 0, nr = 0;
  while (t < sel.t_end && na < M && nr < 4 * M + 64) {
    h = nan_min(h, sel.t_end - t);
    const float ratio = attempt_team(n, T, sel, N, t, h, u, w);
    if (ratio <= 1.0f) {
      t = t + h;
      for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
        const int off = own_off(T, n.P, e);
        u.y[off] = u.y1[off];
        u.k[0][off] = u.k[kStages - 1][off];
      }
      ++na;
    } else {
      ++nr;
    }
    if (lead && threadIdx.x == 0) st[na] = t;
    h = next_step(h, ratio);
    __syncthreads();
  }
  if (lead && threadIdx.x == 0) {
    stats[0] = na;
    stats[1] = nr;
    stats[2] = t >= sel.t_end ? 1 : 0;
  }
}

// One attempt of that kernel's loop: y1, f1 = k6, rec = (ratio, h, next h).
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
ode_attempt_kernel(Net n, Sel sel, Wg w, const float* __restrict__ t_in,
                      const float* __restrict__ h_in, const float* __restrict__ y,
                      const float* __restrict__ f0, float* scr, float* __restrict__ y1,
                      float* __restrict__ f1, float* __restrict__ rec) {
  extern __shared__ __align__(16) unsigned char smt[];
  Team T;
  team_init(T, smt, n.P, n.B, 0, 3, 6, kSelLanes);
  SelBuf u;
  const int N = n.B * T.S;
  carve_global(scr, N, &u);
  for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
    const int off = own_off(T, n.P, e);
    u.y[off] = y[off];
    u.k[0][off] = f0[off];
  }
  __syncthreads();
  const float t = t_in[0];
  const float h = nan_min(h_in[0], sel.t_end - t);
  const float ratio = attempt_team(n, T, sel, N, t, h, u, w);
  for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
    const int off = own_off(T, n.P, e);
    y1[off] = u.y1[off];
    f1[off] = u.k[kStages - 1][off];
  }
  if (T.rank == 0 && threadIdx.x == 0) {
    rec[0] = ratio;
    rec[1] = h;
    rec[2] = next_step(h, ratio);
  }
}

// B7 as a team per lane: lane blockIdx.x / kCluster, one team each. The step
// and its rows as ode_replay_fwd_kernel. NT = 2: the split2 tier's replay
// (two-term split); NT = 3: B7t-team, the f32-exact engine's replay where
// the three-term weights do not fit a block (from 24 columns at 4 inputs).
template <int NT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
ode_replay_fwd_team_kernel(Net n, int n_steps, Wg w, const float* __restrict__ st,
                           const float* __restrict__ y0, float* scr, float* __restrict__ ys,
                           float* __restrict__ coeffs) {
  extern __shared__ __align__(16) unsigned char smt[];
  Team T;
  const int b = blockIdx.x / kCluster;
  team_init(T, smt, n.P, 1, b, NT, NT == 3 ? 6 : 3, 1);
  const int S = T.S, B = n.B;
  SelBuf u;
  carve_global(scr + (size_t)b * 10 * S, S, &u);
  for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
    const int off = own_off(T, n.P, e);
    u.y[off] = y0[(size_t)b * S + off];
  }
  __syncthreads();
  const size_t row = (size_t)B * S;
  for (int k = 0; k < n_steps; ++k) {
    const float t0 = st[k], h = st[k + 1] - t0;
    drift_team<NT, 1>(n, T, t0, u.y, u.k[0], w);
    for (int i = 1; i < kStages; ++i) {
      float* dst = i == kStages - 1 ? u.y1 : u.ys;
      stage_own(T, n.P, i, h, u.y, u.k, dst);
      drift_team<NT, 1>(n, T, t0 + kC[i] * h, dst, u.k[i], w);
    }
    float* yk = ys + ((size_t)k * B + b) * S;
    float* ck = coeffs + ((size_t)k * 5 * B + b) * S;
    for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
      const int i = own_off(T, n.P, e);
      const float y = u.y[i], y1 = u.y1[i];
      const float dy = y1 - y;
      const float r3 = h * u.k[0][i] - dy;
      yk[i] = y;
      ck[i] = y;
      ck[row + i] = dy;
      ck[2 * row + i] = r3;
      ck[3 * row + i] = (dy - h * u.k[kStages - 1][i]) - r3;
      ck[4 * row + i] = weighted(kD, h, u.k, i);
      u.y[i] = y1;
    }
    __syncthreads();
  }
}

// B8 in emit mode: the reverse sweep of the state cotangent alone, lane
// blockIdx.x / kCluster. Per step k (n-1 down to 0) it first writes
// ybar_steps[k] = the cotangent on the step's output from the later steps,
// then runs the step's VJP as ode_replay_bwd_kernel does, without the weight
// cotangents. NT = 2: B8', the split2 tier's sweep; NT = 3: B8't, the
// f32-exact engine's sweep where its weights hold more than 1 MiB (from 64
// columns at 4 inputs). Either way the weight gradients are taken outside
// (solvers/fused.py ode_outer_arg_grads).
template <int NT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
ode_replay_bwd_emit_kernel(Net n, int n_steps, Wg w, const float* __restrict__ st,
                           const float* __restrict__ ys, const float* __restrict__ cobar,
                           float* scr, float* __restrict__ ybar_out,
                           float* __restrict__ ybar_steps) {
  extern __shared__ __align__(16) unsigned char smt[];
  Team T;
  const int b = blockIdx.x / kCluster;
  team_init(T, smt, n.P, 1, b, NT, NT == 3 ? 6 : 3, 1);
  const int S = T.S, B = n.B;
  const size_t N = (size_t)B * S;
  float* base = scr + (size_t)b * 16 * S;
  float *Y[kStages], *kk[kStages];
  for (int i = 0; i < kStages; ++i) {
    Y[i] = base + (size_t)i * S;
    kk[i] = base + (size_t)(kStages + i) * S;
  }
  float* ysum = base + (size_t)14 * S;
  float* g = base + (size_t)15 * S;
  for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) ysum[own_off(T, n.P, e)] = 0.0f;
  __syncthreads();
  for (int k = n_steps - 1; k >= 0; --k) {
    const float t0 = st[k], h = st[k + 1] - t0;
    const float* yk = ys + ((size_t)k * B + b) * S;
    const float* ck = cobar + ((size_t)k * 5 * B + b) * S;
    float* sk = ybar_steps + ((size_t)k * B + b) * S;
    for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
      const int i = own_off(T, n.P, e);
      Y[0][i] = yk[i];
      sk[i] = ysum[i];
    }
    __syncthreads();
    drift_team<NT, 1>(n, T, t0, Y[0], kk[0], w);
    for (int i = 1; i < kStages; ++i) {
      stage_own(T, n.P, i, h, Y[0], kk, Y[i]);
      if (i < kStages - 1) drift_team<NT, 1>(n, T, t0 + kC[i] * h, Y[i], kk[i], w);
    }
    for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
      const int i = own_off(T, n.P, e);
      const float c1 = ck[i], c2 = ck[N + i], c3 = ck[2 * N + i], c4 = ck[3 * N + i],
                  c5 = ck[4 * N + i];
      const float r3bar = c3 - c4;
      const float dybar = (c2 + c4) - r3bar;
      const float y1bar = ysum[i] + dybar;
      for (int j = 0; j < kStages; ++j) {
        float v = kD[j] != 0.0f ? (h * kD[j]) * c5 : 0.0f;
        if (j == kStages - 1) v = v - h * c4;
        if (j == 0) v = v + h * r3bar;
        if (kB[j] != 0.0f) v = v + (h * kB[j]) * y1bar;
        kk[j][i] = v;
      }
      ysum[i] = (c1 - dybar) + y1bar;
    }
    __syncthreads();
    for (int s = kStages - 1; s >= 0; --s) {
      if constexpr (NT == 3) vjp3_team(n, T, Y[s], kk[s], g, w);
      else vjp2_team(n, T, Y[s], kk[s], g, w);
      for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
        const int i = own_off(T, n.P, e);
        const float ge = g[i];
        ysum[i] = ysum[i] + ge;
        for (int j = 0; j < s; ++j) {
          const float a = kA[s][j];
          if (a != 0.0f) kk[j][i] = kk[j][i] + (h * a) * ge;
        }
      }
      __syncthreads();
    }
  }
  for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
    const int i = own_off(T, n.P, e);
    ybar_out[(size_t)b * S + i] = ysum[i];
  }
}

// B8t-team: ode_replay_bwd_kernel (kernel mode, three-term split) as one team
// of kCluster blocks for the whole batch, where the batch's sixteen state
// vectors and the three-term weights do not fit one block (from 18 columns
// at 4 lanes and 4 inputs). jax.vjp contracts each product's weight
// cotangent over the lanes before its bf16 rounding, so the lanes cannot run
// as independent teams. As in network_sde.cu's B4't-team, block r owns
// populations [c0, c0 + nc) of every lane (their state entries) and the
// weight-cotangent entries of its own OUTPUT columns j, every row i. Each of
// a step's seven drift VJPs stores the rates' bf16 terms, the current's
// cotangent and the stimulus into every block's shared memory (vjp_team_w,
// two WX buffers used in turn: a block writes buffer p of VJP m only after
// the cluster barrier of VJP m - 1, which every block reaches after its
// contraction of VJP m - 2, the last reads of buffer p); each block then
// contracts its entries over the lanes in float64, in lane order, rounds to
// bf16 and adds to the step's accumulators (global work, NT (P, P) bf16
// sums and the float32 (n_in, P) iwT sum, each entry touched by one thread
// of its own block only): stage 6's VJP opens them, stages 5..0 add, as the
// reverse pass meets the forward's products. After the step each block folds
// its entries through the split once into d_wT and adds d_iwT's. No value
// crosses a block in a sum, so the result is the one-block B8's and the plain
// version's bit for bit. scr: 16 B 3P floats (Y0..Y6, k0..k6, ysum, g).
// NT = 3: B8t-team (the f32-exact engine, prepare_premixed_split); NT = 2:
// B8s, the fused-split2 tier's sweep with its weight gradients in the kernel
// (prepare_premixed_split2: two bf16 terms of the rates against two of wT,
// three products per drift, the accumulators hi and mid, split2_fold), at
// every width where the JAX package takes kernel mode (through 63 columns at
// 4 inputs); there is no one-block B8s.
template <int NT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
ode_replay_bwd_team_kernel(Net n, int n_steps, Wg w, int team_bytes,
                           const float* __restrict__ st, const float* __restrict__ ys,
                           const float* __restrict__ cobar, float* scr,
                           float* __restrict__ ybar_out, float* __restrict__ d_wT,
                           float* __restrict__ d_iwT, float* work) {
  extern __shared__ __align__(16) unsigned char smt[];
  Team T;
  const int B = n.B;
  team_init(T, smt, n.P, B, 0, NT, NT == 3 ? 6 : 3, 1);
  const int P = n.P, nc = T.nc, c0 = T.c0, NI = n.n_in;
  const size_t N = (size_t)B * T.S, PP = (size_t)P * P;
  unsigned char* p = smt + team_bytes;
  const WX wx[2] = {wx_at(p, P, B), wx_at(p + wx_bytes(P, B), P, B)};
  float *Y[kStages], *kk[kStages];
  for (int i = 0; i < kStages; ++i) {
    Y[i] = scr + (size_t)i * N;
    kk[i] = scr + (size_t)(kStages + i) * N;
  }
  float* ysum = scr + (size_t)14 * N;
  float* g = scr + (size_t)15 * N;
  float* acc_iw = work + NT * PP;  // after the NT accumulators (hi, mid[, lo])
  for (int e = threadIdx.x; e < P * nc; e += blockDim.x) {
    const int i = e / nc;
    d_wT[(size_t)i * P + c0 + (e - i * nc)] = 0.0f;
  }
  for (int e = threadIdx.x; e < NI * nc; e += blockDim.x) {
    const int m = e / nc;
    d_iwT[(size_t)m * P + c0 + (e - m * nc)] = 0.0f;
  }
  for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) ysum[own_off(T, P, e)] = 0.0f;
  __syncthreads();
  int xp = 0;  // the WX buffer of the next drift VJP
  for (int k = n_steps - 1; k >= 0; --k) {
    const float t0 = st[k], h = st[k + 1] - t0;
    const float* yk = ys + (size_t)k * N;
    const float* ck = cobar + (size_t)k * 5 * N;
    for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
      const int i = own_off(T, P, e);
      Y[0][i] = yk[i];
    }
    __syncthreads();
    drift_team<NT, 1>(n, T, t0, Y[0], kk[0], w);
    for (int i = 1; i < kStages; ++i) {
      stage_own(T, P, i, h, Y[0], kk, Y[i]);
      if (i < kStages - 1) drift_team<NT, 1>(n, T, t0 + kC[i] * h, Y[i], kk[i], w);
    }
    for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
      const int i = own_off(T, P, e);
      const float c1 = ck[i], c2 = ck[N + i], c3 = ck[2 * N + i], c4 = ck[3 * N + i],
                  c5 = ck[4 * N + i];
      const float r3bar = c3 - c4;
      const float dybar = (c2 + c4) - r3bar;
      const float y1bar = ysum[i] + dybar;
      for (int j = 0; j < kStages; ++j) {
        float v = kD[j] != 0.0f ? (h * kD[j]) * c5 : 0.0f;
        if (j == kStages - 1) v = v - h * c4;
        if (j == 0) v = v + h * r3bar;
        if (kB[j] != 0.0f) v = v + (h * kB[j]) * y1bar;
        kk[j][i] = v;
      }
      ysum[i] = (c1 - dybar) + y1bar;
    }
    __syncthreads();
    for (int s = kStages - 1; s >= 0; --s) {
      const WX& x = wx[xp];
      xp ^= 1;
      vjp_team_w<NT>(n, T, s ? t0 + kC[s] * h : t0, nullptr, Y[s], kk[s], g, w, x);
      for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
        const int i = own_off(T, P, e);
        const float ge = g[i];
        ysum[i] = ysum[i] + ge;
        for (int j = 0; j < s; ++j) {
          const float a = kA[s][j];
          if (a != 0.0f) kk[j][i] = kk[j][i] + (h * a) * ge;
        }
      }
      // This VJP's weight cotangents of the own columns, every row.
      const bool first = s == kStages - 1;
      for (int e = threadIdx.x; e < P * nc; e += blockDim.x) {
        const int i = e / nc, j = c0 + (e - i * nc);
        const size_t at = (size_t)i * P + j;
        float d[NT], acc[NT];
        wx_cot<NT>(x, B, P, i, j, d);
#pragma unroll
        for (int q = 0; q < NT; ++q) acc[q] = first ? 0.0f : work[q * PP + at];
        acc_add<NT>(acc, d, first);
#pragma unroll
        for (int q = 0; q < NT; ++q) work[q * PP + at] = acc[q];
      }
      for (int e = threadIdx.x; e < NI * nc; e += blockDim.x) {
        const int m = e / nc, j = c0 + (e - m * nc);
        double d = 0.0;
        for (int b = 0; b < B; ++b)
          d += (double)x.ext[b * kMaxInputs + m] * (double)x.c[(size_t)b * P + j];
        const size_t at = (size_t)m * P + j;
        acc_iw[at] = first ? (float)d : acc_iw[at] + (float)d;
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < P * nc; e += blockDim.x) {
      const int i = e / nc;
      const size_t at = (size_t)i * P + c0 + (e - i * nc);
      float acc[NT];
#pragma unroll
      for (int q = 0; q < NT; ++q) acc[q] = work[q * PP + at];
      d_wT[at] = d_wT[at] + acc_fold<NT>(acc);
    }
    for (int e = threadIdx.x; e < NI * nc; e += blockDim.x) {
      const int m = e / nc;
      const size_t at = (size_t)m * P + c0 + (e - m * nc);
      d_iwT[at] = d_iwT[at] + acc_iw[at];
    }
  }
  for (int e = threadIdx.x; e < own_count(T); e += blockDim.x) {
    const int i = own_off(T, P, e);
    ybar_out[i] = ysum[i];
  }
}

// B7 as a team per lane: NT = 2 (cf_ode_replay_fwd_split2_team8, the split2
// tier) or 3 (cf_ode_replay_fwd_team_team8, B7t-team); lo unused at NT = 2.
template <int NT>
int replay_fwd_team(int B, int P, int n_in, int K, const float* hc, int n_steps,
                    const float* bg, const float* adapt, const void* hi, const void* mid,
                    const void* lo, const float* iw, const float* kv, const float* st,
                    const float* y0, float* scr, float* ys, float* coeffs, void* stream) {
  size_t bytes;
  if (int e = team_prepare(ode_replay_fwd_team_kernel<NT>, P, n_in, K, 1, NT, NT == 3 ? 6 : 3,
                           1, &bytes))
    return e;
  const Wg w{(const bf16*)hi, (const bf16*)mid, NT == 3 ? (const bf16*)lo : nullptr, nullptr,
             nullptr, nullptr, iw};
  if (B > 0)
    ode_replay_fwd_team_kernel<NT><<<kCluster * B, kThreads, bytes, (cudaStream_t)stream>>>(
        make_net(B, P, n_in, K, hc, bg, adapt, kv), n_steps, w, st, y0, scr, ys, coeffs);
  return (int)cudaGetLastError();
}

// B8 in emit mode as a team per lane: NT = 2 (cf_ode_replay_bwd_emit, B8')
// or 3 (cf_ode_replay_bwd_emit_split3, B8't); lo, loT unused at NT = 2.
template <int NT>
int replay_bwd_emit(int B, int P, int n_in, int K, const float* hc, int n_steps,
                    const float* bg, const float* adapt, const void* hi, const void* mid,
                    const void* lo, const void* hiT, const void* midT, const void* loT,
                    const float* iw, const float* kv, const float* st, const float* ys,
                    const float* cobar, float* scr, float* ybar, float* ybar_steps,
                    void* stream) {
  size_t bytes;
  if (int e = team_prepare(ode_replay_bwd_emit_kernel<NT>, P, n_in, K, 1, NT, NT == 3 ? 6 : 3,
                           1, &bytes))
    return e;
  const Wg w{(const bf16*)hi, (const bf16*)mid, NT == 3 ? (const bf16*)lo : nullptr,
             (const bf16*)hiT, (const bf16*)midT, NT == 3 ? (const bf16*)loT : nullptr, iw};
  if (B > 0)
    ode_replay_bwd_emit_kernel<NT><<<kCluster * B, kThreads, bytes, (cudaStream_t)stream>>>(
        make_net(B, P, n_in, K, hc, bg, adapt, kv), n_steps, w, st, ys, cobar, scr, ybar,
        ybar_steps);
  return (int)cudaGetLastError();
}

// The kernel-mode sweep as one team for the batch: NT = 3
// (cf_ode_replay_bwd_team, B8t-team) or 2 (cf_ode_replay_bwd_split2, B8s);
// lo, loT unused at NT = 2; work: NT P^2 + n_in P floats.
template <int NT>
int replay_bwd_team(int B, int P, int n_in, int K, const float* hc, int n_steps,
                    const float* bg, const float* adapt, const void* hi, const void* mid,
                    const void* lo, const void* hiT, const void* midT, const void* loT,
                    const float* iw, const float* kv, const float* st, const float* ys,
                    const float* cobar, float* scr, float* ybar, float* d_wT, float* d_iwT,
                    float* work, void* stream) {
  if (int e = check_shape(P, n_in, K)) return e;
  if (P % kCluster || B < 1) return (int)cudaErrorInvalidValue;
  const size_t team = team_smem(P, B, NT, NT == 3 ? 6 : 3, 1);
  const size_t bytes = team + 2 * wx_bytes(P, B);
  if (int e = set_smem(ode_replay_bwd_team_kernel<NT>, bytes)) return e;
  const Wg w{(const bf16*)hi, (const bf16*)mid, NT == 3 ? (const bf16*)lo : nullptr,
             (const bf16*)hiT, (const bf16*)midT, NT == 3 ? (const bf16*)loT : nullptr, iw};
  ode_replay_bwd_team_kernel<NT><<<kCluster, kThreads, bytes, (cudaStream_t)stream>>>(
      make_net(B, P, n_in, K, hc, bg, adapt, kv), n_steps, w, (int)team, st, ys, cobar, scr,
      ybar, d_wT, d_iwT, work);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cf_ode_replay_fwd(int B, int P, int n_in, int K, const float* hc, int n_steps,
                      const float* bg, const float* adapt, const float* wT, const float* iwT,
                      const float* kv, const float* st, const float* y0, float* ys,
                      float* coeffs, void* stream) {
  const size_t bytes = block_bytes(1, P, n_in, 0);
  if (int e = prepare(ode_replay_fwd_kernel, P, n_in, K, bytes)) return e;
  if (B > 0)
    ode_replay_fwd_kernel<<<B, kThreads, bytes, (cudaStream_t)stream>>>(
        make_net(B, P, n_in, K, hc, bg, adapt, kv), n_steps, wT, iwT, st, y0, ys, coeffs);
  return (int)cudaGetLastError();
}

int cf_ode_replay_bwd(int B, int P, int n_in, int K, const float* hc, int n_steps,
                      const float* bg, const float* adapt, const float* wT, const float* iwT,
                      const float* kv, const float* st, const float* ys, const float* cobar,
                      float* ybar, float* d_wT, float* d_iwT, float* work, void* stream) {
  const size_t bytes = block_bytes(B, P, n_in, 1);
  if (int e = prepare(ode_replay_bwd_kernel, P, n_in, K, bytes)) return e;
  ode_replay_bwd_kernel<<<1, kThreads, bytes, (cudaStream_t)stream>>>(
      make_net(B, P, n_in, K, hc, bg, adapt, kv), n_steps, wT, iwT, st, ys, cobar, ybar, d_wT,
      d_iwT, work);
  return (int)cudaGetLastError();
}

// The shared memory cf_ode_replay_fwd (sweep 0) or cf_ode_replay_bwd (sweep
// 1) asks of one block at (B, P, n_in), into *bytes: the count that
// ode_fwd_route and ode_bwd_route (network_ode.py) hold against a block's
// limit.
int cf_ode_block_bytes(int B, int P, int n_in, int sweep, long long* bytes) {
  *bytes = (long long)block_bytes(B, P, n_in, sweep);
  return 0;
}

// The team kernels. hi/mid/lo: bf16 (P, P) terms of wT (lo: the three-term
// split only); hiT/midT/loT their transposes; iw float32 (n_in, P); scr:
// global scratch for the state vectors (10 B 3P floats; 16 B 3P for the
// reverse sweeps).
// hc (host): tau_s, tau_m, tau_a, R, sigma, kc0[K-1], kd[K-1];
// hs (host): t_start, t_end, rtol, atol, dt0, t_end - t_start.
int cf_ode_select_team8(int B, int P, int n_in, int K, const float* hc, const float* hs,
                     int use_initial, int max_steps, const float* bg, const float* adapt,
                     const void* hi, const void* mid, const void* lo, const float* iw,
                     const float* kv, const float* y0, float* scr, float* st, int* stats,
                     void* stream) {
  size_t bytes;
  if (int e = team_prepare(ode_select_kernel, P, n_in, K, B, 3, 6, kSelLanes, &bytes)) return e;
  const Wg w{(const bf16*)hi, (const bf16*)mid, (const bf16*)lo, nullptr, nullptr, nullptr, iw};
  ode_select_kernel<<<kCluster, kThreads, bytes, (cudaStream_t)stream>>>(
      make_net(B, P, n_in, K, hc, bg, adapt, kv), make_sel(hs, use_initial, max_steps), w, y0,
      scr, st, stats);
  return (int)cudaGetLastError();
}

int cf_ode_attempt_team8(int B, int P, int n_in, int K, const float* hc, const float* hs,
                      const float* bg, const float* adapt, const void* hi, const void* mid,
                      const void* lo, const float* iw, const float* kv, const float* t,
                      const float* h, const float* y, const float* f0, float* scr, float* y1,
                      float* f1, float* rec, void* stream) {
  size_t bytes;
  if (int e = team_prepare(ode_attempt_kernel, P, n_in, K, B, 3, 6, kSelLanes, &bytes)) return e;
  const Wg w{(const bf16*)hi, (const bf16*)mid, (const bf16*)lo, nullptr, nullptr, nullptr, iw};
  ode_attempt_kernel<<<kCluster, kThreads, bytes, (cudaStream_t)stream>>>(
      make_net(B, P, n_in, K, hc, bg, adapt, kv), make_sel(hs, 0, 0), w, t, h, y, f0, scr, y1,
      f1, rec);
  return (int)cudaGetLastError();
}

int cf_ode_replay_fwd_split2_team8(int B, int P, int n_in, int K, const float* hc, int n_steps,
                                   const float* bg, const float* adapt, const void* hi,
                                   const void* mid, const float* iw, const float* kv,
                                   const float* st, const float* y0, float* scr, float* ys,
                                   float* coeffs, void* stream) {
  return replay_fwd_team<2>(B, P, n_in, K, hc, n_steps, bg, adapt, hi, mid, nullptr, iw, kv, st,
                            y0, scr, ys, coeffs, stream);
}

int cf_ode_replay_bwd_emit_team8(int B, int P, int n_in, int K, const float* hc, int n_steps,
                           const float* bg, const float* adapt, const void* hi, const void* mid,
                           const void* hiT, const void* midT, const float* iw, const float* kv,
                           const float* st, const float* ys, const float* cobar, float* scr,
                           float* ybar, float* ybar_steps, void* stream) {
  return replay_bwd_emit<2>(B, P, n_in, K, hc, n_steps, bg, adapt, hi, mid, nullptr, hiT, midT,
                            nullptr, iw, kv, st, ys, cobar, scr, ybar, ybar_steps, stream);
}

// The f32-exact engine's team kernels, on the three-term split
// (prepare_premixed_split); work (B8t-team): 3 P^2 + n_in P floats, the
// step's accumulators. P must be a multiple of 8.
int cf_ode_replay_fwd_team_team8(int B, int P, int n_in, int K, const float* hc, int n_steps,
                                 const float* bg, const float* adapt, const void* hi,
                                 const void* mid, const void* lo, const float* iw,
                                 const float* kv, const float* st, const float* y0, float* scr,
                                 float* ys, float* coeffs, void* stream) {
  return replay_fwd_team<3>(B, P, n_in, K, hc, n_steps, bg, adapt, hi, mid, lo, iw, kv, st, y0,
                            scr, ys, coeffs, stream);
}

int cf_ode_replay_bwd_emit_split3_team8(int B, int P, int n_in, int K, const float* hc,
                                  int n_steps,
                                  const float* bg, const float* adapt, const void* hi,
                                  const void* mid, const void* lo, const void* hiT,
                                  const void* midT, const void* loT, const float* iw,
                                  const float* kv, const float* st, const float* ys,
                                  const float* cobar, float* scr, float* ybar, float* ybar_steps,
                                  void* stream) {
  return replay_bwd_emit<3>(B, P, n_in, K, hc, n_steps, bg, adapt, hi, mid, lo, hiT, midT, loT,
                            iw, kv, st, ys, cobar, scr, ybar, ybar_steps, stream);
}

int cf_ode_replay_bwd_team(int B, int P, int n_in, int K, const float* hc, int n_steps,
                           const float* bg, const float* adapt, const void* hi, const void* mid,
                           const void* lo, const void* hiT, const void* midT, const void* loT,
                           const float* iw, const float* kv, const float* st, const float* ys,
                           const float* cobar, float* scr, float* ybar, float* d_wT,
                           float* d_iwT, float* work, void* stream) {
  return replay_bwd_team<3>(B, P, n_in, K, hc, n_steps, bg, adapt, hi, mid, lo, hiT, midT, loT,
                            iw, kv, st, ys, cobar, scr, ybar, d_wT, d_iwT, work, stream);
}

// B8s: the split2 tier's kernel-mode sweep, on the two-term split
// (prepare_premixed_split2); hi, mid and their transposes; work: 2 P^2 +
// n_in P floats. P must be a multiple of 8.
int cf_ode_replay_bwd_split2(int B, int P, int n_in, int K, const float* hc, int n_steps,
                             const float* bg, const float* adapt, const void* hi,
                             const void* mid, const void* hiT, const void* midT, const float* iw,
                             const float* kv, const float* st, const float* ys,
                             const float* cobar, float* scr, float* ybar, float* d_wT,
                             float* d_iwT, float* work, void* stream) {
  return replay_bwd_team<2>(B, P, n_in, K, hc, n_steps, bg, adapt, hi, mid, nullptr, hiT, midT,
                            nullptr, iw, kv, st, ys, cobar, scr, ybar, d_wT, d_iwT, work, stream);
}

}  // extern "C"
