// B7t-team and B7 split2, the column network's dopri5 replay over the frozen
// grid on the three- and two-term splits, as Hopper cluster teams, one per
// lane (ode_team.cuh ode_replay16_kernel).
//   cf_ode_replay_fwd_team      <- columnflow/solvers/fused.py
//                                  _make_replay_chunk_kernel with
//                                  prepare_premixed_split (B7t-team)
//   cf_ode_replay_fwd_split2    <- the same with prepare_premixed_split2
//                                  (B7 split2)
//   cf_ode_replay_max_clusters  how many of the kernel's clusters the card
//                               holds at once (what picks the cluster size)
// Plain C entry points, loaded with ctypes by
// columnflow_torch/kernels/_build.py; each returns cudaGetLastError().
// Precision and design: ode_team.cuh.

#include "dopri5.cuh"
#include "ode_team.cuh"

namespace {

// The kernel instance of a plan: streamed or resident, the float32 slice
// (three terms only) or the bf16 terms.
template <int NT, class F>
int replay16_instance(const Plan3& p, F&& f) {
  if constexpr (NT == 3) {
    if (p.f32)
      return p.stream ? f(ode_replay16_kernel<3, true, true>)
                      : f(ode_replay16_kernel<3, false, true>);
  }
  return p.stream ? f(ode_replay16_kernel<NT, true, false>)
                  : f(ode_replay16_kernel<NT, false, false>);
}

template <int NT>
int replay16(int B, int P, int n_in, int K, const float* hc, int n_steps, int C, int stream,
             const float* bg, const float* adapt, const void* wpk, const float* iw,
             const float* kv, const float* st, const float* y0, float* ys, float* coeffs,
             void* cstream) {
  Plan3 p;
  if (int e = team3_plan(B, P, n_in, K, 1, NT, kT3Replay, stream, &p, C)) return e;
  const Net n = make_net(B, P, n_in, K, hc, bg, adapt, kv);
  const uint32_t* w = (const uint32_t*)wpk;
  const cudaStream_t s = (cudaStream_t)cstream;
  return replay16_instance<NT>(p, [&](auto kernel) {
    return team2_launch(kernel, p, B, s, n, p.C, n_steps, w, iw, st, y0, ys, coeffs);
  });
}

}  // namespace

extern "C" {

// B7t-team (three terms) and B7 split2 (two terms) as a cluster team of C
// blocks per lane (C 16 or 8, dividing P). wpk: the split's columns packed
// per block (ode_team_pack in kernels/network_ode.py: (C, P, rw) 32-bit
// words, the replay plan's layout), or where the plan says f32 the float32
// wT's (ode_replay_pack); iw float32 (n_in, P); stream: 1 streams
// the slices through the ring even where they fit; st (n_steps + 1) the
// frozen grid, y0 (B, 3P); ys (n_steps, B, 3P) the step-start states,
// coeffs (n_steps, 5, B, 3P) the dense rows. hc as cf_ode_select_team8.
int cf_ode_replay_fwd_team(int B, int P, int n_in, int K, const float* hc, int n_steps, int C,
                           int stream, const float* bg, const float* adapt, const void* wpk,
                           const float* iw, const float* kv, const float* st, const float* y0,
                           float* ys, float* coeffs, void* cstream) {
  return replay16<3>(B, P, n_in, K, hc, n_steps, C, stream, bg, adapt, wpk, iw, kv, st, y0, ys,
                     coeffs, cstream);
}

int cf_ode_replay_fwd_split2(int B, int P, int n_in, int K, const float* hc, int n_steps, int C,
                             int stream, const float* bg, const float* adapt, const void* wpk,
                             const float* iw, const float* kv, const float* st, const float* y0,
                             float* ys, float* coeffs, void* cstream) {
  return replay16<2>(B, P, n_in, K, hc, n_steps, C, stream, bg, adapt, wpk, iw, kv, st, y0, ys,
                     coeffs, cstream);
}

// cudaOccupancyMaxActiveClusters of the replay's kernel on NT terms with
// clusters of C blocks (streamed or resident as the plan holds the slice):
// how many lanes' teams run at once.
int cf_ode_replay_max_clusters(int P, int n_in, int NT, int C, int stream, int* out) {
  Plan3 p;
  if (NT < 2 || NT > 3) return (int)cudaErrorInvalidValue;
  if (int e = team3_plan(1, P, n_in, 1, 1, NT, kT3Replay, stream, &p, C)) return e;
  const auto clusters = [&](auto kernel) { return team2_max_clusters(kernel, p, out); };
  return NT == 3 ? replay16_instance<3>(p, clusters) : replay16_instance<2>(p, clusters);
}

}  // extern "C"
