// B8' and B8't, the column network's emit-mode dopri5 reverse sweeps on the
// two- and three-term splits, as Hopper cluster teams, one per lane
// (ode_team.cuh).
//   cf_ode_replay_bwd_emit         <- columnflow/solvers/fused.py
//                                     _make_bwd_chunk_kernel(emit_steps=True)
//                                     with prepare_premixed_split2 (B8')
//   cf_ode_replay_bwd_emit_split3  <- the same with prepare_premixed_split
//                                     (B8't)
// Plain C entry points, loaded with ctypes by
// columnflow_torch/kernels/_build.py; each returns cudaGetLastError().
// Precision and design: ode_team.cuh.

#include "dopri5.cuh"
#include "ode_team.cuh"

namespace {

template <int NT>
int emit16(int B, int P, int n_in, int K, const float* hc, int n_steps, int stream,
           const float* bg, const float* adapt, const void* wpk, const float* iw, const float* kv,
           const float* st, const float* ys, const float* cobar, float* ybar, float* ybar_steps,
           void* cstream) {
  Plan3 p;
  if (int e = team3_plan(B, P, n_in, K, 1, NT, 1, stream, &p)) return e;
  const Net n = make_net(B, P, n_in, K, hc, bg, adapt, kv);
  const uint32_t* w = (const uint32_t*)wpk;
  const cudaStream_t s = (cudaStream_t)cstream;
  return p.stream ? team2_launch(ode_emit16_kernel<NT, true>, p, B, s, n, n_steps, w, iw, st, ys,
                                 cobar, ybar, ybar_steps)
                  : team2_launch(ode_emit16_kernel<NT, false>, p, B, s, n, n_steps, w, iw, st,
                                 ys, cobar, ybar, ybar_steps);
}

}  // namespace

extern "C" {

// B8' (two terms) and B8't (three terms) as a cluster team per lane
// (ode_team.cuh); wpk, iw and stream as cf_ode_select, the rest as
// cf_ode_replay_bwd_emit_team8.
int cf_ode_replay_bwd_emit(int B, int P, int n_in, int K, const float* hc, int n_steps,
                           int stream, const float* bg, const float* adapt, const void* wpk,
                           const float* iw, const float* kv, const float* st, const float* ys,
                           const float* cobar, float* ybar, float* ybar_steps, void* cstream) {
  return emit16<2>(B, P, n_in, K, hc, n_steps, stream, bg, adapt, wpk, iw, kv, st, ys, cobar,
                   ybar, ybar_steps, cstream);
}

int cf_ode_replay_bwd_emit_split3(int B, int P, int n_in, int K, const float* hc, int n_steps,
                                  int stream, const float* bg, const float* adapt,
                                  const void* wpk, const float* iw, const float* kv,
                                  const float* st, const float* ys, const float* cobar,
                                  float* ybar, float* ybar_steps, void* cstream) {
  return emit16<3>(B, P, n_in, K, hc, n_steps, stream, bg, adapt, wpk, iw, kv, st, ys, cobar,
                   ybar, ybar_steps, cstream);
}

}  // extern "C"
