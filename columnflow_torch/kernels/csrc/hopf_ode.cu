// The Hopf MLP dopri5 kernels of the kernel-mode path at the reference hidden
// width, 100 (B6h, B7h, B8h): the templates of hopf_mlp.cuh at H = 100, with
// every weight and activation in shared memory. The outer mode's kernels are
// hopf_outer.cu (a library of their own, so that nvcc builds the two in
// parallel). Plain C entry points, loaded with ctypes by
// columnflow_torch/kernels/_build.py; each returns cudaGetLastError().

#include "hopf_mlp.cuh"

namespace {
constexpr int kH = 100;
}  // namespace

extern "C" {

// params: the packed MLP; mu: (T, B); hc (host): t0, dt of the mu table's
// grid; hs (host): t_start, t_end, rtol, atol, dt0, t_end - t_start.
int cf_hopf_select(int B, int T, const float* hc, const float* hs, int use_initial, int max_steps,
                   const float* params, const float* mu, const float* y0, float* st, int* stats,
                   void* stream) {
  return select_h<kH>(B, T, hc, hs, use_initial, max_steps, params, nullptr, nullptr, mu, y0, st,
                      stats, stream);
}

int cf_hopf_attempt(int B, int T, const float* hc, const float* hs, const float* params,
                    const float* mu, const float* t, const float* h, const float* y,
                    const float* f0, float* y1, float* f1, float* rec, void* stream) {
  return attempt_h<kH>(B, T, hc, hs, params, nullptr, nullptr, mu, t, h, y, f0, y1, f1, rec,
                       stream);
}

int cf_hopf_replay_fwd(int B, int T, const float* hc, int n_steps, const float* params,
                       const float* mu, const float* st, const float* y0, float* ys,
                       float* coeffs, void* stream) {
  return replay_fwd_h<kH>(B, T, hc, n_steps, params, nullptr, nullptr, mu, st, y0, ys, coeffs,
                          stream);
}

int cf_hopf_replay_bwd(int B, int T, const float* hc, int n_steps, const float* params,
                       const float* mu, const float* st, const float* ys, const float* cobar,
                       float* ybar, float* dparams, float* work, void* stream) {
  return replay_bwd_h<kH, false>(B, T, hc, n_steps, params, nullptr, nullptr, mu, st, ys, cobar,
                                 ybar, nullptr, dparams, work, stream);
}

}  // extern "C"
