// The Hopf MLP dopri5 kernels of the outer mode (the templates of
// hopf_mlp.cuh): the emit-mode sweep B8ho at the reference width, 100, and at
// hidden width 512, where the MLP's 2.1 MB of parameters send the JAX
// package's arg_grads="auto" to outer mode, the whole path: B6h-wide,
// B7h-wide and B8ho-wide (entry points cf_hopf_wide_*). At 512 the weights
// stay in device memory (wt: w2^T then w3^T, (H, H) each, for the forward's
// coalesced reads) and the activations in a device-memory scratch
// (kernels/hopf_ode.py _wide_args: B (3 + 3 H) float64 values, and 2 B H more
// for the sweep); the kernel-mode sweep at this width (B8hw) is not built.
// Plain C entry points, loaded with ctypes by
// columnflow_torch/kernels/_build.py; each returns cudaGetLastError().

#include "hopf_mlp.cuh"

namespace {
constexpr int kNarrow = 100, kH = 512;
}  // namespace

extern "C" {

int cf_hopf_replay_bwd_emit(int B, int T, const float* hc, int n_steps, const float* params,
                            const float* mu, const float* st, const float* ys,
                            const float* cobar, float* ybar, float* ybar_steps, void* stream) {
  return replay_bwd_h<kNarrow, true>(B, T, hc, n_steps, params, nullptr, nullptr, mu, st, ys,
                                     cobar, ybar, ybar_steps, nullptr, nullptr, stream);
}


int cf_hopf_wide_select(int B, int T, const float* hc, const float* hs, int use_initial,
                        int max_steps, const float* params, const float* wt, double* scratch,
                        const float* mu, const float* y0, float* st, int* stats, void* stream) {
  return select_h<kH>(B, T, hc, hs, use_initial, max_steps, params, wt, scratch, mu, y0, st,
                      stats, stream);
}

int cf_hopf_wide_attempt(int B, int T, const float* hc, const float* hs, const float* params,
                         const float* wt, double* scratch, const float* mu, const float* t,
                         const float* h, const float* y, const float* f0, float* y1, float* f1,
                         float* rec, void* stream) {
  return attempt_h<kH>(B, T, hc, hs, params, wt, scratch, mu, t, h, y, f0, y1, f1, rec, stream);
}

int cf_hopf_wide_replay_fwd(int B, int T, const float* hc, int n_steps, const float* params,
                            const float* wt, double* scratch, const float* mu, const float* st,
                            const float* y0, float* ys, float* coeffs, void* stream) {
  return replay_fwd_h<kH>(B, T, hc, n_steps, params, wt, scratch, mu, st, y0, ys, coeffs, stream);
}

int cf_hopf_wide_replay_bwd_emit(int B, int T, const float* hc, int n_steps, const float* params,
                                 const float* wt, double* scratch, const float* mu,
                                 const float* st, const float* ys, const float* cobar,
                                 float* ybar, float* ybar_steps, void* stream) {
  return replay_bwd_h<kH, true>(B, T, hc, n_steps, params, wt, scratch, mu, st, ys, cobar, ybar,
                                ybar_steps, nullptr, nullptr, stream);
}

}  // extern "C"
