// B6, the column network's dopri5 step-size selection, as one Hopper
// cluster team for the batch (ode_team.cuh), and its one-attempt test entry.
//   cf_ode_select    <- columnflow/solvers/fused.py _make_adaptive_kernel:
//                       Hairer's initial step, the whole accept/reject
//                       while-loop, the accepted times, on the three-term
//                       split (the f32-exact engine's drift, and the split2
//                       tier's select_func)
//   cf_ode_attempt   <- the same body, one controller attempt
//   cf_ode_team_plan the teams' plan (plan3: the selection's, the sweeps'
//                       and the replay's), for the wrapper's to be held
//                       against
// Plain C entry points, loaded with ctypes by
// columnflow_torch/kernels/_build.py; each returns cudaGetLastError().
// Precision and design: ode_team.cuh.

#include "dopri5.cuh"
#include "ode_team.cuh"

namespace {

template <int IPT>
int select16(const Plan3& p, cudaStream_t s, Net n, Sel sel, const uint32_t* w, const float* iw,
             const float* y0, float* st, int* stats) {
  return p.stream ? team2_launch(ode_select16_kernel<IPT, true>, p, 1, s, n, sel, w, iw, y0, st,
                                 stats)
                  : team2_launch(ode_select16_kernel<IPT, false>, p, 1, s, n, sel, w, iw, y0, st,
                                 stats);
}

template <int IPT>
int attempt16(const Plan3& p, cudaStream_t s, Net n, Sel sel, const uint32_t* w, const float* iw,
              const float* t, const float* h, const float* y, const float* f0, float* y1,
              float* f1, float* rec) {
  return p.stream ? team2_launch(ode_attempt16_kernel<IPT, true>, p, 1, s, n, sel, w, iw, t, h, y,
                                 f0, y1, f1, rec)
                  : team2_launch(ode_attempt16_kernel<IPT, false>, p, 1, s, n, sel, w, iw, t, h,
                                 y, f0, y1, f1, rec);
}

}  // namespace

extern "C" {

// B6 as one cluster team (ode_team.cuh). wpk: the three-term split's
// columns packed per block as float64 high words (ode_team_pack in
// kernels/network_ode.py: (C, P, rw) 32-bit words, the plan's layout); iw
// float32 (n_in, P); stream: 1 streams the slices through the ring even
// where they fit. hc, hs as cf_ode_select_team8.
int cf_ode_select(int B, int P, int n_in, int K, const float* hc, const float* hs,
                  int use_initial, int max_steps, int stream, const float* bg,
                  const float* adapt, const void* wpk, const float* iw, const float* kv,
                  const float* y0, float* st, int* stats, void* cstream) {
  Plan3 p;
  if (int e = team3_plan(B, P, n_in, K, B, 3, kT3Select, stream, &p)) return e;
  const Net n = make_net(B, P, n_in, K, hc, bg, adapt, kv);
  const Sel sel = make_sel(hs, use_initial, max_steps);
  const uint32_t* w = (const uint32_t*)wpk;
  const cudaStream_t s = (cudaStream_t)cstream;
  return p.ipt == 1 ? select16<1>(p, s, n, sel, w, iw, y0, st, stats)
                    : select16<2>(p, s, n, sel, w, iw, y0, st, stats);
}

int cf_ode_attempt(int B, int P, int n_in, int K, const float* hc, const float* hs, int stream,
                   const float* bg, const float* adapt, const void* wpk, const float* iw,
                   const float* kv, const float* t, const float* h, const float* y,
                   const float* f0, float* y1, float* f1, float* rec, void* cstream) {
  Plan3 p;
  if (int e = team3_plan(B, P, n_in, K, B, 3, kT3Select, stream, &p)) return e;
  const Net n = make_net(B, P, n_in, K, hc, bg, adapt, kv);
  const Sel sel = make_sel(hs, 0, 0);
  const uint32_t* w = (const uint32_t*)wpk;
  const cudaStream_t s = (cudaStream_t)cstream;
  return p.ipt == 1 ? attempt16<1>(p, s, n, sel, w, iw, t, h, y, f0, y1, f1, rec)
                    : attempt16<2>(p, s, n, sel, w, iw, t, h, y, f0, y1, f1, rec);
}

// The team plan (Plan3, in order: C, nc, NT, NB, LB, G, gw, xs, L, Lv, rw,
// ipt, slots, stream, R, T, S, fits, slot bytes, fixed bytes, bytes, f32,
// accs) of the selection (use kT3Select: NB lanes, three terms), the sweep
// (kT3Sweep: one lane, NT terms), the replay (kT3Replay: one lane, NT
// terms), the SDE sweep (kT3SdeSweep: one lane, three terms) or the
// kernel-mode sweeps (kT3KSweep, the dopri5 sweep, and kT3SdeKSweep, the
// SDE's: NB lanes, NT terms; C must be 0) at P with clusters of C blocks (0:
// the default, 16 where 16 divides P, else 8), for the wrapper's own
// reckoning to be held against.
int cf_ode_team_plan(int P, int n_in, int NB, int NT, int use, int C, int stream,
                     long long* out) {
  if (P <= 0 || P % 8 || n_in < 0 || n_in > kMaxInputs || NB < 1 || NT < 2 || NT > 3 ||
      use < kT3Select || use > kT3SdeKSweep || (C != 0 && C != 8 && C != 16) ||
      (C && P % C) || (C && t3_ksweep(use)))
    return (int)cudaErrorInvalidValue;
  const Plan3 p = plan3(P, n_in, NB, NT, use, stream, C);
  const long long v[23] = {p.C, p.nc, p.NT, p.NB, p.LB, p.G, p.gw, p.xs, p.L, p.Lv, p.rw,
                           p.ipt, p.slots, p.stream, p.R, p.T, p.S, p.fits,
                           (long long)p.slot, (long long)p.fixed, (long long)p.bytes, p.f32,
                           p.accs};
  for (int j = 0; j < 23; ++j) out[j] = v[j];
  return 0;
}

}  // extern "C"
