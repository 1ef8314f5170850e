// B8 and B8t-team, the column network's kernel-mode dopri5 reverse sweep on
// the three-term split, as one Hopper cluster team for the batch
// (ode_team.cuh ode_ksweep16_kernel).
//   cf_ode_replay_bwd_ksweep  <- columnflow/solvers/fused.py
//                                _make_bwd_chunk_kernel (kernel mode) with
//                                prepare_premixed_split: the state cotangent
//                                ybar0 and the weight cotangents d wT, d iwT
// Plain C entry points, loaded with ctypes by
// columnflow_torch/kernels/_build.py; each returns cudaGetLastError().
//
// What bounds it on this card: the serial chain of accepted steps (~1.8 *
// 10^3 at 13 columns, ~2.4 * 10^3 at 32 over the second), each six drift
// evaluations, seven drift VJPs and seven weight-cotangent passes of the
// batch, every one a (B, P) x (P, P) product on each term of the split: a
// few MFLOP whose latency is what costs. The kernels it replaces on the
// main paths (network_ode.cu, kept as yardsticks: cf_ode_replay_bwd, route
// "block", and cf_ode_replay_bwd_team, route "team8") ran the batch on ONE
// block (B8: one of 132 SMs, a block barrier between elementwise passes,
// the step's three accumulators in device memory) or on a team of 8 blocks
// that read the three terms and their transposes from L2 in every product
// and kept the sixteen state vectors and the accumulators in device memory
// (B8t-team).
//
// Design (ode_team.cuh plan3k): jax.vjp contracts each product's weight
// cotangent over the batch before it rounds it to bf16, so the lanes cannot
// run as teams of their own (the emit-mode sweeps B8' and B8't do): the
// batch is one cluster of C blocks (16 where 16 divides P, else 8), block r
// owning the populations [r nc, (r+1) nc) of every lane, their states in
// registers (one item a thread), and the columns [r nc, (r+1) nc) of the
// three bf16 terms in shared memory (copied by TMA: resident where the plan
// fits, else streamed through tma_ring.cuh's ring). A drift sums its
// products in the replay's order (t3_chunks), so the stage states equal
// B7's, B7t-team's and team8's; a VJP sends each row's partial sums over the
// block's columns to the row's owner, who adds the C partials in rank order
// (t3_vjp's pattern), and in the same exchange the owners put their rates'
// three bf16 terms into every block; block r then forms the weight-
// cotangent entries of its own columns j, every row i, over the lanes in
// float64 in lane order, rounds them to bf16 and adds them into the step's
// accumulators (shared memory where the plan fits, else device memory),
// folds them once a step and writes d wT and d iwT once at the end. No value
// crosses a block in a sum, so the weight cotangents are the plain
// version's bit for bit wherever the state cotangents are.

#include "dopri5.cuh"
#include "ode_team.cuh"

namespace {

template <int LT, class F>
int ksweep_instance(const Plan3& p, F&& f) {
  return p.stream ? f(ode_ksweep16_kernel<3, LT, true>) : f(ode_ksweep16_kernel<3, LT, false>);
}

}  // namespace

extern "C" {

// The kernel-mode sweep as one cluster team for the batch of B lanes
// (ode_team.cuh plan3k, kT3KSweep). wpk: the three bf16 terms of wT packed
// per block (ode_team_pack in kernels/network_ode.py: (C, P, rw) 32-bit
// words of the plan's layout); iw float32 (n_in, P); stream: 1 streams the
// slices through the ring even where they fit; st (n + 1,); ys (n, B, 3P);
// cobar (n, 5, B, 3P); ybar (B, 3P); d_wT (P, P); d_iwT (n_in, P); work:
// (C, 4, P / C, P) floats where the plan keeps the accumulators in device
// memory (else unused). hc as cf_ode_replay_bwd's.
int cf_ode_replay_bwd_ksweep(int B, int P, int n_in, int K, const float* hc, int n_steps,
                             int stream, const float* bg, const float* adapt, const void* wpk,
                             const float* iw, const float* kv, const float* st, const float* ys,
                             const float* cobar, float* ybar, float* d_wT, float* d_iwT,
                             float* work, void* cstream) {
  Plan3 p;
  if (int e = team3_plan(B, P, n_in, K, B, 3, kT3KSweep, stream, &p)) return e;
  if (n_steps < 0 || (!p.accs && work == nullptr)) return (int)cudaErrorInvalidValue;
  const Net n = make_net(B, P, n_in, K, hc, bg, adapt, kv);
  const uint32_t* w = (const uint32_t*)wpk;
  const cudaStream_t s = (cudaStream_t)cstream;
  const auto launch = [&](auto kernel) {
    return team2_launch(kernel, p, 1, s, n, p, n_steps, w, iw, st, ys, cobar, ybar, d_wT,
                        d_iwT, work);
  };
  return p.LB == 1 ? ksweep_instance<1>(p, launch) : ksweep_instance<4>(p, launch);
}

}  // extern "C"
