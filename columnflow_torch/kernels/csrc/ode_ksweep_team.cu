// B8 and B8t-team, the column network's kernel-mode dopri5 reverse sweep on
// the three-term split, as one Hopper cluster team for the batch
// (ode_team.cuh ode_ksweep16_kernel; its two-term instances, B8s, are built
// from ode_ksweep2_team.cu).
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

extern "C" {

// The kernel-mode sweep as one cluster team for the batch of B lanes
// (ode_team.cuh plan3k, kT3KSweep, ode_ksweep_launch): wpk the three bf16
// terms of wT packed per block; the arguments as ode_ksweep_launch's, hc as
// cf_ode_replay_bwd's.
int cf_ode_replay_bwd_ksweep(int B, int P, int n_in, int K, const float* hc, int n_steps,
                             int stream, const float* bg, const float* adapt, const void* wpk,
                             const float* iw, const float* kv, const float* st, const float* ys,
                             const float* cobar, float* ybar, float* d_wT, float* d_iwT,
                             float* work, void* cstream) {
  return ode_ksweep_launch<3>(B, P, n_in, K, hc, n_steps, stream, bg, adapt, wpk, iw, kv, st,
                              ys, cobar, ybar, d_wT, d_iwT, work, cstream);
}

}  // extern "C"
