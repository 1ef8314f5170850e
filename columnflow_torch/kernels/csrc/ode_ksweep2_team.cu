// B8s, the column network's kernel-mode dopri5 reverse sweep on the two-term
// split (the fused-split2 tier in kernel mode, --engine fused-split2 through
// 63 columns), as one Hopper cluster team for the batch (ode_team.cuh
// ode_ksweep16_kernel<2, *, *>, the same kernel as B8 and B8t-team's on
// three terms, ode_ksweep_team.cu; a source of its own so that nvcc builds
// the two in parallel).
//   cf_ode_replay_bwd_split2_ksweep <- columnflow/solvers/fused.py
//                                      _make_bwd_chunk_kernel (kernel mode)
//                                      with prepare_premixed_split2: the
//                                      state cotangent ybar0 and the weight
//                                      cotangents d wT, d iwT
// Plain C entry point, loaded with ctypes by
// columnflow_torch/kernels/_build.py; it returns cudaGetLastError().
//
// What bounds it on this card: the serial chain of accepted steps (~2.4 *
// 10^3 over the second at 32 columns), each six drift evaluations, seven
// drift VJPs and seven weight-cotangent passes of the batch, every one a
// (B, P) x (P, P) product on each of the two terms: a few MFLOP whose
// latency is what costs. The kernel it replaces (network_ode.cu
// ode_replay_bwd_team_kernel<2>, cf_ode_replay_bwd_split2, kept as the
// yardstick behind route "team8") ran the batch on a team of 8 blocks that
// read the two terms and their transposes from L2 in every product and kept
// the sixteen state vectors and the accumulators in device memory.
//
// Design: ode_ksweep_team.cu's, on two terms. Each block keeps its columns
// of the two bf16 terms in shared memory; a drift forms three products
// (x_hi W_hi, x_hi W_mid, x_mid W_hi) in the replay's chunk order; a VJP
// sends each row's two partial sums to its owner and the rates' two bf16
// terms to every block; each block contracts the weight-cotangent entries
// of its own columns over the lanes in float64, in lane order, rounds them
// to bf16 and adds them into the step's two accumulators (acc_add<2>),
// folded once a step (acc_fold<2>, split2_fold's chain).

#include "ode_team.cuh"

extern "C" {

// B8s as one cluster team for the batch of B lanes: wpk the two bf16 terms
// of the split2 weights packed per block (ode_team_pack), work (C, 3, P /
// C, P) floats where the plan keeps the accumulators in device memory; the
// arguments as ode_team.cuh ode_ksweep_launch's, hc as cf_ode_replay_bwd's.
int cf_ode_replay_bwd_split2_ksweep(int B, int P, int n_in, int K, const float* hc,
                                    int n_steps, int stream, const float* bg,
                                    const float* adapt, const void* wpk, const float* iw,
                                    const float* kv, const float* st, const float* ys,
                                    const float* cobar, float* ybar, float* d_wT,
                                    float* d_iwT, float* work, void* cstream) {
  return ode_ksweep_launch<2>(B, P, n_in, K, hc, n_steps, stream, bg, adapt, wpk, iw, kv, st,
                              ys, cobar, ybar, d_wT, d_iwT, work, cstream);
}

}  // extern "C"
