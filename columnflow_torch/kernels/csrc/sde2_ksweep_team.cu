// B4s, the column network's kernel-mode reverse sweep of the SRA1 replay on
// the two-term split (--split2 without --grad-bf16 through 63 columns, the
// split2 stochastic-adaptive step), as one Hopper cluster team for the batch
// (ode_team.cuh sde3_ksweep16_kernel<2, *, *>, the same kernel as B4't's on
// three terms, sde3_ksweep_team.cu; a source of its own so that nvcc builds
// the two in parallel and neither's instances change the other's
// registers).
//   cf_sde2_bwd_ksweep  <- columnflow/solvers/fused.py
//                          _make_sde_bwd_chunk_kernel (kernel mode) with
//                          prepare_premixed_split2: the state cotangent ybar
//                          and the weight cotangents d wT, d iwT, each lane
//                          on its own grid
// Plain C entry point, loaded with ctypes by
// columnflow_torch/kernels/_build.py; it returns cudaGetLastError().
//
// What bounds it on this card: the serial chain of half steps (~5.2 * 10^3
// over the second at 32 columns on the f32 selection's grids), each one
// drift evaluation, two drift VJPs and two weight-cotangent passes of the
// batch, every one a (B, P) x (P, P) product on each of the two terms: a
// few MFLOP whose latency is what costs. The kernel it replaces
// (network_sde.cu sde3_bwd_team_kernel<2>, cf_sde2_bwd, kept as the
// yardstick behind route "team") ran the batch on a team of 8 blocks that
// read the two terms and their transposes from L2 in every product and kept
// the step's accumulators and a (7, B, 3P) scratch in device memory.
//
// Design: sde3_ksweep_team.cu's, on two terms. Each block keeps its columns
// of the two bf16 terms in shared memory (ode_team_pack at NT = 2); a drift
// forms three products (x_hi W_hi, x_hi W_mid, x_mid W_hi) in the replay's
// chunk order, as step_vjp_split2's drift_premixed does; a VJP sends each
// row's two partial sums to its owner and the rates' two bf16 terms to every
// block; each block contracts the weight-cotangent entries of its own
// columns over the lanes in float64, in lane order, rounds them to bf16 and
// adds them into the step's two accumulators (acc_add<2>), folded once a
// step (acc_fold<2>, split2_fold's chain) into the chunk partial, which is
// added to d wT at each chunk's first step.

#include "ode_team.cuh"

extern "C" {

// B4s as one cluster team for the batch of B lanes: wpk the two bf16 terms
// of the split2 weights packed per block (ode_team_pack), work (C, 4, P /
// C, P) floats where the plan keeps the accumulators in device memory; the
// arguments as ode_team.cuh sde_ksweep_launch's.
int cf_sde2_bwd_ksweep(int B, int P, int n_in, int K, const float* hc, int n_steps,
                       int n_real, int lanes, int stride, int chunk, int stream,
                       const float* bg, const float* adapt, const void* wpk, const float* iw,
                       const float* kv, const float* t0s, const float* hs, const float* i10,
                       const float* ys_prev, const float* ysbar, float* ybar, float* d_wT,
                       float* d_iwT, float* work, void* cstream) {
  return sde_ksweep_launch<2>(B, P, n_in, K, hc, n_steps, n_real, lanes, stride, chunk, stream,
                              bg, adapt, wpk, iw, kv, t0s, hs, i10, ys_prev, ysbar, ybar, d_wT,
                              d_iwT, work, cstream);
}

}  // extern "C"
