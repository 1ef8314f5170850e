// B4't, the column network's kernel-mode reverse sweep of the SRA1 replay on
// the three-term split, as one Hopper cluster team for the batch
// (ode_team.cuh sde3_ksweep16_kernel).
//   cf_sde3_bwd_ksweep  <- columnflow/solvers/fused.py
//                          _make_sde_bwd_chunk_kernel (kernel mode) with
//                          prepare_premixed_split: the state cotangent ybar
//                          and the weight cotangents d wT, d iwT, each
//                          lane on its own grid (lanes) or on the uniform one
// Plain C entry point, loaded with ctypes by
// columnflow_torch/kernels/_build.py; it returns cudaGetLastError().
//
// What bounds it on this card: the serial chain of half steps (~5.2 * 10^3
// over the second at 13 columns on the XLA selection's grids, 999 on the
// uniform grid), each one drift evaluation, two drift VJPs and two
// weight-cotangent passes of the batch, every one a (B, P) x (P, P) product
// on each term of the split: a few MFLOP whose latency is what costs. The
// kernels it replaces on the main paths, kept as the yardsticks, are
// network_sde.cu's sde3_bwd_kernel (cf_sde3_bwd, route "block"), which ran
// the batch on ONE block, one SM of 132, with a block barrier between every
// elementwise pass and the step's three accumulators in device memory, and
// past that block's capacity (from 20 columns at 4 lanes) its
// sde3_bwd_team_kernel<3> (cf_sde3_bwd_team, route "team"), one team of 8
// blocks that read the three terms and their transposes from L2 in every
// product.
//
// Design (ode_team.cuh plan3k, kT3SdeKSweep; the kernel-mode dopri5
// sweep's, ode_ksweep_team.cu, on the SRA1 step): jax.vjp contracts each
// product's weight cotangent over the batch before it rounds it to bf16, so
// the batch is one cluster of C blocks (16 where 16 divides P, else 8),
// block r owning the populations [r nc, (r+1) nc) of every lane, their
// states in registers (one item a thread), and the columns [r nc, (r+1) nc)
// of the split's terms in shared memory (copied by TMA: resident where the
// plan fits, else streamed). A half step is one drift (t3_drift, the
// replay's sum order, so f1 and h2 are B3t's) and two VJPs (t3k_vjp: each
// row's partial sums to its owner, the rates' terms to every block, then
// each block contracts the weight-cotangent entries of its own columns over
// the lanes in float64, in lane order); each lane's stimulus at its own
// time (the lanes' t0 and t0 + 0.75 h in shared memory); the step's
// accumulators fold once into the block's chunk partial, added to d wT at
// each chunk's first step (k % chunk == 0) as the JAX kernel's chunks add.
// No value crosses a block in a sum, so the weight cotangents are the plain
// version's bit for bit wherever the state cotangents are.

#include "ode_team.cuh"

extern "C" {

// B4't as one cluster team for the batch of B lanes (ode_team.cuh plan3k,
// kT3SdeKSweep): wpk the three bf16 terms of wT packed per block
// (ode_team_pack), work (C, 5, P / C, P) floats where the plan keeps the
// accumulators in device memory; the arguments as ode_team.cuh
// sde_ksweep_launch's.
int cf_sde3_bwd_ksweep(int B, int P, int n_in, int K, const float* hc, int n_steps,
                       int n_real, int lanes, int stride, int chunk, int stream,
                       const float* bg, const float* adapt, const void* wpk, const float* iw,
                       const float* kv, const float* t0s, const float* hs, const float* i10,
                       const float* ys_prev, const float* ysbar, float* ybar, float* d_wT,
                       float* d_iwT, float* work, void* cstream) {
  return sde_ksweep_launch<3>(B, P, n_in, K, hc, n_steps, n_real, lanes, stride, chunk, stream,
                              bg, adapt, wpk, iw, kv, t0s, hs, i10, ys_prev, ysbar, ybar, d_wT,
                              d_iwT, work, cstream);
}

}  // extern "C"
