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
// kernel it replaces on the main paths (network_sde.cu sde3_bwd_kernel, kept
// as the yardstick: cf_sde3_bwd, route "block") ran the batch on ONE block,
// one SM of 132, with a block barrier between every elementwise pass and
// the step's three accumulators in device memory.
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

namespace {

template <int NT, int LT, class F>
int sde3_ksweep_instance(const Plan3& p, F&& f) {
  return p.stream ? f(sde3_ksweep16_kernel<NT, LT, true>)
                  : f(sde3_ksweep16_kernel<NT, LT, false>);
}

}  // namespace

extern "C" {

// B4't as one cluster team for the batch of B lanes (ode_team.cuh plan3k,
// kT3SdeKSweep). wpk: the three bf16 terms of wT packed per block
// (ode_team_pack in kernels/network_ode.py: (C, P, rw) 32-bit words of the
// plan's layout); iw float32 (n_in, P); n_steps the rows of the grid,
// n_real the steps swept (n_real - 1 .. 0); lanes: 1 takes t0s, hs (n, B),
// 0 the uniform grid's (n,); i10 (n, B); stride: the carry is zeroed after
// every step k with k % stride == 0 (0: never); chunk (>= 1): the steps
// whose weight cotangents add before the total; stream: 1 streams the
// slices through the ring even where they fit; ys_prev, ysbar (n, B, 3P);
// ybar (B, 3P); d_wT (P, P); d_iwT (n_in, P); work: (C, 5, P / C, P) floats
// where the plan keeps the accumulators in device memory (else unused); hc
// the drift's constants and sigma (network_drift.cuh make_net).
int cf_sde3_bwd_ksweep(int B, int P, int n_in, int K, const float* hc, int n_steps,
                       int n_real, int lanes, int stride, int chunk, int stream,
                       const float* bg, const float* adapt, const void* wpk, const float* iw,
                       const float* kv, const float* t0s, const float* hs, const float* i10,
                       const float* ys_prev, const float* ysbar, float* ybar, float* d_wT,
                       float* d_iwT, float* work, void* cstream) {
  Plan3 p;
  if (int e = team3_plan(B, P, n_in, K, B, 3, kT3SdeKSweep, stream, &p)) return e;
  if (n_real < 0 || n_real > n_steps || stride < 0 || chunk < 1 ||
      (!p.accs && work == nullptr))
    return (int)cudaErrorInvalidValue;
  const Net n = make_net(B, P, n_in, K, hc, bg, adapt, kv);
  const T3Grid g{n_real, lanes, t0s, hs, i10};
  const uint32_t* w = (const uint32_t*)wpk;
  const cudaStream_t s = (cudaStream_t)cstream;
  const auto launch = [&](auto kernel) {
    return team2_launch(kernel, p, 1, s, n, p, g, stride, chunk, w, iw, ys_prev, ysbar, ybar,
                        d_wT, d_iwT, work);
  };
  return p.LB == 1 ? sde3_ksweep_instance<3, 1>(p, launch)
                   : sde3_ksweep_instance<3, 4>(p, launch);
}

}  // extern "C"
