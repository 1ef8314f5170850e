// The block-wide float64 sum of the kernels that reduce over a whole block
// (network_drift.cuh for the column network, dopri5.cuh for the dopri5
// error norm). Included once per source; every source is its own library,
// so the definition lives in an unnamed namespace.

#pragma once

#include <cuda_runtime.h>

namespace {

// Block-wide sum of v over the block, in float64, in a fixed order: each
// warp's values by shuffles, then the warps' sums in warp order. red holds
// blockDim.x / 32 doubles; every thread of the block calls it.
__device__ double block_sum(double v, double* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double total = 0.0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += red[w];
  __syncthreads();
  return total;
}

}  // namespace
