// The bf16 accumulators of a kernel-mode sweep's weight cotangents: each
// drift VJP's product cotangents added to a step's NT accumulators in the
// order the reverse pass meets the forward's products, and their fold
// through the split once a step. What the team headers share (team.cuh:
// B8t-team, B8s, B4't-team; ode_team.cuh: the kernel-mode sweep's cluster
// team). Included once per source; every source is its own library, so the
// definitions live in an unnamed namespace.

#pragma once

#include "network_drift.cuh"

namespace {

// Add one drift VJP's product cotangents d (team.cuh wx_cot, ode_team.cuh
// t3k_vjp) to the bf16 accumulators acc[0..NT) (hi, mid[, lo]) in the order
// the reverse pass meets the forward's products (models/network.py
// split3_accumulate / split2_accumulate); ``first`` opens them.
template <int NT>
__device__ __forceinline__ void acc_add(float* acc, const float* d, bool first) {
  if constexpr (NT == 3) {
    const float a = d[0], bb = d[1], ee = d[2];
    if (first) {
      acc[1] = bf16r(a + bb);
      acc[0] = bf16r(acc[1] + ee);
      acc[2] = a;
    } else {
      acc[0] = bf16r(bf16r(bf16r(acc[0] + a) + bb) + ee);
      acc[1] = bf16r(bf16r(acc[1] + a) + bb);
      acc[2] = bf16r(acc[2] + a);
    }
  } else {
    const float a = d[0], bb = d[1];
    if (first) {
      acc[0] = bf16r(bb + a);
      acc[1] = a;
    } else {
      acc[0] = bf16r(bf16r(acc[0] + bb) + a);
      acc[1] = bf16r(acc[1] + a);
    }
  }
}

// The cotangent of w from those of its NT terms, once per prepare
// (split3_fold / split2_fold).
template <int NT>
__device__ __forceinline__ float acc_fold(const float* acc) {
  if constexpr (NT == 3) {
    const float r = acc[2] + bf16r(acc[1] - acc[2]);
    return r + bf16r(acc[0] + bf16r(-r));
  } else {
    return acc[1] + bf16r(acc[0] - acc[1]);
  }
}

}  // namespace
