// What the Hopper cluster teams share (replay2_team.cuh: B3 and B4;
// ode_team.cuh: B6, B8' and B8't; sde_select_team.cu: the SDE selection):
// mbarriers and TMA bulk copies (PTX), bf16 and float32 weights placed in a
// double without a conversion, the ring of tile stages through which a
// block's packed weight slice streams where it does not stay resident in
// shared memory, and the launch of a cluster of C blocks per team with
// cudaLaunchKernelEx (a cluster of 16 is non-portable). Included once per source; every source is its own library,
// so the definitions live in an unnamed namespace.
//
// The ring. A team's plan cuts a block's slice (P rows of rw 32-bit words)
// into T tiles of R rows; a product pass walks the T tiles in order. Tile
// sequence number g (tile g mod T) lands in stage g mod S: thread 0 starts
// the bulk copies of the first S tiles when the kernel starts and, when the
// consumers ask for tile g, first refills the stage of tile g - 1 (which
// every warp has released) with tile g - 1 + S. So the tile sequence runs on
// across product passes, and the next pass's first tiles load while the team
// synchronises. Each stage has a full mbarrier (one arrival and the copy's
// bytes) and an empty one (one arrival per warp).
//
// A team type TT for the ring holds: p.R, p.T, p.S, p.rw (its plan), w (the
// resident slice, or stage 0), src (its slice in device memory), mbar ([0]
// the resident load, [1 + s] stage s full, [1 + kT2MaxStages + s] empty),
// used (tiles consumed so far) and limit (tiles the kernel consumes in all;
// a kernel that cannot know it passes a bound and drains the ring before it
// leaves: t2_drain).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "network_drift.cuh"

namespace {

constexpr int kT2MaxStages = 8;
constexpr int kT2MinTileRows = 32;
constexpr size_t kT2SmemLimit = 232448;  // shared memory a block can use (sm_90)

__host__ __device__ inline size_t t2_align(size_t x) { return (x + 15) / 16 * 16; }

// ---------------------------------------------------------------------------
// mbarriers and bulk copies (PTX)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t t2_smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void t2_mbar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(t2_smem(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void t2_mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(t2_smem(b)) : "memory");
}

__device__ __forceinline__ void t2_mbar_wait(uint64_t* b, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "T2_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra T2_DONE;\n"
      "bra T2_WAIT;\n"
      "T2_DONE:\n"
      "}\n" ::"r"(t2_smem(b)),
      "r"(parity)
      : "memory");
}

// Make the mbarriers' initialisation visible to the cluster (thread 0,
// after t2_mbar_init, before the block barrier that precedes the copies).
__device__ __forceinline__ void t2_mbar_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Copy bytes (a multiple of 16) from device memory into this block's shared
// memory, in bulk copies of at most kT2CopyBytes; the copies complete on b,
// which expects exactly these bytes (one arrival).
constexpr uint32_t kT2CopyBytes = 32768;

__device__ __forceinline__ void t2_bulk_load(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* b) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(t2_smem(b)),
               "r"(bytes)
               : "memory");
  for (uint32_t off = 0; off < bytes; off += kT2CopyBytes) {
    const uint32_t part = bytes - off < kT2CopyBytes ? bytes - off : kT2CopyBytes;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(t2_smem(static_cast<unsigned char*>(dst) + off)),
        "l"(static_cast<const unsigned char*>(src) + off), "r"(part), "r"(t2_smem(b))
        : "memory");
  }
}

// ---------------------------------------------------------------------------
// Weights placed in a double without a conversion
// ---------------------------------------------------------------------------

// A bf16 weight h as the float64 w 2^-896, exactly: its sign, exponent and
// mantissa bits placed in the double's (exponent 0 gives a subnormal, which
// is the scaled bf16 subnormal or zero); the other operand of every product
// is scaled by 2^896 (exact: it is a finite float32), so each product is
// the unscaled one, exactly, and every sum is the same float64 sum. Only a
// non-finite weight would differ; a split of finite float32 weights has
// none.
__device__ __forceinline__ double t3_w(uint32_t h) {
  return __hiloint2double((int)(((h << 16) & 0x80000000u) | ((h & 0x7fffu) << 13)), 0);
}
// A float32 weight w (its bits) as the float64 w 2^-896, exactly, the same
// placement: the sign stays, the exponent and mantissa bits move down by
// three, into the double's exponent (whose top three bits are then 0) and
// mantissa; the mantissa's last three bits open the low word. That is w
// 2^(127 - 1023) for every finite float32, subnormals and +-0 included.
__device__ __forceinline__ double t3_w32(uint32_t w) {
  return __hiloint2double((int)((w & 0x80000000u) | ((w & 0x7fffffffu) >> 3)), (int)(w << 29));
}
// The scale of the other operand of such a product.
constexpr double kT3Scale = 0x1p896;

// ---------------------------------------------------------------------------
// The ring
// ---------------------------------------------------------------------------

template <class TT>
__device__ __forceinline__ uint32_t* t2_stage(const TT& T, int s) {
  return T.w + (size_t)s * T.p.R * T.p.rw;
}

// Start the bulk copy of tile sequence number g (tile g mod T of the slice)
// into stage g mod S (thread 0; the stage is free).
template <class TT>
__device__ void t2_fetch(TT& T, int g, int P) {
  const int s = g % T.p.S, m = g % T.p.T;
  const int rows = min(T.p.R, P - m * T.p.R);
  t2_bulk_load(t2_stage(T, s), T.src + (size_t)m * T.p.R * T.p.rw,
               (uint32_t)(4 * rows * T.p.rw), T.mbar + 1 + s);
}

// The rows of tile sequence number g, once they have landed. Thread 0 first
// refills the stage of tile g - 1 (which every warp has released) with tile
// g - 1 + S.
template <bool kStream, class TT>
__device__ __forceinline__ const uint32_t* t2_acquire(TT& T, int g, int P) {
  if (!kStream) return T.w;
  const int S = T.p.S;
  if (threadIdx.x == 0 && g >= 1 && g - 1 + S < T.limit) {
    t2_mbar_wait(T.mbar + 1 + kT2MaxStages + (g - 1) % S, (uint32_t)(((g - 1) / S) & 1));
    t2_fetch(T, g - 1 + S, P);
  }
  t2_mbar_wait(T.mbar + 1 + g % S, (uint32_t)((g / S) & 1));
  return t2_stage(T, g % S);
}

template <bool kStream, class TT>
__device__ __forceinline__ void t2_release(TT& T, int g) {
  if (!kStream) return;
  __syncwarp();
  if ((threadIdx.x & 31) == 0) t2_mbar_arrive(T.mbar + 1 + kT2MaxStages + g % T.p.S);
}

// Wait for the tiles still in flight when a kernel with an unbounded limit
// has consumed its last one (thread 0): tiles used .. last, where the first
// S were started at the kernel's start and t2_acquire(g) started g - 1 + S.
template <class TT>
__device__ void t2_drain(TT& T) {
  if (threadIdx.x != 0) return;
  const int S = T.p.S;
  const int last = T.used >= 1 ? T.used - 2 + S : S - 1;
  for (int q = T.used; q <= last; ++q) t2_mbar_wait(T.mbar + 1 + q % S, (uint32_t)((q / S) & 1));
}

// ---------------------------------------------------------------------------
// Launching a cluster team (a plan type with C, the cluster size, and
// bytes, a block's shared memory)
// ---------------------------------------------------------------------------

// A team kernel's attributes (p.bytes of shared memory; cluster size 16 is
// non-portable) and launch configuration for B teams of C blocks each.
template <class PL, typename... K>
int team2_prepare(void (*kernel)(K...), const PL& p) {
  if (int e = set_smem(kernel, p.bytes)) return e;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <class PL>
inline cudaLaunchConfig_t team2_config(const PL& p, int B, cudaStream_t stream,
                                       cudaLaunchAttribute* at) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * p.C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = p.bytes;
  cfg.stream = stream;
  at->id = cudaLaunchAttributeClusterDimension;
  at->val.clusterDim.x = p.C;
  at->val.clusterDim.y = 1;
  at->val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cfg;
}

template <class PL, typename... K, typename... A>
int team2_launch(void (*kernel)(K...), const PL& p, int B, cudaStream_t stream, A... args) {
  if (int e = team2_prepare(kernel, p)) return e;
  if (B < 1) return (int)cudaGetLastError();
  cudaLaunchAttribute at;
  const cudaLaunchConfig_t cfg = team2_config(p, B, stream, &at);
  if (int e = (int)cudaLaunchKernelEx(&cfg, kernel, args...)) return e;
  return (int)cudaGetLastError();
}

// How many of the kernel's clusters the card holds at once (0: none fits).
template <class PL, typename... K>
int team2_max_clusters(void (*kernel)(K...), const PL& p, int* out) {
  if (int e = team2_prepare(kernel, p)) return e;
  cudaLaunchAttribute at;
  const cudaLaunchConfig_t cfg = team2_config(p, 1, nullptr, &at);
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

}  // namespace
