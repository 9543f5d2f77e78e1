// Helpers shared by the kl_simplex kernels: one warp owns one row of a
// [V, K] matrix, its lanes stride over the row (neighbouring lanes on
// neighbouring addresses), and the row's sums and maxima are combined with
// butterfly shuffles, so every lane ends with the row's value.
//
// Precise math only: the kernels are built without --use_fast_math and call
// log2f / logf / expf, never the __log2f / __expf intrinsics, so that a row
// of 4096 terms still holds 1e-5 against the plain versions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace kl_simplex {

constexpr float kEps = 1e-12f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;   // rows per block
constexpr int kThreads = 32 * kWarpsPerBlock;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// clip(v, 1e-12, 1) as jnp.clip / torch.clamp compute it
__device__ __forceinline__ float clip_unit(float v) {
  return fminf(fmaxf(v, kEps), 1.0f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, offset);
  }
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, offset));
  }
  return v;
}

// The warp's row; rows past V return -1 (the whole warp leaves together, so
// the shuffles of the warps that stay always see 32 lanes).
__device__ __forceinline__ long long warp_row() {
  return static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
}

inline unsigned grid_for(int v) {
  return static_cast<unsigned>((v + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace kl_simplex
