// The bf16 tensor-core pieces that the serving kernel (flash_attention.cu) and
// the training kernels (flash_train.cu) share: 16-byte `cp.async` copies,
// `ldmatrix` fragment loads, `mma.sync.m16n8k16` with f32 accumulation, and
// the two tile products of attention on one warp's 16 rows.
//
// Fragments of m16n8k16 (thread g = lane / 4, t = lane % 4): A holds rows g
// and g + 8 at columns 2t, 2t + 1 and 2t + 8, 2t + 9; B holds k rows 2t, 2t + 1
// and 2t + 8, 2t + 9 of column g; the f32 accumulator rows g and g + 8 at
// columns 2t, 2t + 1. So the accumulator of a product A B^T over 8-column
// tiles is, register for register, the A fragment of a product with it on the
// left (no shuffle, no trip through shared memory).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// two floats as a bf16 pair (x in the low half) and what rounding left over
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// acc[j] += A[16 rows, KD] . B[rows 8j .. 8j + 7, KD]^T for j < NT: A and B
// row-major in shared memory with pitches PA and PB (elements; rows 16-byte
// aligned). Q K^T, dO V^T.
template <int KD, int NT, int PA, int PB>
__device__ __forceinline__ void mma_abt(const __nv_bfloat16* as, const __nv_bfloat16* bs,
                                        float (&acc)[NT][4], int lane) {
  const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, as + (rr + (mi & 1) * 8) * PA + kk * 16 + (mi >> 1) * 8);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, bs + (jp * 16 + rr + (mi >> 1) * 8) * PB + kk * 16 + (mi & 1) * 8);
      mma_bf16(acc[2 * jp], a, b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// o[n] += A[16 rows, KD] . B[KD rows, cols 8n .. 8n + 7] for n < N / 8, A the
// f32 accumulators of an mma_abt over KD columns taken as bf16 fragments (one
// rounding, or kSplit: two terms hi = bf16(a) and lo = bf16(a - hi), lo V then
// hi V), B row-major in shared memory with pitch PB. P V, dS K.
template <int KD, int N, int PB, bool kSplit>
__device__ __forceinline__ void mma_acc_b(const float (&p)[KD / 8][4], const __nv_bfloat16* bs,
                                          float (&o)[N / 8][4], int lane) {
  const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    uint32_t hi[4], lo[4];
    if constexpr (kSplit) {
      split_bf16x2(p[2 * kk][0], p[2 * kk][1], hi[0], lo[0]);
      split_bf16x2(p[2 * kk][2], p[2 * kk][3], hi[1], lo[1]);
      split_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[3], lo[3]);
    } else {
      hi[0] = pack_bf16x2(p[2 * kk][0], p[2 * kk][1]);
      hi[1] = pack_bf16x2(p[2 * kk][2], p[2 * kk][3]);
      hi[2] = pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      hi[3] = pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    }
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, bs + (kk * 16 + rr + (mi & 1) * 8) * PB + np * 16 + (mi >> 1) * 8);
      if constexpr (kSplit) mma_bf16(o[2 * np], lo, b[0], b[1]);
      mma_bf16(o[2 * np], hi, b[0], b[1]);
      if constexpr (kSplit) mma_bf16(o[2 * np + 1], lo, b[2], b[3]);
      mma_bf16(o[2 * np + 1], hi, b[2], b[3]);
    }
  }
}

}  // namespace flash
