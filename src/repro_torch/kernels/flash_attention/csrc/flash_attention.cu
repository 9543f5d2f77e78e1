// Forward-only blocked online-softmax attention for Hopper (sm_90a), on the
// tensor cores:
//
//     o[b,i,h,:] = sum_j softmax_j(scale * q[b,i,h,:] . k[b,j,h/G,:]) * v[b,j,h/G,:]
//
// over the keys j kept by the mask: j < T, plus j <= i when causal, plus
// j > i - window when a window is set. q [B, S, H, hd], k/v [B, T, KV, hd]
// with G = H / KV (GQA: q-head h reads kv-head h / G), read in place through
// their strides (the last stride is 1, every row 16-byte aligned); o
// [B, S, H, hd] contiguous, in q's dtype. f32 or bf16 in; the running max,
// denominator and accumulator in f32. A query row with no kept key gives 0
// (the Pallas kernel's max(l, 1e-30) denominator).
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py.
//
// What bounds it on this card: operations. A causal prefill does
// 4 * B * H * hd * S(S+1)/2 operations on O(S * hd) bytes per head (at B=4,
// S=T=2048, H=16, KV=8, hd=128: 6.9e10 operations against 50 MB), hundreds
// of operations per byte. On the tensor cores that is 0.07 ms at the bf16
// rate (989 TFLOP/s); the f32 path below does three TF32 products for each
// one, 2.1e11 operations, 0.42 ms at the TF32 rate (495 TFLOP/s). (On the
// CUDA cores, as the first design ran, the f32 floor was 1.03 ms.)
//
// What the design does about it:
// * Tiling. One block owns one (b, kv-head, 64-query tile) and hb q-heads
//   that read that kv-head: hb = 2 when G is even, else 1, so a block is
//   4 * hb warps, each warp 16 query rows of one head (the m16 of `mma`). A
//   GQA group of G > 2 heads is split over G / 2 blocks: two heads (256
//   threads) are what the f32 path's shared memory (215 KB at hd = 128) and
//   registers hold. Each k/v tile is loaded once per block and used by hb
//   heads. The query tile is the grid's slow axis, walked from the last one
//   down: under a causal mask the longest blocks start first.
// * Copies. Key tiles of kBK = 64 keys, K and V, go into a 2-stage ring in
//   shared memory filled with 16-byte `cp.async` copies (zero-filled past T);
//   tile n + 1 is in flight while tile n is computed (`cp.async.wait_group`).
//   The q tile is copied the same way, once. Nothing is converted on the way
//   in. The wrapper raises on a view whose rows are not 16-byte aligned.
// * bf16: `mma.sync.m16n8k16` with f32 accumulation. Q and K fragments come
//   from shared memory by `ldmatrix`, V's by `ldmatrix.trans`; the score
//   accumulator of S = Q K^T is, register for register, the A fragment of
//   P V (no shuffle, no trip through shared memory). P is rounded to bf16 as
//   two terms, hi = bf16(p) and lo = bf16(p - hi), and P V is hi V + lo V:
//   a single bf16 P (FlashAttention's choice) errs by 2^-9 of p, which at a
//   2,048-key row is above the 2e-5 + 1e-2 |o| held element-wise at the
//   serving shape. Q K^T takes one product: bf16 x bf16 is exact in f32.
//   These bf16 pieces live in flash_common.cuh, shared with the training
//   kernels (flash_train.cu).
// * f32: 3xTF32 on `mma.sync.m16n8k8`. Each operand a splits into
//   big = tf32(a) and small = tf32(a - big) (`cvt.rna.tf32.f32`), and each
//   product is small*big + big*small + big*big: about 21 bits of each
//   operand (a CPU test emulates the split in torch: it holds the f32
//   tolerance of 2e-5 where plain TF32 misses it). The tensor cores add a
//   step's products aligned to the largest addend and cut the bits below it,
//   so the products are summed on them only in short chains from 0 (16 dims
//   of Q K^T, 32 keys of P V, the correction terms apart from big*big), and
//   the chains are added into the f32 sums in registers, rounded to nearest.
//   Measured at B=1, S=T=2048, H=16, KV=8, hd=128, causal, scale 0.3: one
//   chain per output across the whole kv loop lost 5.1e-5 (past 2e-5),
//   almost all of it in P V; these chains lose 9.4e-6 (1.2e-5 with window
//   512) on the same inputs, which chip_smoke.py prints, near what the CPU
//   emulation of the split alone gives (1.6e-5). The k index of both
//   products is permuted (the same way in A and B, so the sum is unchanged) so that a
//   thread's fragments are adjacent in shared memory: Q and K as 16-byte
//   reads, and P's fragment is again the score accumulator itself. Shared
//   memory pitches (hd + 16 for Q and K, hd + 4 for V) keep the reads free
//   of bank conflicts.
//   `wgmma` would reach the rest of the tensor cores' rate; `mma.sync` is
//   the simpler, surer first step (wgmma takes tf32 operands only K-major,
//   so V would have to be staged transposed for P V). Later work.
// * Softmax. Each thread holds two rows' running max and denominator; row
//   max is a 2-step shuffle over the 4 threads of a quad, the denominator is
//   summed per thread and reduced once at the end. Scores are taken to base
//   2 (scale * log2 e folded in) for exp2f.
// * Kept exactly from the first design: masked scores are the finite
//   sentinel -1e30 and p is selected to 0 by the mask itself, so a tile with
//   no kept key gives a rescale of exp2(0) = 1 and never NaN; tiles wholly
//   outside the causal or window band are not visited (the loop bounds; the
//   test for a window is the reference's k_start + BK - 1 > q_start -
//   window); a warp whose 16 rows keep every key of a tile skips the mask.
//   hd is a template parameter (16, 32, 64, 128): 8 instantiations with the
//   two dtypes.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers, strides and the current stream, and raises on the
// returned error.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

using flash::cp_async16;

constexpr int kBQ = 64;            // query rows of one head per block (4 warps x 16)
constexpr int kBK = 64;            // keys per tile
constexpr int kMaxHeads = 2;       // q-heads per block
constexpr int kMaxThreads = 128 * kMaxHeads;
constexpr int kNT = kBK / 8;       // n-tiles of 8 keys in a score tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int s, t, h, kv, group;
  int hb;          // q-heads per block
  int n_hgroups;   // blocks per (b, kv-head, query tile) = group / hb
  long long sqb, sqs, sqh;   // strides of q (elements), last stride 1
  long long skb, skt, skh;
  long long svb, svt, svh;
  float scale;
  int causal;
  int has_window;
  int window;
};

// shared-memory pitches (elements) and size
template <typename T, int HD>
struct Layout {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  // f32: pitch = 16 (mod 32 words) for 16-byte reads of Q and K, 4 (mod 16)
  // for V's 4-byte reads; bf16: 16 bytes (mod 128) for ldmatrix
  static constexpr int kQK = kF32 ? (HD % 32 == 0 ? HD + 16 : HD) : HD + 8;
  static constexpr int kV = kF32 ? HD + 4 : HD + 8;
  static constexpr size_t bytes(int hb) {
    return (static_cast<size_t>(hb) * kBQ * kQK + 2 * kBK * kQK + 2 * kBK * kV) *
           sizeof(T);
  }
};

// ---------------------------------------------------------------- bf16 ----

// s[j] += Q[16 rows] . K[keys 8j .. 8j+7]^T over hd
template <int HD>
__device__ __forceinline__ void qk_bf16(const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                                        float (&s)[kNT][4], int lane) {
  constexpr int P = Layout<__nv_bfloat16, HD>::kQK;
  flash::mma_abt<HD, kNT, P, P>(qs, ks, s, lane);
}

// o[n] += P[16 rows, 64 keys] . V[64 keys, cols 8n .. 8n+7], P = hi + lo
template <int HD>
__device__ __forceinline__ void pv_bf16(const float (&p)[kNT][4], const __nv_bfloat16* vs,
                                        float (&o)[HD / 8][4], int lane) {
  flash::mma_acc_b<kBK, HD, Layout<__nv_bfloat16, HD>::kV, true>(p, vs, o, lane);
}

// ----------------------------------------------------------- f32: 3xTF32 ----

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// an A fragment split once into its big and small tf32 halves
struct SplitA {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ SplitA split_a(float a0, float a1, float a2, float a3) {
  SplitA r;
  split_tf32(a0, r.big[0], r.small[0]);
  split_tf32(a1, r.big[1], r.small[1]);
  split_tf32(a2, r.big[2], r.small[2]);
  split_tf32(a3, r.big[3], r.small[3]);
  return r;
}

// One k8 step of a . b in 3xTF32, b given as two floats: the big x big
// product into `big`, the two correction products into `fix`. The caller
// starts both at 0 for a short chain of steps and adds them into its f32
// sum with an ordinary (round-to-nearest) add: the tensor cores align each
// step's products to the largest addend and drop the bits below it, so a
// long chain into one large accumulator loses, step after step, the very
// bits the correction terms carry.
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&fix)[4], const SplitA& a,
                                           float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma_tf32(fix, a.small, bb0, bb1);
  mma_tf32(fix, a.big, bs0, bs1);
  mma_tf32(big, a.big, bb0, bb1);
}

__device__ __forceinline__ void add_chain(float (&d)[4], const float (&big)[4],
                                          const float (&fix)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += big[e] + fix[e];
}

// s[j] += Q[16 rows] . K[keys 8j .. 8j+7]^T over hd. Within each 16-wide
// slice of hd, thread (g, t) takes dims 4t .. 4t+3 of rows g and g+8: the
// first k8 step reads dims 4t, 4t+1 as its k = t, t+4, the second 4t+2, 4t+3.
// One chain per 16-wide slice.
template <int HD>
__device__ __forceinline__ void qk_f32(const float* qs, const float* ks, float (&s)[kNT][4],
                                       int lane) {
  constexpr int P = Layout<float, HD>::kQK;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kb = 0; kb < HD / 16; ++kb) {
    const float4 qa = *reinterpret_cast<const float4*>(qs + g * P + kb * 16 + 4 * t);
    const float4 qb = *reinterpret_cast<const float4*>(qs + (g + 8) * P + kb * 16 + 4 * t);
    const SplitA a0 = split_a(qa.x, qb.x, qa.y, qb.y);
    const SplitA a1 = split_a(qa.z, qb.z, qa.w, qb.w);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float4 kv = *reinterpret_cast<const float4*>(ks + (8 * j + g) * P + kb * 16 + 4 * t);
      float big[4] = {0.0f, 0.0f, 0.0f, 0.0f}, fix[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_3xtf32(big, fix, a0, kv.x, kv.y);
      mma_3xtf32(big, fix, a1, kv.z, kv.w);
      add_chain(s[j], big, fix);
    }
  }
}

// o[n] += P[16 rows, 64 keys] . V[64 keys, cols 8n .. 8n+7]. In key block jj
// the k8 step's k = t, t+4 are keys 8jj + 2t, 8jj + 2t + 1: the two columns
// of the score accumulator this thread already holds. One chain per 32 keys:
// P's fragments of 4 key blocks are split first (32 registers), then each
// output n-tile takes its 12 products in one chain.
template <int HD>
__device__ __forceinline__ void pv_f32(const float (&p)[kNT][4], const float* vs,
                                       float (&o)[HD / 8][4], int lane) {
  constexpr int P = Layout<float, HD>::kV;
  constexpr int kJ = kNT / 2;   // key blocks of 8 per chain
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    SplitA a[kJ];
#pragma unroll
    for (int i = 0; i < kJ; ++i) {
      const int jj = half * kJ + i;
      a[i] = split_a(p[jj][0], p[jj][2], p[jj][1], p[jj][3]);
    }
    const float* v0 = vs + (half * kJ * 8 + 2 * t) * P + g;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      float big[4] = {0.0f, 0.0f, 0.0f, 0.0f}, fix[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < kJ; ++i)
        mma_3xtf32(big, fix, a[i], v0[8 * i * P + 8 * n], v0[(8 * i + 1) * P + 8 * n]);
      add_chain(o[n], big, fix);
    }
  }
}

// ----------------------------------------------------------------- kernel ----

// bf16: two blocks of 256 threads per SM (at most 128 registers a thread;
// 104 KB of shared memory each at hd = 128) ran the serving shape 22 % faster
// than one; f32 blocks take 215 KB of shared memory, one per SM.
template <typename T, int HD>
__global__ void __launch_bounds__(kMaxThreads, std::is_same<T, float>::value ? 1 : 2)
    flash_attention_kernel(const Args a) {
  using L = Layout<T, HD>;
  constexpr int kEl = 16 / sizeof(T);     // elements per 16-byte copy
  constexpr int kCh = HD / kEl;           // 16-byte copies per row
  constexpr int NO = HD / 8;              // n-tiles of the output

  extern __shared__ float4 smem4[];
  T* s_q = reinterpret_cast<T*>(smem4);              // [hb * kBQ][kQK]
  T* s_k = s_q + a.hb * kBQ * L::kQK;                // [2][kBK][kQK]
  T* s_v = s_k + 2 * kBK * L::kQK;                   // [2][kBK][kV]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int hh = warp >> 2;               // which of the block's heads
  const int r0 = (warp & 3) * 16;         // the warp's first row in its head's tile

  int bx = blockIdx.x;
  const int hg = bx % a.n_hgroups;
  bx /= a.n_hgroups;
  const int kvi = bx % a.kv;
  const int bi = bx / a.kv;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int h0 = kvi * a.group + hg * a.hb;

  const T* q = static_cast<const T*>(a.q) + bi * a.sqb + h0 * a.sqh;
  const T* k = static_cast<const T*>(a.k) + bi * a.skb + kvi * a.skh;
  const T* v = static_cast<const T*>(a.v) + bi * a.svb + kvi * a.svh;

  // the key tiles that hold a kept key for some row of this query tile
  int kt_end = (a.t + kBK - 1) / kBK;
  if (a.causal) kt_end = min(kt_end, (q_start + kBQ - 1) / kBK + 1);
  int kt_begin = 0;
  if (a.has_window) {
    const int first = q_start - a.window + 1;   // the oldest key row q_start keeps
    if (first > 0) kt_begin = first / kBK;
  }
  const int n_tiles = max(kt_end - kt_begin, 0);

  // the q tile of every head of the block (zero past S), then the first k/v tile
  for (int c = tid; c < a.hb * kBQ * kCh; c += nthreads) {
    const int row = c / kCh, ch = c - row * kCh;
    const int head = row / kBQ, pos = q_start + row % kBQ;
    const bool in = pos < a.s;
    const T* src = in ? q + pos * a.sqs + head * a.sqh + ch * kEl : q;
    cp_async16(s_q + row * L::kQK + ch * kEl, src, in);
  }
  auto load_kv = [&](int kt, int stage) {
    T* dk = s_k + stage * kBK * L::kQK;
    T* dv = s_v + stage * kBK * L::kV;
    for (int c = tid; c < kBK * kCh; c += nthreads) {
      const int r = c / kCh, ch = c - r * kCh;
      const int key = kt * kBK + r;
      const bool in = key < a.t;
      cp_async16(dk + r * L::kQK + ch * kEl, in ? k + key * a.skt + ch * kEl : k, in);
      cp_async16(dv + r * L::kV + ch * kEl, in ? v + key * a.svt + ch * kEl : v, in);
    }
  };
  if (n_tiles > 0) load_kv(kt_begin, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const float scale2 = a.scale * kLog2e;
  const int row_lo = q_start + r0;        // the warp's rows: row_lo .. row_lo + 15
  const int my_row[2] = {row_lo + g, row_lo + g + 8};

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_kv(kt_begin + it + 1, (it + 1) & 1);
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int stage = it & 1;
    const int k_start = (kt_begin + it) * kBK;
    const T* qs = s_q + (hh * kBQ + r0) * L::kQK;
    const T* ks = s_k + stage * kBK * L::kQK;
    const T* vs = s_v + stage * kBK * L::kV;

    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    if constexpr (L::kF32) {
      qk_f32<HD>(qs, ks, s, lane);
    } else {
      qk_bf16<HD>(qs, ks, s, lane);
    }

    // mask (only where some pair of the warp's rows and this tile is
    // dropped), scale to base 2, running max
    const bool need_mask = k_start + kBK > a.t ||
                           (a.causal && k_start + kBK - 1 > row_lo) ||
                           (a.has_window && k_start <= row_lo + 15 - a.window);
    uint32_t kept = 0xffffffffu;
    float row_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        bool ok = true;
        if (need_mask) {
          const int key = k_start + 8 * j + 2 * t4 + (e & 1);
          const int qp = my_row[r];
          ok = key < a.t && (!a.causal || key <= qp) &&
               (!a.has_window || key > qp - a.window);
        }
        if (!ok) kept &= ~(1u << (j * 4 + e));
        s[j][e] = ok ? s[j][e] * scale2 : kNegInf;
        row_max[r] = fmaxf(row_max[r], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 1));
      row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 2));
      const float m_new = fmaxf(m[r], row_max[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = ((kept >> (j * 4 + e)) & 1u) ? exp2f(s[j][e] - m[r]) : 0.0f;
        s[j][e] = p;
        l[r] += p;
      }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    if constexpr (L::kF32) {
      pv_f32<HD>(s, vs, o, lane);
    } else {
      pv_bf16<HD>(s, vs, o, lane);
    }
    __syncthreads();   // this stage's readers are done before it is refilled
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");   // no tile: the q copies

  T* out = static_cast<T*>(a.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = my_row[r];
    if (row >= a.s) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* o_row = out + ((static_cast<long long>(bi) * a.s + row) * a.h + h0 + hh) * HD;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float x = o[n][2 * r] / denom, y = o[n][2 * r + 1] / denom;
      if constexpr (L::kF32) {
        *reinterpret_cast<float2*>(o_row + 8 * n + 2 * t4) = make_float2(x, y);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * n + 2 * t4) =
            __floats2bfloat162_rn(x, y);
      }
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr size_t max_bytes = Layout<T, HD>::bytes(kMaxHeads);
  static_assert(max_bytes <= 232448, "shared memory of one block");
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(max_bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * a.kv * a.n_hgroups, (a.s + kBQ - 1) / kBQ);
  flash_attention_kernel<T, HD><<<grid, 128 * a.hb, Layout<T, HD>::bytes(a.hb), stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const Args& a, int batch, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(a, batch, stream);
    case 32: return launch<T, 32>(a, batch, stream);
    case 64: return launch<T, 64>(a, batch, stream);
    case 128: return launch<T, 128>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q-heads one block serves for a GQA group of `group` heads (the rule above)
extern "C" int flash_attention_heads_per_block(int group) {
  return group % kMaxHeads == 0 ? kMaxHeads : 1;
}

// shared memory of one block, in bytes, for head_dim hd, dtype (0 = float32,
// 1 = bfloat16) and a GQA group of `group` q-heads; 0 for an hd not built
extern "C" long long flash_attention_smem_bytes(int hd, int dtype, int group) {
  const int hb = flash_attention_heads_per_block(group);
  switch (hd * 2 + dtype) {
    case 32: return Layout<float, 16>::bytes(hb);
    case 64: return Layout<float, 32>::bytes(hb);
    case 128: return Layout<float, 64>::bytes(hb);
    case 256: return Layout<float, 128>::bytes(hb);
    case 33: return Layout<__nv_bfloat16, 16>::bytes(hb);
    case 65: return Layout<__nv_bfloat16, 32>::bytes(hb);
    case 129: return Layout<__nv_bfloat16, 64>::bytes(hb);
    case 257: return Layout<__nv_bfloat16, 128>::bytes(hb);
    default: return 0;
  }
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o). Strides in elements.
// window is read only when has_window. Returns the launch's cudaError_t.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int b, int s, int t,
    int h, int kv, long long sqb, long long sqs, long long sqh, long long skb,
    long long skt, long long skh, long long svb, long long svt, long long svh,
    float scale, int causal, int has_window, int window, int hd, int dtype, void* stream) {
  if (kv <= 0 || h % kv != 0) return cudaErrorInvalidValue;
  const int group = h / kv;
  const int hb = flash_attention_heads_per_block(group);
  const Args a{q, k, v, o, s, t, h, kv, group, hb, group / hb, sqb, sqs, sqh, skb, skt, skh,
               svb, svt, svh, scale, causal, has_window, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(a, b, hd, st);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(a, b, hd, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
