// Causal training attention for Hopper (sm_90a): forward with the rows'
// log-sum-exp, and its backward, bf16 operands on the tensor cores with f32
// sums:
//
//     o[b,i,h,:] = sum_j p_ij v[b,j,h/G,:],  p_ij = exp(scale q_i . k_j - lse_i)
//
// over the keys j <= i (and j > i - window when a window is set). q [B, S, H,
// dqk], k [B, S, KV, dqk], v [B, S, KV, dv] with G = H / KV (GQA), read in
// place through their strides (last stride 1, rows 16-byte aligned); o
// [B, S, H, dv] bf16 and lse [B, H, S] f32 (natural log), contiguous. The
// value width is its own template parameter: (dqk, dv) = (64, 64) (granite,
// musicgen, hymba), (128, 128) (the zoo's other archs) and (192, 128)
// (Moonlight's latent attention: q/k 128 + 64 rotary, v 128).
//
// Backward, given dO (contiguous, bf16), with D_i = sum_c dO_ic o_ic and P
// recomputed from q, k and lse:
//     dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),  dQ = scale dS K,
//     dK = scale dS^T Q,
// in two launches: `flash_train_dq` (one block per 64 query rows of a head;
// it forms D for its rows, writes it, and sums dQ over the key tiles) and then
// `flash_train_dkdv` (one block per 64 keys of a kv-head; it reads D and sums
// dK and dV over the G q-heads of the group and their query tiles). Each
// output element is summed by one thread in a fixed order: no atomics, and
// the gradients are the same bits from run to run. The price is that S = Q K^T
// and dP = dO V^T are formed in both launches: 7 products of a tile instead
// of the 5 that f32 atomics for dQ would need (2 (4 dqk + 3 dv) operations a
// kept pair and head against 2 (3 dqk + 2 dv)).
//
// Replaces no TPU kernel: the Pallas `flash_attention` (src/repro/kernels/
// flash_attention/kernel.py) is forward only and the JAX package trains
// through its plain attention. It was added because the port's train step
// spent most of its device time (69 % of a round of Moonlight at S = 8,192,
// 37 % of granite's at 4,096) in the plain `_sdpa`: f32 logits [B, KV, G, S, S]
// materialised, masked by a `where`, two full-f32 GEMMs each way, and half the
// work on keys the causal mask drops.
//
// Numbers: the same precision as `_sdpa` on bf16 q, k, v. Q K^T and dO V^T
// take bf16 operands, whose products are exact in f32, summed in f32 (as
// `_sdpa`'s f32 einsum of widened bf16 values); P enters P V and P^T dO as one
// bf16 rounding (`_sdpa` rounds its probabilities to bf16 before P V, and its
// autograd rounds dP there); dS enters dQ and dK as one bf16 rounding
// (FlashAttention's choice; `_sdpa` keeps dS in f32, so this is the one
// rounding it does not make: 2^-9 of each term of a sum of S terms). The
// softmax statistics, D and every accumulator are f32; o, dq, dk, dv are
// rounded to bf16 once, at the end, as `_sdpa`'s outputs and gradients are.
//
// What bounds it on this card: operations. A causal pass over S keys needs
// 2 B H S(S+1)/2 (dqk + dv) operations forward and 2 B H S(S+1)/2 (3 dqk + 2 dv)
// backward (its five products: S recomputed, dP, dV, dK, dQ) on O(S (dqk + dv))
// bytes per head: at Moonlight's layer (B = 1, H = 16, S = 8,192, 192 / 128)
// 3.4e11 operations forward (0.35 ms at the bf16 rate, 989 TFLOP/s) and 8.9e11
// backward (0.90 ms), against about 170 MB of q, k, v and o (50 us at
// 3.35 TB/s) and twice that backward.
//
// What the design does about it:
// * Tiles: 64 queries by 64 keys; tiles wholly above the diagonal (or below
//   the window) are not visited, the query tiles walked from the last (the
//   longest) first, the key tiles of the backward from the first.
// * Forward and dQ: 4 warps, each 16 query rows of one head; key tiles of K
//   and V go into a 2-stage `cp.async` ring (tile n + 1 in flight while tile n
//   is computed). The score accumulator is the A fragment of P V (dS K):
//   `flash_common.cuh`, shared with the serving kernel.
// * dK, dV: 8 warps. Phase 1: S and dP of 64 rows x 64 keys (each warp 16 rows
//   x 32 keys), P and dS to shared memory as bf16. Phase 2: each warp 16 keys x
//   half of the dqk and dv columns, P^T and dS^T read back by `ldmatrix.trans`.
//   So no warp holds S, dP, dK and dV of the whole width at once: at (192, 128)
//   a thread keeps 48 + 32 accumulators of dK, dV and 16 + 16 of S, dP (the
//   register budget is the design question at that width). Q and dO tiles
//   stream through a 2-stage ring; K and V stay in shared memory.
// * Softmax in base 2 (scale log2 e folded in; lse stored as a natural log),
//   masked scores at the finite sentinel -1e30 and p selected to 0 by the
//   mask, as in the serving kernel.
// * The key tile is 64 at every width. At (192, 128) the dQ launch holds 96
//   dQ, 32 S and 32 dP accumulators a thread: ptxas gives it 255 registers and
//   a 20-byte spill; the dK / dV launch 206 registers, the forward 194, no spill.
// `mma.sync`, not `wgmma`: the simpler first step; it takes Moonlight's
// attention from about 1.5 s of `_sdpa` to under 0.2 s a round (PERF.md). A
// warp's 16 rows read each K and V fragment from shared memory for two
// products only, so shared memory, not the tensor cores, sets the pace (a
// quarter of the bf16 rate at best): `wgmma` with TMA is the later redesign.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers, strides and the current stream, and raises on the
// returned error.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::cp_async16;

constexpr int kBM = 64;            // query rows of a tile
constexpr int kBN = 64;            // keys of a tile
constexpr int kNT = kBN / 8;       // n-tiles of 8 keys in a score tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;      // forward's output, [B, S, H, dv] (backward)
  const bf16* dout;   // [B, S, H, dv] (backward)
  bf16* out;          // o (forward) or dq [B, S, H, dqk]
  bf16* dk;           // [B, S, KV, dqk]
  bf16* dv;           // [B, S, KV, dv]
  float* lse;         // [B, H, S]
  float* dsum;        // D, [B, H, S]
  int s, h, kv, group;
  long long sqb, sqs, sqh;   // strides of q (elements), last stride 1
  long long skb, skt, skh;
  long long svb, svt, svh;
  float scale;
  int has_window;
  int window;
};

// shared-memory pitches (elements): 16 bytes (mod 128) for ldmatrix
template <int DQK, int DV>
struct Layout {
  static constexpr int kQK = DQK + 8;
  static constexpr int kV = DV + 8;
  static constexpr int kP = kBN + 8;
  // q tile, 2-stage k / v ring
  static constexpr size_t fwd_bytes = (kBM * kQK + 2 * kBN * (kQK + kV)) * sizeof(bf16);
  // q and dO tiles, 2-stage k / v ring
  static constexpr size_t dq_bytes = (kBM * (kQK + kV) + 2 * kBN * (kQK + kV)) * sizeof(bf16);
  // k and v tiles, 2-stage q / dO ring, P and dS
  static constexpr size_t dkdv_bytes =
      (kBN * (kQK + kV) + 2 * kBM * (kQK + kV) + 2 * kBM * kP) * sizeof(bf16);
};

// rows [row0, row0 + rows) of a [*, width] tile at src (row stride `stride`
// elements) into shared memory with pitch `pitch`, zero past `limit`
template <int WIDTH, int PITCH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long stride, int row0,
                                          int rows, int limit, int tid, int nthreads) {
  constexpr int kCh = WIDTH / 8;   // 16-byte copies per row
  for (int c = tid; c < rows * kCh; c += nthreads) {
    const int r = c / kCh, ch = c - r * kCh;
    const int pos = row0 + r;
    const bool in = pos < limit;
    cp_async16(dst + r * PITCH + ch * 8, in ? src + pos * stride + ch * 8 : src, in);
  }
}

__device__ __forceinline__ bool kept(int key, int row, const Args& a) {
  return key <= row && (!a.has_window || key > row - a.window);
}

// first and one-past-last key tile that a query tile keeps a key of
__device__ __forceinline__ void key_tiles(int q_start, const Args& a, int& begin, int& end) {
  end = q_start / kBN + 1;
  begin = 0;
  if (a.has_window) {
    const int first = q_start - a.window + 1;   // the oldest key row q_start keeps
    if (first > 0) begin = first / kBN;
  }
}

// ---------------------------------------------------------------- forward ----

template <int DQK, int DV>
__global__ void __launch_bounds__(128, 2) flash_train_fwd_kernel(const Args a) {
  using L = Layout<DQK, DV>;
  constexpr int NO = DV / 8;
  extern __shared__ float4 smem4[];
  bf16* s_q = reinterpret_cast<bf16*>(smem4);       // [kBM][kQK]
  bf16* s_k = s_q + kBM * L::kQK;                    // [2][kBN][kQK]
  bf16* s_v = s_k + 2 * kBN * L::kQK;                // [2][kBN][kV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
  const int hi = blockIdx.x % a.h, bi = blockIdx.x / a.h;
  const int kvi = hi / a.group;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kBM;
  const bf16* q = a.q + bi * a.sqb + hi * a.sqh;
  const bf16* k = a.k + bi * a.skb + kvi * a.skh;
  const bf16* v = a.v + bi * a.svb + kvi * a.svh;

  int kt_begin, kt_end;
  key_tiles(q_start, a, kt_begin, kt_end);
  const int n_tiles = kt_end - kt_begin;

  load_rows<DQK, L::kQK>(s_q, q, a.sqs, q_start, kBM, a.s, tid, blockDim.x);
  auto load_kv = [&](int kt, int stage) {
    load_rows<DQK, L::kQK>(s_k + stage * kBN * L::kQK, k, a.skt, kt * kBN, kBN, a.s, tid,
                           blockDim.x);
    load_rows<DV, L::kV>(s_v + stage * kBN * L::kV, v, a.svt, kt * kBN, kBN, a.s, tid,
                         blockDim.x);
  };
  load_kv(kt_begin, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const float scale2 = a.scale * kLog2e;
  const int my_row[2] = {q_start + r0 + g, q_start + r0 + g + 8};

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_kv(kt_begin + it + 1, (it + 1) & 1);
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int stage = it & 1;
    const int k_start = (kt_begin + it) * kBN;
    const bf16* ks = s_k + stage * kBN * L::kQK;
    const bf16* vs = s_v + stage * kBN * L::kV;

    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    flash::mma_abt<DQK, kNT, L::kQK, L::kQK>(s_q + r0 * L::kQK, ks, s, lane);

    float row_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k_start + 8 * j + 2 * t4 + (e & 1);
        s[j][e] = kept(key, my_row[e >> 1], a) ? s[j][e] * scale2 : kNegInf;
        row_max[e >> 1] = fmaxf(row_max[e >> 1], s[j][e]);
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
        const float p = s[j][e] == kNegInf ? 0.0f : exp2f(s[j][e] - m[r]);
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
    flash::mma_acc_b<kBN, DV, L::kV, false>(s, vs, o, lane);
    __syncthreads();   // this stage's readers are done before it is refilled
  }

  const long long head_row = (static_cast<long long>(bi) * a.h + hi) * a.s;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = my_row[r];
    if (row >= a.s) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    if (t4 == 0) a.lse[head_row + row] = (m[r] + log2f(denom)) * kLn2;
    bf16* o_row = a.out + ((static_cast<long long>(bi) * a.s + row) * a.h + hi) * DV;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(o_row + 8 * n + 2 * t4) =
          flash::pack_bf16x2(o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
  }
}

// ------------------------------------------------------------- backward: dQ ----

template <int DQK, int DV>
__global__ void __launch_bounds__(128, 1) flash_train_dq_kernel(const Args a) {
  using L = Layout<DQK, DV>;
  constexpr int NQ = DQK / 8;
  extern __shared__ float4 smem4[];
  bf16* s_q = reinterpret_cast<bf16*>(smem4);       // [kBM][kQK]
  bf16* s_do = s_q + kBM * L::kQK;                   // [kBM][kV]
  bf16* s_k = s_do + kBM * L::kV;                    // [2][kBN][kQK]
  bf16* s_v = s_k + 2 * kBN * L::kQK;                // [2][kBN][kV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
  const int hi = blockIdx.x % a.h, bi = blockIdx.x / a.h;
  const int kvi = hi / a.group;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kBM;
  const bf16* q = a.q + bi * a.sqb + hi * a.sqh;
  const bf16* k = a.k + bi * a.skb + kvi * a.skh;
  const bf16* v = a.v + bi * a.svb + kvi * a.svh;
  // o and dO: [B, S, H, dv] contiguous, row stride H * dv
  const long long orow0 = (static_cast<long long>(bi) * a.s * a.h + hi) * DV;
  const long long ostride = static_cast<long long>(a.h) * DV;

  int kt_begin, kt_end;
  key_tiles(q_start, a, kt_begin, kt_end);
  const int n_tiles = kt_end - kt_begin;

  load_rows<DQK, L::kQK>(s_q, q, a.sqs, q_start, kBM, a.s, tid, blockDim.x);
  load_rows<DV, L::kV>(s_do, a.dout + orow0, ostride, q_start, kBM, a.s, tid, blockDim.x);
  auto load_kv = [&](int kt, int stage) {
    load_rows<DQK, L::kQK>(s_k + stage * kBN * L::kQK, k, a.skt, kt * kBN, kBN, a.s, tid,
                           blockDim.x);
    load_rows<DV, L::kV>(s_v + stage * kBN * L::kV, v, a.svt, kt * kBN, kBN, a.s, tid,
                         blockDim.x);
  };
  load_kv(kt_begin, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // D and lse of the thread's two rows (g and g + 8 of the warp's 16); D is
  // written once, here, for the dK / dV launch
  const long long head_row = (static_cast<long long>(bi) * a.h + hi) * a.s;
  const int my_row[2] = {q_start + r0 + g, q_start + r0 + g + 8};
  float dsum[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = my_row[r];
    float acc = 0.0f;
    if (row < a.s) {
      const bf16* orow = a.o + orow0 + row * ostride;
      const bf16* drow = a.dout + orow0 + row * ostride;
#pragma unroll 4
      for (int n = 0; n < DV / 8; ++n) {
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(orow + 8 * n + 2 * t4);
        const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(drow + 8 * n + 2 * t4);
        acc += __low2float(x) * __low2float(y) + __high2float(x) * __high2float(y);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dsum[r] = acc;
    lse2[r] = row < a.s ? a.lse[head_row + row] * kLog2e : 0.0f;
    if (t4 == 0 && row < a.s) a.dsum[head_row + row] = acc;
  }

  float dq[NQ][4];
#pragma unroll
  for (int n = 0; n < NQ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;
  const float scale2 = a.scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_kv(kt_begin + it + 1, (it + 1) & 1);
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int stage = it & 1;
    const int k_start = (kt_begin + it) * kBN;
    const bf16* ks = s_k + stage * kBN * L::kQK;
    const bf16* vs = s_v + stage * kBN * L::kV;

    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    flash::mma_abt<DQK, kNT, L::kQK, L::kQK>(s_q + r0 * L::kQK, ks, s, lane);
    flash::mma_abt<DV, kNT, L::kV, L::kV>(s_do + r0 * L::kV, vs, dp, lane);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = k_start + 8 * j + 2 * t4 + (e & 1);
        const float p = kept(key, my_row[r], a) ? exp2f(s[j][e] * scale2 - lse2[r]) : 0.0f;
        s[j][e] = p * (dp[j][e] - dsum[r]);   // dS
      }
    flash::mma_acc_b<kBN, DQK, L::kQK, false>(s, ks, dq, lane);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = my_row[r];
    if (row >= a.s) continue;
    bf16* q_row = a.out + ((static_cast<long long>(bi) * a.s + row) * a.h + hi) * DQK;
#pragma unroll
    for (int n = 0; n < NQ; ++n)
      *reinterpret_cast<uint32_t*>(q_row + 8 * n + 2 * t4) =
          flash::pack_bf16x2(dq[n][2 * r] * a.scale, dq[n][2 * r + 1] * a.scale);
  }
}

// --------------------------------------------------------- backward: dK, dV ----

// o[n] += M[k, m0 .. m0 + 15]^T . B[k, cols 8n .. 8n + 7] summed over k < KD:
// M and B row-major in shared memory (pitches PM, PB), M's columns taken as
// the rows of A through `ldmatrix.trans`. P^T dO, dS^T Q.
template <int KD, int N, int PM, int PB>
__device__ __forceinline__ void mma_at_b(const bf16* ms, const bf16* bs, float (&o)[N / 8][4],
                                         int lane) {
  const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    uint32_t am[4];
    flash::ldsm_x4_trans(am, ms + (kk * 16 + rr + (mi >> 1) * 8) * PM + (mi & 1) * 8);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t b[4];
      flash::ldsm_x4_trans(b, bs + (kk * 16 + rr + (mi & 1) * 8) * PB + np * 16 + (mi >> 1) * 8);
      flash::mma_bf16(o[2 * np], am, b[0], b[1]);
      flash::mma_bf16(o[2 * np + 1], am, b[2], b[3]);
    }
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(256, 1) flash_train_dkdv_kernel(const Args a) {
  using L = Layout<DQK, DV>;
  constexpr int NK = DQK / 16;   // n-tiles of a warp's half of dK's columns
  constexpr int NV = DV / 16;
  extern __shared__ float4 smem4[];
  bf16* s_k = reinterpret_cast<bf16*>(smem4);       // [kBN][kQK]
  bf16* s_v = s_k + kBN * L::kQK;                    // [kBN][kV]
  bf16* s_q = s_v + kBN * L::kV;                     // [2][kBM][kQK]
  bf16* s_do = s_q + 2 * kBM * L::kQK;               // [2][kBM][kV]
  bf16* s_p = s_do + 2 * kBM * L::kV;                // [kBM][kP]
  bf16* s_ds = s_p + kBM * L::kP;                    // [kBM][kP]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kvi = blockIdx.x % a.kv, bi = blockIdx.x / a.kv;
  const int k_start = blockIdx.y * kBN;
  const bf16* k = a.k + bi * a.skb + kvi * a.skh;
  const bf16* v = a.v + bi * a.svb + kvi * a.svh;
  const long long ostride = static_cast<long long>(a.h) * DV;

  // the query tiles that keep a key of this tile: from the diagonal to the
  // end, or to the window's reach
  const int qt_begin = k_start / kBM;
  int qt_end = (a.s + kBM - 1) / kBM;
  if (a.has_window) qt_end = min(qt_end, (k_start + kBN - 1 + a.window + kBM - 1) / kBM);
  const int n_q = qt_end - qt_begin;
  const int n_iter = a.group * n_q;

  auto load_qdo = [&](int it, int stage) {
    const int hq = kvi * a.group + it / n_q;
    const int q0 = (qt_begin + it % n_q) * kBM;
    load_rows<DQK, L::kQK>(s_q + stage * kBM * L::kQK, a.q + bi * a.sqb + hq * a.sqh, a.sqs,
                           q0, kBM, a.s, tid, blockDim.x);
    load_rows<DV, L::kV>(s_do + stage * kBM * L::kV,
                         a.dout + (static_cast<long long>(bi) * a.s * a.h + hq) * DV, ostride,
                         q0, kBM, a.s, tid, blockDim.x);
  };
  load_rows<DQK, L::kQK>(s_k, k, a.skt, k_start, kBN, a.s, tid, blockDim.x);
  load_rows<DV, L::kV>(s_v, v, a.svt, k_start, kBN, a.s, tid, blockDim.x);
  if (n_iter > 0) load_qdo(0, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // phase 1: warp (wm, wn) has query rows 16 wm .. + 15, keys 32 wn .. + 31;
  // phase 2: warp (wk, wc) keys 16 wk .. + 15, the wc-th half of the columns
  const int wm = warp & 3, wn = warp >> 2;
  const int wk = warp & 3, wc = warp >> 2;
  float dk[NK][4], dv[NV][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = 0.0f;
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = 0.0f;
  const float scale2 = a.scale * kLog2e;

  for (int it = 0; it < n_iter; ++it) {
    const int hq = kvi * a.group + it / n_q;
    const int q0 = (qt_begin + it % n_q) * kBM;
    const long long head_row = (static_cast<long long>(bi) * a.h + hq) * a.s;
    int my_row[2];
    float lse2[2], dsum[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      my_row[r] = q0 + wm * 16 + g + 8 * r;
      const bool in = my_row[r] < a.s;
      lse2[r] = in ? a.lse[head_row + my_row[r]] * kLog2e : 0.0f;
      dsum[r] = in ? a.dsum[head_row + my_row[r]] : 0.0f;
    }
    if (it + 1 < n_iter) {
      load_qdo(it + 1, (it + 1) & 1);
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int stage = it & 1;
    const bf16* qs = s_q + stage * kBM * L::kQK;
    const bf16* dos = s_do + stage * kBM * L::kV;

    // phase 1: P and dS of the warp's 16 rows x 32 keys, to shared memory
    {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      flash::mma_abt<DQK, 4, L::kQK, L::kQK>(qs + wm * 16 * L::kQK, s_k + wn * 32 * L::kQK, s,
                                             lane);
      flash::mma_abt<DV, 4, L::kV, L::kV>(dos + wm * 16 * L::kV, s_v + wn * 32 * L::kV, dp,
                                          lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int key = k_start + wn * 32 + 8 * j + 2 * t4 + (e & 1);
          const bool ok = my_row[r] < a.s && kept(key, my_row[r], a);
          p[e] = ok ? exp2f(s[j][e] * scale2 - lse2[r]) : 0.0f;
          ds[e] = p[e] * (dp[j][e] - dsum[r]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int at = (wm * 16 + g + 8 * r) * L::kP + wn * 32 + 8 * j + 2 * t4;
          *reinterpret_cast<uint32_t*>(s_p + at) = flash::pack_bf16x2(p[2 * r], p[2 * r + 1]);
          *reinterpret_cast<uint32_t*>(s_ds + at) = flash::pack_bf16x2(ds[2 * r], ds[2 * r + 1]);
        }
      }
    }
    __syncthreads();
    // phase 2: dV += P^T dO, dK += dS^T Q over the tile's 64 query rows
    mma_at_b<kBM, DV / 2, L::kP, L::kV>(s_p + wk * 16, dos + wc * (DV / 2), dv, lane);
    mma_at_b<kBM, DQK / 2, L::kP, L::kQK>(s_ds + wk * 16, qs + wc * (DQK / 2), dk, lane);
    __syncthreads();   // P, dS and this stage are free before they are refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k_start + wk * 16 + g + 8 * r;
    if (key >= a.s) continue;
    const long long at = (static_cast<long long>(bi) * a.s + key) * a.kv + kvi;
    bf16* dk_row = a.dk + at * DQK + wc * (DQK / 2);
    bf16* dv_row = a.dv + at * DV + wc * (DV / 2);
#pragma unroll
    for (int n = 0; n < NK; ++n)
      *reinterpret_cast<uint32_t*>(dk_row + 8 * n + 2 * t4) =
          flash::pack_bf16x2(dk[n][2 * r] * a.scale, dk[n][2 * r + 1] * a.scale);
#pragma unroll
    for (int n = 0; n < NV; ++n)
      *reinterpret_cast<uint32_t*>(dv_row + 8 * n + 2 * t4) =
          flash::pack_bf16x2(dv[n][2 * r], dv[n][2 * r + 1]);
  }
}

// ---------------------------------------------------------------- launch ----

template <typename Kernel>
cudaError_t start(Kernel kernel, dim3 grid, int threads, size_t bytes, const Args& a,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// pass 0: forward; 1: dQ (and D); 2: dK, dV
template <int DQK, int DV>
cudaError_t launch(int pass, const Args& a, int batch, cudaStream_t stream) {
  using L = Layout<DQK, DV>;
  static_assert(L::dkdv_bytes <= 232448 && L::dq_bytes <= 232448, "shared memory of a block");
  const int tiles = (a.s + kBM - 1) / kBM;
  switch (pass) {
    case 0:
      return start(flash_train_fwd_kernel<DQK, DV>, dim3(batch * a.h, tiles), 128,
                   L::fwd_bytes, a, stream);
    case 1:
      return start(flash_train_dq_kernel<DQK, DV>, dim3(batch * a.h, tiles), 128, L::dq_bytes,
                   a, stream);
    case 2:
      return start(flash_train_dkdv_kernel<DQK, DV>, dim3(batch * a.kv, tiles), 256,
                   L::dkdv_bytes, a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// pass: 0 = forward (q, k, v -> o, lse), 1 = dQ and D (q, k, v, o, dout, lse ->
// dq, dsum), 2 = dK and dV (q, k, v, dout, lse, dsum -> dk, dv); pass 2 reads
// the D that pass 1 wrote. (dqk, dv) one of (64, 64), (128, 128), (192, 128).
// q, k, v strides in elements; o, dout, out, dk, dv, lse, dsum contiguous.
// window is read only when has_window. Returns the launch's cudaError_t.
extern "C" int flash_train_launch(
    int pass, const void* q, const void* k, const void* v, const void* o, const void* dout,
    void* out, void* dk, void* dv, float* lse, float* dsum, int b, int s, int h, int kv,
    long long sqb, long long sqs, long long sqh, long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh, float scale, int has_window, int window,
    int dqk, int dvw, void* stream) {
  if (kv <= 0 || h % kv != 0 || s <= 0 || b <= 0) return cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const bf16*>(o),
               static_cast<const bf16*>(dout), static_cast<bf16*>(out),
               static_cast<bf16*>(dk), static_cast<bf16*>(dv), lse, dsum, s, h, kv, h / kv,
               sqb, sqs, sqh, skb, skt, skh, svb, svt, svh, scale, has_window, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dqk == 64 && dvw == 64) return launch<64, 64>(pass, a, b, st);
  if (dqk == 128 && dvw == 128) return launch<128, 128>(pass, a, b, st);
  if (dqk == 192 && dvw == 128) return launch<192, 128>(pass, a, b, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
