// Forward-only blocked online-softmax attention for Hopper (sm_90a):
//
//     o[b,i,h,:] = sum_j softmax_j(scale * q[b,i,h,:] . k[b,j,h/G,:]) * v[b,j,h/G,:]
//
// over the keys j kept by the mask: j < T, plus j <= i when causal, plus
// j > i - window when a window is set. q [B, S, H, hd], k/v [B, T, KV, hd]
// with G = H / KV (GQA: q-head h reads kv-head h / G), read in place through
// their strides (the last stride is 1); o [B, S, H, hd] contiguous, in q's
// dtype. f32 or bf16 in; every product, sum and the running max /
// denominator / accumulator in f32. A query row with no kept key gives 0
// (the Pallas kernel's max(l, 1e-30) denominator).
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py.
//
// What bounds it on this card: operations. A causal prefill does
// 4 * B * H * hd * S(S+1)/2 f32 operations on O(S * hd) bytes per head
// (at B=4, S=T=2048, H=16, KV=8, hd=128: 6.9e10 operations against 50 MB),
// hundreds of operations per byte: at the 67 TFLOP/s of f32 outside the
// tensor cores its floor is 1.03 ms.
//
// What the design does about it (a first, plain design; see "Later" below):
// * One block of 128 threads per (64-query tile, b * H + h). The kv loop runs
//   inside the block, where the TPU walked a sequential third grid axis.
//   Blocks start from the last query tile, which under a causal mask has the
//   most key tiles.
// * The q tile and each k tile sit in shared memory transposed ([hd][rows],
//   converted to f32), the v tile row-major, so that the two products are
//   register-blocked outer products as in an SGEMM: a thread owns 4 query
//   rows x BK/8 keys of the score tile and the same 4 rows x hd/8 columns of
//   the output; per step of the inner loop it reads one 16-byte vector of q
//   (or p) and BK/32 (or hd/32) vectors of k (or v) and does 32 (or 64) FMAs.
//   The interleaved column order (chunk * 32 + tx * 4) keeps those reads free
//   of bank conflicts.
// * The running max, denominator and accumulator stay in registers: the
//   thread that computes a row's scores is the one that owns its output
//   columns, so the rescale factor never leaves the thread. Row max and row
//   sum are shuffles over the 8 threads of a row.
// * Tiles wholly outside the causal or window band are not visited (the
//   loop bounds), as `pl.when(run)` skips them; the test for a window is the
//   reference's `k_start + BK - 1 > q_start - window`.
// * Masked scores are the finite sentinel -1e30, and p is selected to 0 by
//   the mask itself, so a tile with no kept key gives exp(-1e30 - (-1e30))
//   = 1 as the rescale factor and never NaN.
// * Ragged edges (S, T not multiples of the tile) are masked on load, with no
//   padded copy. hd is a template parameter (16, 32, 64, 128); the key tile
//   is BK = 32 rows at every hd: shared memory is 78 KB at hd = 128 (two
//   blocks per SM), so the launcher opts in above 48 KB. A second key tile
//   comes back only with a measured gain on a path that runs it.
//
// Later (a redesign, not this kernel): bf16 `mma`/`wgmma` on the tensor
// cores (989 TFLOP/s; the f32 tolerance of 2e-5 would not survive TF32),
// TMA loads into a ring of tiles, and one kv tile shared by the G q-heads of
// a GQA group.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers, strides and the current stream, and raises on the
// returned error.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // 16 row groups x 8 column groups
constexpr int kBQ = 64;         // query rows per block: 16 x 4
constexpr int kQPitch = kBQ + 4;
constexpr int BK = 32;          // key rows per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int s, t, h, group;
  long long sqb, sqs, sqh;   // strides of q (elements), last stride 1
  long long skb, skt, skh;
  long long svb, svt, svh;
  float scale;
  int causal;
  int has_window;
  int window;
};

template <int HD>
constexpr int smem_floats() {
  return HD * kQPitch + HD * (BK + 4) + BK * HD + BK * kQPitch;
}

// VEC contiguous floats from shared memory (VEC = 4 or 2, aligned to it)
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(const Args a) {
  constexpr int kKPitch = BK + 4;
  constexpr int NJ = BK / 8;            // scores per thread and row
  constexpr int NC = HD / 8;            // output columns per thread and row
  constexpr int VEC = NC >= 4 ? 4 : 2;  // output columns per shared-memory read
  constexpr int CH = NC / VEC;
  static_assert(BK % 32 == 0 && NC % VEC == 0, "tile shape");

  extern __shared__ float4 smem4[];
  float* q_t = reinterpret_cast<float*>(smem4);   // [HD][kBQ + 4]
  float* k_t = q_t + HD * kQPitch;                // [HD][BK + 4]
  float* v_s = k_t + HD * kKPitch;                // [BK][HD]
  float* p_t = v_s + BK * HD;                     // [BK][kBQ + 4]

  const int tid = threadIdx.x;
  const int tx = tid & 7;    // column group; the 8 threads of a row group are lanes
  const int ty = tid >> 3;   // row group: rows ty * 4 .. ty * 4 + 3 of the tile
  const int q_start = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int bi = blockIdx.y / a.h;
  const int hi = blockIdx.y % a.h;
  const int kvi = hi / a.group;

  const T* q = static_cast<const T*>(a.q) + bi * a.sqb + hi * a.sqh;
  const T* k = static_cast<const T*>(a.k) + bi * a.skb + kvi * a.skh;
  const T* v = static_cast<const T*>(a.v) + bi * a.svb + kvi * a.svh;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int row = q_start + r;
    q_t[d * kQPitch + r] = row < a.s ? to_float(q[row * a.sqs + d]) : 0.0f;
  }

  // the key tiles that hold a kept key for some row of this query tile
  int kt_end = (a.t + BK - 1) / BK;
  if (a.causal) kt_end = min(kt_end, (q_start + kBQ - 1) / BK + 1);
  int kt_begin = 0;
  if (a.has_window) {
    const int first = q_start - a.window + 1;   // the oldest key row q_start keeps
    if (first > 0) kt_begin = first / BK;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_start = kt * BK;
    __syncthreads();   // the last tile's readers are done (and q_t is staged)
    for (int e = tid; e < BK * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      const int key = k_start + r;
      const bool in = key < a.t;
      k_t[d * kKPitch + r] = in ? to_float(k[key * a.skt + d]) : 0.0f;
      v_s[r * HD + d] = in ? to_float(v[key * a.svt + d]) : 0.0f;
    }
    __syncthreads();

    // scores of rows ty*4+i, keys (j/4)*32 + tx*4 + j%4
    float sc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[NJ];
      load_vec<4>(q_t + d * kQPitch + ty * 4, qv);
#pragma unroll
      for (int c = 0; c < NJ / 4; ++c) load_vec<4>(k_t + d * kKPitch + c * 32 + tx * 4, kv + c * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q_start + ty * 4 + i;
      unsigned kept = 0;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int k_pos = k_start + (j / 4) * 32 + tx * 4 + (j % 4);
        const bool ok = k_pos < a.t && (!a.causal || k_pos <= q_pos) &&
                        (!a.has_window || k_pos > q_pos - a.window);
        kept |= static_cast<unsigned>(ok) << j;
        sc[i][j] = ok ? sc[i][j] * a.scale : kNegInf;
        row_max = fmaxf(row_max, sc[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = ((kept >> j) & 1u) ? expf(sc[i][j] - m_new) : 0.0f;
        row_sum += p;
        p_t[((j / 4) * 32 + tx * 4 + (j % 4)) * kQPitch + ty * 4 + i] = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = alpha * l[i] + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += p v on rows ty*4+i, columns ch * 8 * VEC + tx * VEC + e
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[NC];
      load_vec<4>(p_t + j * kQPitch + ty * 4, pv);
#pragma unroll
      for (int ch = 0; ch < CH; ++ch)
        load_vec<VEC>(v_s + j * HD + ch * 8 * VEC + tx * VEC, vv + ch * VEC);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_start + ty * 4 + i;
    if (row >= a.s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o_row = o + ((static_cast<long long>(bi) * a.s + row) * a.h + hi) * HD;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o_row[ch * 8 * VEC + tx * VEC + e] = from_float<T>(acc[i][ch * VEC + e] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + kBQ - 1) / kBQ, batch * a.h);
  flash_attention_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(a);
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

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o). Strides in elements.
// window is read only when has_window. Returns the launch's cudaError_t.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int b, int s, int t,
    int h, int kv, long long sqb, long long sqs, long long sqh, long long skb,
    long long skt, long long skh, long long svb, long long svt, long long svh,
    float scale, int causal, int has_window, int window, int hd, int dtype, void* stream) {
  if (kv <= 0 || h % kv != 0) return cudaErrorInvalidValue;
  const Args a{q, k, v, o, s, t, h, h / kv, sqb, sqs, sqh, skb, skt, skh,
               svb, svt, svh, scale, causal, has_window, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(a, b, hd, st);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(a, b, hd, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
