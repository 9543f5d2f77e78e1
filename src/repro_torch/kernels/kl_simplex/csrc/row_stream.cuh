// The row reduction behind kl_rows.cu and entropy_rows.cu, for Hopper
// (sm_90a): out[v] = sum over k of a term of s[v,k] (and, for the KL, of
// log2 clip(g[k])), S [V, K] f32 or bf16 read as f32, out [V] f32.
//
// What bounds them on this card. At K = 1024, bytes by the roofline (S is
// 4 MB: 1.25 us at 3.35 TB/s), but the precise log2f is some 30 instructions
// (a polynomial, no MUFU), so the issue rate of log2f bounds a launch as much
// as the bytes do: about 1 us of issue for the 1M elements over 132 SMs, not
// overlapped with the loads' first arrival. At the paper's K = 100 (40 KB of
// S, 0.012 us of bytes) a launch is launch latency: the time from one queued
// launch to the next. The first design (one warp per row, one 4-byte load per
// lane and step, log2 clip(g) recomputed for every row) kept 128 bytes in
// flight per warp and did two log2f per element of the KL. This one:
//
// * 16-byte loads: a row whose base is 16-byte aligned, whose K is a
//   multiple of 4 (f32) or 8 (bf16) and that has a load for every lane of a
//   warp is read as uint4 packs; anything else (a ragged K, a row slice that
//   starts off a 16-byte boundary, a short row) takes the same kernel with
//   one element per load. The launcher picks per launch.
// * Loads in flight: each thread issues kBatch of its row's loads into
//   registers before any log2f.
// * The mapping (pick_mapping, from V and K): a team of warps_per_row warps
//   walks one row, enough that a thread holds at most kThreadElements of it
//   (the log2f of a thread are a chain of issue slots; more warps share them
//   out), and more while V is too few rows to fill the card, their partial
//   sums meeting in shared memory; a block holds rows_per_block teams, the
//   most that still give every SM a block. V = K = 100 takes 100 blocks of 2
//   warps, V = K = 1024 256 blocks of 4 rows x 2 warps (the KL's staged
//   log2 clip(g) serving 4 rows), V = 64, K = 4096 64 blocks of 16 warps.
// * log2 clip(g), for the KL: each block stages it in shared memory once, so
//   each element of S costs one log2f. g is loaded before S; a thread's first
//   log2 clip(s) are taken before the barrier that publishes the staged
//   values, the terms after it. A K past kStageFloats is walked in chunks of
//   that many columns, all of the block's rows sharing each chunk; the buffer
//   stays under 48 KB (no opt-in to more dynamic shared memory).
// * Programmatic dependent launch: the grid may be set up while the stream's
//   previous kernel finishes (the launch floor of the queued-launch protocol
//   falls from about 2.3 to 1.3 us on an H100); griddepcontrol.wait comes
//   before the first access to global memory, so the kernel reads and writes
//   as in plain stream order.
//
// Precise math, as in row_reduce.cuh (log2f, no --use_fast_math). A term is
// computed for every element and kept where s > 1e-12 (as jnp.where does), so
// the loop does not branch; padding loads read as 0 and add nothing. Rows are
// never padded or copied. This header leaves row_reduce.cuh as its other
// users (eg_step.cu, eg_update.cuh) compile it.
#pragma once

#include <stdint.h>

#include "row_reduce.cuh"

namespace kl_simplex {
namespace row_stream {

constexpr int kBatch = 4;            // loads a thread keeps in flight
constexpr int kMaxWarps = 16;        // warps of a block
constexpr int kStageFloats = 8192;   // log2 clip(g) per staged chunk: 32 KB
constexpr int kThreadElements = 16;  // of its row, a thread holds at most these...
constexpr int kFillWarpsPerSm = 4;   // ...and more warps share a row until the card has these

// The raw bits of one load: 16 bytes on the vector path, one element on the
// scalar one. All-zero bits read as +0.0 in both dtypes.
template <typename T, bool kVec> struct Load;
template <> struct Load<float, true> { using Raw = uint4; static constexpr int kN = 4; };
template <> struct Load<__nv_bfloat16, true> { using Raw = uint4; static constexpr int kN = 8; };
template <> struct Load<float, false> { using Raw = unsigned; static constexpr int kN = 1; };
template <> struct Load<__nv_bfloat16, false> {
  using Raw = unsigned short;
  static constexpr int kN = 1;
};

__device__ __forceinline__ unsigned word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// element i of a load as f32 (a bf16 is the upper half of an f32: exact)
template <typename T, bool kVec> __device__ __forceinline__ float element(
    typename Load<T, kVec>::Raw r, int i);
template <> __device__ __forceinline__ float element<float, true>(uint4 r, int i) {
  return __uint_as_float(word(r, i));
}
template <> __device__ __forceinline__ float element<__nv_bfloat16, true>(uint4 r, int i) {
  const unsigned w = word(r, i >> 1);
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}
template <> __device__ __forceinline__ float element<float, false>(unsigned r, int) {
  return __uint_as_float(r);
}
template <> __device__ __forceinline__ float element<__nv_bfloat16, false>(unsigned short r,
                                                                          int) {
  return __uint_as_float(static_cast<unsigned>(r) << 16);
}

// Loads idx, idx + stride, ... (kBatch of them) of a row into r; those at or
// past `end`, or of a row past V, read as 0.
template <typename Raw>
__device__ __forceinline__ void load_batch(Raw (&r)[kBatch], const Raw* __restrict__ src,
                                           int idx, int end, int stride, bool live) {
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const int j = idx + b * stride;
    r[b] = (live && j < end) ? __ldg(src + j) : Raw{};
  }
}

// The block's loads of g[j0 + b * blockDim.x] (b < kBatch, j < n) into x.
__device__ __forceinline__ void load_g(float (&x)[kBatch], const float* __restrict__ g,
                                       int j0, int n) {
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const int j = j0 + b * blockDim.x;
    if (j >= n) break;
    x[b] = __ldg(g + j);
  }
}

// lg[j] = log2 clip(x[b]) for the same j (no predicated-off log2f).
__device__ __forceinline__ void store_log2(float* lg, const float (&x)[kBatch], int j0, int n) {
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const int j = j0 + b * blockDim.x;
    if (j >= n) break;
    lg[j] = log2f(clip_unit(x[b]));
  }
}

// The shared-memory layout: the partial sums of a block's warps, then the
// staged log2 clip(g) (16-byte aligned: read as float4 on the vector path).
inline size_t smem_bytes(bool kl, int k) {
  const int staged = kl ? (k < kStageFloats ? k : kStageFloats) : 0;
  return sizeof(float) * (kMaxWarps + staged);
}

// lx[b][i] = log2 min(x, 1) for each element x of this thread's loads r
// (indices idx, idx + stride, ... below p1): log2 clip(x) wherever x > 1e-12.
template <typename T, bool kVec>
__device__ __forceinline__ void log2_batch(const typename Load<T, kVec>::Raw (&r)[kBatch],
                                           int idx, int p1, int stride,
                                           float (&lx)[kBatch][Load<T, kVec>::kN]) {
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    if (idx + b * stride >= p1) break;               // this thread's loads end here
#pragma unroll
    for (int i = 0; i < Load<T, kVec>::kN; ++i) {
      lx[b][i] = log2f(fminf(element<T, kVec>(r[b], i), 1.0f));
    }
  }
}

// acc += x (lx - lg) (kKl, lg staged from index p0 on) or x lx, over x > 1e-12.
template <typename T, bool kVec, bool kKl>
__device__ __forceinline__ void add_terms(const typename Load<T, kVec>::Raw (&r)[kBatch],
                                          const float (&lx)[kBatch][Load<T, kVec>::kN],
                                          int idx, int p0, int p1, int stride,
                                          const float* lg, float& acc) {
  constexpr int kN = Load<T, kVec>::kN;
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const int j = idx + b * stride;
    if (j >= p1) break;
    float l[kN];
    if constexpr (kKl) {
      const float* at = lg + (j - p0) * kN;
      if constexpr (kN == 1) {
        l[0] = at[0];
      } else {
#pragma unroll
        for (int q = 0; q < kN; q += 4) {
          const float4 f = *reinterpret_cast<const float4*>(at + q);
          l[q] = f.x; l[q + 1] = f.y; l[q + 2] = f.z; l[q + 3] = f.w;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const float x = element<T, kVec>(r[b], i);
      float term;
      if constexpr (kKl) {
        term = x * (lx[b][i] - l[i]);
      } else {
        term = x * lx[b][i];
      }
      acc += x > kEps ? term : 0.0f;
    }
  }
}

// kKl: out[row] = sum_k s (log2 clip(s) - log2 clip(g)) over s > 1e-12; else
// minus sum_k s log2 clip(s) (the entropy).
template <typename T, bool kVec, bool kKl>
__global__ void __launch_bounds__(32 * kMaxWarps)
    row_kernel(const T* __restrict__ s, const float* __restrict__ g, float* __restrict__ out,
               int v, int k, int rows_per_block, int warps_per_row) {
  using Raw = typename Load<T, kVec>::Raw;
  constexpr int kN = Load<T, kVec>::kN;
  extern __shared__ __align__(16) float smem[];
  float* part = smem;               // [kMaxWarps]
  float* lg = smem + kMaxWarps;     // [min(K, kStageFloats)], the chunk being read
  const int warp = threadIdx.x >> 5;
  const int team = warp / warps_per_row;
  const int stride = 32 * warps_per_row;             // threads of a team
  const int t = threadIdx.x - team * stride;         // thread within the team
  const long long row = static_cast<long long>(blockIdx.x) * rows_per_block + team;
  const bool live = row < v;
  const int packs = k / kN;                          // loads per row
  const Raw* src = reinterpret_cast<const Raw*>(s + (live ? row : 0) * static_cast<long long>(k));
  const int chunk = kKl ? kStageFloats / kN : packs; // loads per staged chunk
  float acc = 0.0f;
  // launched as a programmatic dependent of the stream's previous kernel:
  // nothing global is read or written before that kernel has finished
  asm volatile("griddepcontrol.wait;" ::: "memory");
  // every thread of the block runs the same chunks: the barriers stay uniform
  for (int p0 = 0; p0 < packs; p0 += chunk) {
    const int p1 = packs - p0 < chunk ? packs : p0 + chunk;
    int idx = p0 + t;
    Raw r[kBatch];
    float lx[kBatch][kN];
    if constexpr (kKl) {
      // g first, then S; the first batch's log2 before the barrier that
      // publishes the staged log2 clip(g)
      const float* gc = g + p0 * kN;
      const int n = (p1 - p0) * kN;
      float x[kBatch];
      load_g(x, gc, threadIdx.x, n);
      load_batch(r, src, idx, p1, stride, live);
      if (p0 > 0) __syncthreads();                   // the last chunk is read
      store_log2(lg, x, threadIdx.x, n);
      for (int j0 = threadIdx.x + kBatch * blockDim.x; j0 < n; j0 += kBatch * blockDim.x) {
        load_g(x, gc, j0, n);
        store_log2(lg, x, j0, n);
      }
      log2_batch<T, kVec>(r, idx, p1, stride, lx);
      __syncthreads();
    } else {
      load_batch(r, src, idx, p1, stride, live);
      log2_batch<T, kVec>(r, idx, p1, stride, lx);
    }
    add_terms<T, kVec, kKl>(r, lx, idx, p0, p1, stride, lg, acc);
    while (p1 - idx > kBatch * stride) {
      idx += kBatch * stride;
      load_batch(r, src, idx, p1, stride, live);
      log2_batch<T, kVec>(r, idx, p1, stride, lx);
      add_terms<T, kVec, kKl>(r, lx, idx, p0, p1, stride, lg, acc);
    }
  }
  if constexpr (!kKl) acc = -acc;
  acc = warp_sum(acc);
  if (warps_per_row == 1) {
    if (live && (threadIdx.x & 31) == 0) out[row] = acc;
    return;
  }
  if ((threadIdx.x & 31) == 0) part[warp] = acc;
  __syncthreads();
  if (live && t == 0) {
    acc = 0.0f;
    for (int w = 0; w < warps_per_row; ++w) acc += part[team * warps_per_row + w];
    out[row] = acc;
  }
}

// The launcher's choice: vec (16-byte loads), rows per block, warps per row.
struct Mapping {
  int vec;
  int rows_per_block;
  int warps_per_row;
};

inline int elements_per_16_bytes(int dtype) { return dtype == 0 ? 4 : 8; }

inline bool vector_path(const void* s, int k, int dtype) {
  return reinterpret_cast<uintptr_t>(s) % 16 == 0 && k % elements_per_16_bytes(dtype) == 0;
}

// The SMs of the current device (asked once per device).
inline cudaError_t sm_count(int* sms) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64 && cached[dev] > 0) {
    *sms = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev >= 0 && dev < 64) cached[dev] = *sms;
  return err;
}

// 16-byte loads where the rows allow them and a warp's lanes get one each
// (a shorter row spreads its elements over the lanes one by one). Warps per
// row: enough that a thread holds at most kThreadElements of its row, then
// more while every lane keeps two loads or more and the card holds fewer than
// kFillWarpsPerSm warps per SM (powers of two, up to kMaxWarps). Rows per
// block: the most (a power of two) that still give every SM a block, else 1.
inline Mapping pick_mapping(const void* s, int v, int k, int dtype, int sms) {
  const bool vec = vector_path(s, k, dtype) && k / elements_per_16_bytes(dtype) >= 32;
  const long long packs = vec ? k / elements_per_16_bytes(dtype) : k;
  int p = 1;
  while (p < kMaxWarps && 32LL * kThreadElements * p < k) p *= 2;
  while (p < kMaxWarps && 64LL * p <= packs &&
         static_cast<long long>(v) * p < static_cast<long long>(kFillWarpsPerSm) * sms) {
    p *= 2;
  }
  int r = 1;
  while (2 * r * p <= kMaxWarps && (v + 2LL * r - 1) / (2 * r) >= sms) r *= 2;
  return {vec ? 1 : 0, r, p};
}

// The launch, with the mapping picked for this V, K, dtype and base address,
// as a programmatic dependent launch: the grid may be set up while the
// stream's previous kernel finishes, and waits for it (griddepcontrol.wait)
// before it touches global memory. cudaErrorInvalidValue for an unknown dtype.
template <typename T, bool kVec, bool kKl>
cudaError_t start(const void* s, const float* g, float* out, int v, int k, Mapping m,
                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((v + m.rows_per_block - 1) / m.rows_per_block));
  cfg.blockDim = dim3(32u * m.rows_per_block * m.warps_per_row);
  cfg.dynamicSmemBytes = smem_bytes(kKl, k);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, row_kernel<T, kVec, kKl>, static_cast<const T*>(s), g, out,
                            v, k, m.rows_per_block, m.warps_per_row);
}

template <bool kKl>
cudaError_t launch(const void* s, const float* g, float* out, int v, int k, int dtype,
                   cudaStream_t stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (v <= 0) return cudaSuccess;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const Mapping m = pick_mapping(s, v, k, dtype, sms);
  if (dtype == 0) {
    return m.vec ? start<float, true, kKl>(s, g, out, v, k, m, stream)
                 : start<float, false, kKl>(s, g, out, v, k, m, stream);
  }
  return m.vec ? start<__nv_bfloat16, true, kKl>(s, g, out, v, k, m, stream)
               : start<__nv_bfloat16, false, kKl>(s, g, out, v, k, m, stream);
}

}  // namespace row_stream
}  // namespace kl_simplex
