// Grouped (ragged) matrix products for Hopper (sm_90a), on group offsets that
// live on the device:
//
//   grouped_mm:        y[r, :] = x[r, :] @ B_e      for offsets[e] <= r < offsets[e+1]
//                      B_e = w[e] ([E, K, N]) or w[e]^T (trans_w, w [E, N, K]);
//                      rows in no group are 0
//   grouped_mm_wgrad:  dw[e] = x[rows of e]^T @ dy[rows of e]   ([E, K, N]; 0 for an
//                      empty group)
//
// x, w, dy f32 or bf16, read as f32; every sum is taken in full f32 (FMA, no
// TF32); outputs in the inputs' dtype. offsets is [E + 1] int32 on the device,
// non-decreasing: no group size is read on the host.
//
// Replaces no Pallas kernel: it is the port of `jax.lax.ragged_dot`, which the
// reference's sorted MoE dispatch (`moe_ragged`, src/repro/models/moe.py)
// leaves to XLA. The forward is grouped_mm; the gradient of x is grouped_mm
// again with the transpose flag flipped (no transposed copy of w), the
// gradient of w is grouped_mm_wgrad.
//
// What bounds it on this card: operations. At the MoE's prefill shapes (M =
// 16,384 rows, K = 1,024, N = 512 for granite-moe; M = 4,096, K = 4,096,
// N = 14,336 for mixtral) each product does 2*M*K*N flops on M*K + E*K*N +
// M*N elements: hundreds to thousands of operations per byte, far above the
// f32 ridge point. In decode (M = B * top_k rows) it reads the whole weight
// stack for a few rows and is bound by bytes, or by launch latency.
//
// What the design does about it: a simple, right kernel first. A block owns a
// 64 x 64 output tile of ONE group and walks the reduction in slices of 16
// through shared memory (both operands staged as f32), 256 threads, each
// keeping a 4 x 4 block of sums in registers; a thread's rows and columns are
// 16 apart, so its shared-memory reads fall on distinct banks and its stores
// coalesce. The grid is group-major and sized without knowing the group
// sizes: (row tiles of M, column tiles of N, E + 1). Block (t, c, e) reads
// offsets[e], offsets[e+1] and takes the group's rows t*64 .. t*64+63, or
// exits at once where the group has fewer; the last slice (e = E) writes the
// zeros of the rows that lie in no group. No tile straddles a group, and in
// decode (a few rows over many experts) every touched expert's tiles run in
// parallel instead of one after another. wgrad gives a block one (K, N)
// tile of one expert and walks that expert's rows. CUDA cores only (f32 FMA,
// 67 TFLOP/s peak): the tensor cores (TF32 would break the f32 contract;
// bf16 wgmma for the bf16 variant) are later work.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers and the current stream, and raises on the returned error.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // output rows and columns of a block
constexpr int kSlice = 16;    // reduction depth staged per step
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPad = 4;       // keeps the staged rows off each other's banks

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ long long clamp_rows(long long r, long long lo, long long hi) {
  return r < lo ? lo : (r > hi ? hi : r);
}

template <typename T, bool kTrans>
__global__ void __launch_bounds__(kThreads)
    grouped_mm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const int* __restrict__ offsets, T* __restrict__ y, int m, int k,
                      int n, int num_groups) {
  __shared__ float a_s[kSlice][kTile + kPad];   // a_s[kk][row]
  __shared__ float b_s[kSlice][kTile + kPad];   // b_s[kk][col]
  const int e = blockIdx.z;
  const int c0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  if (e == num_groups) {
    // the rows in no group, [0, offsets[0]) and [offsets[E], M): zeros
    const long long first = clamp_rows(offsets[0], 0, m);
    const long long last = clamp_rows(offsets[num_groups], first, m);
    const long long r0 = static_cast<long long>(blockIdx.x) * kTile;
    const long long r_end = r0 + kTile < m ? r0 + kTile : m;
    if (r0 >= first && r_end <= last) return;
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
      const long long r = r0 + i / kTile;
      const int c = c0 + i % kTile;
      if (r < r_end && c < n && (r < first || r >= last)) y[r * n + c] = from_float<T>(0.0f);
    }
    return;
  }
  const long long lo = clamp_rows(offsets[e], 0, m);
  const long long hi = clamp_rows(offsets[e + 1], lo, m);
  const long long r0 = lo + static_cast<long long>(blockIdx.x) * kTile;
  if (r0 >= hi) return;                         // the group has fewer row tiles
  const long long r_end = r0 + kTile < hi ? r0 + kTile : hi;
  const T* we = w + static_cast<long long>(e) * k * n;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += kSlice) {
    for (int i = threadIdx.x; i < kTile * kSlice; i += kThreads) {
      const int row = i / kSlice, kk = i % kSlice;
      const long long gr = r0 + row;
      const int gk = k0 + kk;
      a_s[kk][row] = (gr < r_end && gk < k) ? to_float(x[gr * k + gk]) : 0.0f;
    }
    for (int i = threadIdx.x; i < kTile * kSlice; i += kThreads) {
      int kk, col;
      if (kTrans) { col = i / kSlice; kk = i % kSlice; }   // w[e] is [N, K]
      else        { kk = i / kTile;  col = i % kTile; }    // w[e] is [K, N]
      const int gk = k0 + kk, gc = c0 + col;
      float v = 0.0f;
      if (gk < k && gc < n) {
        v = to_float(kTrans ? we[static_cast<long long>(gc) * k + gk]
                            : we[static_cast<long long>(gk) * n + gc]);
      }
      b_s[kk][col] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlice; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gr = r0 + ty + 16 * i;
    if (gr >= r_end) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = c0 + tx + 16 * j;
      if (gc < n) y[gr * n + gc] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    grouped_mm_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                            const int* __restrict__ offsets, T* __restrict__ dw, int m,
                            int k, int n) {
  __shared__ float a_s[kSlice][kTile + kPad];   // a_s[rr][i]: x rows, K columns
  __shared__ float b_s[kSlice][kTile + kPad];   // b_s[rr][j]: dy rows, N columns
  const int i0 = blockIdx.x * kTile, j0 = blockIdx.y * kTile, e = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long lo = clamp_rows(offsets[e], 0, m);
  const long long hi = clamp_rows(offsets[e + 1], lo, m);
  float acc[4][4] = {};
  for (long long r0 = lo; r0 < hi; r0 += kSlice) {
    for (int t = threadIdx.x; t < kTile * kSlice; t += kThreads) {
      const int rr = t / kTile, c = t % kTile;
      const long long gr = r0 + rr;
      a_s[rr][c] = (gr < hi && i0 + c < k) ? to_float(x[gr * k + i0 + c]) : 0.0f;
      b_s[rr][c] = (gr < hi && j0 + c < n) ? to_float(dy[gr * n + j0 + c]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kSlice; ++rr) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[rr][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[rr][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  T* out = dw + static_cast<long long>(e) * k * n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = i0 + ty + 16 * i;
    if (gi >= k) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = j0 + tx + 16 * j;
      if (gj < n) out[static_cast<long long>(gi) * n + gj] = from_float<T>(acc[i][j]);
    }
  }
}

inline unsigned tiles(long long extent) {
  return static_cast<unsigned>((extent + kTile - 1) / kTile);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const int* offsets, void* y, int m,
                   int k, int n, int num_groups, int trans_w, cudaStream_t stream) {
  const dim3 grid(tiles(m), tiles(n), num_groups + 1);
  if (trans_w) {
    grouped_mm_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), offsets, static_cast<T*>(y),
        m, k, n, num_groups);
  } else {
    grouped_mm_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), offsets, static_cast<T*>(y),
        m, k, n, num_groups);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgrad(const void* x, const void* dy, const int* offsets, void* dw,
                         int m, int k, int n, int num_groups, cudaStream_t stream) {
  const dim3 grid(tiles(k), tiles(n), num_groups);
  grouped_mm_wgrad_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), offsets, static_cast<T*>(dw),
      m, k, n);
  return cudaGetLastError();
}

}  // namespace

// y [m, n] = grouped x [m, k] @ w (w [E, k, n], or [E, n, k] with trans_w).
// dtype: 0 = float32, 1 = bfloat16 (of x, w and y). Returns the launch's
// cudaError_t. Needs m >= 1, n >= 1, num_groups >= 1 (the wrapper sees to it).
extern "C" int grouped_mm_launch(const void* x, const void* w, const int* offsets, void* y,
                                 int m, int k, int n, int num_groups, int trans_w,
                                 int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, offsets, y, m, k, n, num_groups, trans_w, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, offsets, y, m, k, n, num_groups, trans_w, st);
  return cudaErrorInvalidValue;
}

// dw [E, k, n] = per group x[rows]^T @ dy[rows] (x [m, k], dy [m, n]).
// Needs k >= 1, n >= 1, num_groups >= 1.
extern "C" int grouped_mm_wgrad_launch(const void* x, const void* dy, const int* offsets,
                                       void* dw, int m, int k, int n, int num_groups,
                                       int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_wgrad<float>(x, dy, offsets, dw, m, k, n, num_groups, st);
  if (dtype == 1)
    return launch_wgrad<__nv_bfloat16>(x, dy, offsets, dw, m, k, n, num_groups, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* grouped_mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
