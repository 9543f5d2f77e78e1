// Dense gossip mix for Hopper (sm_90a):   out = W @ X
//
//     W  [K_out, K_in]  f32 row-stochastic mixing matrix (may be rectangular)
//     X  [K_in, P]      stacked flattened models, f32 or bf16, P >> K
//     out[K_out, P]     in X's dtype, accumulated in f32
//
// Replaces the Pallas TPU kernel `_mix_kernel` / `gossip_mix_matmul` in
// src/repro/kernels/gossip_mix/kernel.py, which computes the product inside
// the kernel body; so does this one (no library GEMM).
//
// What bounds it on this card: each X element is read once and each output
// element written once (8 bytes per column and row) for K_in multiply-adds
// per output element, so against the card's memory rate and its f32 FMA rate
// the two limits cross near K = 80: bytes below, f32 operations above (the
// paper's K = 100 sits just on the operations side). The product must hold a
// 1e-5 tolerance against a full-f32 reference, so it runs on the f32 FMA
// pipes, not on the tensor cores in TF32.
//
// What the design does about it: a plain tiled kernel. Each block owns a
// tile of kTileP columns of X, which it reads from device memory exactly
// once into shared memory (converted to f32); W, a few hundred rows at most,
// is staged whole in shared memory beside it, zero-padded along K_in to a
// multiple of 4 so that it is read back as float4. A thread owns one column
// and kRowsPerThread output rows at a time: the W reads are warp-wide
// broadcasts (a warp shares its rows), the X reads are conflict-free, and
// every 16-byte W read feeds four FMAs. The ragged edges (P, K_out, K_in)
// are masked in the kernel. Tensor-core / TMA variants are later work.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers and the current stream, and raises on the returned error.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileP = 64;          // columns of X per block (threadIdx.x)
constexpr int kRowGroups = 8;       // threadIdx.y
constexpr int kRowsPerThread = 8;   // output rows a thread accumulates at once
constexpr int kThreads = kTileP * kRowGroups;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mix_matmul_kernel(const float* __restrict__ w, const T* __restrict__ x,
                      T* __restrict__ out, int k_out, int k_in, int k_in_pad,
                      int p) {
  extern __shared__ float4 smem_raw[];
  float* s_w = reinterpret_cast<float*>(smem_raw);   // [k_out][k_in_pad]
  float* s_x = s_w + static_cast<size_t>(k_out) * k_in_pad;  // [k_in_pad][kTileP]

  const int tid = threadIdx.y * kTileP + threadIdx.x;
  for (int i = tid; i < k_out * k_in_pad; i += kThreads) {
    const int r = i / k_in_pad;
    const int j = i - r * k_in_pad;
    s_w[i] = j < k_in ? w[static_cast<size_t>(r) * k_in + j] : 0.0f;
  }
  const long long col =
      static_cast<long long>(blockIdx.x) * kTileP + threadIdx.x;
  const bool in_cols = col < p;
  for (int j = threadIdx.y; j < k_in_pad; j += kRowGroups) {
    s_x[j * kTileP + threadIdx.x] =
        (j < k_in && in_cols) ? to_float(x[static_cast<size_t>(j) * p + col])
                              : 0.0f;
  }
  __syncthreads();

  const int quads = k_in_pad / 4;
  const float* x_col = s_x + threadIdx.x;
  for (int r0 = threadIdx.y * kRowsPerThread; r0 < k_out;
       r0 += kRowGroups * kRowsPerThread) {
    float acc[kRowsPerThread];
    const float4* w_row[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      acc[i] = 0.0f;
      // rows past K_out re-read the last row; their sums are never stored
      const int r = min(r0 + i, k_out - 1);
      w_row[i] = reinterpret_cast<const float4*>(
          s_w + static_cast<size_t>(r) * k_in_pad);
    }
    for (int q = 0; q < quads; ++q) {
      const float x0 = x_col[(4 * q + 0) * kTileP];
      const float x1 = x_col[(4 * q + 1) * kTileP];
      const float x2 = x_col[(4 * q + 2) * kTileP];
      const float x3 = x_col[(4 * q + 3) * kTileP];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float4 wv = w_row[i][q];
        acc[i] = fmaf(wv.x, x0, acc[i]);
        acc[i] = fmaf(wv.y, x1, acc[i]);
        acc[i] = fmaf(wv.z, x2, acc[i]);
        acc[i] = fmaf(wv.w, x3, acc[i]);
      }
    }
    if (in_cols) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        if (r0 + i < k_out) {
          out[static_cast<size_t>(r0 + i) * p + col] = from_float<T>(acc[i]);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const float* w, const void* x, void* out, int k_out,
                   int k_in, int p, cudaStream_t stream) {
  const int k_in_pad = (k_in + 3) & ~3;
  const size_t smem = (static_cast<size_t>(k_out) * k_in_pad +
                       static_cast<size_t>(k_in_pad) * kTileP) * sizeof(float);
  // above 48 KB a kernel has to opt in to its dynamic shared memory, once
  // per device (the attribute belongs to the device's copy of the kernel)
  constexpr int kMaxDevices = 64;
  static size_t opted_in[kMaxDevices] = {};
  if (smem > 48 * 1024) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    size_t& have = opted_in[device % kMaxDevices];
    if (smem > have) {
      err = cudaFuncSetAttribute(mix_matmul_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      have = smem;
    }
  }
  const dim3 grid((p + kTileP - 1) / kTileP);
  const dim3 block(kTileP, kRowGroups);
  mix_matmul_kernel<T><<<grid, block, smem, stream>>>(
      w, static_cast<const T*>(x), static_cast<T*>(out), k_out, k_in, k_in_pad, p);
  return cudaGetLastError();
}

}  // namespace

// Shared memory the kernel needs for a [k_out, k_in] mixing matrix, in bytes;
// the wrapper holds it against the card's per-block limit before launching.
extern "C" long long gossip_mix_matmul_smem_bytes(int k_out, int k_in) {
  const long long k_in_pad = (k_in + 3) & ~3;
  return (static_cast<long long>(k_out) * k_in_pad + k_in_pad * kTileP) *
         static_cast<long long>(sizeof(float));
}

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t (0 = ok).
extern "C" int gossip_mix_matmul_launch(const float* w, const void* x,
                                        void* out, int k_out, int k_in, int p,
                                        int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(w, x, out, k_out, k_in, p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(w, x, out, k_out, k_in, p, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* gossip_mix_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
