// Sparse gossip mix on a padded neighbour list, for Hopper (sm_90a):
//
//     out[k, p] = sum_d  w[k, d] * X[idx[k, d], p]
//
// Replaces the Pallas TPU kernel `_gather_mix_kernel` / `gossip_mix_gather`
// in src/repro/kernels/gossip_mix/kernel.py.
//
// What bounds it on this card: bytes. Per output element it does D
// multiply-adds but X is small next to the L2 cache (K_in * P values), so
// after the first touch every gathered row comes from L2 and device memory
// sees each X element once and each output element once.
//
// What the design does about it: one thread block per (block of kRows output
// rows, tile of P). The block first loads its own rows of idx / w into shared
// memory (the TPU version had them scalar-prefetched), then every thread owns
// one 16-byte vector of one output row, walks the D slots accumulating in f32
// registers, and writes its vector once. Loads and stores are 16 bytes a
// thread along P when the row pitch and the base pointers allow it; otherwise
// an element-wise instantiation handles any P and any alignment, so the
// ragged edge of P is masked in the kernel and X is never copied or padded.
// Padding slots carry weight 0 and an in-bounds id, so they add nothing.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers and the current stream, and raises on the returned error.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsP = 128;  // threads along P
constexpr int kRows = 4;        // output rows per block (threadIdx.y)

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

// VEC elements of T per thread: 16 / sizeof(T) on the vector path, 1 otherwise.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreadsP* kRows)
    gather_mix_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                      const T* __restrict__ x, T* __restrict__ out, int k_out,
                      int d, int p) {
  extern __shared__ float4 smem_raw[];
  int* s_idx = reinterpret_cast<int*>(smem_raw);
  float* s_w = reinterpret_cast<float*>(smem_raw) + kRows * d;

  const int row0 = blockIdx.y * kRows;
  const int tid = threadIdx.y * kThreadsP + threadIdx.x;
  // rows are contiguous, so the block's kRows x d slab of idx / w is one run
  for (int i = tid; i < kRows * d; i += kThreadsP * kRows) {
    const bool in_rows = row0 + i / d < k_out;
    s_idx[i] = in_rows ? idx[static_cast<size_t>(row0) * d + i] : 0;
    s_w[i] = in_rows ? w[static_cast<size_t>(row0) * d + i] : 0.0f;
  }
  __syncthreads();

  const int row = row0 + threadIdx.y;
  const long long col =
      (static_cast<long long>(blockIdx.x) * kThreadsP + threadIdx.x) * VEC;
  if (row >= k_out || col >= p) return;

  const int* my_idx = s_idx + threadIdx.y * d;
  const float* my_w = s_w + threadIdx.y * d;
  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;

#pragma unroll 4
  for (int s = 0; s < d; ++s) {
    const float wv = my_w[s];
    const T* src = x + static_cast<size_t>(my_idx[s]) * p + col;
    if constexpr (VEC == 1) {
      acc[0] = fmaf(wv, to_float(src[0]), acc[0]);
    } else {
      const uint4 raw = *reinterpret_cast<const uint4*>(src);
      const T* elems = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = fmaf(wv, to_float(elems[v]), acc[v]);
    }
  }

  T* dst = out + static_cast<size_t>(row) * p + col;
  if constexpr (VEC == 1) {
    dst[0] = from_float<T>(acc[0]);
  } else {
    uint4 raw;
    T* elems = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int v = 0; v < VEC; ++v) elems[v] = from_float<T>(acc[v]);
    *reinterpret_cast<uint4*>(dst) = raw;
  }
}

template <typename T>
cudaError_t launch(const int* idx, const float* w, const void* x, void* out,
                   int k_out, int d, int p, cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const size_t smem = static_cast<size_t>(kRows) * d * (sizeof(int) + sizeof(float));
  const bool vector_ok = p % kVec == 0 &&
                         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 block(kThreadsP, kRows);
  const unsigned grid_y = (k_out + kRows - 1) / kRows;
  if (vector_ok) {
    const long long per_block = static_cast<long long>(kThreadsP) * kVec;
    const dim3 grid(static_cast<unsigned>((p + per_block - 1) / per_block), grid_y);
    gather_mix_kernel<T, kVec><<<grid, block, smem, stream>>>(
        idx, w, static_cast<const T*>(x), static_cast<T*>(out), k_out, d, p);
  } else {
    const dim3 grid((p + kThreadsP - 1) / kThreadsP, grid_y);
    gather_mix_kernel<T, 1><<<grid, block, smem, stream>>>(
        idx, w, static_cast<const T*>(x), static_cast<T*>(out), k_out, d, p);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t (0 = ok).
extern "C" int gossip_mix_gather_launch(const int* idx, const float* w,
                                        const void* x, void* out, int k_out,
                                        int d, int p, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(idx, w, x, out, k_out, d, p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(idx, w, x, out, k_out, d, p, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* gossip_mix_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
