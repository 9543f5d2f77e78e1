// Per-row KL divergence to the target, in bits, for Hopper (sm_90a):
//
//     out[v] = sum_k  s[v,k] * (log2 clip(s[v,k]) - log2 clip(g[k]))   over s[v,k] > 1e-12
//
// with clip(x) = min(max(x, 1e-12), 1). S [V, K] f32 or bf16 (read as f32),
// g [K] f32, out [V] f32. Eq. (9) of the paper over a whole state matrix.
//
// Replaces the Pallas TPU kernel `_kl_kernel` / `kl_rows` in
// src/repro/kernels/kl_simplex/kernel.py.
//
// What bounds it on this card: bytes. Each element of S is read once for a
// handful of f32 operations (two log2, a subtract, a multiply-add), far
// below the card's ~20 operations per byte, so its floor is V*K*4 bytes over
// the memory rate (0.012 us at V = K = 100, 1.25 us at K = 1024); at the
// paper's K = 100 every launch sits at launch latency instead.
//
// What the design does about it: one warp per row, lanes striding over K so
// that a warp reads 128 contiguous bytes (f32) per step, the partial sums
// combined with shuffles (row_reduce.cuh). Any K: the loop masks the ragged
// edge of the row, where the TPU kernel padded a copy of S to 128 lanes.
// g is re-read by every row through the read-only cache; it is K floats.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers and the current stream, and raises on the returned error.
#include "row_reduce.cuh"

namespace {

using namespace kl_simplex;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    kl_rows_kernel(const T* __restrict__ s, const float* __restrict__ g,
                   float* __restrict__ out, int v, int k) {
  const long long row = warp_row();
  if (row >= v) return;
  const int lane = threadIdx.x & 31;
  const T* s_row = s + row * k;
  float acc = 0.0f;
  for (int j = lane; j < k; j += 32) {
    const float x = to_float(s_row[j]);
    if (x > kEps) {
      acc += x * (log2f(clip_unit(x)) - log2f(clip_unit(__ldg(g + j))));
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) out[row] = acc;
}

template <typename T>
cudaError_t launch(const void* s, const float* g, float* out, int v, int k,
                   cudaStream_t stream) {
  kl_rows_kernel<T><<<grid_for(v), kThreads, 0, stream>>>(
      static_cast<const T*>(s), g, out, v, k);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of S). Returns the launch's cudaError_t.
extern "C" int kl_rows_launch(const void* s, const float* g, float* out, int v,
                              int k, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(s, g, out, v, k, st);
  if (dtype == 1) return launch<__nv_bfloat16>(s, g, out, v, k, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* kl_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
