// Per-row entropy, in bits, for Hopper (sm_90a):
//
//     out[v] = - sum_k  s[v,k] * log2 clip(s[v,k])   over s[v,k] > 1e-12
//
// with clip(x) = min(max(x, 1e-12), 1). S [V, K] f32 or bf16 (read as f32),
// out [V] f32. Eq. (8) of the paper over a whole state matrix.
//
// Replaces the Pallas TPU kernel `_entropy_kernel` / `entropy_rows` in
// src/repro/kernels/kl_simplex/kernel.py.
//
// What bounds it on this card: bytes, as for kl_rows.cu: each element of S
// is read once for one log2 and a multiply-add, so the floor is V*K*4 bytes
// over the memory rate; at the paper's K = 100 a launch is launch latency.
//
// What the design does about it: one warp per row, lanes striding over K
// (coalesced 128-byte reads per warp step), shuffle reduction
// (row_reduce.cuh); the loop masks the ragged edge of the row instead of
// padding a copy to 128 lanes as the TPU kernel did.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers and the current stream, and raises on the returned error.
#include "row_reduce.cuh"

namespace {

using namespace kl_simplex;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    entropy_rows_kernel(const T* __restrict__ s, float* __restrict__ out, int v,
                        int k) {
  const long long row = warp_row();
  if (row >= v) return;
  const int lane = threadIdx.x & 31;
  const T* s_row = s + row * k;
  float acc = 0.0f;
  for (int j = lane; j < k; j += 32) {
    const float x = to_float(s_row[j]);
    if (x > kEps) acc += x * log2f(clip_unit(x));
  }
  acc = warp_sum(acc);
  if (lane == 0) out[row] = -acc;
}

template <typename T>
cudaError_t launch(const void* s, float* out, int v, int k, cudaStream_t stream) {
  entropy_rows_kernel<T><<<grid_for(v), kThreads, 0, stream>>>(
      static_cast<const T*>(s), out, v, k);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of S). Returns the launch's cudaError_t.
extern "C" int entropy_rows_launch(const void* s, float* out, int v, int k,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(s, out, v, k, st);
  if (dtype == 1) return launch<__nv_bfloat16>(s, out, v, k, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* entropy_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
