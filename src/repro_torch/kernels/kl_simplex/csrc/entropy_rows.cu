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
// What bounds it on this card: bytes at K = 1024 (V*K*4 bytes of S over the
// memory rate, 1.25 us) and as much the issue of one precise log2f per
// element; the launch floor at the paper's K = 100. What the design does
// about it is in row_stream.cuh, shared with kl_rows.cu: 16-byte loads where
// the rows allow them, a batch of each thread's loads in flight before any
// log2f, warps per row and rows per block picked from V and K, and a
// programmatic dependent launch; the ragged edge of a row is masked where the TPU kernel
// padded a copy of S to 128 lanes.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers and the current stream, and raises on the returned error.
#include "row_stream.cuh"

// dtype: 0 = float32, 1 = bfloat16 (of S). Returns the launch's cudaError_t.
extern "C" int entropy_rows_launch(const void* s, float* out, int v, int k,
                                   int dtype, void* stream) {
  return kl_simplex::row_stream::launch<false>(s, nullptr, out, v, k, dtype,
                                               static_cast<cudaStream_t>(stream));
}

extern "C" const char* entropy_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
