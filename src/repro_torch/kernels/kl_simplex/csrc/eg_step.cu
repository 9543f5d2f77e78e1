// One exponentiated-gradient step of the P1 solver per row, for Hopper
// (sm_90a): alpha, grad, mask [V, K] (f32 or bf16, read as f32) -> out [V, K]
// f32. The per-row math (a masked softmax, exactly 0 off the mask, and 0 on a
// row whose mask is all zero, as the TPU kernel gives; its plain version,
// like the reference's eg_step_ref, gives NaN there) is in eg_update.cuh,
// shared with eg_solve.cu.
//
// Replaces the Pallas TPU kernel `_eg_step_kernel` / `eg_step` in
// src/repro/kernels/kl_simplex/kernel.py, where `step_size` was a
// compile-time constant; here it is an argument.
//
// What bounds it on this card: bytes. Three [V, K] inputs are read and one
// written once (16 bytes per element) for some twenty f32 operations, one
// log and one exp among them: 0.05 us at V = K = 100, 5 us at K = 1024. At the
// paper's K = 100 every launch sits at launch latency; the P1 solve launches
// it once per EG step, where the shape is too large for eg_solve.cu.
//
// What the design does about it: one warp per row, and the row's five
// reductions (two sums, two maxima, one sum) as shuffles (row_reduce.cuh).
// Up to K = 1024 a lane keeps its ceil(K/32) elements of alpha, grad and mask
// in registers (a template on that count), so each input is read from
// memory once and the output written once. Longer rows take a streaming
// variant that walks the row once per reduction and reads it again from L1
// / L2. Both mask the ragged edge of the row in the kernel; nothing is
// padded or copied.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers and the current stream, and raises on the returned error.
#include "eg_update.cuh"

namespace {

using namespace kl_simplex;

constexpr int kMaxItems = 32;   // elements per lane held in registers: K <= 1024

template <typename T, int ITEMS>
__global__ void __launch_bounds__(kThreads)
    eg_step_registers(const T* __restrict__ alpha, const T* __restrict__ grad,
                      const T* __restrict__ mask, float* __restrict__ out, int v,
                      int k, float step) {
  const long long row = warp_row();
  if (row >= v) return;
  const int lane = threadIdx.x & 31;
  const long long base = row * k;
  float a[ITEMS], g[ITEMS], m[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = lane + 32 * i;
    const bool in_row = j < k;
    a[i] = in_row ? to_float(alpha[base + j]) : 0.0f;
    g[i] = in_row ? to_float(grad[base + j]) : 0.0f;
    m[i] = in_row ? to_float(mask[base + j]) : 0.0f;
  }
  eg_update_row<ITEMS>(a, g, m, step);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = lane + 32 * i;
    if (j < k) out[base + j] = a[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    eg_step_streaming(const T* __restrict__ alpha, const T* __restrict__ grad,
                      const T* __restrict__ mask, float* __restrict__ out, int v,
                      int k, float step) {
  const long long row = warp_row();
  if (row >= v) return;
  const int lane = threadIdx.x & 31;
  const T* a_row = alpha + row * k;
  const T* g_row = grad + row * k;
  const T* m_row = mask + row * k;
  float* o_row = out + row * k;

  float m_sum = 0.0f, gm_sum = 0.0f;
  for (int j = lane; j < k; j += 32) {
    const float m = to_float(m_row[j]);
    m_sum += m;
    gm_sum += to_float(g_row[j]) * m;
  }
  const float n_active = fmaxf(warp_sum(m_sum), 1.0f);
  const float gbar = warp_sum(gm_sum) / n_active;

  float c_max = 0.0f;
  for (int j = lane; j < k; j += 32) {
    c_max = fmaxf(c_max, fabsf(eg_centered(to_float(g_row[j]), gbar,
                                           to_float(m_row[j]))));
  }
  const float scale = step / fmaxf(warp_max(c_max), 1.0f);

  float z_max = -CUDART_INF_F;
  for (int j = lane; j < k; j += 32) {
    const float m = to_float(m_row[j]);
    if (m > 0.0f) {
      z_max = fmaxf(z_max, eg_logit(to_float(a_row[j]), scale,
                                    eg_centered(to_float(g_row[j]), gbar, m)));
    }
  }
  z_max = warp_max(z_max);

  float e_sum = 0.0f;
  for (int j = lane; j < k; j += 32) {
    const float m = to_float(m_row[j]);
    if (m > 0.0f) {
      e_sum += expf(eg_logit(to_float(a_row[j]), scale,
                             eg_centered(to_float(g_row[j]), gbar, m)) - z_max);
    }
  }
  const float inv_denom = 1.0f / fmaxf(warp_sum(e_sum), kEps);

  for (int j = lane; j < k; j += 32) {
    const float m = to_float(m_row[j]);
    float e = 0.0f;
    if (m > 0.0f) {
      e = expf(eg_logit(to_float(a_row[j]), scale,
                        eg_centered(to_float(g_row[j]), gbar, m)) - z_max);
    }
    o_row[j] = e * inv_denom;   // as eg_update_row
  }
}

template <typename T, int ITEMS>
void launch_registers(const void* a, const void* g, const void* m, float* out,
                      int v, int k, float step, cudaStream_t stream) {
  eg_step_registers<T, ITEMS><<<grid_for(v), kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(g),
      static_cast<const T*>(m), out, v, k, step);
}

template <typename T>
cudaError_t launch(const void* a, const void* g, const void* m, float* out,
                   int v, int k, float step, cudaStream_t stream) {
  const int items = (k + 31) / 32;
  if (items <= 1) {
    launch_registers<T, 1>(a, g, m, out, v, k, step, stream);
  } else if (items <= 2) {
    launch_registers<T, 2>(a, g, m, out, v, k, step, stream);
  } else if (items <= 4) {
    launch_registers<T, 4>(a, g, m, out, v, k, step, stream);
  } else if (items <= 8) {
    launch_registers<T, 8>(a, g, m, out, v, k, step, stream);
  } else if (items <= 16) {
    launch_registers<T, 16>(a, g, m, out, v, k, step, stream);
  } else if (items <= kMaxItems) {
    launch_registers<T, kMaxItems>(a, g, m, out, v, k, step, stream);
  } else {
    eg_step_streaming<T><<<grid_for(v), kThreads, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(g),
        static_cast<const T*>(m), out, v, k, step);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of alpha, grad and mask alike). Returns
// the launch's cudaError_t (0 = ok).
extern "C" int eg_step_launch(const void* alpha, const void* grad,
                              const void* mask, float* out, int v, int k,
                              float step, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(alpha, grad, mask, out, v, k, step, st);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(alpha, grad, mask, out, v, k, step, st);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* eg_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
