// The per-row math of one exponentiated-gradient step of the P1 solver,
// shared by eg_step.cu (one step per launch) and eg_solve.cu (every step of
// a solve in one launch), so that the two kernels cannot drift apart. For one
// row of alpha, grad and mask, natural logarithms throughout:
//
//     n      = max(sum_k m, 1)                  gbar  = sum_k grad*m / n
//     c      = (grad - gbar) * m                scale = step / max(max_k |c|, 1)
//     logit  = log clip(alpha) - scale*c        where m > 0, else -inf
//     e      = exp(logit - max_k logit)         where m > 0, else 0
//     out    = e * (1 / max(sum_k e, 1e-12))
//
// with clip(x) = min(max(x, 1e-12), 1): a masked softmax, exactly 0 off the
// mask. A row whose mask is all zero gives 0 everywhere, as the TPU kernel
// does: the exp of a lane off the mask (+inf on an empty row, where the
// max is -inf) is replaced by 0, never used.
#pragma once

#include <math_constants.h>

#include "row_reduce.cuh"

namespace kl_simplex {

__device__ __forceinline__ float eg_centered(float g, float gbar, float m) {
  return (g - gbar) * m;
}

__device__ __forceinline__ float eg_logit(float a, float scale, float c) {
  return logf(clip_unit(a)) - scale * c;
}

// One warp updates one row held in registers: lane l holds the row's elements
// l, l + 32, ..., l + 32 (ITEMS - 1), with a = g = m = 0 past the row's end.
// On return a holds the new alpha of those elements; g is overwritten.
template <int ITEMS>
__device__ __forceinline__ void eg_update_row(float (&a)[ITEMS], float (&g)[ITEMS],
                                              const float (&m)[ITEMS], float step) {
  float m_sum = 0.0f, gm_sum = 0.0f;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    m_sum += m[i];
    gm_sum += g[i] * m[i];
  }
  const float n_active = fmaxf(warp_sum(m_sum), 1.0f);
  const float gbar = warp_sum(gm_sum) / n_active;
  float c_max = 0.0f;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    g[i] = eg_centered(g[i], gbar, m[i]);   // g now holds c
    c_max = fmaxf(c_max, fabsf(g[i]));
  }
  const float scale = step / fmaxf(warp_max(c_max), 1.0f);
  // selects, not branches, so that the items' log / exp chains interleave:
  // every logit is finite (clip keeps log above -28), and an exp taken on a
  // lane off the mask is discarded
  float z_max = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    a[i] = eg_logit(a[i], scale, g[i]);   // a now holds the logit
    z_max = m[i] > 0.0f ? fmaxf(z_max, a[i]) : z_max;
  }
  z_max = warp_max(z_max);
  float e_sum = 0.0f;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const float e = expf(a[i] - z_max);
    a[i] = m[i] > 0.0f ? e : 0.0f;        // a now holds e
    e_sum += a[i];
  }
  const float inv_denom = 1.0f / fmaxf(warp_sum(e_sum), kEps);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) a[i] *= inv_denom;
}

}  // namespace kl_simplex
