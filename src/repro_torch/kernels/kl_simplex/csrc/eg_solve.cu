// The whole P1 solve in one launch, for Hopper (sm_90a): every
// exponentiated-gradient step of a P1 solve, one block per row of alpha. A
// block r stages its own D candidate rows of the states, a [D, K] matrix
// S_r, beside its target g_r [K] and its 0/1 contact mask m_r [D] (f32), and
// gives alpha_r [D] f32:
//
//     alpha_0 = m_r / max(sum_j m_r[j], 1)
//     repeat num_steps times:
//       u     = max(alpha @ S_r, 1e-12)                    [K]
//       grad  = (log u - log max(g_r, 1e-12) + 1) @ S_r^T  [D]
//       alpha = the EG update of (alpha, grad, m_r) (eg_update.cuh)
//
// The same iteration as the loop ref.eg_iterate of
// src/repro_torch/kernels/kl_simplex/ref.py (over eg_step.cu on the card),
// with the two products in full f32 on the CUDA cores (no TF32). A row whose
// mask is all zero gives 0, by the TPU kernel's rule.
//
// One entry, on an id table (eg_solve_rows_launch): states [S, N, K] (S seeds
// of N rows, folded into one [S * N, K] array), ids [S, R, D] int32 (or none:
// the identity, row j of its seed's N), targets [S, K] and masks [S, R, D].
// Block b = s * R + r stages rows s * N + ids[s, r, j] of the states and
// reads target row s, so a seed axis costs no copy (no repeat of the
// targets, no offset ids). core/kl_solver.py solves every layout on it:
// neighbour lists (ids = SparseContacts.idx, whose padding slots carry the
// row's own id with mask 0: staged, and given alpha 0, as the loop's gather
// does) and dense contacts (no ids), with a seed axis or without.
//
// Replaces the reference's fused P1 loop (src/repro/kernels/kl_simplex/ops.py)
// over the Pallas TPU kernel `_eg_step_kernel` / `eg_step` in
// src/repro/kernels/kl_simplex/kernel.py, and on the card the loop of
// ref.eg_iterate (about nine device events a step: eg_step, the two products
// and the elementwise ops between them): one launch for the whole solve.
//
// What bounds it on this card: neither bytes nor operations but the chain of
// dependent steps. At the paper's D = K = 100 a step is 2 x 10^4 FMAs per row
// (2 x 10^6 for all rows, 0.06 us at the f32 FMA rate; 12 us for 200 steps),
// and S, g and the mask are read once and alpha written once (0.12 MB).
// Issued as a loop of small launches it costs a launch latency and some nine
// device events per step. Here a step is a chain of four phases, each ended by a block
// barrier: the u product, log u, the grad product and one warp's row update
// (four dependent warp reductions, a log, an exp and three divisions). On an
// H100 at 700 W that chain takes 5,100 cycles at K = 100 (u 1,300, log u
// 350, grad 1,150, update 2,300) and 3,300 at K = 8, most of it latency
// (scripts/torch_profile_eg_solve.py prints the split, with and without ids). On
// neighbour lists (D = D_max, a tenth of K) the products shrink with D and
// the update does not: 3,750 cycles on the [100, 11] ids of a K = 100
// contact stream (u 440, log u 340, grad 750, update 2,200), not D / K of
// the dense chain.
//
// What the design does about it: one block of 256 threads per row of alpha
// for the whole solve. Rows are independent, so blocks never wait for each
// other (at R = 100, 100 blocks on 132 SMs: one wave, no grid-wide barrier).
// The block stages its S into shared memory once (`cp.async`, 16 bytes at a
// time where the rows are 16-byte aligned, else 4; through the id table, one
// row per id), with 0 in the pad columns and log g beside it. Both products
// read S 16 bytes a lane, and S's pitch is a
// multiple of 4 floats with an odd number of 16-byte chunks, so that both
// directions are free of bank conflicts:
// * u = alpha[v] @ S: lanes on neighbouring 16-byte chunks of a row of S,
//   warps over S's rows (two at a time, for independent loads); the eight
//   warps' partial sums meet in shared memory.
// * grad = r @ S^T: a lane per row of S (32 rows a warp: 8 lanes of a
//   quarter-warp read 8 rows, all 32 banks), summing its row over a slice of
//   the chunks against r read as a broadcast; no shuffles. With fewer than
//   eight groups of 32 rows the chunks are split between warps, and warp 0
//   adds the slices.
// Warp 0 keeps the row's alpha and mask in registers across all steps and
// applies the EG update with the warp-level code eg_step.cu uses (selects, not
// branches, so that the items' log / exp chains overlap). Four block barriers
// per step. The first design (4-byte reads, grad by warp shuffles, the
// update with branches) took 0.82 ms per 200-step solve at K = 100; this one
// 0.52 ms (chip_smoke.py). The id table adds a read of the row's id to each
// staged chunk (from L1 after the first) and leaves the step loop as it was;
// with no table and one seed the launcher takes the dense instantiation (a
// template flag), which reads neither ids nor seed offsets: at K = 100 it
// takes 0.496 ms a solve where the table form takes 0.503 (CUDA events, one
// call). On the ids of a K = 100 contact stream a solve takes 0.37 ms
// against 55 ms of the plain loop (chip_smoke.py).
//
// Why it does not serve every shape: a block's S has to fit its shared
// memory (D x K x 4 bytes plus rows of length K and D: up to D = K = 234 in
// the H100's 227 KB; at K = 1,024 up to D = 46), and a row's lanes keep
// ceil(max(D, K) / 32) <= 32 values in registers (D, K <= 1024). The
// library reports the limit (eg_solve_fits / eg_solve_max_k); past it
// core/kl_solver.py runs the loop of ref.eg_iterate: cuBLAS f32 products
// plus one eg_step launch per step. At
// the scale sweep's dense K = 1024, S is 4 MB: streamed from L2 by each of
// 1,024 blocks for both products it would move 8 GB a step, where the
// library's two products read it about twice.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers and the current stream, and raises on the returned error.
#include <stdint.h>

#include "eg_update.cuh"

namespace {

using namespace kl_simplex;

constexpr int kWarps = 8;                   // warps per block (one row of alpha)
constexpr int kBlockThreads = 32 * kWarps;
constexpr int kMaxItems = 32;               // values per lane: D, K <= 1024
constexpr int kMaxDim = 32 * kMaxItems;

__host__ __device__ __forceinline__ int pitch4(int n) { return (n + 3) & ~3; }

// S's row pitch: a multiple of 4 floats (16-byte rows) with an odd number of
// 16-byte chunks, so that 8 lanes reading 16 bytes each from 8 rows hit all
// 32 banks once
__host__ __device__ __forceinline__ int s_pitch(int k) {
  const int p = pitch4(k);
  return (p / 4) % 2 == 1 ? p : p + 4;
}

// The grad product's column slices: ceil(d / 32) groups of 32 rows, each
// split over this many warps (1 from eight groups on).
__host__ __device__ __forceinline__ int grad_splits(int d) {
  const int groups = (d + 31) / 32;
  return groups >= kWarps ? 1 : kWarps / groups;
}

size_t solve_smem_bytes(int d, int k) {
  // u partial sums [kWarps][pitch4 k], r and log g [pitch4 k], alpha and the
  // grad slices [1 + splits][pitch4 d], S [d][s_pitch k]
  const size_t ldk = pitch4(k), ldd = pitch4(d);
  return sizeof(float) * ((kWarps + 2) * ldk + (1 + grad_splits(d)) * ldd +
                          static_cast<size_t>(d) * s_pitch(k));
}

bool fits(int d, int k, int limit) {
  return d >= 1 && k >= 1 && d <= kMaxDim && k <= kMaxDim &&
         solve_smem_bytes(d, k) <= static_cast<size_t>(limit);
}

// the shared memory a block may opt in to on the current device
cudaError_t smem_limit(int* bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float w, const float4& x, float4& acc) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}

// kRows: states of `rows_n` rows per seed, `ids` per block (the identity
// where null), a target per seed of `rows_r` blocks; else one seed's states,
// rows 0..d-1, and its target (the dense form, which reads neither)
template <int ITEMS, bool kRows>
__global__ void __launch_bounds__(kBlockThreads)
    eg_solve_kernel(const float* __restrict__ states, const int* __restrict__ ids,
                    const float* __restrict__ target, const float* __restrict__ mask,
                    float* __restrict__ out, int rows_r, int rows_n, int d, int k,
                    int num_steps, float step) {
  constexpr int kQuads = (ITEMS + 3) / 4;   // 16-byte column chunks per lane
  extern __shared__ float4 smem_raw[];
  const int ldk = pitch4(k), ldd = pitch4(d), ld = s_pitch(k);
  const int splits = grad_splits(d);
  float* s_upart = reinterpret_cast<float*>(smem_raw);   // [kWarps][ldk]
  float* s_r = s_upart + kWarps * ldk;                   // [ldk]: log u - log g + 1
  float* s_log_g = s_r + ldk;                            // [ldk]
  float* s_alpha = s_log_g + ldk;                        // [ldd]
  float* s_gpart = s_alpha + ldd;                        // [splits][ldd]
  float* s_s = s_gpart + splits * ldd;                   // [d][ld]

  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // the id-table form: this block's seed, its ids and its seed's target
  const long long seed = kRows ? row / rows_r : 0;
  const int* id_row = kRows && ids != nullptr ? ids + row * d : nullptr;
  if (kRows) target += seed * k;
  // row j of this block's S: the states row it stages
  auto source_row = [&](int j) -> size_t {
    if (!kRows) return static_cast<size_t>(j);
    return static_cast<size_t>(seed * rows_n + (id_row != nullptr ? id_row[j] : j));
  };

  // S into shared memory, once; the pad columns of S and r are 0, so that
  // 16-byte reads past column k add nothing
  if (k % 4 == 0 && reinterpret_cast<uintptr_t>(states) % 16 == 0) {
    const int quads = k / 4;
    for (int i = tid; i < d * quads; i += kBlockThreads) {
      const int j = i / quads;
      const int c = (i - j * quads) * 4;
      cp_async16(s_s + j * ld + c, states + source_row(j) * k + c);
    }
  } else {
    for (int i = tid; i < d * k; i += kBlockThreads) {
      const int j = i / k;
      const int c = i - j * k;
      cp_async4(s_s + j * ld + c, states + source_row(j) * k + c);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const int pad = ld - k;
  for (int i = tid; i < d * pad; i += kBlockThreads) {
    const int j = i / pad;
    s_s[j * ld + k + (i - j * pad)] = 0.0f;
  }
  for (int c = tid; c < ldk; c += kBlockThreads) {
    s_log_g[c] = c < k ? logf(fmaxf(target[c], kEps)) : 0.0f;
    s_r[c] = 0.0f;
  }

  // warp 0 holds the row's mask and alpha for the whole solve
  float a[ITEMS], m[ITEMS], g[ITEMS];
  if (warp == 0) {
    const float* m_row = mask + row * d;
    float m_sum = 0.0f;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = lane + 32 * i;
      m[i] = j < d ? m_row[j] : 0.0f;
      m_sum += m[i];
    }
    const float n_active = fmaxf(warp_sum(m_sum), 1.0f);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = lane + 32 * i;
      a[i] = m[i] / n_active;
      if (j < d) s_alpha[j] = a[i];
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // this warp's share of the grad product: 32 rows x a slice of the 16-byte
  // column chunks
  const int groups = (d + 31) / 32;
  const int chunks = (k + 3) / 4;
  const int slice = (chunks + splits - 1) / splits;

  for (int t = 0; t < num_steps; ++t) {
    // u = alpha[v] @ S: lanes on neighbouring 16-byte chunks of a row, warp w
    // over S's rows w, w + kWarps, ..., two at a time
    float4 acc[kQuads];
#pragma unroll
    for (int q = 0; q < kQuads; ++q) acc[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int j = warp;
    for (; j + kWarps < d; j += 2 * kWarps) {
      const float a0 = s_alpha[j], a1 = s_alpha[j + kWarps];
      const float* r0 = s_s + j * ld;
      const float* r1 = r0 + kWarps * ld;
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const int c = 4 * (lane + 32 * q);
        if (c < k) {
          const float4 x0 = lds4(r0 + c), x1 = lds4(r1 + c);
          fma4(a0, x0, acc[q]);
          fma4(a1, x1, acc[q]);
        }
      }
    }
    if (j < d) {
      const float aj = s_alpha[j];
      const float* r0 = s_s + j * ld;
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const int c = 4 * (lane + 32 * q);
        if (c < k) fma4(aj, lds4(r0 + c), acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const int c = 4 * (lane + 32 * q);
      if (c < k) *reinterpret_cast<float4*>(s_upart + warp * ldk + c) = acc[q];
    }
    __syncthreads();
    for (int c = tid; c < k; c += kBlockThreads) {
      float u = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) u += s_upart[w * ldk + c];
      s_r[c] = logf(fmaxf(u, kEps)) - s_log_g[c] + 1.0f;
    }
    __syncthreads();

    // grad = r @ S^T: a lane per row of S over its warp's slice of chunks, r
    // read as a broadcast
    for (int unit = warp; unit < groups * splits; unit += kWarps) {
      const int jj = (unit % groups) * 32 + lane;
      const int q0 = (unit / groups) * slice;
      const int q1 = min(chunks, q0 + slice);
      if (jj < d) {
        const float* s_row = s_s + jj * ld;
        float4 dot = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int q = q0; q < q1; ++q) {
          const float4 x = lds4(s_row + 4 * q), r = lds4(s_r + 4 * q);
          dot.x = fmaf(r.x, x.x, dot.x);
          dot.y = fmaf(r.y, x.y, dot.y);
          dot.z = fmaf(r.z, x.z, dot.z);
          dot.w = fmaf(r.w, x.w, dot.w);
        }
        s_gpart[(unit / groups) * ldd + jj] = (dot.x + dot.y) + (dot.z + dot.w);
      }
    }
    __syncthreads();

    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int jj = lane + 32 * i;
        float sum = 0.0f;
#pragma unroll
        for (int sp = 0; sp < kWarps; ++sp) {
          if (jj < d && sp < splits) sum += s_gpart[sp * ldd + jj];
        }
        g[i] = sum;
      }
      eg_update_row<ITEMS>(a, g, m, step);
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int jj = lane + 32 * i;
        if (jj < d) s_alpha[jj] = a[i];
      }
    }
    __syncthreads();
  }

  if (warp == 0) {
    float* o_row = out + row * d;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = lane + 32 * i;
      if (j < d) o_row[j] = a[i];
    }
  }
}

template <int ITEMS, bool kRows>
cudaError_t launch(const float* s, const int* ids, const float* g, const float* m,
                   float* out, int blocks, int r, int n, int d, int k, int num_steps,
                   float step, cudaStream_t stream) {
  const size_t smem = solve_smem_bytes(d, k);
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
      err = cudaFuncSetAttribute(eg_solve_kernel<ITEMS, kRows>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      have = smem;
    }
  }
  eg_solve_kernel<ITEMS, kRows><<<blocks, kBlockThreads, smem, stream>>>(
      s, ids, g, m, out, r, n, d, k, num_steps, step);
  return cudaGetLastError();
}

// the instantiation for max(d, k): ceil(max / 32) values per lane, rounded up
// to a power of two
template <bool kRows>
cudaError_t launch_items(const float* s, const int* ids, const float* g, const float* m,
                         float* out, int blocks, int r, int n, int d, int k,
                         int num_steps, float step, cudaStream_t st) {
  const int items = ((d > k ? d : k) + 31) / 32;
  if (items <= 1)
    return launch<1, kRows>(s, ids, g, m, out, blocks, r, n, d, k, num_steps, step, st);
  if (items <= 2)
    return launch<2, kRows>(s, ids, g, m, out, blocks, r, n, d, k, num_steps, step, st);
  if (items <= 4)
    return launch<4, kRows>(s, ids, g, m, out, blocks, r, n, d, k, num_steps, step, st);
  if (items <= 8)
    return launch<8, kRows>(s, ids, g, m, out, blocks, r, n, d, k, num_steps, step, st);
  if (items <= 16)
    return launch<16, kRows>(s, ids, g, m, out, blocks, r, n, d, k, num_steps, step, st);
  return launch<kMaxItems, kRows>(s, ids, g, m, out, blocks, r, n, d, k, num_steps, step,
                                  st);
}

}  // namespace

// Shared memory one block takes for a [d, k] state matrix, in bytes.
extern "C" long long eg_solve_smem_bytes(int d, int k) {
  return static_cast<long long>(solve_smem_bytes(d, k));
}

// Whether a [d, k] state matrix fits one block on the current device:
// *fits = 1 or 0. Returns a cudaError_t (0 = ok).
extern "C" int eg_solve_fits(int d, int k, int* fits_out) {
  int limit = 0;
  const cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  *fits_out = fits(d, k, limit) ? 1 : 0;
  return cudaSuccess;
}

// The largest n for which an [n, n] state matrix fits one block on the
// current device. Returns a cudaError_t (0 = ok).
extern "C" int eg_solve_max_k(int* n_out) {
  int limit = 0;
  const cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  int n = kMaxDim;
  while (n > 0 && !fits(n, n, limit)) --n;
  *n_out = n;
  return cudaSuccess;
}

// One launch of num_steps >= 0 EG steps: states
// [seeds, n, k], ids [seeds, r, d] int32 in [0, n) or null (the identity:
// d <= n), target [seeds, k], mask [seeds, r, d] -> out [seeds, r, d], all
// f32 but ids and contiguous, seeds, r >= 1. Block s * r + v stages rows
// s * n + ids[s, v, :] of the states; with no ids and one seed, the dense
// instantiation stages rows 0..d-1. Returns the launch's cudaError_t
// (0 = ok); cudaErrorInvalidValue for a shape that does not fit
// (eg_solve_fits) or a grid past its limit. The ids are not checked here.
extern "C" int eg_solve_rows_launch(const float* states, const int* ids, const float* target,
                                    const float* mask, float* out, int seeds, int r, int n,
                                    int d, int k, int num_steps, float step, void* stream) {
  int limit = 0;
  const cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(seeds) * r;
  if (seeds < 1 || r < 1 || n < 1 || num_steps < 0 || !fits(d, k, limit) ||
      blocks > 0x7fffffffLL || (ids == nullptr && d > n))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ids == nullptr && seeds == 1)
    return launch_items<false>(states, nullptr, target, mask, out, r, r, n, d, k, num_steps,
                               step, st);
  return launch_items<true>(states, ids, target, mask, out, static_cast<int>(blocks), r, n, d,
                            k, num_steps, step, st);
}

extern "C" const char* eg_solve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
