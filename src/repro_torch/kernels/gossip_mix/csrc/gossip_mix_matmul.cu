// Dense gossip mix for Hopper (sm_90a), one launch over a group of leaves:
//
//     out_l[s] = W[s] @ X_l[s]    for every leaf l of the group, every seed s
//
//     W    [S, K_out, K_in]  f32 row-stochastic mixing matrices (may be
//                            rectangular), one per seed
//     X_l  [S, K_in, P_l]    one flattened parameter leaf, f32 or bf16 (one
//                            dtype per launch), P_l from 1 to ~10^5
//     out_l[S, K_out, P_l]   in X's dtype, accumulated in f32
//
// S = 1 is the single federation; S > 1 is run_seeds' seed axis, all seeds in
// the same launch (blockIdx.z is the seed; each seed's W, X and out are
// contiguous slabs, so a block only offsets its three pointers). A
// block-diagonal [S*K, S*K] product would do S times the work and stage S
// times the W rows.
//
// Replaces the Pallas TPU kernel `_mix_kernel` / `gossip_mix_matmul` in
// src/repro/kernels/gossip_mix/kernel.py, which computes the product inside
// the kernel body; so does this one (no library GEMM). The Pallas function
// takes one [K_in, P] array; a group of one leaf is that function.
//
// What bounds it on this card: each X element is read once and each output
// element written once (8 bytes per column and row in f32) for K_in
// multiply-adds per output element, so against the card's memory rate and
// its f32 FMA rate the two limits cross near K = 80 (the paper's K = 100 sits
// just on the operations side: one round's mix of the 21,840-parameter CNN is
// 4.4e8 operations, 6.5 us, against 17.5 MB, 5.2 us). The product must hold a
// 1e-5 tolerance against a full-f32 reference, so it runs on the f32 FMA
// pipes, not on the tensor cores in TF32. At that size what costs most is not
// the arithmetic but the shape: the CNN's eight leaves are 10 to 16,000
// columns wide, and one launch per leaf pays eight launch latencies, most of
// them for a block or two of work.
//
// What the design does about it:
// * One launch per group. The wrapper passes the group as a table by value in
//   the kernel's parameters (LeafTable, under 2 KB: per leaf the input and
//   output pointers, P, and its first column tile, which the launcher below
//   lays out from P and kBN), so no host-to-device copy and no concatenated
//   buffer are needed. A group of more than kMaxLeaves leaves is split by the
//   wrapper into ceil(n / kMaxLeaves) launches.
// * The grid walks (column tile, row tile) over every leaf's tiles: blockIdx.x
//   is a column tile of the whole group (each leaf owns ceil(P_l / kBN) of
//   them), blockIdx.y a tile of kBM output rows. At K = 100 the CNN's round is
//   345 column tiles x 1 row tile: one wave over the 132 SMs, three blocks
//   each.
// * A block stages one row tile of W ([min(kBM, K_out), kc], f32) and one
//   column tile of X ([kc, kBN], in X's dtype) in shared memory (65.6 KB at
//   K = 100 in f32: three blocks per SM), kc <= kKC rows of K_in at a
//   time (one pass at K = 100; a loop over K_in chunks beyond kKC, so no W is
//   too large). X rows go in with 16-byte `cp.async` copies where the leaf's
//   rows are 16-byte aligned, and with masked scalar loads at the ragged
//   edge and for unaligned leaves; W rows the same way. The K_in chunk is
//   zero-padded to a multiple of 4 so that W is read back as float4.
// * Each of the 256 threads accumulates an 8 x 4 register block (8 output rows
//   x 4 adjacent columns) with f32 FMAs: per 4 steps of K_in it reads 8
//   16-byte vectors of W (the same for the 16 threads of a row group:
//   broadcasts) and 4 of X (conflict-free), for 128 FMAs: shared memory, not
//   the FMA pipes, is what the product waits on. Warps whose rows all lie
//   past K_out skip the product.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers and the current stream, and raises on the returned error.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 64;   // leaves per launch (the table's size)
constexpr int kBM = 128;         // output rows per block
constexpr int kBN = 64;          // columns per block
constexpr int kKC = 128;         // rows of K_in staged at once
constexpr int kRows = 8;         // output rows per thread
constexpr int kThreads = 256;    // 16 row groups x 16 column groups, kRows x 4 each

struct LeafTable {
  const void* x[kMaxLeaves];
  void* out[kMaxLeaves];
  long long p[kMaxLeaves];
  int tile_begin[kMaxLeaves + 1];   // first column tile of each leaf; [n] = total
  int n;
};

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

// four adjacent elements of a shared-memory X row, as floats
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// three blocks per SM (at most 80 registers a thread): the K = 100 round is
// then one wave, 9 % faster than at the compiler's own 118 registers
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
    mix_matmul_grouped_kernel(const __grid_constant__ LeafTable table,
                              const float* __restrict__ w, int k_out, int k_in) {
  const long long seed = blockIdx.z;
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte copy
  const int kc_max = min(k_in, kKC);
  const int kc_pad_max = (kc_max + 3) & ~3;
  const int w_rows = min(k_out, kBM);   // rows of W staged per block
  extern __shared__ float4 smem_raw[];
  float* s_w = reinterpret_cast<float*>(smem_raw);                 // [w_rows][kc_pad]
  T* s_x = reinterpret_cast<T*>(s_w + w_rows * kc_pad_max);        // [kc_pad][kBN]

  // the leaf that owns this column tile
  const int tile = blockIdx.x;
  int leaf = 0;
  while (leaf + 1 < table.n && tile >= table.tile_begin[leaf + 1]) ++leaf;
  const long long p = table.p[leaf];
  const long long col0 = static_cast<long long>(tile - table.tile_begin[leaf]) * kBN;
  const T* x = static_cast<const T*>(table.x[leaf]) + seed * k_in * p;
  T* out = static_cast<T*>(table.out[leaf]) + seed * k_out * p;
  w += seed * k_out * k_in;
  const int row0 = blockIdx.y * kBM;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) % 16 == 0) && ((p * sizeof(T)) % 16 == 0);
  const bool w_aligned = (reinterpret_cast<uintptr_t>(w) % 16 == 0) && (k_in % 4 == 0);

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // columns tx*4 .. tx*4+3
  const int ty = tid >> 4;   // rows ty*kRows .. ty*kRows + kRows-1
  // a warp owns row groups 2w, 2w+1: rows 2w*kRows .. (2w+2)*kRows-1 of the tile
  const bool warp_has_rows = row0 + (tid >> 5) * 2 * kRows < k_out;

  float acc[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k_in; k0 += kKC) {
    const int kc = min(kKC, k_in - k0);
    const int kc_pad = (kc + 3) & ~3;
    if (k0 > 0) __syncthreads();   // the last chunk's readers are done
    // W rows [row0, row0 + w_rows) x K_in [k0, k0 + kc_pad), 4 floats at a
    // time, zero past the edges
    const int quads = kc_pad / 4;
    for (int i = tid; i < w_rows * quads; i += kThreads) {
      const int r = i / quads;
      const int j = (i - r * quads) * 4;
      const int row = row0 + r;
      float* dst = s_w + r * kc_pad + j;
      const float* src = w + static_cast<size_t>(row) * k_in + k0 + j;
      if (w_aligned && row < k_out && j + 4 <= kc) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = (row < k_out && j + e < kc) ? src[e] : 0.0f;
      }
    }
    // X rows [k0, k0 + kc_pad) x columns [col0, col0 + kBN)
    constexpr int kChunks = kBN / kVec;   // 16-byte chunks per tile row
    for (int i = tid; i < kc_pad * kChunks; i += kThreads) {
      const int j = i / kChunks;
      const int c = (i - j * kChunks) * kVec;
      T* dst = s_x + j * kBN + c;
      const long long col = col0 + c;
      const T* src = x + static_cast<long long>(k0 + j) * p + col;
      if (j < kc && aligned && col + kVec <= p) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          dst[e] = (j < kc && col + e < p) ? src[e] : from_float<T>(0.0f);
      }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    if (warp_has_rows) {
      // rows past the staged ones (past K_out) re-read the last; never stored
      const float* w_row[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        w_row[i] = s_w + min(ty * kRows + i, w_rows - 1) * kc_pad;
      const T* x_cols = s_x + tx * 4;
      for (int q = 0; q < kc_pad; q += 4) {
        float4 wv[kRows], xv[4];
#pragma unroll
        for (int i = 0; i < kRows; ++i) wv[i] = load4(w_row[i] + q);
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = load4(x_cols + (q + j) * kBN);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float wr[4] = {wv[i].x, wv[i].y, wv[i].z, wv[i].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][0] = fmaf(wr[j], xv[j].x, acc[i][0]);
            acc[i][1] = fmaf(wr[j], xv[j].y, acc[i][1]);
            acc[i][2] = fmaf(wr[j], xv[j].z, acc[i][2]);
            acc[i][3] = fmaf(wr[j], xv[j].w, acc[i][3]);
          }
        }
      }
    }
  }

  if (!warp_has_rows) return;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = row0 + ty * kRows + i;
    if (row >= k_out) break;
    T* o = out + static_cast<long long>(row) * p;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long col = col0 + tx * 4 + j;
      if (col < p) o[col] = from_float<T>(acc[i][j]);
    }
  }
}

size_t smem_bytes(int k_out, int k_in, int esize) {
  const size_t kc_pad = (static_cast<size_t>(k_in < kKC ? k_in : kKC) + 3) & ~size_t{3};
  const size_t w_rows = k_out < kBM ? k_out : kBM;
  return w_rows * kc_pad * sizeof(float) + kc_pad * kBN * esize;
}

template <typename T>
cudaError_t launch(const LeafTable& table, const float* w, int seeds, int k_out,
                   int k_in, cudaStream_t stream) {
  const size_t smem = smem_bytes(k_out, k_in, sizeof(T));
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
      err = cudaFuncSetAttribute(mix_matmul_grouped_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      have = smem;
    }
  }
  const dim3 grid(table.tile_begin[table.n], (k_out + kBM - 1) / kBM, seeds);
  mix_matmul_grouped_kernel<T><<<grid, kThreads, smem, stream>>>(table, w, k_out, k_in);
  return cudaGetLastError();
}

}  // namespace

// Leaves per launch: a group of more leaves takes ceil(n / this) launches.
extern "C" int gossip_mix_matmul_max_leaves() { return kMaxLeaves; }

// Shared memory one block takes for a [k_out, k_in] W and X in dtype (0 =
// float32, 1 = bfloat16), in bytes (at most 96 KB: K_in is staged in chunks).
extern "C" long long gossip_mix_matmul_smem_bytes(int k_out, int k_in, int dtype) {
  return static_cast<long long>(smem_bytes(k_out, k_in, dtype == 0 ? 4 : 2));
}

// One launch over 1 <= n <= kMaxLeaves leaves, all of one dtype (0 =
// float32, 1 = bfloat16), for 1 <= seeds <= 65535 seeds: w [seeds, k_out,
// k_in], x[i] [seeds, k_in, p[i]] -> out[i] [seeds, k_out, p[i]], all
// contiguous, every p[i] >= 1. The column tiles of the grid are laid out
// here. Returns the launch's cudaError_t (0 = ok); cudaErrorInvalidValue for
// arguments the kernel does not take or a grid past its limits.
extern "C" int gossip_mix_matmul_grouped_launch(
    const float* w, const void* const* x, void* const* out, const long long* p,
    int n, int seeds, int k_out, int k_in, int dtype, void* stream) {
  if (n < 1 || n > kMaxLeaves || k_out < 1 || k_in < 1) return cudaErrorInvalidValue;
  if (seeds < 1 || seeds > 65535) return cudaErrorInvalidValue;        // grid z
  if ((k_out + kBM - 1) / kBM > 65535) return cudaErrorInvalidValue;   // grid y
  LeafTable table = {};
  long long tiles = 0;
  for (int i = 0; i < n; ++i) {
    if (p[i] < 1 || p[i] >= (1LL << 31)) return cudaErrorInvalidValue;
    table.x[i] = x[i];
    table.out[i] = out[i];
    table.p[i] = p[i];
    table.tile_begin[i] = static_cast<int>(tiles);
    tiles += (p[i] + kBN - 1) / kBN;
    if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;   // grid x
  }
  table.tile_begin[n] = static_cast<int>(tiles);
  table.n = n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(table, w, seeds, k_out, k_in, s);
  if (dtype == 1) return launch<__nv_bfloat16>(table, w, seeds, k_out, k_in, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* gossip_mix_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
