// Dense gossip mix for Hopper (sm_90a), one launch over a group of leaves:
//
//     out_l[s] = W[s] @ X_l[s]    for every leaf l of the group, every seed s
//
//     W    [S, K_out, K_in]  f32 row-stochastic mixing matrices (may be
//                            rectangular), one per seed
//     X_l  [S, K_in, P_l]    one flattened parameter leaf, f32 or bf16 (one
//                            dtype per launch)
//     out_l[S, K_out, P_l]   in X's dtype, accumulated in f32; may be X_l
//                            itself (in place) under the column mapping below
//
// S = 1 is the single federation; S > 1 is run_seeds' seed axis, all seeds in
// the same launch (each seed's W, X and out are contiguous slabs, so a block
// only offsets its three pointers). A block-diagonal [S*K, S*K] product would
// do S times the work and stage S times the W rows.
//
// Replaces the Pallas TPU kernel `_mix_kernel` / `gossip_mix_matmul` in
// src/repro/kernels/gossip_mix/kernel.py, which computes the product inside
// the kernel body; so does this one (no library GEMM). The Pallas function
// takes one [K_in, P] array; a group of one leaf is that function.
//
// Two mappings, chosen in the launcher from K_out
// (gossip_mix_matmul_path() says which one a shape gets):
//
// 1. Tiles (K_out > kSmallKMax): the federation's K = 100. Per output element
//    K_in multiply-adds against 8 bytes moved (f32), so against the card's
//    memory rate and its f32 FMA rate the two limits cross near K = 80 (K =
//    100 sits just on the operations side: one round's mix of the
//    21,840-parameter CNN is 4.4e8 operations, 6.5 us, against 17.5 MB, 5.2
//    us). The product must hold a 1e-5 tolerance against a full-f32
//    reference, so it runs on the f32 FMA pipes, not on the tensor cores in
//    TF32. At that size what costs most is the shape: the CNN's eight leaves
//    are 10 to 16,000 columns wide, and one launch per leaf pays eight launch
//    latencies, most of them for a block or two of work. So:
//    * One launch per group. The wrapper passes the group as a table by value
//      in the kernel's parameters (LeafTable, under 2 KB: per leaf the input
//      and output pointers, P, and its first column tile, which the launcher
//      lays out from P and kBN), so no host-to-device copy and no
//      concatenated buffer are needed. A group of more than kMaxLeaves leaves
//      is split by the wrapper into ceil(n / kMaxLeaves) launches.
//    * The grid walks (column tile, row tile) over every leaf's tiles:
//      blockIdx.x is a column tile of the whole group (each leaf owns
//      ceil(P_l / kBN) of them), blockIdx.y a tile of kBM output rows,
//      blockIdx.z the seed. At K = 100 the CNN's round is 345 column tiles x
//      1 row tile: one wave over the 132 SMs, three blocks each.
//    * A block stages one row tile of W ([min(kBM, K_out), kc], f32) and one
//      column tile of X ([kc, kBN], in X's dtype) in shared memory (65.6 KB
//      at K = 100 in f32: three blocks per SM), kc <= kKC rows of K_in at a
//      time (a loop over K_in chunks beyond kKC, so no W is too large). X
//      rows go in with 16-byte `cp.async` copies where the leaf's rows are
//      16-byte aligned, and with masked scalar loads at the ragged edge and
//      for unaligned leaves; W rows the same way, zero-padded to a multiple
//      of 4 so that W is read back as float4.
//    * Each of the 256 threads accumulates an 8 x 4 register block (8 output
//      rows x 4 adjacent columns) with f32 FMAs: per 4 steps of K_in it reads
//      8 16-byte vectors of W (broadcasts) and 4 of X (conflict-free), for 128
//      FMAs: shared memory, not the FMA pipes, is what the product waits on.
//      Warps whose rows all lie past K_out skip the product.
//
// 2. Column streaming (K_out <= kSmallKMax): the transformer train round's
//    few vehicles (K = 2 over qwen3-1.7b's 2.03e9 columns) and the small
//    federations (the smoke campaign's K = 8, a per-shard [8, 2] block).
//    Bound by bytes, far from the FMA rate: at K = 2 it does 2 multiply-adds
//    per 8 bytes moved. The tile mapping wastes that shape (at K_out = 2 a
//    block stages 2 x 64 floats, 15 of its 16 row groups hold no row, and the
//    grid is 31.7 M blocks of 512 bytes in and out). So:
//    * Each thread owns kU 16-byte chunks of columns (4 f32 or 8 bf16 values)
//      for EVERY output row: it reads the K_in input rows of its chunks,
//      accumulates KO x kVec outputs per chunk in f32 registers (KO = K_out
//      rounded up to 2, 4, 8 or 16: one instantiation each, rows past K_out
//      weighted 0 and never stored) and writes them once. Neighbouring
//      threads take neighbouring chunks, so each load and store of a warp is
//      512 contiguous bytes.
//    * W lives in shared memory transposed, [K_in chunk][KO] f32, read back
//      as float2 / float4 broadcasts; staged once per seed when K_in <=
//      kSmallKC, once per K_in chunk of a tile past it (any K_in streams).
//    * Persistent: a grid of (SMs x resident blocks) blocks strides over the
//      (seed, tile) items of the whole group, a tile being kSmallThreads x kU
//      chunks of one leaf. A block finds its leaf by walking the table
//      forward from the previous tile's leaf (the tiles it takes only grow
//      within a seed): once per tile, not a scan per block. Tile indices and
//      column offsets are 64-bit (qwen3's stack is within 5 % of 2^31
//      columns, and seed x row x P products pass it).
//    * Bytes in flight: kU 16-byte loads per row of K_in, four rows unrolled,
//      per thread, and several blocks per SM: 82-86 % of the bytes bound at
//      K = 2 in f32 with plain vector loads (76 % in bf16), so no TMA ring.
//    * A leaf whose base pointers and rows are not 16-byte aligned takes the
//      element-wise path over the same chunks (masked at P's edge).
//    * In place: a thread reads every input row of its columns before it
//      writes any output row of them, and no other thread touches those
//      columns, so out_l may be X_l itself when K_out == K_in. The launcher
//      takes out[i] == x[i] under this mapping only; any other overlap of an
//      output with an input or another output is refused.
//    Crossover (chip_smoke.py's kernels phase times the launcher's mapping
//    against the tiles, reached by padding W with zero rows to K_out = 17, per
//    K and dtype; numbers in PERF.md): past the L2 the column mapping wins at
//    every K_out from 1 to 16, and at qwen3's train round (K = 2, 2.03e9
//    columns) it takes 11.3 ms where the tiles took 148 ms. On the MNIST
//    CNN's 21,840 L2-warm columns both are bound by the launch, and there the
//    tiles win by a few us a round (not profiled; likely because a persistent
//    grid of 12 to 27 blocks, each staging W before its loads, hides less
//    than 345 tile blocks overlap).
//    The limit stays at kSmallKMax = 16 and the rule reads K_out alone: the
//    train round's in-place mix needs the columns, and a dense federation of
//    16 or fewer CNNs pays those few us per round (an accepted regression
//    against the tiles; ROADMAP.md section C).
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
// the column-streaming mapping
constexpr int kSmallKMax = 16;       // largest K_out it takes (registers: KO x kVec x kU)
constexpr int kSmallThreads = 256;   // threads per block
constexpr int kSmallKC = 256;        // rows of K_in staged at once

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

// ------------------------------------------------ column-streaming mapping ----

struct SmallTable {
  const void* x[kMaxLeaves];
  void* out[kMaxLeaves];
  long long p[kMaxLeaves];
  long long tile_begin[kMaxLeaves + 1];   // first tile of each leaf; [n] = total
  int n;
};

// 16-byte chunks a thread owns per tile (kU): up to 4, while kU x KO x kVec
// f32 accumulators stay at 32; 1 where KO x kVec alone passes that (64
// accumulators, 128 for bf16 at KO = 16)
template <typename T, int KO>
__host__ __device__ constexpr int small_unroll() {
  constexpr int per_chunk = KO * (16 / static_cast<int>(sizeof(T)));
  return per_chunk >= 32 ? 1 : (32 / per_chunk > 4 ? 4 : 32 / per_chunk);
}

__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack16(const uint4& v, float (&f)[8]) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&words[i]);
    f[2 * i] = __low2float(h);
    f[2 * i + 1] = __high2float(h);
  }
}
__device__ __forceinline__ uint4 pack16(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack16(const float (&f)[8]) {
  uint32_t words[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    words[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(words[0], words[1], words[2], words[3]);
}

// row j's KO weights, staged as s_w[j * KO + r]
template <int KO>
__device__ __forceinline__ void w_column(const float* s_w, int j, float (&wj)[KO]) {
  if constexpr (KO == 2) {
    const float2 v = *reinterpret_cast<const float2*>(s_w + j * KO);
    wj[0] = v.x;
    wj[1] = v.y;
  } else {
#pragma unroll
    for (int r = 0; r < KO; r += 4) {
      const float4 v = *reinterpret_cast<const float4*>(s_w + j * KO + r);
      wj[r] = v.x;
      wj[r + 1] = v.y;
      wj[r + 2] = v.z;
      wj[r + 3] = v.w;
    }
  }
}

// acc[u][r][e] += W[r, j] * X[j, chunk u, e] for one row j of K_in
template <int KO, int kU, int kVec>
__device__ __forceinline__ void accumulate_row(float (&acc)[kU][KO][kVec], const float* s_w,
                                               int j, const uint4 (&v)[kU]) {
  float wj[KO];
  w_column<KO>(s_w, j, wj);
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    float f[kVec];
    unpack16(v[u], f);
#pragma unroll
    for (int r = 0; r < KO; ++r)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[u][r][e] = fmaf(wj[r], f[e], acc[u][r][e]);
  }
}

// W[seed][:, k0:k0+kc] into s_w[j * KO + r], rows past K_out zero
template <int KO>
__device__ __forceinline__ void stage_w(float* s_w, const float* w, int k_out, int k_in, int k0,
                                        int kc) {
  for (int i = threadIdx.x; i < kc * KO; i += kSmallThreads) {
    const int j = i / KO;
    const int r = i - j * KO;
    s_w[i] = r < k_out ? w[static_cast<long long>(r) * k_in + k0 + j] : 0.0f;
  }
}

template <typename T, int KO>
__global__ void __launch_bounds__(kSmallThreads)
    mix_matmul_small_kernel(const __grid_constant__ SmallTable table,
                            const float* __restrict__ w, int k_out, int k_in, int seeds) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kU = small_unroll<T, KO>();
  constexpr long long kTileChunks = static_cast<long long>(kSmallThreads) * kU;
  __shared__ __align__(16) float s_w[kSmallKC * KO];
  const long long tiles = table.tile_begin[table.n];
  const long long items = tiles * seeds;
  const bool one_chunk = k_in <= kSmallKC;
  const int tid = threadIdx.x;
  int staged_seed = -1;
  int leaf = 0;
  // every branch on what follows is uniform over the block (t is), so the
  // barriers around the staging of W are reached by all its threads
  for (long long t = blockIdx.x; t < items; t += gridDim.x) {
    const int seed = static_cast<int>(t / tiles);
    const long long tile = t - static_cast<long long>(seed) * tiles;
    const float* w_seed = w + static_cast<long long>(seed) * k_out * k_in;
    if (seed != staged_seed) {
      leaf = 0;
      if (one_chunk) {
        __syncthreads();                // the last seed's readers are done
        stage_w<KO>(s_w, w_seed, k_out, k_in, 0, k_in);
        __syncthreads();
      }
      staged_seed = seed;
    }
    while (tile >= table.tile_begin[leaf + 1]) ++leaf;
    const long long p = table.p[leaf];
    const long long chunks = (p + kVec - 1) / kVec;
    const long long chunk0 = (tile - table.tile_begin[leaf]) * kTileChunks + tid;
    const T* x = static_cast<const T*>(table.x[leaf]) + static_cast<long long>(seed) * k_in * p;
    T* out = static_cast<T*>(table.out[leaf]) + static_cast<long long>(seed) * k_out * p;
    const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                         (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
                         ((p * static_cast<long long>(sizeof(T))) % 16 == 0);

    float acc[kU][KO][kVec];
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int r = 0; r < KO; ++r)
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[u][r][e] = 0.0f;

    for (int k0 = 0; k0 < k_in; k0 += kSmallKC) {
      const int kc = min(kSmallKC, k_in - k0);
      if (!one_chunk) {
        __syncthreads();
        stage_w<KO>(s_w, w_seed, k_out, k_in, k0, kc);
        __syncthreads();
      }
      const T* x0 = x + static_cast<long long>(k0) * p;
      if (aligned) {
        // chunk u of row j: 16 bytes at x0 + j * p + (chunk0 + u * threads) * kVec
#pragma unroll 4
        for (int j = 0; j < kc; ++j) {
          const T* row = x0 + static_cast<long long>(j) * p;
          uint4 v[kU];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const long long c = chunk0 + static_cast<long long>(u) * kSmallThreads;
            v[u] = c < chunks ? *reinterpret_cast<const uint4*>(row + c * kVec)
                              : make_uint4(0, 0, 0, 0);
          }
          accumulate_row<KO, kU, kVec>(acc, s_w, j, v);
        }
      } else {
        // element-wise: the same chunks, every element masked at P's edge
        for (int j = 0; j < kc; ++j) {
          const T* row = x0 + static_cast<long long>(j) * p;
          float wj[KO];
          w_column<KO>(s_w, j, wj);
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const long long col = (chunk0 + static_cast<long long>(u) * kSmallThreads) * kVec;
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
              const float xv = col + e < p ? to_float(row[col + e]) : 0.0f;
#pragma unroll
              for (int r = 0; r < KO; ++r) acc[u][r][e] = fmaf(wj[r], xv, acc[u][r][e]);
            }
          }
        }
      }
    }

    // every input row of these columns has been read: write the outputs
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long c = chunk0 + static_cast<long long>(u) * kSmallThreads;
      if (c >= chunks) continue;
#pragma unroll
      for (int r = 0; r < KO; ++r) {
        if (r >= k_out) break;
        T* o = out + static_cast<long long>(r) * p + c * kVec;
        if (aligned) {
          *reinterpret_cast<uint4*>(o) = pack16(acc[u][r]);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            if (c * kVec + e < p) o[e] = from_float<T>(acc[u][r][e]);
        }
      }
    }
  }
}

struct Device {
  int sms = 0;
  int blocks[2][5] = {};   // resident blocks per SM, [dtype][log2 KO - 1]
};

template <typename T, int KO>
cudaError_t launch_small(SmallTable& table, const long long* p, int n, const float* w,
                         int seeds, int k_out, int k_in, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr long long kTileChunks = static_cast<long long>(kSmallThreads) * small_unroll<T, KO>();
  long long tiles = 0;
  for (int i = 0; i < n; ++i) {
    table.tile_begin[i] = tiles;
    tiles += ((p[i] + kVec - 1) / kVec + kTileChunks - 1) / kTileChunks;
  }
  table.tile_begin[n] = tiles;
  // the grid: every SM full, once (asked of the runtime once per device)
  constexpr int kMaxDevices = 64;
  static Device devices[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  Device& d = devices[device % kMaxDevices];
  if (d.sms == 0) {
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  int& resident = d.blocks[sizeof(T) == 2][__builtin_ctz(KO) - 1];
  if (resident == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, mix_matmul_small_kernel<T, KO>, kSmallThreads, 0);
    if (err != cudaSuccess) return err;
    if (resident < 1) resident = 1;
  }
  const long long items = tiles * seeds;
  const long long full = static_cast<long long>(d.sms) * resident;
  const unsigned grid = static_cast<unsigned>(items < full ? items : full);
  mix_matmul_small_kernel<T, KO><<<grid, kSmallThreads, 0, stream>>>(table, w, k_out, k_in,
                                                                     seeds);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_small(SmallTable& table, const long long* p, int n, const float* w,
                         int seeds, int k_out, int k_in, cudaStream_t stream) {
  if (k_out <= 2) return launch_small<T, 2>(table, p, n, w, seeds, k_out, k_in, stream);
  if (k_out <= 4) return launch_small<T, 4>(table, p, n, w, seeds, k_out, k_in, stream);
  if (k_out <= 8) return launch_small<T, 8>(table, p, n, w, seeds, k_out, k_in, stream);
  return launch_small<T, 16>(table, p, n, w, seeds, k_out, k_in, stream);
}

bool overlap(uintptr_t a, uintptr_t a_end, uintptr_t b, uintptr_t b_end) {
  return a < b_end && b < a_end;
}

}  // namespace

// Leaves per launch: a group of more leaves takes ceil(n / this) launches.
extern "C" int gossip_mix_matmul_max_leaves() { return kMaxLeaves; }

// The mapping a [k_out, k_in] W gets: 0 = tiles of kBM x kBN, 1 = column
// streaming (K_out <= kSmallKMax; the only one that mixes in place when
// k_out == k_in); -1 for a shape the kernel does not take.
extern "C" int gossip_mix_matmul_path(int k_out, int k_in) {
  if (k_out < 1 || k_in < 1) return -1;
  return k_out <= kSmallKMax ? 1 : 0;
}

// Shared memory one block of the tile mapping takes for a [k_out, k_in] W and
// X in dtype (0 = float32, 1 = bfloat16), in bytes (at most 96 KB: K_in is
// staged in chunks).
extern "C" long long gossip_mix_matmul_smem_bytes(int k_out, int k_in, int dtype) {
  return static_cast<long long>(smem_bytes(k_out, k_in, dtype == 0 ? 4 : 2));
}

// One launch over 1 <= n <= kMaxLeaves leaves, all of one dtype (0 =
// float32, 1 = bfloat16), for 1 <= seeds <= 65535 seeds: w [seeds, k_out,
// k_in], x[i] [seeds, k_in, p[i]] -> out[i] [seeds, k_out, p[i]], all
// contiguous, 1 <= p[i] < 2^31. The mapping is gossip_mix_matmul_path(
// k_out, k_in); its tiles are laid out here. out[i] == x[i] mixes leaf i in
// place, under the column mapping with k_out == k_in only; any other overlap
// of an output with an input or with another output is refused. Returns the launch's cudaError_t (0 = ok);
// cudaErrorInvalidValue for arguments the kernel does not take or a grid
// past its limits.
extern "C" int gossip_mix_matmul_grouped_launch(
    const float* w, const void* const* x, void* const* out, const long long* p,
    int n, int seeds, int k_out, int k_in, int dtype, void* stream) {
  if (n < 1 || n > kMaxLeaves || k_out < 1 || k_in < 1) return cudaErrorInvalidValue;
  if (seeds < 1 || seeds > 65535) return cudaErrorInvalidValue;        // grid z
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const int path = gossip_mix_matmul_path(k_out, k_in);
  const bool in_place_ok = path == 1 && k_out == k_in;
  // bytes of one seed-row of a leaf per column, over every seed
  const long long in_row = static_cast<long long>(seeds) * k_in * (dtype == 0 ? 4 : 2);
  const long long out_row = static_cast<long long>(seeds) * k_out * (dtype == 0 ? 4 : 2);
  for (int i = 0; i < n; ++i) {
    if (p[i] < 1 || p[i] >= (1LL << 31)) return cudaErrorInvalidValue;
    const uintptr_t o = reinterpret_cast<uintptr_t>(out[i]);
    const uintptr_t o_end = o + out_row * p[i];
    for (int j = 0; j < n; ++j) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(x[j]);
      if (overlap(o, o_end, a, a + in_row * p[j]) &&
          !(j == i && out[i] == x[i] && in_place_ok))
        return cudaErrorInvalidValue;
      const uintptr_t b = reinterpret_cast<uintptr_t>(out[j]);
      if (j != i && overlap(o, o_end, b, b + out_row * p[j]))
        return cudaErrorInvalidValue;
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    SmallTable table = {};
    for (int i = 0; i < n; ++i) {
      table.x[i] = x[i];
      table.out[i] = out[i];
      table.p[i] = p[i];
    }
    table.n = n;
    if (dtype == 0) return launch_small<float>(table, p, n, w, seeds, k_out, k_in, s);
    return launch_small<__nv_bfloat16>(table, p, n, w, seeds, k_out, k_in, s);
  }
  if ((k_out + kBM - 1) / kBM > 65535) return cudaErrorInvalidValue;   // grid y
  LeafTable table = {};
  long long tiles = 0;
  for (int i = 0; i < n; ++i) {
    table.x[i] = x[i];
    table.out[i] = out[i];
    table.p[i] = p[i];
    table.tile_begin[i] = static_cast<int>(tiles);
    tiles += (p[i] + kBN - 1) / kBN;
    if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;   // grid x
  }
  table.tile_begin[n] = static_cast<int>(tiles);
  table.n = n;
  if (dtype == 0) return launch<float>(table, w, seeds, k_out, k_in, s);
  return launch<__nv_bfloat16>(table, w, seeds, k_out, k_in, s);
}

extern "C" const char* gossip_mix_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
