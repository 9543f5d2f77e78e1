// Sparse gossip mix on a padded neighbour list for Hopper (sm_90a), one
// launch over a group of leaves:
//
//     out_l[k, p] = sum_d  w[k, d] * X_l[idx[k, d], p]      for every leaf l
//
//     idx  [K_out, D]    int32 neighbour ids (padding slots: an in-bounds id)
//     w    [K_out, D]    f32 weights (0 on padding slots)
//     X_l  [K_in, P_l]   one flattened parameter leaf, f32 or bf16 (one dtype
//                        per launch)
//     out_l[K_out, P_l]  in X's dtype, accumulated in f32
//
// Replaces the Pallas TPU kernel `_gather_mix_kernel` / `gossip_mix_gather`
// in src/repro/kernels/gossip_mix/kernel.py. The Pallas function takes one
// [K_in, P] array; a group of one leaf is that function.
//
// run_seeds' seed axis: S seeds of [K_out, D] lists over [S, K_in, P_l]
// leaves in the same launch. The kernel walks the S*K_out output rows of the
// seed-major [S*K_out, D] lists as one list and folds each row's seed into
// its ids as it stages them (row r belongs to seed r / K_out and gathers
// from rows (r / K_out) * K_in + id of the [S*K_in, P_l] leaves), so the
// fold costs no launch of its own. S = 1 is the single federation.
//
// What bounds it on this card: bytes. Per output element it does D
// multiply-adds, but X is small next to the L2 cache (K_in * P values), so
// after the first touch every gathered row comes from L2 and device memory
// sees each X element once and each output element once: 5.2 us for one
// round's mix of the 21,840-parameter MNIST CNN at K = 100 in f32. At that
// size what costs most is the shape: the CNN's eight leaves are 10 to 16,000
// columns wide, and one launch per leaf pays eight launch latencies, six of
// them for under 2 KB per row.
//
// What the design does about it:
// * One launch per group. The wrapper passes the group as a table by value in
//   the kernel's parameters (LeafTable, under 2 KB: per leaf the input and
//   output pointers, P, its first column tile and whether it takes the 16-byte
//   path), so there is no host-to-device copy and no concatenated buffer. The
//   C launcher below lays out the column tiles from the widths; a group of
//   more than kMaxLeaves leaves is split by the wrapper.
// * The grid walks (column tile, row block) over every leaf's tiles:
//   blockIdx.x is a column tile of the whole group (a leaf owns
//   ceil(P_l / tile width) of them), blockIdx.y a block of kRows output rows.
// * A block first loads its own rows of idx / w into shared memory (the TPU
//   version had them scalar-prefetched), then every thread owns one 16-byte
//   vector of one output row, walks the D slots accumulating in f32
//   registers, and writes its vector once. A leaf whose rows and base
//   pointers are 16-byte aligned takes 16-byte loads and stores (a tile of
//   kThreadsP vectors); any other leaf takes the element-wise path (a tile of
//   kThreadsP elements). The choice is per leaf, so uniform within a block.
//   The ragged edge of P is masked in the kernel; X is never copied or padded.
//   Padding slots carry weight 0 and an in-bounds id, so they add nothing.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers and the current stream, and raises on the returned error.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 64;  // leaves per launch (the table's size)
constexpr int kThreadsP = 128;  // threads along P
constexpr int kRows = 4;        // output rows per block (threadIdx.y)
constexpr int kMaxSlotBytes = 48 * 1024;   // the block's idx / w buffer

struct LeafTable {
  const void* x[kMaxLeaves];
  void* out[kMaxLeaves];
  long long p[kMaxLeaves];
  int tile_begin[kMaxLeaves + 1];   // first column tile of each leaf; [n] = total
  unsigned char vec[kMaxLeaves];    // 1: 16-byte loads and stores
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

// One thread's VEC adjacent elements of one output row: VEC = 16 / sizeof(T)
// on the 16-byte path, 1 on the element-wise one.
template <typename T, int VEC>
__device__ __forceinline__ void gather_row(const int* my_idx, const float* my_w, int d,
                                           const T* __restrict__ x, T* __restrict__ out,
                                           long long p, int row, long long col) {
  if (col >= p) return;
  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;

#pragma unroll 4
  for (int s = 0; s < d; ++s) {
    const float wv = my_w[s];
    const T* src = x + static_cast<long long>(my_idx[s]) * p + col;
    if constexpr (VEC == 1) {
      acc[0] = fmaf(wv, to_float(src[0]), acc[0]);
    } else {
      const uint4 raw = *reinterpret_cast<const uint4*>(src);
      const T* elems = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = fmaf(wv, to_float(elems[v]), acc[v]);
    }
  }

  T* dst = out + static_cast<long long>(row) * p + col;
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
__global__ void __launch_bounds__(kThreadsP* kRows)
    gather_mix_grouped_kernel(const __grid_constant__ LeafTable table,
                              const int* __restrict__ idx, const float* __restrict__ w,
                              int rows, int k_out, int k_in, int d) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ float4 smem_raw[];
  int* s_idx = reinterpret_cast<int*>(smem_raw);
  float* s_w = reinterpret_cast<float*>(smem_raw) + kRows * d;

  const int row0 = blockIdx.y * kRows;
  const int tid = threadIdx.y * kThreadsP + threadIdx.x;
  // rows are contiguous, so the block's kRows x d slab of idx / w is one run;
  // each id moves to its seed's rows of the leaves
  for (int i = tid; i < kRows * d; i += kThreadsP * kRows) {
    const int r = row0 + i / d;
    const bool in_rows = r < rows;
    s_idx[i] = in_rows ? idx[static_cast<size_t>(row0) * d + i] + (r / k_out) * k_in : 0;
    s_w[i] = in_rows ? w[static_cast<size_t>(row0) * d + i] : 0.0f;
  }
  __syncthreads();

  const int row = row0 + threadIdx.y;
  if (row >= rows) return;
  // the leaf that owns this column tile
  const int tile = blockIdx.x;
  int leaf = 0;
  while (leaf + 1 < table.n && tile >= table.tile_begin[leaf + 1]) ++leaf;
  const long long first = static_cast<long long>(tile - table.tile_begin[leaf]) * kThreadsP;
  const T* x = static_cast<const T*>(table.x[leaf]);
  T* out = static_cast<T*>(table.out[leaf]);
  const int* my_idx = s_idx + threadIdx.y * d;
  const float* my_w = s_w + threadIdx.y * d;
  if (table.vec[leaf]) {
    gather_row<T, kVec>(my_idx, my_w, d, x, out, table.p[leaf], row,
                        (first + threadIdx.x) * kVec);
  } else {
    gather_row<T, 1>(my_idx, my_w, d, x, out, table.p[leaf], row,
                     (first + threadIdx.x) * 1);
  }
}

template <typename T>
cudaError_t launch(const LeafTable& table, const int* idx, const float* w, int rows,
                   int k_out, int k_in, int d, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kRows) * d * (sizeof(int) + sizeof(float));
  const dim3 block(kThreadsP, kRows);
  const dim3 grid(table.tile_begin[table.n], (rows + kRows - 1) / kRows);
  gather_mix_grouped_kernel<T><<<grid, block, smem, stream>>>(table, idx, w, rows, k_out,
                                                               k_in, d);
  return cudaGetLastError();
}

}  // namespace

// Leaves per launch: a group of more leaves takes ceil(n / this) launches.
extern "C" int gossip_mix_gather_max_leaves() { return kMaxLeaves; }

// One launch over 1 <= n <= kMaxLeaves leaves, all of one dtype (0 =
// float32, 1 = bfloat16), for 1 <= seeds seeds: x[i] [seeds, k_in, p[i]] ->
// out[i] [seeds, k_out, p[i]], both contiguous, every p[i] >= 1; idx / w
// [seeds, k_out, d], d >= 1, the ids of seed s into its own k_in rows. The
// column tiles of the grid and each leaf's path are laid out here. Returns
// the launch's cudaError_t (0 = ok); cudaErrorInvalidValue for arguments the
// kernel does not take (d past the block's slot buffer) or a grid past its
// limits.
extern "C" int gossip_mix_gather_grouped_launch(
    const int* idx, const float* w, const void* const* x, void* const* out,
    const long long* p, int n, int seeds, int k_out, int k_in, int d, int dtype,
    void* stream) {
  if (n < 1 || n > kMaxLeaves || seeds < 1 || k_out < 1 || k_in < 1 || d < 1)
    return cudaErrorInvalidValue;
  if (static_cast<long long>(kRows) * d * 8 > kMaxSlotBytes) return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(seeds) * k_out;
  if ((rows + kRows - 1) / kRows > 65535) return cudaErrorInvalidValue;   // grid y
  if (static_cast<long long>(seeds) * k_in >= (1LL << 31)) return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const int vec = dtype == 0 ? 4 : 8;   // elements per 16 bytes
  LeafTable table = {};
  long long tiles = 0;
  for (int i = 0; i < n; ++i) {
    if (p[i] < 1 || p[i] >= (1LL << 31)) return cudaErrorInvalidValue;
    const bool aligned = p[i] % vec == 0 && reinterpret_cast<uintptr_t>(x[i]) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(out[i]) % 16 == 0;
    const long long cols = static_cast<long long>(kThreadsP) * (aligned ? vec : 1);
    table.x[i] = x[i];
    table.out[i] = out[i];
    table.p[i] = p[i];
    table.vec[i] = aligned ? 1 : 0;
    table.tile_begin[i] = static_cast<int>(tiles);
    tiles += (p[i] + cols - 1) / cols;
    if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;   // grid x
  }
  table.tile_begin[n] = static_cast<int>(tiles);
  table.n = n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = static_cast<int>(rows);
  if (dtype == 0) return launch<float>(table, idx, w, r, k_out, k_in, d, s);
  return launch<__nv_bfloat16>(table, idx, w, r, k_out, k_in, d, s);
}

extern "C" const char* gossip_mix_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
