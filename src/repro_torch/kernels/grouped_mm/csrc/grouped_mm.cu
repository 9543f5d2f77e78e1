// Grouped (ragged) matrix products for Hopper (sm_90a), on group offsets that
// live on the device:
//
//   grouped_mm:        y[r, :] = x[r, :] @ B_e      for offsets[e] <= r < offsets[e+1]
//                      B_e = w[e] ([E, K, N]) or w[e]^T (trans_w, w [E, N, K]);
//                      rows in no group are 0
//   grouped_mm_wgrad:  dw[e] = x[rows of e]^T @ dy[rows of e]   ([E, K, N]; 0 for an
//                      empty group)
//
// x, w, dy f32 or bf16 (one dtype), outputs in that dtype; every sum is kept
// in f32. offsets is [E + 1] int32 on the device, non-decreasing: no group
// size is read on the host, so a launch stays valid inside a CUDA graph when
// only the offsets change.
//
// Replaces no Pallas kernel: it is the port of `jax.lax.ragged_dot`, which the
// reference's sorted MoE dispatch (`moe_ragged`, src/repro/models/moe.py)
// leaves to XLA. The forward is grouped_mm; the gradient of x is grouped_mm
// again with the transpose flag flipped (no transposed copy of w), the
// gradient of w is grouped_mm_wgrad.
//
// What bounds it on this card: operations. At the MoE's prefill shapes (M =
// 16,384 rows, K = 1,024, N = 512 for granite-moe; M = 4,096, K = 4,096,
// N = 14,336 for mixtral) each product does 2*M*K*N flops on M*K + E*K*N +
// M*N elements: hundreds to thousands of operations per byte. bf16 runs on
// the tensor cores (989 TFLOP/s); f32 runs three TF32 products per product
// (3 x 2*M*K*N at 495 TFLOP/s). In decode (M = B * top_k rows) it reads the
// touched experts' weights for a few rows and is bound by bytes, or by launch
// latency.
//
// What the design does about it (the times below were measured on an H100;
// PERF.md, section 6, names the runs):
// * One persistent launch on a tile schedule built on the device. The grid is
//   the SM count times the blocks that fit on an SM, capped by a bound that
//   needs only the shapes: (ceil(M/BM) + E) * ceil(N/BN) forward, E *
//   ceil(K/BM) * ceil(N/BN) for wgrad. Forward, each block reads offsets[0..E]
//   and forms in shared memory the prefix of each group's row tiles (a block
//   scan), then maps each tile index to (group, row tile, column tile) by a
//   binary search over that prefix: no tile straddles a group and no block
//   idles on an empty one. The rows in no group, [0, offsets[0]) and
//   [offsets[E], M), are zeroed by the same launch (a grid-stride loop).
//   wgrad's tiles are (group, K tile, N tile) with the groups ranked by their
//   rows, largest first: a tile's work is its group's rows, and in group order
//   the Dirichlet-sized groups of granite's prefill left some block with far
//   more than the mean (f32 weight gradient 0.507 ms in group order, 0.366 ms
//   ranked, in one run of scripts/torch_kernel_variants.py grouped). Blocks take tile
//   indices in rounds, in a snake: block b takes r * G + b in even rounds r,
//   r * G + G - 1 - b in odd ones (G blocks). An empty group's wgrad tiles
//   write zeros.
// * A ring of shared-memory slots (dynamic shared memory, ~200 KB) filled by
//   TMA: one thread issues a k-step's copies (`cp.async.bulk.tensor`, 128-byte
//   swizzle, zeros outside the tensor) on the slot's mbarrier, kAhead steps
//   ahead of the one computed, and the ring runs on across a block's tiles.
//   Every thread staging 16-byte `cp.async` copies (4 slots, 2 ahead) capped
//   the loads near 3.9 TB/s and stalled the warps that then issue the
//   products, so load and math times added up (bf16 at mixtral's shape: 2.10
//   ms loads + 0.62 ms math = 2.69 ms; with TMA 1.27 ms). Rows past a group's
//   end: forward copies them and never stores their results; wgrad zeroes
//   them in the slot (they would join the reduction). Where a width is not a
//   multiple of 16 bytes, or a base pointer not 16-byte aligned, the same
//   kernel stages that operand with guarded element loads by every thread
//   into the same layout (kept zero past the edge).
// * bf16 on `wgmma.mma_async.m64n256k16.f32.bf16.bf16`: a 128 x 256 output
//   tile per block of two warpgroups (64 rows each), f32 accumulators in
//   registers, BK = 64, 4 slots, 2 ahead. With TMA the loads come from L2 at
//   about 6 TB/s, so the tile is what bounds bf16: 128 x 256 moves a quarter
//   fewer bytes per flop than 128 x 128 (mixtral: 1.27 -> 1.03 ms). Both
//   operands are read from shared memory through descriptors in the
//   128-byte-swizzled layout each keeps its major order in: x (and w[e] under
//   trans_w) K-major, rows of 128 bytes with the 16-byte chunk c of row r at
//   chunk c ^ (r % 8); w[e] [K, N] and both wgrad operands (x^T and dy)
//   MN-major, atoms of 8 k-rows x 64 elements (leading byte offset: the next
//   64-element atom column; stride byte offset: the next 8 k-rows). One
//   `wgmma.wait_group 1` per step keeps one step's products in flight while
//   the next step's copies are issued. The epilogue passes each warp's 16
//   rows through a 2 KB swizzled buffer (`stmatrix`, then 16-byte copies), so
//   every row's 128 bytes go out coalesced: storing the accumulators' 4-byte
//   pairs straight from registers took a third of wgrad's time (mixtral
//   1.563 -> 1.051 ms, granite's forward 0.062 -> 0.049, in one run of
//   scripts/torch_kernel_variants.py grouped). Widths not a multiple of 8 keep the
//   paired stores.
// * f32 as 3xTF32 on `mma.sync.m16n8k8` (as flash_attention.cu's f32 path):
//   a 64 x 256 tile per block of eight warps (each 32 x 64), BK = 32, 5
//   slots, 3 ahead. Each operand fragment is split once per staged tile into
//   big = tf32(a), rounded to nearest as `cvt.rna.tf32.f32` rounds (by two
//   integer operations: the conversion ran f32 ~10 % slower), and small =
//   a - big, which the tensor cores read cut to tf32 (rounding it as well ran
//   4-6 % slower); each product is
//   small*big + big*small + big*big: about 21 bits of each operand. The
//   tensor cores align each step to the largest addend and cut the bits below
//   it, so a long chain into one accumulator would lose the bits the
//   corrections carry: each output's 12 products of a stage (4 k8 steps x 3)
//   form one chain from 0, added into its f32 sum in registers, rounded to
//   nearest. Held to the same 1e-5 of the plain version's scale as the FMA
//   design (a CPU test emulates the split: one TF32 product misses it).
//   `wgmma` takes tf32 operands only K-major, and w[e] and both wgrad
//   operands are MN-major. This path is bound by instruction issue: per
//   `mma` it also splits, reads shared memory and adds. So the warp tile is
//   32 x 64 (not 32 x 32), the fragment offsets are tabled per thread and
//   fold into constants (the swizzle's XOR takes 8 values per operand kind;
//   computed at each read, granite's forward took 0.50 ms, tabled 0.41), and for
//   wgrad (both operands MN-major) the k slots of each k8 step are mapped so
//   that the reads are free of bank conflicts.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers and the current stream, and raises on the returned error.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;      // two warpgroups (bf16), eight warps (f32)
constexpr int kMaxGroups = 1024;   // the prefix of row tiles lives in shared memory
constexpr int kMaxStages = 5;      // the larger ring of Tile<T>

enum Mode { kFwd = 0, kFwdTrans = 1, kWgrad = 2 };

// A block's output tile (BM x BN), its reduction slice per stage (BK: one
// 128-byte row of a swizzle atom, 64 bf16 or 32 f32), and its ring: kStages
// slots, kAhead steps in flight ahead of the one computed (at most kStages
// - 2: the step before may still be read by asynchronous products).
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int BM = 64, BN = 256, BK = 32;
  static constexpr int kStages = 5, kAhead = 3;
};
template <>
struct Tile<bf16> {
  static constexpr int BM = 128, BN = 256, BK = 64;
  static constexpr int kStages = 4, kAhead = 2;
};

// One operand tile of a stage: R rows (the operand's slow axis in memory) x
// C contiguous columns, in 128-byte-swizzled atoms of 8 rows x kW columns
// (the layout TMA's SWIZZLE_128B writes and wgmma's descriptors name): the
// 16-byte chunk q of row r at chunk q ^ (r % 8); atom columns R * 128 bytes
// apart, each a contiguous R x 128-byte block.
template <typename T, int R, int C>
struct Operand {
  static constexpr int kW = 128 / sizeof(T);    // columns of an atom row
  static constexpr int kEl = 16 / sizeof(T);    // columns of a 16-byte chunk
  static_assert(C % kW == 0, "whole atom columns");
  static constexpr int kRows = R, kCols = C, kElems = R * C;
  static constexpr int kAtomCols = C / kW, kAtomElems = R * kW;
  __device__ __forceinline__ static int offset(int r, int c) {
    return (c / kW) * kAtomElems + r * kW + ((((c / kEl) & 7) ^ (r & 7)) * kEl) + (c % kEl);
  }
};

template <typename T, int kMode>
struct Layout {
  using C = Tile<T>;
  static constexpr bool kF32 = std::is_same<T, float>::value;
  // A: x's rows x K (K-major), or for wgrad rows x K-index (x^T, MN-major)
  using A = typename std::conditional<kMode == kWgrad, Operand<T, C::BK, C::BM>,
                                      Operand<T, C::BM, C::BK>>::type;
  // B: w[e] [K, N] (MN-major), w[e] [N, K] under trans_w (K-major), dy (MN-major)
  using B = typename std::conditional<kMode == kFwdTrans, Operand<T, C::BN, C::BK>,
                                      Operand<T, C::BK, C::BN>>::type;
  static constexpr int kStageElems = A::kElems + B::kElems;
  // bf16's epilogue stages each warp's 16 x 64 block of the output (2 KB) behind the ring
  static constexpr int kEpilogueElems = kF32 ? 0 : (kThreads / 32) * 16 * 64;
  static constexpr size_t kSmemBytes =
      (static_cast<size_t>(C::kStages) * kStageElems + kEpilogueElems) * sizeof(T) +
      1024;   // + alignment
};

struct Params {
  CUtensorMap map_a;     // x: {K, M}
  CUtensorMap map_b;     // w: {N, K, E} / {K, N, E} (trans_w); dy: {N, M}
  const void* a;         // x
  const void* b;         // w, or dy for wgrad
  const int* offsets;    // [groups + 1]
  void* out;             // y [m, n], or dw [groups, k, n]
  int m, k, n, groups;
  int tma_a, tma_b;      // the operand is staged by TMA, else by guarded element loads
};

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <>
__device__ __forceinline__ bf16 zero_of<bf16>() { return __float2bfloat16(0.0f); }

__device__ __forceinline__ long long clamp_rows(long long r, long long lo, long long hi) {
  return r < lo ? lo : (r > hi ? hi : r);
}

// rows [lo, hi) of group e, clamped into [0, m) as the plain version does
__device__ __forceinline__ void group_rows(const int* offsets, int e, int m, long long& lo,
                                           long long& hi) {
  lo = clamp_rows(offsets[e], 0, m);
  hi = clamp_rows(offsets[e + 1], lo, m);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------ TMA, mbarriers ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of `parity` to complete. A bounded spin: a phase that
// never completes traps (a launch error) instead of hanging the device.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred P;\nmbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1 << 24)) __trap();
  }
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Stages rows [0, R) x columns [0, C) of the tile at `src` (row pitch `ld`
// elements) into `dst` by guarded element loads (an operand TMA cannot
// take): entries at a row >= rows or a column >= cols are 0.
template <typename T, typename Op>
__device__ __forceinline__ void stage_elements(T* dst, const T* src, long long ld,
                                               long long rows, long long cols) {
  constexpr int kPerRow = Op::kCols / Op::kEl;
  for (int i = threadIdx.x; i < Op::kRows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i - r * kPerRow) * Op::kEl;
    T* d = dst + Op::offset(r, c);
    const bool row_in = r < rows;
#pragma unroll
    for (int q = 0; q < Op::kEl; ++q)
      d[q] = (row_in && c + q < cols) ? src[r * ld + c + q] : zero_of<T>();
  }
}

// zeroes rows [rows, R) of a staged tile (wgrad: rows past the group's end,
// which TMA copied from the next group)
template <typename T, typename Op>
__device__ __forceinline__ void zero_rows_from(T* dst, int rows) {
  constexpr int kPerRow = Op::kCols / Op::kEl;
  for (int i = threadIdx.x + rows * kPerRow; i < Op::kRows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i - r * kPerRow) * Op::kEl;
    *reinterpret_cast<uint4*>(dst + Op::offset(r, c)) = make_uint4(0, 0, 0, 0);
  }
}

// ---------------------------------------------------------- bf16: wgmma ----

__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);   // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across a wait
__device__ __forceinline__ void fence_operands(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] += A[64 x 16] . B[16 x 256]; kTA / kTB: the operand is MN-major
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

// One stage (BK = 64: four k16 steps) of this warpgroup's 64 x 256 block.
// Byte offsets: a warpgroup's 64 rows of a K-major A, or its atom column of
// an MN-major A, are 8,192 bytes in; a k16 step is 32 bytes along a K-major
// row, 16 rows (2,048 bytes) down an MN-major atom column. MN-major B's atom
// columns are 8,192 bytes apart.
template <int kMode>
__device__ __forceinline__ void wgmma_stage(const bf16* sa, const bf16* sb, float (&acc)[128]) {
  constexpr bool kMnA = kMode == kWgrad, kMnB = kMode != kFwdTrans;
  const int wg = threadIdx.x >> 7;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bf16* pa = sa + wg * 4096 + (kMnA ? kk * 1024 : kk * 16);
    const bf16* pb = sb + (kMnB ? kk * 1024 : kk * 16);
    const uint64_t da = kMnA ? smem_desc(pa, 8192, 1024) : smem_desc(pa, 16, 1024);
    const uint64_t db = kMnB ? smem_desc(pb, 8192, 1024) : smem_desc(pb, 16, 1024);
    wgmma_m64n256k16<kMnA ? 1 : 0, kMnB ? 1 : 0>(acc, da, db);
  }
  wgmma_commit();
}

// ----------------------------------------------------- f32: 3xTF32 mma ----

// big = tf32(x), rounded to nearest with ties away from zero (what
// cvt.rna.tf32.f32 gives, by two integer operations), and small = x - big
// (exact in f32), passed as is: the tensor cores read a .tf32 operand's upper
// 19 bits, so small enters the products cut to tf32 (within 2^-21 of x)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct SplitA {
  uint32_t big[4], small[4];
};

// The f32 fragment reads. In a swizzled f32 slot (atoms of 8 rows x 32
// floats) element (row, col) lies at (col / 32) * rows * 32 + row * 32 +
// (((col / 4) % 8) ^ (row % 8)) * 4 + col % 4. For this thread's fragments
// the XOR takes 8 values per operand kind, fixed for the whole kernel: they
// are tabled once per stage, and every read is a table entry plus a
// constant.
//  * K-major (x rows in the forward, w[e]'s rows under trans_w): rows
//    base + g (base a multiple of 8), k = 8 KS + slot: table kmaj[KS][s] =
//    g * 32 + (((2 KS + s) ^ g) * 4) + t, slot t + 4s.
//  * MN-major (w[e] [K, N]; x^T and dy in wgrad): columns base + 8 q + g
//    (base a multiple of 32, q < 4 within an atom column), k = 8 KS + slot:
//    table mn[q][s] = slot * 32 + (((2q + g / 4) ^ slot) * 4) + g % 4.
struct FragTables {
  int kmaj[4][2];
  int mn[4][2];
};

// k slot s of a k8 step: t + 4s, or for wgrad (both operands MN-major) 2t + s,
// which keeps its MN-major reads free of bank conflicts (both operands map
// alike, so the sum is the same)
template <int kMode>
__device__ __forceinline__ int k_slot(int t, int s) {
  return kMode == kWgrad ? 2 * t + s : t + 4 * s;
}

template <int kMode>
__device__ __forceinline__ FragTables frag_tables() {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  FragTables f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      f.kmaj[i][s] = g * 32 + (((2 * i + s) ^ g) << 2) + t;
      const int slot = k_slot<kMode>(t, s);
      f.mn[i][s] = slot * 32 + ((((2 * i + (g >> 2)) ^ slot) & 7) << 2) + (g & 3);
    }
  return f;
}

// k8 step KS of a stage (BK = 32: four k8 steps) of this warp's 32 x 64
// block: rows wm .. wm + 31 of the tile (two m16 tiles), columns wn .. wn + 63
// (eight n8 tiles). Fragments (g = lane / 4, t = lane % 4): A (row g | g + 8,
// k slot 0 | 1), B (k slot 0 | 1, column g), sums (row g | g + 8, columns 2t,
// 2t + 1). `a_w` / `b_w` are the slot's A / B at this warp's atom column
// (MN-major) or row block (K-major).
template <int kMode, int KS>
__device__ __forceinline__ void k8_step(const float* a_w, const float* b_w, const FragTables& f,
                                        float (&chain)[2][8][4]) {
  constexpr int BK = Tile<float>::BK;
  // A (r = 16 mi + 8 u + g of the warp's rows, k slot s)
  auto A = [&](int mi, int u, int s) {
    return kMode == kWgrad ? a_w[f.mn[2 * mi + u][s] + KS * 8 * 32]
                           : a_w[(16 * mi + 8 * u) * 32 + f.kmaj[KS][s]];
  };
  // B (k slot s, c = 8 nj + g of the warp's columns)
  auto B = [&](int nj, int s) {
    return kMode == kFwdTrans ? b_w[8 * nj * 32 + f.kmaj[KS][s]]
                              : b_w[(nj >> 2) * BK * 32 + f.mn[nj & 3][s] + KS * 8 * 32];
  };
  SplitA a[2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    split_tf32(A(mi, 0, 0), a[mi].big[0], a[mi].small[0]);
    split_tf32(A(mi, 1, 0), a[mi].big[1], a[mi].small[1]);
    split_tf32(A(mi, 0, 1), a[mi].big[2], a[mi].small[2]);
    split_tf32(A(mi, 1, 1), a[mi].big[3], a[mi].small[3]);
  }
#pragma unroll
  for (int nj = 0; nj < 8; ++nj) {
    uint32_t bb0, bs0, bb1, bs1;
    split_tf32(B(nj, 0), bb0, bs0);
    split_tf32(B(nj, 1), bb1, bs1);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      mma_tf32(chain[mi][nj], a[mi].small, bb0, bb1);
      mma_tf32(chain[mi][nj], a[mi].big, bs0, bs1);
      mma_tf32(chain[mi][nj], a[mi].big, bb0, bb1);
    }
  }
}

// One stage of this warp's block. Each output's three products of the
// stage form one chain on the tensor cores from 0 (12 steps), added into its
// f32 sum in registers.
template <int kMode>
__device__ __forceinline__ void mma_stage_f32(const float* sa, const float* sb,
                                              const FragTables& f, float (&acc)[2][8][4]) {
  using L = Layout<float, kMode>;
  static_assert(Tile<float>::BK == 32, "four k8 steps");
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 64;
  // this warp's part of each operand: a row block (K-major) or an atom column
  const float* a_w = sa + (kMode == kWgrad ? (wm / 32) * L::A::kAtomElems : wm * 32);
  const float* b_w = sb + (kMode == kFwdTrans ? wn * 32 : (wn / 32) * L::B::kAtomElems);
  float chain[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) chain[i][j][q] = 0.0f;
  k8_step<kMode, 0>(a_w, b_w, f, chain);
  k8_step<kMode, 1>(a_w, b_w, f, chain);
  k8_step<kMode, 2>(a_w, b_w, f, chain);
  k8_step<kMode, 3>(a_w, b_w, f, chain);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] += chain[i][j][q];
}

// ------------------------------------------------------------ epilogue ----

// row[c], row[c + 1] = v0, v1 where c, c + 1 < cols; one paired store where
// the row's pitch is even (pairs)
__device__ __forceinline__ void store_pair(float* row, int c, long long cols, bool pairs,
                                           float v0, float v1) {
  if (pairs && c + 1 < cols) {
    *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
    return;
  }
  if (c < cols) row[c] = v0;
  if (c + 1 < cols) row[c + 1] = v1;
}

__device__ __forceinline__ void store_pair(bf16* row, int c, long long cols, bool pairs,
                                           float v0, float v1) {
  if (pairs && c + 1 < cols) {
    *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(v0, v1);
    return;
  }
  if (c < cols) row[c] = __float2bfloat16(v0);
  if (c + 1 < cols) row[c + 1] = __float2bfloat16(v1);
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stores this warp's 16 x 256 block of a bf16 tile (rows `row0` .. of the
// tile, accumulators in wgmma's layout) into dst (row pitch n, a multiple of
// 8) where row < out_rows and column < out_cols. Four passes of 64 columns
// through the warp's 2 KB buffer `sw` (16 rows of 128 bytes, swizzled):
// `stmatrix` writes the fragments, then each lane copies 16-byte chunks, so
// every row's 128 bytes go out in one coalesced piece.
__device__ __forceinline__ void store_warp_bf16(const float (&acc)[128], bf16* sw, bf16* dst,
                                                int row0, long long n, long long out_rows,
                                                long long out_cols) {
  const int lane = threadIdx.x & 31;
  const int mat = lane >> 3, mrow = (lane & 7) + (mat & 1) * 8;   // stmatrix's row address
#pragma unroll
  for (int pass = 0; pass < 4; ++pass) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {   // n8 blocks j, j + 1: 16 rows x 16 columns
      const int j = 8 * pass + 2 * q;
      const int chunk = 2 * q + (mat >> 1);
      const uint32_t addr = smem_u32(sw + mrow * 64 + ((chunk ^ (mrow & 7)) << 3));
      asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
                   "r"(bf16x2_bits(acc[4 * j], acc[4 * j + 1])),
                   "r"(bf16x2_bits(acc[4 * j + 2], acc[4 * j + 3])),
                   "r"(bf16x2_bits(acc[4 * j + 4], acc[4 * j + 5])),
                   "r"(bf16x2_bits(acc[4 * j + 6], acc[4 * j + 7]))
                   : "memory");
    }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int srow = it * 4 + (lane >> 3), chunk = lane & 7;
      const long long r = row0 + srow, c = pass * 64 + chunk * 8;
      const uint4 v = *reinterpret_cast<const uint4*>(sw + srow * 64 + ((chunk ^ (srow & 7)) << 3));
      if (r < out_rows && c < out_cols) *reinterpret_cast<uint4*>(dst + r * n + c) = v;
    }
    __syncwarp();   // the buffer is read before the next pass writes it
  }
}

// ------------------------------------------------------------- kernel ----

// the row tiles of each group, prefixed into s_pre[0..groups]; returns the count
template <int BM>
__device__ long long row_tile_prefix(const int* offsets, int groups, int m, int* s_pre,
                                     long long* s_scan) {
  const int per = (groups + kThreads - 1) / kThreads;   // groups per thread, <= 4
  const int g0 = threadIdx.x * per;
  long long mine = 0;
  for (int i = 0; i < per; ++i) {
    if (g0 + i >= groups) break;
    long long lo, hi;
    group_rows(offsets, g0 + i, m, lo, hi);
    mine += (hi - lo + BM - 1) / BM;
  }
  s_scan[threadIdx.x] = mine;
  __syncthreads();
  for (int d = 1; d < kThreads; d <<= 1) {                 // inclusive scan
    const long long v = threadIdx.x >= d ? s_scan[threadIdx.x - d] : 0;
    __syncthreads();
    s_scan[threadIdx.x] += v;
    __syncthreads();
  }
  long long run = s_scan[threadIdx.x] - mine;
  for (int i = 0; i < per; ++i) {
    if (g0 + i >= groups) break;
    long long lo, hi;
    group_rows(offsets, g0 + i, m, lo, hi);
    s_pre[g0 + i] = static_cast<int>(run);
    run += (hi - lo + BM - 1) / BM;
  }
  const long long total = s_scan[kThreads - 1];
  if (threadIdx.x == 0) s_pre[groups] = static_cast<int>(total);
  __syncthreads();
  return total;
}

// the group whose row tiles hold row tile `rt`: the last e with s_pre[e] <= rt
__device__ __forceinline__ int group_of(const int* s_pre, int groups, long long rt) {
  int lo = 0, hi = groups - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s_pre[mid] <= rt) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads, 1) grouped_kernel(const __grid_constant__ Params p) {
  using L = Layout<T, kMode>;
  using C = Tile<T>;
  using OpA = typename L::A;
  using OpB = typename L::B;
  constexpr bool kF32 = L::kF32;
  constexpr uint32_t kBytesA = OpA::kElems * sizeof(T), kBytesB = OpB::kElems * sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_pre[kMaxGroups + 1];
  __shared__ long long s_scan[kThreads];
  __shared__ uint64_t s_bar[kMaxStages];   // one per slot: the TMA copies of a step landed
  // the swizzle works on address bits: 1,024-byte atoms
  T* ring = reinterpret_cast<T*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);
  T* out = static_cast<T*>(p.out);
  const long long m = p.m, k = p.k, n = p.n;
  const long long tn = (n + C::BN - 1) / C::BN;
  const bool pairs = (n & 1) == 0;
  const bool tma = p.tma_a || p.tma_b;
  const uint32_t tx_bytes = (p.tma_a ? kBytesA : 0) + (p.tma_b ? kBytesB : 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) mbar_init(&s_bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  long long total;
  if constexpr (kMode == kWgrad) {
    // a wgrad tile's work is its group's rows: the groups in order of size,
    // largest first (s_pre[rank] = group), so that the rounds below deal
    // the long tiles out first and evenly
    total = p.groups * ((k + C::BM - 1) / C::BM) * tn;
    __shared__ int s_rows[kMaxGroups];
    for (int i = threadIdx.x; i < p.groups; i += kThreads) {
      long long lo, hi;
      group_rows(p.offsets, i, p.m, lo, hi);
      s_rows[i] = static_cast<int>(hi - lo);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < p.groups; i += kThreads) {
      const int mine = s_rows[i];
      int rank = 0;
      for (int j = 0; j < p.groups; ++j) {
        const int other = s_rows[j];
        rank += other > mine || (other == mine && j < i);
      }
      s_pre[rank] = i;
    }
    __syncthreads();
  } else {
    total = row_tile_prefix<C::BM>(p.offsets, p.groups, p.m, s_pre, s_scan) * tn;
    // the rows in no group: [0, first) and [last, m)
    const long long first = clamp_rows(p.offsets[0], 0, m);
    const long long last = clamp_rows(p.offsets[p.groups], first, m);
    const long long head = first * n, count = head + (m - last) * n;
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < count;
         i += stride)
      out[i < head ? i : last * n + (i - head)] = zero_of<T>();
  }

  // A tile: its group, its reduction length (k-steps), where its operands
  // start and where it stores.
  struct Geo {
    int e;
    long long nk, rows_a, r0, c0, j0, out_rows, out_cols;
    T* dst;
  };
  auto geo_of = [&](long long tile) {
    Geo g;
    long long lo, hi;
    if constexpr (kMode == kWgrad) {   // dw[e] rows c0.. (x's columns), columns j0.. (dy's)
      const long long tk = (k + C::BM - 1) / C::BM;
      const long long rank = tile / (tk * tn);
      g.e = s_pre[rank];
      const long long rem = tile - rank * tk * tn;
      g.c0 = (rem / tn) * C::BM;
      g.j0 = (rem % tn) * C::BN;
      group_rows(p.offsets, g.e, p.m, lo, hi);
      g.nk = (hi - lo + C::BK - 1) / C::BK;
      g.rows_a = hi - lo;                       // the reduction's rows, from r0
      g.r0 = lo;
      g.dst = out + (g.e * k + g.c0) * n + g.j0;
      g.out_rows = k - g.c0;
      g.out_cols = n - g.j0;
    } else {                           // y rows r0.. of group e, columns c0..
      const long long rt = tile / tn;
      g.c0 = (tile - rt * tn) * C::BN;
      g.j0 = 0;
      g.e = group_of(s_pre, p.groups, rt);
      group_rows(p.offsets, g.e, p.m, lo, hi);
      g.r0 = lo + (rt - s_pre[g.e]) * C::BM;
      const long long r_end = g.r0 + C::BM < hi ? g.r0 + C::BM : hi;
      g.nk = (k + C::BK - 1) / C::BK;
      g.rows_a = r_end - g.r0;
      g.dst = out + g.r0 * n + g.c0;
      g.out_rows = r_end - g.r0;
      g.out_cols = n - g.c0;
    }
    return g;
  };

  // fills slot step % kStages with k-step kt of tile g: TMA (thread 0) for
  // the operands that take it, guarded element loads by every thread for
  // the others
  auto issue = [&](const Geo& g, long long kt, long long step) {
    const int slot = static_cast<int>(step % C::kStages);
    T* sa = ring + slot * L::kStageElems;
    T* sb = sa + OpA::kElems;
    uint64_t* bar = &s_bar[slot];
    const int k0 = static_cast<int>(kt * C::BK);
    if constexpr (kMode == kWgrad) {
      const int i0 = static_cast<int>(g.c0), j0 = static_cast<int>(g.j0);
      const int row = static_cast<int>(g.r0 + k0);
      if (threadIdx.x == 0 && tma) {
        mbar_expect_tx(bar, tx_bytes);
        if (p.tma_a)
          for (int q = 0; q < OpA::kAtomCols; ++q)
            tma_2d(sa + q * OpA::kAtomElems, &p.map_a, i0 + q * OpA::kW, row, bar);
        if (p.tma_b)
          for (int q = 0; q < OpB::kAtomCols; ++q)
            tma_2d(sb + q * OpB::kAtomElems, &p.map_b, j0 + q * OpB::kW, row, bar);
      }
      if (!p.tma_a)
        stage_elements<T, OpA>(sa, a + static_cast<long long>(row) * k + i0, k, g.rows_a - k0,
                               k - i0);
      if (!p.tma_b)
        stage_elements<T, OpB>(sb, b + static_cast<long long>(row) * n + j0, n, g.rows_a - k0,
                               n - j0);
    } else {
      if (threadIdx.x == 0 && tma) {
        mbar_expect_tx(bar, tx_bytes);
        if (p.tma_a) tma_2d(sa, &p.map_a, k0, static_cast<int>(g.r0), bar);
        if (p.tma_b) {
          if constexpr (kMode == kFwd) {
            for (int q = 0; q < OpB::kAtomCols; ++q)
              tma_3d(sb + q * OpB::kAtomElems, &p.map_b, static_cast<int>(g.c0) + q * OpB::kW,
                     k0, g.e, bar);
          } else {
            tma_3d(sb, &p.map_b, k0, static_cast<int>(g.c0), g.e, bar);
          }
        }
      }
      if (!p.tma_a) stage_elements<T, OpA>(sa, a + g.r0 * k + k0, k, g.rows_a, k - k0);
      if (!p.tma_b) {
        const T* we = b + static_cast<long long>(g.e) * k * n;
        if constexpr (kMode == kFwd) {
          stage_elements<T, OpB>(sb, we + static_cast<long long>(k0) * n + g.c0, n, k - k0,
                                 n - g.c0);
        } else {
          stage_elements<T, OpB>(sb, we + g.c0 * k + k0, k, n - g.c0, k - k0);
        }
      }
    }
  };

  // The ring runs on across tiles: the producer's cursor (a tile of this
  // block and a k-step of it) is up to kAhead steps ahead of the one
  // computed, into the block's next tiles; tiles with no k-step (an empty
  // group's wgrad) take no slot.
  //
  // Round r gives this block tile r * G + b (G = gridDim.x, b = blockIdx.x),
  // or r * G + G - 1 - b in odd rounds: a snake, so that where tiles are
  // ordered by their work (wgrad) no block gets the largest of every round.
  // next_tile(r) moves r to this block's next round that has a tile for it
  // and returns that tile, or -1 past the last.
  const long long grid = gridDim.x;
  auto next_tile = [&](long long& r) -> long long {
    for (++r; r * grid < total; ++r) {
      const long long t = r * grid + ((r & 1) ? grid - 1 - blockIdx.x : blockIdx.x);
      if (t < total) return t;
    }
    return -1;
  };
  long long p_round = -1, p_kt = 0, p_step = 0;
  long long p_tile = next_tile(p_round);
  Geo pg{};
  if (p_tile >= 0) pg = geo_of(p_tile);
  auto skip_done = [&]() {
    while (p_tile >= 0 && p_kt >= pg.nk) {
      p_tile = next_tile(p_round);
      p_kt = 0;
      if (p_tile >= 0) pg = geo_of(p_tile);
    }
  };
  auto produce = [&]() {
    skip_done();
    if (p_tile < 0) return;
    issue(pg, p_kt, p_step);
    ++p_kt;
    ++p_step;
  };

  // waits for the slot of step `step` (tile g's k-step kt); wgrad zeroes
  // what TMA copied past the group's end
  auto arrive = [&](const Geo& g, long long kt, long long step) -> const T* {
    const int slot = static_cast<int>(step % C::kStages);
    T* sa = ring + slot * L::kStageElems;
    if (tma) mbar_wait(&s_bar[slot], static_cast<uint32_t>((step / C::kStages) & 1));
    bool wrote = !(p.tma_a && p.tma_b);      // element loads are generic-proxy stores
    if constexpr (kMode == kWgrad) {
      const long long left = g.rows_a - kt * C::BK;
      if (tma && left < C::BK) {
        if (p.tma_a) zero_rows_from<T, OpA>(sa, static_cast<int>(left));
        if (p.tma_b) zero_rows_from<T, OpB>(sa + OpA::kElems, static_cast<int>(left));
        wrote = true;
      }
    }
    if (!kF32 && wrote) fence_proxy_async();   // seen by wgmma's async proxy
    __syncthreads();   // the slot is whole; the step two back is no longer read
    return sa;
  };

  for (int i = 0; i < C::kAhead; ++i) produce();
  long long step = 0;   // this block's k-steps computed: step j reads slot j % kStages
  long long round = -1;
  for (long long tile = next_tile(round); tile >= 0; tile = next_tile(round)) {
    const Geo g = geo_of(tile);
    if constexpr (kF32) {
      float acc[2][8][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
      const FragTables frag = frag_tables<kMode>();
      for (long long kt = 0; kt < g.nk; ++kt, ++step) {
        const float* sa = arrive(g, kt, step);
        produce();
        mma_stage_f32<kMode>(sa, sa + OpA::kElems, frag, acc);
      }
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      const int gq = lane >> 2, t = lane & 3;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (warp >> 2) * 32 + 16 * mi + gq + 8 * h;
          if (r >= g.out_rows) continue;
          T* row = g.dst + r * n;
#pragma unroll
          for (int nj = 0; nj < 8; ++nj)
            store_pair(row, (warp & 3) * 64 + 8 * nj + 2 * t, g.out_cols, pairs,
                       acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
        }
    } else {
      static_assert(C::BN == 256, "m64n256 products");
      float acc[128];   // this thread's share of its warpgroup's 64 x 256 block
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
      for (long long kt = 0; kt < g.nk; ++kt, ++step) {
        const T* sa = arrive(g, kt, step);
        wgmma_stage<kMode>(sa, sa + OpA::kElems, acc);
        produce();
        wgmma_wait<1>();                 // this step's products may still run
      }
      wgmma_wait<0>();
      fence_operands(acc);
      const int wg = threadIdx.x >> 7, w4 = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
      if (n % 8 == 0) {   // rows of 16-byte chunks: through the warp's staging buffer
        bf16* sw = ring + C::kStages * L::kStageElems + (threadIdx.x >> 5) * 16 * 64;
        store_warp_bf16(acc, sw, g.dst, wg * 64 + w4 * 16, n, g.out_rows, g.out_cols);
      } else {
        const int gq = lane >> 2, t = lane & 3;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wg * 64 + w4 * 16 + gq + 8 * h;
          if (r >= g.out_rows) continue;
          T* row = g.dst + r * n;
#pragma unroll
          for (int j = 0; j < C::BN / 8; ++j)
            store_pair(row, 8 * j + 2 * t, g.out_cols, pairs, acc[4 * j + 2 * h],
                       acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// ------------------------------------------------------------- launch ----

bool aligned16(const void* ptr, long long width, size_t esize) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
         (width * static_cast<long long>(esize)) % 16 == 0;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status) ==
            cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A TMA map of a row-major tensor (dims innermost first, strides in bytes of
// the outer dims) copied in boxes of `box`, 128-byte swizzled, zeros outside.
bool encode(CUtensorMap* map, int dtype, const void* base, cuuint32_t rank,
            const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            rank, const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the bound on the launch's tiles that needs only the shapes
template <typename T>
long long tile_bound(long long m, long long k, long long n, long long groups, int mode) {
  using C = Tile<T>;
  const long long tn = (n + C::BN - 1) / C::BN;
  if (mode == kWgrad) return groups * ((k + C::BM - 1) / C::BM) * tn;
  return ((m + C::BM - 1) / C::BM + groups) * tn;
}

// the persistent grid: SMs x blocks per SM, capped by the tile bound. The
// first call on a device opts the kernel into its dynamic shared memory
// (above 48 KB) and asks for its occupancy; later calls, a CUDA graph's
// capture among them, read what the first one found.
template <typename T, int kMode>
cudaError_t grid_of(const Params& p, long long& grid) {
  constexpr size_t smem = Layout<T, kMode>::kSmemBytes;
  static_assert(smem + (2 * kMaxGroups + 1) * 4 + kThreads * 8 + kMaxStages * 8 <= 232448,
                "shared memory of one block");
  static_assert(Tile<T>::kStages <= kMaxStages && Tile<T>::kAhead <= Tile<T>::kStages - 2,
                "the ring");
  constexpr int kMaxDevices = 64;
  static int blocks[kMaxDevices];   // SMs x blocks per SM, per device; 0 until asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (blocks[dev] == 0) {
    err = cudaFuncSetAttribute(grouped_kernel<T, kMode>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grouped_kernel<T, kMode>,
                                                             kThreads, smem)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    blocks[dev] = sms * per_sm;
  }
  grid = blocks[dev];
  const long long bound = tile_bound<T>(p.m, p.k, p.n, p.groups, kMode);
  if (bound < grid) grid = bound;
  if (grid < 1) grid = 1;
  return cudaSuccess;
}

template <typename T, int kMode>
cudaError_t launch(const Params& p, cudaStream_t stream, long long* grid_only) {
  long long grid = 0;
  cudaError_t err = grid_of<T, kMode>(p, grid);
  if (err != cudaSuccess) return err;
  if (grid_only != nullptr) {
    *grid_only = grid;
    return cudaSuccess;
  }
  grouped_kernel<T, kMode><<<static_cast<unsigned>(grid), kThreads,
                             Layout<T, kMode>::kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

// The TMA maps of the operands that TMA takes (16-byte aligned base and
// rows); the others are staged by guarded element loads.
template <typename T>
cudaError_t maps(Params& p, int mode, int dtype) {
  using C = Tile<T>;
  const cuuint64_t es = sizeof(T), m = p.m, k = p.k, n = p.n, e = p.groups;
  const cuuint32_t w = 128 / sizeof(T);   // an atom row: the box's inner extent
  p.tma_a = p.m > 0 && p.k > 0 && aligned16(p.a, p.k, es);
  if (p.tma_a) {
    const cuuint64_t dims[2] = {k, m}, strides[1] = {k * es};
    const cuuint32_t box[2] = {w, static_cast<cuuint32_t>(mode == kWgrad ? C::BK : C::BM)};
    if (!encode(&p.map_a, dtype, p.a, 2, dims, strides, box)) return cudaErrorInvalidValue;
  }
  p.tma_b = p.k > 0 && aligned16(p.b, mode == kFwdTrans ? p.k : p.n, es) &&
            (mode != kWgrad || p.m > 0);
  if (p.tma_b) {
    bool ok;
    if (mode == kFwd) {          // w [E, K, N]
      const cuuint64_t dims[3] = {n, k, e}, strides[2] = {n * es, k * n * es};
      const cuuint32_t box[3] = {w, static_cast<cuuint32_t>(C::BK), 1};
      ok = encode(&p.map_b, dtype, p.b, 3, dims, strides, box);
    } else if (mode == kFwdTrans) {   // w [E, N, K]
      const cuuint64_t dims[3] = {k, n, e}, strides[2] = {k * es, n * k * es};
      const cuuint32_t box[3] = {w, static_cast<cuuint32_t>(C::BN), 1};
      ok = encode(&p.map_b, dtype, p.b, 3, dims, strides, box);
    } else {                     // dy [M, N]
      const cuuint64_t dims[2] = {n, m}, strides[1] = {n * es};
      const cuuint32_t box[2] = {w, static_cast<cuuint32_t>(C::BK)};
      ok = encode(&p.map_b, dtype, p.b, 2, dims, strides, box);
    }
    if (!ok) return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(Params& p, int mode, int dtype, cudaStream_t stream, long long* grid_only) {
  if (grid_only == nullptr) {
    const cudaError_t err = maps<T>(p, mode, dtype);
    if (err != cudaSuccess) return err;
  }
  switch (mode) {
    case kFwd: return launch<T, kFwd>(p, stream, grid_only);
    case kFwdTrans: return launch<T, kFwdTrans>(p, stream, grid_only);
    case kWgrad: return launch<T, kWgrad>(p, stream, grid_only);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run(const void* a, const void* b, const int* offsets, void* out, int m, int k, int n,
                int groups, int mode, int dtype, cudaStream_t stream, long long* grid_only) {
  if (groups < 1 || groups > kMaxGroups || m < 0 || k < 0 || n < 1) return cudaErrorInvalidValue;
  Params p{};
  p.a = a;
  p.b = b;
  p.offsets = offsets;
  p.out = out;
  p.m = m;
  p.k = k;
  p.n = n;
  p.groups = groups;
  if (dtype == 0) return dispatch<float>(p, mode, dtype, stream, grid_only);
  if (dtype == 1) return dispatch<bf16>(p, mode, dtype, stream, grid_only);
  return cudaErrorInvalidValue;
}

}  // namespace

// y [m, n] = grouped x [m, k] @ w (w [E, k, n], or [E, n, k] with trans_w).
// dtype: 0 = float32, 1 = bfloat16 (of x, w and y). Returns the launch's
// cudaError_t. Needs m >= 1, n >= 1, 1 <= num_groups <= 1024.
extern "C" int grouped_mm_launch(const void* x, const void* w, const int* offsets, void* y,
                                 int m, int k, int n, int num_groups, int trans_w,
                                 int dtype, void* stream) {
  return run(x, w, offsets, y, m, k, n, num_groups, trans_w ? kFwdTrans : kFwd, dtype,
             static_cast<cudaStream_t>(stream), nullptr);
}

// dw [E, k, n] = per group x[rows]^T @ dy[rows] (x [m, k], dy [m, n]).
// Needs k >= 1, n >= 1, 1 <= num_groups <= 1024.
extern "C" int grouped_mm_wgrad_launch(const void* x, const void* dy, const int* offsets,
                                       void* dw, int m, int k, int n, int num_groups,
                                       int dtype, void* stream) {
  return run(x, dy, offsets, dw, m, k, n, num_groups, kWgrad, dtype,
             static_cast<cudaStream_t>(stream), nullptr);
}

// The grid (blocks) a launch of these shapes takes on the current device:
// mode 0 forward, 1 forward with trans_w, 2 wgrad; a negative cudaError_t
// where it cannot be formed. Launches nothing.
extern "C" long long grouped_mm_grid(int m, int k, int n, int num_groups, int mode, int dtype) {
  long long grid = 0;
  const cudaError_t err = run(nullptr, nullptr, nullptr, nullptr, m, k, n, num_groups, mode,
                              dtype, nullptr, &grid);
  return err == cudaSuccess ? grid : -static_cast<long long>(err);
}

extern "C" const char* grouped_mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
