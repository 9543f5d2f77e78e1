// AdamW for Hopper (sm_90a), one in-place launch over a table of f32 leaves:
//
//     mu <- b1 mu + (1 - b1) g
//     nu <- b2 nu + (1 - b2) g g
//     p  <- p + (-lr) ((mu / c1) / (sqrt(nu / c2) + eps) + wd p)
//
// for every element of every leaf of the table. c1 = 1 - b1^t and c2 = 1 - b2^t
// are read from the device (two 0-d f32 tensors the caller computed there),
// so nothing waits for the host and nothing is copied to it.
//
// Replaces no TPU kernel: the reference leaves its AdamW to XLA's fused
// elementwise code (src/repro/optim). It replaces the port's eager
// optim.adamw on the train step's main path (launch/steps, local_train),
// which ran about twenty PyTorch ops per leaf, each streaming the whole leaf
// through device memory: about a dozen full-size temporaries, then three
// copies back into p, mu and nu.
//
// What bounds it on this card: bytes. Per parameter it must read p, g, mu and
// nu and write p, mu and nu, 28 bytes, for 16 f32 operations (three of them
// a division, one a square root): a 1.36e9-parameter vehicle is 38 GB, 11.3 ms
// at 3.35 TB/s.
//
// What the design does about it:
//   * One pass. Every element is read once and written once; all of the
//     update happens in registers. Nothing is allocated and nothing is
//     copied back.
//   * 16-byte accesses (float4, with the streaming cache hints: nothing is
//     read again) wherever the four bases agree modulo 16 bytes. The ragged
//     head (the up to three elements before p's first 16-byte boundary, e.g.
//     row v = 1 of a [2, n] stack with n odd) and the ragged tail go by 4-byte
//     accesses in the same kernel; a leaf whose four bases differ modulo 16
//     goes by 4-byte accesses throughout.
//   * A persistent grid: SMs x resident blocks of kThreads. Work is cut into
//     units of four elements, numbered across the whole table, and dealt
//     round robin over all the grid's threads, so a small leaf after a large
//     one starts on idle threads and one launch keeps the card's memory busy
//     from its first leaf to its last.
//   * The table travels by value in the kernel's parameters
//     (__grid_constant__ LeafTable, under 4 KB: per leaf the four pointers,
//     the length, the first unit and the head), as gossip_mix_matmul.cu's
//     does: no host-to-device copy. A longer list of leaves is split by the
//     wrapper into ceil(n / kMaxLeaves) launches.
//   * The same bits as optim.adamw, op for op and in its order: every
//     operation is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
//     __fdiv_rn, __fsqrt_rn), so the compiler contracts nothing into an FMA,
//     and the scalars arrive as PyTorch rounds the Python floats to f32.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers and the current stream, and raises on the returned error.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLeaves = 64;
constexpr int kThreads = 256;

struct LeafTable {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* mu[kMaxLeaves];
  float* nu[kMaxLeaves];
  long long n[kMaxLeaves];
  long long unit_begin[kMaxLeaves + 1];   // first unit of each leaf; [count] = total
  int head[kMaxLeaves];   // elements before p's first 16-byte boundary (0-3);
                          // -1: the bases differ mod 16, 4-byte accesses only
  int count;
};

struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay, neg_lr;
};

__device__ __forceinline__ void adamw_element(float& p, float g, float& m, float& v,
                                              const Hyper& h, float c1, float c2) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.one_minus_b2, __fmul_rn(g, g)));
  const float adam =
      __fdiv_rn(__fdiv_rn(m, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), h.eps));
  p = __fadd_rn(p, __fmul_rn(h.neg_lr, __fadd_rn(adam, __fmul_rn(h.weight_decay, p))));
}

__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const __grid_constant__ LeafTable t, const Hyper h,
                 const float* __restrict__ c1_ptr, const float* __restrict__ c2_ptr) {
  const float c1 = *c1_ptr;
  const float c2 = *c2_ptr;
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  const long long me = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (int l = 0; l < t.count; ++l) {
    const long long begin = t.unit_begin[l];
    const long long units = t.unit_begin[l + 1] - begin;
    // this thread's first unit of the leaf: global unit begin + u falls to
    // thread (begin + u) mod threads
    long long u = me - begin % threads;
    if (u < 0) u += threads;
    if (u >= units) continue;
    float* __restrict__ p = t.p[l];
    const float* __restrict__ g = t.g[l];
    float* __restrict__ mu = t.mu[l];
    float* __restrict__ nu = t.nu[l];
    const long long n = t.n[l];
    const int head = t.head[l];
    // unit u covers elements [4u - shift, 4u + 4 - shift), clipped to [0, n)
    const long long shift = head > 0 ? 4 - head : 0;
    for (; u < units; u += threads) {
      const long long lo = 4 * u - shift;
      if (head >= 0 && lo >= 0 && lo + 4 <= n) {
        float4 pv = __ldcs(reinterpret_cast<const float4*>(p + lo));
        const float4 gv = __ldcs(reinterpret_cast<const float4*>(g + lo));
        float4 mv = __ldcs(reinterpret_cast<const float4*>(mu + lo));
        float4 vv = __ldcs(reinterpret_cast<const float4*>(nu + lo));
        adamw_element(pv.x, gv.x, mv.x, vv.x, h, c1, c2);
        adamw_element(pv.y, gv.y, mv.y, vv.y, h, c1, c2);
        adamw_element(pv.z, gv.z, mv.z, vv.z, h, c1, c2);
        adamw_element(pv.w, gv.w, mv.w, vv.w, h, c1, c2);
        __stcs(reinterpret_cast<float4*>(p + lo), pv);
        __stcs(reinterpret_cast<float4*>(mu + lo), mv);
        __stcs(reinterpret_cast<float4*>(nu + lo), vv);
      } else {
        const long long end = lo + 4 < n ? lo + 4 : n;
        for (long long i = lo < 0 ? 0 : lo; i < end; ++i) {
          float pe = p[i], m = mu[i], v = nu[i];
          adamw_element(pe, g[i], m, v, h, c1, c2);
          p[i] = pe;
          mu[i] = m;
          nu[i] = v;
        }
      }
    }
  }
}

struct Device {
  int sms = 0;
  int resident = 0;   // blocks of adamw_kernel per SM
};

bool overlap(uintptr_t a, uintptr_t a_end, uintptr_t b, uintptr_t b_end) {
  return a < b_end && b < a_end;
}

}  // namespace

// Leaves per launch: a longer list takes ceil(n / this) launches.
extern "C" int adamw_max_leaves() { return kMaxLeaves; }

// One in-place AdamW step over 1 <= count <= kMaxLeaves leaves: for each i,
// p[i], g[i], mu[i], nu[i] are n[i] >= 1 contiguous f32 elements on the
// current device (4-byte aligned); p, mu and nu are written, g is read. c1,
// c2 point at one f32 each on the device (the bias corrections). A written
// range that overlaps another written range or any gradient is refused (two
// gradients may share memory). The scalars are f32: b1, 1 - b1, b2, 1 - b2,
// eps, the weight decay and -lr, each as PyTorch rounds the Python float.
// Returns the launch's cudaError_t (0 = ok); cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int adamw_launch(void* const* p, const void* const* g, void* const* mu,
                            void* const* nu, const long long* n, int count, float b1,
                            float one_minus_b1, float b2, float one_minus_b2, float eps,
                            float weight_decay, float neg_lr, const float* c1,
                            const float* c2, void* stream) {
  if (count < 1 || count > kMaxLeaves || c1 == nullptr || c2 == nullptr)
    return cudaErrorInvalidValue;
  LeafTable t = {};
  long long units = 0;
  for (int i = 0; i < count; ++i) {
    const uintptr_t a[4] = {reinterpret_cast<uintptr_t>(p[i]),
                            reinterpret_cast<uintptr_t>(g[i]),
                            reinterpret_cast<uintptr_t>(mu[i]),
                            reinterpret_cast<uintptr_t>(nu[i])};
    if (n[i] < 1 || n[i] > (1LL << 60)) return cudaErrorInvalidValue;
    for (uintptr_t x : a)
      if (x == 0 || x % 4 != 0) return cudaErrorInvalidValue;
    const bool same = a[0] % 16 == a[1] % 16 && a[0] % 16 == a[2] % 16 && a[0] % 16 == a[3] % 16;
    const int head = same ? static_cast<int>((16 - a[0] % 16) % 16 / 4) : -1;
    const long long shift = head > 0 ? 4 - head : 0;
    t.p[i] = static_cast<float*>(p[i]);
    t.g[i] = static_cast<const float*>(g[i]);
    t.mu[i] = static_cast<float*>(mu[i]);
    t.nu[i] = static_cast<float*>(nu[i]);
    t.n[i] = n[i];
    t.head[i] = head;
    t.unit_begin[i] = units;
    units += (n[i] + shift + 3) / 4;
  }
  t.unit_begin[count] = units;
  t.count = count;
  // written ranges against every other written range and every gradient
  for (int i = 0; i < count; ++i) {
    const long long bytes_i = 4 * n[i];
    const void* written_i[3] = {p[i], mu[i], nu[i]};
    for (int wi = 0; wi < 3; ++wi) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(written_i[wi]);
      for (int j = 0; j < count; ++j) {
        const long long bytes_j = 4 * n[j];
        const void* other[4] = {p[j], mu[j], nu[j], g[j]};
        for (int wj = 0; wj < 4; ++wj) {
          if (j == i && wj == wi) continue;
          const uintptr_t b = reinterpret_cast<uintptr_t>(other[wj]);
          if (overlap(a, a + bytes_i, b, b + bytes_j)) return cudaErrorInvalidValue;
        }
      }
    }
  }
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
  if (d.resident == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&d.resident, adamw_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (d.resident < 1) d.resident = 1;
  }
  const long long needed = (units + kThreads - 1) / kThreads;
  const long long full = static_cast<long long>(d.sms) * d.resident;
  const unsigned grid = static_cast<unsigned>(needed < full ? needed : full);
  const Hyper h = {b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay, neg_lr};
  adamw_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t, h, c1, c2);
  return cudaGetLastError();
}

extern "C" const char* adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
