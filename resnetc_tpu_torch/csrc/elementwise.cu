// Elementwise ops of the op library, bf16 or fp32, any contiguous shape:
//
//     relu(a)        max(a, 0)
//     add(a, b)      a + b
//     add_relu(a, b) max(a + b, 0)
//
// max keeps a NaN (as jnp.maximum and torch.maximum do; relu.cuh), its bits
// as they are, and gives +0 for a zero of either sign.  A bf16 sum is taken
// in fp32 and rounded once to bf16, which is one rounding of the exact sum,
// as the plain version and XLA compute it.
//
// Replaces resnetc_tpu/ops/pallas/elementwise.py:29 `_unary_call`
// (pallas_call :42; `relu` :82) and :53 `_binary_call` (pallas_call :67;
// `add` :92, `add_relu` :102).  The TPU wrappers fold the tensor into
// (rows, 512) tiles with a padded tail; here the flat tensor is cut into a
// scalar head (up to the first 16-byte boundary), a body of 16-byte vectors
// and a scalar tail.
//
// What bounds it.  No arithmetic to speak of: the bytes (one or two reads
// and one write of the tensor) over the HBM rate, and below a few MB the
// launch.  Design, for the bytes:
// - every pointer that shares the first operand's offset mod 16 (any
//   element-aligned view, with the output allocated to match) takes the
//   vector body; the few head and tail values go value by value through
//   the first block's first two warps, beside their vectors.  Pointers at
//   different offsets take the scalar kernel;
// - one 16-byte vector of each operand a thread, neighbouring threads on
//   neighbouring vectors, so every access is coalesced and a tensor of a
//   few MB still spreads over every SM (four vectors a thread, or two of
//   each operand, left a ragged 1.4 MB tensor on 87 blocks and lost to
//   torch.relu there; PERF.md);
// - loads through the read-only path (ld.global.nc), stores streaming
//   (st.global.cs): every byte is written once, and evict-first loads lost
//   the L2 hits of an input that fits there;
// - a flat grid of one vector a thread (a grid of one resident wave
//   striding over the body was 2.4-7.2% slower at (32, 56, 56, 256) and
//   level elsewhere; PERF.md).  A tensor of a few thousand values takes a
//   block or two.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 256;

enum Kind { KIND_BF16 = 1, KIND_F32 = 2 };
enum Op { OP_RELU = 0, OP_ADD = 1, OP_ADD_RELU = 2 };

// A value as its bits (U) and as fp32: bf16 is the top half of an fp32.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  using U = unsigned;
  static __device__ __forceinline__ float f32(U u) { return __uint_as_float(u); }
  static __device__ __forceinline__ U of(float v) { return __float_as_uint(v); }
  // relu keeps the value: v > 0 (sign clear, not +0) or NaN, as
  // relu.cuh's relu_keeps.
  static __device__ __forceinline__ bool keeps(U u) {
    return static_cast<int>(u) > 0 || (u & 0x7fffffffu) > 0x7f800000u;
  }
};
template <>
struct Elem<__nv_bfloat16> {
  using U = unsigned short;
  static __device__ __forceinline__ float f32(U u) {
    return __uint_as_float(static_cast<unsigned>(u) << 16);
  }
  static __device__ __forceinline__ U of(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ bool keeps(U u) {
    return static_cast<short>(u) > 0 || (u & 0x7fffu) > 0x7f80u;
  }
};

// max(v, 0) on v's bits: v itself (a NaN's payload and sign kept) or +0.
// The test is on the integer bits: with a float select `v > 0 || v != v ?
// v : 0` the card gave the canonical NaN (as max.NaN does), not v's.
template <typename T>
__device__ __forceinline__ typename Elem<T>::U relu(typename Elem<T>::U u) {
  return Elem<T>::keeps(u) ? u : 0;
}

template <typename T, int OP>
__device__ __forceinline__ typename Elem<T>::U apply(typename Elem<T>::U a,
                                                     typename Elem<T>::U b) {
  using E = Elem<T>;
  if (OP == OP_RELU) return relu<T>(a);
  const typename E::U s = E::of(__fadd_rn(E::f32(a), E::f32(b)));
  return OP == OP_ADD ? s : relu<T>(s);
}

// The op on one 32-bit word of each operand: one fp32 value or two bf16.
template <typename T, int OP>
__device__ __forceinline__ unsigned apply_word(unsigned x, unsigned y) {
  if constexpr (sizeof(T) == 4) {
    return apply<T, OP>(x, y);
  } else {
    using U = typename Elem<T>::U;
    const unsigned lo = apply<T, OP>(static_cast<U>(x), static_cast<U>(y));
    const unsigned hi = apply<T, OP>(static_cast<U>(x >> 16), static_cast<U>(y >> 16));
    return lo | (hi << 16);
  }
}

template <typename T, int OP>
__device__ __forceinline__ uint4 apply16(uint4 x, uint4 y) {
  return make_uint4(apply_word<T, OP>(x.x, y.x), apply_word<T, OP>(x.y, y.y),
                    apply_word<T, OP>(x.z, y.z), apply_word<T, OP>(x.w, y.w));
}

// The vector body: nvec 16-byte vectors from a + head (16-byte aligned, as
// b + head and out + head are), one a thread and step.  The first two warps
// of block 0 also take the head values [0, head) and the tail values after
// the body, value by value, loading theirs before their vector and storing
// it after, so that both loads are in flight at once.  b is unused (may
// equal a) for relu.
template <typename T, int OP, typename Bits = typename Elem<T>::U>
__global__ void __launch_bounds__(THREADS)
ew_vec_kernel(const Bits* __restrict__ a, const Bits* __restrict__ b, Bits* __restrict__ out,
              int head, size_t nvec, int tail) {
  constexpr int V = 16 / sizeof(T);
  const int t = threadIdx.x;
  size_t j = 0;  // this thread's head or tail value, if it has one
  bool scalar = false;
  if (blockIdx.x == 0) {
    if (t < head) {
      j = t;
      scalar = true;
    } else if (t >= 32 && t - 32 < tail) {
      j = head + nvec * V + (t - 32);
      scalar = true;
    }
  }
  Bits sa = 0, sb = 0;
  if (scalar) {
    sa = a[j];
    sb = b[j];
  }
  const uint4* va = reinterpret_cast<const uint4*>(a + head);
  const uint4* vb = reinterpret_cast<const uint4*>(b + head);
  uint4* vo = reinterpret_cast<uint4*>(out + head);
  for (size_t i = blockIdx.x * static_cast<size_t>(THREADS) + t; i < nvec;
       i += static_cast<size_t>(gridDim.x) * THREADS) {
    const uint4 x = __ldg(va + i);
    const uint4 y = OP == OP_RELU ? x : __ldg(vb + i);
    __stcs(vo + i, apply16<T, OP>(x, y));
  }
  if (scalar) out[j] = apply<T, OP>(sa, sb);
}

// Pointers at different offsets mod 16: one value a thread, grid-stride.
template <typename T, int OP, typename Bits = typename Elem<T>::U>
__global__ void __launch_bounds__(THREADS)
ew_scalar_kernel(const Bits* __restrict__ a, const Bits* __restrict__ b, Bits* __restrict__ out,
                 size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(THREADS) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * THREADS)
    out[i] = apply<T, OP>(a[i], b[i]);
}

// Blocks of THREADS that the card holds at once running the scalar kernel:
// one wave.
template <typename T, int OP>
int resident_blocks() {
  static const int blocks = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ew_scalar_kernel<T, OP>, THREADS, 0);
    return std::max(1, sms * per_sm);
  }();
  return blocks;
}

template <typename T, int OP, typename Bits = typename Elem<T>::U>
int launch(const Bits* a, const Bits* b, Bits* out, size_t n, cudaStream_t stream) {
  if (n == 0) return 0;
  if (OP == OP_RELU) b = a;
  const uintptr_t off = reinterpret_cast<uintptr_t>(a) % 16;
  const bool vec = off % sizeof(T) == 0 && reinterpret_cast<uintptr_t>(out) % 16 == off &&
                   reinterpret_cast<uintptr_t>(b) % 16 == off;
  if (!vec) {
    const size_t blocks =
        std::min<size_t>((n + THREADS - 1) / THREADS, resident_blocks<T, OP>());
    ew_scalar_kernel<T, OP><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(a, b, out, n);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int V = 16 / sizeof(T);
  const int head = static_cast<int>(std::min<size_t>(n, (16 - off) % 16 / sizeof(T)));
  const size_t nvec = (n - head) / V;
  const int tail = static_cast<int>((n - head) % V);
  const size_t blocks = std::max<size_t>(1, (nvec + THREADS - 1) / THREADS);
  ew_vec_kernel<T, OP><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(a, b, out, head,
                                                                                nvec, tail);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int op, const void* a, const void* b, void* out, size_t n,
             cudaStream_t stream) {
  using U = typename Elem<T>::U;
  const U* pa = static_cast<const U*>(a);
  const U* pb = static_cast<const U*>(b);
  U* po = static_cast<U*>(out);
  switch (op) {
    case OP_RELU:
      return launch<T, OP_RELU>(pa, pb, po, n, stream);
    case OP_ADD:
      return launch<T, OP_ADD>(pa, pb, po, n, stream);
    case OP_ADD_RELU:
      return launch<T, OP_ADD_RELU>(pa, pb, po, n, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// op: OP_RELU (b unused, may be NULL), OP_ADD or OP_ADD_RELU; n elements of
// kind at a, b and out (each element-aligned).  The vector body runs when b
// and out share a's offset mod 16, else the scalar kernel.
extern "C" int elementwise(int op, int kind, const void* a, const void* b, void* out,
                           long long n, cudaStream_t stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (kind == KIND_BF16)
    return dispatch<__nv_bfloat16>(op, a, b, out, static_cast<size_t>(n), stream);
  if (kind == KIND_F32) return dispatch<float>(op, a, b, out, static_cast<size_t>(n), stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
