// Elementwise ops of the op library, bf16 or fp32, any contiguous shape:
//
//     relu(a)        max(a, 0)
//     add(a, b)      a + b
//     add_relu(a, b) max(a + b, 0)
//
// max keeps a NaN (as jnp.maximum and torch.maximum do; relu.cuh) and
// gives +0 for a zero of either sign.  A bf16 sum is taken in fp32 and rounded once to bf16, which is one
// rounding of the exact sum, as the plain version and XLA compute it.
//
// Replaces resnetc_tpu/ops/pallas/elementwise.py:29 `_unary_call`
// (pallas_call :42; `relu` :82) and :53 `_binary_call` (pallas_call :67;
// `add` :92, `add_relu` :102).  The TPU wrappers fold the tensor into
// (rows, 512) tiles with a padded tail; here one grid-stride loop walks the
// flat tensor.
//
// What bounds it.  No arithmetic to speak of: the bytes (one or two reads
// and one write of the tensor) over the HBM rate.  Design: 16-byte vector
// loads and stores (8 bf16 or 4 fp32 values a thread) when every pointer is
// 16-byte aligned and the size a multiple of the vector, else one value a
// thread; neighbouring threads on neighbouring vectors, so every access is
// coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "relu.cuh"

namespace {

constexpr int THREADS = 256;
constexpr unsigned MAX_BLOCKS = 132 * 16;  // enough to fill the card

enum Kind { KIND_BF16 = 1, KIND_F32 = 2 };
enum Op { OP_RELU = 0, OP_ADD = 1, OP_ADD_RELU = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// max(v, 0) (relu.cuh) in T: v itself (a NaN's bits kept) or +0.
template <typename T>
__device__ __forceinline__ T relu(T v) {
  return relu_keeps(to_f32(v)) ? v : from_f32<T>(0.f);
}

template <typename T, int OP>
__device__ __forceinline__ T apply(T a, T b) {
  if (OP == OP_RELU) return relu(a);
  const T s = from_f32<T>(__fadd_rn(to_f32(a), to_f32(b)));
  return OP == OP_ADD ? s : relu(s);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// n: the number of VEC-groups.
template <typename T, int OP, int VEC>
__global__ void __launch_bounds__(THREADS)
ew_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out, size_t n) {
  const size_t stride = (size_t)gridDim.x * THREADS;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    const Vec<T, VEC> va = reinterpret_cast<const Vec<T, VEC>*>(a)[i];
    Vec<T, VEC> vb = va;
    if (OP != OP_RELU) vb = reinterpret_cast<const Vec<T, VEC>*>(b)[i];
    Vec<T, VEC> vo;
#pragma unroll
    for (int k = 0; k < VEC; ++k) vo.v[k] = apply<T, OP>(va.v[k], vb.v[k]);
    reinterpret_cast<Vec<T, VEC>*>(out)[i] = vo;
  }
}

template <typename T, int OP>
int launch(const void* a, const void* b, void* out, size_t n, int vec, cudaStream_t stream) {
  constexpr int V16 = 16 / sizeof(T);
  const size_t groups = vec ? n / V16 : n;
  if (groups == 0) return 0;
  size_t blocks = (groups + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* po = static_cast<T*>(out);
  if (vec)
    ew_kernel<T, OP, V16><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(pa, pb, po, groups);
  else
    ew_kernel<T, OP, 1><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(pa, pb, po, groups);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int op, const void* a, const void* b, void* out, size_t n, int vec,
             cudaStream_t stream) {
  switch (op) {
    case OP_RELU:
      return launch<T, OP_RELU>(a, b, out, n, vec, stream);
    case OP_ADD:
      return launch<T, OP_ADD>(a, b, out, n, vec, stream);
    case OP_ADD_RELU:
      return launch<T, OP_ADD_RELU>(a, b, out, n, vec, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// op: OP_RELU (b unused, may be NULL), OP_ADD or OP_ADD_RELU; n elements;
// vec: 1 when a, b and out are 16-byte aligned and n a multiple of 16 bytes'
// worth of values, else 0.
extern "C" int elementwise(int op, int kind, const void* a, const void* b, void* out,
                           long long n, int vec, cudaStream_t stream) {
  if (kind == KIND_BF16)
    return dispatch<__nv_bfloat16>(op, a, b, out, static_cast<size_t>(n), vec, stream);
  if (kind == KIND_F32) return dispatch<float>(op, a, b, out, static_cast<size_t>(n), vec, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
