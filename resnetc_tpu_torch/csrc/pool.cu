// Pools, NHWC, over the k x k window at (r*s - p, c*s - p) of x[b, ., ., ch]:
//
// - max: taps outside the image never win (the -inf / integer-min padding
//   of the TPU kernel); a NaN tap does, as jnp.maximum keeps a NaN.  bf16, fp32 or int8.  Replaces
//   resnetc_tpu/ops/pallas/pool.py:65 `max_pool2d` (pallas_call at :126).
//   On the `int8` and `pallas` paths it is the pool after the stem:
//   (B, 112, 112, 64) bf16 -> (B, 56, 56, 64), k 3, s 2, p 1.
// - average: divisor k*k whatever the padding, taps outside the image add
//   zeros.  bf16 or fp32, output in the input's type.  Replaces
//   resnetc_tpu/ops/pallas/pool.py:174 `avg_pool2d` (pallas_call at :220;
//   body `_avg_tap_kernel` :146), in its order of operations: per kernel
//   row kh an fp32 sum over kw from left to right, then acc = acc + that,
//   then one multiply by the fp32 constant 1/k^2 (the wrapper passes it;
//   dividing by k^2 can differ in the last bit), so the output equals the
//   plain version bit for bit.  Op library: ResNet-152's 7x7 head pool over
//   (B, 7, 7, 2048).
//
// What bounds it.  Nine compares per output against one read of the input
// and one write of the output: bytes-bound (~64 MB at batch 32, ~19 us at
// 3.35 TB/s).  Design: one thread per output pixel and 16-byte group of
// channels (8 bf16, 4 fp32 or 16 int8 values) when the channel row allows
// 16-byte access, else one channel per thread; neighbouring threads take
// neighbouring channel groups, so every load and store is coalesced, and
// the window's overlapping reads come from L1/L2.  The TPU kernels' phase
// planes (strided access Mosaic lacks) and the padded copy are not carried
// over.  A max is exact, so its output equals the plain version bit for
// bit (a NaN is the hardware's canonical one).  The average pool keeps that
// layout for small windows (the 3x3/2/p1 shape).
//
// A large window with few outputs (the head pool: 7x7 over (B, 7, 7, C), one
// output pixel an image) gives that layout few threads, each walking k*k
// taps: bound by latency, not bytes (on an H100 at batch 32, 0.0144 ms in
// bf16 against F.avg_pool2d's 0.0095; PERF.md, section 6).  For k >= 4 (up
// to 16) the window's kernel rows are spread over threads instead: a block
// of 32 x k threads takes 32 (output pixel, channel group) items, thread (x,
// kh) forms row kh's sum over kw left to right, and thread (x, 0) adds the k
// row sums in kh order from shared memory; the same roundings as above, so
// the output is the same to the bit.  Channel groups are 16 bytes, or 8
// where 16-byte groups would leave fewer than AVG_FILL threads (the head
// pool in bf16).
//
// - the int8_chain stem's tail (stem_pool_int8): from the stem convolution's
//   bias-free output y (B, H1, W1, C), bf16 or fp32, to the zero-ring chain
//   rows (B * hp * wp, C) int8 of the 3x3/2 (pad 1) max pool of
//   q(v) = clamp(rint(relu(T(v + T(bias))) / s), -127, 127), T the rounding
//   to y's type, s the first block's input scale read from its device
//   pointer.  It replaces no Pallas kernel: the JAX package leaves this
//   tail to XLA, which fuses it (resnetc_tpu/ops/pallas/fused.py:857-863),
//   and the port ran it as a dozen eager torch passes over the 112 px map
//   (bias, relu, an fp32 cast, divide, round, clamp, the int8 cast, a pool
//   in fp32 with its casts and permutes, the chain pad).  Every step of q
//   is monotone non-decreasing (the correctly rounded add, relu, the IEEE
//   divide by s > 0, rint, clamp), so the max of q over a window is q of the
//   window's max: each thread takes the max of the raw inputs and applies
//   the bias, the rounding, relu and the quantizer once per output value,
//   the same bits as the composition (finite inputs) at a ninth of the
//   arithmetic.  Bytes-bound: read y once (2 bytes a value in bf16), write
//   the pooled int8 once, B*H1*W1*C*2 + B*H2*W2*C bytes (~0.14 ms at b256,
//   224 px, 3.35 TB/s).  Design: one thread per chain column and 8-channel
//   group (16 bytes of bf16 a load) over a band of STEM_BAND chain rows of
//   one image; neighbouring threads take neighbouring channel groups, so the
//   loads and the 8-byte stores are coalesced; down the band the thread
//   carries each shared input row (2r + 1 of output row r is 2(r+1) - 1 of
//   the next) in registers, so within a band every input row is read once,
//   and the left neighbour's column comes from L1.  The kernel writes every
//   byte of the chain rows, ring rows and columns too, so the output needs
//   no memset.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int THREADS = 256;

enum Kind { KIND_BF16 = 1, KIND_F32 = 2, KIND_I8 = 3 };

__device__ __forceinline__ float key(float v) { return v; }
__device__ __forceinline__ float key(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ int key(int8_t v) { return v; }

template <typename T>
__device__ __forceinline__ T lowest();
template <>
__device__ __forceinline__ float lowest<float>() { return -__int_as_float(0x7f800000); }
template <>
__device__ __forceinline__ __nv_bfloat16 lowest<__nv_bfloat16>() {
  return __ushort_as_bfloat16(static_cast<unsigned short>(0xFF80u));  // -inf
}
template <>
__device__ __forceinline__ int8_t lowest<int8_t>() { return INT8_MIN; }

template <typename T>
__device__ __forceinline__ T zero() { return T(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(static_cast<unsigned short>(0));
}

template <typename T>
__device__ __forceinline__ T from_f32(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// max(m, t) as torch.maximum and jnp.maximum compute it: a NaN where
// either is one (a NaN, once in, stays), else the larger.  The hardware's
// NaN-propagating max: one instruction a value, or a pair of bf16 values.
__device__ __forceinline__ float take_max(float m, float t) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(t), "f"(m));
  return d;
}
__device__ __forceinline__ __nv_bfloat16 take_max(__nv_bfloat16 m, __nv_bfloat16 t) {
  return __hmax_nan(t, m);
}
__device__ __forceinline__ int8_t take_max(int8_t m, int8_t t) { return t > m ? t : m; }

template <typename T, int VEC>
__device__ __forceinline__ void take_max(Vec<T, VEC>& m, const Vec<T, VEC>& t) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && VEC % 2 == 0) {
    auto* m2 = reinterpret_cast<__nv_bfloat162*>(m.v);
    const auto* t2 = reinterpret_cast<const __nv_bfloat162*>(t.v);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) m2[i] = __hmax2_nan(t2[i], m2[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) m.v[i] = take_max(m.v[i], t.v[i]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
max_pool_kernel(const T* __restrict__ x, T* __restrict__ out, int B, int H, int W, int C,
                int OH, int OW, int k, int s, int p) {
  const int groups = C / VEC;
  const size_t total = (size_t)B * OH * OW * groups;
  const size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int g = static_cast<int>(idx % groups);
  size_t pix = idx / groups;
  const int c = static_cast<int>(pix % OW);
  pix /= OW;
  const int r = static_cast<int>(pix % OH);
  const int b = static_cast<int>(pix / OH);

  Vec<T, VEC> m;
#pragma unroll
  for (int i = 0; i < VEC; ++i) m.v[i] = lowest<T>();
  const int y0 = r * s - p, x0 = c * s - p;
  for (int u = 0; u < k; ++u) {
    const int iy = y0 + u;
    if (iy < 0 || iy >= H) continue;
    for (int v = 0; v < k; ++v) {
      const int ix = x0 + v;
      if (ix < 0 || ix >= W) continue;
      const Vec<T, VEC> t = *reinterpret_cast<const Vec<T, VEC>*>(
          x + (((size_t)b * H + iy) * W + ix) * C + (size_t)g * VEC);
      take_max(m, t);
    }
  }
  *reinterpret_cast<Vec<T, VEC>*>(out + (((size_t)b * OH + r) * OW + c) * C + (size_t)g * VEC) =
      m;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
avg_pool_kernel(const T* __restrict__ x, T* __restrict__ out, int B, int H, int W, int C,
                int OH, int OW, int k, int s, int p, float inv) {
  const int groups = C / VEC;
  const size_t total = (size_t)B * OH * OW * groups;
  const size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int g = static_cast<int>(idx % groups);
  size_t pix = idx / groups;
  const int c = static_cast<int>(pix % OW);
  pix /= OW;
  const int r = static_cast<int>(pix % OH);
  const int b = static_cast<int>(pix / OH);

  float acc[VEC], cur[VEC];
  const int y0 = r * s - p, x0 = c * s - p;
  for (int u = 0; u < k; ++u) {
    const int iy = y0 + u;
    for (int v = 0; v < k; ++v) {
      const int ix = x0 + v;
      Vec<T, VEC> t;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
        t = *reinterpret_cast<const Vec<T, VEC>*>(x + (((size_t)b * H + iy) * W + ix) * C +
                                                  (size_t)g * VEC);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) t.v[i] = zero<T>();
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float f = static_cast<float>(key(t.v[i]));
        cur[i] = v == 0 ? f : __fadd_rn(cur[i], f);
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = u == 0 ? cur[i] : __fadd_rn(acc[i], cur[i]);
  }
  Vec<T, VEC> o;
#pragma unroll
  for (int i = 0; i < VEC; ++i) o.v[i] = from_f32<T>(__fmul_rn(acc[i], inv));
  *reinterpret_cast<Vec<T, VEC>*>(out + (((size_t)b * OH + r) * OW + c) * C + (size_t)g * VEC) =
      o;
}

// The average pool with the window's kernel rows over threadIdx.y (see the
// header): blockDim (32, k), smem k * 32 * VEC floats.
template <typename T, int VEC>
__global__ void __launch_bounds__(512)
avg_pool_rows_kernel(const T* __restrict__ x, T* __restrict__ out, int B, int H, int W, int C,
                     int OH, int OW, int k, int s, int p, float inv) {
  extern __shared__ float part[];  // [kh][item][VEC]: row kh's sum of each item
  const int groups = C / VEC;
  const size_t total = (size_t)B * OH * OW * groups;
  const size_t idx = (size_t)blockIdx.x * 32 + threadIdx.x;
  const int u = threadIdx.y;
  float* const mine = part + ((size_t)u * 32 + threadIdx.x) * VEC;
  if (idx < total) {
    const int g = static_cast<int>(idx % groups);
    size_t pix = idx / groups;
    const int c = static_cast<int>(pix % OW);
    pix /= OW;
    const int r = static_cast<int>(pix % OH);
    const int b = static_cast<int>(pix / OH);
    const int iy = r * s - p + u, x0 = c * s - p;
    const bool row_in = iy >= 0 && iy < H;
    float cur[VEC];
    for (int v = 0; v < k; ++v) {
      const int ix = x0 + v;
      Vec<T, VEC> t;
      if (row_in && ix >= 0 && ix < W) {
        t = *reinterpret_cast<const Vec<T, VEC>*>(x + (((size_t)b * H + iy) * W + ix) * C +
                                                  (size_t)g * VEC);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) t.v[i] = zero<T>();
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float f = static_cast<float>(key(t.v[i]));
        cur[i] = v == 0 ? f : __fadd_rn(cur[i], f);
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) mine[i] = cur[i];
  }
  __syncthreads();
  if (u != 0 || idx >= total) return;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = mine[i];
  for (int kh = 1; kh < k; ++kh) {
    const float* row = part + ((size_t)kh * 32 + threadIdx.x) * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = __fadd_rn(acc[i], row[i]);
  }
  Vec<T, VEC> o;
#pragma unroll
  for (int i = 0; i < VEC; ++i) o.v[i] = from_f32<T>(__fmul_rn(acc[i], inv));
  *reinterpret_cast<Vec<T, VEC>*>(out + idx * VEC) = o;
}

template <typename T>
int launch(const void* x, void* out, int vec, int B, int H, int W, int C, int OH, int OW,
           int k, int s, int p, cudaStream_t stream) {
  constexpr int V16 = 16 / sizeof(T);
  const int v = vec ? V16 : 1;
  const size_t total = (size_t)B * OH * OW * (C / v);
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  if (blocks == 0) return 0;
  if (vec)
    max_pool_kernel<T, V16><<<blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), B, H, W, C, OH, OW, k, s, p);
  else
    max_pool_kernel<T, 1><<<blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), B, H, W, C, OH, OW, k, s, p);
  return static_cast<int>(cudaGetLastError());
}

// The fewest threads a rows-kernel launch should have before it narrows its
// channel groups from 16 to 8 bytes (about 500 an SM).
constexpr size_t AVG_FILL = 65536;

template <typename T, int VEC>
int launch_avg_rows(const void* x, void* out, int B, int H, int W, int C, int OH, int OW, int k,
                    int s, int p, float inv, cudaStream_t stream) {
  const size_t total = (size_t)B * OH * OW * (C / VEC);
  const unsigned blocks = static_cast<unsigned>((total + 31) / 32);
  if (blocks == 0) return 0;
  const size_t smem = (size_t)k * 32 * VEC * sizeof(float);
  avg_pool_rows_kernel<T, VEC><<<blocks, dim3(32, k), smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), B, H, W, C, OH, OW, k, s, p, inv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_avg(const void* x, void* out, int vec, int B, int H, int W, int C, int OH, int OW,
               int k, int s, int p, float inv, cudaStream_t stream) {
  constexpr int V16 = 16 / sizeof(T);
  if (k >= 4 && k <= 16) {  // a large window: its kernel rows over threads
    if (!vec)
      return launch_avg_rows<T, 1>(x, out, B, H, W, C, OH, OW, k, s, p, inv, stream);
    if ((size_t)B * OH * OW * (C / V16) * k >= AVG_FILL)
      return launch_avg_rows<T, V16>(x, out, B, H, W, C, OH, OW, k, s, p, inv, stream);
    return launch_avg_rows<T, V16 / 2>(x, out, B, H, W, C, OH, OW, k, s, p, inv, stream);
  }
  const int v = vec ? V16 : 1;
  const size_t total = (size_t)B * OH * OW * (C / v);
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  if (blocks == 0) return 0;
  if (vec)
    avg_pool_kernel<T, V16><<<blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), B, H, W, C, OH, OW, k, s, p, inv);
  else
    avg_pool_kernel<T, 1><<<blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), B, H, W, C, OH, OW, k, s, p, inv);
  return static_cast<int>(cudaGetLastError());
}

// --- the int8_chain stem's tail (stem_pool_int8) --------------------------

constexpr int STEM_THREADS = 128;
// Chain rows a thread covers: its band re-reads one input row of the band
// above (1 in 2 * STEM_BAND, mostly from L2).
constexpr int STEM_BAND = 4;

// v rounded to T (bf16: round to nearest even, as .to(bf16) does).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

// 8 channels from p (16-byte aligned), through the read-only path.
template <typename T>
__device__ __forceinline__ Vec<T, 8> load8(const T* p) {
  Vec<T, 8> v;
  auto* d = reinterpret_cast<uint4*>(v.v);
  const auto* src = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < (int)sizeof(Vec<T, 8>) / 16; ++i) d[i] = __ldg(src + i);
  return v;
}

// The max over the window's columns 2c - 1, 2c, 2c + 1 (those in the image)
// of input row `row`, 8 channels.
template <typename T>
__device__ __forceinline__ Vec<T, 8> window_row(const T* __restrict__ row, int c2, int W1,
                                                int C) {
  const T* p = row + (size_t)(2 * c2) * C;
  Vec<T, 8> m = load8(p);
  if (2 * c2 + 1 < W1) take_max(m, load8(p + C));
  if (c2 > 0) take_max(m, load8(p - C));
  return m;
}

template <typename T>
__global__ void __launch_bounds__(STEM_THREADS)
stem_pool_int8_kernel(const T* __restrict__ y, const float* __restrict__ bias,
                      const float* __restrict__ s_in, int8_t* __restrict__ out, int H1, int W1,
                      int C, int H2, int W2, int hp, int wp) {
  const int groups = C / 8;
  const int t = blockIdx.x * STEM_THREADS + threadIdx.x;
  if (t >= wp * groups) return;
  const int g = t % groups, cc = t / groups;
  const int b = blockIdx.z;
  const int rr0 = blockIdx.y * STEM_BAND, rr1 = min(rr0 + STEM_BAND, hp);
  int8_t* o = out + ((size_t)b * hp * wp + cc) * C + g * 8;
  const size_t row_step = (size_t)wp * C;

  if (cc == 0 || cc > W2) {  // a ring column
    for (int rr = rr0; rr < rr1; ++rr)
      *reinterpret_cast<uint2*>(o + rr * row_step) = make_uint2(0u, 0u);
    return;
  }
  const int c2 = cc - 1;
  float bv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) bv[i] = round_to<T>(bias[g * 8 + i]);
  const float s = *s_in;
  const T* img = y + (size_t)b * H1 * W1 * C + g * 8;
  const size_t in_row = (size_t)W1 * C;

  Vec<T, 8> carry;  // row 2r + 1 of the previous output row r, once read
  bool have = false;
  for (int rr = rr0; rr < rr1; ++rr) {
    union { int8_t q[8]; uint2 u; } res;
    if (rr == 0 || rr > H2) {  // a ring row
      res.u = make_uint2(0u, 0u);
    } else {
      const int r = rr - 1;  // rows 2r - 1, 2r, 2r + 1; 2r < H1 always
      Vec<T, 8> m = window_row(img + 2 * r * in_row, c2, W1, C);
      if (have) {
        take_max(m, carry);
      } else if (r > 0) {
        take_max(m, window_row(img + (2 * r - 1) * in_row, c2, W1, C));
      }
      have = 2 * r + 1 < H1;
      if (have) {
        carry = window_row(img + (2 * r + 1) * in_row, c2, W1, C);
        take_max(m, carry);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v = round_to<T>(__fadd_rn(static_cast<float>(key(m.v[i])), bv[i]));
        v = v > 0.f ? v : 0.f;
        const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
        res.q[i] = static_cast<int8_t>(__float2int_rn(q));
      }
    }
    *reinterpret_cast<uint2*>(o + rr * row_step) = res.u;
  }
}

template <typename T>
int launch_stem(const void* y, const float* bias, const float* s_in, int8_t* out, int B, int H1,
                int W1, int C, int H2, int W2, int hp, int wp, cudaStream_t stream) {
  const dim3 grid((wp * (C / 8) + STEM_THREADS - 1) / STEM_THREADS,
                  (hp + STEM_BAND - 1) / STEM_BAND, B);
  if (B == 0) return 0;
  stem_pool_int8_kernel<T><<<grid, STEM_THREADS, 0, stream>>>(
      static_cast<const T*>(y), bias, s_in, out, H1, W1, C, H2, W2, hp, wp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec: 1 when C * sizeof(T) is a multiple of 16 and x, out are 16-byte
// aligned (16-byte groups of channels), else 0 (one channel per thread).
extern "C" int max_pool2d_nhwc(const void* x, void* out, int kind, int vec, int B, int H,
                               int W, int C, int OH, int OW, int k, int s, int p,
                               cudaStream_t stream) {
  switch (kind) {
    case KIND_BF16:
      return launch<__nv_bfloat16>(x, out, vec, B, H, W, C, OH, OW, k, s, p, stream);
    case KIND_F32:
      return launch<float>(x, out, vec, B, H, W, C, OH, OW, k, s, p, stream);
    case KIND_I8:
      return launch<int8_t>(x, out, vec, B, H, W, C, OH, OW, k, s, p, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Average pool; bf16 or fp32; vec as for max_pool2d_nhwc; inv: the fp32
// value of 1/k^2 that the output is multiplied by.
extern "C" int avg_pool2d_nhwc(const void* x, void* out, int kind, int vec, int B, int H,
                               int W, int C, int OH, int OW, int k, int s, int p, float inv,
                               cudaStream_t stream) {
  switch (kind) {
    case KIND_BF16:
      return launch_avg<__nv_bfloat16>(x, out, vec, B, H, W, C, OH, OW, k, s, p, inv, stream);
    case KIND_F32:
      return launch_avg<float>(x, out, vec, B, H, W, C, OH, OW, k, s, p, inv, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The int8_chain stem's tail: y (B, H1, W1, C) bf16 (kind 1) or fp32 (kind
// 2), C a multiple of 16, y 16-byte aligned; bias (C,) fp32; s_in one fp32
// on the card; out the (B * hp * wp, C) int8 chain rows of the pooled
// (H2, W2) map, every byte written.
extern "C" int stem_pool_int8(const void* y, const float* bias, const float* s_in, int8_t* out,
                              int kind, int B, int H1, int W1, int C, int H2, int W2, int hp,
                              int wp, cudaStream_t stream) {
  switch (kind) {
    case KIND_BF16:
      return launch_stem<__nv_bfloat16>(y, bias, s_in, out, B, H1, W1, C, H2, W2, hp, wp,
                                        stream);
    case KIND_F32:
      return launch_stem<float>(y, bias, s_in, out, B, H1, W1, C, H2, W2, hp, wp, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
