// The bf16 / fp32 stride-1 bottleneck block of the `pallas_block` backend:
//
//     z1 = round(relu(x . w1 + b1))                      1x1, 4c -> c
//     z2 = round(relu(((P0 + P1) + P2) + b2))            3x3 stride 1 pad 1, c -> c
//          P_kh = sum over (kw, ci) of z1[y + kh - 1, x + kw - 1, ci] * w2[kh, kw, ci, :]
//     y  = round(relu(((z2 . w3) + b3) + x))             1x1, c -> 4c, identity residual
//
// x, w1 (4c, c), w2 HWIO (3, 3, c, c), w3 (c, 4c) and the output all bf16
// or all fp32; biases fp32; every dot accumulates in fp32; round() is the
// cast to the compute type.  The three steps and their order of operations
// are those of the TPU kernels (kh partials summed as (P0 + P1) + P2).
//
// Replaces two TPU kernels over one piece of code:
//   resnetc_tpu/ops/pallas/block.py:278 `bottleneck_block_chained`
//     (pallas_call :320; body `_chained_kernel` :152), chain = 1: x and the
//     output are the chained padded-row layout (B*hp*wp, 4c).  Only interior
//     rows of x are read (a ring row may hold anything: the TPU kernel's
//     NaN-killing `where`), and the output's ring rows are written as zeros.
//     Every identity block of the `pallas_block` backend, 46 per ResNet-152
//     forward;
//   resnetc_tpu/ops/pallas/block.py:3688 `bottleneck_block_fused`
//     (pallas_call :3740; body `_block_kernel` :95), chain = 0: x and the
//     output are NHWC (B, h, w, 4c), the zero ring implicit.  Op library.
//
// Design.  Three launches on the caller's stream, z1 and z2 through device
// memory as compact NHWC (B*h*w, c) in the compute type (the same rounding
// points as the TPU kernels).  Each launch is one tile GEMM, a 64-row x
// 64-column tile per block of 256 threads (4 x 4 outputs a thread), K
// staged sixteen values at a time through shared memory as fp32:
//   conv1: rows = the B*h*w interior pixels, A row = the pixel's row of x;
//   conv2: rows = pixels, A gathered per tap from z1 with a bounds check
//          that stands for the zero ring (no padded copy of z1 exists), one
//          K segment of 3c per kernel row kh, summed as the TPU kernel does;
//   conv3: rows = every row of the output (chain rows, ring included, or
//          pixels), A = the row's pixel of z2 (zeros on the ring), + b3,
//          + the residual read from x at the same row, relu, ring rows 0.
// The TPU kernel's kw-interleaved scratch, its row-offset implicit GEMM with
// kh batched into N, and its batch tiles exist to feed Mosaic aligned
// contiguous slices; a per-tap gather with a bounds check has no such need.
//
// What bounds it.  2 * B*h*w * 17c^2 flops (14 GFLOP at batch 32 at every
// ResNet-152 stage) against two passes over B*hp*wp*4c values: at c >= 256
// the bf16 tensor-core rate (~14 us), at c = 64 and 128 the bytes (15-36
// us).  This first version multiplies on the CUDA cores in fp32 FMAs, well
// below both (PERF.md section 6 has its times); tensor cores (mma / wgmma on
// bf16 tiles), one launch with z1 and z2 kept on chip, and skipping the ring
// rows of conv3 are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;  // rows per block
constexpr int BN = 64;  // output channels per block
constexpr int BK = 16;  // K values per stage
constexpr int THREADS = 256;

enum Kind { KIND_BF16 = 1, KIND_F32 = 2 };
enum Stage { CONV1 = 1, CONV2 = 2, CONV3 = 3 };

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

// max(v, 0) that keeps a NaN, as jnp.maximum and torch.relu do.
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

struct Geo {
  int B, h, w, hp, wp, c, c4;
  int chain;  // 1: x and out are chain rows (B*hp*wp, c4); 0: NHWC (B*h*w, c4)
};

// Pixel p of the (B, h, w) interior -> its chain row.
__device__ __forceinline__ int chain_row(const Geo& g, int p) {
  const int hw = g.h * g.w;
  const int b = p / hw;
  const int rem = p - b * hw;
  const int y = rem / g.w;
  return (b * g.hp + y + 1) * g.wp + (rem - y * g.w) + 1;
}

// Chain row t -> its interior pixel, or -1 on the ring.
__device__ __forceinline__ int pixel_of(const Geo& g, int t) {
  const int per = g.hp * g.wp;
  const int b = t / per;
  const int rem = t - b * per;
  const int r = rem / g.wp;
  const int col = rem - r * g.wp;
  if (r < 1 || r > g.h || col < 1 || col > g.w) return -1;
  return (b * g.h + r - 1) * g.w + col - 1;
}

// One step of the block as a tile GEMM: out (M, N) from A (M, K) . wt (K, N).
// CONV1: a = x, K = 4c.  CONV2: a = z1, K = 9c in three kh segments of 3c.
// CONV3: a = z2, K = c, residual x.  kseg is the K of one segment.
template <typename T, int STAGE>
__global__ void __launch_bounds__(THREADS)
fp_block_step(const T* __restrict__ a, const T* __restrict__ wt, const float* __restrict__ bias,
              const T* __restrict__ x, T* __restrict__ out, Geo g, int M, int N, int kseg) {
  __shared__ float As[BK][BM + 4];  // As[kk][m]
  __shared__ float Bs[BK][BN + 4];  // Bs[kk][n]
  __shared__ int rowA[BM];          // the row's A row (CONV2: its pixel), -1: zeros
  __shared__ int rowY[BM], rowX[BM];  // CONV2: the pixel's position in its image

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  if (tid < BM) {
    const int m = m0 + tid;
    int ra = -1, ry = 0, rx = 0;
    if (m < M) {
      if (STAGE == CONV1) {
        ra = g.chain ? chain_row(g, m) : m;
      } else if (STAGE == CONV3) {
        ra = g.chain ? pixel_of(g, m) : m;
      } else {
        ra = m;
        const int rem = m % (g.h * g.w);
        ry = rem / g.w;
        rx = rem - ry * g.w;
      }
    }
    rowA[tid] = ra;
    rowY[tid] = ry;
    rowX[tid] = rx;
  }
  __syncthreads();

  float tot[4][4];
  constexpr int SEGS = STAGE == CONV2 ? 3 : 1;
#pragma unroll 1
  for (int seg = 0; seg < SEGS; ++seg) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < kseg; k0 += BK) {
      // A tile: neighbouring threads on neighbouring channels of one row.
#pragma unroll
      for (int t = 0; t < (BM * BK) / THREADS; ++t) {
        const int e = tid + t * THREADS;
        const int m = e / BK, kk = e % BK;
        const int gk = k0 + kk;
        const int ra = rowA[m];
        float v = 0.f;
        if (ra >= 0 && gk < kseg) {
          if (STAGE == CONV2) {
            // Segment seg is kernel row kh = seg; gk runs over (kw, ci).
            const int kw = gk / g.c;
            const int ci = gk - kw * g.c;
            const int iy = rowY[m] + seg - 1, ix = rowX[m] + kw - 1;
            if (iy >= 0 && iy < g.h && ix >= 0 && ix < g.w)
              v = to_f32(a[(size_t)(ra + (seg - 1) * g.w + kw - 1) * g.c + ci]);
          } else {
            v = to_f32(a[(size_t)ra * kseg + gk]);
          }
        }
        As[kk][m] = v;
      }
      // B tile: rows of the weight, coalesced over the output channels.
#pragma unroll
      for (int t = 0; t < (BK * BN) / THREADS; ++t) {
        const int e = tid + t * THREADS;
        const int kk = e / BN, n = e % BN;
        const int gk = k0 + kk, gn = n0 + n;
        Bs[kk][n] = (gk < kseg && gn < N) ? to_f32(wt[(size_t)(seg * kseg + gk) * N + gn]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
    // The kh partials in the TPU kernel's order: (P0 + P1) + P2.
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) tot[i][j] = seg == 0 ? acc[i][j] : __fadd_rn(tot[i][j], acc[i][j]);
  }

  // Epilogue: + bias, (+ residual), relu, round.  Rows past M and channels
  // past N are never written; ring rows of a chain output are zeros.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lm = ty + 16 * i;
    const int gm = m0 + lm;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      const size_t o = (size_t)gm * N + gn;
      float v = __fadd_rn(tot[i][j], bias[gn]);
      if (STAGE == CONV3) {
        if (rowA[lm] < 0) {
          out[o] = from_f32<T>(0.f);
          continue;
        }
        v = __fadd_rn(v, to_f32(x[o]));
      }
      out[o] = from_f32<T>(relu(v));
    }
  }
}

template <typename T, int STAGE>
int step(const void* a, const void* wt, const float* bias, const void* x, void* out, const Geo& g,
         int M, int N, int kseg, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fp_block_step<T, STAGE><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(wt), bias, static_cast<const T*>(x),
      static_cast<T*>(out), g, M, N, kseg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int block(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
          const void* w3, const float* b3, void* z1, void* z2, void* out, const Geo& g,
          cudaStream_t stream) {
  const int pixels = g.B * g.h * g.w;
  const int rows = g.chain ? g.B * g.hp * g.wp : pixels;
  if (pixels == 0) return 0;
  int rc = step<T, CONV1>(x, w1, b1, nullptr, z1, g, pixels, g.c, g.c4, stream);
  if (rc) return rc;
  rc = step<T, CONV2>(z1, w2, b2, nullptr, z2, g, pixels, g.c, 3 * g.c, stream);
  if (rc) return rc;
  return step<T, CONV3>(z2, w3, b3, x, out, g, rows, g.c4, g.c, stream);
}

}  // namespace

// kind: KIND_BF16 or KIND_F32 (x, the weights, z1, z2, out); chain: 1 for
// the chained padded-row layout (x, out (B*hp*wp, c4)), 0 for NHWC (x, out
// (B, h, w, c4); hp and wp unused).  z1, z2: (B*h*w, c) scratch.
extern "C" int fp_block(const void* x, const void* w1, const float* b1, const void* w2,
                        const float* b2, const void* w3, const float* b3, void* z1, void* z2,
                        void* out, int kind, int chain, int B, int h, int w, int hp, int wp,
                        int c, int c4, cudaStream_t stream) {
  const Geo g{B, h, w, hp, wp, c, c4, chain};
  if (kind == KIND_BF16)
    return block<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, z1, z2, out, g, stream);
  if (kind == KIND_F32) return block<float>(x, w1, b1, w2, b2, w3, b3, z1, z2, out, g, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
