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
// points as the TPU kernels).
//
//   bf16: each launch is one product on the tensor-core tile of
//   bf16_tile.cuh (wgmma from a swizzled cp.async ring, fp32 sums in
//   registers, the weight read in its own (K, N) order):
//     conv1: rows = the B*h*w interior pixels, A row = the pixel's row of x
//            (GemmALoader, MAP_PIXEL_TO_CHAIN): the ring rows of x are never
//            read, so a NaN there reaches nothing;
//     conv2: the im2col loader (ConvALoader, stride 1) over z1, the zero
//            padding as zero-filled copies; the wgmma sum restarts at every
//            kernel row (tap = 3c) and the three kh partials are added in
//            fp32 round-to-nearest as ((0 + P0) + P1) + P2, the TPU kernel's
//            order;
//     conv3: rows = every row of the output (chain rows, ring included, or
//            pixels), A = the row's pixel of z2 (MAP_CHAIN_TO_PIXEL: a ring
//            row's A is zero-filled), + b3, + the residual read from x at
//            the same row, relu; a ring row is written as zeros by a select
//            in the epilogue (Epi::ring), its residual never read.
//   The two forms share every launch and plan (conv3's tile shape is chosen
//   from the pixel count in both), so the NHWC form equals the interior of
//   the chained one bit for bit.
//
//   The fold span.  The tensor cores' accumulation truncates, so a longer
//   run of products between two round-to-nearest adds drifts further from
//   the plain version.  Folding per kernel row spans 3c products (1,536 at
//   c = 512); folding per tap (tap = c) spans c but regroups the kh sum.
//   Per kernel row is kept: it is the TPU kernel's order, both spans gave
//   the same max error / max |plain| at ResNet-152's four stage shapes on
//   an H100 (2.7e-3 to 5.4e-3 against FP_BLOCK_TOL's 1e-2: one bf16 step
//   at the largest values), and it was 0-2% faster (two drains a tile
//   instead of eight).
//
//   fp32: a 64-row x 64-column tile per block of 256 threads on the CUDA
//   cores (4 x 4 outputs a thread), K staged sixteen values at a time
//   through shared memory, the same rows and order as above (conv2 gathers
//   each tap with a bounds check that stands for the zero ring).  The FP32
//   policy's gates (1e-3 of the fp32 logits) need digits that TF32 tensor
//   cores would spend.
// The TPU kernel's kw-interleaved scratch, its row-offset implicit GEMM with
// kh batched into N, and its batch tiles exist to feed Mosaic aligned
// contiguous slices; neither form needs them.
//
// What bounds it.  2 * B*h*w * 17c^2 flops (14 GFLOP at batch 32 at every
// ResNet-152 stage) against two passes over B*hp*wp*4c values: at c >= 256
// the bf16 tensor-core rate (~14 us), at c = 64 and 128 the bytes (15-36
// us).  The bf16 form still moves z1 and z2 through device memory and
// computes conv3 on the ring rows; one launch with z1 and z2 kept on chip
// (which needs halo recomputation for the 3x3) is later work.

#include "bf16_tile.cuh"

namespace {

using bf16tile::bf16;
using bf16tile::Chain;

constexpr int BM = 64;  // rows per block (fp32 tile)
constexpr int BN = 64;  // output channels per block (fp32 tile)
constexpr int BK = 16;  // K values per stage (fp32 tile)
constexpr int THREADS = 256;

using bf16tile::KIND_BF16;
using bf16tile::KIND_F32;

enum Stage { CONV1 = 1, CONV2 = 2, CONV3 = 3 };

struct Geo {
  int B, h, w, hp, wp, c, c4;
  int chain;  // 1: x and out are chain rows (B*hp*wp, c4); 0: NHWC (B*h*w, c4)
  __host__ __device__ Chain ch() const { return Chain{h, w, hp, wp}; }
};

// ---------------------------------------------------------------------------
// fp32: the CUDA-core tile
// ---------------------------------------------------------------------------

// One step of the block as a tile GEMM: out (M, N) from A (M, K) . wt (K, N).
// CONV1: a = x, K = 4c.  CONV2: a = z1, K = 9c in three kh segments of 3c.
// CONV3: a = z2, K = c, residual x.  kseg is the K of one segment.
template <int STAGE>
__global__ void __launch_bounds__(THREADS)
fp_block_step(const float* __restrict__ a, const float* __restrict__ wt,
              const float* __restrict__ bias, const float* __restrict__ x,
              float* __restrict__ out, Geo g, int M, int N, int kseg) {
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
        ra = g.chain ? bf16tile::chain_row(g.ch(), m) : m;
      } else if (STAGE == CONV3) {
        ra = g.chain ? bf16tile::pixel_of(g.ch(), m) : m;
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
              v = a[(size_t)(ra + (seg - 1) * g.w + kw - 1) * g.c + ci];
          } else {
            v = a[(size_t)ra * kseg + gk];
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
        Bs[kk][n] = (gk < kseg && gn < N) ? wt[(size_t)(seg * kseg + gk) * N + gn] : 0.f;
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

  // Epilogue: + bias, (+ residual), relu.  Rows past M and channels past N
  // are never written; ring rows of a chain output are zeros.
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
          out[o] = 0.f;
          continue;
        }
        v = __fadd_rn(v, x[o]);
      }
      out[o] = relu_keep_nan(v);
    }
  }
}

template <int STAGE>
int step(const void* a, const void* wt, const float* bias, const void* x, void* out, const Geo& g,
         int M, int N, int kseg, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fp_block_step<STAGE><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(wt), bias,
      static_cast<const float*>(x), static_cast<float*>(out), g, M, N, kseg);
  return static_cast<int>(cudaGetLastError());
}

int block_f32(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
              const void* w3, const float* b3, void* z1, void* z2, void* out, const Geo& g,
              cudaStream_t stream) {
  const int pixels = g.B * g.h * g.w;
  const int rows = g.chain ? g.B * g.hp * g.wp : pixels;
  int rc = step<CONV1>(x, w1, b1, nullptr, z1, g, pixels, g.c, g.c4, stream);
  if (rc) return rc;
  rc = step<CONV2>(z1, w2, b2, nullptr, z2, g, pixels, g.c, 3 * g.c, stream);
  if (rc) return rc;
  return step<CONV3>(z2, w3, b3, x, out, g, rows, g.c4, g.c, stream);
}

// ---------------------------------------------------------------------------
// bf16: three launches of the tensor-core tile
// ---------------------------------------------------------------------------

template <int TBM, bool VEC>
using Conv2Loader = bf16tile::ConvALoader<TBM, VEC, 1>;

int block_bf16(const bf16* x, const bf16* w1, const float* b1, const bf16* w2, const float* b2,
               const bf16* w3, const float* b3, bf16* z1, bf16* z2, bf16* out, const Geo& g,
               cudaStream_t stream) {
  using namespace bf16tile;
  const int pixels = g.B * g.h * g.w;
  const int rows = g.chain ? g.B * g.hp * g.wp : pixels;
  const int c = g.c, c4 = g.c4;
  const bool vec = c % 8 == 0 && aligned16(x) && aligned16(w1) && aligned16(w2) &&
                   aligned16(w3) && aligned16(z1) && aligned16(z2);

  // conv1: z1 = relu(x . w1 + b1) over the interior pixels.
  const GemmA a1{x, pixels, c4, g.chain ? MAP_PIXEL_TO_CHAIN : MAP_NONE, g.ch()};
  const Epi e1{b1, nullptr, z1, nullptr, pixels, c, bf16tile::KIND_NONE, 1, 1};
  cudaError_t e = run<GemmALoader>(a1, w1, e1, c4, make_plan(pixels, c, c4, false), vec,
                                   /*tap=*/0, stream);
  if (e != cudaSuccess) return static_cast<int>(e);

  // conv2: z2 = relu(((P0 + P1) + P2) + b2), the wgmma sum restarting at
  // every kernel row (tap = 3c).
  const ConvA a2{z1, g.B, g.h, g.w, c, g.h, g.w, 3};
  const Epi e2{b2, nullptr, z2, nullptr, pixels, c, bf16tile::KIND_NONE, 1, 1};
  e = run<Conv2Loader>(a2, w2, e2, 9 * c, make_plan(pixels, c, 9 * c, false), vec,
                       /*tap=*/3 * c, stream);
  if (e != cudaSuccess) return static_cast<int>(e);

  // conv3: out = relu((z2 . w3 + b3) + x), ring rows zero.  The plan is the
  // pixel count's in both forms.
  const GemmA a3{z2, rows, c, g.chain ? MAP_CHAIN_TO_PIXEL : MAP_NONE, g.ch()};
  Epi e3{b3, x, out, nullptr, rows, c4, KIND_BF16, 1, 1};
  if (g.chain) e3.ring = g.ch();
  return static_cast<int>(run<GemmALoader>(a3, w3, e3, c, make_plan(pixels, c4, c, false), vec,
                                           /*tap=*/0, stream));
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
  if (B * h * w == 0) return 0;
  if (kind == KIND_BF16)
    return block_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
                      static_cast<const bf16*>(w2), b2, static_cast<const bf16*>(w3), b3,
                      static_cast<bf16*>(z1), static_cast<bf16*>(z2), static_cast<bf16*>(out), g,
                      stream);
  if (kind == KIND_F32) return block_f32(x, w1, b1, w2, b2, w3, b3, z1, z2, out, g, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
