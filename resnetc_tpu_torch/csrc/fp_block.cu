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
// are those of the TPU kernels (kh partials summed as (P0 + P1) + P2; the
// fp32 form regroups the kh sum, below).  In fp32 the kernel reads each
// weight's split (N, K) copy in its place (w1_nk, w2_nk, w3_nk).
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
//   fp32: the same three launches, each one product on the split-fp32 tile
//   of tf32x3_tile.cuh (three TF32 wgmma products per fp32 product, A split
//   in shared memory, B from the engine's split (N, K) copy w_nk, (2, N, K),
//   sums drained into round-to-nearest fp32 totals every 32 values of K):
//     conv1: ChainA32Loader with MAP_PIXEL_TO_CHAIN over x, B = w1_nk (2, c,
//            4c);
//     conv2: ConvA32Loader<.., 1> over z1, K = 9c in (kh, kw, ci) order, B =
//            w2_nk (2, c, 9c) (gemm.pack_nk of the HWIO weight);
//     conv3: ChainA32Loader with MAP_CHAIN_TO_PIXEL over z2, B = w3_nk (2, 4c,
//            c), + b3, + x, relu, ring rows zeroed by Epi::ring.
//   The FP32 policy's gates (1e-3 of the fp32 logits) need digits that one
//   TF32 product would spend.  conv2's kh sum: the tile's running drain
//   (every 32 values of K into one fp32 total, whatever the kernel row), not
//   the TPU kernel's (P0 + P1) + P2.  Both were built and measured on an
//   H100 at ResNet-152's four stage shapes (batch 8 and 32): a drain per
//   kernel row into a second register total gave the same max error / max
//   |plain| against the float64 plain version (2.8e-7 to 4.0e-7 both; the
//   spans differ from the plain version's per-row float64 sums either way),
//   took 246 registers at 128 x 128 against 176-215, and was 11% slower at
//   stage 0 (0.406 against 0.365 ms at batch 32), level at the others.
// The TPU kernel's kw-interleaved scratch, its row-offset implicit GEMM with
// kh batched into N, and its batch tiles exist to feed Mosaic aligned
// contiguous slices; neither form needs them.
//
// What bounds it.  2 * B*h*w * 17c^2 flops (14 GFLOP at batch 32 at every
// ResNet-152 stage) against two passes over B*hp*wp*4c values: in bf16 at
// c >= 256 the tensor-core rate (~14 us), at c = 64 and 128 the bytes (15-36
// us); in fp32 the split product's 495 / 3 = 165 TFLOP/s (85 us at every
// stage; the CUDA cores' 67 TFLOP/s would take 209).  Measured on an H100
// at batch 32 (utils/fp32_ab.py): the fp32 chained block 0.275-0.406 ms at
// ResNet-152's four stage shapes, 21-31% of that bound, 2.4-3.3x the
// CUDA-core tile it replaced; within 4.4e-7 of max |plain| of the float64
// plain version (5.9e-7 over a chain of three).  Both forms still move z1
// and z2 through device memory and compute conv3 on the ring rows (the NHWC
// form, without them, is 7-10% faster in fp32); one launch with z1 and z2
// kept on chip (which needs halo recomputation for the 3x3) is later work.

#include "tf32x3_tile.cuh"

namespace {

using bf16tile::bf16;
using bf16tile::Chain;
using bf16tile::KIND_BF16;
using bf16tile::KIND_F32;

struct Geo {
  int B, h, w, hp, wp, c, c4;
  int chain;  // 1: x and out are chain rows (B*hp*wp, c4); 0: NHWC (B*h*w, c4)
  __host__ __device__ Chain ch() const { return Chain{h, w, hp, wp}; }
};

// ---------------------------------------------------------------------------
// fp32: three launches of the split-fp32 tile
// ---------------------------------------------------------------------------

template <int TBM, bool VEC>
using Conv2Loader32 = tf32tile::ConvA32Loader<TBM, VEC, 1>;

int block_f32(const float* x, const float* w1_nk, const float* b1, const float* w2_nk,
              const float* b2, const float* w3_nk, const float* b3, float* z1, float* z2,
              float* out, const Geo& g, cudaStream_t stream) {
  using namespace tf32tile;
  if (w1_nk == nullptr || w2_nk == nullptr || w3_nk == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pixels = g.B * g.h * g.w;
  const int rows = g.chain ? g.B * g.hp * g.wp : pixels;
  const int c = g.c, c4 = g.c4;
  const bool vec = c % 4 == 0 && aligned16(x) && aligned16(w1_nk) && aligned16(w2_nk) &&
                   aligned16(w3_nk) && aligned16(z1) && aligned16(z2);

  // conv1: z1 = relu(x . w1 + b1) over the interior pixels.
  const ChainA32 a1{x, pixels, c4, g.chain ? MAP_PIXEL_TO_CHAIN : MAP_NONE, g.ch()};
  const Epi e1{b1, nullptr, z1, nullptr, pixels, c, KIND_NONE, 0, 1};
  cudaError_t e = run_f32<ChainA32Loader>(a1, w1_nk, e1, c4,
                                          make_plan_f32(pixels, c, c4, false), vec, stream);
  if (e != cudaSuccess) return static_cast<int>(e);

  // conv2: z2 = relu(conv3x3(z1) + b2), drained every 32 values of K.
  const ConvA32 a2{z1, g.B, g.h, g.w, c, g.h, g.w, 3};
  const Epi e2{b2, nullptr, z2, nullptr, pixels, c, KIND_NONE, 0, 1};
  e = run_f32<Conv2Loader32>(a2, w2_nk, e2, 9 * c, make_plan_f32(pixels, c, 9 * c, false), vec,
                             stream);
  if (e != cudaSuccess) return static_cast<int>(e);

  // conv3: out = relu((z2 . w3 + b3) + x), ring rows zero.  The plan is the
  // pixel count's in both forms.
  const ChainA32 a3{z2, rows, c, g.chain ? MAP_CHAIN_TO_PIXEL : MAP_NONE, g.ch()};
  Epi e3{b3, x, out, nullptr, rows, c4, KIND_F32, 0, 1};
  if (g.chain) e3.ring = g.ch();
  return static_cast<int>(run_f32<ChainA32Loader>(a3, w3_nk, e3, c,
                                                  make_plan_f32(pixels, c4, c, false), vec,
                                                  stream));
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

// kind: KIND_BF16 or KIND_F32 (x, z1, z2, out); chain: 1 for the chained
// padded-row layout (x, out (B*hp*wp, c4)), 0 for NHWC (x, out (B, h, w,
// c4); hp and wp unused).  z1, z2: (B*h*w, c) scratch.  bf16 reads w1 (4c,
// c), w2 HWIO (3, 3, c, c), w3 (c, 4c); fp32 reads w1_nk (2, c, 4c), w2_nk
// (2, c, 9c), w3_nk (2, 4c, c) in their place: the TF32 heads and tails of
// each weight's (N, K) copy (gemm.pack_nk).
extern "C" int fp_block(const void* x, const void* w1, const float* w1_nk, const float* b1,
                        const void* w2, const float* w2_nk, const float* b2, const void* w3,
                        const float* w3_nk, const float* b3, void* z1, void* z2, void* out,
                        int kind, int chain, int B, int h, int w, int hp, int wp, int c, int c4,
                        cudaStream_t stream) {
  const Geo g{B, h, w, hp, wp, c, c4, chain};
  if (B * h * w == 0) return 0;
  if (kind == KIND_BF16)
    return block_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
                      static_cast<const bf16*>(w2), b2, static_cast<const bf16*>(w3), b3,
                      static_cast<bf16*>(z1), static_cast<bf16*>(z2), static_cast<bf16*>(out), g,
                      stream);
  if (kind == KIND_F32)
    return block_f32(static_cast<const float*>(x), w1_nk, b1, w2_nk, b2, w3_nk, b3,
                     static_cast<float*>(z1), static_cast<float*>(z2), static_cast<float*>(out),
                     g, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
