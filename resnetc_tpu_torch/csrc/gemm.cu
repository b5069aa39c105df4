// GEMM with fp32 accumulation and a fused epilogue:
//
//     out = relu?(x @ w + bias + residual)
//
// x (M, K) and w (K, N) row-major, both bf16 or both fp32; bias (N,) fp32,
// residual (M, N) bf16 or fp32 (read in its own type), either may be
// absent; out fp32 or bf16.  In fp32 the kernel reads w_nk in its place:
// the TF32 heads and tails of w's (N, K) copy, (2, N, K).
//
// Replaces resnetc_tpu/ops/pallas/gemm.py:100 `matmul` (body `_gemm_kernel`,
// gemm.py:28): every 1x1 convolution of the `pallas` backend (M = batch *
// h * w pixels, K and N 64-2048) and the fc head of every serving path,
// (B, 2048) bf16 x (2048, 1000) bf16 -> fp32.
//
// What bounds it.  The 1x1s do 2*K flops per byte of x read at K >= 64, so
// at batch 32 they are bound by the bf16 tensor-core rate; the fc does
// 2*B*2048*1000 flops against 4 MB of weights read once, so it is bound by
// reading w.
//
// Design.  bf16 runs on the tensor cores through the shared tile of
// bf16_tile.cuh (wgmma from a swizzled cp.async ring, fp32 sums in
// registers; the weight read in its (K, N) order through wgmma's transpose
// bit).  A product whose output tiles cannot fill the card splits K
// (make_plan): at the fc, 16 tiles of 64 x 64 become 128 blocks of four K
// stages each, whose fp32 partials go to a workspace the wrapper allocates
// (gemm_workspace_floats) and are summed in a fixed order by a second
// kernel, so every call gives the same bits.
//
// The fp32 form (the FP32 policy: every 1x1 of the `pallas` backend, 105
// launches a ResNet-152 forward with the fc) runs on the tensor cores too,
// through the split-fp32 tile of tf32x3_tile.cuh: each operand split into
// two TF32 parts, three TF32 products per fp32 product, the weight read
// from w_nk, its (N, K) copy split once (TF32 wgmma has no transpose
// bit), the sums drained
// into round-to-nearest fp32 totals every 32 values of K.  What bounds it:
// fp32 on the CUDA cores peaks at 67 TFLOP/s, the split product at 495 / 3
// = 165 TFLOP/s; the 1x1s with few K stages are bound by their output and
// residual, the fc by reading its weight.  Split-K and its fixed-order
// reduce as in bf16.  Measured on an H100 at ResNet-152's 1x1 and fc
// shapes, batch 32 (utils/fp32_ab.py): within 2.3e-7 to 4.5e-7 of max
// |plain| of the plain version's float64 sums (at most 2.4e-6 apart), at
// 26-60% of the bound, 0.77x IEEE torch.matmul's time over a forward.

#include "tf32x3_tile.cuh"

// Floats of workspace the product of this shape needs (its split-K
// partial sums), 0 when it does not split.
extern "C" long long gemm_workspace_floats(int M, int N, int K, int in_bf16) {
  const bf16tile::Plan p = in_bf16 ? bf16tile::make_plan(M, N, K, /*may_split=*/true)
                                   : tf32tile::make_plan_f32(M, N, K, /*may_split=*/true);
  return p.splits > 1 ? static_cast<long long>(p.splits) * M * N : 0;
}

// res_kind: 0 none, 1 bf16, 2 fp32.  ws: gemm_workspace_floats(...) floats,
// or NULL when that is 0.  bf16 reads w (K, N); fp32 reads w_nk, the TF32
// heads and tails of its (N, K) copy, (2, N, K).
extern "C" int gemm_f32acc(const void* x, const void* w, const float* w_nk, const float* bias,
                           const void* res, void* out, float* ws, int in_bf16, int res_kind,
                           int out_bf16, int M, int N, int K, int relu, cudaStream_t stream) {
  const bf16tile::Plan p = in_bf16 ? bf16tile::make_plan(M, N, K, /*may_split=*/true)
                                   : tf32tile::make_plan_f32(M, N, K, /*may_split=*/true);
  if (p.splits > 1 && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const bf16tile::Epi ep{bias, res, out, ws, M, N, res_kind, out_bf16, relu};
  if (!in_bf16) {
    if (w_nk == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = K % 4 == 0 && bf16tile::aligned16(x) && bf16tile::aligned16(w_nk);
    return static_cast<int>(tf32tile::run_f32<tf32tile::GemmA32Loader>(
        tf32tile::GemmA32{static_cast<const float*>(x), M, K}, w_nk, ep, K, p, vec, stream));
  }
  const bool vec = K % 8 == 0 && N % 8 == 0 && bf16tile::aligned16(x) && bf16tile::aligned16(w);
  return static_cast<int>(bf16tile::run<bf16tile::GemmALoader>(
      bf16tile::GemmA{static_cast<const __nv_bfloat16*>(x), M, K},
      static_cast<const __nv_bfloat16*>(w), ep, K, p, vec, /*tap=*/0, stream));
}
