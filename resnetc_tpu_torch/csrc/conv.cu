// Fused convolutions of the `pallas` and `int8` serving backends:
//
//     out = relu?(conv(x, w) + bias + residual)
//
// x NHWC (B, H, W, Cin), w HWIO (k, k, Cin, Cout), both bf16 or both fp32;
// bias (Cout,) fp32, optional; residual (B, OH, OW, Cout) bf16 or fp32,
// optional; out bf16 or fp32.  Zero padding k/2, stride S (a template
// parameter): OH = (H + 2*(k/2) - k) / S + 1.  In fp32 the kernel reads
// w_nk in its place: the TF32 heads and tails of w's (Cout, k*k*Cin) copy,
// (2, Cout, k*k*Cin).
//
// Replaces two TPU kernels:
//   resnetc_tpu/ops/pallas/conv.py:150 `conv3x3_s1_fused` (pallas_call :232),
//     k = 3, S = 1: every stride-1 3x3 of the two backends, with the
//     residual for the basic family's second conv;
//   resnetc_tpu/ops/pallas/conv.py:287 `conv_s2_fused` (pallas_call :379;
//     `conv3x3_s2_fused` :402 is an alias), odd k, S = 2, no residual: the
//     three stride-2 3x3s of each network.
//
// What bounds it.  A ResNet 3x3 at batch 32 does 2*9*Cin*Cout flops per
// pixel (7.4 GFLOP for each bottleneck 3x3 of ResNet-152, stride 1 or 2)
// against a few tens of MB: far above the ridge, so the bound is the bf16
// tensor-core rate (~7.5 us; ~3.7 us for ResNet-34's stride-2 convs).
//
// Design.  One implicit GEMM per launch: M = B*OH*OW output pixels, N =
// Cout, K = k*k*Cin ordered (u, v, ci) as the HWIO weight rows are.  Tap (u,
// v) of output pixel (r, c) reads x[r*S + u - k/2, c*S + v - k/2]; a tap in
// the padding reads zeros, so no padded copy of x is ever written.  The TPU
// kernel's padded row layout, batch tiles and (for stride 2) phase planes
// exist because Mosaic wants static contiguous slices; none of that carries
// over.
//   - bf16, both strides (`conv3x3_s1_fused`, `conv_s2_fused` at any odd
//     k): the tensor-core tile of bf16_tile.cuh with its im2col loader
//     (ConvALoader<BM, VEC, S>): each 16-byte chunk of A is 8 channels of
//     one tap, copied by cp.async, zero-filled where the tap falls in the
//     padding; wgmma sums in fp32 registers.  The loader tests each tap
//     against the row's corner pixel and the image's H and W, so k has no
//     limit.  A Cin off the 8-channel grid (the Cin = 3 of a stem-like
//     7x7) is gathered value by value in the same kernel.
//   - fp32, both strides: the split-fp32 tile of tf32x3_tile.cuh with its
//     im2col loader (ConvA32Loader<BM, VEC, S>, 4 channels of one tap a
//     16-byte chunk, value by value where Cin % 4 != 0): each operand split
//     into two TF32 parts, three TF32 wgmma per fp32 product, the weight
//     read from w_nk, the (Cout, k*k*Cin) copy of the HWIO weight split
//     once (TF32 wgmma has no transpose bit).  fp32 on the CUDA cores peaks at 67 TFLOP/s,
//     the split product at 495 / 3 = 165 TFLOP/s, so a ResNet 3x3 at batch
//     32 is bound by the split product (~45 us for each 7.4 GFLOP 3x3 of
//     ResNet-152).  The FP32 policy's gates (1e-3 of the fp32 logits) need
//     fp32's digits, which one TF32 product would spend.  Measured on an
//     H100 at ResNet-152's seven 3x3 shapes, batch 32 (utils/fp32_ab.py):
//     0.129-0.215 ms, 21-34% of the bound, about half the time of IEEE
//     F.conv2d; within 3.6e-7 to 6.9e-7 of max |plain| of the plain
//     version (at most 3.1e-6 apart).
// The bf16 tile adds its per-tap sums in tap order, as the plain version
// and XLA's per-tap dots (the TPU kernel's one jnp.dot per tap) do; the
// fp32 tile drains its sums every 32 values of K, whatever the taps.
// Within a span both sum in another order than the plain version (float64
// per tap): bf16 outputs agree with it to fp32 rounding before the final
// cast, fp32 ones to the split's 2^-20 of each product and fp32 rounding.

#include "tf32x3_tile.cuh"

namespace {

template <int BM, bool VEC>
using ConvS1Loader = bf16tile::ConvALoader<BM, VEC, 1>;
template <int BM, bool VEC>
using ConvS2Loader = bf16tile::ConvALoader<BM, VEC, 2>;
template <int BM, bool VEC>
using ConvS1Loader32 = tf32tile::ConvA32Loader<BM, VEC, 1>;
template <int BM, bool VEC>
using ConvS2Loader32 = tf32tile::ConvA32Loader<BM, VEC, 2>;

}  // namespace

// in_kind: KIND_BF16 or KIND_F32 (x and w); stride 1 or 2.  bf16 reads w
// (HWIO); fp32 reads w_nk, its (Cout, k*k*Cin) copy split, (2, Cout,
// k*k*Cin).
extern "C" int conv_fused(const void* x, const void* w, const float* w_nk, const float* bias,
                          const void* res, void* out, int in_kind, int res_kind, int out_bf16,
                          int B, int H, int W, int Cin, int OH, int OW, int Cout, int k,
                          int stride, int relu, cudaStream_t stream) {
  if (stride != 1 && stride != 2) return static_cast<int>(cudaErrorInvalidValue);
  const int M = B * OH * OW, K = k * k * Cin;
  const bf16tile::Epi ep{bias, res, out, nullptr, M, Cout, res_kind, out_bf16, relu};
  if (in_kind == bf16tile::KIND_BF16) {
    const bool vec =
        Cin % 8 == 0 && Cout % 8 == 0 && bf16tile::aligned16(x) && bf16tile::aligned16(w);
    const bf16tile::ConvA a{static_cast<const __nv_bfloat16*>(x), B, H, W, Cin, OH, OW, k};
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    const bf16tile::Plan p = bf16tile::make_plan(M, Cout, K, /*may_split=*/false);
    return static_cast<int>(
        stride == 1 ? bf16tile::run<ConvS1Loader>(a, wb, ep, K, p, vec, /*tap=*/Cin, stream)
                    : bf16tile::run<ConvS2Loader>(a, wb, ep, K, p, vec, /*tap=*/Cin, stream));
  }
  if (w_nk == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = Cin % 4 == 0 && bf16tile::aligned16(x) && bf16tile::aligned16(w_nk);
  const tf32tile::ConvA32 a{static_cast<const float*>(x), B, H, W, Cin, OH, OW, k};
  const bf16tile::Plan p = tf32tile::make_plan_f32(M, Cout, K, /*may_split=*/false);
  return static_cast<int>(
      stride == 1 ? tf32tile::run_f32<ConvS1Loader32>(a, w_nk, ep, K, p, vec, stream)
                  : tf32tile::run_f32<ConvS2Loader32>(a, w_nk, ep, K, p, vec, stream));
}
