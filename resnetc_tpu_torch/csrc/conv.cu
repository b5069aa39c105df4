// Fused convolutions of the `pallas` and `int8` serving backends:
//
//     out = relu?(conv(x, w) + bias + residual)
//
// x NHWC (B, H, W, Cin), w HWIO (k, k, Cin, Cout), both bf16 or both fp32;
// bias (Cout,) fp32, optional; residual (B, OH, OW, Cout) bf16 or fp32,
// optional; out bf16 or fp32.  Zero padding k/2, stride S (a template
// parameter): OH = (H + 2*(k/2) - k) / S + 1.
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
//   - fp32: a 64-pixel x 64-channel tile on the CUDA cores (256 threads,
//     4 x 4 outputs a thread), K staged sixteen values at a time through
//     shared memory with a bounds check per value; ~12-14 TFLOP/s.  The
//     FP32 policy's gates (1e-3 of the fp32 logits) need digits that TF32
//     tensor cores would spend.
// The tile adds its per-tap sums in tap order, as the plain version and
// XLA's per-tap dots (the TPU kernel's one jnp.dot per tap) do; the FMA
// tile keeps one running sum over K.  Within a tap both sum in another
// order than a library dot (a product of two bf16 values is exact in
// fp32): outputs agree with the plain version to fp32 rounding before the
// final cast.

#include "bf16_tile.cuh"

namespace {

constexpr int BM = 64;  // output pixels per block
constexpr int BN = 64;  // output channels per block
constexpr int BK = 16;  // K values per stage
constexpr int THREADS = 256;

using bf16tile::KIND_BF16;
using bf16tile::KIND_F32;

template <int S>
__global__ void __launch_bounds__(THREADS)
conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, const void* __restrict__ res,
                void* __restrict__ out, int res_kind, int out_bf16, int B, int H, int W, int Cin,
                int OH, int OW, int Cout, int k, int relu) {
  __shared__ float As[BK][BM + 4];  // As[kk][m]
  __shared__ float Bs[BK][BN + 4];  // Bs[kk][n]
  __shared__ int rowB[BM], rowY[BM], rowX[BM];  // image and top-left input pixel

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int M = B * OH * OW;
  const int K = k * k * Cin;
  const int pad = k / 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  if (tid < BM) {
    const int m = m0 + tid;
    int b = -1, y = 0, xx = 0;
    if (m < M) {
      b = m / (OH * OW);
      const int rem = m - b * OH * OW;
      const int r = rem / OW;
      y = r * S - pad;
      xx = (rem - r * OW) * S - pad;
    }
    rowB[tid] = b;
    rowY[tid] = y;
    rowX[tid] = xx;
  }
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile, gathered: neighbouring threads on neighbouring channels.
#pragma unroll
    for (int t = 0; t < (BM * BK) / THREADS; ++t) {
      const int e = tid + t * THREADS;
      const int m = e / BK, kk = e % BK;
      const int gk = k0 + kk;
      const int b = rowB[m];
      float v = 0.f;
      if (b >= 0 && gk < K) {
        const int tap = gk / Cin;
        const int ci = gk - tap * Cin;
        const int u = tap / k;
        const int iy = rowY[m] + u;
        const int ix = rowX[m] + tap - u * k;
        if (iy >= 0 && iy < H && ix >= 0 && ix < W)
          v = x[(((size_t)b * H + iy) * W + ix) * Cin + ci];
      }
      As[kk][m] = v;
    }
    // B tile: rows of the HWIO weight, coalesced over the output channels.
#pragma unroll
    for (int t = 0; t < (BK * BN) / THREADS; ++t) {
      const int e = tid + t * THREADS;
      const int kk = e / BN, n = e % BN;
      const int gk = k0 + kk, gn = n0 + n;
      Bs[kk][n] = (gk < K && gn < Cout) ? w[(size_t)gk * Cout + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue in the Pallas kernel's order: + bias, + residual, relu, cast.
  // Rows past M and channels past Cout are masked, never written.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= Cout) continue;
      const size_t o = (size_t)gm * Cout + gn;
      float v = acc[i][j];
      if (bias) v = __fadd_rn(v, bias[gn]);
      if (res_kind == KIND_BF16)
        v = __fadd_rn(v, __bfloat162float(static_cast<const __nv_bfloat16*>(res)[o]));
      else if (res_kind == KIND_F32)
        v = __fadd_rn(v, static_cast<const float*>(res)[o]);
      if (relu) v = relu_keep_nan(v);
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
      else
        static_cast<float*>(out)[o] = v;
    }
  }
}

template <int S>
int launch_f32(const void* x, const void* w, const float* bias, const void* res, void* out,
               int res_kind, int out_bf16, int B, int H, int W, int Cin, int OH, int OW,
               int Cout, int k, int relu, cudaStream_t stream) {
  const int M = B * OH * OW;
  const dim3 grid((Cout + BN - 1) / BN, (M + BM - 1) / BM);
  conv_f32_kernel<S><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), bias, res, out, res_kind,
      out_bf16, B, H, W, Cin, OH, OW, Cout, k, relu);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, bool VEC>
using ConvS1Loader = bf16tile::ConvALoader<BM, VEC, 1>;
template <int BM, bool VEC>
using ConvS2Loader = bf16tile::ConvALoader<BM, VEC, 2>;

}  // namespace

// in_kind: KIND_BF16 or KIND_F32 (x and w); stride 1 or 2.
extern "C" int conv_fused(const void* x, const void* w, const float* bias, const void* res,
                          void* out, int in_kind, int res_kind, int out_bf16, int B, int H,
                          int W, int Cin, int OH, int OW, int Cout, int k, int stride,
                          int relu, cudaStream_t stream) {
  if (stride != 1 && stride != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (in_kind == KIND_BF16) {
    const int M = B * OH * OW, K = k * k * Cin;
    const bf16tile::Epi ep{bias, res, out, nullptr, M, Cout, res_kind, out_bf16, relu};
    const bool vec =
        Cin % 8 == 0 && Cout % 8 == 0 && bf16tile::aligned16(x) && bf16tile::aligned16(w);
    const bf16tile::ConvA a{static_cast<const __nv_bfloat16*>(x), B, H, W, Cin, OH, OW, k};
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    const bf16tile::Plan p = bf16tile::make_plan(M, Cout, K, /*may_split=*/false);
    return static_cast<int>(
        stride == 1 ? bf16tile::run<ConvS1Loader>(a, wb, ep, K, p, vec, /*tap=*/Cin, stream)
                    : bf16tile::run<ConvS2Loader>(a, wb, ep, K, p, vec, /*tap=*/Cin, stream));
  }
  return stride == 1 ? launch_f32<1>(x, w, bias, res, out, res_kind, out_bf16, B, H, W, Cin, OH,
                                     OW, Cout, k, relu, stream)
                     : launch_f32<2>(x, w, bias, res, out, res_kind, out_bf16, B, H, W, Cin, OH,
                                     OW, Cout, k, relu, stream);
}
