// GEMM with fp32 accumulation and a fused epilogue:
//
//     out = relu?(x @ w + bias + residual)
//
// x (M, K) and w (K, N) row-major, both bf16 or both fp32; bias (N,) fp32,
// residual (M, N) bf16 or fp32 (read in its own type), either may be
// absent; out fp32 or bf16.
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
// kernel, so every call gives the same bits.  The fp32 form keeps the plain
// shared-memory tile on the CUDA cores (64 x 64 outputs a block, 4 x 4 a
// thread): the FP32 policy's gates hold the `pallas` forward to 1e-3 of the
// fp32 logits, digits that TF32 tensor cores would spend.

#include "bf16_tile.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;

using bf16tile::KIND_BF16;
using bf16tile::KIND_F32;

__global__ void __launch_bounds__(THREADS)
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, const void* __restrict__ res, int res_kind,
                void* __restrict__ out, int out_bf16, int M, int N, int K, int relu) {
  __shared__ float As[BK][BM + 4];  // As[k][m]
  __shared__ float Bs[BK][BN + 4];  // Bs[k][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int m = e / BK, k = e % BK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int k = e / BN, n = e % BN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      // Epilogue in the Pallas kernel's order: + bias, + residual, relu.
      const size_t o = (size_t)gm * N + gn;
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

}  // namespace

// Floats of workspace the bf16 product of this shape needs (its split-K
// partial sums), 0 when it does not split.
extern "C" long long gemm_workspace_floats(int M, int N, int K, int in_bf16) {
  if (!in_bf16) return 0;
  const bf16tile::Plan p = bf16tile::make_plan(M, N, K, /*may_split=*/true);
  return p.splits > 1 ? static_cast<long long>(p.splits) * M * N : 0;
}

// res_kind: 0 none, 1 bf16, 2 fp32.  ws: gemm_workspace_floats(...) floats,
// or NULL when that is 0.
extern "C" int gemm_f32acc(const void* x, const void* w, const float* bias, const void* res,
                           void* out, float* ws, int in_bf16, int res_kind, int out_bf16, int M,
                           int N, int K, int relu, cudaStream_t stream) {
  if (!in_bf16) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_f32_kernel<<<grid, THREADS, 0, stream>>>(static_cast<const float*>(x),
                                                  static_cast<const float*>(w), bias, res,
                                                  res_kind, out, out_bf16, M, N, K, relu);
    return static_cast<int>(cudaGetLastError());
  }
  const bf16tile::Plan p = bf16tile::make_plan(M, N, K, /*may_split=*/true);
  if (p.splits > 1 && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const bf16tile::Epi ep{bias, res, out, ws, M, N, res_kind, out_bf16, relu};
  const bool vec = K % 8 == 0 && N % 8 == 0 && bf16tile::aligned16(x) && bf16tile::aligned16(w);
  return static_cast<int>(bf16tile::run<bf16tile::GemmALoader>(
      bf16tile::GemmA{static_cast<const __nv_bfloat16*>(x), M, K},
      static_cast<const __nv_bfloat16*>(w), ep, K, p, vec, /*tap=*/0, stream));
}
