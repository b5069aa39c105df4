// Tiled GEMM with fp32 accumulation and a fused epilogue:
//
//     out = relu?(x @ w + bias + residual)
//
// x (M, K) and w (K, N) row-major, both bf16 or both fp32; bias (N,) and
// residual (M, N) fp32, either may be absent; out fp32 or bf16.
//
// Replaces resnetc_tpu/ops/pallas/gemm.py:100 `matmul` (body `_gemm_kernel`,
// gemm.py:28), which on the int8_chain path is the fc head: (B, 2048) bf16 x
// (2048, 1000) bf16 -> fp32.  At that shape the work is 2*B*2048*1000
// operations against 4 MB of weights read once, so the kernel is bound by
// reading w (bytes), not by the bf16 tensor-core rate.  This first version
// is a plain shared-memory tiled product on the CUDA cores (64x64 output
// tile per block, 4x4 outputs per thread): simple and exact in its fp32
// accumulation; tensor cores (mma / wgmma) are work for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const float* __restrict__ bias, const float* __restrict__ res,
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
      As[k][m] = (gm < M && gk < K) ? to_f32(x[(size_t)gm * K + gk]) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int k = e / BN, n = e % BN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N) ? to_f32(w[(size_t)gk * N + gn]) : 0.f;
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
      float v = acc[i][j];
      if (bias) v = __fadd_rn(v, bias[gn]);
      if (res) v = __fadd_rn(v, res[(size_t)gm * N + gn]);
      if (relu) v = fmaxf(v, 0.f);
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[(size_t)gm * N + gn] = __float2bfloat16_rn(v);
      else
        static_cast<float*>(out)[(size_t)gm * N + gn] = v;
    }
  }
}

}  // namespace

extern "C" int gemm_f32acc(const void* x, const void* w, const float* bias,
                           const float* res, void* out, int in_bf16,
                           int out_bf16, int M, int N, int K, int relu,
                           cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (in_bf16)
    gemm_kernel<__nv_bfloat16><<<grid, THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        bias, res, out, out_bf16, M, N, K, relu);
  else
    gemm_kernel<float><<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bias, res,
        out, out_bf16, M, N, K, relu);
  return static_cast<int>(cudaGetLastError());
}
