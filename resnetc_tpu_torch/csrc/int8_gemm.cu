// The int8 GEMM of the `int8` serving backend, with its dequant epilogue:
//
//     out = relu?(acc * (sx * sw[n]) + bias[n] + residual[m, n]),
//     acc = x_q @ w_q  (exact int32)
//
// x_q (M, K) and w_q (K, N) int8 row-major, K a multiple of 4 (the wrapper
// zero-pads); sx a device scalar, sw and bias (N,) fp32, bias optional;
// residual (M, N) bf16 or fp32, optional; out bf16 or fp32.
//
// Replaces resnetc_tpu/ops/pallas/quant.py:78 `int8_matmul` (pallas_call at
// :140).  On the path it is every 1x1 convolution of the `int8` backend and
// its fc head: ResNet-152 at batch 32 runs M up to 100,352 with K and N
// 64..2048, and the fc at M = 32, K = 2048, N = 1000.
//
// What bounds it.  At the widest layer1 shape (M 100,352, K 256, N 64) it
// does 3.3 G int8 operations against ~38 MB moved: bytes-bound on this card
// (~11 us at 3.35 TB/s); the deeper layers' K = N = 1024..2048 shapes sit
// above the int8 ridge and are bound by the tensor-core rate.  This first
// version runs on the CUDA cores' __dp4a (4 int8 products a lane per
// instruction), a 64x64 output tile per block of 256 threads, 4x4 outputs a
// thread, K staged through shared memory 32 int8 values at a time: simple
// and exact.  Tensor cores (mma.sync s8 / wgmma), TMA and a persistent grid
// are later work.
//
// Exactness.  The int32 dot is exact.  The epilogue keeps the Pallas
// kernel's order of operations as XLA evaluates it (quant.py:64-71): the
// scale sx * sw[n] is rounded on its own; `acc * scale + bias` is one fused
// multiply-add (XLA fuses it), or `acc * scale + residual` when there is no
// bias; then + residual, relu, one rounding to the output type.  __fmaf_rn,
// __fmul_rn and __fadd_rn keep nvcc from contracting anything else, so the
// output equals the plain version (quant.py int8_matmul_plain) bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;          // output rows per block
constexpr int BN = 64;          // output columns per block
constexpr int BKW = 8;          // 32-bit words of K per stage (32 int8 values)
constexpr int PITCH = BKW + 1;  // shared-memory row pitch in words
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each

enum ResKind { RES_NONE = 0, RES_BF16 = 1, RES_F32 = 2 };

__global__ void __launch_bounds__(THREADS)
int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 const float* __restrict__ bias, const void* __restrict__ res,
                 void* __restrict__ out, int res_kind, int out_bf16, int M, int N,
                 int K, int relu) {
  __shared__ int As[BM][PITCH];  // As[m][word]: 4 consecutive k of row m
  __shared__ int Bs[BN][PITCH];  // Bs[n][word]: 4 consecutive k of column n
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += 4 * BKW) {
    // A tile: BM rows x BKW words, eight threads on one row's 32 bytes.
#pragma unroll
    for (int t = 0; t < (BM * BKW) / THREADS; ++t) {
      const int e = tid + t * THREADS;
      const int row = e / BKW, wk = e % BKW;
      const int kk = k0 + 4 * wk;
      const int gm = m0 + row;
      int v = 0;
      if (gm < M && kk < K) v = *reinterpret_cast<const int*>(x + (size_t)gm * K + kk);
      As[row][wk] = v;
    }
    // B tile: BN columns x BKW words; word (n, wk) packs w[kk..kk+3][n].
#pragma unroll
    for (int t = 0; t < (BN * BKW) / THREADS; ++t) {
      const int e = tid + t * THREADS;
      const int n = e % BN, wk = e / BN;
      const int kk = k0 + 4 * wk;
      const int gn = n0 + n;
      int v = 0;
      if (gn < N && kk < K) {
        const int8_t* p = w + (size_t)kk * N + gn;
        const uint32_t b0 = static_cast<uint8_t>(p[0]);
        const uint32_t b1 = static_cast<uint8_t>(p[N]);
        const uint32_t b2 = static_cast<uint8_t>(p[2 * (size_t)N]);
        const uint32_t b3 = static_cast<uint8_t>(p[3 * (size_t)N]);
        v = static_cast<int>(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
      }
      Bs[n][wk] = v;
    }
    __syncthreads();
#pragma unroll
    for (int wk = 0; wk < BKW; ++wk) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][wk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[tx + 16 * j][wk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float s_x = *sx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      const size_t o = (size_t)gm * N + gn;
      const float scale = __fmul_rn(s_x, sw[gn]);
      const float a = static_cast<float>(acc[i][j]);  // round to nearest even
      float r = 0.f;
      if (res_kind == RES_BF16)
        r = __bfloat162float(static_cast<const __nv_bfloat16*>(res)[o]);
      else if (res_kind == RES_F32)
        r = static_cast<const float*>(res)[o];
      float v;
      if (bias) {
        v = __fmaf_rn(a, scale, bias[gn]);
        if (res_kind != RES_NONE) v = __fadd_rn(v, r);
      } else if (res_kind != RES_NONE) {
        v = __fmaf_rn(a, scale, r);
      } else {
        v = __fmul_rn(a, scale);
      }
      if (relu) v = fmaxf(v, 0.f);
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
      else
        static_cast<float*>(out)[o] = v;
    }
  }
}

}  // namespace

extern "C" int int8_gemm(const int8_t* x, const int8_t* w, const float* sx, const float* sw,
                         const float* bias, const void* res, void* out, int res_kind,
                         int out_bf16, int M, int N, int K, int relu, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm_kernel<<<grid, THREADS, 0, stream>>>(x, w, sx, sw, bias, res, out, res_kind,
                                                 out_bf16, M, N, K, relu);
  return static_cast<int>(cudaGetLastError());
}
