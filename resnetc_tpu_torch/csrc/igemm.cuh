// The int8 implicit GEMM of the one chain-layout block kernel still on the
// CUDA cores: the BasicBlock's stride-2 transition (basic_block.cu, row 11
// of PERF.md's table).  Every other int8 block kernel (the stride-1 blocks
// of both families and their runs, the bottleneck transition, the
// pixel-paired kernels: rows 1-3, 5-10) runs on the int8 tensor-core tile
// instead (chain_tile.cuh), which takes its epilogue helpers (requant, the
// output kinds) from here.
//
// Layout.  An activation is a "chain": flat rows (B*hp*wp, C) int8 of the
// zero-ring padded image, pixel (r, q) at row (b*hp + r+1)*wp + q+1, with
// (hp, wp) = (h+2, round_up(w+2, 8)) or wp = w+1 when (w+1) % 8 == 0.  Ring
// rows carry no meaning; every kernel here writes zeros there and reads
// only interior pixels, treating every tap outside the image as zero.
//
// Design.  Each convolution is one launch of igemm_kernel: a block computes
// a 64-row x 64-channel output tile, gathering the int8 activation rows of
// each output pixel (1x1, one kernel row of a 3x3, or all nine taps, stride
// 1 or 2) into shared memory 32 channels at a time, with the int8 weights,
// and accumulates in int32 with __dp4a (exact).  Up to four operands (NG)
// keep separate int32 sums, so that each gets its own dequant scale in the
// epilogue (the three kernel rows of a kh-batched 3x3, a projection
// shortcut).  The TPU kernels' VMEM tricks (kw-interleave scratch, 128-lane
// slots, phase-plane and pair DMAs, bt picking) are scheduling and are not
// carried over.
//
// What bounds it.  A 3x3 convolution does 18*c*c int8 operations per pixel
// against a few bytes moved, far above the card's int8 ridge, so the bound
// is the int8 tensor-core rate.  This kernel runs on the CUDA cores' dp4a
// instead (first, simple version), 25-60x above that bound; moving row 11
// onto the int8 tile, as rows 1-3 and 5-10 were, is the next step.
//
// Exactness.  Every epilogue is fp32 in the Pallas kernel's order of
// operations, rounds half to even (rintf) and clips to +-127.  Where the
// Pallas code writes a*b + c, XLA emits one fused multiply-add, so the
// kernels use __fmaf_rn there and __fmul_rn / __fadd_rn (which nvcc cannot
// contract) everywhere else; the plain versions round the same way
// (block.py _fma).  The integer dots are exact, so the outputs equal the
// plain PyTorch versions in resnetc_tpu_torch/ops/cuda/block.py bit for
// bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;         // output rows per block
constexpr int BN = 64;         // output channels per block
constexpr int BKW = 8;         // 32-bit words of K per stage (32 int8 values)
constexpr int PITCH = BKW + 1; // shared-memory row pitch in words
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int MAX_OPS = 4;

struct Geo {
  int h, w, hp, wp;  // interior size and chain (padded) size
};

// One implicit-GEMM operand: the chain buffer `a` (rows of `cin` int8
// channels, geometry `g`) gathered per output pixel (r, q), times the int8
// weight matrix w (rows, ldw) from column col0.  Output pixel (r, q) reads
// input pixel (r*stride + dy, q*stride + dx) where
//   taps == 1: (dy, dx) = (0, 0),              K = cin;
//   taps == 3: (dy, dx) = (kh-1, kw-1),        K = (kw, k) = 3*cin;
//   taps == 9: (dy, dx) = (kh-1, kw-1),        K = (kh, kw, k) = 9*cin.
// With the kernel's WPAD flag, K index kk reads weight row
// kk + (kk / (3*cin)) * wpad: wpad zero rows follow each kernel row's 3*cin
// taps (the basic-ds conv1 packing).  WPAD is a template flag so that the
// other launches carry no division in their weight loads.

struct Operand {
  const int8_t* a;
  int cin;
  Geo g;
  int stride;
  int taps;
  int kh;
  const int8_t* w;
  int ldw;
  int col0;
  int K;
  int wpad;
};

struct Operands {
  Operand o[MAX_OPS];
};

enum Epilogue {
  // v = relu(fma(acc, a, c)); int8 out, zero on ring rows (the 9-tap conv1)
  EPI_RELU_Q = 0,
  // y = kh3 + c, then the projection shortcut fma(acc3, ad, y) + cd (NG ==
  // 4, operand 3 the projection); relu; int8 / bf16 out (conv2)
  EPI_BASIC_OUT = 1,
};

enum OutKind { OUT_I8 = 0, OUT_BF16 = 1, OUT_F32 = 2 };

struct EpiArgs {
  const float* a[3];      // per-channel multipliers
  const float* c;         // per-channel bias
  const float* ad;        // projection shortcut multiplier (last operand)
  const float* cd;        // projection shortcut bias
  int out_kind;
  void* out;              // (M, N) chain rows
};

__device__ __forceinline__ int8_t requant(float v) {
  v = rintf(v);
  v = fminf(fmaxf(v, -127.f), 127.f);
  return static_cast<int8_t>(v);
}

// kh3 = ((P0*a0 + P1*a1) + P2*a2), as XLA fuses it:
// fma(P2, a2, fma(P0, a0, P1*a1)): the kh-batched 3x3's three rows, each
// dequantized with its own per-(kh, j) scale.
__device__ __forceinline__ float kh3(int p0, int p1, int p2, const float* const* a, int n) {
  const float v = __fmaf_rn(static_cast<float>(p0), a[0][n],
                            __fmul_rn(static_cast<float>(p1), a[1][n]));
  return __fmaf_rn(static_cast<float>(p2), a[2][n], v);
}

__device__ __forceinline__ void store(const EpiArgs& ep, size_t o, float y) {
  if (ep.out_kind == OUT_I8)
    static_cast<int8_t*>(ep.out)[o] = requant(y);
  else if (ep.out_kind == OUT_BF16)
    static_cast<__nv_bfloat16*>(ep.out)[o] = __float2bfloat16_rn(y);
  else
    static_cast<float*>(ep.out)[o] = y;
}

template <int NG, int EPI, bool WPAD>
__global__ void __launch_bounds__(THREADS)
igemm_kernel(Operands ops, Geo og, int M, int N, EpiArgs ep) {
  static_assert(EPI != EPI_BASIC_OUT || NG == 4, "EPI_BASIC_OUT takes the projection operand");
  __shared__ int As[BM][PITCH];
  __shared__ int Bs[BN][PITCH];
  // Per tile row: image (or -1) and interior pixel.
  __shared__ int rowImg[BM], rowR[BM], rowQ[BM];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // Decode the tile's output rows once: image and interior pixel, or -1.
  if (tid < BM) {
    const int m = m0 + tid;
    int img = -1, r = 0, q = 0;
    if (m < M) {
      const int per = og.hp * og.wp;
      const int b = m / per;
      const int rem = m - b * per;
      const int py = rem / og.wp, px = rem - (rem / og.wp) * og.wp;
      if (py >= 1 && py <= og.h && px >= 1 && px <= og.w) {
        img = b;
        r = py - 1;
        q = px - 1;
      }
    }
    rowImg[tid] = img;
    rowR[tid] = r;
    rowQ[tid] = q;
  }
  __syncthreads();

  int acc[NG][4][4];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[g][i][j] = 0;

#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const Operand& op = ops.o[g];
    for (int k0 = 0; k0 < op.K; k0 += 4 * BKW) {
      // A tile: BM rows x BKW words, gathered per output pixel.
#pragma unroll
      for (int t = 0; t < (BM * BKW) / THREADS; ++t) {
        const int e = tid + t * THREADS;
        const int row = e / BKW, wk = e % BKW;
        const int kk = k0 + 4 * wk;
        const int img = rowImg[row];
        int v = 0;
        if (img >= 0 && kk < op.K) {
          const int tap = kk / op.cin;
          const int ch = kk - tap * op.cin;
          int dy, dx;
          if (op.taps == 1) {
            dy = 0;
            dx = 0;
          } else if (op.taps == 3) {
            dy = op.kh - 1;
            dx = tap - 1;
          } else {
            dy = tap / 3 - 1;
            dx = tap % 3 - 1;
          }
          const int sy = rowR[row] * op.stride + dy;
          const int sx = rowQ[row] * op.stride + dx;
          if (sy >= 0 && sy < op.g.h && sx >= 0 && sx < op.g.w) {
            const size_t off =
                ((size_t)(img * op.g.hp + sy + 1) * op.g.wp + sx + 1) * op.cin + ch;
            v = *reinterpret_cast<const int*>(op.a + off);
          }
        }
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
        if (gn < N && kk < op.K) {
          const int wrow = WPAD ? kk + (kk / (3 * op.cin)) * op.wpad : kk;
          const int8_t* p = op.w + (size_t)wrow * op.ldw + op.col0 + gn;
          const uint32_t b0 = static_cast<uint8_t>(p[0]);
          const uint32_t b1 = static_cast<uint8_t>(p[op.ldw]);
          const uint32_t b2 = static_cast<uint8_t>(p[2 * op.ldw]);
          const uint32_t b3 = static_cast<uint8_t>(p[3 * op.ldw]);
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
          for (int j = 0; j < 4; ++j) acc[g][i][j] = __dp4a(a[i], b[j], acc[g][i][j]);
      }
      __syncthreads();
    }
  }

  constexpr int G1 = NG > 1 ? 1 : 0, G2 = NG > 2 ? 2 : 0, G3 = NG > 3 ? 3 : 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lr = ty + 16 * i;
    const int m = m0 + lr;
    if (m >= M) continue;
    const bool inside = rowImg[lr] >= 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const size_t o = (size_t)m * N + n;
      if (EPI == EPI_RELU_Q) {
        float v = __fmaf_rn(static_cast<float>(acc[0][i][j]), ep.a[0][n], ep.c[n]);
        v = fmaxf(v, 0.f);
        static_cast<int8_t*>(ep.out)[o] = inside ? requant(v) : int8_t(0);
      } else {
        float y = __fadd_rn(kh3(acc[0][i][j], acc[G1][i][j], acc[G2][i][j], ep.a, n), ep.c[n]);
        y = __fadd_rn(__fmaf_rn(static_cast<float>(acc[G3][i][j]), ep.ad[n], y), ep.cd[n]);
        store(ep, o, inside ? fmaxf(y, 0.f) : 0.f);
      }
    }
  }
}

// M is the number of output rows (chain rows).
template <int NG, int EPI, bool WPAD = false>
int launch(const Operand* o, Geo og, int M, int N, const EpiArgs& ep,
           cudaStream_t stream) {
  Operands ops{};
  for (int g = 0; g < NG; ++g) ops.o[g] = o[g];
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  igemm_kernel<NG, EPI, WPAD><<<grid, THREADS, 0, stream>>>(ops, og, M, N, ep);
  return static_cast<int>(cudaGetLastError());
}

Operand operand(const int8_t* a, int cin, Geo g, int stride, int taps, int kh,
                const int8_t* w, int ldw, int col0, int wpad = 0) {
  return Operand{a, cin, g, stride, taps, kh, w, ldw, col0, taps * cin, wpad};
}

}  // namespace
