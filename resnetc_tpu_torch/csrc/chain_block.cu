// Int8 bottleneck-block kernels over the chained padded-row layout.
//
// Replaces three Pallas megakernels of resnetc_tpu/ops/pallas/block.py:
//   - bottleneck_block_chained_int8 (block.py:718, body _chained_kernel_int8
//     :362): one stride-1 bottleneck block (identity or 1x1 projection
//     shortcut; int8, bf16 or per-image-mean exit);
//   - bottleneck_run_chained_int8 (block.py:2908, body :2743): a run of N
//     such blocks, the int8 activation handed from block to block;
//   - downsample_block_s2_int8 (block.py:3460, body :3109): the stride-2
//     stage transition, chain layout in and out.
//
// Layout.  An activation is a "chain": flat rows (B*hp*wp, C) int8 of the
// zero-ring padded image, pixel (r, q) at row (b*hp + r+1)*wp + q+1, with
// (hp, wp) = (h+2, round_up(w+2, 8)) or wp = w+1 when (w+1) % 8 == 0.  Ring
// rows carry no meaning; every kernel here writes zeros there and reads
// only interior pixels, treating every tap outside the image as zero.
//
// Design.  Each convolution is one launch of an implicit-GEMM kernel: a
// block computes a 64-row x 64-channel output tile, gathering the int8
// activation rows of each output pixel (1x1, one kernel row of a 3x3, or
// all nine taps, stride 1 or 2) into shared memory 32 channels at a time,
// with the int8 weights, and accumulates in int32 with __dp4a (exact).  A
// block therefore costs three launches (four with the mean exit), with its
// int8 intermediates z1/z2 in device scratch that the wrapper allocates.
// The TPU kernels' VMEM tricks (kw-interleave scratch, 128-lane slots,
// phase-plane DMAs, bt picking) are scheduling and are not carried over.
//
// What bounds it.  At ResNet-152 shapes the three convolutions do
// 2*(cin*c + 9*c*c + c*c4) int8 operations per pixel against cin + c4
// bytes moved, well above the card's int8 ridge, so the bound is the int8
// tensor-core rate.  These kernels run on the CUDA cores' dp4a instead
// (first, simple version); the tensor-core (mma/wgmma) version, and fusing
// the block into one launch to keep z1/z2 on chip, are later work.
//
// Exactness.  Every epilogue is fp32 in the Pallas kernel's order of
// operations, written with __fmul_rn / __fadd_rn so that nvcc cannot
// contract it into an FMA, rounds half to even (rintf) and clips to +-127.
// The integer dots are exact, so the outputs equal the plain PyTorch
// versions in resnetc_tpu_torch/ops/cuda/block.py bit for bit (the mean
// exit up to fp32 summation order).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;         // output rows per block
constexpr int BN = 64;         // output channels per block
constexpr int BKW = 8;         // 32-bit words of K per stage (32 int8 values)
constexpr int PITCH = BKW + 1; // shared-memory row pitch in words
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each

struct Geo {
  int h, w, hp, wp;  // interior size and chain (padded) size
};

// One implicit-GEMM operand: the chain buffer `a` (rows of `cin` int8
// channels, geometry `g`) gathered per output pixel (r, q), times the int8
// weight matrix w (K, ldw) from column col0.  Output pixel (r, q) reads
// input pixel (r*stride + dy, q*stride + dx) where
//   taps == 1: (dy, dx) = (0, 0),              K = cin;
//   taps == 3: (dy, dx) = (kh-1, kw-1),        K = (kw, k) = 3*cin;
//   taps == 9: (dy, dx) = (kh-1, kw-1),        K = (kh, kw, k) = 9*cin.
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
};

struct Operands {
  Operand o[3];
};

enum Epilogue {
  // v = relu(acc*a + c); int8 out, zero on ring rows (conv1, ds conv2)
  EPI_RELU_Q = 0,
  // v = relu(((P0*a0 + P1*a1) + P2*a2) + c); int8 out (stride-1 conv2)
  EPI_KH3_Q = 1,
  // y = relu((acc*a + c) + residual); int8 / bf16 / fp32 out (conv3)
  EPI_BLOCK_OUT = 2,
};

enum OutKind { OUT_I8 = 0, OUT_BF16 = 1, OUT_F32 = 2 };

struct EpiArgs {
  const float* a[3];      // per-channel multipliers
  const float* c;         // per-channel bias
  const float* ad;        // projection shortcut multiplier (operand 1)
  const float* cd;        // projection shortcut bias
  const int8_t* res;      // identity residual: chain rows, same geometry, ld N
  const float* s_res;     // identity residual scale (device scalar)
  int out_kind;
  void* out;              // (M, N) chain rows
};

__device__ __forceinline__ int8_t requant(float v) {
  v = rintf(v);
  v = fminf(fmaxf(v, -127.f), 127.f);
  return static_cast<int8_t>(v);
}

template <int NG, int EPI>
__global__ void __launch_bounds__(THREADS)
igemm_kernel(Operands ops, Geo og, int M, int N, EpiArgs ep) {
  __shared__ int As[BM][PITCH];
  __shared__ int Bs[BN][PITCH];
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
          const int8_t* p = op.w + (size_t)kk * op.ldw + op.col0 + gn;
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
        float v = __fadd_rn(__fmul_rn(static_cast<float>(acc[0][i][j]), ep.a[0][n]), ep.c[n]);
        v = fmaxf(v, 0.f);
        static_cast<int8_t*>(ep.out)[o] = inside ? requant(v) : int8_t(0);
      } else if (EPI == EPI_KH3_Q) {
        float v = __fadd_rn(
            __fmul_rn(static_cast<float>(acc[0][i][j]), ep.a[0][n]),
            __fmul_rn(static_cast<float>(acc[NG > 1 ? 1 : 0][i][j]), ep.a[1][n]));
        v = __fadd_rn(v, __fmul_rn(static_cast<float>(acc[NG > 2 ? 2 : 0][i][j]), ep.a[2][n]));
        v = fmaxf(__fadd_rn(v, ep.c[n]), 0.f);
        static_cast<int8_t*>(ep.out)[o] = inside ? requant(v) : int8_t(0);
      } else {
        float y = __fadd_rn(__fmul_rn(static_cast<float>(acc[0][i][j]), ep.a[0][n]), ep.c[n]);
        if (NG == 2) {
          const float sc = __fadd_rn(
              __fmul_rn(static_cast<float>(acc[NG - 1][i][j]), ep.ad[n]), ep.cd[n]);
          y = __fadd_rn(y, sc);
        } else {
          y = __fadd_rn(y, __fmul_rn(static_cast<float>(ep.res[o]), *ep.s_res));
        }
        y = inside ? fmaxf(y, 0.f) : 0.f;
        if (ep.out_kind == OUT_I8)
          static_cast<int8_t*>(ep.out)[o] = requant(y);
        else if (ep.out_kind == OUT_BF16)
          static_cast<__nv_bfloat16*>(ep.out)[o] = __float2bfloat16_rn(y);
        else
          static_cast<float*>(ep.out)[o] = y;
      }
    }
  }
}

// Per-image mean of the interior rows of an fp32 chain: out[b, n] =
// sum over pixels in row-major order of y * inv_hw (the head fold).
__global__ void mean_kernel(const float* __restrict__ y, Geo g, int N,
                            float inv_hw, float* __restrict__ out) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float s = 0.f;
  for (int r = 0; r < g.h; ++r)
    for (int q = 0; q < g.w; ++q) {
      const size_t row = (size_t)(b * g.hp + r + 1) * g.wp + q + 1;
      s = __fadd_rn(s, __fmul_rn(y[row * N + n], inv_hw));
    }
  out[(size_t)b * N + n] = s;
}

template <int NG, int EPI>
int launch(const Operand* o, Geo og, int M, int N, const EpiArgs& ep,
           cudaStream_t stream) {
  Operands ops{};
  for (int g = 0; g < NG; ++g) ops.o[g] = o[g];
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  igemm_kernel<NG, EPI><<<grid, THREADS, 0, stream>>>(ops, og, M, N, ep);
  return static_cast<int>(cudaGetLastError());
}

Operand operand(const int8_t* a, int cin, Geo g, int stride, int taps, int kh,
                const int8_t* w, int ldw, int col0) {
  return Operand{a, cin, g, stride, taps, kh, w, ldw, col0, taps * cin};
}

}  // namespace

// One stride-1 bottleneck block, chain in and out.  wd == NULL: identity
// shortcut (cin == c4), residual x * s_res; else the 1x1 projection
// (wd, ad, cd).  out_kind 0: int8 chain, 1: bf16 chain, 2: per-image fp32
// means (B, c4) through the fp32 scratch y (B*hp*wp, c4).  z1, z2 are int8
// scratch (B*hp*wp, c).  Returns the first launch's cudaError_t, or 0.
extern "C" int chain_block_int8(
    const int8_t* x, int B, int h, int w, int hp, int wp, int cin, int c, int c4,
    const int8_t* w1, const float* a1, const float* c1,
    const int8_t* w2p, const float* a2, const float* c2,
    const int8_t* w3, const float* a3, const float* c3,
    const float* s_res, const int8_t* wd, const float* ad, const float* cd,
    int8_t* z1, int8_t* z2, float* y, int out_kind, void* out, float inv_hw,
    cudaStream_t stream) {
  const Geo g{h, w, hp, wp};
  const int M = B * hp * wp;
  int err;

  // conv1 (1x1, cin -> c): relu(acc*a1 + c1) -> int8, ring zeroed.
  Operand o1 = operand(x, cin, g, 1, 1, 0, w1, c, 0);
  EpiArgs e1{};
  e1.a[0] = a1;
  e1.c = c1;
  e1.out_kind = OUT_I8;
  e1.out = z1;
  if ((err = launch<1, EPI_RELU_Q>(&o1, g, M, c, e1, stream))) return err;

  // conv2 (3x3/1, kh-batched packing (kw,k) x (kh,j)): three int32 sums
  // P_kh, one per kernel row, each dequantized with its own a2[kh].
  Operand o2[3];
  for (int kh = 0; kh < 3; ++kh) o2[kh] = operand(z1, c, g, 1, 3, kh, w2p, 3 * c, kh * c);
  EpiArgs e2{};
  e2.a[0] = a2;
  e2.a[1] = a2 + c;
  e2.a[2] = a2 + 2 * c;
  e2.c = c2;
  e2.out_kind = OUT_I8;
  e2.out = z2;
  if ((err = launch<3, EPI_KH3_Q>(o2, g, M, c, e2, stream))) return err;

  // conv3 (1x1, c -> c4) + shortcut + relu.
  Operand o3[2];
  o3[0] = operand(z2, c, g, 1, 1, 0, w3, c4, 0);
  EpiArgs e3{};
  e3.a[0] = a3;
  e3.c = c3;
  e3.out_kind = out_kind == 2 ? OUT_F32 : out_kind;
  e3.out = out_kind == 2 ? static_cast<void*>(y) : out;
  if (wd) {
    o3[1] = operand(x, cin, g, 1, 1, 0, wd, c4, 0);
    e3.ad = ad;
    e3.cd = cd;
    if ((err = launch<2, EPI_BLOCK_OUT>(o3, g, M, c4, e3, stream))) return err;
  } else {
    e3.res = x;
    e3.s_res = s_res;
    if ((err = launch<1, EPI_BLOCK_OUT>(o3, g, M, c4, e3, stream))) return err;
  }
  if (out_kind == 2) {
    const dim3 grid((c4 + 127) / 128, B);
    mean_kernel<<<grid, 128, 0, stream>>>(y, g, c4, inv_hw, static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

// A run of n_blocks stride-1 blocks.  Per-block parameters are stacked:
// w1s (n_w1, c4, c) with n_w1 = n_blocks - (w10 != NULL), w2ps (N, 3c, 3c),
// w3s (N, c, c4), a1s/c1s/c2s (N, c), a2s (N, 3, c), a3s/c3s (N, c4),
// s_res (N,).  With w10/wd/ad/cd block 0 is the projection block over x
// (rows, cin).  Activations between blocks go through act0/act1 (int8
// chains, (B*hp*wp, c4)); the last block writes `out` (int8 or bf16).
extern "C" int chain_run_int8(
    const int8_t* x, int n_blocks, int B, int h, int w, int hp, int wp, int cin,
    int c, int c4, const int8_t* w1s, const int8_t* w10,
    const float* a1s, const float* c1s, const int8_t* w2ps, const float* a2s,
    const float* c2s, const int8_t* w3s, const float* a3s, const float* c3s,
    const float* s_res, const int8_t* wd, const float* ad, const float* cd,
    int8_t* z1, int8_t* z2, int8_t* act0, int8_t* act1, int last_bf16,
    void* out, cudaStream_t stream) {
  const bool proj = w10 != nullptr;
  int8_t* act[2] = {act0, act1};
  for (int n = 0; n < n_blocks; ++n) {
    const bool last = n == n_blocks - 1;
    const int8_t* xin = n == 0 ? x : act[(n - 1) % 2];
    const bool pn = proj && n == 0;
    const int8_t* w1 = proj ? (n == 0 ? w10 : w1s + (size_t)(n - 1) * c4 * c)
                            : w1s + (size_t)n * c4 * c;
    const int err = chain_block_int8(
        xin, B, h, w, hp, wp, pn ? cin : c4, c, c4,
        w1, a1s + (size_t)n * c, c1s + (size_t)n * c,
        w2ps + (size_t)n * 9 * c * c, a2s + (size_t)n * 3 * c, c2s + (size_t)n * c,
        w3s + (size_t)n * c * c4, a3s + (size_t)n * c4, c3s + (size_t)n * c4,
        s_res + n, pn ? wd : nullptr, ad, cd, z1, z2, nullptr,
        last ? (last_bf16 ? OUT_BF16 : OUT_I8) : OUT_I8,
        last ? out : static_cast<void*>(act[n % 2]), 0.f, stream);
    if (err) return err;
  }
  return 0;
}

// The stride-2 transition block: x is the (h, w) input stage's int8 chain,
// out the (oh, ow) = ((h+1)/2, (w+1)/2) stage's chain (int8, or bf16 when
// out_kind == 1).  conv1 1x1 over the input chain, conv2 3x3/2 with one
// int32 sum over all nine taps (w2 (9c, c), rows (kh, kw, k)), conv3 1x1
// plus the 1x1/2 projection of x[2r, 2q].  z1 (B*hp*wp, c) and
// z2 (B*hp2*wp2, c) are int8 scratch.
extern "C" int ds_block_s2_int8(
    const int8_t* x, int B, int h, int w, int hp, int wp, int cin, int c, int c4,
    int oh, int ow, int hp2, int wp2,
    const int8_t* w1, const float* a1, const float* c1,
    const int8_t* w2, const float* a2, const float* c2,
    const int8_t* w3, const float* a3, const float* c3,
    const int8_t* wd, const float* ad, const float* cd,
    int8_t* z1, int8_t* z2, int out_kind, void* out, cudaStream_t stream) {
  const Geo gi{h, w, hp, wp};
  const Geo go{oh, ow, hp2, wp2};
  int err;

  Operand o1 = operand(x, cin, gi, 1, 1, 0, w1, c, 0);
  EpiArgs e1{};
  e1.a[0] = a1;
  e1.c = c1;
  e1.out_kind = OUT_I8;
  e1.out = z1;
  if ((err = launch<1, EPI_RELU_Q>(&o1, gi, B * hp * wp, c, e1, stream))) return err;

  Operand o2 = operand(z1, c, gi, 2, 9, 0, w2, c, 0);
  EpiArgs e2{};
  e2.a[0] = a2;
  e2.c = c2;
  e2.out_kind = OUT_I8;
  e2.out = z2;
  if ((err = launch<1, EPI_RELU_Q>(&o2, go, B * hp2 * wp2, c, e2, stream))) return err;

  Operand o3[2];
  o3[0] = operand(z2, c, go, 1, 1, 0, w3, c4, 0);
  o3[1] = operand(x, cin, gi, 2, 1, 0, wd, c4, 0);
  EpiArgs e3{};
  e3.a[0] = a3;
  e3.c = c3;
  e3.ad = ad;
  e3.cd = cd;
  e3.out_kind = out_kind;
  e3.out = out;
  return launch<2, EPI_BLOCK_OUT>(o3, go, B * hp2 * wp2, c4, e3, stream);
}
