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
// The convolutions go through the int8 implicit GEMM of igemm.cuh (its
// header says how it works and what bounds it): a block costs three
// launches (four with the mean exit), with its int8 intermediates z1/z2 in
// device scratch that the wrapper allocates.  At ResNet-152 shapes the three
// convolutions do 2*(cin*c + 9*c*c + c*c4) int8 operations per pixel
// against cin + c4 bytes moved, well above the card's int8 ridge, so the
// bound is the int8 tensor-core rate; fusing the block into one launch to
// keep z1/z2 on chip is later work.  The outputs equal the plain PyTorch
// versions in resnetc_tpu_torch/ops/cuda/block.py bit for bit (the mean
// exit up to fp32 summation order).

#include "igemm.cuh"

namespace {

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

  // conv1 (1x1, cin -> c): relu(fma(acc, a1, c1)) -> int8, ring zeroed.
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
