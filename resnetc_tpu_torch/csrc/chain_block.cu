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
// The stride-1 block (and so the run, which loops over it) is three
// launches of one int8 tensor-core kernel, chain_tile_kernel (chain_tile.cuh,
// shared with the basic blocks), and a small one that zeroes the output's
// ring rows (the mean exit's mean_kernel instead), over the tile of
// s8_tile.cuh: wgmma m64nNk32 s32.s8.s8 with both operands K-major from a
// swizzled cp.async ring.  Its int8 intermediates z1/z2 go through device
// scratch that the wrapper allocates, as chain rows:
//   conv1: every chain row of x (K = cin), relu, requant, ring rows zero
//          (a select: a ring row of x may hold anything);
//   conv2: kernel row kh reads, for output chain row t, the three
//          consecutive chain rows t + (kh-1)*wp - 1 .. + 1 of z1: 3c
//          contiguous int8 values, the (kw, k) order of w2pq's rows, so its
//          A is z1 viewed at a row offset with row stride c and K = 3c
//          (rows outside the chain zero-filled).  The zero ring of z1 is the
//          padding; the ring of x is never read by a 3x3.  Three int32 sums
//          P_kh, each its own loop over the ring, folded as soon as it is
//          done: fma(P0, a0, P1*a1) after P1, then fma(P2, a2, .) + c2;
//   conv3: z2 (K = c), plus the identity residual fma(x, s_res, y) read
//          from x at the row, or a second sum over x for the projection;
//          relu; int8, bf16 or fp32 out.
// conv2 and conv3 compute the interior pixels only (row m of the GEMM is
// pixel m, at its chain row): a chain has 1.22x, 1.31x and 1.47x as many
// rows as pixels at 28x28, 14x14 and 7x7.  z2's ring rows are then never
// written nor read, and a small kernel writes the output's ring rows as
// zeros (zero_ring_kernel).  Measured on an H100 at batch 32 (NVIDIA H100
// 80GB HBM3, 700 W; PERF.md, PR 8) against every chain row: 0.0754 against
// 0.0808 ms a block at 14x14, 0.0676 / 0.0884 at 7x7, 0.1190 / 0.1317 at
// 28x28, the stage-0 projection block 0.2012 / 0.2157.
// The weights are the K-major (N, K) copies (8-bit wgmma has no transpose
// bit): the int8_chain engine makes them once (fused.pack_chain_kmajor),
// a call without them transposes once.
//
// What bounds it.  2*(cin*c + 9*c*c + c*c4) int8 operations per pixel
// (~14 G at batch 32 at every ResNet-152 stage) against cin + c4 bytes:
// far above the card's int8 ridge, so the bound is the int8 tensor-core
// rate (~7 us a block).  This design runs at 7-10% of that at ResNet-152's
// stages 1-3 (PERF.md): it moves z1 and z2 through device memory, drains
// the wgmma pipeline at each of the 3x3's sum boundaries, and keeps two
// stages of copies in flight; one launch with z1/z2 on chip, TMA and a
// deeper ring are later work.
//
// The stride-2 transition is three launches of the same tile and a ring
// pass, z1 (input geometry) and z2 (output geometry) through device scratch:
//   conv1: as the stride-1 block's, over every chain row of x, ring rows
//          zero (a select);
//   conv2: over the output's interior pixels, ONE int32 sum of K = 9c:
//          output pixel (i, j) reads, for kernel row u, the three
//          consecutive chain rows of z1 from input pixel (2i+u-1, 2j-1)
//          (3c contiguous int8 values in the (kw, k) order of w2q's rows),
//          the loader stepping wp rows every 3c columns (chain_tile.cuh's
//          stride-2 source row); one sum because the per-channel scale is
//          joint over the nine taps (three folded sums would round
//          otherwise); relu(fma(P, a2, c2)) -> int8;
//   conv3: z2 at the output pixel's chain row plus the 1x1/2 projection, a
//          second sum reading x at input pixel (2i, 2j); relu; int8 or bf16;
//          then the output's ring rows are zeroed.
// z1's zero ring is conv2's padding: where the input size is odd, the taps
// of the last output row or column that fall past the image are ring rows.  At ResNet-152's three transitions
// (batch 32) each is ~23.9 G int8 operations: a bound of ~12 us.
//
// The outputs equal the plain PyTorch versions in
// resnetc_tpu_torch/ops/cuda/block.py bit for bit (the mean exit up to fp32
// summation order): integer sums are exact, and every fp32 epilogue keeps
// the Pallas kernel's order of operations with XLA's roundings
// (__int2float_rn, __fmaf_rn, __fmul_rn, __fadd_rn, rintf).

#include "chain_tile.cuh"

namespace {

// Per-image mean of the interior rows of an fp32 chain: out[b, n] =
// sum over pixels in row-major order of y * inv_hw (the head fold).
__global__ void mean_kernel(const float* __restrict__ y, Chain g, int N,
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

// One stride-1 bottleneck block, chain in and out, on the int8 tile.  The
// weights are the K-major (N, K) copies: w1_nk (c, cin), w2p_nk (3c, 3c)
// whose row kh*c + j is output j of kernel row kh over the (kw, k) taps,
// w3_nk (c4, c), wd_nk (c4, cin); sw1, b1 (c), sw2p (3c: (kh, j)), b2 (c),
// sw3, b3 (c4), swd, bd (c4) fp32; scales the device [s_x, s_z1, s_z2,
// s_y], s_y taken as 1 when unit_y.  wd_nk == NULL: identity shortcut (cin
// == c4); else the 1x1 projection.  out_kind 0: int8 chain, 1: bf16 chain,
// 2: per-image fp32 means (B, c4) through the fp32 scratch y (B*hp*wp,
// c4).  z1, z2 are int8 scratch (B*hp*wp, c).  Returns the first failed
// launch's cudaError_t, or 0.
extern "C" int chain_block_int8(
    const int8_t* x, int B, int h, int w, int hp, int wp, int cin, int c, int c4,
    const int8_t* w1_nk, const float* sw1, const float* b1,
    const int8_t* w2p_nk, const float* sw2p, const float* b2,
    const int8_t* w3_nk, const float* sw3, const float* b3,
    const float* scales, int unit_y, const int8_t* wd_nk, const float* swd, const float* bd,
    int8_t* z1, int8_t* z2, float* y, int out_kind, void* out, float inv_hw,
    cudaStream_t stream) {
  enum { S_X = 0, S_Z1 = 1, S_Z2 = 2, S_Y = 3 };
  const Chain ch{h, w, hp, wp};
  const int rows = B * hp * wp;
  const int pixels = B * h * w;
  int err;

  // conv1 (1x1, cin -> c) over every chain row: relu(fma(P, a1, c1)) ->
  // int8, ring rows zero (conv2 reads them as its padding).
  TileArgs t1{};
  t1.sum[0] = S8Sum{x, w1_nk, static_cast<long long>(rows) * cin, cin, 0, cin};
  t1.sw[0] = sw1, t1.num[0] = S_X, t1.den[0] = S_Z1;
  t1.b = b1;
  t1.scales = scales;
  t1.iy = S_Y;
  t1.out = z1;
  t1.out_kind = OUT_I8;
  t1.M = rows;
  t1.N = c;
  t1.g = ch;
  if ((err = run_tile<1, TE_RELU_Q>(t1, stream))) return err;

  // conv2 (3x3/1) over the interior pixels: three int32 sums P_kh, kernel
  // row kh reading z1 at row offset (kh-1)*wp - 1 from the pixel's chain row
  // (three consecutive chain rows, K = 3c).
  TileArgs t2{};
  for (int kh = 0; kh < 3; ++kh) {
    t2.sum[kh] = S8Sum{z1, w2p_nk + static_cast<size_t>(kh) * c * 3 * c,
                       static_cast<long long>(rows) * c, c, (kh - 1) * wp - 1, 3 * c};
    t2.sw[kh] = sw2p + kh * c, t2.num[kh] = S_Z1, t2.den[kh] = S_Z2;
  }
  t2.b = b2;
  t2.scales = scales;
  t2.iy = S_Y;
  t2.out = z2;
  t2.out_kind = OUT_I8;
  t2.M = pixels;
  t2.N = c;
  t2.pixels = 1;
  t2.g = ch;
  if ((err = run_tile<3, TE_KH3_Q>(t2, stream))) return err;

  // conv3 (1x1, c -> c4) + shortcut + relu over the interior pixels; then
  // the output's ring rows are zeroed.
  TileArgs t3{};
  t3.sum[0] = S8Sum{z2, w3_nk, static_cast<long long>(rows) * c, c, 0, c};
  t3.sw[0] = sw3, t3.num[0] = S_Z2, t3.den[0] = S_Y;
  t3.b = b3;
  t3.scales = scales;
  t3.iy = S_Y;
  t3.unit_y = unit_y;
  t3.out_kind = out_kind == 2 ? OUT_F32 : out_kind;
  t3.out = out_kind == 2 ? static_cast<void*>(y) : out;
  t3.M = pixels;
  t3.N = c4;
  t3.pixels = 1;
  t3.g = ch;
  if (wd_nk) {
    t3.sum[1] = S8Sum{x, wd_nk, static_cast<long long>(rows) * cin, cin, 0, cin};
    t3.sw[1] = swd, t3.num[1] = S_X, t3.den[1] = S_Y;
    t3.bd = bd;
    if ((err = run_tile<2, TE_OUT>(t3, stream))) return err;
  } else {
    t3.res = x;
    if ((err = run_tile<1, TE_OUT>(t3, stream))) return err;
  }
  if (out_kind == 2) {
    const dim3 grid((c4 + 127) / 128, B);
    mean_kernel<<<grid, 128, 0, stream>>>(y, ch, c4, inv_hw, static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  zero_ring_kernel<<<264, 256, 0, stream>>>(static_cast<uint8_t*>(out), ch, B,
                                            c4 * (out_kind == OUT_BF16 ? 2 : 1));
  return static_cast<int>(cudaGetLastError());
}

// A run of n_blocks stride-1 blocks.  Per-block parameters are stacked,
// the weights as K-major copies: w1s (n_w1, c, c4) with n_w1 = n_blocks -
// (w10 != NULL), w2ps (N, 3c, 3c), w3s (N, c4, c); sw1s/b1s/b2s (N, c),
// sw2ps (N, 3c), sw3s/b3s (N, c4), scales_s (N, 4), the last block's s_y
// taken as 1 when it exits bf16.  With w10 (c, cin)/wd (c4, cin)/swd/bd
// block 0 is the projection block over x (rows, cin).  Activations between
// blocks go through act0/act1 (int8 chains, (B*hp*wp, c4)); the last block
// writes `out` (int8 or bf16).
extern "C" int chain_run_int8(
    const int8_t* x, int n_blocks, int B, int h, int w, int hp, int wp, int cin,
    int c, int c4, const int8_t* w1s, const int8_t* w10,
    const float* sw1s, const float* b1s, const int8_t* w2ps, const float* sw2ps,
    const float* b2s, const int8_t* w3s, const float* sw3s, const float* b3s,
    const float* scales_s, const int8_t* wd, const float* swd, const float* bd,
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
        w1, sw1s + (size_t)n * c, b1s + (size_t)n * c,
        w2ps + (size_t)n * 9 * c * c, sw2ps + (size_t)n * 3 * c, b2s + (size_t)n * c,
        w3s + (size_t)n * c * c4, sw3s + (size_t)n * c4, b3s + (size_t)n * c4,
        scales_s + 4 * n, last && last_bf16, pn ? wd : nullptr, swd, bd, z1, z2, nullptr,
        last ? (last_bf16 ? OUT_BF16 : OUT_I8) : OUT_I8,
        last ? out : static_cast<void*>(act[n % 2]), 0.f, stream);
    if (err) return err;
  }
  return 0;
}

// The stride-2 transition block: x is the (h, w) input stage's int8 chain,
// out the (oh, ow) = ((h+1)/2, (w+1)/2) stage's chain (int8, or bf16 when
// out_kind == 1).  The weights are the K-major copies w1_nk (c, cin), w2_nk
// (c, 9c) whose columns are (kh, kw, k), w3_nk (c4, c), wd_nk (c4, cin); the
// vectors raw: sw1, b1, sw2, b2 (c), sw3, b3, swd, bd (c4); scales the device
// [s_x, s_z1, s_z2, s_y], s_y taken as 1 when unit_y.  z1 (B*hp*wp, c) and
// z2 (B*hp2*wp2, c) are int8 scratch.  Returns the first failed launch's
// cudaError_t, or 0.
extern "C" int ds_block_s2_int8(
    const int8_t* x, int B, int h, int w, int hp, int wp, int cin, int c, int c4,
    int oh, int ow, int hp2, int wp2,
    const int8_t* w1_nk, const float* sw1, const float* b1,
    const int8_t* w2_nk, const float* sw2, const float* b2,
    const int8_t* w3_nk, const float* sw3, const float* b3,
    const int8_t* wd_nk, const float* swd, const float* bd,
    const float* scales, int unit_y, int8_t* z1, int8_t* z2, int out_kind, void* out,
    cudaStream_t stream) {
  enum { S_X = 0, S_Z1 = 1, S_Z2 = 2, S_Y = 3 };
  const Chain gi{h, w, hp, wp}, go{oh, ow, hp2, wp2};
  const int rows = B * hp * wp, pixels = B * oh * ow;
  int err;

  // conv1 (1x1, cin -> c) over every chain row of x: relu(fma(P, a1, c1))
  // -> int8, ring rows zero (conv2's padding).
  TileArgs t1{};
  t1.sum[0] = S8Sum{x, w1_nk, static_cast<long long>(rows) * cin, cin, 0, cin};
  t1.sw[0] = sw1, t1.num[0] = S_X, t1.den[0] = S_Z1;
  t1.b = b1;
  t1.scales = scales;
  t1.iy = S_Y;
  t1.out = z1;
  t1.out_kind = OUT_I8;
  t1.M = rows;
  t1.N = c;
  t1.g = gi;
  if ((err = run_tile<1, TE_RELU_Q>(t1, stream))) return err;

  // conv2 (3x3/2) over the output's interior pixels: one sum over the nine
  // taps, segment u (3c columns) reading z1 from the chain row of input
  // pixel (2i+u-1, 2j-1).
  TileArgs t2{};
  t2.sum[0] = S8Sum{z1, w2_nk, static_cast<long long>(rows) * c, c, -wp - 1, 9 * c, 3 * c, wp};
  t2.sw[0] = sw2, t2.num[0] = S_Z1, t2.den[0] = S_Z2;
  t2.b = b2;
  t2.scales = scales;
  t2.iy = S_Y;
  t2.out = z2;
  t2.out_kind = OUT_I8;
  t2.M = pixels;
  t2.N = c;
  t2.pixels = 1;
  t2.g = go;
  t2.src = gi;
  if ((err = run_tile<1, TE_RELU_Q, 0, false, 1>(t2, stream))) return err;

  // conv3 (1x1, c -> c4) + the 1x1/2 projection of x at input pixel (2i,
  // 2j) + relu over the output's interior pixels; then its ring rows zero.
  TileArgs t3{};
  t3.sum[0] = S8Sum{z2, w3_nk, static_cast<long long>(B) * hp2 * wp2 * c, c, 0, c};
  t3.sw[0] = sw3, t3.num[0] = S_Z2, t3.den[0] = S_Y;
  t3.sum[1] = S8Sum{x, wd_nk, static_cast<long long>(rows) * cin, cin, 0, cin, cin, 0};
  t3.sw[1] = swd, t3.num[1] = S_X, t3.den[1] = S_Y;
  t3.b = b3;
  t3.bd = bd;
  t3.scales = scales;
  t3.iy = S_Y;
  t3.unit_y = unit_y;
  t3.out = out;
  t3.out_kind = out_kind;
  t3.M = pixels;
  t3.N = c4;
  t3.pixels = 1;
  t3.g = go;
  t3.src = gi;
  if ((err = run_tile<2, TE_OUT, 0, false, 2>(t3, stream))) return err;
  zero_ring_kernel<<<264, 256, 0, stream>>>(static_cast<uint8_t*>(out), go, B,
                                            c4 * (out_kind == OUT_BF16 ? 2 : 1));
  return static_cast<int>(cudaGetLastError());
}
