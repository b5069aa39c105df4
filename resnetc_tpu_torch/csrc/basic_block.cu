// Int8 BasicBlock kernels (ResNet-18/34) over the chained padded-row layout.
//
// Replaces three Pallas megakernels of resnetc_tpu/ops/pallas/block.py:
//   - basic_block_chained_int8 (block.py:1646, body _basic_chained_kernel_int8
//     :1559): one stride-1 BasicBlock, two kh-batched 3x3s and the identity
//     shortcut; int8 or bf16 exit;
//   - basic_run_chained_int8 (block.py:1830, body :1734): a run of N such
//     blocks, the int8 activation handed from block to block;
//   - basic_ds_block_s2_int8 (block.py:2542, body :2336): the stride-2 stage
//     transition (3x3/2, 3x3, 1x1/2 projection), chain layout in and out.
//
// The stride-1 block (and so the run, which loops over it) is two launches
// of the int8 tensor-core kernel of chain_tile.cuh (wgmma s32.s8.s8, the
// tile of the bottleneck block, chain_block.cu), each over the interior
// pixels (row m of the GEMM is pixel m, at its chain row) and each followed
// by a small kernel that zeroes the ring rows of what it wrote, with the
// int8 intermediate z1 in device scratch that the wrapper allocates:
//   conv1: kernel row kh reads the three consecutive chain rows
//          t + (kh-1)*wp - 1 .. + 1 of x (3c contiguous int8 values, the
//          (kw, k) order of w1pq's rows), a chunk whose source pixel lies
//          off the image zero-filled (the kernel's MASK: a ring row of x may
//          hold anything, and the JAX kernel masks x before its first 3x3);
//          three int32 sums P_kh folded as
//          relu(fma(P2, a2, fma(P0, a0, P1*a1)) + c1) -> int8; z1's ring
//          rows zeroed, so that they are conv2's padding;
//   conv2: the same three sums over z1 with no test, then the identity
//          residual fma(x, s_res, y) read from x at the row, relu, int8 or
//          bf16 out; the output's ring rows zeroed.
// conv1 over the interior pixels and a ring pass against conv1 over every
// chain row (ring rows written as zeros by the epilogue's select), measured
// on an H100 at batch 32 (NVIDIA H100 80GB HBM3, 700 W; PERF.md, section 6):
// 0.0939 against 0.1024 ms a block at 28x28, 0.0645 / 0.0624 at 14x14,
// 0.0624 / 0.0892 at 7x7, the stage-0 run of three 0.4637 / 0.5103.
// The weights are the K-major (N, K) copies w1pq_nk = w1pq.t(), whose row
// kh*c + j is output j of kernel row kh (the int8_chain engine makes them
// once, fused.pack_chain_kmajor; a call without them transposes once), and
// the requant scales are folded in the kernel from the raw sw1p, b1, sw2p,
// b2 and the device [s_x, s_z1, s_y] (s_y taken as 1 with unit_y: the bf16
// exit, the run's last block), op for op as _fold_basic.
//
// What bounds it.  Each 3x3 does 18*c*c int8 operations per output pixel
// against 2*c bytes moved, far above the card's int8 ridge: the bound is the
// int8 tensor-core rate (~7.5 us a block at batch 32 at every ResNet-34
// stage).  What holds this design below it is row 1's (chain_block.cu): z1
// through device memory, the wgmma pipeline drained at each sum boundary,
// two stages of copies in flight, one block an SM (registers).
//
// The transition is two launches of the same tile and two ring passes,
// over the output's interior pixels (row m of the GEMM is output pixel
// (i, j)), with z1 in the output geometry:
//   conv1: 3x3/2 over x as ONE int32 sum over the nine taps (its
//          per-channel scale is joint over them, as on the TPU): the
//          stride-2 source row (S2) reads x from the chain row of input
//          pixel (2i, 2j), segment u (3cin values) the three chain rows of
//          pixels (2i+u-1, 2j-1 .. +1), and the mask (MASK) zero-fills the
//          taps off the image, since x's ring may hold anything;
//          relu(fma(P, a1, c1)) -> int8 z1, whose ring rows are then
//          zeroed (conv2's padding);
//   conv2: the three kernel-row sums over z1 (no test) and the 1x1/2
//          projection of x at (2i, 2j) as a fourth sum (S2, interior
//          pixels only), folded as relu(fma(Pd, ad, kh3 + c2) + cd) ->
//          int8 or bf16; the output's ring rows zeroed.
// Its weights are the K-major copies w1_nk (c, 9cin), columns (kh, kw, k):
// the (3, 4cin, c) pair-slot packing of the TPU kernel without the zero
// rows [3cin, 4cin) of each kernel row; w2_nk (3c, 3c); wd_nk (c, cin);
// the requant scales folded in the kernel from the raw vectors and the
// device [s_x, s_z1, s_y], op for op as _fold_basic_ds.
// Every transition of ResNet-34 does 2*oh*ow*(9*cin*c + 9*c*c + cin*c)
// int8 operations an image against ~(oh*ow*(4*cin + c)) bytes: bound by the
// int8 tensor-core rate (~5.8 us at batch 32).
//
// The outputs equal the plain PyTorch versions in
// resnetc_tpu_torch/ops/cuda/block.py bit for bit.

#include "chain_tile.cuh"

// One stride-1 BasicBlock, chain in and out: x (B*hp*wp, c) int8; w1_nk,
// w2_nk (3c, 3c) the K-major copies of the kh-batched 3x3s; sw1p, sw2p
// (3c: (kh, j)), b1, b2 (c) fp32; scales the device [s_x, s_z1, s_y], s_y
// taken as 1 when unit_y.  z1 (B*hp*wp, c) int8 scratch.  out_kind 0: int8
// chain, 1: bf16 chain.  Returns the first failed launch's cudaError_t, or
// 0.
extern "C" int basic_block_int8(
    const int8_t* x, int B, int h, int w, int hp, int wp, int c,
    const int8_t* w1_nk, const float* sw1p, const float* b1,
    const int8_t* w2_nk, const float* sw2p, const float* b2,
    const float* scales, int unit_y, int8_t* z1, int out_kind, void* out,
    cudaStream_t stream) {
  enum { S_X = 0, S_Z1 = 1, S_Y = 2 };
  const Chain ch{h, w, hp, wp};
  const int rows = B * hp * wp;
  const long long limit = static_cast<long long>(rows) * c;
  int err;

  // conv1 (3x3/1) over the interior pixels: kernel row kh reads x at row
  // offset (kh-1)*wp - 1, off-image pixels zero; relu(kh3 + c1) -> int8;
  // then z1's ring rows are zeroed.
  TileArgs t1{};
  for (int kh = 0; kh < 3; ++kh) {
    t1.sum[kh] = S8Sum{x, w1_nk + static_cast<size_t>(kh) * c * 3 * c, limit, c,
                       (kh - 1) * wp - 1, 3 * c};
    t1.sw[kh] = sw1p + kh * c, t1.num[kh] = S_X, t1.den[kh] = S_Z1;
  }
  t1.b = b1;
  t1.scales = scales;
  t1.iy = S_Y;
  t1.out = z1;
  t1.out_kind = OUT_I8;
  t1.M = B * h * w;
  t1.N = c;
  t1.pixels = 1;
  t1.g = ch;
  if ((err = run_tile<3, TE_KH3_Q, 7>(t1, stream))) return err;
  zero_ring_kernel<<<264, 256, 0, stream>>>(reinterpret_cast<uint8_t*>(z1), ch, B, c);

  // conv2 (3x3/1) over the interior pixels, + identity residual + relu;
  // then the output's ring rows are zeroed.
  TileArgs t2{};
  for (int kh = 0; kh < 3; ++kh) {
    t2.sum[kh] = S8Sum{z1, w2_nk + static_cast<size_t>(kh) * c * 3 * c, limit, c,
                       (kh - 1) * wp - 1, 3 * c};
    t2.sw[kh] = sw2p + kh * c, t2.num[kh] = S_Z1, t2.den[kh] = S_Y;
  }
  t2.b = b2;
  t2.scales = scales;
  t2.iy = S_Y;
  t2.unit_y = unit_y;
  t2.res = x;
  t2.out = out;
  t2.out_kind = out_kind;
  t2.M = B * h * w;
  t2.N = c;
  t2.pixels = 1;
  t2.g = ch;
  if ((err = run_tile<3, TE_KH3_OUT>(t2, stream))) return err;
  zero_ring_kernel<<<264, 256, 0, stream>>>(static_cast<uint8_t*>(out), ch, B,
                                            c * (out_kind == OUT_BF16 ? 2 : 1));
  return static_cast<int>(cudaGetLastError());
}

// A run of n_blocks stride-1 BasicBlocks.  Per-block parameters are
// stacked: w1s_nk, w2s_nk (N, 3c, 3c) K-major; sw1ps, sw2ps (N, 3c); b1s,
// b2s (N, c); scales_s (N, 3), the last block's s_y taken as 1 when it
// exits bf16.  Activations between blocks go through act0/act1 (int8
// chains, (B*hp*wp, c)); the last block writes `out` (int8 or bf16).
extern "C" int basic_run_int8(
    const int8_t* x, int n_blocks, int B, int h, int w, int hp, int wp, int c,
    const int8_t* w1s_nk, const float* sw1ps, const float* b1s,
    const int8_t* w2s_nk, const float* sw2ps, const float* b2s, const float* scales_s,
    int8_t* z1, int8_t* act0, int8_t* act1, int last_bf16, void* out,
    cudaStream_t stream) {
  int8_t* act[2] = {act0, act1};
  for (int n = 0; n < n_blocks; ++n) {
    const bool last = n == n_blocks - 1;
    const size_t wo = (size_t)n * 9 * c * c, vo = (size_t)n * 3 * c, bo = (size_t)n * c;
    const int err = basic_block_int8(
        n == 0 ? x : act[(n - 1) % 2], B, h, w, hp, wp, c,
        w1s_nk + wo, sw1ps + vo, b1s + bo, w2s_nk + wo, sw2ps + vo, b2s + bo,
        scales_s + 3 * n, last && last_bf16, z1,
        last ? (last_bf16 ? OUT_BF16 : OUT_I8) : OUT_I8,
        last ? out : static_cast<void*>(act[n % 2]), stream);
    if (err) return err;
  }
  return 0;
}

// The stride-2 BasicBlock transition: x is the (h, w) input stage's int8
// chain (cin channels), out the (oh, ow) = ((h+1)/2, (w+1)/2) stage's chain
// (c channels; int8, or bf16 when out_kind == 1).  The weights are the
// K-major copies w1_nk (c, 9cin), w2_nk (3c, 3c), wd_nk (c, cin) (see the
// header); the vectors raw: sw1, b1, b2, swd, bd (c), sw2p (3c: (kh, j));
// scales the device [s_x, s_z1, s_y], s_y taken as 1 when unit_y.  z1
// (B*hp2*wp2, c) is int8 scratch in the output geometry.  Returns the first
// failed launch's cudaError_t, or 0.
extern "C" int basic_ds_block_s2_int8(
    const int8_t* x, int B, int h, int w, int hp, int wp, int cin, int c,
    int oh, int ow, int hp2, int wp2,
    const int8_t* w1_nk, const float* sw1, const float* b1,
    const int8_t* w2_nk, const float* sw2p, const float* b2,
    const int8_t* wd_nk, const float* swd, const float* bd,
    const float* scales, int unit_y, int8_t* z1, int out_kind, void* out,
    cudaStream_t stream) {
  enum { S_X = 0, S_Z1 = 1, S_Y = 2 };
  const Chain gi{h, w, hp, wp}, go{oh, ow, hp2, wp2};
  const long long limit_x = static_cast<long long>(B) * hp * wp * cin;
  const long long limit_z1 = static_cast<long long>(B) * hp2 * wp2 * c;
  int err;

  // conv1 (3x3/2, cin -> c) over the output's interior pixels: one sum,
  // segment u reading x from the chain row of input pixel (2i+u-1, 2j-1),
  // off-image taps zero; relu(fma(P, a1, c1)) -> int8; then z1's ring rows
  // are zeroed.
  TileArgs t1{};
  t1.sum[0] = S8Sum{x, w1_nk, limit_x, cin, -wp - 1, 9 * cin, 3 * cin, wp};
  t1.sw[0] = sw1, t1.num[0] = S_X, t1.den[0] = S_Z1;
  t1.b = b1;
  t1.scales = scales;
  t1.iy = S_Y;
  t1.out = z1;
  t1.out_kind = OUT_I8;
  t1.M = B * oh * ow;
  t1.N = c;
  t1.pixels = 1;
  t1.g = go;
  t1.src = gi;
  if ((err = run_tile<1, TE_RELU_Q, 1, false, 1>(t1, stream))) return err;
  zero_ring_kernel<<<264, 256, 0, stream>>>(reinterpret_cast<uint8_t*>(z1), go, B, c);

  // conv2 (3x3/1) over z1 and the 1x1/2 projection of x at input pixel
  // (2i, 2j), then relu(fma(Pd, ad, kh3 + c2) + cd); then the output's ring
  // rows are zeroed.
  TileArgs t2{};
  for (int kh = 0; kh < 3; ++kh) {
    t2.sum[kh] = S8Sum{z1, w2_nk + static_cast<size_t>(kh) * c * 3 * c, limit_z1, c,
                       (kh - 1) * wp2 - 1, 3 * c};
    t2.sw[kh] = sw2p + kh * c, t2.num[kh] = S_Z1, t2.den[kh] = S_Y;
  }
  t2.sum[3] = S8Sum{x, wd_nk, limit_x, cin, 0, cin, cin, 0};
  t2.sw[3] = swd, t2.num[3] = S_X, t2.den[3] = S_Y;
  t2.b = b2;
  t2.bd = bd;
  t2.scales = scales;
  t2.iy = S_Y;
  t2.unit_y = unit_y;
  t2.out = out;
  t2.out_kind = out_kind;
  t2.M = B * oh * ow;
  t2.N = c;
  t2.pixels = 1;
  t2.g = go;
  t2.src = gi;
  if ((err = run_tile<4, TE_KH3_PROJ, 0, false, 8>(t2, stream))) return err;
  zero_ring_kernel<<<264, 256, 0, stream>>>(static_cast<uint8_t*>(out), go, B,
                                            c * (out_kind == OUT_BF16 ? 2 : 1));
  return static_cast<int>(cudaGetLastError());
}
