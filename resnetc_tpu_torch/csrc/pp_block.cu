// Pixel-paired int8 block kernels for stage 0 (c = 64) of both families.
//
// Replaces four Pallas megakernels of resnetc_tpu/ops/pallas/block.py:
//   - bottleneck_block_chained_int8_pp (block.py:1113, body
//     _chained_kernel_int8_pp :996): one stride-1 bottleneck block, identity
//     or 1x1 projection shortcut, int8 or bf16 exit;
//   - bottleneck_run_chained_int8_pp (block.py:1387, body :1286): a run of N
//     such blocks, optionally with the projection block 0 first;
//   - basic_block_chained_int8_pp (block.py:2002, body :1925): one stride-1
//     BasicBlock;
//   - basic_run_chained_int8_pp (block.py:2175, body :2087): a run of N.
//
// What they compute.  The Pallas bodies on their pair-space operands: the
// chain buffer viewed as pair rows (B*hp*wp/2, 2*cin), two W-adjacent pixels
// per row; block-diagonal 1x1 weights (2*cin, 2*cout); the pair-packed 3x3
// (3*2c, 3*2c), rows (kwp, half, k), columns (kh, half, j); fp32 scale and
// bias vectors lane-tiled to pair width.  Each kernel is a dense pair-space
// GEMM: it does not assume the zero blocks of those weights, so it computes
// exactly what the pair-space operands say (the wrappers' plain versions
// compute the same, and the card tests feed dense random weights).  The
// only pair-specific rule is interior-ness per half of a pair row, because
// the pad parity differs inside boundary pairs: a source half whose pixel
// lies outside the image reads as zero, and the epilogues write zeros to
// the ring half of a boundary pair.
//
// The BasicBlock and its run (rows 9 and 10) run on the int8 tensor-core
// tile of chain_tile.cuh in pair geometry: two launches a block, M =
// B*hp*wp/2 pair rows, N = 2c = 128, kernel row kh reading pair rows m +
// (kh-1)*wp/2 - 1 .. + 1 as one row of K = 3*2c = 384 contiguous int8 values
// (lda = 2c), B the K-major copy of the pair-packed 3x3.  conv1 zero-fills
// each 16-byte chunk whose half's source pixel is off the image (at c = 64 a
// (kwp, half) block is four whole chunks, so no chunk straddles two halves)
// and writes z1's ring halves as zeros; conv2 reads z1 with no test, adds
// the residual x * s_res and writes the output's ring halves as zeros.  Both
// run over every pair row.  The kernels take the vectors folded and
// lane-tiled on the host, once per call (the JAX wrappers' jnp.tile; the
// tile's `folded` mode); the engine makes the pair-packed weights' K-major
// copies once (fused.pack_chain_kmajor), a call without them packs and
// transposes once.
//
// The bottleneck block and run (rows 5 and 6) are each convolution one
// launch of the dp4a implicit GEMM of igemm.cuh in pair geometry (M =
// B*hp*wp/2 rows, N = 2*cout, the 3x3's kw taps shifting whole pair rows),
// three launches a block, with int8 intermediates in device scratch that the
// wrapper allocates; a run loops over its blocks, handing the int8
// activation on through two ping-pong buffers.  Epilogues as in the
// standard kernels, in the Pallas order with XLA's fused multiply-adds.
//
// What bounds it.  The work (the standard block's: interior pixels times
// its convolutions' operations) is far above the card's int8 ridge, so the
// bound is the int8 tensor-core rate.  In pair space every kernel does
// twice the standard kernels' multiply-adds: the 1x1s multiply a zero
// block, and 6 of the pack's 12 (2c, 2c) blocks are zero.  On the TPU
// pairing bought N = 128 matrix-unit tiles; here the basic kernels get
// N = 128 wgmma tiles and pay the zero blocks.  Skipping them, and moving
// rows 5 and 6 off dp4a, is later work.

#include "chain_tile.cuh"

// One pixel-paired stride-1 bottleneck block, pair rows in and out: x
// (B*hp*wp/2, cin2) int8; w1 (cin2, c2) block-diagonal, a1, c1 (c2,); w2
// (3*c2, 3*c2) pair-packed, a2 (3, c2) per-(kh, half, j) multipliers, c2v
// (c2,); w3 (c2, c4p), a3, c3 (c4p,); wd == NULL: identity shortcut (cin2 ==
// c4p), residual x * s_res; else the 1x1 projection wd (cin2, c4p), ad, cd
// (c4p,).  z1, z2 (B*hp*wp/2, c2) int8 scratch.  out_kind 0: int8, 1: bf16.
// (h, w, hp, wp) is the pixel geometry.  Returns the first launch's
// cudaError_t, or 0.
extern "C" int pp_block_int8(
    const int8_t* x, int B, int h, int w, int hp, int wp, int cin2, int c2, int c4p,
    const int8_t* w1, const float* a1, const float* c1,
    const int8_t* w2, const float* a2, const float* c2v,
    const int8_t* w3, const float* a3, const float* c3,
    const float* s_res, const int8_t* wd, const float* ad, const float* cd,
    int8_t* z1, int8_t* z2, int out_kind, void* out, cudaStream_t stream) {
  const Geo g{h, w, hp, wp};
  const int M = B * hp * wp / 2;
  int err;

  // conv1 (1x1, block-diagonal): relu(fma(acc, a1, c1)) -> int8, ring
  // halves zeroed.
  Operand o1 = operand(x, cin2, g, 1, 1, 0, w1, c2, 0);
  EpiArgs e1{};
  e1.a[0] = a1;
  e1.c = c1;
  e1.out_kind = OUT_I8;
  e1.out = z1;
  if ((err = launch<1, EPI_RELU_Q, false, true>(&o1, g, M, c2, e1, stream))) return err;

  // conv2 (pair-packed 3x3): three int32 sums P_kh, one per kernel row.
  Operand o2[3];
  for (int kh = 0; kh < 3; ++kh) o2[kh] = operand(z1, c2, g, 1, 3, kh, w2, 3 * c2, kh * c2);
  EpiArgs e2{};
  e2.a[0] = a2;
  e2.a[1] = a2 + c2;
  e2.a[2] = a2 + 2 * c2;
  e2.c = c2v;
  e2.out_kind = OUT_I8;
  e2.out = z2;
  if ((err = launch<3, EPI_KH3_Q, false, true>(o2, g, M, c2, e2, stream))) return err;

  // conv3 (1x1, block-diagonal) + shortcut + relu.
  Operand o3[2];
  o3[0] = operand(z2, c2, g, 1, 1, 0, w3, c4p, 0);
  EpiArgs e3{};
  e3.a[0] = a3;
  e3.c = c3;
  e3.out_kind = out_kind;
  e3.out = out;
  if (wd) {
    o3[1] = operand(x, cin2, g, 1, 1, 0, wd, c4p, 0);
    e3.ad = ad;
    e3.cd = cd;
    return launch<2, EPI_BLOCK_OUT, false, true>(o3, g, M, c4p, e3, stream);
  }
  e3.res = x;
  e3.s_res = s_res;
  return launch<1, EPI_BLOCK_OUT, false, true>(o3, g, M, c4p, e3, stream);
}

// A run of n_blocks pixel-paired bottleneck blocks.  Per-block pair-space
// parameters are stacked: w1s (n_w1, c4p, c2) with n_w1 = n_blocks -
// (w10 != NULL), w2s (N, 3*c2, 3*c2), w3s (N, c2, c4p), a1s/c1s/c2s (N, c2),
// a2s (N, 3, c2), a3s/c3s (N, c4p), s_res (N,).  With w10 (cin2, c2) and
// wd/ad/cd block 0 is the projection block over x (rows, cin2).
// Activations between blocks go through act0/act1 (int8 pair rows,
// (B*hp*wp/2, c4p)); the last block writes `out` (int8 or bf16).
extern "C" int pp_run_int8(
    const int8_t* x, int n_blocks, int B, int h, int w, int hp, int wp, int cin2,
    int c2, int c4p, const int8_t* w1s, const int8_t* w10,
    const float* a1s, const float* c1s, const int8_t* w2s, const float* a2s,
    const float* c2s, const int8_t* w3s, const float* a3s, const float* c3s,
    const float* s_res, const int8_t* wd, const float* ad, const float* cd,
    int8_t* z1, int8_t* z2, int8_t* act0, int8_t* act1, int last_bf16,
    void* out, cudaStream_t stream) {
  const bool proj = w10 != nullptr;
  int8_t* act[2] = {act0, act1};
  for (int n = 0; n < n_blocks; ++n) {
    const bool last = n == n_blocks - 1;
    const bool pn = proj && n == 0;
    const int8_t* w1 = proj ? (n == 0 ? w10 : w1s + (size_t)(n - 1) * c4p * c2)
                            : w1s + (size_t)n * c4p * c2;
    const int err = pp_block_int8(
        n == 0 ? x : act[(n - 1) % 2], B, h, w, hp, wp, pn ? cin2 : c4p, c2, c4p,
        w1, a1s + (size_t)n * c2, c1s + (size_t)n * c2,
        w2s + (size_t)n * 9 * c2 * c2, a2s + (size_t)n * 3 * c2, c2s + (size_t)n * c2,
        w3s + (size_t)n * c2 * c4p, a3s + (size_t)n * c4p, c3s + (size_t)n * c4p,
        s_res + n, pn ? wd : nullptr, ad, cd, z1, z2,
        last ? (last_bf16 ? OUT_BF16 : OUT_I8) : OUT_I8,
        last ? out : static_cast<void*>(act[n % 2]), stream);
    if (err) return err;
  }
  return 0;
}

// One pixel-paired stride-1 BasicBlock, pair rows in and out: x
// (B*hp*wp/2, c2) int8; w1_nk, w2_nk (3*c2, 3*c2) the K-major copies of the
// pair-packed 3x3s; a1, a2 (3, c2) folded per-(kh, half, j) multipliers;
// c1, c2v (c2,) folded biases; s_res the identity-residual scale (device
// scalar).  z1 (B*hp*wp/2, c2) int8 scratch.  out_kind 0: int8, 1: bf16.  x
// enters conv1 masked per half; the residual reads it as it is.
extern "C" int pp_basic_block_int8(
    const int8_t* x, int B, int h, int w, int hp, int wp, int c2,
    const int8_t* w1_nk, const float* a1, const float* c1,
    const int8_t* w2_nk, const float* a2, const float* c2v, const float* s_res,
    int8_t* z1, int out_kind, void* out, cudaStream_t stream) {
  const int M = B * hp * wp / 2;
  const long long limit = static_cast<long long>(M) * c2;
  TileArgs t[2] = {};
  const int8_t* a_of[2] = {x, z1};
  const int8_t* w_of[2] = {w1_nk, w2_nk};
  const float* mul_of[2] = {a1, a2};
  for (int conv = 0; conv < 2; ++conv) {
    TileArgs& p = t[conv];
    for (int kh = 0; kh < 3; ++kh) {
      p.sum[kh] = S8Sum{a_of[conv], w_of[conv] + static_cast<size_t>(kh) * c2 * 3 * c2, limit,
                        c2, (kh - 1) * (wp / 2) - 1, 3 * c2};
      p.sw[kh] = mul_of[conv] + kh * c2;
    }
    p.scales = s_res;
    p.folded = 1;
    p.M = M;
    p.N = c2;
    p.g = Chain{h, w, hp, wp};
  }
  // conv1 (pair-packed 3x3): relu(kh3 + c1) -> int8, ring halves zeroed.
  t[0].b = c1;
  t[0].out = z1;
  t[0].out_kind = OUT_I8;
  int err = run_tile<3, TE_KH3_Q, true, true>(t[0], stream);
  if (err) return err;
  // conv2 (pair-packed 3x3) + identity residual x*s_res + relu.
  t[1].b = c2v;
  t[1].res = x;
  t[1].out = out;
  t[1].out_kind = out_kind;
  return run_tile<3, TE_KH3_OUT, false, true>(t[1], stream);
}

// A run of n_blocks pixel-paired BasicBlocks: w1s_nk, w2s_nk (N, 3*c2, 3*c2)
// K-major; a1s, a2s (N, 3, c2), c1s, c2s (N, c2), s_res (N,).  Activations
// between blocks go through act0/act1 ((B*hp*wp/2, c2) int8); the last block
// writes `out` (int8 or bf16).
extern "C" int pp_basic_run_int8(
    const int8_t* x, int n_blocks, int B, int h, int w, int hp, int wp, int c2,
    const int8_t* w1s_nk, const float* a1s, const float* c1s,
    const int8_t* w2s_nk, const float* a2s, const float* c2s, const float* s_res,
    int8_t* z1, int8_t* act0, int8_t* act1, int last_bf16, void* out,
    cudaStream_t stream) {
  int8_t* act[2] = {act0, act1};
  for (int n = 0; n < n_blocks; ++n) {
    const bool last = n == n_blocks - 1;
    const size_t wo = (size_t)n * 9 * c2 * c2, vo = (size_t)n * 3 * c2, bo = (size_t)n * c2;
    const int err = pp_basic_block_int8(
        n == 0 ? x : act[(n - 1) % 2], B, h, w, hp, wp, c2,
        w1s_nk + wo, a1s + vo, c1s + bo, w2s_nk + wo, a2s + vo, c2s + bo, s_res + n,
        z1, last ? (last_bf16 ? OUT_BF16 : OUT_I8) : OUT_I8,
        last ? out : static_cast<void*>(act[n % 2]), stream);
    if (err) return err;
  }
  return 0;
}
