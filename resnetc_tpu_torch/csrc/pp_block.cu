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
// All four run on the int8 tensor-core tile of chain_tile.cuh in pair
// geometry, over every pair row: M = B*hp*wp/2 pair rows, N = 2 * cout, a
// kernel row kh of a pair-packed 3x3 reading pair rows m + (kh-1)*wp/2 - 1
// .. + 1 as one row of K = 3*2c = 384 contiguous int8 values (lda = 2c), a
// 1x1 its own pair row, B the K-major copy of each pair-space weight.  A
// conv that reads x itself (the BasicBlock's conv1, the bottleneck's conv1
// and projection) zero-fills each 16-byte chunk whose half's source pixel is
// off the image (the tile's MASK; at c = 64 a (kwp, half) block is four
// whole chunks and a 1x1's half of a pair row four or sixteen, so no chunk
// straddles two halves); the conv1 epilogues write z1's ring halves as zeros
// (a select), so the 3x3 over z1 reads it with no test, and every epilogue
// writes the output's ring halves as zeros.
//   - The bottleneck block (rows 5 and 6): conv1 the block-diagonal 1x1
//     (cin2 -> c2 = 128, TE_RELU_Q); conv2 the pair-packed 3x3 as three
//     sums (TE_KH3_Q, a2 per (kh, half, j)); conv3 the block-diagonal 1x1
//     plus the identity residual x * s_res, or the projection as a second
//     sum (TE_OUT): three launches a block.  The run loops over the block,
//     handing the int8 activation on through two ping-pong buffers.
//   - The BasicBlock (rows 9 and 10): two pair-packed 3x3s, the identity
//     residual in conv2's epilogue: two launches a block.
// The chain-level entries give the kernels the standard block's raw
// vectors and the device scales: the tile folds them in its epilogue and
// reads channel n of a pair row at n mod cout (`tiled`), which is the JAX
// wrappers' fold-then-jnp.tile, bit for bit.  The pair-space entries (and
// the basic kernels) give them folded and lane-tiled (the tile's `folded`
// mode).  The engine makes the K-major copies of the pair-space weights once
// (fused.pack_chain_kmajor: the block-diagonal 1x1s, the pair-packed 3x3s,
// stage 0's run stacked); a call without them packs and transposes once.
//
// What bounds it.  The work (the standard block's: interior pixels times
// its convolutions' operations) is far above the card's int8 ridge, so the
// bound is the int8 tensor-core rate.  In pair space every kernel does
// twice the standard kernels' multiply-adds: the 1x1s multiply a zero
// block, and 6 of the pack's 12 (2c, 2c) blocks are zero.  On the TPU
// pairing bought N = 128 matrix-unit tiles; here the kernels get N = 128
// wgmma tiles and pay the zero blocks.  Skipping them is later work.

#include "chain_tile.cuh"

// One pixel-paired stride-1 bottleneck block, pair rows in and out: x
// (B*hp*wp/2, cin2) int8; the K-major pair-space weights w1_nk (c2, cin2)
// block-diagonal, w2_nk (3*c2, 3*c2) pair-packed (row kh*c2 + j: output j
// of kernel row kh), w3_nk (c4p, c2); wd_nk == NULL: identity shortcut
// (cin2 == c4p), residual x * s_res; else the 1x1 projection wd_nk (c4p,
// cin2).  With `folded` the vectors are the pair-space entry's: sw1, b1
// (c2), sw2 (3, c2), b2 (c2), sw3, b3, swd, bd (c4p) the folded multipliers
// and biases, scales the device residual scale s_res.  Without it they are
// the standard block's raw vectors, half as wide (sw2 (3c2/2) per (kh, j)),
// and scales the device [s_x, s_z1, s_z2, s_y], s_y taken as 1 when
// unit_y.  z1, z2 (B*hp*wp/2, c2) int8 scratch.  out_kind 0: int8, 1: bf16.
// (h, w, hp, wp) is the pixel geometry.  Returns the first failed launch's
// cudaError_t, or 0.
extern "C" int pp_block_int8(
    const int8_t* x, int B, int h, int w, int hp, int wp, int cin2, int c2, int c4p,
    const int8_t* w1_nk, const float* sw1, const float* b1,
    const int8_t* w2_nk, const float* sw2, const float* b2,
    const int8_t* w3_nk, const float* sw3, const float* b3,
    const float* scales, int folded, int unit_y,
    const int8_t* wd_nk, const float* swd, const float* bd,
    int8_t* z1, int8_t* z2, int out_kind, void* out, cudaStream_t stream) {
  enum { S_X = 0, S_Z1 = 1, S_Z2 = 2, S_Y = 3 };
  const int M = B * hp * wp / 2;
  TileArgs t[3] = {};
  for (TileArgs& p : t) {
    p.scales = scales;
    p.iy = S_Y;
    p.folded = folded;
    p.tiled = !folded;
    p.M = M;
    p.g = Chain{h, w, hp, wp};
  }
  int err;

  // conv1 (1x1, block-diagonal) over x masked per half: relu(fma(P, a1,
  // c1)) -> int8, ring halves zeroed.
  t[0].sum[0] = S8Sum{x, w1_nk, static_cast<long long>(M) * cin2, cin2, 0, cin2};
  t[0].sw[0] = sw1, t[0].num[0] = S_X, t[0].den[0] = S_Z1;
  t[0].b = b1;
  t[0].out = z1;
  t[0].out_kind = OUT_I8;
  t[0].N = c2;
  if ((err = run_tile<1, TE_RELU_Q, 1, true>(t[0], stream))) return err;

  // conv2 (pair-packed 3x3): three int32 sums P_kh, one per kernel row;
  // relu(kh3 + c2) -> int8, ring halves zeroed.
  const int step = folded ? c2 : c2 / 2;  // multipliers per kernel row
  for (int kh = 0; kh < 3; ++kh) {
    t[1].sum[kh] = S8Sum{z1, w2_nk + static_cast<size_t>(kh) * c2 * 3 * c2,
                         static_cast<long long>(M) * c2, c2, (kh - 1) * (wp / 2) - 1, 3 * c2};
    t[1].sw[kh] = sw2 + kh * step, t[1].num[kh] = S_Z1, t[1].den[kh] = S_Z2;
  }
  t[1].b = b2;
  t[1].out = z2;
  t[1].out_kind = OUT_I8;
  t[1].N = c2;
  if ((err = run_tile<3, TE_KH3_Q, 0, true>(t[1], stream))) return err;

  // conv3 (1x1, block-diagonal) + shortcut + relu, ring halves zeroed.
  t[2].sum[0] = S8Sum{z2, w3_nk, static_cast<long long>(M) * c2, c2, 0, c2};
  t[2].sw[0] = sw3, t[2].num[0] = S_Z2, t[2].den[0] = S_Y;
  t[2].b = b3;
  t[2].unit_y = unit_y;
  t[2].out = out;
  t[2].out_kind = out_kind;
  t[2].N = c4p;
  if (wd_nk) {  // the projection over x masked per half
    t[2].sum[1] = S8Sum{x, wd_nk, static_cast<long long>(M) * cin2, cin2, 0, cin2};
    t[2].sw[1] = swd, t[2].num[1] = S_X, t[2].den[1] = S_Y;
    t[2].bd = bd;
    return run_tile<2, TE_OUT, 2, true>(t[2], stream);
  }
  t[2].res = x;
  return run_tile<1, TE_OUT, 0, true>(t[2], stream);
}

// A run of n_blocks pixel-paired bottleneck blocks.  Per-block parameters
// are stacked: w1s_nk (n_w1, c2, c4p) with n_w1 = n_blocks - (w10_nk !=
// NULL), w2s_nk (N, 3*c2, 3*c2), w3s_nk (N, c4p, c2); the vectors as
// pp_block_int8 takes them, stacked: folded, sw1s/b1s/b2s (N, c2), sw2s (N,
// 3, c2), sw3s/b3s (N, c4p), scales_s (N,) the residual scales; raw, each
// half as wide and scales_s (N, 4), the last block's s_y taken as 1 when it
// exits bf16.  With w10_nk (c2, cin2) and wd_nk/swd/bd block 0 is the
// projection block over x (rows, cin2).  Activations between blocks go
// through act0/act1 (int8 pair rows, (B*hp*wp/2, c4p)); the last block
// writes `out` (int8 or bf16).
extern "C" int pp_run_int8(
    const int8_t* x, int n_blocks, int B, int h, int w, int hp, int wp, int cin2,
    int c2, int c4p, const int8_t* w1s_nk, const int8_t* w10_nk,
    const float* sw1s, const float* b1s, const int8_t* w2s_nk, const float* sw2s,
    const float* b2s, const int8_t* w3s_nk, const float* sw3s, const float* b3s,
    const float* scales_s, int folded, const int8_t* wd_nk, const float* swd, const float* bd,
    int8_t* z1, int8_t* z2, int8_t* act0, int8_t* act1, int last_bf16,
    void* out, cudaStream_t stream) {
  const bool proj = w10_nk != nullptr;
  const size_t v2 = folded ? c2 : c2 / 2, v4 = folded ? c4p : c4p / 2;  // vector widths
  int8_t* act[2] = {act0, act1};
  for (int n = 0; n < n_blocks; ++n) {
    const bool last = n == n_blocks - 1;
    const bool pn = proj && n == 0;
    const int8_t* w1 = proj ? (n == 0 ? w10_nk : w1s_nk + (size_t)(n - 1) * c4p * c2)
                            : w1s_nk + (size_t)n * c4p * c2;
    const int err = pp_block_int8(
        n == 0 ? x : act[(n - 1) % 2], B, h, w, hp, wp, pn ? cin2 : c4p, c2, c4p,
        w1, sw1s + n * v2, b1s + n * v2,
        w2s_nk + (size_t)n * 9 * c2 * c2, sw2s + n * 3 * v2, b2s + n * v2,
        w3s_nk + (size_t)n * c2 * c4p, sw3s + n * v4, b3s + n * v4,
        scales_s + (folded ? n : 4 * n), folded, !folded && last && last_bf16,
        pn ? wd_nk : nullptr, swd, bd, z1, z2,
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
  int err = run_tile<3, TE_KH3_Q, 7, true>(t[0], stream);
  if (err) return err;
  // conv2 (pair-packed 3x3) + identity residual x*s_res + relu.
  t[1].b = c2v;
  t[1].res = x;
  t[1].out = out;
  t[1].out_kind = out_kind;
  return run_tile<3, TE_KH3_OUT, 0, true>(t[1], stream);
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
