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
// Each convolution is one launch of the int8 implicit GEMM of igemm.cuh (its
// header gives the layout, the design and the exactness argument), so a
// block costs two launches with its int8 intermediate z1 in device scratch
// that the wrapper allocates.  The second launch of a block takes conv2's
// three kernel rows as three operands (one int32 sum each, dequantized with
// its own per-(kh, j) scale) and, in the transition, the 1x1/2 projection as
// a fourth; its epilogue adds the shortcut, applies relu and requantizes.
//
// What bounds it.  Each 3x3 does 18*c*c int8 operations per output pixel
// against 2*c bytes moved, far above the card's int8 ridge: the bound is the
// int8 tensor-core rate, and these dp4a kernels run far below it.
//
// The TPU layouts the weights keep: the stride-1 3x3s are packed kh-batched,
// (kw, k) rows x (kh, j) columns, and read one kernel row (a column block of
// c) per operand.  The transition's conv1 is packed (3, 4*cin, c): for each
// kernel row u, rows [0, 3*cin) are its (kw, k) taps and [3*cin, 4*cin) zero
// (the TPU pair-slot layout), so the 9-tap operand reads it with wpad = cin
// and needs no repack.  conv1's nine taps share one int32 sum and one joint
// per-channel scale, as on the TPU.

#include "igemm.cuh"

// One stride-1 BasicBlock, chain in and out: x (B*hp*wp, c) int8; w1p, w2p
// (3c, 3c) kh-batched; a1, a2 (3, c) per-(kh, j) multipliers; c1, c2 (c,);
// s_res the identity-residual scale (device scalar).  z1 (B*hp*wp, c) int8
// scratch.  out_kind 0: int8 chain, 1: bf16 chain.  Returns the first
// launch's cudaError_t, or 0.
extern "C" int basic_block_int8(
    const int8_t* x, int B, int h, int w, int hp, int wp, int c,
    const int8_t* w1p, const float* a1, const float* c1,
    const int8_t* w2p, const float* a2, const float* c2, const float* s_res,
    int8_t* z1, int out_kind, void* out, cudaStream_t stream) {
  const Geo g{h, w, hp, wp};
  const int M = B * hp * wp;
  int err;

  // conv1 (3x3/1): relu(kh3 + c1) -> int8, ring zeroed.
  Operand o1[3];
  for (int kh = 0; kh < 3; ++kh) o1[kh] = operand(x, c, g, 1, 3, kh, w1p, 3 * c, kh * c);
  EpiArgs e1{};
  e1.a[0] = a1;
  e1.a[1] = a1 + c;
  e1.a[2] = a1 + 2 * c;
  e1.c = c1;
  e1.out_kind = OUT_I8;
  e1.out = z1;
  if ((err = launch<3, EPI_KH3_Q>(o1, g, M, c, e1, stream))) return err;

  // conv2 (3x3/1) + identity residual x*s_res + relu.
  Operand o2[3];
  for (int kh = 0; kh < 3; ++kh) o2[kh] = operand(z1, c, g, 1, 3, kh, w2p, 3 * c, kh * c);
  EpiArgs e2{};
  e2.a[0] = a2;
  e2.a[1] = a2 + c;
  e2.a[2] = a2 + 2 * c;
  e2.c = c2;
  e2.res = x;
  e2.s_res = s_res;
  e2.out_kind = out_kind;
  e2.out = out;
  return launch<3, EPI_BASIC_OUT>(o2, g, M, c, e2, stream);
}

// A run of n_blocks stride-1 BasicBlocks.  Per-block parameters are
// stacked: w1ps, w2ps (N, 3c, 3c), a1s, a2s (N, 3, c), c1s, c2s (N, c),
// s_res (N,).  Activations between blocks go through act0/act1 (int8
// chains, (B*hp*wp, c)); the last block writes `out` (int8 or bf16).
extern "C" int basic_run_int8(
    const int8_t* x, int n_blocks, int B, int h, int w, int hp, int wp, int c,
    const int8_t* w1ps, const float* a1s, const float* c1s,
    const int8_t* w2ps, const float* a2s, const float* c2s, const float* s_res,
    int8_t* z1, int8_t* act0, int8_t* act1, int last_bf16, void* out,
    cudaStream_t stream) {
  int8_t* act[2] = {act0, act1};
  for (int n = 0; n < n_blocks; ++n) {
    const bool last = n == n_blocks - 1;
    const size_t wo = (size_t)n * 9 * c * c, vo = (size_t)n * 3 * c, bo = (size_t)n * c;
    const int err = basic_block_int8(
        n == 0 ? x : act[(n - 1) % 2], B, h, w, hp, wp, c,
        w1ps + wo, a1s + vo, c1s + bo, w2ps + wo, a2s + vo, c2s + bo, s_res + n,
        z1, last ? (last_bf16 ? OUT_BF16 : OUT_I8) : OUT_I8,
        last ? out : static_cast<void*>(act[n % 2]), stream);
    if (err) return err;
  }
  return 0;
}

// The stride-2 BasicBlock transition: x is the (h, w) input stage's int8
// chain (cin channels), out the (oh, ow) = ((h+1)/2, (w+1)/2) stage's chain
// (c channels; int8, or bf16 when out_kind == 1).  conv1 3x3/2 over x with
// one int32 sum over all nine taps (w1p (3, 4*cin, c), see the header),
// a1 (c,) joint scales; conv2 3x3/1 kh-batched (w2p (3c, 3c), a2 (3, c));
// the shortcut is the 1x1/2 projection of x[2r, 2q] (wd (cin, c), ad, cd).
// z1 (B*hp2*wp2, c) is int8 scratch in the output geometry.
extern "C" int basic_ds_block_s2_int8(
    const int8_t* x, int B, int h, int w, int hp, int wp, int cin, int c,
    int oh, int ow, int hp2, int wp2,
    const int8_t* w1p, const float* a1, const float* c1,
    const int8_t* w2p, const float* a2, const float* c2,
    const int8_t* wd, const float* ad, const float* cd,
    int8_t* z1, int out_kind, void* out, cudaStream_t stream) {
  const Geo gi{h, w, hp, wp};
  const Geo go{oh, ow, hp2, wp2};
  const int M = B * hp2 * wp2;
  int err;

  // conv1 (3x3/2, cin -> c): relu(fma(acc, a1, c1)) -> int8 in the output
  // chain.
  Operand o1 = operand(x, cin, gi, 2, 9, 0, w1p, c, 0, cin);
  EpiArgs e1{};
  e1.a[0] = a1;
  e1.c = c1;
  e1.out_kind = OUT_I8;
  e1.out = z1;
  if ((err = launch<1, EPI_RELU_Q, true>(&o1, go, M, c, e1, stream))) return err;

  // conv2 (3x3/1) + projection shortcut + relu:
  // relu(fma(sc, ad, kh3 + c2) + cd).
  Operand o2[4];
  for (int kh = 0; kh < 3; ++kh) o2[kh] = operand(z1, c, go, 1, 3, kh, w2p, 3 * c, kh * c);
  o2[3] = operand(x, cin, gi, 2, 1, 0, wd, c, 0);
  EpiArgs e2{};
  e2.a[0] = a2;
  e2.a[1] = a2 + c;
  e2.a[2] = a2 + 2 * c;
  e2.c = c2;
  e2.ad = ad;
  e2.cd = cd;
  e2.out_kind = out_kind;
  e2.out = out;
  return launch<4, EPI_BASIC_OUT>(o2, go, M, c, e2, stream);
}
