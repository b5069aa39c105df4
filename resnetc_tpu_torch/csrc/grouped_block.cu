// Int8 ResNeXt bottleneck blocks over the chained padded-row layout: the
// bottleneck of chain_block.cu with conv2 a grouped 3x3 (G groups of gw =
// W / G channels), W = C wide (ResNeXt-101 32x8d: W = C = 256, 512, 1024,
// 2048 by stage, gw = 8, 16, 32, 64).  No JAX kernel exists for it; the
// plain versions beside the wrappers (ops/cuda/block.py, grouped section)
// are the specification.
//
//   - grouped_block_int8: one stride-1 block (identity, or the 1x1
//     projection of stage 0's first block, 64 -> 256 -> 256);
//   - grouped_ds_block_s2_int8: the stride-2 transition (the first block
//     of stages 1-3), 3x3/2 grouped, 1x1/2 projection.
//
// Each is three launches of the int8 tile of chain_tile.cuh and a ring
// pass, z1 and z2 through device scratch, as chain_block.cu's blocks:
//   conv1: 1x1 cin -> W over every chain row, relu, requant, ring rows zero
//          (conv2's padding), exactly row 1's conv1;
//   conv2: the grouped 3x3 as ONE int32 sum over the nine taps (the tile's
//          GRP: per-output-channel weight scale joint over the taps and the
//          group's input channels, as the stride-2 transition of row 3
//          has it), over the output's interior pixels; stride 1 reads z1 at
//          the pixel's chain row, stride 2 at the source row of input pixel
//          (2i, 2j); relu(fma(P, a2, c2)) -> int8;
//   conv3: 1x1 W -> C plus the identity residual or the projection (a second
//          sum over x, at (2i, 2j) for stride 2), relu; int8 or bf16; then
//          the output's ring rows are zeroed.
// The requant scales fold in the epilogues as row 1's and row 3's do
// (chain_tile.cuh), from the device [s_x, s_z1, s_z2, s_y].
//
// conv2's tensor-core work.  Column tile n0 of BN output channels holds
// BN / gw whole groups and reads only their BN input channels (chain_tile.cuh,
// the grouped sum): K = 9 BN, the weight the tile's (W, 9 BN) K-major copy
// (fused.pack_chain_kmajor: block.pack_grouped_nk), zero where input and
// output lie in different groups; no dense W x W weight is built.  BN =
// max(32, gw) (block.grouped_tile_n), and the last K stage issues only the
// k32 products that hold K values, so the tensor cores do BN / gw times the
// grouped MACs (9 W gw a pixel): 4x at stage 0 (gw 8, BN 32), 2x at stage 1
// (gw 16, BN 32), 1x at stages 2 and 3 (gw 32 and 64, BN 32 and 64).  A
// dense W x W expansion would be G = 32x at every stage.
//
// What bounds it.  2 (cin W + 9 W gw + W C [+ cin C]) int8 operations a
// pixel against cin + C bytes: the 1x1s dominate (conv2 is ~12% of the
// real operations), far above the card's int8 ridge, so the bound is the
// tensor-core rate.  The outputs equal the plain versions bit for bit: the
// int32 sums are exact and each epilogue keeps the plain version's order of
// operations (__fmaf_rn, __fmul_rn, rintf).

#include "chain_tile.cuh"

namespace {

enum { S_X = 0, S_Z1 = 1, S_Z2 = 2, S_Y = 3 };

template <int BM, int BN, bool VEC, int S2>
__global__ void __launch_bounds__(2 * BM) grouped_tile_kernel(TileArgs p) {
  chain_tile<BM, BN, VEC, 1, TE_RELU_Q, 0, false, S2, true>(p);
}

template <int BM, int BN, int S2>
cudaError_t launch_grouped_tile(const TileArgs& p, bool vec, cudaStream_t stream) {
  using namespace s8tile;
  void (*kern)(TileArgs) = vec ? grouped_tile_kernel<BM, BN, true, S2>
                               : grouped_tile_kernel<BM, BN, false, S2>;
  static bool sized[2] = {false, false};
  if (!sized[vec]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<BM, BN>(STAGES));
    if (e != cudaSuccess) return e;
    sized[vec] = true;
  }
  const int stages = (p.sum[0].K + BK8 - 1) / BK8;
  const int smem = smem_bytes<BM, BN>(stages < STAGES ? stages : STAGES);
  const dim3 grid((p.M + BM - 1) / BM, p.N / BN);
  kern<<<grid, 2 * BM, smem, stream>>>(p);
  return cudaGetLastError();
}

// The grouped 3x3 (stride 1 + S2) of a block: z1 -> z2 over the output's
// interior pixels, column tiles of bn = K / 9 channels.  128-row tiles where
// they give two thirds of a wave or more, else 64.
template <int S2>
int run_grouped(const TileArgs& p, cudaStream_t stream) {
  using namespace s8tile;
  const S8Sum& s = p.sum[0];
  const int bn = s.K / 9;
  if (s.K != 9 * bn || (bn != 32 && bn != 64) || p.N % bn)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = s.lda % 16 == 0 && aligned16(s.a) && aligned16(s.w);
  const bool tall = 3 * ((p.M + 127) / 128) * (p.N / bn) >= 2 * sm_count();
  cudaError_t e;
  if (bn == 32)
    e = tall ? launch_grouped_tile<128, 32, S2>(p, vec, stream)
             : launch_grouped_tile<64, 32, S2>(p, vec, stream);
  else
    e = tall ? launch_grouped_tile<128, 64, S2>(p, vec, stream)
             : launch_grouped_tile<64, 64, S2>(p, vec, stream);
  return static_cast<int>(e);
}

// conv1 (1x1, cin -> W) over every chain row of x: relu(fma(P, a1, c1)) ->
// int8, ring rows zero (conv2 reads them as its padding).
int conv1(const int8_t* x, long long rows, int cin, int c, const int8_t* w1_nk,
          const float* sw1, const float* b1, const float* scales, const Chain& g, int8_t* z1,
          cudaStream_t stream) {
  TileArgs t{};
  t.sum[0] = S8Sum{x, w1_nk, rows * cin, cin, 0, cin};
  t.sw[0] = sw1, t.num[0] = S_X, t.den[0] = S_Z1;
  t.b = b1;
  t.scales = scales;
  t.iy = S_Y;
  t.out = z1;
  t.out_kind = OUT_I8;
  t.M = static_cast<int>(rows);
  t.N = c;
  t.g = g;
  return run_tile<1, TE_RELU_Q>(t, stream);
}

// conv2, the grouped 3x3: relu(fma(P, a2, c2)) -> int8 z2 at the output's
// interior pixels (geometry go; with S2 reading z1 in geometry gi).
template <int S2>
int conv2(const int8_t* z1, long long z1_rows, int c, const int8_t* w2g_nk, int k2,
          const float* sw2, const float* b2, const float* scales, const Chain& gi,
          const Chain& go, int pixels, int8_t* z2, cudaStream_t stream) {
  TileArgs t{};
  t.sum[0] = S8Sum{z1, w2g_nk, z1_rows * c, c, -gi.wp - 1, k2, k2 / 9, gi.wp};
  t.sw[0] = sw2, t.num[0] = S_Z1, t.den[0] = S_Z2;
  t.b = b2;
  t.scales = scales;
  t.iy = S_Y;
  t.out = z2;
  t.out_kind = OUT_I8;
  t.M = pixels;
  t.N = c;
  t.pixels = 1;
  t.g = go;
  t.src = gi;
  return run_grouped<S2>(t, stream);
}

}  // namespace

// One stride-1 grouped bottleneck block, chain in and out.  The weights are
// the K-major copies: w1_nk (c, cin), w2g_nk (c, 9 bn) (block.pack_grouped_nk:
// row n holds the nine taps of the bn input channels of its column tile),
// w3_nk (c4, c), wd_nk (c4, cin); sw1, b1, sw2, b2 (c), sw3, b3, swd, bd
// (c4) fp32 raw; scales the device [s_x, s_z1, s_z2, s_y], s_y taken as 1
// when unit_y.  wd_nk == NULL: identity shortcut (cin == c4).  out_kind 0:
// int8 chain, 1: bf16 chain.  z1, z2 int8 scratch (B*hp*wp, c).  Returns the
// first failed launch's cudaError_t, or 0.
extern "C" int grouped_block_int8(
    const int8_t* x, int B, int h, int w, int hp, int wp, int cin, int c, int c4,
    const int8_t* w1_nk, const float* sw1, const float* b1,
    const int8_t* w2g_nk, int k2, const float* sw2, const float* b2,
    const int8_t* w3_nk, const float* sw3, const float* b3,
    const float* scales, int unit_y, const int8_t* wd_nk, const float* swd, const float* bd,
    int8_t* z1, int8_t* z2, int out_kind, void* out, cudaStream_t stream) {
  const Chain ch{h, w, hp, wp};
  const long long rows = static_cast<long long>(B) * hp * wp;
  const int pixels = B * h * w;
  int err;
  if ((err = conv1(x, rows, cin, c, w1_nk, sw1, b1, scales, ch, z1, stream))) return err;
  if ((err = conv2<0>(z1, rows, c, w2g_nk, k2, sw2, b2, scales, ch, ch, pixels, z2, stream)))
    return err;

  // conv3 (1x1, c -> c4) + shortcut + relu over the interior pixels.
  TileArgs t3{};
  t3.sum[0] = S8Sum{z2, w3_nk, rows * c, c, 0, c};
  t3.sw[0] = sw3, t3.num[0] = S_Z2, t3.den[0] = S_Y;
  t3.b = b3;
  t3.scales = scales;
  t3.iy = S_Y;
  t3.unit_y = unit_y;
  t3.out_kind = out_kind;
  t3.out = out;
  t3.M = pixels;
  t3.N = c4;
  t3.pixels = 1;
  t3.g = ch;
  if (wd_nk) {
    t3.sum[1] = S8Sum{x, wd_nk, rows * cin, cin, 0, cin};
    t3.sw[1] = swd, t3.num[1] = S_X, t3.den[1] = S_Y;
    t3.bd = bd;
    if ((err = run_tile<2, TE_OUT>(t3, stream))) return err;
  } else {
    t3.res = x;
    if ((err = run_tile<1, TE_OUT>(t3, stream))) return err;
  }
  zero_ring_kernel<<<264, 256, 0, stream>>>(static_cast<uint8_t*>(out), ch, B,
                                            c4 * (out_kind == OUT_BF16 ? 2 : 1));
  return static_cast<int>(cudaGetLastError());
}

// The stride-2 grouped transition: x the (h, w) stage's int8 chain, out the
// (oh, ow) = ((h+1)/2, (w+1)/2) stage's chain (int8, or bf16 when out_kind
// == 1).  Weights and vectors as grouped_block_int8's, the projection
// always present.  z1 (B*hp*wp, c) and z2 (B*hp2*wp2, c) int8 scratch.
extern "C" int grouped_ds_block_s2_int8(
    const int8_t* x, int B, int h, int w, int hp, int wp, int cin, int c, int c4,
    int oh, int ow, int hp2, int wp2,
    const int8_t* w1_nk, const float* sw1, const float* b1,
    const int8_t* w2g_nk, int k2, const float* sw2, const float* b2,
    const int8_t* w3_nk, const float* sw3, const float* b3,
    const int8_t* wd_nk, const float* swd, const float* bd,
    const float* scales, int unit_y, int8_t* z1, int8_t* z2, int out_kind, void* out,
    cudaStream_t stream) {
  const Chain gi{h, w, hp, wp}, go{oh, ow, hp2, wp2};
  const long long rows = static_cast<long long>(B) * hp * wp;
  const int pixels = B * oh * ow;
  int err;
  if ((err = conv1(x, rows, cin, c, w1_nk, sw1, b1, scales, gi, z1, stream))) return err;
  if ((err = conv2<1>(z1, rows, c, w2g_nk, k2, sw2, b2, scales, gi, go, pixels, z2, stream)))
    return err;

  // conv3 (1x1, c -> c4) + the 1x1/2 projection of x at input pixel (2i,
  // 2j) + relu over the output's interior pixels; then its ring rows zero.
  TileArgs t3{};
  t3.sum[0] = S8Sum{z2, w3_nk, static_cast<long long>(B) * hp2 * wp2 * c, c, 0, c};
  t3.sw[0] = sw3, t3.num[0] = S_Z2, t3.den[0] = S_Y;
  t3.sum[1] = S8Sum{x, wd_nk, rows * cin, cin, 0, cin, cin, 0};
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
