// The int8 tensor-core convolution tile of the chain-layout block kernels:
// one launch computes up to four int32 sums of int8 products on wgmma
// (s8_tile.cuh: m64nNk32 s32.s8.s8, both operands K-major from a swizzled
// cp.async ring) and folds them into one fp32 epilogue.  Shared by
//   - chain_block.cu: the stride-1 bottleneck block and its run
//     (bottleneck_block_chained_int8, resnetc_tpu/ops/pallas/block.py:718;
//     bottleneck_run_chained_int8, :2908): conv1 1x1, conv2 3x3, conv3 1x1
//     with its shortcut; and the stride-2 transition
//     (downsample_block_s2_int8, :3460): conv1 1x1, conv2 3x3/2 as one
//     nine-tap sum, conv3 1x1 with the 1x1/2 projection;
//   - basic_block.cu: the stride-1 BasicBlock and its run
//     (basic_block_chained_int8, :1646; basic_run_chained_int8, :1830): two
//     3x3s and the identity shortcut; and the stride-2 transition
//     (basic_ds_block_s2_int8, :2542): conv1 3x3/2 as one nine-tap sum,
//     conv2 3x3 with the 1x1/2 projection as a fourth sum;
//   - grouped_block.cu: the ResNeXt bottleneck blocks, whose conv2 is the
//     grouped 3x3 sum below (GRP), stride 1 and stride 2;
//   - pp_block.cu: the pixel-paired bottleneck block and run
//     (bottleneck_block_chained_int8_pp, :1113; bottleneck_run_chained_int8_pp,
//     :1387) and BasicBlock and run (basic_block_chained_int8_pp, :2002;
//     basic_run_chained_int8_pp, :2175), the same convolutions in pair
//     geometry.
//
// A sum's A operand is a row view of a chain buffer (S8Sum): GEMM row m
// reads the K int8 values at a + (row(m) + off) * lda.  A 1x1 reads its own
// row (off 0, lda = K); kernel row kh of a 3x3 reads the three consecutive
// chain rows row(m) + (kh-1)*wp - 1 .. + 1 as one row of K = 3c (off
// (kh-1)*wp - 1, lda = c), which is the (kw, k) order of a kh-batched
// weight's rows.  In pair geometry (the kernel's PAIR flag) a GEMM row is a
// pair row of two W-adjacent pixels (row width 2c: the even pixel, then the
// odd one), and kernel row kh reads pair rows row(m) + (kh-1)*wp/2 - 1 ..
// + 1, K = 3 * 2c in the pair-packed weight's (kwp, half, k) order.  B is
// the (N, K) K-major weight (8-bit wgmma has no transpose bit).
//
// The stride-2 source row (the kernel's S2 mask over the sums).  A stride-2
// sum's GEMM row m is an interior pixel (i, j) of the output geometry g,
// and its A row is read from the input chain (geometry src) at the chain
// row of input pixel (2i, 2j) instead of row(m), in K segments of `seg`
// values, segment q starting `seg_rows` rows further on: the transition's
// conv2 reads z1 with off = -wp - 1, seg = 3c, seg_rows = wp, so segment u
// is the three consecutive chain rows of input pixels (2i+u-1, 2j-1 .. +1),
// the (kh, kw, k) order of its (9c, c) weight, all nine taps in ONE int32
// sum (its per-channel scale is joint over the taps); the projection reads
// x at (2i, 2j) with seg = K.  z1's zero ring is the padding: where the
// input size is odd, the taps of the last output row or column that fall
// past the image are ring rows (with wp = w + 1 the right pad column is the
// next row's left one).  The BasicBlock transition's conv1 reads x itself
// the same way (off = -wp - 1, seg = 3cin, seg_rows = wp), under the mask
// below.
//
// The grouped sum (the kernel's GRP; its launch's only sum, grouped_block.cu).
// A grouped 3x3 of group width gw maps output channel n to the input
// channels of its own group only, so the column tile [n0, n0 + BN), whole
// groups (gw divides BN), reads input channels [n0, n0 + BN) alone: K is
// the nine taps of those BN channels, K index k in tap q = k / BN (kh = q /
// 3, kw = q % 3) at channel n0 + k % BN, read at the chain row base + off +
// kh * seg_rows + kw (base: the pixel's chain row, or with S2 the stride-2
// source row; off = -wp - 1, seg_rows = wp).  B is the tile's (N, 9 BN)
// copy, zero where input and output lie in different groups.  The last K
// stage issues only the k32 products that hold K values (9 BN is no
// multiple of 128), so the tensor cores do BN / gw times the grouped MACs.
//
// Where a 3x3 or a pair-space 1x1 reads a buffer whose ring may hold
// anything (the BasicBlock's conv1 reads x itself: "chain ring garbage must
// not enter a 3x3", block.py:1595; in pair space a dense weight mixes the
// two halves), the kernel's MASK (a mask over the sums) zero-fills every
// 16-byte chunk whose source pixel is not an interior pixel: each thread
// decodes, once, which of its rows' taps (x 2 halves in pair geometry) are
// interior, and a chunk at K index k lies in tap k / lda (and half
// (k % lda) / (lda/2)) because lda, and lda / 2 in pair geometry, are
// multiples of 16 on the vector path; the byte path tests each byte.  A
// masked sum g of a three-sum launch is kernel row g of a 3x3, one of a
// one- or two-sum launch a 1x1 at the row's own pixels, and a masked
// stride-2 sum (the only sum of its launch) the nine taps (u, v) of a 3x3/2,
// tap (u, v) reading input pixel (2i+u-1, 2j+v-1): a chunk at K index k
// lies in tap (k / seg, (k % seg) / lda) because seg and lda are multiples
// of 16 on the vector path.  MASK is a template mask so that the other
// sums and launches load without a test.  A 3x3 over z1 needs no mask: z1's
// ring is zero (a pass after the standard conv1; a select in the conv1
// epilogues over every row, per half of a pair row).
//
// The requant scales are folded into the epilogue, op for op as the wrapper
// of the TPU kernel folds them on the host (block.py:789-797, 822-823,
// 1684-1690, 2631-2641, 3545-3554; ops/cuda/block.py _fold_block,
// _fold_basic, _fold_basic_ds, _fold_ds): sum g's multiplier is sw[g][n] *
// (s[num[g]] / s[den[g]]), the bias b[n] * (1 / s[den[0]]), the projection
// bias bd[n] * (1 / s_y), the residual scale s_x / s_y, where s is the
// device vector [s_x, s_z1, s_z2, s_y] of a bottleneck block or [s_x, s_z1,
// s_y] of a BasicBlock (s_y = 1 for a bf16 or fp32 exit).  No small kernel
// runs per call to fold them.  In pair geometry with `tiled` the raw vectors
// are the standard block's (width N / 2) and channel n of a pair row reads
// entry n mod N / 2, which is the JAX wrappers' lane tiling (jnp.tile) of
// the folded vectors, since the fold is elementwise; the launch keeps each
// column tile within one half, so the mod is one offset a tile (a test per
// column raised the pair kernels' spills from 0-16 to 128-240 bytes and cost
// the pixel-paired BasicBlock 10%).  The pair-space entries take the vectors
// already folded and lane-tiled to pair width: with `folded` every ratio is
// 1 and the residual scale is scales[0], so the epilogue's products
// reproduce the folded values exactly.
//
// The declarations are in an unnamed namespace: each library that includes
// this header has its own kernels and its own launch_chain_tile statics (a
// static of an inline template shared by two libraries would be one GNU
// unique object, and the second library's kernel would launch without its
// shared-memory attribute).

#pragma once

#include "s8_tile.cuh"

namespace {

using s8tile::Chain;

enum OutKind { OUT_I8 = 0, OUT_BF16 = 1, OUT_F32 = 2 };

// The int8 exit of every epilogue: round half to even, clip to +-127.
__device__ __forceinline__ int8_t requant(float v) {
  v = rintf(v);
  v = fminf(fmaxf(v, -127.f), 127.f);
  return static_cast<int8_t>(v);
}

// One int32 sum of a launch: row m of A is the K int8 values at
// a + (row(m) + off) * lda, zero where that lies outside [0, limit) (a
// chain's first or last rows) or past K; B is the (N, K) K-major weight w.
// A stride-2 sum (the kernel's S2) reads K index k at a + (src(m) + off +
// (k / seg) * seg_rows) * lda + k % seg.
struct S8Sum {
  const int8_t* a;
  const int8_t* w;
  long long limit;
  int lda, off, K;
  int seg, seg_rows;
};

// TE_RELU_Q (1x1, or a 3x3 as one sum): relu(fma(P, a0, c)) -> int8.
// TE_KH3_Q (3x3): relu(fma(P2, a2, fma(P0, a0, P1*a1)) + c) -> int8.  TE_OUT
// (bottleneck conv3): y = fma(P, a0, c), then the shortcut: fma(x, s_res,
// y), or y + fma(Pd, a1, cd); relu; int8, bf16 or fp32.  TE_KH3_OUT
// (BasicBlock conv2): y = fma(P2, a2, fma(P0, a0, P1*a1)) + c, then fma(x,
// s_res, y); relu; int8 or bf16.  TE_KH3_PROJ (the BasicBlock transition's
// conv2, four sums): y = fma(P2, a2, fma(P0, a0, P1*a1)) + c, then the
// projection fma(Pd, a3, y) + cd; relu; int8 or bf16.
enum TileEpi { TE_RELU_Q = 0, TE_KH3_Q = 1, TE_OUT = 2, TE_KH3_OUT = 3, TE_KH3_PROJ = 4 };

__host__ __device__ constexpr bool is_kh3(int epi) {
  return epi == TE_KH3_Q || epi == TE_KH3_OUT || epi == TE_KH3_PROJ;
}

struct TileArgs {
  S8Sum sum[4];
  const float* sw[4];   // per-channel weight scales of the sums (folded: multipliers)
  int num[4], den[4];   // indices into the scales of each sum's ratio
  const float* b;       // per-channel bias (of the first sum)
  const float* bd;      // projection bias (TE_OUT with two sums, TE_KH3_PROJ)
  const float* scales;  // the device scales, s_y at index iy (folded: the residual scale)
  int iy;               // 3: [s_x, s_z1, s_z2, s_y]; 2: [s_x, s_z1, s_y]
  int unit_y;           // s_y taken as 1
  int folded;           // sw and b are the folded multipliers and biases
  int tiled;            // PAIR: the vectors have N / 2 entries, read at n mod N / 2
  const int8_t* res;    // identity residual (GEMM rows, ld N), or nullptr
  void* out;            // GEMM rows, ld N
  int out_kind;         // OUT_I8, OUT_BF16, OUT_F32
  int M, N;
  int pixels;           // 1: row m is interior pixel m, at its chain row; 0: GEMM row m
  Chain g;              // the pixel geometry
  Chain src;            // the input geometry of the stride-2 sums
};

__device__ __forceinline__ int out_row(const TileArgs& p, int m) {
  return p.pixels ? s8tile::chain_row(p.g, m) : m;
}

// Interior pixel m = (b, i, j) of the output geometry -> the chain row of
// input pixel (2i, 2j) in the source geometry.
__device__ __forceinline__ int s2_row(const TileArgs& p, int m) {
  const int hw = p.g.h * p.g.w;
  const int b = m / hw, rem = m - b * hw, i = rem / p.g.w, j = rem - i * p.g.w;
  return (b * p.src.hp + 2 * i + 1) * p.src.wp + 2 * j + 1;
}

// The per-launch scalars of the epilogue, from the device scales.
struct Ratios {
  float sum[4];  // sum g's multiplier is sw[g][n] * sum[g]
  float bias;    // 1 / s[den[0]]
  float proj;    // 1 / s_y (the projection bias)
  float res;     // s_x / s_y (the identity residual)
};

__device__ __forceinline__ Ratios ratios(const TileArgs& p, int ng) {
  Ratios r;
  if (p.folded) {
#pragma unroll
    for (int g = 0; g < 4; ++g) r.sum[g] = 1.f;
    r.bias = r.proj = 1.f;
    r.res = p.scales[0];
    return r;
  }
  float s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = i <= p.iy ? p.scales[i] : 1.f;
  if (p.unit_y) s[p.iy] = 1.f;
#pragma unroll
  for (int g = 0; g < 4; ++g) r.sum[g] = g < ng ? __fdiv_rn(s[p.num[g]], s[p.den[g]]) : 0.f;
  r.bias = __fdiv_rn(1.f, s[p.den[0]]);
  r.proj = __fdiv_rn(1.f, s[p.iy]);
  r.res = __fdiv_rn(s[0], s[p.iy]);
  return r;
}

// Folds the finished sum G (acc) into the running fp32 values h, in the
// Pallas kernel's order of operations as XLA evaluates it (every a*b + c one
// fma); the last sum leaves the output before the shortcut and relu.
// Column n reads entry n - hoff of the vectors (hoff: see chain_tile), the
// offset taken off the vectors' base pointers once, a uniform value.
template <int BN, int EPI, int G>
__device__ __forceinline__ void fold(const TileArgs& p, const Ratios& r, const int (&acc)[BN / 2],
                                     float (&h)[BN / 2], int n0, int hoff, int lane) {
  const float* const sw = p.sw[G] - hoff;
  const float* const sw0 = p.sw[0] - hoff;
  const float* const b = p.b - hoff;
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) {
    const int n = n0 + 8 * (j / 4) + 2 * (lane % 4) + (j % 2);
    const bool in = n < p.N;
    const float f = __int2float_rn(acc[j]);
    const float a = in ? __fmul_rn(sw[n], r.sum[G]) : 0.f;
    if (EPI == TE_KH3_PROJ && G == 3) {
      h[j] = __fadd_rn(__fmaf_rn(f, a, h[j]), in ? __fmul_rn(p.bd[n - hoff], r.proj) : 0.f);
    } else if (is_kh3(EPI)) {
      if (G == 0) {
        h[j] = f;
      } else if (G == 1) {
        const float a0 = in ? __fmul_rn(sw0[n], r.sum[0]) : 0.f;
        h[j] = __fmaf_rn(h[j], a0, __fmul_rn(f, a));
      } else {
        h[j] = __fadd_rn(__fmaf_rn(f, a, h[j]), in ? __fmul_rn(b[n], r.bias) : 0.f);
      }
    } else if (G == 0) {
      h[j] = __fmaf_rn(f, a, in ? __fmul_rn(b[n], r.bias) : 0.f);
    } else {
      h[j] = __fadd_rn(h[j], __fmaf_rn(f, a, in ? __fmul_rn(p.bd[n - hoff], r.proj) : 0.f));
    }
  }
}

// Eight outputs of GEMM row t, columns n..n+7, from their fp32 values y:
// the shortcut, relu, zeros where the pixel is on the ring (bit 0 of `in`:
// the row's pixel, or the even pixel of a pair row, whose columns are
// [0, N/2); bit 1: the odd one), the cast.
template <int EPI, bool PAIR>
__device__ __forceinline__ void finish8(const TileArgs& p, const Ratios& ratio, int t, int in,
                                        int n, float (&y)[8], bool vec) {
  const size_t o = static_cast<size_t>(t) * p.N + n;
  const int cnt = vec ? 8 : min(8, p.N - n);
  if ((EPI == TE_OUT || EPI == TE_KH3_OUT) && p.res) {
    const float s = ratio.res;
    uint2 raw = make_uint2(0, 0);
    if (vec) {
      raw = *reinterpret_cast<const uint2*>(p.res + o);
    } else {
      for (int e = 0; e < cnt; ++e) {
        const uint32_t b = static_cast<uint8_t>(p.res[o + e]);
        (e < 4 ? raw.x : raw.y) |= b << (8 * (e % 4));
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int8_t r = static_cast<int8_t>(((e < 4 ? raw.x : raw.y) >> (8 * (e % 4))) & 0xFF);
      y[e] = __fmaf_rn(static_cast<float>(r), s, y[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int half = PAIR && 2 * (n + e) >= p.N;
    y[e] = (in >> half) & 1 ? fmaxf(y[e], 0.f) : 0.f;
  }
  if (p.out_kind == OUT_I8) {
    uint2 pk = make_uint2(0, 0);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t b = static_cast<uint8_t>(requant(y[e]));
      (e < 4 ? pk.x : pk.y) |= b << (8 * (e % 4));
    }
    int8_t* out = static_cast<int8_t*>(p.out) + o;
    if (vec)
      *reinterpret_cast<uint2*>(out) = pk;
    else
      for (int e = 0; e < cnt; ++e)
        out[e] = static_cast<int8_t>(((e < 4 ? pk.x : pk.y) >> (8 * (e % 4))) & 0xFF);
  } else if (p.out_kind == OUT_BF16) {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + o;
    if (vec) {
      uint4 pk;
      __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&pk);
#pragma unroll
      for (int e = 0; e < 4; ++e) p2[e] = __floats2bfloat162_rn(y[2 * e], y[2 * e + 1]);
      *reinterpret_cast<uint4*>(out) = pk;
    } else {
      for (int e = 0; e < cnt; ++e) out[e] = __float2bfloat16_rn(y[e]);
    }
  } else {
    float* out = static_cast<float*>(p.out) + o;
    if (vec)
      s8tile::store_f32x8(out, y);
    else
      for (int e = 0; e < cnt; ++e) out[e] = y[e];
  }
}

// Whether pixel t of the chain is an interior pixel, as a bit.
__device__ __forceinline__ uint32_t interior(const Chain& g, long long t) {
  return s8tile::pixel_of(g, static_cast<int>(t)) >= 0;
}

// grid (ceil(M / BM), ceil(N / BN)).  The NG sums run as one stream of K
// stages through bf16tile::tile_kernel's pipeline (copies STAGES - 2 stages
// ahead, one wgmma group in flight, a stage refilled only after every
// warpgroup has waited for its products); where a sum ends, its int32
// tile is folded into the fp32 values h (fold) and the next sum starts from
// zero, so one int32 tile and one fp32 tile are live (the 3x3's
// fma(P0, a0, P1*a1) is formed as soon as P1 is done).  The A loads of the
// sums in MASK skip source pixels off the image, those in S2 read at the
// stride-2 source row, and with PAIR the GEMM rows are pair rows (see the
// header).  With GRP the one sum is the grouped 3x3 (see the header).  MASK,
// S2, PAIR and GRP are template parameters so that a kernel without them
// carries no test of theirs.
template <int BM, int BN, bool VEC, int NG, int EPI, int MASK, bool PAIR, int S2,
          bool GRP = false>
__device__ __forceinline__ void chain_tile(const TileArgs& p) {
  using namespace s8tile;
  static_assert(!(MASK & S2) || NG == 1, "a masked stride-2 sum is its launch's only sum");
  static_assert(EPI != TE_KH3_PROJ || NG == 4,
                "TE_KH3_PROJ folds three kernel rows and a projection");
  static_assert(!GRP || (NG == 1 && MASK == 0 && !PAIR), "the grouped sum is alone and unmasked");
  extern __shared__ uint8_t smem_raw[];
  __shared__ int row_t[BM];       // the tile row's GEMM row in the output
  __shared__ int row_in[BM];      // ... and which of its pixels are interior (finish8)
  constexpr uint32_t A_BYTES = BM * 128, STAGE_BYTES = (BM + BN) * 128;
  uint8_t* const ring_ptr = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t ring = smem_u32(ring_ptr);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  constexpr int span = PAIR ? 2 : 1;  // pixels per GEMM row

  if (tid < BM) {
    const int m = m0 + tid;
    const int t = m < p.M ? out_row(p, m) : -1;
    row_t[tid] = t;
    int in = 0;
    if (t >= 0 && p.pixels)
      in = 3;
    else if (t >= 0 && PAIR)
      in = static_cast<int>(interior(p.g, 2ll * t) | interior(p.g, 2ll * t + 1) << 1);
    else if (t >= 0)
      in = interior(p.g, t) ? 3 : 0;
    row_in[tid] = in;
  }

  // This thread's four A rows (t / 8 + i * BM / 4): their GEMM rows (and
  // with S2 their stride-2 source rows), and with MASK which source pixels
  // of each are interior: bit (3g + tap) * 2 + half.  A masked sum g of a
  // three-sum launch is kernel row kh = g of a 3x3, so the source pixel of
  // (g, tap, half) lies g - 1 padded rows and span * (tap - 1) + half
  // columns from the row's first pixel (py, px); a masked sum of a one- or
  // two-sum launch is a 1x1, one tap at the row's own pixels.  The column
  // wraps into the neighbouring padded row as the flat index does.  A
  // masked stride-2 sum has nine taps (u, v), bits (3u + v) * 2: input
  // pixel (2i+u-1, 2j+v-1) lies u - 1 rows and v - 1 columns from the
  // source row's padded (py, px) = (2i+1, 2j+1), inside the image's padded
  // rows and columns, so no wrap.
  // Where a row's pixels are all ring its output is zero whatever it reads,
  // and for every other row the source row stays within one padded row of
  // the image, so the test against (h, w) is the flat decode's.
  const int c = tid & 7;
  long long arow[4];
  int srow[4];
  uint32_t amask[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tid / 8 + i * (BM / 4);
    arow[i] = m < p.M ? out_row(p, m) : -(1ll << 40);
    srow[i] = S2 && m < p.M ? s2_row(p, m) : -(1 << 30);
    amask[i] = 0;
    if constexpr ((MASK & S2) != 0) {
      if (m < p.M) {
        const int rem = srow[i] % (p.src.hp * p.src.wp);
        const int py = rem / p.src.wp, px = rem - py * p.src.wp;
#pragma unroll
        for (int u = 0; u < 3; ++u)
#pragma unroll
          for (int v = 0; v < 3; ++v) {
            const int row = py + u - 1, col = px + v - 1;
            if (row >= 1 && row <= p.src.h && col >= 1 && col <= p.src.w)
              amask[i] |= 1u << ((3 * u + v) * 2);
          }
      }
    } else if (MASK && m < p.M) {
      const int rem = static_cast<int>(arow[i] * span % (p.g.hp * p.g.wp));
      const int py = rem / p.g.wp, px = rem - py * p.g.wp;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        if (!((MASK >> g) & 1)) continue;
        constexpr int taps = NG == 3 ? 3 : 1;
        const int dy = taps == 3 ? g - 1 : 0;
#pragma unroll
        for (int tap = 0; tap < 3; ++tap)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            int row = py + dy, col = px + span * (tap - taps / 2) + half;
            if (col < 0)
              col += p.g.wp, --row;
            else if (col >= p.g.wp)
              col -= p.g.wp, ++row;
            const bool in = row >= 1 && row <= p.g.h && col >= 1 && col <= p.g.w;
            if (tap < taps && half < span && in) amask[i] |= 1u << ((3 * g + tap) * 2 + half);
          }
      }
    }
  }
  int nk[NG], total = 0;
#pragma unroll
  for (int g = 0; g < NG; ++g) total += nk[g] = (p.sum[g].K + BK8 - 1) / BK8;

  // The mask bit of K index k of sum g.
  auto bit_of = [&](int g, int k) {
    const S8Sum& s = p.sum[g];
    if ((S2 >> g) & 1) {  // the masked stride-2 sum: tap (u, v)
      const int u = k / s.seg;
      return (3 * u + (k - u * s.seg) / s.lda) * 2;
    }
    const int tap = k / s.lda;
    const int half = PAIR && 2 * (k - tap * s.lda) >= s.lda;
    return (3 * g + tap) * 2 + half;
  };
  // The flat index into sum g's buffer of K index k of this thread's row i.
  auto src_index = [&](int g, int i, int k) -> long long {
    const S8Sum& s = p.sum[g];
    if constexpr (GRP) {  // tap q = (kh, kw) of channel n0 + k % BN
      const int q = k / BN, kh = q / 3;
      const long long base = S2 ? static_cast<long long>(srow[i]) : arow[i];
      return (base + s.off + static_cast<long long>(kh) * s.seg_rows + (q - 3 * kh)) * s.lda +
             n0 + (k - q * BN);
    }
    if ((S2 >> g) & 1) {
      const int q = k / s.seg;
      return (static_cast<long long>(srow[i]) + s.off + static_cast<long long>(q) * s.seg_rows) *
                 s.lda + (k - q * s.seg);
    }
    return (arow[i] + s.off) * s.lda + k;
  };
  auto load_a = [&](int g, uint32_t st, int kt) {
    const S8Sum& s = p.sum[g];
    const bool masked = (MASK >> g) & 1;
    const int k = kt * BK8 + 16 * c;
    const int bit = masked && VEC && k < s.K ? bit_of(g, k) : 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t dst = st + a_off(tid / 8 + i * (BM / 4), c);
      if (VEC) {
        const long long f = src_index(g, i, k);
        const bool ok = k < s.K && f >= 0 && f < s.limit && (!masked || (amask[i] >> bit) & 1);
        cp_async16(dst, ok ? s.a + f : s.a, ok);
      } else {
        uint32_t v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t word = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = k + 4 * j + e;
            if (kk >= s.K) continue;
            const long long f = src_index(g, i, kk);
            if (f >= 0 && f < s.limit && (!masked || (amask[i] >> bit_of(g, kk)) & 1))
              word |= static_cast<uint32_t>(static_cast<uint8_t>(s.a[f])) << (8 * e);
          }
          v[j] = word;
        }
        st_shared16(dst, v);
      }
    }
  };
  auto fill = [&](int i) {
    const uint32_t st = ring + (i % STAGES) * STAGE_BYTES;
    int q = i;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (q >= 0 && q < nk[g]) {
        load_a(g, st, q);
        load_rows<BN, BM, VEC>(st + A_BYTES, p.sum[g].w, p.N, p.sum[g].K, n0, q, tid);
      }
      q -= nk[g];
    }
  };
#pragma unroll
  for (int i = 0; i < STAGES - 2; ++i) {
    if (i < total) fill(i);
    cp_async_commit();
  }

  const int wg = tid / 128, lane = tid % 32;
  int acc[BN / 2];
  float h[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0, h[j] = 0.f;
  // Stages [i, end) of one sum, its wgmma sum started from zero.  Each sum
  // has a loop of its own and is folded after it: a fold inside the loop
  // made ptxas serialize the wgmmas (C7515), and the ring's copies run on
  // across the boundary all the same.
  int i = 0, end = 0;
  auto run_sum = [&](int g) {
    const int first = end;
    end += nk[g];
    int scale = 0;
    for (; i < end; ++i) {
      cp_async_wait<STAGES - 3>();  // this thread's copies of stage i landed
      fence_proxy_async();
      __syncthreads();  // everyone's landed; every wgmma of stage i - 2 retired
      if (i + STAGES - 2 < total) fill(i + STAGES - 2);
      cp_async_commit();
      const uint32_t sa = ring + (i % STAGES) * STAGE_BYTES + wg * 64 * 128;
      const uint32_t sb = ring + (i % STAGES) * STAGE_BYTES + A_BYTES;
      // The K values this stage holds (GRP: the last stage of 9 BN is short).
      const int kleft = GRP ? p.sum[g].K - (i - first) * BK8 : BK8;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK8 / 32; ++ks) {
        if (!GRP || ks * 32 < kleft) {
          WgmmaS8<BN>::mma(acc, desc_sw128(sa + ks * 32, 16, 1024),
                           desc_sw128(sb + ks * 32, 16, 1024), scale);
          scale = 1;
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    fence_iregs(acc);
  };
  const Ratios r = ratios(p, NG);
  // With `tiled` the column tile lies within one half of the pair row
  // (run_tile sees to it), so column n reads entry n - N/2 in the odd half.
  const int hoff = PAIR && p.tiled && 2 * n0 >= p.N ? p.N / 2 : 0;
  run_sum(0);
  fold<BN, EPI, 0>(p, r, acc, h, n0, hoff, lane);
  if constexpr (NG > 1) {
    run_sum(1);
    fold<BN, EPI, 1>(p, r, acc, h, n0, hoff, lane);
  }
  if constexpr (NG > 2) {
    run_sum(2);
    fold<BN, EPI, 2>(p, r, acc, h, n0, hoff, lane);
  }
  if constexpr (NG > 3) {
    run_sum(3);
    fold<BN, EPI, 3>(p, r, acc, h, n0, hoff, lane);
  }

  // Stage the fp32 tile in shared memory (the ring is free now), then
  // finish it row by row, eight columns a thread.  Accumulator layout of
  // m64nBN: thread (warp q, lane l) of the warpgroup holds rows 16q + l/4
  // (+8) and columns 8j + 2(l % 4) (+1).
  cp_async_wait<0>();
  __syncthreads();
  float* const tile = reinterpret_cast<float*>(ring_ptr);
  constexpr int LD = stage_ld(BN);
  {
    const int t = tid % 128, q = t / 32;
    const int r = wg * 64 + 16 * q + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(tile + (r + 8 * hh) * LD + 8 * j + 2 * (lane % 4)) =
            make_float2(h[4 * j + 2 * hh], h[4 * j + 2 * hh + 1]);
  }
  __syncthreads();
  const bool vec = p.N % 8 == 0;
  for (int e = tid; e < BM * (BN / 8); e += 2 * BM) {
    const int rr = e / (BN / 8), cc = 8 * (e % (BN / 8));
    const int n = n0 + cc;
    if (row_t[rr] < 0 || n >= p.N) continue;
    const float4 lo = *reinterpret_cast<const float4*>(tile + rr * LD + cc);
    const float4 hi = *reinterpret_cast<const float4*>(tile + rr * LD + cc + 4);
    float y[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    finish8<EPI, PAIR>(p, r, row_t[rr], row_in[rr], n, y, vec && n + 8 <= p.N);
  }
}

template <int BM, int BN, bool VEC, int NG, int EPI, int MASK, bool PAIR, int S2>
__global__ void __launch_bounds__(2 * BM) chain_tile_kernel(TileArgs p) {
  chain_tile<BM, BN, VEC, NG, EPI, MASK, PAIR, S2>(p);
}

// The same, two blocks an SM: the 128 x 64 tiles of two to four sums (the
// 3x3s, the projection conv3, the BasicBlock transition's conv2) need
// 130-140 registers a thread unbounded, which leaves one 256-thread block an
// SM and nothing to overlap its copies and epilogue with; capped at 128 (a
// few bytes spilled) two blocks share the SM.  Measured on an H100 at batch
// 32 (NVIDIA H100 80GB HBM3, 700 W; PERF.md, section 6): rows 7-10 15-25%
// faster, row 1's stage-0 projection block 0.2050 against 0.2628 ms.  The
// one-sum launches keep their 74-80 registers unbounded (any minimum raised
// them to 128, and row 1 at 14x14 lost 5%).
template <int BM, int BN, bool VEC, int NG, int EPI, int MASK, bool PAIR, int S2>
__global__ void __launch_bounds__(2 * BM, 2) chain_tile_kernel_2sm(TileArgs p) {
  chain_tile<BM, BN, VEC, NG, EPI, MASK, PAIR, S2>(p);
}

// Zeros on the ring rows of a chain of B images (rows of row_bytes bytes),
// after a launch that wrote the interior pixels only.
// Ring row q of an image: the wp rows of the top pad row, then wp - w for
// each interior row (its left pad column, then its right ones), then the
// wp rows of the bottom pad row.  One 16-byte store a thread (one byte
// where a row is not whole 16-byte chunks).
__global__ void zero_ring_kernel(uint8_t* out, Chain g, int B, int row_bytes) {
  const int side = g.wp - g.w, per = 2 * g.wp + g.h * side;
  const bool vec = row_bytes % 16 == 0;
  const int chunks = vec ? row_bytes / 16 : row_bytes;
  const long long total = static_cast<long long>(B) * per * chunks;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(i % chunks);
    const long long q = i / chunks;
    const int b = static_cast<int>(q / per), r = static_cast<int>(q % per);
    int t;  // chain row within the image
    if (r < g.wp)
      t = r;
    else if (r < g.wp + g.h * side) {
      const int o = (r - g.wp) % side;
      t = (1 + (r - g.wp) / side) * g.wp + (o ? g.w + o : 0);
    }
    else
      t = (g.hp - 1) * g.wp + (r - g.wp - g.h * side);
    uint8_t* row = out + (static_cast<size_t>(b) * g.hp * g.wp + t) * row_bytes;
    if (vec)
      reinterpret_cast<uint4*>(row)[k] = make_uint4(0, 0, 0, 0);
    else
      row[k] = 0;
  }
}

template <int BM, int BN, int NG, int EPI, int MASK, bool PAIR, int S2>
cudaError_t launch_chain_tile(const TileArgs& p, int stages, bool vec, cudaStream_t stream) {
  using namespace s8tile;
  void (*kern)(TileArgs);
  if constexpr (NG > 1 && BM == 128 && BN == 64)
    kern = vec ? chain_tile_kernel_2sm<BM, BN, true, NG, EPI, MASK, PAIR, S2>
               : chain_tile_kernel_2sm<BM, BN, false, NG, EPI, MASK, PAIR, S2>;
  else
    kern = vec ? chain_tile_kernel<BM, BN, true, NG, EPI, MASK, PAIR, S2>
               : chain_tile_kernel<BM, BN, false, NG, EPI, MASK, PAIR, S2>;
  static bool sized[2] = {false, false};
  if (!sized[vec]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<BM, BN>(STAGES));
    if (e != cudaSuccess) return e;
    sized[vec] = true;
  }
  const int smem = smem_bytes<BM, BN>(stages < STAGES ? stages : STAGES);
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN);
  kern<<<grid, 2 * BM, smem, stream>>>(p);
  return cudaGetLastError();
}

// One launch of NG sums (make_plan_stages picks the tile from the total
// number of K stages; with `tiled` no wider than half the pair row).  MASK
// and S2 are masks over the sums (bit g: sum g).
// The vector path needs every 16-byte chunk of A and w aligned and inside
// one row, with MASK inside one tap (lda % 16) and one half of a pair row
// ((lda / 2) % 16), with S2 inside one segment (seg % 16).
template <int NG, int EPI, int MASK = 0, bool PAIR = false, int S2 = 0>
int run_tile(TileArgs p, cudaStream_t stream) {
  using namespace s8tile;
  int stages = 0;
  bool vec = true;
  for (int g = 0; g < NG; ++g) {
    const S8Sum& s = p.sum[g];
    stages += (s.K + BK8 - 1) / BK8;
    vec = vec && s.K % 16 == 0 && s.lda % 16 == 0 && aligned16(s.a) && aligned16(s.w) &&
          (!((MASK >> g) & 1) || !PAIR || (s.lda / 2) % 16 == 0) &&
          (!((S2 >> g) & 1) || s.seg % 16 == 0);
  }
  Plan pl = make_plan_stages(p.M, p.N, stages, /*may_split=*/false);
  if (PAIR && p.tiled) {  // each column tile within one half of the pair row
    if ((p.N / 2) % 64) return static_cast<int>(cudaErrorInvalidValue);
    if ((p.N / 2) % pl.bn) pl.bn = 64;
  }
  cudaError_t e = cudaErrorInvalidValue;
  if (pl.bm == 128 && pl.bn == 128)
    e = launch_chain_tile<128, 128, NG, EPI, MASK, PAIR, S2>(p, stages, vec, stream);
  else if (pl.bm == 128 && pl.bn == 64)
    e = launch_chain_tile<128, 64, NG, EPI, MASK, PAIR, S2>(p, stages, vec, stream);
  else
    e = launch_chain_tile<64, 64, NG, EPI, MASK, PAIR, S2>(p, stages, vec, stream);
  return static_cast<int>(e);
}

}  // namespace
