// The fp32 tensor-core tile of the fused GEMM (gemm.cu: `matmul`,
// resnetc_tpu/ops/pallas/gemm.py:100), the fused convolutions (conv.cu:
// `conv3x3_s1_fused`, resnetc_tpu/ops/pallas/conv.py:150, and
// `conv_s2_fused`, conv.py:287) and the bottleneck block (fp_block.cu:
// `bottleneck_block_chained` / `_fused`, resnetc_tpu/ops/pallas/
// block.py:278 / :3688, three launches) on fp32 operands:
//
//     C[M, N] = A[M, K] @ B[K, N]   (fp32 operands, fp32 sums)
//
// with A filled as the bf16 tile fills it (a row-major matrix, its rows
// optionally picked through the chain layout's pixel <-> row map, or the
// implicit im2col of an NHWC image at stride 1 or 2) and B given as w_nk,
// the TF32 heads and tails of its (N, K) copy, (2, N, K).  Over a chain
// (ChainA32Loader, Epi::ring) a ring row of the output is written as zeros.
//
// What bounds it.  fp32 on the CUDA cores peaks at 67 TFLOP/s on an H100;
// the card's TF32 tensor cores run 495 TFLOP/s but keep 10 bits of each
// operand's mantissa, three decimal digits: the FP32 policy's gates (the
// `pallas` forward within 1e-3 of max |logit| of the fp32 forward) and the
// kernels' own (rtol 1e-5 for the GEMM, 1e-4 for the convolutions, against
// sums in float64) need fp32's.
//
// Design: split fp32 (3xTF32) on the tensor cores.
//   - Each operand value is split as v = hi + lo, hi = tf32(v) and lo =
//     tf32(v - hi), both rounded to nearest (cvt.rna.tf32.f32); v - hi is
//     exact in fp32.  hi + lo holds v to 2^-22 of |v|, and
//     a*b = A_hi*B_hi + A_hi*B_lo + A_lo*B_hi + A_lo*B_lo, of which the last
//     (below 2^-22 of |a*b|) is dropped: three TF32 products per fp32
//     product, a bound of 495 / 3 = 165 TFLOP/s.  An infinite v keeps lo = 0
//     (v - hi is NaN there), so +-Inf and NaN reach the output as the plain
//     version's sums give them.
//   - wgmma.mma_async.m64nNk8.f32.tf32.tf32 (N = 64 or 128), A and B from
//     shared memory.  TF32 wgmma has no transpose bit (the PTX ISA gives it
//     to f16 / bf16 only), so both operands are K-major: A (pixels x K) is,
//     and B comes from the (N, K) copy of the (K, N) weight.  (A from
//     registers, loaded and split there, measured no faster on an H100.)
//     A 128-byte swizzle row holds 32 fp32 values of K: a stage
//     is four k8 steps, the ring geometry of the bf16 and int8 tiles (k16
//     and k32 steps of 32 bytes), and one descriptor form serves both
//     operands.
//   - B comes split: w_nk is (2, N, K), the heads and the tails of the
//     (N, K) weight (gemm.pack_nk, the plain version of this split), which
//     the FP32 engines make once; a call without it makes it per call.
//     Splitting B in the kernel cost every block the split of every weight
//     stage it reads again.  A is split in the kernel: each thread copies
//     its 16-byte chunks of a stage (cp.async, zero-filled past M, N or K
//     or in a convolution's padding), waits for them, and splits the same
//     chunks in shared memory: heads in place, tails in the stage's second
//     half.  No other thread reads them before the barrier that also lets
//     the stage's products start.  A shape off the 16-byte grid (K or Cin
//     not a multiple of 4, an unaligned pointer) runs with VEC off: each
//     chunk gathered value by value.
//   - Per stage and warpgroup, 4 x 3 wgmma (lo*hi, hi*lo, hi*hi at each k8
//     step) into one register sum, then the sum is drained into an fp32
//     total with round-to-nearest adds.  The tensor cores' accumulation
//     truncates; draining every 32 values of K keeps that drift to a span
//     of 32, and the spans are the same K ranges whatever N, the tile or
//     the grid, so the result does not depend on them (split-K, at the fc,
//     starts a slice's total at its first stage: there the split count
//     decides the order of the adds; every call gives the same bits).
//   - Software pipeline over a ring of STG stages (run_f32 picks STG per
//     tile): while the tensor cores run stage i, every thread splits its
//     chunks of stage i + 1, whose copies were issued STG - 1 iterations
//     before; then wgmma.wait_group 0, the drain, one barrier, and stage
//     i's slot is refilled with stage i + STG.  The ring holds only as many
//     stages as a block's K run fills; the epilogue stages the tile
//     through the freed ring (bf16_tile.cuh's Epi and store8, split-K
//     through its workspace and splitk_reduce).
//   - Tile shapes and split-K: bf16_tile.cuh's make_plan_stages over K
//     stages of 128 bytes (32 fp32 values).
//
// Measured (an H100, batch 32, ResNet-152's shapes; utils/fp32_ab.py):
// outputs within 7e-7 of max |plain| of float64 sums; 21-60% of the 165
// TFLOP/s or bytes bound.  Left for later: the split of A in every block,
// and the idle SMs of a 98- or 52-tile grid at ResNet-152's stage 2 and 3
// 3x3s.
//
// Epilogue in the Pallas kernels' order: + bias, + residual, relu (keeping
// NaN), cast.

#pragma once

#include <type_traits>

#include "bf16_tile.cuh"

namespace tf32tile {

using namespace bf16tile;

constexpr int KS = 32;  // fp32 K values per stage: one 128-byte swizzle row

// Dynamic shared memory of a launch with `stages` stages (two copies, heads
// and tails, of BM + BN rows of 128 bytes each): the ring or the epilogue's
// staging tile, whichever is larger, + room to align to 1024.
template <int BM, int BN>
__host__ __device__ constexpr int smem_f32(int stages) {
  return (stages * 2 * (BM + BN) * 128 > BM * stage_ld(BN) * 4 ? stages * 2 * (BM + BN) * 128
                                                                : BM * stage_ld(BN) * 4) +
         1024;
}

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

// D[64 x N] = A[64 x 8] * B[8 x N] + (scale_d ? D : 0), both K-major in
// shared memory.
template <int N>
struct WgmmaTf32;

template <>
struct WgmmaTf32<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db,
                                           int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db,
                                           int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// v rounded to TF32 (10 mantissa bits), to nearest, ties away from zero.
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

__device__ __forceinline__ float4 ld_shared_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void st_shared_f4(uint32_t addr, const float4& v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}

// Four values' TF32 heads and tails: v = hi + lo to 2^-22 of |v|; lo = 0
// where v is infinite or NaN.
__device__ __forceinline__ void split4(const float4& v, float4& hi, float4& lo) {
  const float in[4] = {v.x, v.y, v.z, v.w};
  float h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    h[e] = tf32_rna(in[e]);
    const float d = __fsub_rn(in[e], h[e]);
    l[e] = d == d ? tf32_rna(d) : 0.f;
  }
  hi = make_float4(h[0], h[1], h[2], h[3]);
  lo = make_float4(l[0], l[1], l[2], l[3]);
}

// ---------------------------------------------------------------------------
// Operand loaders.  A block has 2*BM threads; thread t fills chunk t % 8
// (4 K values) of A rows t/8 + i*BM/4, i < 4, and of B rows t/8 + i*BM/4,
// i < 4*BN/BM: the chunks it later splits.
// ---------------------------------------------------------------------------

// A = rows of x (M, K), row stride K.
struct GemmA32 {
  const float* x;
  int M, K;
};

// A = rows of x (row stride K) through `map` (geometry g; bf16_tile.cuh's
// RowMap): the block's conv1 reads a pixel's chain row, its conv3 a chain
// row's pixel.
struct ChainA32 {
  const float* x;
  int M, K;
  int map;
  Chain g;
};

// MAP: the ChainA32 form.  Only its rows can be chain rows, so only its
// epilogue tests Epi::ring (kChain): the GEMM's code is that of a loader
// without maps.
template <int BM, bool VEC, bool MAP>
struct GemmA32LoaderT {
  using Params = std::conditional_t<MAP, ChainA32, GemmA32>;
  static constexpr bool kChain = MAP;
  const float* base;
  const float* row[4];  // nullptr past M and where the map finds no row
  int K, c;

  __device__ GemmA32LoaderT(const Params& p, int m0, int tid) : base(p.x), K(p.K), c(tid & 7) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + tid / 8 + i * (BM / 4);
      if constexpr (MAP) {
        int src = m < p.M ? m : -1;
        if (src >= 0 && p.map == MAP_PIXEL_TO_CHAIN) src = chain_row(p.g, src);
        if (src >= 0 && p.map == MAP_CHAIN_TO_PIXEL) src = pixel_of(p.g, src);
        row[i] = src >= 0 ? p.x + static_cast<size_t>(src) * p.K : nullptr;
      } else {
        row[i] = m < p.M ? p.x + static_cast<size_t>(m) * p.K : nullptr;
      }
    }
  }

  __device__ __forceinline__ void load(uint32_t sa, int kt, int tid) const {
    const int k = kt * KS + 4 * c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t dst = sa + a_off(tid / 8 + i * (BM / 4), c);
      if (VEC) {
        const bool ok = row[i] != nullptr && k < K;
        cp_async16(dst, ok ? row[i] + k : base, ok);
      } else {
        uint32_t v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = __float_as_uint(row[i] && k + j < K ? row[i][k + j] : 0.f);
        st_shared16(dst, v);
      }
    }
  }
};

template <int BM, bool VEC>
using GemmA32Loader = GemmA32LoaderT<BM, VEC, false>;
template <int BM, bool VEC>
using ChainA32Loader = GemmA32LoaderT<BM, VEC, true>;

// A = the implicit im2col of x NHWC (B, H, W, Cin) for a k x k convolution,
// stride S, zero padding k/2 (bf16_tile.cuh's ConvALoader over fp32: a
// 16-byte chunk is 4 channels of one tap).
struct ConvA32 {
  const float* x;
  int B, H, W, Cin, OH, OW, k;
};

template <int BM, bool VEC, int S>
struct ConvA32Loader {
  using Params = ConvA32;
  static constexpr bool kChain = false;
  const float* base;       // x: the source of zero-fill copies
  const float* corner[4];  // the row's tap (0, 0) pixel, which may lie outside the image
  int iy0[4], ix0[4];      // its coordinates; iy0 = H past M, so that no tap is inside
  int H, W, Cin, k, K, c;

  __device__ ConvA32Loader(const ConvA32& p, int m0, int tid)
      : base(p.x), H(p.H), W(p.W), Cin(p.Cin), k(p.k), K(p.k * p.k * p.Cin), c(tid & 7) {
    const int M = p.B * p.OH * p.OW;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + tid / 8 + i * (BM / 4);
      const int b = m / (p.OH * p.OW);
      const int rem = m - b * p.OH * p.OW;
      const int oy = rem / p.OW;
      const int y = oy * S - p.k / 2, x = (rem - oy * p.OW) * S - p.k / 2;
      corner[i] = p.x + (static_cast<long long>(b * p.H + y) * p.W + x) * p.Cin;
      iy0[i] = m < M ? y : p.H;
      ix0[i] = x;
    }
  }

  __device__ __forceinline__ bool inside(int i, int u, int v) const {
    return static_cast<unsigned>(iy0[i] + u) < static_cast<unsigned>(H) &&
           static_cast<unsigned>(ix0[i] + v) < static_cast<unsigned>(W);
  }

  __device__ __forceinline__ void load(uint32_t sa, int kt, int tid) const {
    const int g = kt * KS + 4 * c;
    if (VEC) {
      // Cin % 4 == 0: the chunk is 4 channels of one tap.
      const bool in_k = g < K;
      const int tap = in_k ? g / Cin : 0, ci = g - tap * Cin, u = tap / k, v = tap - u * k;
      const int off = (u * W + v) * Cin + ci;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = in_k && inside(i, u, v);
        cp_async16(sa + a_off(tid / 8 + i * (BM / 4), c), ok ? corner[i] + off : base, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t val[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gj = g + j;
          float f = 0.f;
          if (gj < K) {
            const int tap = gj / Cin, ci = gj - tap * Cin, u = tap / k, v = tap - u * k;
            if (inside(i, u, v)) f = corner[i][(u * W + v) * Cin + ci];
          }
          val[j] = __float_as_uint(f);
        }
        st_shared16(sa + a_off(tid / 8 + i * (BM / 4), c), val);
      }
    }
  }
};

// B = w_nk (2, N, K): the TF32 heads and tails of the (N, K) weight, made
// once (gemm.pack_nk).  BN rows of each from n0, K-major and swizzled as A,
// the heads at sb and the tails at sb_lo.
template <int BM, int BN, bool VEC>
__device__ __forceinline__ void load_b_nk(uint32_t sb, uint32_t sb_lo,
                                          const float* __restrict__ w_nk, int N, int K, int n0,
                                          int kt, int tid) {
  const int c = tid & 7, k = kt * KS + 4 * c;
  const size_t lo = static_cast<size_t>(N) * K;
#pragma unroll
  for (int i = 0; i < 4 * BN / BM; ++i) {
    const int r = tid / 8 + i * (BM / 4), n = n0 + r;
    const uint32_t o = a_off(r, c);
    const float* src = w_nk + static_cast<size_t>(n) * K + k;
    if (VEC) {
      const bool ok = n < N && k < K;
      cp_async16(sb + o, ok ? src : w_nk, ok);
      cp_async16(sb_lo + o, ok ? src + lo : w_nk, ok);
    } else {
      uint32_t v[4], t[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = n < N && k + j < K;
        v[j] = __float_as_uint(ok ? src[j] : 0.f);
        t[j] = __float_as_uint(ok ? src[j + lo] : 0.f);
      }
      st_shared16(sb + o, v);
      st_shared16(sb_lo + o, t);
    }
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// grid (ceil(M / BM), ceil(N / BN), splits); blockIdx.z sums K stages
// [z * kt_per, (z + 1) * kt_per).  Stage layout: A_hi (BM rows) | B_hi (BN
// rows) | A_lo | B_lo, 128 bytes a row.
template <int BM, int BN, int STG, bool VEC, class AL>
__global__ void __launch_bounds__(2 * BM)
tf32x3_kernel(typename AL::Params ap, const float* __restrict__ w_nk, Epi ep, int K,
              int kt_per) {
  extern __shared__ uint8_t smem_raw[];
  constexpr uint32_t A_BYTES = BM * 128, HALF = (BM + BN) * 128, STAGE_BYTES = 2 * HALF;
  uint8_t* const ring_ptr = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t ring = smem_u32(ring_ptr);
  const int tid = threadIdx.x, c = tid & 7;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kt0 = blockIdx.z * kt_per;
  const int nk = min((K + KS - 1) / KS, kt0 + kt_per) - kt0;

  const AL a(ap, m0, tid);
  float acc[BN / 2];    // the stage's products (wgmma)
  float total[BN / 2];  // the drained stages
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = total[i] = 0.f;

  auto fill = [&](int i) {
    const uint32_t st = ring + (i % STG) * STAGE_BYTES;
    a.load(st, kt0 + i, tid);
    load_b_nk<BM, BN, VEC>(st + A_BYTES, st + HALF + A_BYTES, w_nk, ep.N, K, n0, kt0 + i, tid);
  };
  // This thread's A chunks of stage i: the heads in place, the tails in the
  // stage's second half (B comes split).
  auto split = [&](int i) {
    const uint32_t st = ring + (i % STG) * STAGE_BYTES;
    float4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = ld_shared_f4(st + a_off(tid / 8 + j * (BM / 4), c));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t o = a_off(tid / 8 + j * (BM / 4), c);
      float4 hi, lo;
      split4(v[j], hi, lo);
      st_shared_f4(st + o, hi);
      st_shared_f4(st + HALF + o, lo);
    }
  };
  // Prologue: stages 0 .. STG-1 in flight; stage 0 landed and split.
#pragma unroll
  for (int i = 0; i < STG; ++i) {
    if (i < nk) fill(i);
    cp_async_commit();
  }
  cp_async_wait<STG - 1>();
  if (nk > 0) split(0);
  fence_proxy_async();
  __syncthreads();

  const int wg = tid / 128;
  for (int i = 0; i < nk; ++i) {
    const uint32_t st = ring + (i % STG) * STAGE_BYTES;
    const uint32_t a_hi = st + wg * 64 * 128, b_hi = st + A_BYTES;
    const uint32_t a_lo = a_hi + HALF, b_lo = b_hi + HALF;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS / 8; ++ks) {
      const uint32_t o = ks * 32;
      WgmmaTf32<BN>::mma(acc, desc_sw128(a_lo + o, 16, 1024), desc_sw128(b_hi + o, 16, 1024),
                         ks > 0);
      WgmmaTf32<BN>::mma(acc, desc_sw128(a_hi + o, 16, 1024), desc_sw128(b_lo + o, 16, 1024),
                         1);
      WgmmaTf32<BN>::mma(acc, desc_sw128(a_hi + o, 16, 1024), desc_sw128(b_hi + o, 16, 1024),
                         1);
    }
    wgmma_commit();
    // While the tensor cores run stage i, split stage i + 1 (another slot).
    if (i + 1 < nk) {
      cp_async_wait<STG - 2>();  // this thread's copies of stage i + 1 landed
      split(i + 1);
      fence_proxy_async();
    }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) total[j] = __fadd_rn(total[j], acc[j]);
    __syncthreads();  // stage i + 1 split by everyone; every product of stage i retired
    if (i + STG < nk) fill(i + STG);  // into stage i's slot
    cp_async_commit();
  }

  // Stage the tile in shared memory (the ring is free now), then write it
  // row by row, eight columns a thread (bf16_tile.cuh's tile_kernel).
  cp_async_wait<0>();
  __syncthreads();
  float* const tile = reinterpret_cast<float*>(ring_ptr);
  constexpr int LD = stage_ld(BN);
  {
    const int t = tid % 128, q = t / 32, l = t % 32;
    const int r = wg * 64 + 16 * q + l / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(tile + (r + 8 * h) * LD + 8 * j + 2 * (l % 4)) =
            make_float2(total[4 * j + 2 * h], total[4 * j + 2 * h + 1]);
  }
  __syncthreads();
  for (int e = tid; e < BM * (BN / 8); e += 2 * BM) {
    const int r = e / (BN / 8), cc = 8 * (e % (BN / 8));
    const int m = m0 + r, n = n0 + cc;
    if (m >= ep.M || n >= ep.N) continue;
    if (AL::kChain && ep.ring.wp && pixel_of(ep.ring, m) < 0) {
      zero8(ep, m, n);
      continue;
    }
    const float4 lo = *reinterpret_cast<const float4*>(tile + r * LD + cc);
    const float4 hi = *reinterpret_cast<const float4*>(tile + r * LD + cc + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    store8(ep, m, n, v);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The plan of an fp32 product with K values of contraction.
inline Plan make_plan_f32(int M, int N, int K, bool may_split) {
  return make_plan_stages(M, N, (K + KS - 1) / KS, may_split);
}

// static: each library that includes the tile keeps its own `sized` flag
// (see bf16tile::launch_tile).
template <int BM, int BN, int STG, bool VEC, class AL>
static cudaError_t launch_f32(const typename AL::Params& ap, const float* w_nk, const Epi& ep,
                              int K, const Plan& p, cudaStream_t stream) {
  auto kern = tf32x3_kernel<BM, BN, STG, VEC, AL>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_f32<BM, BN>(STG));
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const int smem = smem_f32<BM, BN>(p.kt_per < STG ? p.kt_per : STG);
  const dim3 grid((ep.M + BM - 1) / BM, (ep.N + BN - 1) / BN, p.splits);
  kern<<<grid, 2 * BM, smem, stream>>>(ap, w_nk, ep, K, p.kt_per);
  return cudaGetLastError();
}

template <int BM, int BN, int STG, template <int, bool> class LoaderOf>
cudaError_t launch_f32_shape(const typename LoaderOf<BM, true>::Params& ap, const float* w_nk,
                             const Epi& ep, int K, const Plan& p, bool vec,
                             cudaStream_t stream) {
  return vec ? launch_f32<BM, BN, STG, true, LoaderOf<BM, true>>(ap, w_nk, ep, K, p, stream)
             : launch_f32<BM, BN, STG, false, LoaderOf<BM, false>>(ap, w_nk, ep, K, p, stream);
}

// Launches C = A @ w_nk^T with the epilogue ep under plan p (ep.ws must hold
// p.splits * M * N floats when p.splits > 1); vec: every 16-byte chunk of A
// and w_nk is aligned and lies wholly inside or outside its operand.
template <template <int, bool> class LoaderOf>
cudaError_t run_f32(const typename LoaderOf<64, true>::Params& ap, const float* w_nk, Epi ep,
                    int K, const Plan& p, bool vec, cudaStream_t stream) {
  ep.vec = ep.N % 8 == 0 && aligned16(ep.out) && aligned16(ep.res) && aligned16(ep.ws) &&
           aligned16(ep.bias);
  Epi tile_ep = ep;
  if (p.splits <= 1) tile_ep.ws = nullptr;
  // Ring depths: 128 x 128 holds 3 stages (192 KB, one block an SM); 128 x
  // 64 2 (96 KB: two blocks an SM, one's loads and epilogue under the
  // other's products; on an H100, 14% off the FP32 forward's GEMMs against
  // 4 stages, one block an SM); 64 x 64 4.
  cudaError_t e = cudaErrorInvalidValue;
  if (p.bm == 128 && p.bn == 128)
    e = launch_f32_shape<128, 128, 3, LoaderOf>(ap, w_nk, tile_ep, K, p, vec, stream);
  else if (p.bm == 128 && p.bn == 64)
    e = launch_f32_shape<128, 64, 2, LoaderOf>(ap, w_nk, tile_ep, K, p, vec, stream);
  else if (p.bm == 64 && p.bn == 64)
    e = launch_f32_shape<64, 64, 4, LoaderOf>(ap, w_nk, tile_ep, K, p, vec, stream);
  if (e != cudaSuccess || p.splits <= 1) return e;
  const size_t mn = static_cast<size_t>(ep.M) * ep.N;
  splitk_reduce<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, stream>>>(ep, p.splits);
  return cudaGetLastError();
}

}  // namespace tf32tile
