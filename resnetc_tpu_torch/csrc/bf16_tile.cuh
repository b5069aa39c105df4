// The bf16 tensor-core GEMM tile shared by the fused convolutions
// (conv.cu: `conv3x3_s1_fused`, resnetc_tpu/ops/pallas/conv.py:150, and
// `conv_s2_fused`, conv.py:287), the fused GEMM (gemm.cu: `matmul`,
// resnetc_tpu/ops/pallas/gemm.py:100) and the bf16 bottleneck block
// (fp_block.cu: `bottleneck_block_chained`, resnetc_tpu/ops/pallas/
// block.py:278, and `bottleneck_block_fused`, block.py:3688):
//
//     C[M, N] = A[M, K] @ B[K, N]   (bf16 operands, fp32 sums in registers)
//
// with one of two ways to fill A (a row-major matrix, its rows optionally
// picked through the chain layout's pixel <-> row map, or the implicit
// im2col of an NHWC image at stride 1 or 2) and B always a row-major (K, N) weight
// read as it lies in memory: the HWIO conv weight viewed as (k*k*Cin,
// Cout), or the GEMM's (K, N).  Nothing repacks a weight per call.  The
// int8 GEMM (int8_gemm.cu) builds its own tile from the PTX, the swizzle
// and the plan of this file.
//
// Design (Hopper, sm_90a).
//   - A block computes a BM x BN output tile (BM 64 or 128, BN 64 or 128)
//     with BM / 64 warpgroups; warpgroup g owns rows 64g..64g+63 and the
//     whole BN width, its sums in registers (BN / 2 fp32 a thread).
//   - K advances 64 values (128 bytes of bf16) a stage through a ring of
//     STAGES stages in dynamic shared memory, filled by 16-byte cp.async
//     issued by every thread.  A `src-size` of 0 zero-fills a chunk that
//     lies in a convolution's padding or past M, N or K, so no bounds test
//     guards the products and no padded copy of an input is ever written.
//   - Both operands sit in the 128-byte swizzled layout that wgmma reads:
//     A K-major (row m at m*128 bytes, 16-byte chunk c at c ^ (m % 8)); B
//     MN-major, in slabs of 64 output channels (k-row r of a slab at r*128,
//     chunk c at c ^ (r % 8)), which is the weight's own N-contiguous order,
//     so wgmma reads it with its transpose bit set.
//   - Each stage is four `wgmma.mma_async.m64nBNk16` per warpgroup, B and A
//     from shared memory.  One wgmma group stays in flight while the next
//     stage's copies are issued; a stage is refilled only two iterations
//     after its products were issued, once every warpgroup has waited for
//     them (wgmma.wait_group 1, then the loop's __syncthreads).
//   - A shape off the 16-byte grid (a K or N that is not a multiple of 8, a
//     Cin that is not, an unaligned pointer) runs the same kernel with the
//     VEC flag off: each chunk is gathered value by value and stored to
//     shared memory, still summed on the tensor cores.
//   - The im2col loader keeps each row's tap-(0, 0) pixel and its (y, x)
//     and tests every tap against the image's H and W: any odd k works
//     (the stride-2 kernel takes k = 3, 5, 7, 9, ...; a per-row mask of
//     k*k bits would cap k at 7).  A 16-byte chunk is 8 channels of one
//     tap at one pixel at either stride, so neither the coalescing nor the
//     swizzle depends on the stride.
//   - The convolutions fold each tap's wgmma sum into an fp32 total with
//     round-to-nearest adds (tile_kernel, kTaps): the tensor cores'
//     accumulation truncates, and over all of K its drift moved enough bf16
//     roundings to fail the tiny engines' kernels-vs-plain checks; summed
//     per tap, in the plain version's order, they pass.
//   - Split-K (the GEMM only): where the output tiles alone cannot fill the
//     card (the fc head, M = batch), blockIdx.z takes a run of K stages and
//     writes its raw fp32 sums to a workspace; `splitk_reduce` adds the
//     slices in slice order and runs the epilogue.  No atomics: the result
//     is the same on every call.
//   - The ring holds only as many stages as a block's K run fills, and the
//     epilogue stages the tile through the freed ring as fp32, then writes
//     it row by row, 16 bytes a thread, reading the residual the same way:
//     a 1x1 with few K stages is bound by its output, and two blocks an SM
//     (128 x 64 tiles) overlap one block's stores with the other's loads.
//     make_plan picks the tile from K and the block count.
//
// What bounds it: the bf16 tensor-core rate at ResNet's 3x3 shapes
// (hundreds of flops per byte); HBM at the 1x1s with few K stages (their
// output and residual) and at the fc (its weight).  What is left for later:
// TMA for the operands, a producer warp with mbarriers, persistent blocks,
// 256-wide N tiles.
//
// Epilogue, in the Pallas kernels' order: + bias (fp32), + residual (bf16
// or fp32, read in its own type), relu (keeping NaN, relu.cuh), cast to bf16
// or fp32.  __fadd_rn keeps nvcc from contracting the adds.  Over a chain
// (Epi::ring) a ring row is written as zeros by a select: its residual is
// never read, so a NaN there reaches nothing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "relu.cuh"

namespace bf16tile {

constexpr int BK = 64;      // K values per stage: one 128-byte swizzle row
constexpr int STAGES = 4;   // ring depth; copies run STAGES - 2 stages ahead

enum Kind { KIND_NONE = 0, KIND_BF16 = 1, KIND_F32 = 2 };

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (and nothing read from src, which
// only has to be a valid address) when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v[0]), "r"(v[1]),
               "r"(v[2]), "r"(v[3])
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's shared-memory writes visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Orders the accumulators after a wgmma wait (no instruction is emitted).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.  lbo: bytes between
// 64-wide MN atoms (MN-major B); sbo: bytes between groups of 8 rows.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// D[64 x N] = A[64 x 16] (K-major) * B[16 x N] (MN-major: transpose bit)
// + (scale_d ? D : 0).
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db,
                                           int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
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
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db,
                                           int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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

// ---------------------------------------------------------------------------
// Operand loaders.  A block has 2*BM threads; thread t fills A chunk t % 8
// (8 K values) of rows t/8 + i*BM/4, i < 4, and 4*BN/BM chunks of B.
// ---------------------------------------------------------------------------

// Byte offset of A's chunk c of row r in a stage (K-major, swizzled).
__device__ __forceinline__ uint32_t a_off(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// The chained padded-row layout (fp_block.cu): pixel (b, y, x) of a (B, h,
// w) interior lies at row (b*hp + y + 1)*wp + x + 1; the other rows are its
// ring.
struct Chain {
  int h, w, hp, wp;
};

// Pixel p of the interior -> its chain row.
__device__ __forceinline__ int chain_row(const Chain& g, int p) {
  const int hw = g.h * g.w;
  const int b = p / hw, rem = p - b * hw, y = rem / g.w;
  return (b * g.hp + y + 1) * g.wp + (rem - y * g.w) + 1;
}

// Chain row t -> its interior pixel, or -1 on the ring.
__device__ __forceinline__ int pixel_of(const Chain& g, int t) {
  const int per = g.hp * g.wp;
  const int b = t / per, rem = t - b * per, r = rem / g.wp, col = rem - r * g.wp;
  if (r < 1 || r > g.h || col < 1 || col > g.w) return -1;
  return (b * g.h + r - 1) * g.w + col - 1;
}

// Which row of x a row of A reads.
enum RowMap {
  MAP_NONE = 0,            // row m
  MAP_PIXEL_TO_CHAIN = 1,  // m is a pixel, x a chain: its chain row
  MAP_CHAIN_TO_PIXEL = 2,  // m is a chain row, x pixel rows: its pixel, zeros on the ring
};

// A = rows of x (row stride K) through `map` (geometry g).
struct GemmA {
  const bf16* x;
  int M, K;
  int map;
  Chain g;
};

template <int BM, bool VEC>
struct GemmALoader {
  using Params = GemmA;
  static constexpr bool kTaps = false;  // one sum over K
  const bf16* base;
  const bf16* row[4];  // nullptr past M and where the map finds no row
  int K, c;

  __device__ GemmALoader(const GemmA& p, int m0, int tid) : base(p.x), K(p.K), c(tid & 7) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + tid / 8 + i * (BM / 4);
      int src = m < p.M ? m : -1;
      if (src >= 0 && p.map == MAP_PIXEL_TO_CHAIN) src = chain_row(p.g, src);
      if (src >= 0 && p.map == MAP_CHAIN_TO_PIXEL) src = pixel_of(p.g, src);
      row[i] = src >= 0 ? p.x + static_cast<size_t>(src) * p.K : nullptr;
    }
  }

  __device__ __forceinline__ void load(uint32_t sa, int kt, int tid) const {
    const int k = kt * BK + 8 * c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t dst = sa + a_off(tid / 8 + i * (BM / 4), c);
      if (VEC) {
        const bool ok = row[i] != nullptr && k < K;
        cp_async16(dst, ok ? row[i] + k : base, ok);
      } else {
        uint32_t v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bf16 z = __ushort_as_bfloat16(0);
          const bf16 lo = row[i] && k + 2 * j < K ? row[i][k + 2 * j] : z;
          const bf16 hi = row[i] && k + 2 * j + 1 < K ? row[i][k + 2 * j + 1] : z;
          v[j] = pack2(lo, hi);
        }
        st_shared16(dst, v);
      }
    }
  }
};

// A = the implicit im2col of x NHWC (B, H, W, Cin) for a k x k convolution,
// stride S, zero padding k/2: row m = output pixel (b, oy, ox), column
// (u, v, ci) = x[b, oy*S + u - k/2, ox*S + v - k/2, ci] (the HWIO weight's
// row order), zero outside the image.
struct ConvA {
  const bf16* x;
  int B, H, W, Cin, OH, OW, k;
};

template <int BM, bool VEC, int S>
struct ConvALoader {
  using Params = ConvA;
  static constexpr bool kTaps = true;  // K runs over taps of Cin values
  const bf16* base;       // x: the source of zero-fill copies
  const bf16* corner[4];  // the row's tap (0, 0) pixel, which may lie outside the image
  int iy0[4], ix0[4];     // its coordinates; iy0 = H past M, so that no tap is inside
  int H, W, Cin, k, K, c;

  __device__ ConvALoader(const ConvA& p, int m0, int tid)
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

  // Tap (u, v) of row i lies in the image.  Tested against the row's
  // corner, so any odd k works (no per-row mask of k*k bits).
  __device__ __forceinline__ bool inside(int i, int u, int v) const {
    return static_cast<unsigned>(iy0[i] + u) < static_cast<unsigned>(H) &&
           static_cast<unsigned>(ix0[i] + v) < static_cast<unsigned>(W);
  }

  // x offset of K index g from row i's corner; false where g is a tap in
  // the padding or past K.
  __device__ __forceinline__ bool locate(int i, int g, int& off) const {
    if (g >= K) return false;
    const int tap = g / Cin, ci = g - tap * Cin, u = tap / k, v = tap - u * k;
    off = (u * W + v) * Cin + ci;
    return inside(i, u, v);
  }

  __device__ __forceinline__ void load(uint32_t sa, int kt, int tid) const {
    const int g = kt * BK + 8 * c;
    if (VEC) {
      // Cin % 8 == 0: the chunk is 8 channels of one tap, at one offset
      // from every row's corner.
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
        uint32_t v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int o0 = 0, o1 = 0;
          const bf16 z = __ushort_as_bfloat16(0);
          const bf16 lo = locate(i, g + 2 * j, o0) ? corner[i][o0] : z;
          const bf16 hi = locate(i, g + 2 * j + 1, o1) ? corner[i][o1] : z;
          v[j] = pack2(lo, hi);
        }
        st_shared16(sa + a_off(tid / 8 + i * (BM / 4), c), v);
      }
    }
  }
};

// B = w (K, N) row-major, N contiguous.  Stage layout: BN / 64 slabs of 64
// k-rows x 128 bytes; chunk c16 of k-row r goes to slab c16 / 8, chunk
// (c16 % 8) ^ (r % 8).  Neighbouring threads copy neighbouring chunks of a
// row (coalesced).
template <int BM, int BN, bool VEC>
__device__ __forceinline__ void load_b(uint32_t sb, const bf16* __restrict__ w, int K, int N,
                                       int n0, int kt, int tid) {
  constexpr int PER_ROW = BN / 8;
#pragma unroll
  for (int i = 0; i < 4 * BN / BM; ++i) {
    const int e = tid + i * 2 * BM;
    const int r = e / PER_ROW, c16 = e % PER_ROW;
    const int gk = kt * BK + r, gn = n0 + 8 * c16;
    const uint32_t dst = sb + (c16 / 8) * (BK * 128) + r * 128 + (((c16 & 7) ^ (r & 7)) << 4);
    const bf16* src = w + static_cast<size_t>(gk) * N + gn;
    if (VEC) {
      const bool ok = gk < K && gn < N;
      cp_async16(dst, ok ? src : w, ok);
    } else {
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16 z = __ushort_as_bfloat16(0);
        const bf16 lo = gk < K && gn + 2 * j < N ? src[2 * j] : z;
        const bf16 hi = gk < K && gn + 2 * j + 1 < N ? src[2 * j + 1] : z;
        v[j] = pack2(lo, hi);
      }
      st_shared16(dst, v);
    }
  }
}

// ---------------------------------------------------------------------------
// Epilogue
// ---------------------------------------------------------------------------

struct Epi {
  const float* bias;  // (N,) or nullptr
  const void* res;    // (M, N) of res_kind, or nullptr
  void* out;          // (M, N), bf16 if out_bf16 else fp32
  float* ws;          // split-K partial sums (splits, M, N), or nullptr
  int M, N, res_kind, out_bf16, relu;
  int vec;            // N % 8 == 0 and every operand 16-byte aligned (set by run)
  Chain ring;         // ring.wp > 0: rows are chain rows, and a ring row is
                      // written as zeros (its residual never read)
};

__device__ __forceinline__ float finish(const Epi& ep, float v, int n, size_t o) {
  if (ep.bias) v = __fadd_rn(v, ep.bias[n]);
  if (ep.res_kind == KIND_BF16)
    v = __fadd_rn(v, __bfloat162float(static_cast<const bf16*>(ep.res)[o]));
  else if (ep.res_kind == KIND_F32)
    v = __fadd_rn(v, static_cast<const float*>(ep.res)[o]);
  return ep.relu ? relu_keep_nan(v) : v;
}

__device__ __forceinline__ void put(const Epi& ep, size_t o, float v) {
  if (ep.out_bf16)
    static_cast<bf16*>(ep.out)[o] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(ep.out)[o] = v;
}

__device__ __forceinline__ void store_f32x8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Eight outputs (m, n..n+7) from raw sums v: to the split-K workspace slice
// blockIdx.z, or through the epilogue to out.  16-byte accesses when ep.vec
// and the run lies inside N; one value at a time at a ragged edge.
__device__ __forceinline__ void store8(const Epi& ep, int m, int n, float (&v)[8]) {
  const size_t o = static_cast<size_t>(m) * ep.N + n;
  float* const ws = ep.ws ? ep.ws + static_cast<size_t>(blockIdx.z) * ep.M * ep.N : nullptr;
  if (!ep.vec || n + 8 > ep.N) {
    for (int e = 0; e < 8 && n + e < ep.N; ++e) {
      if (ws)
        ws[o + e] = v[e];
      else
        put(ep, o + e, finish(ep, v[e], n + e, o + e));
    }
    return;
  }
  if (ws) {
    store_f32x8(ws + o, v);
    return;
  }
  if (ep.bias) {
    const float4 b0 = reinterpret_cast<const float4*>(ep.bias + n)[0];
    const float4 b1 = reinterpret_cast<const float4*>(ep.bias + n)[1];
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(v[e], b[e]);
  }
  if (ep.res_kind == KIND_BF16) {
    const uint4 r = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(ep.res) + o);
    const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(r2[e]);
      v[2 * e] = __fadd_rn(v[2 * e], f.x);
      v[2 * e + 1] = __fadd_rn(v[2 * e + 1], f.y);
    }
  } else if (ep.res_kind == KIND_F32) {
    const float4* r = reinterpret_cast<const float4*>(static_cast<const float*>(ep.res) + o);
    const float4 r0 = r[0], r1 = r[1];
    const float rr[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(v[e], rr[e]);
  }
  if (ep.relu) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = relu_keep_nan(v[e]);
  }
  if (!ep.out_bf16) {
    store_f32x8(static_cast<float*>(ep.out) + o, v);
    return;
  }
  uint4 pk;
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&pk);
#pragma unroll
  for (int e = 0; e < 4; ++e) p2[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  *reinterpret_cast<uint4*>(static_cast<bf16*>(ep.out) + o) = pk;
}

// Eight zeros at (m, n..n+7): a ring row of a chain output.
__device__ __forceinline__ void zero8(const Epi& ep, int m, int n) {
  const size_t o = static_cast<size_t>(m) * ep.N + n;
  if (!ep.vec || n + 8 > ep.N) {
    for (int e = 0; e < 8 && n + e < ep.N; ++e) put(ep, o + e, 0.f);
  } else if (ep.out_bf16) {
    *reinterpret_cast<uint4*>(static_cast<bf16*>(ep.out) + o) = make_uint4(0, 0, 0, 0);
  } else {
    const float z[8] = {};
    store_f32x8(static_cast<float*>(ep.out) + o, z);
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// fp32 row of the epilogue's staging tile: 8 spare words spread the rows
// that one fragment store touches over the banks.
__host__ __device__ constexpr int stage_ld(int bn) { return bn + 8; }

// Dynamic shared memory of a launch: the ring (only as many stages as a
// block's K run fills) or the staging tile, whichever is larger, + room to
// align the ring to 1024 bytes.
template <int BM, int BN>
__host__ __device__ constexpr int smem_bytes(int stages) {
  return (stages * (BM + BN) * 128 > BM * stage_ld(BN) * 4 ? stages * (BM + BN) * 128
                                                             : BM * stage_ld(BN) * 4) +
         1024;
}

// grid (ceil(M / BM), ceil(N / BN), splits); blockIdx.z sums K stages
// [z * kt_per, (z + 1) * kt_per).  With AL::kTaps (the convolutions, tap =
// Cin), the wgmma sum restarts at every multiple of tap in K and each
// finished tap is added to the total with fp32 round-to-nearest, in K
// order: the sum over taps of per-tap dots, as the plain version and XLA's
// per-tap dots form it, so the tensor cores' own accumulation (which
// truncates) spans one tap.
template <int BM, int BN, bool VEC, class AL>
__global__ void __launch_bounds__(2 * BM)
tile_kernel(typename AL::Params ap, const bf16* __restrict__ w, Epi ep, int K, int kt_per,
            int tap) {
  extern __shared__ uint8_t smem_raw[];
  constexpr uint32_t A_BYTES = BM * 128, STAGE_BYTES = (BM + BN) * 128;
  uint8_t* const ring_ptr = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t ring = smem_u32(ring_ptr);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kt0 = blockIdx.z * kt_per;
  const int nk = min((K + BK - 1) / BK, kt0 + kt_per) - kt0;

  const AL a(ap, m0, tid);
  float acc[BN / 2];    // the running tap (wgmma)
  float total[BN / 2];  // the finished taps
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = total[i] = 0.f;

  auto fill = [&](int i) {
    const uint32_t st = ring + (i % STAGES) * STAGE_BYTES;
    a.load(st, kt0 + i, tid);
    load_b<BM, BN, VEC>(st + A_BYTES, w, K, ep.N, n0, kt0 + i, tid);
  };
#pragma unroll
  for (int i = 0; i < STAGES - 2; ++i) {
    if (i < nk) fill(i);
    cp_async_commit();
  }

  const int wg = tid / 128;
  // K index where the running tap ends (K: one sum over the block's K run)
  int next_tap = tap > 0 ? (kt0 * BK / tap + 1) * tap : K;
  int scale = 0;                     // 0: the next wgmma starts a new sum
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<STAGES - 3>();  // this thread's copies of stage i landed
    fence_proxy_async();
    __syncthreads();  // everyone's landed; every wgmma of stage i - 2 retired
    if (i + STAGES - 2 < nk) fill(i + STAGES - 2);
    cp_async_commit();

    const uint32_t sa = ring + (i % STAGES) * STAGE_BYTES + wg * 64 * 128;
    const uint32_t sb = ring + (i % STAGES) * STAGE_BYTES + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const int g = (kt0 + i) * BK + 16 * ks;
      if (AL::kTaps && g >= next_tap) {  // the running tap ended: fold it in
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) total[j] = __fadd_rn(total[j], acc[j]);
        next_tap = (g / tap + 1) * tap;
        scale = 0;
        wgmma_fence();
      }
      Wgmma<BN>::mma(acc, desc_sw128(sa + ks * 32, 16, 1024),
                     desc_sw128(sb + ks * 16 * 128, BK * 128, 1024), scale);
      scale = 1;
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) total[j] = AL::kTaps ? __fadd_rn(total[j], acc[j]) : acc[j];

  // Stage the tile in shared memory (fp32; the ring is free now), then
  // write it row by row, eight columns a thread.  Accumulator layout of
  // m64nBN: thread (warp q, lane l) of the warpgroup holds rows 16q + l/4
  // (+8) and columns 8j + 2(l % 4) (+1).
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
    const int r = e / (BN / 8), c = 8 * (e % (BN / 8));
    const int m = m0 + r, n = n0 + c;
    if (m >= ep.M || n >= ep.N) continue;
    if (ep.ring.wp && pixel_of(ep.ring, m) < 0) {
      zero8(ep, m, n);
      continue;
    }
    const float4 lo = *reinterpret_cast<const float4*>(tile + r * LD + c);
    const float4 hi = *reinterpret_cast<const float4*>(tile + r * LD + c + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    store8(ep, m, n, v);
  }
}

// Sums the split-K slices in slice order, then the epilogue.
__global__ void splitk_reduce(Epi ep, int splits) {
  const size_t mn = static_cast<size_t>(ep.M) * ep.N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float v = ep.ws[i];
  for (int s = 1; s < splits; ++s) v = __fadd_rn(v, ep.ws[s * mn + i]);
  put(ep, i, finish(ep, v, static_cast<int>(i % ep.N), i));
}

// ---------------------------------------------------------------------------
// Host side: tile shape and split count, launch
// ---------------------------------------------------------------------------

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

struct Plan {
  int bm, bn, splits, kt_per;
};

// Tile shape by the number of K stages kt (128 bytes of K each): with 16
// or more a block is bound by its products and 128 x 128 tiles (one block
// an SM) win; with fewer, by its loads and stores, and 128 x 64 tiles (two
// an SM) win.  The first shape of the list that still gives two thirds of
// the SMs a block; else 64 x 64, and, if allowed, K split so that the
// blocks cover the SMs.  (Measured on an H100 over ResNet's conv and 1x1
// shapes at batch 32.)  The int8 tile (int8_gemm.cu) plans with it too.
inline Plan make_plan_stages(int M, int N, int kt, bool may_split) {
  const int sms = sm_count();
  auto blocks = [&](int bm, int bn) { return ((M + bm - 1) / bm) * ((N + bn - 1) / bn); };
  Plan p{64, 64, 1, kt};
  if (kt >= 16 && N > 64 && 3 * blocks(128, 128) >= 2 * sms)
    p = {128, 128, 1, kt};
  else if (3 * blocks(128, 64) >= 2 * sms)
    p = {128, 64, 1, kt};
  const int nb = blocks(p.bm, p.bn);
  if (may_split && 2 * nb < sms && kt > 1) {
    const int want = (sms + nb - 1) / nb;
    p.kt_per = (kt + want - 1) / want;
    p.splits = (kt + p.kt_per - 1) / p.kt_per;
  }
  return p;
}

// The plan of a bf16 product with K values of contraction.
inline Plan make_plan(int M, int N, int K, bool may_split) {
  return make_plan_stages(M, N, (K + BK - 1) / BK, may_split);
}

// static: each library that includes the tile keeps its own `sized` flag.
// As the static of an inline function template it would be one object
// across every loaded library (a GNU unique symbol), and the kernel of the
// second library to launch a shape would run without its shared-memory
// attribute set.
template <int BM, int BN, bool VEC, class AL>
static cudaError_t launch_tile(const typename AL::Params& ap, const bf16* w, const Epi& ep,
                               int K, const Plan& p, int tap, cudaStream_t stream) {
  auto kern = tile_kernel<BM, BN, VEC, AL>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<BM, BN>(STAGES));
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const int smem = smem_bytes<BM, BN>(p.kt_per < STAGES ? p.kt_per : STAGES);
  const dim3 grid((ep.M + BM - 1) / BM, (ep.N + BN - 1) / BN, p.splits);
  kern<<<grid, 2 * BM, smem, stream>>>(ap, w, ep, K, p.kt_per, tap);
  return cudaGetLastError();
}

template <int BM, int BN, template <int, bool> class LoaderOf>
cudaError_t launch_shape(const typename LoaderOf<BM, true>::Params& ap, const bf16* w,
                         const Epi& ep, int K, const Plan& p, bool vec, int tap,
                         cudaStream_t stream) {
  return vec ? launch_tile<BM, BN, true, LoaderOf<BM, true>>(ap, w, ep, K, p, tap, stream)
             : launch_tile<BM, BN, false, LoaderOf<BM, false>>(ap, w, ep, K, p, tap, stream);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Launches C = A @ w with the epilogue ep under plan p (ep.ws must hold
// p.splits * M * N floats when p.splits > 1).  LoaderOf<BM, VEC> is the A
// loader of each tile height; vec: every 16-byte chunk of A and w is
// aligned and lies wholly inside or outside its operand; tap: see
// tile_kernel (read only where the loader has kTaps).
template <template <int, bool> class LoaderOf>
cudaError_t run(const typename LoaderOf<64, true>::Params& ap, const bf16* w, Epi ep, int K,
                const Plan& p, bool vec, int tap, cudaStream_t stream) {
  ep.vec = ep.N % 8 == 0 && aligned16(ep.out) && aligned16(ep.res) && aligned16(ep.ws) &&
           aligned16(ep.bias);
  Epi tile_ep = ep;
  if (p.splits <= 1) tile_ep.ws = nullptr;
  cudaError_t e = cudaErrorInvalidValue;
  if (p.bm == 128 && p.bn == 128)
    e = launch_shape<128, 128, LoaderOf>(ap, w, tile_ep, K, p, vec, tap, stream);
  else if (p.bm == 128 && p.bn == 64)
    e = launch_shape<128, 64, LoaderOf>(ap, w, tile_ep, K, p, vec, tap, stream);
  else if (p.bm == 64 && p.bn == 64)
    e = launch_shape<64, 64, LoaderOf>(ap, w, tile_ep, K, p, vec, tap, stream);
  if (e != cudaSuccess || p.splits <= 1) return e;
  const size_t mn = static_cast<size_t>(ep.M) * ep.N;
  splitk_reduce<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, stream>>>(ep, p.splits);
  return cudaGetLastError();
}

}  // namespace bf16tile
