// The int8 tensor-core tile shared by the int8 GEMM (int8_gemm.cu,
// `int8_matmul`, resnetc_tpu/ops/pallas/quant.py:78) and the chain-layout
// block tile (chain_tile.cuh: the stride-1 int8 bottleneck and basic blocks,
// resnetc_tpu/ops/pallas/block.py:718, :1646, :2002): the PTX of
//
//     wgmma.mma_async.m64nNk32.s32.s8.s8   (N = 32, 64 or 128; 32 for the
//                                           grouped 3x3 of grouped_block.cu)
//
// with A and B both K-major in shared memory (for 8-bit types wgmma has no
// transpose bit: the PTX ISA gives it to f16 / bf16 only), and the loader
// that fills either operand from a K-major row-major int8 matrix.  The ring,
// the 128-byte swizzle, the staging of the tile for the epilogue and the
// plan (make_plan_stages) are bf16_tile.cuh's: a 128-byte swizzle row holds
// 128 int8 values of K, so a stage is four k32 products, the bf16 tile's
// ring geometry (four k16 of 32 bytes).
//
// Exactness.  The int32 sums are exact: no sum overflows (2048 * 127^2 <
// 2^31 at the widest K), so there is no .satfinite.

#pragma once

#include "bf16_tile.cuh"

namespace s8tile {

using namespace bf16tile;

constexpr int BK8 = 128;  // int8 K values per stage: one 128-byte swizzle row

// D[64 x N] (s32) = A[64 x 32] * B[32 x N] + (scale_d ? D : 0), A and B
// K-major in shared memory (8-bit wgmma has no transpose bit).
template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], uint64_t da, uint64_t db,
                                           int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaS8<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da, uint64_t db,
                                           int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaS8<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da, uint64_t db,
                                           int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// Orders the accumulators after a wgmma wait (no instruction is emitted).
template <int R>
__device__ __forceinline__ void fence_iregs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Stage kt of ROWS rows (from r0) of a (rows, K) int8 row-major matrix into
// the swizzled K-major layout: row r at r * 128 bytes, 16-byte chunk c (16
// K values) at c ^ (r % 8).  A block has 2 * BM threads; thread t copies
// chunk t % 8 of rows t / 8 + i * BM / 4, neighbouring threads
// neighbouring chunks of a row (coalesced).
template <int ROWS, int BM, bool VEC>
__device__ __forceinline__ void load_rows(uint32_t s, const int8_t* __restrict__ p, int rows,
                                          int K, int r0, int kt, int tid) {
  const int c = tid & 7, k = kt * BK8 + 16 * c;
#pragma unroll
  for (int i = 0; i < 4 * ROWS / BM; ++i) {
    const int r = tid / 8 + i * (BM / 4), g = r0 + r;
    const uint32_t dst = s + a_off(r, c);
    const int8_t* src = p + static_cast<size_t>(g) * K + k;
    if (VEC) {
      const bool ok = g < rows && k < K;
      cp_async16(dst, ok ? src : p, ok);
    } else {
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (g < rows && k + 4 * j + e < K)
            word |= static_cast<uint32_t>(static_cast<uint8_t>(src[4 * j + e])) << (8 * e);
        v[j] = word;
      }
      st_shared16(dst, v);
    }
  }
}

}  // namespace s8tile
