// The int8 GEMM of the `int8` serving backend, with its dequant epilogue:
//
//     out = relu?(acc * (sx * sw[n]) + bias[n] + residual[m, n]),
//     acc = x_q @ w_q  (exact int32)
//
// x_q (M, K) int8 row-major; the weight as w_nk (N, K) int8 row-major, the
// K-major copy of the (K, N) w_q; sx a device scalar, sw and bias (N,)
// fp32, bias optional; residual (M, N) bf16 or fp32, optional; out bf16 or
// fp32.  Any M, N, K.
//
// Replaces resnetc_tpu/ops/pallas/quant.py:78 `int8_matmul` (pallas_call at
// :140, body :49-71).  On the path it is every 1x1 convolution of the
// `int8` backend and its fc head: ResNet-152 at batch 32 runs M up to
// 100,352 with K and N 64..2048, and the fc at M = 32, K = 2048, N = 1000.
//
// What bounds it.  At the widest layer1 shape (M 100,352, K 256, N 64) it
// does 3.3 G int8 operations against ~38 MB moved: bytes-bound on this card
// (~11 us at 3.35 TB/s); the deeper layers' K = N = 1024..2048 shapes sit
// above the int8 ridge and are bound by the tensor-core rate (1,979 TOP/s).
//
// Design (Hopper, sm_90a): the int8 tile of s8_tile.cuh (shared with the
// stride-1 bottleneck block, chain_block.cu), the sibling of bf16_tile.cuh's
// tile, with its pipeline, its 128-byte swizzle and its plan
// (make_plan_stages).
//   - `wgmma.mma_async.m64nBNk32.s32.s8.s8`, A and B from shared memory, the
//     sums in int32 registers.  A 128-byte swizzle row is 128 int8 values of
//     K; a stage is four k32 products, the bf16 tile's ring geometry (four
//     k16 of 32 bytes).  All four run even where the stage's tail lies past
//     K (zero-filled): skipping the ones past K behind a branch cost up to
//     27% at K = 2048 on an H100 and won 1-3% at K = 64.
//   - B is K-major.  For 8-bit types wgmma has no transpose bit (the PTX
//     ISA gives it to f16 / bf16 only), so the (K, N) weight cannot be read
//     as it lies, as the bf16 tile reads its weight.  Given as (N, K), both
//     operands are K-major row-major matrices and one loader fills both:
//     16-byte cp.async chunks, zero-filled past M, N or K.  The `int8`
//     engine makes the (N, K) copy once (quant.pack_kmajor); the wrapper
//     transposes per call only when it is not given.
//   - K off the 16-byte grid (or an unaligned operand) runs the same kernel
//     with VEC off: each chunk is gathered byte by byte.  N off 8 writes
//     the ragged columns one by one.  No padded copy of an operand.
//   - The ring holds only the stages a block's K run fills; the epilogue
//     stages the int32 tile through the freed ring, then writes each row 8
//     columns (16 bytes of bf16) a thread: the layer1 shapes are bound by
//     their output and residual.
//   - Split-K where the output tiles cannot fill the card (the fc): each
//     slice writes its int32 partial sums to a workspace and a second
//     kernel adds them and runs the epilogue.  Integer sums are exact, so
//     the result does not depend on the split, and is the same every call.
//
// Exactness.  The int32 dot is exact: no sum overflows (2048 * 127^2 <
// 2^31 at the widest K; no .satfinite).  The epilogue keeps the Pallas
// kernel's order of operations as XLA evaluates it (quant.py:64-71): the
// accumulator converted with round-to-nearest; the scale sx * sw[n]
// rounded on its own; `acc * scale + bias` one fused multiply-add (XLA
// fuses it), or `acc * scale + residual` when there is no bias; then +
// residual, relu, one rounding to the output type.  __int2float_rn,
// __fmaf_rn, __fmul_rn and __fadd_rn keep nvcc from contracting anything
// else, so the output equals the plain version (quant.py int8_matmul_plain)
// bit for bit.

#include "s8_tile.cuh"

namespace {

using namespace s8tile;

struct S8Epi {
  const float* sx;    // the activation scale, a device scalar
  const float* sw;    // (N,)
  const float* bias;  // (N,) or nullptr
  const void* res;    // (M, N) of res_kind, or nullptr
  void* out;          // (M, N), bf16 if out_bf16 else fp32
  int* ws;            // split-K partial sums (splits, M, N), or nullptr
  int M, N, res_kind, out_bf16, relu;
  int vec;            // N % 8 == 0 and every operand 16-byte aligned (set by the host)
};

// One output from its exact sum: quant.py:64-71 as XLA evaluates it.
__device__ __forceinline__ float dequant(const S8Epi& ep, int acc, float scale, float b,
                                         float r) {
  const float a = __int2float_rn(acc);
  float v;
  if (ep.bias) {
    v = __fmaf_rn(a, scale, b);
    if (ep.res_kind != KIND_NONE) v = __fadd_rn(v, r);
  } else if (ep.res_kind != KIND_NONE) {
    v = __fmaf_rn(a, scale, r);
  } else {
    v = __fmul_rn(a, scale);
  }
  return ep.relu ? relu_keep_nan(v) : v;
}

__device__ __forceinline__ void put1(const S8Epi& ep, float sx, int acc, int n, size_t o) {
  float r = 0.f;
  if (ep.res_kind == KIND_BF16)
    r = __bfloat162float(static_cast<const bf16*>(ep.res)[o]);
  else if (ep.res_kind == KIND_F32)
    r = static_cast<const float*>(ep.res)[o];
  const float v =
      dequant(ep, acc, __fmul_rn(sx, ep.sw[n]), ep.bias ? ep.bias[n] : 0.f, r);
  if (ep.out_bf16)
    static_cast<bf16*>(ep.out)[o] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(ep.out)[o] = v;
}

__device__ __forceinline__ void load_f32x8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// Eight outputs (m, n..n+7) from their sums: to the split-K workspace slice
// blockIdx.z, or through the epilogue to out.  16-byte accesses when ep.vec
// and the run lies inside N; one value at a time at a ragged edge.
__device__ __forceinline__ void store8(const S8Epi& ep, float sx, int m, int n,
                                       const int (&acc)[8]) {
  const size_t o = static_cast<size_t>(m) * ep.N + n;
  int* const ws = ep.ws ? ep.ws + static_cast<size_t>(blockIdx.z) * ep.M * ep.N : nullptr;
  if (!ep.vec || n + 8 > ep.N) {
    for (int e = 0; e < 8 && n + e < ep.N; ++e) {
      if (ws)
        ws[o + e] = acc[e];
      else
        put1(ep, sx, acc[e], n + e, o + e);
    }
    return;
  }
  if (ws) {
    reinterpret_cast<int4*>(ws + o)[0] = make_int4(acc[0], acc[1], acc[2], acc[3]);
    reinterpret_cast<int4*>(ws + o)[1] = make_int4(acc[4], acc[5], acc[6], acc[7]);
    return;
  }
  float sw[8], b[8] = {}, r[8] = {}, v[8];
  load_f32x8(ep.sw + n, sw);
  if (ep.bias) load_f32x8(ep.bias + n, b);
  if (ep.res_kind == KIND_BF16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(ep.res) + o);
    const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(r2[e]);
      r[2 * e] = f.x;
      r[2 * e + 1] = f.y;
    }
  } else if (ep.res_kind == KIND_F32) {
    load_f32x8(static_cast<const float*>(ep.res) + o, r);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = dequant(ep, acc[e], __fmul_rn(sx, sw[e]), b[e], r[e]);
  if (!ep.out_bf16) {
    float* const out = static_cast<float*>(ep.out) + o;
    reinterpret_cast<float4*>(out)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(out)[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
  uint4 pk;
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&pk);
#pragma unroll
  for (int e = 0; e < 4; ++e) p2[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  *reinterpret_cast<uint4*>(static_cast<bf16*>(ep.out) + o) = pk;
}

// grid (ceil(M / BM), ceil(N / BN), splits); blockIdx.z sums K stages
// [z * kt_per, (z + 1) * kt_per).  The pipeline is bf16tile::tile_kernel's:
// copies STAGES - 2 stages ahead, one wgmma group in flight, a stage
// refilled only after every warpgroup has waited for its products.
template <int BM, int BN, bool VEC>
__global__ void __launch_bounds__(2 * BM)
s8_tile_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt, S8Epi ep, int K,
               int kt_per) {
  extern __shared__ uint8_t smem_raw[];
  constexpr uint32_t A_BYTES = BM * 128, STAGE_BYTES = (BM + BN) * 128;
  uint8_t* const ring_ptr = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t ring = smem_u32(ring_ptr);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kt0 = blockIdx.z * kt_per;
  const int nk = min((K + BK8 - 1) / BK8, kt0 + kt_per) - kt0;

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  auto fill = [&](int i) {
    const uint32_t st = ring + (i % STAGES) * STAGE_BYTES;
    load_rows<BM, BM, VEC>(st, x, ep.M, K, m0, kt0 + i, tid);
    load_rows<BN, BM, VEC>(st + A_BYTES, wt, ep.N, K, n0, kt0 + i, tid);
  };
#pragma unroll
  for (int i = 0; i < STAGES - 2; ++i) {
    if (i < nk) fill(i);
    cp_async_commit();
  }

  const int wg = tid / 128;
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
    for (int ks = 0; ks < BK8 / 32; ++ks)
      WgmmaS8<BN>::mma(acc, desc_sw128(sa + ks * 32, 16, 1024),
                       desc_sw128(sb + ks * 32, 16, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_iregs(acc);

  // Stage the tile in shared memory (int32; the ring is free now), then
  // write it row by row, eight columns a thread.  Accumulator layout of
  // m64nBN: thread (warp q, lane l) of the warpgroup holds rows 16q + l/4
  // (+8) and columns 8j + 2(l % 4) (+1).
  cp_async_wait<0>();
  __syncthreads();
  int* const tile = reinterpret_cast<int*>(ring_ptr);
  constexpr int LD = stage_ld(BN);
  {
    const int t = tid % 128, q = t / 32, l = t % 32;
    const int r = wg * 64 + 16 * q + l / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(tile + (r + 8 * h) * LD + 8 * j + 2 * (l % 4)) =
            make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  __syncthreads();
  const float sx = *ep.sx;
  for (int e = tid; e < BM * (BN / 8); e += 2 * BM) {
    const int r = e / (BN / 8), c = 8 * (e % (BN / 8));
    const int m = m0 + r, n = n0 + c;
    if (m >= ep.M || n >= ep.N) continue;
    const int4 lo = *reinterpret_cast<const int4*>(tile + r * LD + c);
    const int4 hi = *reinterpret_cast<const int4*>(tile + r * LD + c + 4);
    const int v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    store8(ep, sx, m, n, v);
  }
}

// Adds the split-K slices (exact), then the epilogue.
__global__ void s8_splitk_reduce(S8Epi ep, int splits) {
  const size_t mn = static_cast<size_t>(ep.M) * ep.N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  int v = ep.ws[i];
  for (int s = 1; s < splits; ++s) v += ep.ws[s * mn + i];
  put1(ep, *ep.sx, v, static_cast<int>(i % ep.N), i);
}

template <int BM, int BN, bool VEC>
cudaError_t launch_s8(const int8_t* x, const int8_t* wt, const S8Epi& ep, int K, const Plan& p,
                      cudaStream_t stream) {
  auto kern = s8_tile_kernel<BM, BN, VEC>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<BM, BN>(STAGES));
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const int smem = smem_bytes<BM, BN>(p.kt_per < STAGES ? p.kt_per : STAGES);
  const dim3 grid((ep.M + BM - 1) / BM, (ep.N + BN - 1) / BN, p.splits);
  kern<<<grid, 2 * BM, smem, stream>>>(x, wt, ep, K, p.kt_per);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_s8_shape(const int8_t* x, const int8_t* wt, const S8Epi& ep, int K,
                         const Plan& p, bool vec, cudaStream_t stream) {
  return vec ? launch_s8<BM, BN, true>(x, wt, ep, K, p, stream)
             : launch_s8<BM, BN, false>(x, wt, ep, K, p, stream);
}

Plan s8_plan(int M, int N, int K) {
  return make_plan_stages(M, N, (K + BK8 - 1) / BK8, /*may_split=*/true);
}

}  // namespace

// Ints of workspace the product of this shape needs (its split-K partial
// sums), 0 when it does not split.
extern "C" long long int8_gemm_workspace_ints(int M, int N, int K) {
  const Plan p = s8_plan(M, N, K);
  return p.splits > 1 ? static_cast<long long>(p.splits) * M * N : 0;
}

// res_kind: 0 none, 1 bf16, 2 fp32.  ws: int8_gemm_workspace_ints(...) ints,
// or NULL when that is 0.
extern "C" int int8_gemm(const int8_t* x, const int8_t* w_nk, const float* sx, const float* sw,
                         const float* bias, const void* res, void* out, int* ws, int res_kind,
                         int out_bf16, int M, int N, int K, int relu, cudaStream_t stream) {
  const Plan p = s8_plan(M, N, K);
  if (p.splits > 1 && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  S8Epi ep{sx, sw, bias, res, out, p.splits > 1 ? ws : nullptr, M, N, res_kind, out_bf16, relu,
           0};
  ep.vec = N % 8 == 0 && aligned16(out) && aligned16(res) && aligned16(ws) && aligned16(bias) &&
           aligned16(sw);
  const bool vec = K % 16 == 0 && aligned16(x) && aligned16(w_nk);
  cudaError_t e = cudaErrorInvalidValue;
  if (p.bm == 128 && p.bn == 128)
    e = launch_s8_shape<128, 128>(x, w_nk, ep, K, p, vec, stream);
  else if (p.bm == 128 && p.bn == 64)
    e = launch_s8_shape<128, 64>(x, w_nk, ep, K, p, vec, stream);
  else if (p.bm == 64 && p.bn == 64)
    e = launch_s8_shape<64, 64>(x, w_nk, ep, K, p, vec, stream);
  if (e != cudaSuccess || p.splits <= 1) return static_cast<int>(e);
  const size_t mn = static_cast<size_t>(M) * N;
  s8_splitk_reduce<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, stream>>>(ep, p.splits);
  return static_cast<int>(cudaGetLastError());
}
