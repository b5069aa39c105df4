// Int8 bottleneck-block kernels over the chained padded-row layout.
//
// Replaces three Pallas megakernels of resnetc_tpu/ops/pallas/block.py:
//   - bottleneck_block_chained_int8 (block.py:718, body _chained_kernel_int8
//     :362): one stride-1 bottleneck block (identity or 1x1 projection
//     shortcut; int8, bf16 or per-image-mean exit);
//   - bottleneck_run_chained_int8 (block.py:2908, body :2743): a run of N
//     such blocks, the int8 activation handed from block to block;
//   - downsample_block_s2_int8 (block.py:3460, body :3109): the stride-2
//     stage transition, chain layout in and out.
//
// The stride-1 block (and so the run, which loops over it) is three
// launches of one int8 tensor-core kernel, chain_tile_kernel below, and a
// small one that zeroes the output's ring rows (the mean exit's
// mean_kernel instead), over the tile of s8_tile.cuh: wgmma m64nNk32
// s32.s8.s8 with both operands K-major from a swizzled cp.async ring.  Its
// int8 intermediates z1/z2 go through device scratch that the wrapper
// allocates, as chain rows:
//   conv1: every chain row of x (K = cin), relu, requant, ring rows zero
//          (a select: a ring row of x may hold anything);
//   conv2: kernel row kh reads, for output chain row t, the three
//          consecutive chain rows t + (kh-1)*wp - 1 .. + 1 of z1: 3c
//          contiguous int8 values, the (kw, k) order of w2pq's rows, so its
//          A is z1 viewed at a row offset with row stride c and K = 3c
//          (rows outside the chain zero-filled).  The zero ring of z1 is the
//          padding; the ring of x is never read by a 3x3.  Three int32 sums
//          P_kh, each its own loop over the ring, folded as soon as it is
//          done: fma(P0, a0, P1*a1) after P1, then fma(P2, a2, .) + c2;
//   conv3: z2 (K = c), plus the identity residual fma(x, s_res, y) read
//          from x at the row, or a second sum over x for the projection;
//          relu; int8, bf16 or fp32 out.
// conv2 and conv3 compute the interior pixels only (row m of the GEMM is
// pixel m, at its chain row): a chain has 1.22x, 1.31x and 1.47x as many
// rows as pixels at 28x28, 14x14 and 7x7.  z2's ring rows are then never
// written nor read, and a small kernel writes the output's ring rows as
// zeros (zero_ring_kernel).  Measured on an H100 at batch 32 (NVIDIA H100
// 80GB HBM3, 700 W; PERF.md, PR 8) against every chain row: 0.0754 against
// 0.0808 ms a block at 14x14, 0.0676 / 0.0884 at 7x7, 0.1190 / 0.1317 at
// 28x28, the stage-0 projection block 0.2012 / 0.2157.
// The weights are the K-major (N, K) copies (8-bit wgmma has no transpose
// bit): the int8_chain engine makes them once (fused.pack_chain_kmajor),
// a call without them transposes once.
//
// What bounds it.  2*(cin*c + 9*c*c + c*c4) int8 operations per pixel
// (~14 G at batch 32 at every ResNet-152 stage) against cin + c4 bytes:
// far above the card's int8 ridge, so the bound is the int8 tensor-core
// rate (~7 us a block).  This design runs at 7-10% of that at ResNet-152's
// stages 1-3 (PERF.md): it moves z1 and z2 through device memory, drains
// the wgmma pipeline at each of the 3x3's sum boundaries, and keeps two
// stages of copies in flight; one launch with z1/z2 on chip, TMA and a
// deeper ring are later work.
//
// The stride-2 transition still goes through the int8 implicit GEMM of
// igemm.cuh on the CUDA cores' dp4a (its header says how it works).
//
// The outputs equal the plain PyTorch versions in
// resnetc_tpu_torch/ops/cuda/block.py bit for bit (the mean exit up to fp32
// summation order): integer sums are exact, and every fp32 epilogue keeps
// the Pallas kernel's order of operations with XLA's roundings
// (__int2float_rn, __fmaf_rn, __fmul_rn, __fadd_rn, rintf).

#include "igemm.cuh"
#include "s8_tile.cuh"

namespace {

using s8tile::Chain;

// ---------------------------------------------------------------------------
// The stride-1 block on the int8 tensor-core tile
// ---------------------------------------------------------------------------

// One int32 sum of a launch: row m of A is the K int8 values at
// a + (row(m) + off) * lda, zero where that lies outside [0, limit) (a
// chain's first or last rows) or past K; B is the (N, K) K-major weight w.
// A 1x1 reads its own row (off 0, lda = K); kernel row kh of the 3x3 reads
// the three consecutive chain rows row(m) + (kh-1)*wp - 1 .. + 1 of z1 as
// one row of K = 3c (off (kh-1)*wp - 1, lda = c), which is the (kw, k) order
// of w2pq's rows.
struct S8Sum {
  const int8_t* a;
  const int8_t* w;
  long long limit;
  int lda, off, K;
};

// conv1: relu(fma(P, a0, c)) -> int8.  conv2: relu(fma(P2, a2, fma(P0, a0,
// P1*a1)) + c) -> int8.  conv3: y = fma(P, a0, c), then the shortcut:
// fma(x, s_res, y), or y + fma(Pd, a1, cd); relu; int8, bf16 or fp32.
enum TileEpi { TE_RELU_Q = 0, TE_KH3_Q = 1, TE_OUT = 2 };

// The requant scales are folded into the epilogue here, op for op as the
// wrapper of the TPU kernel folds them on the host (block.py:789-797,
// 822-823; ops/cuda/block.py _fold_block): sum g's multiplier is
// sw[g][n] * (s[num[g]] / s[den[g]]), the bias b[n] * (1 / s[den[0]]), the
// projection bias bd[n] * (1 / s_y), the residual scale s_x / s_y, where s
// = [s_x, s_z1, s_z2, s_y] on the device (s_y = 1 for a bf16 or fp32
// exit).  No small kernel runs per call to fold them.
struct TileArgs {
  S8Sum sum[3];
  const float* sw[3];   // per-channel weight scales of the sums
  int num[3], den[3];   // indices into the scales of each sum's ratio
  const float* b;       // per-channel bias (of the first sum)
  const float* bd;      // projection bias (TE_OUT with two sums)
  const float* scales;  // [s_x, s_z1, s_z2, s_y] (device)
  int unit_y;           // s_y taken as 1
  const int8_t* res;    // identity residual (chain rows, ld N), or nullptr
  void* out;            // chain rows, ld N
  int out_kind;         // OUT_I8, OUT_BF16, OUT_F32
  int M, N;
  int pixels;           // 1: row m is interior pixel m, at its chain row; 0: chain row m
  Chain g;
};

__device__ __forceinline__ int out_row(const TileArgs& p, int m) {
  return p.pixels ? s8tile::chain_row(p.g, m) : m;
}

__device__ __forceinline__ float col_of(const float* v, int n, int N) {
  return n < N ? v[n] : 0.f;
}

// The per-launch scalars of the epilogue, from the device scales.
struct Ratios {
  float sum[3];  // sum g's multiplier is sw[g][n] * sum[g]
  float bias;    // 1 / s[den[0]]
  float proj;    // 1 / s_y (the projection bias)
  float res;     // s_x / s_y (the identity residual)
};

__device__ __forceinline__ Ratios ratios(const TileArgs& p, int ng) {
  float s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = p.scales[i];
  if (p.unit_y) s[3] = 1.f;
  Ratios r;
#pragma unroll
  for (int g = 0; g < 3; ++g) r.sum[g] = g < ng ? __fdiv_rn(s[p.num[g]], s[p.den[g]]) : 0.f;
  r.bias = __fdiv_rn(1.f, s[p.den[0]]);
  r.proj = __fdiv_rn(1.f, s[3]);
  r.res = __fdiv_rn(s[0], s[3]);
  return r;
}

// Folds the finished sum G (acc) into the running fp32 values h, in the
// Pallas kernel's order of operations as XLA evaluates it (igemm.cuh's
// epilogues); the last sum leaves the output before the shortcut and relu.
template <int BN, int EPI, int G>
__device__ __forceinline__ void fold(const TileArgs& p, const Ratios& r, const int (&acc)[BN / 2],
                                     float (&h)[BN / 2], int n0, int lane) {
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) {
    const int n = n0 + 8 * (j / 4) + 2 * (lane % 4) + (j % 2);
    const bool in = n < p.N;
    const float f = __int2float_rn(acc[j]);
    const float a = in ? __fmul_rn(p.sw[G][n], r.sum[G]) : 0.f;
    if (EPI == TE_KH3_Q) {
      if (G == 0) {
        h[j] = f;
      } else if (G == 1) {
        const float a0 = in ? __fmul_rn(p.sw[0][n], r.sum[0]) : 0.f;
        h[j] = __fmaf_rn(h[j], a0, __fmul_rn(f, a));
      } else {
        h[j] = __fadd_rn(__fmaf_rn(f, a, h[j]), in ? __fmul_rn(p.b[n], r.bias) : 0.f);
      }
    } else if (G == 0) {
      h[j] = __fmaf_rn(f, a, in ? __fmul_rn(p.b[n], r.bias) : 0.f);
    } else {
      h[j] = __fadd_rn(h[j], __fmaf_rn(f, a, in ? __fmul_rn(p.bd[n], r.proj) : 0.f));
    }
  }
}

// Eight outputs of row m (chain row t), columns n..n+7, from their fp32
// values y: the shortcut, relu, zeros on the ring, the cast.
template <int EPI>
__device__ __forceinline__ void finish8(const TileArgs& p, const Ratios& ratio, int t,
                                        bool inside, int n, float (&y)[8], bool vec) {
  const size_t o = static_cast<size_t>(t) * p.N + n;
  const int cnt = vec ? 8 : min(8, p.N - n);
  if (EPI == TE_OUT && p.res) {
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
  for (int e = 0; e < 8; ++e) y[e] = inside ? fmaxf(y[e], 0.f) : 0.f;
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

// grid (ceil(M / BM), ceil(N / BN)).  The NG sums run as one stream of K
// stages through bf16tile::tile_kernel's pipeline (copies STAGES - 2 stages
// ahead, one wgmma group in flight, a stage refilled only after every
// warpgroup has waited for its products); where a sum ends, its int32
// tile is folded into the fp32 values h (fold) and the next sum starts from
// zero, so one int32 tile and one fp32 tile are live (the 3x3's
// fma(P0, a0, P1*a1) is formed as soon as P1 is done).
template <int BM, int BN, bool VEC, int NG, int EPI>
__global__ void __launch_bounds__(2 * BM) chain_tile_kernel(TileArgs p) {
  using namespace s8tile;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int row_t[BM];       // the tile row's chain row
  __shared__ int row_in[BM];      // ... and whether it is an interior pixel
  constexpr uint32_t A_BYTES = BM * 128, STAGE_BYTES = (BM + BN) * 128;
  uint8_t* const ring_ptr = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t ring = smem_u32(ring_ptr);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  if (tid < BM) {
    const int m = m0 + tid;
    const int t = m < p.M ? out_row(p, m) : -1;
    row_t[tid] = t;
    row_in[tid] = t >= 0 && (p.pixels || pixel_of(p.g, t) >= 0);
  }

  // This thread's four A rows (t / 8 + i * BM / 4): their chain rows.
  const int c = tid & 7;
  long long arow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tid / 8 + i * (BM / 4);
    arow[i] = m < p.M ? out_row(p, m) : -(1ll << 40);
  }
  int nk[NG], total = 0;
#pragma unroll
  for (int g = 0; g < NG; ++g) total += nk[g] = (p.sum[g].K + BK8 - 1) / BK8;

  auto load_a = [&](const S8Sum& s, uint32_t st, int kt) {
    const int k = kt * BK8 + 16 * c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t dst = st + a_off(tid / 8 + i * (BM / 4), c);
      const long long f = (arow[i] + s.off) * s.lda + k;
      if (VEC) {
        const bool ok = k < s.K && f >= 0 && f < s.limit;
        cp_async16(dst, ok ? s.a + f : s.a, ok);
      } else {
        uint32_t v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t word = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = 4 * j + e;
            if (k + kk < s.K && f + kk >= 0 && f + kk < s.limit)
              word |= static_cast<uint32_t>(static_cast<uint8_t>(s.a[f + kk])) << (8 * e);
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
        load_a(p.sum[g], st, q);
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
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK8 / 32; ++ks) {
        WgmmaS8<BN>::mma(acc, desc_sw128(sa + ks * 32, 16, 1024),
                         desc_sw128(sb + ks * 32, 16, 1024), scale);
        scale = 1;
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    fence_iregs(acc);
  };
  const Ratios r = ratios(p, NG);
  run_sum(0);
  fold<BN, EPI, 0>(p, r, acc, h, n0, lane);
  if constexpr (NG > 1) {
    run_sum(1);
    fold<BN, EPI, 1>(p, r, acc, h, n0, lane);
  }
  if constexpr (NG > 2) {
    run_sum(2);
    fold<BN, EPI, 2>(p, r, acc, h, n0, lane);
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
    finish8<EPI>(p, r, row_t[rr], row_in[rr] != 0, n, y, vec && n + 8 <= p.N);
  }
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

template <int BM, int BN, int NG, int EPI>
cudaError_t launch_chain_tile(const TileArgs& p, int stages, bool vec, cudaStream_t stream) {
  using namespace s8tile;
  auto kern = vec ? chain_tile_kernel<BM, BN, true, NG, EPI>
                  : chain_tile_kernel<BM, BN, false, NG, EPI>;
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
// number of K stages).
template <int NG, int EPI>
int run_tile(TileArgs p, cudaStream_t stream) {
  using namespace s8tile;
  int stages = 0;
  bool vec = true;
  for (int g = 0; g < NG; ++g) {
    const S8Sum& s = p.sum[g];
    stages += (s.K + BK8 - 1) / BK8;
    vec = vec && s.K % 16 == 0 && s.lda % 16 == 0 && aligned16(s.a) && aligned16(s.w);
  }
  const Plan pl = make_plan_stages(p.M, p.N, stages, /*may_split=*/false);
  cudaError_t e = cudaErrorInvalidValue;
  if (pl.bm == 128 && pl.bn == 128)
    e = launch_chain_tile<128, 128, NG, EPI>(p, stages, vec, stream);
  else if (pl.bm == 128 && pl.bn == 64)
    e = launch_chain_tile<128, 64, NG, EPI>(p, stages, vec, stream);
  else
    e = launch_chain_tile<64, 64, NG, EPI>(p, stages, vec, stream);
  return static_cast<int>(e);
}

// Per-image mean of the interior rows of an fp32 chain: out[b, n] =
// sum over pixels in row-major order of y * inv_hw (the head fold).
__global__ void mean_kernel(const float* __restrict__ y, Geo g, int N,
                            float inv_hw, float* __restrict__ out) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float s = 0.f;
  for (int r = 0; r < g.h; ++r)
    for (int q = 0; q < g.w; ++q) {
      const size_t row = (size_t)(b * g.hp + r + 1) * g.wp + q + 1;
      s = __fadd_rn(s, __fmul_rn(y[row * N + n], inv_hw));
    }
  out[(size_t)b * N + n] = s;
}

}  // namespace

// One stride-1 bottleneck block, chain in and out, on the int8 tile.  The
// weights are the K-major (N, K) copies: w1_nk (c, cin), w2p_nk (3c, 3c)
// whose row kh*c + j is output j of kernel row kh over the (kw, k) taps,
// w3_nk (c4, c), wd_nk (c4, cin); sw1, b1 (c), sw2p (3c: (kh, j)), b2 (c),
// sw3, b3 (c4), swd, bd (c4) fp32; scales the device [s_x, s_z1, s_z2,
// s_y], s_y taken as 1 when unit_y.  wd_nk == NULL: identity shortcut (cin
// == c4); else the 1x1 projection.  out_kind 0: int8 chain, 1: bf16 chain,
// 2: per-image fp32 means (B, c4) through the fp32 scratch y (B*hp*wp,
// c4).  z1, z2 are int8 scratch (B*hp*wp, c).  Returns the first failed
// launch's cudaError_t, or 0.
extern "C" int chain_block_int8(
    const int8_t* x, int B, int h, int w, int hp, int wp, int cin, int c, int c4,
    const int8_t* w1_nk, const float* sw1, const float* b1,
    const int8_t* w2p_nk, const float* sw2p, const float* b2,
    const int8_t* w3_nk, const float* sw3, const float* b3,
    const float* scales, int unit_y, const int8_t* wd_nk, const float* swd, const float* bd,
    int8_t* z1, int8_t* z2, float* y, int out_kind, void* out, float inv_hw,
    cudaStream_t stream) {
  enum { S_X = 0, S_Z1 = 1, S_Z2 = 2, S_Y = 3 };
  const Chain ch{h, w, hp, wp};
  const int rows = B * hp * wp;
  const int pixels = B * h * w;
  int err;

  // conv1 (1x1, cin -> c) over every chain row: relu(fma(P, a1, c1)) ->
  // int8, ring rows zero (conv2 reads them as its padding).
  TileArgs t1{};
  t1.sum[0] = S8Sum{x, w1_nk, static_cast<long long>(rows) * cin, cin, 0, cin};
  t1.sw[0] = sw1, t1.num[0] = S_X, t1.den[0] = S_Z1;
  t1.b = b1;
  t1.scales = scales;
  t1.out = z1;
  t1.out_kind = OUT_I8;
  t1.M = rows;
  t1.N = c;
  t1.g = ch;
  if ((err = run_tile<1, TE_RELU_Q>(t1, stream))) return err;

  // conv2 (3x3/1) over the interior pixels: three int32 sums P_kh, kernel
  // row kh reading z1 at row offset (kh-1)*wp - 1 from the pixel's chain row
  // (three consecutive chain rows, K = 3c).
  TileArgs t2{};
  for (int kh = 0; kh < 3; ++kh) {
    t2.sum[kh] = S8Sum{z1, w2p_nk + static_cast<size_t>(kh) * c * 3 * c,
                       static_cast<long long>(rows) * c, c, (kh - 1) * wp - 1, 3 * c};
    t2.sw[kh] = sw2p + kh * c, t2.num[kh] = S_Z1, t2.den[kh] = S_Z2;
  }
  t2.b = b2;
  t2.scales = scales;
  t2.out = z2;
  t2.out_kind = OUT_I8;
  t2.M = pixels;
  t2.N = c;
  t2.pixels = 1;
  t2.g = ch;
  if ((err = run_tile<3, TE_KH3_Q>(t2, stream))) return err;

  // conv3 (1x1, c -> c4) + shortcut + relu over the interior pixels; then
  // the output's ring rows are zeroed.
  TileArgs t3{};
  t3.sum[0] = S8Sum{z2, w3_nk, static_cast<long long>(rows) * c, c, 0, c};
  t3.sw[0] = sw3, t3.num[0] = S_Z2, t3.den[0] = S_Y;
  t3.b = b3;
  t3.scales = scales;
  t3.unit_y = unit_y;
  t3.out_kind = out_kind == 2 ? OUT_F32 : out_kind;
  t3.out = out_kind == 2 ? static_cast<void*>(y) : out;
  t3.M = pixels;
  t3.N = c4;
  t3.pixels = 1;
  t3.g = ch;
  if (wd_nk) {
    t3.sum[1] = S8Sum{x, wd_nk, static_cast<long long>(rows) * cin, cin, 0, cin};
    t3.sw[1] = swd, t3.num[1] = S_X, t3.den[1] = S_Y;
    t3.bd = bd;
    if ((err = run_tile<2, TE_OUT>(t3, stream))) return err;
  } else {
    t3.res = x;
    if ((err = run_tile<1, TE_OUT>(t3, stream))) return err;
  }
  if (out_kind == 2) {
    const Geo g{h, w, hp, wp};
    const dim3 grid((c4 + 127) / 128, B);
    mean_kernel<<<grid, 128, 0, stream>>>(y, g, c4, inv_hw, static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  zero_ring_kernel<<<264, 256, 0, stream>>>(static_cast<uint8_t*>(out), ch, B,
                                            c4 * (out_kind == OUT_BF16 ? 2 : 1));
  return static_cast<int>(cudaGetLastError());
}

// A run of n_blocks stride-1 blocks.  Per-block parameters are stacked,
// the weights as K-major copies: w1s (n_w1, c, c4) with n_w1 = n_blocks -
// (w10 != NULL), w2ps (N, 3c, 3c), w3s (N, c4, c); sw1s/b1s/b2s (N, c),
// sw2ps (N, 3c), sw3s/b3s (N, c4), scales_s (N, 4), the last block's s_y
// taken as 1 when it exits bf16.  With w10 (c, cin)/wd (c4, cin)/swd/bd
// block 0 is the projection block over x (rows, cin).  Activations between
// blocks go through act0/act1 (int8 chains, (B*hp*wp, c4)); the last block
// writes `out` (int8 or bf16).
extern "C" int chain_run_int8(
    const int8_t* x, int n_blocks, int B, int h, int w, int hp, int wp, int cin,
    int c, int c4, const int8_t* w1s, const int8_t* w10,
    const float* sw1s, const float* b1s, const int8_t* w2ps, const float* sw2ps,
    const float* b2s, const int8_t* w3s, const float* sw3s, const float* b3s,
    const float* scales_s, const int8_t* wd, const float* swd, const float* bd,
    int8_t* z1, int8_t* z2, int8_t* act0, int8_t* act1, int last_bf16,
    void* out, cudaStream_t stream) {
  const bool proj = w10 != nullptr;
  int8_t* act[2] = {act0, act1};
  for (int n = 0; n < n_blocks; ++n) {
    const bool last = n == n_blocks - 1;
    const int8_t* xin = n == 0 ? x : act[(n - 1) % 2];
    const bool pn = proj && n == 0;
    const int8_t* w1 = proj ? (n == 0 ? w10 : w1s + (size_t)(n - 1) * c4 * c)
                            : w1s + (size_t)n * c4 * c;
    const int err = chain_block_int8(
        xin, B, h, w, hp, wp, pn ? cin : c4, c, c4,
        w1, sw1s + (size_t)n * c, b1s + (size_t)n * c,
        w2ps + (size_t)n * 9 * c * c, sw2ps + (size_t)n * 3 * c, b2s + (size_t)n * c,
        w3s + (size_t)n * c * c4, sw3s + (size_t)n * c4, b3s + (size_t)n * c4,
        scales_s + 4 * n, last && last_bf16, pn ? wd : nullptr, swd, bd, z1, z2, nullptr,
        last ? (last_bf16 ? OUT_BF16 : OUT_I8) : OUT_I8,
        last ? out : static_cast<void*>(act[n % 2]), 0.f, stream);
    if (err) return err;
  }
  return 0;
}

// The stride-2 transition block: x is the (h, w) input stage's int8 chain,
// out the (oh, ow) = ((h+1)/2, (w+1)/2) stage's chain (int8, or bf16 when
// out_kind == 1).  conv1 1x1 over the input chain, conv2 3x3/2 with one
// int32 sum over all nine taps (w2 (9c, c), rows (kh, kw, k)), conv3 1x1
// plus the 1x1/2 projection of x[2r, 2q].  z1 (B*hp*wp, c) and
// z2 (B*hp2*wp2, c) are int8 scratch.
extern "C" int ds_block_s2_int8(
    const int8_t* x, int B, int h, int w, int hp, int wp, int cin, int c, int c4,
    int oh, int ow, int hp2, int wp2,
    const int8_t* w1, const float* a1, const float* c1,
    const int8_t* w2, const float* a2, const float* c2,
    const int8_t* w3, const float* a3, const float* c3,
    const int8_t* wd, const float* ad, const float* cd,
    int8_t* z1, int8_t* z2, int out_kind, void* out, cudaStream_t stream) {
  const Geo gi{h, w, hp, wp};
  const Geo go{oh, ow, hp2, wp2};
  int err;

  Operand o1 = operand(x, cin, gi, 1, 1, 0, w1, c, 0);
  EpiArgs e1{};
  e1.a[0] = a1;
  e1.c = c1;
  e1.out_kind = OUT_I8;
  e1.out = z1;
  if ((err = launch<1, EPI_RELU_Q>(&o1, gi, B * hp * wp, c, e1, stream))) return err;

  Operand o2 = operand(z1, c, gi, 2, 9, 0, w2, c, 0);
  EpiArgs e2{};
  e2.a[0] = a2;
  e2.c = c2;
  e2.out_kind = OUT_I8;
  e2.out = z2;
  if ((err = launch<1, EPI_RELU_Q>(&o2, go, B * hp2 * wp2, c, e2, stream))) return err;

  Operand o3[2];
  o3[0] = operand(z2, c, go, 1, 1, 0, w3, c4, 0);
  o3[1] = operand(x, cin, gi, 2, 1, 0, wd, c4, 0);
  EpiArgs e3{};
  e3.a[0] = a3;
  e3.c = c3;
  e3.ad = ad;
  e3.cd = cd;
  e3.out_kind = out_kind;
  e3.out = out;
  return launch<2, EPI_BLOCK_OUT>(o3, go, B * hp2 * wp2, c4, e3, stream);
}
