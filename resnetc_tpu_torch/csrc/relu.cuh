// relu as jnp.maximum(v, 0) and torch.relu compute it, for every fp32
// epilogue of the port's float kernels (the tensor-core tile bf16_tile.cuh,
// the fp32 FMA tiles of conv.cu, gemm.cu and fp_block.cu, the int8 GEMM's
// dequant epilogue, and the elementwise ops).
//
// v where v > 0 or v is NaN, else +0 (for a zero of either sign too).
// fmaxf(v, 0.f) and `v > 0 ? v : 0` turn a NaN into 0, so one NaN in an
// image would give finite logits where JAX and the plain versions give NaN.
// The int8 block epilogues (chain_tile.cuh) keep fmaxf: their inputs are
// int32 sums times finite scales, never NaN.

#pragma once

// relu keeps v itself (else it gives +0).
__device__ __forceinline__ bool relu_keeps(float v) { return v > 0.f || v != v; }

__device__ __forceinline__ float relu_keep_nan(float v) { return relu_keeps(v) ? v : 0.f; }
