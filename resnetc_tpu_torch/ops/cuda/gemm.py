"""Tiled GEMM with fp32 accumulation and a fused epilogue.

Counterpart of ``resnetc_tpu/ops/pallas/gemm.py:100 matmul``: ``relu?(x @ w
+ bias + residual)``.  On the int8_chain path it is the fc head, (B, 2048)
bf16 x (2048, 1000) bf16 -> fp32.  The kernel is CUDA C++ in
``resnetc_tpu_torch/csrc/gemm.cu``; the plain version beside it is what a
CPU tensor runs.  The tile arguments of the JAX wrapper (tm/tn/tk,
interpret) are TPU scheduling and are accepted and ignored.
"""

from __future__ import annotations

import ctypes

import torch

from resnetc_tpu_torch.ops.cuda import _build

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.library("gemm")
    if lib.gemm_f32acc.argtypes is None:
        # x w bias res out; in_bf16 out_bf16 M N K relu; stream
        lib.gemm_f32acc.argtypes = [_P] * 5 + [_I] * 6 + [_P]
        lib.gemm_f32acc.restype = ctypes.c_int
    return lib


def matmul_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    *,
    relu: bool = False,
    out_dtype: torch.dtype | None = None,
    tm=None, tn=None, tk=None, interpret=False,
) -> torch.Tensor:
    """Plain PyTorch version: fp32 product of the (exactly widened) operands,
    then + bias, + residual, relu, cast."""
    out = x.float() @ w.float()
    if bias is not None:
        out = out + bias.float()
    if residual is not None:
        out = out + residual.float()
    if relu:
        out = torch.relu(out)
    return out.to(out_dtype or x.dtype)


def matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    *,
    relu: bool = False,
    out_dtype: torch.dtype | None = None,
    tm=None, tn=None, tk=None, interpret=False,
) -> torch.Tensor:
    """``relu(x @ w + bias + residual)``: x (M, K), w (K, N) both bf16 or
    both fp32, bias (N,), residual (M, N); fp32 accumulation; output dtype
    defaults to x's."""
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(x.shape)} @ {tuple(w.shape)}")
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return matmul_plain(x, w, bias, residual, relu=relu, out_dtype=out_dtype)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x: dtype {x.dtype}, expected bf16 or fp32")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {out_dtype}, expected bf16 or fp32")
    dev = x.device
    _build.require(x, "x", x.dtype, dev)
    _build.require(w, "w", x.dtype, dev)
    if bias is not None:
        bias = bias.float().contiguous()
        _build.require(bias, "bias", torch.float32, dev, (n,))
    if residual is not None:
        residual = residual.float().contiguous()
        _build.require(residual, "residual", torch.float32, dev, (m, n))
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    rc = _lib().gemm_f32acc(
        x.data_ptr(), w.data_ptr(), _build.ptr(bias), _build.ptr(residual),
        out.data_ptr(), int(x.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), m, n, k, int(relu), _build.stream(),
    )
    _build.check(rc, "matmul")
    _build.LAUNCHES["matmul"] += 1
    return out
