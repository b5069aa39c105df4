"""GEMM with fp32 accumulation and a fused epilogue.

Counterpart of ``resnetc_tpu/ops/pallas/gemm.py:100 matmul``: ``relu?(x @ w
+ bias + residual)``.  On the int8_chain path it is the fc head, (B, 2048)
bf16 x (2048, 1000) bf16 -> fp32; on the ``pallas`` backend every 1x1
convolution.  The kernel is CUDA C++ in ``resnetc_tpu_torch/csrc/gemm.cu``
(bf16 on the tensor cores through ``csrc/bf16_tile.cuh``, K split over a
workspace where the output tiles cannot fill the card); the plain version
beside it is what a CPU tensor runs.  The residual is read in its own dtype
(bf16 or fp32), as the Pallas kernel reads it.  The tile arguments of the
JAX wrapper (tm/tn/tk, interpret) are TPU scheduling and are accepted and
ignored.
"""

from __future__ import annotations

import torch

from resnetc_tpu_torch.ops.cuda import _build


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


def _out_dtype(out_bf16: bool) -> torch.dtype:
    return torch.bfloat16 if out_bf16 else torch.float32


def _gemm_plain(x, w, bias, residual, relu, out_bf16):
    return matmul_plain(x, w, bias, residual, relu=relu, out_dtype=_out_dtype(out_bf16))


def _gemm_fake(x, w, bias, residual, relu, out_bf16):
    return x.new_empty((x.shape[0], w.shape[1]), dtype=_out_dtype(out_bf16))


#: Kernel 4 (gemm.py:100): ``csrc/gemm.cu``'s ``gemm_f32acc``.
GEMM_F32ACC = _build.kernel_op(
    "gemm_f32acc",
    "(Tensor x, Tensor w, Tensor? bias, Tensor? residual, bool relu, bool out_bf16) -> Tensor",
    plain=_gemm_plain, fake=_gemm_fake,
)


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
    both fp32, bias (N,), residual (M, N) bf16 or fp32 (other dtypes are
    widened to fp32); fp32 accumulation; output dtype defaults to x's.
    One launch of the counter per call, the split-K sum included."""
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(x.shape)} @ {tuple(w.shape)}")
    out_dtype = out_dtype or x.dtype
    if _build.runs_plain():
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
        if residual.dtype not in (torch.bfloat16, torch.float32):
            residual = residual.float()
        residual = residual.contiguous()
        _build.require(residual, "residual", residual.dtype, dev, (m, n))
    return _build.call("matmul", GEMM_F32ACC,
        x, w, bias, residual, relu, out_dtype == torch.bfloat16)
