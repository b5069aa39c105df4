"""GEMM with fp32 accumulation and a fused epilogue.

Counterpart of ``resnetc_tpu/ops/pallas/gemm.py:100 matmul``: ``relu?(x @ w
+ bias + residual)``.  On the int8_chain path it is the fc head, (B, 2048)
bf16 x (2048, 1000) bf16 -> fp32; on the ``pallas`` backend every 1x1
convolution.  The kernel is CUDA C++ in ``resnetc_tpu_torch/csrc/gemm.cu``
(bf16 on the tensor cores through ``csrc/bf16_tile.cuh``, K split over a
workspace where the output tiles cannot fill the card; fp32 on the tensor
cores too, through the split-fp32 tile ``csrc/tf32x3_tile.cuh``, which
reads the weight from ``w_nk``, the TF32 heads and tails of its (N, K)
copy: ``pack_nk`` makes it, the engine once, the wrapper per call where it
is not given); the plain version beside it is what a CPU tensor runs.
``tf32_split`` is the plain version of the split the tile makes of each
value of x.  The residual is read in its own dtype (bf16 or fp32), as the
Pallas kernel reads it.  The tile arguments of the
JAX wrapper (tm/tn/tk, interpret) are TPU scheduling and are accepted and
ignored.
"""

from __future__ import annotations

import torch

from resnetc_tpu_torch.ops.cuda import _build


def pack_nk(w: torch.Tensor) -> torch.Tensor:
    """What the fp32 kernels read in place of a (K, N) weight, or of an
    HWIO conv weight viewed as (k*k*Cin, Cout): ``tf32_split`` of its (N,
    K) copy (TF32 wgmma takes both operands K-major), stacked as (2, N, K),
    heads then tails."""
    return torch.stack(tf32_split(w.reshape(-1, w.shape[-1]).t())).contiguous()


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """fp32 ``v`` rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero: ``cvt.rna.tf32.f32``.  NaN stays NaN."""
    bits = v.float().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(v), v.float(), r)


def tf32_split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` with ``hi = tf32(v)``, ``lo = tf32(v - hi)``: the split
    fp32 tile's two TF32 parts of each operand value (``split4`` in
    ``csrc/tf32x3_tile.cuh``, and ``pack_nk`` for the weight).  ``hi + lo`` holds v to 2^-22 of |v|, and
    ``a_hi*b_hi + a_hi*b_lo + a_lo*b_hi`` holds ``a*b`` to 3 * 2^-22 of
    |a*b|.  ``lo`` is 0 where v is infinite or NaN."""
    v = v.float()
    hi = tf32_round(v)
    d = v - hi
    return hi, torch.where(torch.isnan(d), torch.zeros_like(d), tf32_round(d))


def matmul_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    *,
    relu: bool = False,
    out_dtype: torch.dtype | None = None,
    w_nk: torch.Tensor | None = None,
    tm=None, tn=None, tk=None, interpret=False,
) -> torch.Tensor:
    """Plain PyTorch version: the product of the (exactly widened) operands
    summed in float64 and rounded to fp32 once, then + bias, + residual,
    relu, cast.  (An fp32 product on the CPU sums in an order that follows
    the BLAS library's blocking, and so the thread count: at the fc, (8,
    2048) x (2048, 11), one and four threads gave other bits.)  ``w_nk``,
    the kernel's copy of w, is not read."""
    out = (x.double() @ w.double()).float()
    if bias is not None:
        out = out + bias.float()
    if residual is not None:
        out = out + residual.float()
    if relu:
        out = torch.relu(out)
    return out.to(out_dtype or x.dtype)


def _out_dtype(out_bf16: bool) -> torch.dtype:
    return torch.bfloat16 if out_bf16 else torch.float32


def _gemm_plain(x, w, w_nk, bias, residual, relu, out_bf16):
    return matmul_plain(x, w, bias, residual, relu=relu, out_dtype=_out_dtype(out_bf16))


def _gemm_fake(x, w, w_nk, bias, residual, relu, out_bf16):
    return x.new_empty((x.shape[0], w.shape[1]), dtype=_out_dtype(out_bf16))


#: Kernel 4 (gemm.py:100): ``csrc/gemm.cu``'s ``gemm_f32acc``.
GEMM_F32ACC = _build.kernel_op(
    "gemm_f32acc",
    "(Tensor x, Tensor w, Tensor? w_nk, Tensor? bias, Tensor? residual, bool relu, "
    "bool out_bf16) -> Tensor",
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
    w_nk: torch.Tensor | None = None,
    tm=None, tn=None, tk=None, interpret=False,
) -> torch.Tensor:
    """``relu(x @ w + bias + residual)``: x (M, K), w (K, N) both bf16 or
    both fp32, bias (N,), residual (M, N) bf16 or fp32 (other dtypes are
    widened to fp32); fp32 accumulation; output dtype defaults to x's.
    ``w_nk`` (fp32 only): ``pack_nk(w)``, (2, N, K), which the fp32 kernel
    reads; made per call where it is not given.  One launch of the counter per call,
    the split-K sum included."""
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
    if x.dtype == torch.float32:
        w_nk = pack_nk(w) if w_nk is None else w_nk
        _build.require(w_nk, "w_nk", torch.float32, dev, (2, n, k))
    elif w_nk is not None:
        raise ValueError("w_nk: the bf16 kernel reads w as it lies; only fp32 takes w_nk")
    if bias is not None:
        bias = bias.float().contiguous()
        _build.require(bias, "bias", torch.float32, dev, (n,))
    if residual is not None:
        if residual.dtype not in (torch.bfloat16, torch.float32):
            residual = residual.float()
        residual = residual.contiguous()
        _build.require(residual, "residual", residual.dtype, dev, (m, n))
    return _build.call("matmul", GEMM_F32ACC,
        x, w, w_nk, bias, residual, relu, out_dtype == torch.bfloat16)
