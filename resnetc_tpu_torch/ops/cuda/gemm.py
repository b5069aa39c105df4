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

import ctypes

import torch

from resnetc_tpu_torch.ops.cuda import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_KIND = {None: 0, torch.bfloat16: 1, torch.float32: 2}
#: Split-K workspace floats per (M, N, K, bf16) shape, asked of the library once.
_WS_FLOATS: dict[tuple[int, int, int, int], int] = {}


def _lib() -> ctypes.CDLL:
    lib = _build.library("gemm")
    if lib.gemm_f32acc.argtypes is None:
        # x w bias res out ws; in_bf16 res_kind out_bf16 M N K relu; stream
        lib.gemm_f32acc.argtypes = [_P] * 6 + [_I] * 7 + [_P]
        lib.gemm_f32acc.restype = ctypes.c_int
        # M N K in_bf16 -> floats of split-K workspace
        lib.gemm_workspace_floats.argtypes = [_I] * 4
        lib.gemm_workspace_floats.restype = ctypes.c_longlong
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
    both fp32, bias (N,), residual (M, N) bf16 or fp32 (other dtypes are
    widened to fp32); fp32 accumulation; output dtype defaults to x's.
    One launch of the counter per call, the split-K sum included."""
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
        if residual.dtype not in (torch.bfloat16, torch.float32):
            residual = residual.float()
        residual = residual.contiguous()
        _build.require(residual, "residual", residual.dtype, dev, (m, n))
    lib = _lib()
    in_bf16 = int(x.dtype == torch.bfloat16)
    ws_floats = _WS_FLOATS.get((m, n, k, in_bf16))
    if ws_floats is None:
        ws_floats = _WS_FLOATS[m, n, k, in_bf16] = lib.gemm_workspace_floats(m, n, k, in_bf16)
    ws = torch.empty(ws_floats, dtype=torch.float32, device=dev) if ws_floats else None
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    rc = lib.gemm_f32acc(
        x.data_ptr(), w.data_ptr(), _build.ptr(bias), _build.ptr(residual),
        out.data_ptr(), _build.ptr(ws), in_bf16,
        _KIND[None if residual is None else residual.dtype],
        int(out_dtype == torch.bfloat16), m, n, k, int(relu), _build.stream(),
    )
    _build.check(rc, "matmul")
    _build.LAUNCHES["matmul"] += 1
    return out
