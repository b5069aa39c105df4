"""Fused convolutions: conv + bias (the BN fold) + residual + relu.

Counterpart of ``resnetc_tpu/ops/pallas/conv.py``; NHWC activations, HWIO
weights, fp32 accumulation, output in ``out_dtype`` (default x's):

- ``conv1x1_fused`` (conv.py:45) — a 1x1 conv is a GEMM over (B*H*W, Cin) x
  (Cin, Cout), a strided one a spatial slice first; through ``gemm.matmul``;
- ``conv3x3_s1_fused`` (conv.py:150) — 3x3, stride 1, pad 1, optional bias
  and residual;
- ``conv_s2_fused`` (conv.py:287) — odd k, stride 2, pad k//2, optional
  bias, no residual; ``conv3x3_s2_fused`` (:402) is its 3x3 alias.

The two kernels are CUDA C++ in ``resnetc_tpu_torch/csrc/conv.cu``: one
implicit GEMM, the stride a template parameter.  In bf16 both run on the
tensor cores through the wgmma tile of ``csrc/bf16_tile.cuh``, whose
im2col loader tests each tap against the image, so ``conv_s2_fused``
takes any odd k (9 and up included) and any Cin (off the 8-channel grid,
as the Cin = 3 of a stem-like 7x7, value by value); in fp32 both keep the
CUDA-core FMA tile.  The plain versions beside them are what a CPU tensor
runs.  The TPU arguments ``tn``, ``bt`` and ``interpret`` are accepted and
ignored.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from resnetc_tpu_torch.ops.cuda import _build, gemm

_P = ctypes.c_void_p
_I = ctypes.c_int
_KIND = {None: 0, torch.bfloat16: 1, torch.float32: 2}


def _lib() -> ctypes.CDLL:
    lib = _build.library("conv")
    if lib.conv_fused.argtypes is None:
        # x w bias res out; in_kind res_kind out_bf16 B H W Cin OH OW Cout k
        # stride relu; stream
        lib.conv_fused.argtypes = [_P] * 5 + [_I] * 13 + [_P]
        lib.conv_fused.restype = ctypes.c_int
    return lib


def conv1x1_fused(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    *,
    stride: int = 1,
    relu: bool = False,
    out_dtype: torch.dtype | None = None,
    interpret: bool = False,
    matmul_fn=gemm.matmul,
) -> torch.Tensor:
    """1x1 conv (+bias+residual+relu) as one epilogue-fused GEMM
    (``matmul_fn``: ``gemm.matmul``, or its plain version).  x (B, H, W,
    Cin); w (1, 1, Cin, Cout) or (Cin, Cout); residual (B, OH, OW, Cout)."""
    if w.ndim == 4:
        if tuple(w.shape[:2]) != (1, 1):
            raise ValueError(f"not a 1x1 weight: {tuple(w.shape)}")
        w = w[0, 0]
    if stride > 1:
        x = x[:, ::stride, ::stride, :]
    b, h, w_sp, cin = x.shape
    cout = w.shape[-1]
    res2d = residual.reshape(b * h * w_sp, cout) if residual is not None else None
    out = matmul_fn(
        x.reshape(b * h * w_sp, cin).contiguous(), w.contiguous(), bias, res2d,
        relu=relu, out_dtype=out_dtype,
    )
    return out.reshape(b, h, w_sp, cout)


def _out_hw(h: int, w_sp: int, k: int, stride: int) -> tuple[int, int]:
    p = k // 2
    return (h + 2 * p - k) // stride + 1, (w_sp + 2 * p - k) // stride + 1


def _conv_plain(x, w, bias, residual, *, stride, relu, out_dtype):
    """Plain PyTorch version of both kernels: one fp32 product per tap of
    the zero-padded input (the operands widened, which is exact), summed in
    tap order as the Pallas kernels do, then + bias, + residual, relu,
    cast."""
    k = w.shape[0]
    p = k // 2
    oh, ow = _out_hw(x.shape[1], x.shape[2], k, stride)
    xp = F.pad(x.float(), (0, 0, p, p, p, p))
    wf = w.float()
    acc = None
    for u in range(k):
        for v in range(k):
            tap = xp[:, u : u + stride * (oh - 1) + 1 : stride,
                     v : v + stride * (ow - 1) + 1 : stride, :]
            c = torch.matmul(tap, wf[u, v])
            acc = c if acc is None else acc + c
    if bias is not None:
        acc = acc + bias.float()
    if residual is not None:
        acc = acc + residual.float()
    if relu:
        acc = torch.relu(acc)
    return acc.to(out_dtype or x.dtype)


def _conv_launch(x, w, bias, residual, *, stride, relu, out_dtype, name):
    b, h, w_sp, cin = x.shape
    k, cout = w.shape[0], w.shape[-1]
    oh, ow = _out_hw(h, w_sp, k, stride)
    out_dtype = out_dtype or x.dtype
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x: dtype {x.dtype}, expected bf16 or fp32")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {out_dtype}, expected bf16 or fp32")
    dev = x.device
    x, w = x.contiguous(), w.contiguous()
    _build.require(x, "x", x.dtype, dev)
    _build.require(w, "w", x.dtype, dev, (k, k, cin, cout))
    if bias is not None:
        bias = bias.float().contiguous()
        _build.require(bias, "bias", torch.float32, dev, (cout,))
    if residual is not None:
        if residual.dtype not in (torch.bfloat16, torch.float32):
            residual = residual.float()
        residual = residual.contiguous()
        _build.require(residual, "residual", residual.dtype, dev, (b, oh, ow, cout))
    out = torch.empty((b, oh, ow, cout), dtype=out_dtype, device=dev)
    rc = _lib().conv_fused(
        x.data_ptr(), w.data_ptr(), _build.ptr(bias), _build.ptr(residual), out.data_ptr(),
        _KIND[x.dtype], _KIND[None if residual is None else residual.dtype],
        int(out_dtype == torch.bfloat16), b, h, w_sp, cin, oh, ow, cout, k, stride, int(relu),
        _build.stream(),
    )
    _build.check(rc, name)
    _build.LAUNCHES[name] += 1
    return out


def _check_weight(x: torch.Tensor, w: torch.Tensor, k: int | None) -> None:
    kk = w.shape[0]
    if w.ndim != 4 or tuple(w.shape[:3]) != (kk, kk, x.shape[-1]):
        raise ValueError(f"weight {tuple(w.shape)} does not fit input {tuple(x.shape)}")
    if (k is not None and kk != k) or kk % 2 == 0:
        raise ValueError(f"kernel size {kk} not supported here")


def conv3x3_s1_fused_plain(x, w, bias=None, residual=None, *, relu=False, out_dtype=None,
                           tn=None, bt=None, interpret=False):
    """Plain PyTorch version of ``conv3x3_s1_fused``."""
    _check_weight(x, w, 3)
    return _conv_plain(x, w, bias, residual, stride=1, relu=relu, out_dtype=out_dtype)


def conv3x3_s1_fused(x, w, bias=None, residual=None, *, relu=False, out_dtype=None,
                     tn=None, bt=None, interpret=False):
    """Fused 3x3 stride-1 pad-1 conv: ``relu(conv(x, w) + bias + residual)``.
    x (B, H, W, Cin); w (3, 3, Cin, Cout); bias (Cout,); residual (B, H, W,
    Cout).  Output (B, H, W, Cout) in ``out_dtype`` (default x's)."""
    _check_weight(x, w, 3)
    if not x.is_cuda:
        return _conv_plain(x, w, bias, residual, stride=1, relu=relu, out_dtype=out_dtype)
    return _conv_launch(x, w, bias, residual, stride=1, relu=relu, out_dtype=out_dtype,
                        name="conv3x3_s1_fused")


def conv_s2_fused_plain(x, w, bias=None, *, relu=False, out_dtype=None, tn=None, bt=None,
                        interpret=False):
    """Plain PyTorch version of ``conv_s2_fused``."""
    _check_weight(x, w, None)
    return _conv_plain(x, w, bias, None, stride=2, relu=relu, out_dtype=out_dtype)


def conv_s2_fused(x, w, bias=None, *, relu=False, out_dtype=None, tn=None, bt=None,
                  interpret=False):
    """Fused odd-k stride-2 pad-k//2 conv: ``relu(conv(x, w) + bias)``.
    Output (B, (H + 2p - k)//2 + 1, (W + 2p - k)//2 + 1, Cout)."""
    _check_weight(x, w, None)
    if not x.is_cuda:
        return _conv_plain(x, w, bias, None, stride=2, relu=relu, out_dtype=out_dtype)
    return _conv_launch(x, w, bias, None, stride=2, relu=relu, out_dtype=out_dtype,
                        name="conv_s2_fused")


def conv3x3_s2_fused(x, w, bias=None, *, relu=False, out_dtype=None, tn=None, bt=None,
                     interpret=False):
    """3x3 stride-2 pad-1 conv: the 3x3 case of ``conv_s2_fused``."""
    return conv_s2_fused(x, w, bias, relu=relu, out_dtype=out_dtype)
