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
as the Cin = 3 of a stem-like 7x7, value by value); in fp32 both run on
the tensor cores through the split-fp32 tile of ``csrc/tf32x3_tile.cuh``,
which reads the weight from ``w_nk``, the TF32 heads and tails of its
(Cout, k*k*Cin) copy (``gemm.pack_nk``: the engine makes it once, the
wrapper per call where it is not given).  The plain versions beside them
are what a CPU tensor runs.  The TPU arguments ``tn``, ``bt`` and ``interpret`` are accepted and
ignored.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from resnetc_tpu_torch.ops.cuda import _build, gemm


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
    w_nk: torch.Tensor | None = None,
) -> torch.Tensor:
    """1x1 conv (+bias+residual+relu) as one epilogue-fused GEMM
    (``matmul_fn``: ``gemm.matmul``, or its plain version).  x (B, H, W,
    Cin); w (1, 1, Cin, Cout) or (Cin, Cout); residual (B, OH, OW, Cout);
    ``w_nk`` (fp32): ``gemm.pack_nk(w)``, which the fp32 kernel reads."""
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
        relu=relu, out_dtype=out_dtype, w_nk=w_nk,
    )
    return out.reshape(b, h, w_sp, cout)


def _out_hw(h: int, w_sp: int, k: int, stride: int) -> tuple[int, int]:
    p = k // 2
    return (h + 2 * p - k) // stride + 1, (w_sp + 2 * p - k) // stride + 1


def _conv_plain(x, w, bias, residual, *, stride, relu, out_dtype):
    """Plain PyTorch version of both kernels: one product per tap of the
    zero-padded input, each tap's dot summed in float64 and rounded to fp32
    once, the taps summed in fp32 in tap order as the Pallas kernels do,
    then + bias, + residual, relu, cast.  (An fp32 dot on the CPU sums in
    an order that follows the BLAS library's blocking, which follows the
    thread count and the batch; the int8 backend's per-tensor scales make a
    last-bit difference a whole int8 step.)"""
    k = w.shape[0]
    p = k // 2
    oh, ow = _out_hw(x.shape[1], x.shape[2], k, stride)
    xp = F.pad(x.double(), (0, 0, p, p, p, p))
    wf = w.double()
    acc = None
    for u in range(k):
        for v in range(k):
            tap = xp[:, u : u + stride * (oh - 1) + 1 : stride,
                     v : v + stride * (ow - 1) + 1 : stride, :]
            c = torch.matmul(tap, wf[u, v]).float()
            acc = c if acc is None else acc + c
    if bias is not None:
        acc = acc + bias.float()
    if residual is not None:
        acc = acc + residual.float()
    if relu:
        acc = torch.relu(acc)
    return acc.to(out_dtype or x.dtype)


def _conv_call(x, w, bias, residual, *, stride, relu, out_dtype, w_nk):
    """Check and shape a conv's operands, then call ``resnetc::conv_fused``
    (in fp32 with ``w_nk``, ``gemm.pack_nk(w)`` where it is not given)."""
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
    if x.dtype == torch.float32:
        w_nk = gemm.pack_nk(w) if w_nk is None else w_nk
        _build.require(w_nk, "w_nk", torch.float32, dev, (2, cout, k * k * cin))
    elif w_nk is not None:
        raise ValueError("w_nk: the bf16 kernel reads w as it lies; only fp32 takes w_nk")
    if bias is not None:
        bias = bias.float().contiguous()
        _build.require(bias, "bias", torch.float32, dev, (cout,))
    if residual is not None:
        if residual.dtype not in (torch.bfloat16, torch.float32):
            residual = residual.float()
        residual = residual.contiguous()
        _build.require(residual, "residual", residual.dtype, dev, (b, oh, ow, cout))
    name = "conv3x3_s1_fused" if stride == 1 else "conv_s2_fused"
    return _build.call(name, CONV_FUSED,
        x, w, w_nk, bias, residual, stride, relu, out_dtype == torch.bfloat16)


def _out_dtype(out_bf16: bool) -> torch.dtype:
    return torch.bfloat16 if out_bf16 else torch.float32


def _conv_fused_plain(x, w, w_nk, bias, residual, stride, relu, out_bf16):
    return _conv_plain(x, w, bias, residual, stride=stride, relu=relu,
                       out_dtype=_out_dtype(out_bf16))


def _conv_fused_fake(x, w, w_nk, bias, residual, stride, relu, out_bf16):
    b, h, w_sp, _ = x.shape
    oh, ow = _out_hw(h, w_sp, w.shape[0], stride)
    return x.new_empty((b, oh, ow, w.shape[-1]), dtype=_out_dtype(out_bf16))


#: Kernels 13 and 14 (conv.py:150, :287): ``csrc/conv.cu``'s ``conv_fused``,
#: the stride a template parameter inside; counted under the wrapper's name.
CONV_FUSED = _build.kernel_op(
    "conv_fused",
    "(Tensor x, Tensor w, Tensor? w_nk, Tensor? bias, Tensor? residual, int stride, "
    "bool relu, bool out_bf16) -> Tensor",
    plain=_conv_fused_plain, fake=_conv_fused_fake,
)


def _check_weight(x: torch.Tensor, w: torch.Tensor, k: int | None) -> None:
    kk = w.shape[0]
    if w.ndim != 4 or tuple(w.shape[:3]) != (kk, kk, x.shape[-1]):
        raise ValueError(f"weight {tuple(w.shape)} does not fit input {tuple(x.shape)}")
    if (k is not None and kk != k) or kk % 2 == 0:
        raise ValueError(f"kernel size {kk} not supported here")


def conv3x3_s1_fused_plain(x, w, bias=None, residual=None, *, relu=False, out_dtype=None,
                           w_nk=None, tn=None, bt=None, interpret=False):
    """Plain PyTorch version of ``conv3x3_s1_fused`` (``w_nk`` is not read)."""
    _check_weight(x, w, 3)
    return _conv_plain(x, w, bias, residual, stride=1, relu=relu, out_dtype=out_dtype)


def conv3x3_s1_fused(x, w, bias=None, residual=None, *, relu=False, out_dtype=None,
                     w_nk=None, tn=None, bt=None, interpret=False):
    """Fused 3x3 stride-1 pad-1 conv: ``relu(conv(x, w) + bias + residual)``.
    x (B, H, W, Cin); w (3, 3, Cin, Cout); bias (Cout,); residual (B, H, W,
    Cout).  Output (B, H, W, Cout) in ``out_dtype`` (default x's).
    ``w_nk`` (fp32): ``gemm.pack_nk(w)``, what the fp32 kernel reads."""
    _check_weight(x, w, 3)
    if _build.runs_plain():
        return _conv_plain(x, w, bias, residual, stride=1, relu=relu, out_dtype=out_dtype)
    return _conv_call(x, w, bias, residual, stride=1, relu=relu, out_dtype=out_dtype,
                      w_nk=w_nk)


def conv_s2_fused_plain(x, w, bias=None, *, relu=False, out_dtype=None, w_nk=None, tn=None,
                        bt=None, interpret=False):
    """Plain PyTorch version of ``conv_s2_fused`` (``w_nk`` is not read)."""
    _check_weight(x, w, None)
    return _conv_plain(x, w, bias, None, stride=2, relu=relu, out_dtype=out_dtype)


def conv_s2_fused(x, w, bias=None, *, relu=False, out_dtype=None, w_nk=None, tn=None, bt=None,
                  interpret=False):
    """Fused odd-k stride-2 pad-k//2 conv: ``relu(conv(x, w) + bias)``.
    Output (B, (H + 2p - k)//2 + 1, (W + 2p - k)//2 + 1, Cout).  ``w_nk``
    as ``conv3x3_s1_fused``'s."""
    _check_weight(x, w, None)
    if _build.runs_plain():
        return _conv_plain(x, w, bias, None, stride=2, relu=relu, out_dtype=out_dtype)
    return _conv_call(x, w, bias, None, stride=2, relu=relu, out_dtype=out_dtype, w_nk=w_nk)


def conv3x3_s2_fused(x, w, bias=None, *, relu=False, out_dtype=None, w_nk=None, tn=None,
                     bt=None, interpret=False):
    """3x3 stride-2 pad-1 conv: the 3x3 case of ``conv_s2_fused``."""
    return conv_s2_fused(x, w, bias, relu=relu, out_dtype=out_dtype, w_nk=w_nk)
