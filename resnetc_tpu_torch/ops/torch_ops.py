"""Plain PyTorch ops: the numerical ground truth of the port.

Counterpart of ``resnetc_tpu/ops/lax_ops.py``; each function keeps the JAX
op's semantics and NHWC / HWIO layouts, and transposes to PyTorch's NCHW /
OIHW only around the library call:

- conv2d: square kernel, symmetric stride/padding, zero padding, no bias;
  fp32 accumulation, then a cast back to the compute dtype;
- max_pool2d: padding contributes -inf (int-min for integer inputs);
- batch_norm inference with eps 1e-5, and its fold into the preceding conv;
- relu / add / global average pool / linear.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-5  # BatchNorm epsilon, the reference's value (cuda/ops.cu:150).


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    padding: int = 0,
    accum_dtype: torch.dtype = torch.float32,
    groups: int = 1,
) -> torch.Tensor:
    """2-D convolution, NHWC x HWIO -> NHWC, zero-padded, bias-free.

    Accumulates in ``accum_dtype`` regardless of the compute dtype, then
    casts back.  On the card cuDNN's bf16 convolution already accumulates in
    fp32; on the CPU the operands are widened first, which is exact (a
    product of two bf16 values is exact in fp32).
    """
    xn = x.permute(0, 3, 1, 2)
    wn = w.permute(3, 2, 0, 1)
    if x.dtype == accum_dtype or x.is_cuda:
        y = F.conv2d(xn, wn.to(x.dtype), stride=stride, padding=padding, groups=groups)
    else:
        y = F.conv2d(
            xn.to(accum_dtype), wn.to(accum_dtype),
            stride=stride, padding=padding, groups=groups,
        ).to(x.dtype)
    return y.permute(0, 2, 3, 1)


def max_pool2d(
    x: torch.Tensor, *, kernel_size: int, stride: int, padding: int
) -> torch.Tensor:
    """Max pool, NHWC.  Padded elements never win (-inf / int-min).

    Integer inputs pool in fp32 and cast back: exact for int8 values, and
    PyTorch has no integer max pool on the card.  Every window holds at
    least one real element (padding <= kernel_size // 2), so -inf and
    int-min padding give the same result.
    """
    xn = x.permute(0, 3, 1, 2)
    if x.dtype.is_floating_point:
        y = F.max_pool2d(xn, kernel_size, stride, padding)
    else:
        y = F.max_pool2d(xn.float(), kernel_size, stride, padding).to(x.dtype)
    return y.permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Global spatial mean in fp32, NHWC -> NC, cast back to x's dtype."""
    return x.float().mean(dim=(1, 2)).to(x.dtype)


def linear(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    accum_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``x [B, in] @ W.T + b`` with W in PyTorch's [out, in] layout; fp32
    accumulation (operands widened: exact for bf16 products)."""
    out = x.to(accum_dtype) @ w.to(accum_dtype).t()
    if b is not None:
        out = out + b.to(accum_dtype)
    return out.to(x.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def batch_norm_inference(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    *,
    eps: float = EPS,
) -> torch.Tensor:
    """``(x - mean) / sqrt(var + eps) * scale + bias`` per channel (NHWC),
    with the per-channel affine precomputed in fp32."""
    inv = torch.rsqrt(var.float() + eps)
    a = (scale.float() * inv).to(x.dtype)
    c = (bias.float() - mean.float() * scale.float() * inv).to(x.dtype)
    return x * a + c


def fold_bn_into_conv(
    w: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    *,
    eps: float = EPS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold an inference-mode BN into the preceding bias-free conv.

    ``w`` is HWIO; returns (folded_w [HWIO], folded_bias [O]) with
    ``g = scale / sqrt(var + eps)``, ``folded_w = w * g``,
    ``folded_bias = bias - mean * g``.
    """
    g = scale.float() * torch.rsqrt(var.float() + eps)
    folded_w = (w.float() * g).to(w.dtype)
    folded_b = bias.float() - mean.float() * g
    return folded_w, folded_b
