"""Plain PyTorch ops: the numerical ground truth of the port.

Counterpart of ``resnetc_tpu/ops/lax_ops.py``; each function keeps the JAX
op's semantics and NHWC / HWIO layouts, and transposes to PyTorch's NCHW /
OIHW only around the library call:

- conv2d: square kernel, symmetric stride/padding, zero padding, no bias;
  fp32 accumulation, then a cast back to the compute dtype;
- max_pool2d: padding contributes -inf (int-min for integer inputs);
- avg_pool2d: divisor k*k whatever the padding;
- batch_norm inference with eps 1e-5, and its fold into the preceding conv;
- batch_norm_train: batch statistics, running statistics with momentum 0.1;
- relu / add / global average pool / linear.

fp32 operands on the card compute in IEEE fp32 (``exact_fp32``), as the
JAX ops pin ``Precision.HIGHEST``: the FP32 policy is the parity mode.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

EPS = 1e-5  # BatchNorm epsilon, the reference's value (cuda/ops.cu:150).

#: Running-stat momentum in training mode, PyTorch BatchNorm2d's default.
BN_MOMENTUM = 0.1


@contextlib.contextmanager
def exact_fp32():
    """IEEE fp32 for cuDNN convolutions and cuBLAS matmuls inside the block,
    whatever the process's TF32 settings; they are given back on exit.

    PyTorch lets cuDNN compute fp32 convolutions in TF32 by default (a
    10-bit mantissa in the products), and ``set_float32_matmul_precision``
    does the same to matmuls.  This sets the per-op ``fp32_precision``
    attributes, which take precedence over the backend-wide and legacy
    ``allow_tf32`` flags.  Autograd runs a backward after the forward has
    returned, so a caller that differentiates fp32 work holds the guard
    around the backward too (``train.train_step`` does).  Process-wide
    state: not for concurrent use from several threads."""
    conv = torch.backends.cudnn.conv
    mm = torch.backends.cuda.matmul
    saved = conv.fp32_precision, mm.fp32_precision
    conv.fp32_precision = mm.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision, mm.fp32_precision = saved


def _exact_if_fp32_cuda(t: torch.Tensor):
    if t.is_cuda and t.dtype == torch.float32:
        return exact_fp32()
    return contextlib.nullcontext()


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

    Accumulates in ``accum_dtype`` or wider regardless of the compute
    dtype, then casts back.  On the card cuDNN's bf16 convolution already
    accumulates in fp32.  On the CPU a narrower input is widened to float64
    and the sum rounded to its dtype at the end: an fp32 convolution there
    goes to oneDNN, whose blocking, and so its order of summation, follows
    the thread count and the batch, and one last-bit difference moves a
    bf16 rounding, an int8 calibration's absmax and then whole int8 steps
    downstream.  The float64 sum of bf16 products does not depend on either.
    fp32 on the card is IEEE fp32 (``exact_fp32``).

    Backward (autograd through ``F.conv2d``): on the card a bf16 convolution
    backpropagates as bf16 cuDNN convolutions that accumulate in fp32, the
    contract of the JAX package's ``_mixed_dtype_conv``.  On the CPU the
    widened path gives float64 gradients rounded to bf16 at the cast, which
    differ from JAX's in the last bits.
    """
    xn = x.permute(0, 3, 1, 2)
    wn = w.permute(3, 2, 0, 1)
    if x.dtype == accum_dtype or x.is_cuda:
        with _exact_if_fp32_cuda(x):
            y = F.conv2d(xn, wn.to(x.dtype), stride=stride, padding=padding, groups=groups)
    else:
        y = F.conv2d(
            xn.to(torch.float64), wn.to(torch.float64),
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


def avg_pool2d(
    x: torch.Tensor, *, kernel_size: int, stride: int, padding: int = 0
) -> torch.Tensor:
    """Average pool, NHWC: an fp32 window sum over the zero-padded input
    divided by ``kernel_size**2`` whatever the padding, cast back."""
    summed = F.avg_pool2d(
        x.permute(0, 3, 1, 2).float(), kernel_size, stride, padding,
        count_include_pad=True, divisor_override=1,
    )
    return (summed / (kernel_size * kernel_size)).to(x.dtype).permute(0, 2, 3, 1)


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
    accumulation (operands widened: exact for bf16 products), IEEE fp32 on
    the card (``exact_fp32``)."""
    xa = x.to(accum_dtype)
    with _exact_if_fp32_cuda(xa):
        out = xa @ w.to(accum_dtype).t()
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


def batch_norm_train(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    *,
    eps: float = EPS,
    momentum: float = BN_MOMENTUM,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode batch norm, NHWC: normalise with the batch statistics
    and return ``(out, new_running_mean, new_running_var)``.

    The JAX package's formula (``lax_ops.py:245``), not ``F.batch_norm``:
    fp32 raw moments ``m = E[x]``, ``E[x^2]``; the biased ``var = E[x^2] -
    m^2`` normalises, through a per-channel ``a``, ``c`` cast to x's dtype
    and ``x * a + c``.  The running variance takes the unbiased one,
    ``var * n / max(n - 1, 1)`` with ``n = N*H*W``, and both running stats
    move by ``momentum``.  They carry no autograd graph.

    ``group`` (a process group; JAX's ``axis_name``) makes this sync-BN:
    the two raw moments are averaged over the group's ranks, which hold
    equal slices of the batch, and ``n`` becomes the global count.
    Averaging raw moments, not per-rank variances, keeps the variance
    between the ranks' means.  The all-reduce carries autograd
    (``torch.distributed.nn.functional``), so the moments' gradient sums
    over the ranks in the backward."""
    xf = x.float()
    n = x.shape[0] * x.shape[1] * x.shape[2]
    mean = xf.mean(dim=(0, 1, 2))
    mean_sq = xf.square().mean(dim=(0, 1, 2))
    if group is not None:
        import torch.distributed as dist
        import torch.distributed.nn.functional as dist_nn

        world = dist.get_world_size(group)
        moments = dist_nn.all_reduce(torch.stack([mean, mean_sq]), group=group) / world
        mean, mean_sq = moments[0], moments[1]
        n *= world
    var = mean_sq - mean.square()
    inv = torch.rsqrt(var + eps)
    a = (scale.float() * inv).to(x.dtype)
    c = (bias.float() - mean * scale.float() * inv).to(x.dtype)
    out = x * a + c
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        new_mean = (1 - momentum) * running_mean.float() + momentum * mean
        new_var = (1 - momentum) * running_var.float() + momentum * unbiased
    return out, new_mean.to(running_mean.dtype), new_var.to(running_var.dtype)


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
