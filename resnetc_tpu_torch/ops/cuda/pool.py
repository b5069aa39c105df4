"""Max and average pools, NHWC.

Counterparts of ``resnetc_tpu/ops/pallas/pool.py``, a k x k window at
stride s:

- ``max_pool2d`` (pool.py:65) — padding p that never wins (-inf for floats,
  the type's minimum for integers);
- ``avg_pool2d`` (pool.py:174) — divisor k*k whatever the padding, padded
  taps add zeros, in the TPU kernel's order of operations (an fp32 sum over
  kw per kernel row, the rows summed in order, one multiply by the fp32
  value of 1/k^2).

Also ``stem_pool_int8``, the ``int8_chain`` stem's tail after its
convolution (bias, relu, quantize, 3x3/2 max pool, chain pad in one pass),
which replaces no Pallas kernel: the JAX package leaves it to XLA
(``resnetc_tpu/ops/pallas/fused.py:857-863``).

The kernels are CUDA C++ in ``resnetc_tpu_torch/csrc/pool.cu``; the plain
versions beside them are what a CPU tensor runs.  The TPU argument
``interpret`` is accepted and ignored.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from resnetc_tpu_torch.ops import torch_ops
from resnetc_tpu_torch.ops.cuda import _build, block
from resnetc_tpu_torch.ops.cuda.quant import quantize_with_scale

_KIND = {torch.bfloat16: 1, torch.float32: 2, torch.int8: 3}


def _geometry(x: torch.Tensor, k: int, s: int, p: int) -> tuple[int, int]:
    if x.ndim != 4:
        raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
    _, h, w_sp, _ = x.shape
    return (h + 2 * p - k) // s + 1, (w_sp + 2 * p - k) // s + 1


def max_pool2d_plain(x: torch.Tensor, *, kernel_size: int, stride: int, padding: int,
                     interpret: bool = False) -> torch.Tensor:
    """Plain PyTorch version: pad with the losing value, then the max over
    the k*k strided taps."""
    k, s, p = kernel_size, stride, padding
    oh, ow = _geometry(x, k, s, p)
    neg = float("-inf") if x.dtype.is_floating_point else int(torch.iinfo(x.dtype).min)
    xp = F.pad(x, (0, 0, p, p, p, p), value=neg)
    out = None
    for u in range(k):
        for v in range(k):
            tap = _tap(xp, u, v, s, oh, ow)
            out = tap if out is None else torch.maximum(out, tap)
    return out.contiguous()


def _tap(xp: torch.Tensor, u: int, v: int, s: int, oh: int, ow: int) -> torch.Tensor:
    return xp[:, u : u + s * (oh - 1) + 1 : s, v : v + s * (ow - 1) + 1 : s, :]


def _pool_fake(x, k, s, p):
    oh, ow = _geometry(x, k, s, p)
    return x.new_empty((x.shape[0], oh, ow, x.shape[3]))


#: Kernel 15 (pool.py:65): ``csrc/pool.cu``'s ``max_pool2d_nhwc``.
MAX_POOL2D_NHWC = _build.kernel_op(
    "max_pool2d_nhwc", "(Tensor x, int k, int s, int p) -> Tensor",
    plain=lambda x, k, s, p: max_pool2d_plain(x, kernel_size=k, stride=s, padding=p),
    fake=_pool_fake,
)


def max_pool2d(x: torch.Tensor, *, kernel_size: int, stride: int, padding: int,
               interpret: bool = False) -> torch.Tensor:
    """Max pool, NHWC (B, H, W, C) bf16 / fp32 / int8 -> (B, OH, OW, C)."""
    k, s, p = kernel_size, stride, padding
    if _build.runs_plain():
        return max_pool2d_plain(x, kernel_size=k, stride=s, padding=p)
    _geometry(x, k, s, p)
    if x.dtype not in _KIND:
        raise ValueError(f"x: dtype {x.dtype}, expected bf16, fp32 or int8")
    x = x.contiguous()
    return _build.call("max_pool2d", MAX_POOL2D_NHWC, x, k, s, p)


def _inv_k2(k: int) -> float:
    # The TPU kernel multiplies by the Python float 1/k^2, taken to fp32.
    return float(np.float32(1.0 / (k * k)))


def avg_pool2d_plain(x: torch.Tensor, *, kernel_size: int, stride: int, padding: int = 0,
                     interpret: bool = False) -> torch.Tensor:
    """Plain PyTorch version: zero padding, per kernel row an fp32 sum of
    its k taps from left to right, the rows summed in order, times the fp32
    value of 1/k^2, cast back."""
    k, s, p = kernel_size, stride, padding
    oh, ow = _geometry(x, k, s, p)
    xp = F.pad(x.float(), (0, 0, p, p, p, p))
    acc = None
    for u in range(k):
        cur = None
        for v in range(k):
            tap = _tap(xp, u, v, s, oh, ow)
            cur = tap if cur is None else cur + tap
        acc = cur if acc is None else acc + cur
    inv = torch.tensor(_inv_k2(k), dtype=torch.float32, device=x.device)
    return (acc * inv).to(x.dtype).contiguous()


#: Kernel 16 (pool.py:174): ``csrc/pool.cu``'s ``avg_pool2d_nhwc``.
AVG_POOL2D_NHWC = _build.kernel_op(
    "avg_pool2d_nhwc", "(Tensor x, int k, int s, int p) -> Tensor",
    plain=lambda x, k, s, p: avg_pool2d_plain(x, kernel_size=k, stride=s, padding=p),
    fake=_pool_fake,
)


def avg_pool2d(x: torch.Tensor, *, kernel_size: int, stride: int, padding: int = 0,
               interpret: bool = False) -> torch.Tensor:
    """Average pool, NHWC (B, H, W, C) bf16 / fp32 -> (B, OH, OW, C), divisor
    k*k (padded taps count as zeros)."""
    k, s, p = kernel_size, stride, padding
    if _build.runs_plain():
        return avg_pool2d_plain(x, kernel_size=k, stride=s, padding=p)
    _geometry(x, k, s, p)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x: dtype {x.dtype}, expected bf16 or fp32")
    x = x.contiguous()
    return _build.call("avg_pool2d", AVG_POOL2D_NHWC, x, k, s, p)


def stem_pool_int8_plain(y: torch.Tensor, bias: torch.Tensor, s_in: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the composition the ``int8_chain`` stem ran
    before the kernel (``fused._xla_conv``'s bias and relu, then
    ``quantize_with_scale``, ``torch_ops.max_pool2d`` and
    ``block.pad_for_chain``)."""
    y = torch_ops.relu(y + bias.to(y.dtype))
    yq = torch_ops.max_pool2d(quantize_with_scale(y, s_in), kernel_size=3, stride=2, padding=1)
    return block.pad_for_chain(yq)


def stem_pool_geometry(y: torch.Tensor) -> tuple[int, int, int, int]:
    """(h, w) of the stem's pooled map and (hp, wp) of its chain rows."""
    h, w_sp = _geometry(y, 3, 2, 1)
    return (h, w_sp, *block.chain_meta(y.shape[0], h, w_sp))


def _stem_pool_fake(y, bias, s_in):
    _, _, hp, wp = stem_pool_geometry(y)
    return y.new_empty((y.shape[0] * hp * wp, y.shape[3]), dtype=torch.int8)


#: The int8_chain stem's tail: ``csrc/pool.cu``'s ``stem_pool_int8``.
STEM_POOL_INT8 = _build.kernel_op(
    "stem_pool_int8", "(Tensor y, Tensor bias, Tensor s_in) -> Tensor",
    plain=stem_pool_int8_plain, fake=_stem_pool_fake,
)


def stem_pool_int8(y: torch.Tensor, bias: torch.Tensor, s_in: torch.Tensor) -> torch.Tensor:
    """The stem convolution's bias-free output ``y`` (B, H, W, C), bf16 or
    fp32, C a multiple of 16, contiguous -> the zero-ring chain rows
    (B * hp * wp, C) int8 of ``max_pool2d(quantize_with_scale(relu(y +
    bias.to(y.dtype)), s_in), 3, 2, 1)``; ``bias`` (C,) fp32 and ``s_in``
    0-d fp32 on y's device (the kernel reads the scale there)."""
    if _build.runs_plain():
        return stem_pool_int8_plain(y, bias, s_in)
    if y.ndim != 4 or y.shape[3] % 16:
        raise ValueError(f"y: shape {tuple(y.shape)}, expected (B, H, W, C), C % 16 == 0")
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"y: dtype {y.dtype}, expected bf16 or fp32")
    _build.require(y, "y", y.dtype, y.device)
    _build.require(bias, "bias", torch.float32, y.device, (y.shape[3],))
    _build.require(s_in, "s_in", torch.float32, y.device, ())
    return _build.call("stem_pool_int8", STEM_POOL_INT8, y, bias, s_in)
