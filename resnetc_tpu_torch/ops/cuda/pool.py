"""Max pool, NHWC.

Counterpart of ``resnetc_tpu/ops/pallas/pool.py:65 max_pool2d``: a k x k
window at stride s, padding p that never wins (-inf for floats, the type's
minimum for integers).  The kernel is CUDA C++ in
``resnetc_tpu_torch/csrc/pool.cu``; the plain version beside it is what a
CPU tensor runs.  The TPU argument ``interpret`` is accepted and ignored.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from resnetc_tpu_torch.ops.cuda import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_KIND = {torch.bfloat16: 1, torch.float32: 2, torch.int8: 3}


def _lib() -> ctypes.CDLL:
    lib = _build.library("pool")
    if lib.max_pool2d_nhwc.argtypes is None:
        # x out; kind vec B H W C OH OW k s p; stream
        lib.max_pool2d_nhwc.argtypes = [_P] * 2 + [_I] * 11 + [_P]
        lib.max_pool2d_nhwc.restype = ctypes.c_int
    return lib


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
            tap = xp[:, u : u + s * (oh - 1) + 1 : s, v : v + s * (ow - 1) + 1 : s, :]
            out = tap if out is None else torch.maximum(out, tap)
    return out.contiguous()


def max_pool2d(x: torch.Tensor, *, kernel_size: int, stride: int, padding: int,
               interpret: bool = False) -> torch.Tensor:
    """Max pool, NHWC (B, H, W, C) bf16 / fp32 / int8 -> (B, OH, OW, C)."""
    k, s, p = kernel_size, stride, padding
    if not x.is_cuda:
        return max_pool2d_plain(x, kernel_size=k, stride=s, padding=p)
    oh, ow = _geometry(x, k, s, p)
    if x.dtype not in _KIND:
        raise ValueError(f"x: dtype {x.dtype}, expected bf16, fp32 or int8")
    x = x.contiguous()
    b, h, w_sp, c = x.shape
    out = torch.empty((b, oh, ow, c), dtype=x.dtype, device=x.device)
    vec = int(c * x.element_size() % 16 == 0 and x.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    rc = _lib().max_pool2d_nhwc(
        x.data_ptr(), out.data_ptr(), _KIND[x.dtype], vec, b, h, w_sp, c, oh, ow, k, s, p,
        _build.stream(),
    )
    _build.check(rc, "max_pool2d")
    _build.LAUNCHES["max_pool2d"] += 1
    return out
