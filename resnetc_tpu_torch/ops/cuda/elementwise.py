"""Elementwise ops of the op library: ``relu``, ``add``, ``add_relu``.

Counterparts of ``resnetc_tpu/ops/pallas/elementwise.py`` (``relu`` :82,
``add`` :92, ``add_relu`` :102, over ``_unary_call`` :29 and
``_binary_call`` :53): any shape, bf16 or fp32, the output in the input's
type.  ``max(v, 0)`` keeps a NaN, as ``jnp.maximum`` does, and gives +0 for
a zero of either sign; a bf16 sum is one rounding of the exact sum.  On the
serving paths these ops live inside the GEMM and block epilogues; the
standalone kernels are for callers that compose the ops themselves.

The kernel is CUDA C++ in ``resnetc_tpu_torch/csrc/elementwise.cu`` (one
grid-stride template, three ops); the plain versions beside it are what a
CPU tensor runs.  The TPU argument ``interpret`` is accepted and ignored.
"""

from __future__ import annotations

import ctypes

import torch

from resnetc_tpu_torch.ops.cuda import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_KIND = {torch.bfloat16: 1, torch.float32: 2}
_OPS = {"relu": 0, "add": 1, "add_relu": 2}


def _lib() -> ctypes.CDLL:
    lib = _build.library("elementwise")
    if lib.elementwise.argtypes is None:
        # op kind; a b out; n vec; stream
        lib.elementwise.argtypes = [_I, _I, _P, _P, _P, ctypes.c_longlong, _I, _P]
        lib.elementwise.restype = ctypes.c_int
    return lib


def relu_plain(x: torch.Tensor, *, interpret: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``relu``: x where x > 0 or x is NaN, else +0."""
    return torch.where((x > 0) | torch.isnan(x), x, torch.zeros((), dtype=x.dtype, device=x.device))


def add_plain(a: torch.Tensor, b: torch.Tensor, *, interpret: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``add``."""
    _check_pair(a, b)
    return a + b


def add_relu_plain(a: torch.Tensor, b: torch.Tensor, *, interpret: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``add_relu``."""
    _check_pair(a, b)
    return relu_plain(a + b)


def _check_pair(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"operands differ: {a.dtype} {tuple(a.shape)} vs {b.dtype} "
                         f"{tuple(b.shape)}")


def _launch(op: str, a: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    if a.dtype not in _KIND:
        raise ValueError(f"dtype {a.dtype}, expected bf16 or fp32")
    a = a.contiguous()
    operands = [a]
    if b is not None:
        b = b.contiguous()
        _build.require(b, "b", a.dtype, a.device)
        operands.append(b)
    out = torch.empty_like(a)
    n = a.numel()
    vec = int(n * a.element_size() % 16 == 0
              and all(t.data_ptr() % 16 == 0 for t in operands + [out]))
    rc = _lib().elementwise(_OPS[op], _KIND[a.dtype], a.data_ptr(), _build.ptr(b), out.data_ptr(),
                            n, vec, _build.stream())
    _build.check(rc, op)
    _build.LAUNCHES[op] += 1
    return out


def relu(x: torch.Tensor, *, interpret: bool = False) -> torch.Tensor:
    """max(x, 0), any shape, bf16 / fp32."""
    if not x.is_cuda:
        return relu_plain(x)
    return _launch("relu", x, None)


def add(a: torch.Tensor, b: torch.Tensor, *, interpret: bool = False) -> torch.Tensor:
    """a + b, two tensors of one shape and type (bf16 / fp32)."""
    if not a.is_cuda:
        return add_plain(a, b)
    _check_pair(a, b)
    return _launch("add", a, b)


def add_relu(a: torch.Tensor, b: torch.Tensor, *, interpret: bool = False) -> torch.Tensor:
    """max(a + b, 0): the residual join in one pass."""
    if not a.is_cuda:
        return add_relu_plain(a, b)
    _check_pair(a, b)
    return _launch("add_relu", a, b)
