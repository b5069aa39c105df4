"""Elementwise ops of the op library: ``relu``, ``add``, ``add_relu``.

Counterparts of ``resnetc_tpu/ops/pallas/elementwise.py`` (``relu`` :82,
``add`` :92, ``add_relu`` :102, over ``_unary_call`` :29 and
``_binary_call`` :53): any shape, bf16 or fp32, the output in the input's
type.  ``max(v, 0)`` keeps a NaN, as ``jnp.maximum`` does, and gives +0 for
a zero of either sign; a bf16 sum is one rounding of the exact sum.  On the
serving paths these ops live inside the GEMM and block epilogues; the
standalone kernels are for callers that compose the ops themselves.

The kernel is CUDA C++ in ``resnetc_tpu_torch/csrc/elementwise.cu``: a
body of 16-byte vectors (read-only loads, streaming stores) between a
scalar head and tail, for any size and any element-aligned view (the
output is allocated at the first operand's offset mod 16, so a view off
the 16-byte grid takes the vector body too); operands at different
offsets take a scalar kernel.  The plain versions beside it are what a
CPU tensor runs.  The TPU argument ``interpret`` is accepted and ignored.
"""

from __future__ import annotations

import torch

from resnetc_tpu_torch.ops.cuda import _build

_KIND = {torch.bfloat16: 1, torch.float32: 2}
_OPS = {"relu": 0, "add": 1, "add_relu": 2}


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


_PLAIN = {0: lambda a, b: relu_plain(a), 1: add_plain, 2: add_relu_plain}


#: Kernels 19 and 20 (elementwise.py:29, :53): ``csrc/elementwise.cu``'s
#: ``elementwise``, ``op`` 0 relu, 1 add, 2 add_relu; counted under that name.
ELEMENTWISE = _build.kernel_op(
    "elementwise", "(int op, Tensor a, Tensor? b) -> Tensor",
    plain=lambda op, a, b: _PLAIN[op](a, b),
    fake=lambda op, a, b: torch.empty_like(a),
)


def _call(op: str, a: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    if a.dtype not in _KIND:
        raise ValueError(f"dtype {a.dtype}, expected bf16 or fp32")
    a = a.contiguous()
    if b is not None:
        b = b.contiguous()
        _build.require(b, "b", a.dtype, a.device)
    if a.numel() == 0:
        return torch.empty_like(a)
    return _build.call(op, ELEMENTWISE, _OPS[op], a, b)


def relu(x: torch.Tensor, *, interpret: bool = False) -> torch.Tensor:
    """max(x, 0), any shape, bf16 / fp32."""
    if _build.runs_plain():
        return relu_plain(x)
    return _call("relu", x, None)


def add(a: torch.Tensor, b: torch.Tensor, *, interpret: bool = False) -> torch.Tensor:
    """a + b, two tensors of one shape and type (bf16 / fp32)."""
    if _build.runs_plain():
        return add_plain(a, b)
    _check_pair(a, b)
    return _call("add", a, b)


def add_relu(a: torch.Tensor, b: torch.Tensor, *, interpret: bool = False) -> torch.Tensor:
    """max(a + b, 0): the residual join in one pass."""
    if _build.runs_plain():
        return add_relu_plain(a, b)
    _check_pair(a, b)
    return _call("add_relu", a, b)
