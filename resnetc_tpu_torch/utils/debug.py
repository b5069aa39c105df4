"""Debugging aids: NaN trapping, the kernels' plain versions on the card,
activation dumps.

Counterpart of ``resnetc_tpu/utils/debug.py``.  The reference debugs by a
device sync and an error check after every launch (cuda/nn.cu:14 et al.)
and a manual dump loop (SURVEY.md §5).  Here:

- ``nan_debug()`` raises at the first operation whose output holds a NaN
  (JAX's ``jax_debug_nans``): torch's operations and the kernels' ops
  (``resnetc::``, ``ops.cuda._build.kernel_op``) through a dispatch mode,
  and each kernel's output also where it is launched
  (``ops.cuda._build.launched``), which names the kernel.  It
  synchronises after every operation: debugging only;
- ``plain_kernels()`` (alias ``interpret_kernels``, JAX's name for its
  Pallas interpret mode): inside it every ``ops.cuda`` wrapper runs its
  plain PyTorch version, on the card too, and launches nothing — a whole
  forward through the plain versions without threading ``kernels=`` through
  it;
- ``dump_activation`` / ``load_activation``: the reference's raw-f32 dump
  format (Tensor::save), byte for byte the JAX package's files.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from resnetc_tpu_torch.ops.cuda import _build

#: Operations whose output is uninitialized memory (checked by the op that
#: fills it).
_UNINITIALIZED = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
                  torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided}


class _NanMode(TorchDispatchMode):
    """Check every floating output of every torch operation for NaN.  Views
    and uninitialized allocations are skipped: their values come from the
    operation that wrote them."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in _UNINITIALIZED or any(
                r.alias_info is not None and not r.alias_info.is_write
                for r in func._schema.returns):  # a view
            return out
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"{func}: the output holds a NaN")
        return out


@contextlib.contextmanager
def nan_debug():
    """Raise ``FloatingPointError`` at the first operation (torch's or a
    kernel's) that produces a NaN."""
    prev = _build.SWITCHES.nan_check
    _build.SWITCHES.nan_check = True
    try:
        with _NanMode():
            yield
    finally:
        _build.SWITCHES.nan_check = prev


@contextlib.contextmanager
def plain_kernels():
    """Run every ``ops.cuda`` wrapper's plain PyTorch version, on the card
    too: no kernel is launched (or counted) inside.  Only the calling
    thread is affected; other threads go on launching the kernels."""
    _build.SWITCHES.plain_depth += 1
    try:
        yield
    finally:
        _build.SWITCHES.plain_depth -= 1


interpret_kernels = plain_kernels


def dump_activation(x, path: str, *, layout: str = "NHWC") -> None:
    """Write an activation as the reference's raw-f32 dump format
    (Tensor::save, cuda/tensor.cuh:154-163) so check_out-style comparison
    tools can read it.  The file is always NCHW (the reference world's
    layout); pass layout="NCHW" if x already is.  ``x``: a tensor (any
    device) or an array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    arr = np.asarray(x, dtype=np.float32)
    if arr.ndim == 4 and layout == "NHWC":
        arr = arr.transpose(0, 3, 1, 2)
    elif layout not in ("NHWC", "NCHW"):
        raise ValueError(f"layout must be 'NHWC' or 'NCHW', got {layout!r}")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    arr.astype("<f4").tofile(path)


def load_activation(path: str, shape: tuple[int, ...]) -> np.ndarray:
    """Read a raw-f32 dump (ours or the reference's) with a caller-supplied
    shape — the same headerless contract as the weight files."""
    raw = np.fromfile(path, dtype="<f4")
    expected = int(np.prod(shape))
    if raw.size != expected:
        raise ValueError(f"{path}: {raw.size} elems, expected {expected} for {shape}")
    return raw.reshape(shape)
