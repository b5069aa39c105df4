"""Symmetric int8 quantization and the int8 GEMM of the ``int8`` backend.

Counterpart of ``resnetc_tpu/ops/pallas/quant.py``: weights per output
channel, activations per tensor (``quantize_per_tensor``, a dynamic absmax
over the whole batch) or with a static calibrated scale, round half to even
and clipped to +-127; ``quantize_folded`` turns a BN-folded tree into the
``int8`` backend's tree, the JAX package's tree exactly.  One kernel:

- ``int8_matmul`` (quant.py:78) — ``relu?(dequant(x_q @ w_q) + bias +
  residual)``, CUDA C++ in ``resnetc_tpu_torch/csrc/int8_gemm.cu``: a
  wgmma tile on Hopper's int8 tensor cores (exact int32 sums, split-K over
  an int32 workspace at the fc), with ``int8_matmul_plain`` beside it.
  8-bit wgmma reads both operands K-major, so the kernel takes the weight
  as an (N, K) copy: ``pack_kmajor`` adds one (``"w_nk"``) beside every
  ``"w_q"`` of a tree, once, and the ``int8`` engine serves the packed
  tree; without it the wrapper transposes per call.  ``conv1x1_int8``
  (quant.py:163) is a 1x1 convolution through it.

Also home of the exact arithmetic the plain versions share (``_idot``,
``_fma``).  The TPU argument ``interpret`` is accepted and ignored.
"""

from __future__ import annotations

import torch

from resnetc_tpu_torch.ops.cuda import _build

def quantize_per_channel(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp weights (K, N) -> (int8 (K, N), per-column scale (N,) f32)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=0)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale[None, :]), -127, 127).to(torch.int8)
    return q, scale


def quantize_per_tensor(x: torch.Tensor, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """fp activations -> (int8, 0-d f32 scale): absmax over the whole tensor
    (so over the whole batch), scale 1 for an all-zero tensor.  With a
    process ``group`` (a data axis), the absmax is the ``MAX`` all-reduce of
    every rank's, so that each rank quantizes its slice of the global batch
    at the global batch's scale, as the JAX backend's one program does."""
    xf = x.float()
    absmax = xf.abs().max()
    if group is not None:
        import torch.distributed as dist

        absmax = absmax.reshape(1)
        dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
        absmax = absmax.reshape(())
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_with_scale(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Static-scale symmetric int8 quantization."""
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8)


# ---------------------------------------------------------------------------
# Exact arithmetic of the plain versions
# ---------------------------------------------------------------------------


def _idot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8-valued operands: a float64 matmul
    (exact: |sum| < 2**53; PyTorch has no int32 matmul on the card), then
    int32."""
    return torch.matmul(a.to(torch.float64), w.to(torch.float64)).to(torch.int32)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 a*b + c with ONE rounding.  The Pallas epilogues write each
    ``a*b + c`` as two ops, but XLA fuses every such pair into a fused
    multiply-add (CPU backend, where the tests run the Pallas kernels), so
    this is the order of operations the port matches; the CUDA kernels use
    __fmaf_rn.  Computed in float64, where the product of two fp32 values is
    exact; the sum is rounded to odd (its error term, from TwoSum, sets the
    last bit), so rounding it on to fp32 rounds only once."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.nextafter(s, torch.copysign(torch.full_like(s, float("inf")), err))
    return torch.where((err != 0) & even, away, s).float()


# ---------------------------------------------------------------------------
# Kernel 12: int8_matmul
# ---------------------------------------------------------------------------


def _check_kmajor(w_nk: torch.Tensor, k: int, n: int) -> None:
    if tuple(w_nk.shape) != (n, k):
        raise ValueError(f"w_nk: shape {tuple(w_nk.shape)}, expected the (N, K) = {(n, k)} "
                         "copy of w_q")


def int8_matmul_plain(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    scale_x: torch.Tensor,
    scale_w: torch.Tensor,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    *,
    relu: bool = False,
    out_dtype: torch.dtype = torch.bfloat16,
    w_nk: torch.Tensor | None = None,
    interpret: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of ``int8_matmul``: the exact int32 dot (over
    ``w_nk``, the (N, K) copy of ``w_q``, where given), then the Pallas
    epilogue as XLA evaluates it (quant.py:64-71): ``scale = sx * sw``
    rounded on its own, ``acc * scale + bias`` one fma (with no bias, ``acc
    * scale + residual`` is the fma), + residual, relu, cast."""
    if w_nk is not None:
        _check_kmajor(w_nk, *w_q.shape)
        w_q = w_nk.t()
    acc = _idot(x_q, w_q).float()
    scale = torch.as_tensor(scale_x, device=acc.device).float() * scale_w.float()
    if bias is not None:
        out = _fma(acc, scale, bias.float())
        if residual is not None:
            out = out + residual.float()
    elif residual is not None:
        out = _fma(acc, scale, residual.float())
    else:
        out = acc * scale
    if relu:
        out = torch.relu(out)
    return out.to(out_dtype)


def _out_dtype(out_bf16: bool) -> torch.dtype:
    return torch.bfloat16 if out_bf16 else torch.float32


def _int8_gemm_plain(x, w_nk, scale_x, scale_w, bias, residual, relu, out_bf16):
    return int8_matmul_plain(x, w_nk.t(), scale_x, scale_w, bias, residual, relu=relu,
                             out_dtype=_out_dtype(out_bf16))


def _int8_gemm_fake(x, w_nk, scale_x, scale_w, bias, residual, relu, out_bf16):
    return x.new_empty((x.shape[0], w_nk.shape[0]), dtype=_out_dtype(out_bf16))


#: Kernel 12 (quant.py:78): ``csrc/int8_gemm.cu``'s ``int8_gemm``.
INT8_GEMM = _build.kernel_op(
    "int8_gemm",
    "(Tensor x, Tensor w_nk, Tensor scale_x, Tensor scale_w, Tensor? bias, Tensor? residual, "
    "bool relu, bool out_bf16) -> Tensor",
    plain=_int8_gemm_plain, fake=_int8_gemm_fake,
)


def int8_matmul(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    scale_x: torch.Tensor,
    scale_w: torch.Tensor,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    *,
    relu: bool = False,
    out_dtype: torch.dtype = torch.bfloat16,
    w_nk: torch.Tensor | None = None,
    interpret: bool = False,
) -> torch.Tensor:
    """``relu(dequant(x_q @ w_q) + bias + residual)`` with an exact int32
    accumulation.  x_q (M, K) int8; w_q (K, N) int8; scale_x a scalar
    tensor; scale_w, bias (N,) f32; residual (M, N) bf16 or f32; out bf16
    or f32.  ``w_nk``: the (N, K) contiguous copy of w_q (``pack_kmajor``)
    that the kernel reads; without it, each call transposes w_q first.
    One launch of the counter per call, the split-K sum included."""
    m, k = x_q.shape
    k2, n = w_q.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(x_q.shape)} @ {tuple(w_q.shape)}")
    if _build.runs_plain():
        return int8_matmul_plain(x_q, w_q, scale_x, scale_w, bias, residual,
                                 relu=relu, out_dtype=out_dtype, w_nk=w_nk)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {out_dtype}, expected bf16 or fp32")
    dev = x_q.device
    if w_nk is None:
        w_nk = w_q.t().contiguous()
    _check_kmajor(w_nk, k, n)
    x_q = x_q.contiguous()
    _build.require(x_q, "x_q", torch.int8, dev)
    _build.require(w_nk, "w_nk", torch.int8, dev)
    sx = torch.as_tensor(scale_x, dtype=torch.float32, device=dev).reshape(1).contiguous()
    sw = scale_w.float().contiguous()
    _build.require(sw, "scale_w", torch.float32, dev, (n,))
    if bias is not None:
        bias = bias.float().contiguous()
        _build.require(bias, "bias", torch.float32, dev, (n,))
    if residual is not None:
        if residual.dtype not in (torch.bfloat16, torch.float32):
            residual = residual.float()
        residual = residual.contiguous()
        _build.require(residual, "residual", residual.dtype, dev, (m, n))
    return _build.call("int8_matmul", INT8_GEMM,
        x_q, w_nk, sx, sw, bias, residual, relu, out_dtype == torch.bfloat16)


def conv1x1_int8(
    x: torch.Tensor,
    w_q: torch.Tensor,
    scale_w: torch.Tensor,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    *,
    stride: int = 1,
    relu: bool = False,
    out_dtype: torch.dtype = torch.bfloat16,
    w_nk: torch.Tensor | None = None,
    interpret: bool = False,
    matmul_fn=int8_matmul,
    group=None,
) -> torch.Tensor:
    """Dynamically quantized 1x1 conv: quantize the activations per tensor
    (over ``group``'s global batch, ``quantize_per_tensor``), then the int8
    GEMM (``matmul_fn``: ``int8_matmul``, or its plain version).  x (B, H,
    W, Cin) float NHWC; w_q (Cin, Cout) int8; scale_w (Cout,); w_nk the
    (Cout, Cin) copy of w_q, where the tree has one."""
    if stride > 1:
        x = x[:, ::stride, ::stride, :]
    b, h, w_sp, cin = x.shape
    cout = w_q.shape[-1]
    x_q, scale_x = quantize_per_tensor(x, group)
    res2d = residual.reshape(b * h * w_sp, cout) if residual is not None else None
    out = matmul_fn(
        x_q.reshape(b * h * w_sp, cin), w_q, scale_x, scale_w, bias, res2d,
        relu=relu, out_dtype=out_dtype, w_nk=w_nk,
    )
    return out.reshape(b, h, w_sp, cout)


def quantize_folded(folded: dict) -> dict:
    """Quantize a BN-folded tree for the ``int8`` backend: every 1x1 conv
    and the fc become {"w_q" int8 (Cin, Cout), "scale_w" (Cout,), "bias"};
    the 3x3 / 7x7 entries keep their fp weights."""

    def walk(node):
        if isinstance(node, dict) and "weight" in node and "bias" in node:
            w = node["weight"]
            if w.ndim == 4 and tuple(w.shape[:2]) == (1, 1):
                w_q, scale = quantize_per_channel(w[0, 0])
                return {"w_q": w_q, "scale_w": scale, "bias": node["bias"]}
            if w.ndim == 2:  # fc [out, in] -> (in, out)
                w_q, scale = quantize_per_channel(w.t().contiguous())
                return {"w_q": w_q, "scale_w": scale, "bias": node["bias"]}
            return dict(node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(folded)


def pack_kmajor(qtree: dict) -> dict:
    """A copy of a ``quantize_folded`` tree with ``"w_nk"``, the contiguous
    (N, K) copy of ``"w_q"``, beside every ``"w_q"``: the operand order that
    ``int8_matmul``'s kernel reads (8-bit wgmma takes both operands
    K-major), made once per engine instead of once per call.  The other
    leaves are shared, not copied."""

    def walk(node):
        if isinstance(node, dict) and "w_q" in node:
            return {**node, "w_nk": node["w_q"].t().contiguous()}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(qtree)
