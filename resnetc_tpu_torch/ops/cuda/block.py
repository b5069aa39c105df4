"""Residual blocks over the chained padded-row layout.

Counterpart of ``resnetc_tpu/ops/pallas/block.py``: the layout helpers
(``chain_meta``, ``pad_for_chain``, ``unpad_from_chain``), weight
quantization (``quantize_chain_block``, ``quantize_ds_block``,
``quantize_basic_block``, ``quantize_basic_ds_block``) and twelve kernels,
each with its plain PyTorch version beside it.  The int8_chain path's
bottleneck family (CUDA in ``resnetc_tpu_torch/csrc/chain_block.cu``):

- ``bottleneck_block_chained_int8``  (block.py:718) — one stride-1 block;
- ``bottleneck_run_chained_int8``    (block.py:2908) — a run of N blocks;
- ``downsample_block_s2_int8``       (block.py:3460) — the stride-2
  transition.

The basic family, ResNet-18/34 (CUDA in ``csrc/basic_block.cu``):

- ``basic_block_chained_int8``       (block.py:1646) — one stride-1 block;
- ``basic_run_chained_int8``         (block.py:1830) — a run of N blocks;
- ``basic_ds_block_s2_int8``         (block.py:2542) — the stride-2
  transition.

The pixel-paired twins for stage 0 at c = 64 (CUDA in ``csrc/pp_block.cu``;
see the section comment below): ``bottleneck_block_chained_int8_pp``
(block.py:1113), ``bottleneck_run_chained_int8_pp`` (:1387),
``basic_block_chained_int8_pp`` (:2002) and ``basic_run_chained_int8_pp``
(:2175).

Every int8 block kernel (the stride-1 blocks of both families and their
runs, the two transitions, the four pixel-paired kernels) runs on the int8
tensor-core tile of ``csrc/chain_tile.cuh`` (its header gives the design
and what bounds it).

The bf16 / fp32 stride-1 bottleneck of the ``pallas_block`` backend and the
op library (CUDA in ``csrc/fp_block.cu``, one piece of code for both; see
the section comment below): ``bottleneck_block_chained`` (block.py:278),
over the chain layout, and ``bottleneck_block_fused`` (:3688), NHWC in and
out.
  A wrapper runs the plain version when
its input lies on the CPU, and launches the kernel for a CUDA tensor, or
raises; there is no fallback.  The scalar requant scales are folded into
per-channel vectors exactly as the JAX wrapper does (block.py:789-797,
822-823, 2966-2980, 3545-3554, 1684-1690, 1866-1879, 2631-2641): by the
wrapper (the pixel-paired basic kernels), or by the kernel itself op for
op, so the kernel and the plain version see identical constants.

Chain ring rows carry no meaning (the JAX kernels leave garbage there); the
port writes zeros, and the tests compare interiors only.  The TPU
scheduling arguments (``bt``, ``interpret``, ``manual_dma``, ``pipe_dma``,
``conv2_chunked``, ``pair_dma``, ``onedot``, ``pipe_out``) are accepted and
ignored.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from resnetc_tpu_torch.ops.cuda import _build
from resnetc_tpu_torch.ops.cuda.quant import _fma, _idot, quantize_per_channel

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------


def chain_meta(b: int, h: int, w_sp: int) -> tuple[int, int]:
    """(hp, wp) of the chained padded-row layout for (B, H, W, C) inputs:
    wp = round_up(w+2, 8), or w+1 when w+1 is already a multiple of 8 (the
    right pad column is then the next row's left pad column)."""
    w2 = w_sp + 1 if (w_sp + 1) % 8 == 0 else _round_up(w_sp + 2, 8)
    return h + 2, w2


def pad_for_chain(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> flat zero-ring padded rows (B*Hp*Wp, C)."""
    b, h, w_sp, c = x.shape
    hp, wp = chain_meta(b, h, w_sp)
    x_pad = F.pad(x, (0, 0, 1, wp - w_sp - 1, 1, 1))
    return x_pad.reshape(b * hp * wp, c)


def unpad_from_chain(xr: torch.Tensor, b: int, h: int, w_sp: int) -> torch.Tensor:
    """Flat padded rows -> NHWC interior (a view)."""
    hp, wp = chain_meta(b, h, w_sp)
    return xr.reshape(b, hp, wp, xr.shape[-1])[:, 1 : 1 + h, 1 : 1 + w_sp, :]


def _chain_from_interior(y: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """(B, h, w, C) interior -> zero-ring chain rows (B*hp*wp, C)."""
    b, h, w_sp, c = y.shape
    out = torch.zeros((b, hp, wp, c), dtype=y.dtype, device=y.device)
    out[:, 1 : 1 + h, 1 : 1 + w_sp] = y
    return out.reshape(b * hp * wp, c)


# ---------------------------------------------------------------------------
# Weight quantization
# ---------------------------------------------------------------------------


def _as_1x1(w: torch.Tensor) -> torch.Tensor:
    return w[0, 0] if w.ndim == 4 else w


def _pack_kh(w: torch.Tensor) -> torch.Tensor:
    """HWIO 3x3 (3, 3, cin, c) -> kh-batched (kw, k) x (kh, j): (3cin, 3c)."""
    return w.permute(1, 2, 0, 3).reshape(3 * w.shape[2], 3 * w.shape[3])


def quantize_chain_block(blk: dict) -> dict:
    """Quantize one BN-folded stride-1 bottleneck block: per-output-channel
    int8, with conv2 packed kh-batched ((kw, k) rows x (kh, j) columns) and
    its scales per (kh, j) column (block.py:3657)."""
    w1 = _as_1x1(blk["conv1"]["weight"])
    w2 = blk["conv2"]["weight"]
    w3 = _as_1x1(blk["conv3"]["weight"])
    w1q, sw1 = quantize_per_channel(w1)
    w2pq, sw2p = quantize_per_channel(_pack_kh(w2))
    w3q, sw3 = quantize_per_channel(w3)
    return {
        "w1q": w1q, "sw1": sw1, "b1": blk["conv1"]["bias"],
        "w2pq": w2pq, "sw2p": sw2p, "b2": blk["conv2"]["bias"],
        "w3q": w3q, "sw3": sw3, "b3": blk["conv3"]["bias"],
    }


def quantize_ds_block(blk: dict) -> dict:
    """Quantize one BN-folded stride-2 downsample block: conv2 with JOINT
    per-output-channel scales over the nine taps (block.py:3627)."""
    w1 = _as_1x1(blk["conv1"]["weight"])
    w2 = blk["conv2"]["weight"]
    w3 = _as_1x1(blk["conv3"]["weight"])
    wd = _as_1x1(blk["downsample"]["weight"])
    c = w1.shape[-1]
    w2q_flat, sw2 = quantize_per_channel(w2.reshape(9 * c, c))
    w1q, sw1 = quantize_per_channel(w1)
    w3q, sw3 = quantize_per_channel(w3)
    wdq, swd = quantize_per_channel(wd)
    return {
        "w1q": w1q, "sw1": sw1, "b1": blk["conv1"]["bias"],
        "w2q": w2q_flat.reshape(3, 3, c, c), "sw2": sw2, "b2": blk["conv2"]["bias"],
        "w3q": w3q, "sw3": sw3, "b3": blk["conv3"]["bias"],
        "wdq": wdq, "swd": swd, "bd": blk["downsample"]["bias"],
    }


def quantize_basic_block(blk: dict) -> dict:
    """Quantize one BN-folded stride-1 BasicBlock: both 3x3s kh-batched,
    with scales per (kh, j) column (block.py:2277)."""
    out = {}
    for key in ("1", "2"):
        conv = blk[f"conv{key}"]
        out[f"w{key}pq"], out[f"sw{key}p"] = quantize_per_channel(_pack_kh(conv["weight"]))
        out[f"b{key}"] = conv["bias"]
    return out


def quantize_basic_ds_block(blk: dict) -> dict:
    """Quantize one BN-folded stride-2 BasicBlock (block.py:2690): conv1
    with JOINT per-output-channel scales over its nine taps, packed
    (3, 4cin, c) — for kernel row u, rows [0, 3cin) are its (kw, k) taps
    and [3cin, 4cin) zero; conv2 kh-batched; the 1x1/2 projection per
    output channel.  The folded fp entries stay beside them, as in JAX."""
    w1 = blk["conv1"]["weight"]
    _, _, cin, c = w1.shape
    w1q, sw1 = quantize_per_channel(w1.reshape(9 * cin, c))
    w1pq = torch.cat(
        [w1q.reshape(3, 3 * cin, c), torch.zeros((3, cin, c), dtype=torch.int8, device=w1.device)],
        dim=1,
    )
    w2pq, sw2p = quantize_per_channel(_pack_kh(blk["conv2"]["weight"]))
    wdq, swd = quantize_per_channel(_as_1x1(blk["downsample"]["weight"]))
    out = {
        "w1pq": w1pq, "sw1": sw1, "b1": blk["conv1"]["bias"],
        "w2pq": w2pq, "sw2p": sw2p, "b2": blk["conv2"]["bias"],
        "wdq": wdq, "swd": swd, "bd": blk["downsample"]["bias"],
    }
    out.update({k: blk[k] for k in ("conv1", "conv2", "downsample")})
    return out


# ---------------------------------------------------------------------------
# Plain arithmetic shared by the plain versions
# ---------------------------------------------------------------------------


def _requant(v: torch.Tensor) -> torch.Tensor:
    """Round half to even, clip to +-127, int8."""
    return torch.clamp(torch.round(v), -127.0, 127.0).to(torch.int8)


def _kh3(z: torch.Tensor, wpq: torch.Tensor, a: torch.Tensor, h: int, w_sp: int) -> torch.Tensor:
    """The kh-batched 3x3/1 over a zero-padded (B, h, w, c) int8 interior:
    ((P0*a[0] + P1*a[1]) + P2*a[2]), one exact int32 sum P_kh per kernel
    row, each with its own per-(kh, j) scale (block.py:1584-1593).  wpq is
    the (kw, k) x (kh, j) packing; a is (3, n).  XLA fuses the sum as
    fma(P2, a2, fma(P0, a0, P1*a1))."""
    n = wpq.shape[1] // 3
    zp = F.pad(z, (0, 0, 1, 1, 1, 1))
    p = []
    for kh in range(3):
        taps = torch.cat([zp[:, kh : kh + h, kw : kw + w_sp] for kw in range(3)], dim=-1)
        p.append(_idot(taps, wpq[:, kh * n : (kh + 1) * n]).float())
    return _fma(p[2], a[2], _fma(p[0], a[0], p[1] * a[1]))


def _check_i8(dev, **tensors):
    """Validate the int8 operands a kernel reads (their alignment to 32-bit
    words is checked where the kernel launches, in its op)."""
    for name, t in tensors.items():
        if t is not None:
            _build.require(t, name, torch.int8, dev)


def _f32_vectors(dev, **vectors) -> dict:
    """fp32 contiguous copies (no copy where they already are) of the
    per-channel vectors a kernel folds itself, each checked against its
    length (or shape, for a stack); an absent one stays None."""
    out = {}
    for name, item in vectors.items():
        if item is None:
            out[name] = None
            continue
        t, n = item
        t = t.float().contiguous()
        _build.require(t, name, torch.float32, dev, n if isinstance(n, tuple) else (n,))
        out[name] = t
    return out


def _out_dtype(out_kind: int) -> torch.dtype:
    """The dtype of a block kernel's output: 0 int8, 1 bf16, 2 fp32 (the
    head fold's per-image means)."""
    return (torch.int8, torch.bfloat16, torch.float32)[out_kind]


def _kind(emit_i8: bool) -> int:
    return 0 if emit_i8 else 1


def _one(ref: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=torch.float32, device=ref.device)


# ---------------------------------------------------------------------------
# Kernel 1: one stride-1 bottleneck block
# ---------------------------------------------------------------------------


def _fold_block(scales, sw1, b1, sw2p, b2, sw3, b3, swd, bd, emit_i8):
    """Host-side scale folding of block.py:789-797 and 822-823, op for op."""
    s_x, s_z1, s_z2 = scales[0], scales[1], scales[2]
    s_y = scales[3] if emit_i8 else _one(scales)
    c = sw1.shape[-1]
    f = {
        "a1": sw1.float() * (s_x / s_z1),
        "c1": b1.float() * (1.0 / s_z1),
        "a2": (sw2p.float() * (s_z1 / s_z2)).reshape(3, c),
        "c2": b2.float() * (1.0 / s_z2),
        "a3": sw3.float() * (s_z2 / s_y),
        "c3": b3.float() * (1.0 / s_y),
        "s_res": (s_x / s_y).float().reshape(1),
        "ad": None,
        "cd": None,
    }
    if swd is not None:
        f["ad"] = swd.float() * (s_x / s_y)
        f["cd"] = bd.float() * (1.0 / s_y)
    return f


def _block_geometry(xq, w1q, w3q, wdq, h, w_sp, emit_i8, emit_mean):
    cin, c = w1q.shape
    c4 = w3q.shape[-1]
    if wdq is None and cin != c4:
        raise ValueError(f"identity shortcut needs cin == 4c, got {cin} vs {c4}")
    if emit_mean and emit_i8:
        raise ValueError("emit_mean is the bf16-exit head fold; pass emit_i8=False")
    hp, wp = chain_meta(0, h, w_sp)
    rows, cin_in = xq.shape
    b = rows // (hp * wp)
    if b * hp * wp != rows or cin_in != cin:
        raise ValueError(f"xq {tuple(xq.shape)} is not a ({hp}x{wp}) chain of {cin} channels")
    return b, hp, wp, cin, c, c4


def _inv_hw(h: int, w_sp: int) -> float:
    # The JAX head fold multiplies by the f32 value mask / (h*w).
    return float(np.float32(1.0) / np.float32(h * w_sp))


def _block_plain_folded(xq, b, h, w_sp, hp, wp, w1q, w2pq, w3q, wdq, f, *,
                        emit_i8, emit_mean):
    cin = xq.shape[1]
    x = xq.reshape(b, hp, wp, cin)[:, 1 : 1 + h, 1 : 1 + w_sp]
    z1 = _requant(torch.relu(_fma(_idot(x, w1q).float(), f["a1"], f["c1"])))
    z2 = _requant(torch.relu(_kh3(z1, w2pq, f["a2"], h, w_sp) + f["c2"]))
    y = _fma(_idot(z2, w3q).float(), f["a3"], f["c3"])
    if wdq is None:
        y = _fma(x.float(), f["s_res"], y)
    else:
        y = y + _fma(_idot(x, wdq).float(), f["ad"], f["cd"])
    y = torch.relu(y)
    if emit_mean:
        return (y * _inv_hw(h, w_sp)).sum(dim=(1, 2))
    return _chain_from_interior(_requant(y) if emit_i8 else y.to(torch.bfloat16), hp, wp)


def _from_kmajor(w, w_nk):
    """The (..., K, N) weight, read from its K-major (..., N, K) copy where
    one is given (checked against the original's shape)."""
    if w_nk is None:
        return w
    if w is not None and tuple(w_nk.shape) != tuple(w.transpose(-1, -2).shape):
        raise ValueError(f"K-major copy of shape {tuple(w_nk.shape)} for a "
                         f"{tuple(w.shape)} weight")
    return w_nk.transpose(-1, -2)


def _kmajor(w, w_nk, name, dev):
    """The K-major (N, K) copy the int8 tile reads: ``w_nk`` as given (the
    engine's, ``pack_chain_kmajor``), else ``w`` transposed for this call.
    Stacked weights (..., K, N) transpose their last two dimensions."""
    if w is None:
        return None
    if w_nk is None:
        w_nk = w.transpose(-1, -2).contiguous()
    if tuple(w_nk.shape) != tuple(w.shape[:-2]) + (w.shape[-1], w.shape[-2]):
        raise ValueError(f"{name}: shape {tuple(w_nk.shape)} is not the K-major copy of "
                         f"{tuple(w.shape)}")
    _check_i8(dev, **{name: w_nk})
    return w_nk


def bottleneck_block_chained_int8_plain(
    xq, w1q, sw1, b1, w2pq, sw2p, b2, w3q, sw3, b3, scales, *,
    h, w_sp, emit_i8=True, bt=None, interpret=False, manual_dma=False,
    emit_mean=False, conv2_chunked=False, pipe_dma=False,
    wdq=None, swd=None, bd=None,
    w1q_nk=None, w2pq_nk=None, w3q_nk=None, wdq_nk=None,
):
    """Plain PyTorch version of ``bottleneck_block_chained_int8`` (the
    weights read from their K-major copies where given)."""
    w1q, w2pq = _from_kmajor(w1q, w1q_nk), _from_kmajor(w2pq, w2pq_nk)
    w3q, wdq = _from_kmajor(w3q, w3q_nk), _from_kmajor(wdq, wdq_nk)
    b, hp, wp, _, _, _ = _block_geometry(xq, w1q, w3q, wdq, h, w_sp, emit_i8, emit_mean)
    f = _fold_block(scales, sw1, b1, sw2p, b2, sw3, b3, swd, bd, emit_i8)
    return _block_plain_folded(xq, b, h, w_sp, hp, wp, w1q, w2pq, w3q, wdq, f,
                               emit_i8=emit_i8, emit_mean=emit_mean)


def bottleneck_block_chained_int8(
    xq, w1q, sw1, b1, w2pq, sw2p, b2, w3q, sw3, b3, scales, *,
    h, w_sp, emit_i8=True, bt=None, interpret=False, manual_dma=False,
    emit_mean=False, conv2_chunked=False, pipe_dma=False,
    wdq=None, swd=None, bd=None,
    w1q_nk=None, w2pq_nk=None, w3q_nk=None, wdq_nk=None,
):
    """Int8 stride-1 bottleneck block over the chained padded-row layout.

    xq: (B*Hp*Wp, cin) int8 chain at scale scales[0]; w1q (cin, c), w2pq
    (3c, 3c) kh-batched, w3q (c, 4c) int8 with per-column scales; biases
    f32; scales (4,) = [s_x, s_z1, s_z2, s_y].  With wdq/swd/bd the
    shortcut is the 1x1 projection instead of identity.  Returns the same
    chain layout, int8 at s_y (emit_i8) or unscaled bf16; or with emit_mean
    the (B, 4c) f32 per-image interior means (the head fold).

    ``w1q_nk`` ... ``wdq_nk``: the K-major (N, K) copies of the weights that
    the int8 tensor-core tile reads (8-bit wgmma takes both operands
    K-major), made once per engine by ``fused.pack_chain_kmajor``; without
    them the wrapper transposes once per call.
    """
    if _build.runs_plain():
        return bottleneck_block_chained_int8_plain(
            xq, w1q, sw1, b1, w2pq, sw2p, b2, w3q, sw3, b3, scales,
            h=h, w_sp=w_sp, emit_i8=emit_i8, emit_mean=emit_mean,
            wdq=wdq, swd=swd, bd=bd,
            w1q_nk=w1q_nk, w2pq_nk=w2pq_nk, w3q_nk=w3q_nk, wdq_nk=wdq_nk,
        )
    b, hp, wp, cin, c, c4 = _block_geometry(xq, w1q, w3q, wdq, h, w_sp, emit_i8, emit_mean)
    dev = xq.device
    _check_i8(dev, xq=xq, w1q=w1q, w2pq=w2pq, w3q=w3q, wdq=wdq)
    if cin % 4 or c % 4:
        raise ValueError(f"channel counts must be multiples of 4, got cin={cin}, c={c}")
    # The kernel folds the scales itself (as _fold_block does, op for op).
    v = _f32_vectors(dev, sw1=(sw1, c), b1=(b1, c), sw2p=(sw2p, 3 * c), b2=(b2, c),
                     sw3=(sw3, c4), b3=(b3, c4), scales=(scales, 4),
                     swd=(swd, c4) if wdq is not None else None,
                     bd=(bd, c4) if wdq is not None else None)
    return _build.call("bottleneck_block_chained_int8", CHAIN_BLOCK_INT8,
        xq, _kmajor(w1q, w1q_nk, "w1q_nk", dev), v["sw1"], v["b1"],
        _kmajor(w2pq, w2pq_nk, "w2pq_nk", dev), v["sw2p"], v["b2"],
        _kmajor(w3q, w3q_nk, "w3q_nk", dev), v["sw3"], v["b3"], v["scales"],
        _kmajor(wdq, wdq_nk, "wdq_nk", dev), v["swd"], v["bd"],
        h, w_sp, 2 if emit_mean else _kind(emit_i8), _inv_hw(h, w_sp),
    )


def _chain_block_plain(x, w1_nk, sw1, b1, w2p_nk, sw2p, b2, w3_nk, sw3, b3, scales,
                       wd_nk, swd, bd, h, w, out_kind, inv_hw):
    return bottleneck_block_chained_int8_plain(
        x, None, sw1, b1, None, sw2p, b2, None, sw3, b3, scales, h=h, w_sp=w,
        emit_i8=out_kind == 0, emit_mean=out_kind == 2, swd=swd, bd=bd,
        w1q_nk=w1_nk, w2pq_nk=w2p_nk, w3q_nk=w3_nk, wdq_nk=wd_nk,
    )


def _chain_block_fake(x, w1_nk, sw1, b1, w2p_nk, sw2p, b2, w3_nk, sw3, b3, scales,
                      wd_nk, swd, bd, h, w, out_kind, inv_hw):
    if out_kind == 2:
        hp, wp = chain_meta(0, h, w)
        return x.new_empty((x.shape[0] // (hp * wp), w3_nk.shape[0]), dtype=torch.float32)
    return x.new_empty((x.shape[0], w3_nk.shape[0]), dtype=_out_dtype(out_kind))


#: Kernel 1 (block.py:718): ``csrc/chain_block.cu``'s ``chain_block_int8``;
#: ``out_kind`` 0 int8, 1 bf16, 2 the head fold's fp32 means.
CHAIN_BLOCK_INT8 = _build.kernel_op(
    "chain_block_int8",
    "(Tensor x, Tensor w1_nk, Tensor sw1, Tensor b1, Tensor w2p_nk, Tensor sw2p, Tensor b2, "
    "Tensor w3_nk, Tensor sw3, Tensor b3, Tensor scales, Tensor? wd_nk, Tensor? swd, "
    "Tensor? bd, int h, int w, int out_kind, float inv_hw) -> Tensor",
    plain=_chain_block_plain, fake=_chain_block_fake,
)


# ---------------------------------------------------------------------------
# Kernel 2: a run of N stride-1 blocks
# ---------------------------------------------------------------------------


def _fold_run(scales_s, sw1_s, b1_s, sw2p_s, b2_s, sw3_s, b3_s, swd, bd, emit_i8):
    """Per-block host folding of block.py:2966-2980 (and 3013-3014)."""
    n_blocks, c = sw1_s.shape
    s_x = scales_s[:, 0]
    s_z1 = scales_s[:, 1]
    s_z2 = scales_s[:, 2]
    s_y = scales_s[:, 3]
    if not emit_i8:  # a device op: a host scalar written in would wait for the card
        s_y = torch.cat([s_y[:-1], torch.ones_like(s_y[-1:])])
    f = {
        "a1": sw1_s.float() * (s_x / s_z1)[:, None],
        "c1": b1_s.float() * (1.0 / s_z1)[:, None],
        "a2": (sw2p_s.float() * (s_z1 / s_z2)[:, None]).reshape(n_blocks * 3, c),
        "c2": b2_s.float() * (1.0 / s_z2)[:, None],
        "a3": sw3_s.float() * (s_z2 / s_y)[:, None],
        "c3": b3_s.float() * (1.0 / s_y)[:, None],
        "s_res": (s_x / s_y).float(),
        "ad": None,
        "cd": None,
    }
    if swd is not None:
        f["ad"] = swd.float() * (s_x[0] / scales_s[0, 3])
        f["cd"] = bd.float() * (1.0 / scales_s[0, 3])
    return f


def _run_geometry(xq, w1q_s, w3q_s, w1q0, wdq, h, w_sp):
    has_proj = w1q0 is not None
    if has_proj:
        n_m1, c4, c = w1q_s.shape
        n_blocks = n_m1 + 1
        cin = w1q0.shape[0]
        if wdq is None or tuple(wdq.shape) != (cin, c4):
            raise ValueError("the projection form needs wdq of shape (cin, 4c)")
    else:
        n_blocks, c4, c = w1q_s.shape
        cin = c4
    if n_blocks < 2 and has_proj:
        raise ValueError("a lone projection block is bottleneck_block_chained_int8's job")
    hp, wp = chain_meta(0, h, w_sp)
    rows, cin_in = xq.shape
    b = rows // (hp * wp)
    if b * hp * wp != rows or cin_in != cin:
        raise ValueError(f"xq {tuple(xq.shape)} is not a ({hp}x{wp}) chain of {cin} channels")
    return n_blocks, b, hp, wp, cin, c, c4


def bottleneck_run_chained_int8_plain(
    xq, w1q_s, sw1_s, b1_s, w2pq_s, sw2p_s, b2_s, w3q_s, sw3_s, b3_s, scales_s, *,
    h, w_sp, emit_i8=True, bt=None, interpret=False, pipe_dma=False,
    w1q0=None, wdq=None, swd=None, bd=None,
    w1q_nk_s=None, w2pq_nk_s=None, w3q_nk_s=None, w1q0_nk=None, wdq_nk=None,
):
    """Plain PyTorch version of ``bottleneck_run_chained_int8`` (the
    weights read from their K-major copies where given)."""
    w1q_s, w2pq_s = _from_kmajor(w1q_s, w1q_nk_s), _from_kmajor(w2pq_s, w2pq_nk_s)
    w3q_s = _from_kmajor(w3q_s, w3q_nk_s)
    w1q0, wdq = _from_kmajor(w1q0, w1q0_nk), _from_kmajor(wdq, wdq_nk)
    n_blocks, b, hp, wp, _, _, _ = _run_geometry(xq, w1q_s, w3q_s, w1q0, wdq, h, w_sp)
    f = _fold_run(scales_s, sw1_s, b1_s, sw2p_s, b2_s, sw3_s, b3_s, swd, bd, emit_i8)
    has_proj = w1q0 is not None
    y = xq
    for n in range(n_blocks):
        last = n == n_blocks - 1
        proj_n = has_proj and n == 0
        w1 = w1q0 if proj_n else w1q_s[n - 1 if has_proj else n]
        fn = {
            "a1": f["a1"][n], "c1": f["c1"][n], "a2": f["a2"][3 * n : 3 * n + 3],
            "c2": f["c2"][n], "a3": f["a3"][n], "c3": f["c3"][n],
            "s_res": f["s_res"][n : n + 1],
            "ad": f["ad"] if proj_n else None, "cd": f["cd"] if proj_n else None,
        }
        y = _block_plain_folded(
            y, b, h, w_sp, hp, wp, w1, w2pq_s[n], w3q_s[n],
            wdq if proj_n else None, fn,
            emit_i8=emit_i8 or not last, emit_mean=False,
        )
    return y


def bottleneck_run_chained_int8(
    xq, w1q_s, sw1_s, b1_s, w2pq_s, sw2p_s, b2_s, w3q_s, sw3_s, b3_s, scales_s, *,
    h, w_sp, emit_i8=True, bt=None, interpret=False, pipe_dma=False,
    w1q0=None, wdq=None, swd=None, bd=None,
    w1q_nk_s=None, w2pq_nk_s=None, w3q_nk_s=None, w1q0_nk=None, wdq_nk=None,
):
    """A run of N stride-1 bottleneck blocks as one call (see the JAX
    wrapper's contract): stacked w1q_s (N, c4, c), sw1_s/b1_s (N, c), w2pq_s
    (N, 3c, 3c), sw2p_s (N, 3c), b2_s (N, c), w3q_s (N, c, c4), sw3_s/b3_s
    (N, c4); scales_s (N, 4) rows [s_x, s_z1, s_z2, s_y].  With w1q0/wdq/
    swd/bd block 0 is the projection block over xq (rows, cin) and w1q_s
    stacks blocks 1..N-1 only.  ``*_nk``: the weights' K-major copies (see
    ``bottleneck_block_chained_int8``), stacked alike."""
    if _build.runs_plain():
        return bottleneck_run_chained_int8_plain(
            xq, w1q_s, sw1_s, b1_s, w2pq_s, sw2p_s, b2_s, w3q_s, sw3_s, b3_s, scales_s,
            h=h, w_sp=w_sp, emit_i8=emit_i8, w1q0=w1q0, wdq=wdq, swd=swd, bd=bd,
            w1q_nk_s=w1q_nk_s, w2pq_nk_s=w2pq_nk_s, w3q_nk_s=w3q_nk_s, w1q0_nk=w1q0_nk,
            wdq_nk=wdq_nk,
        )
    n_blocks, b, hp, wp, cin, c, c4 = _run_geometry(xq, w1q_s, w3q_s, w1q0, wdq, h, w_sp)
    dev = xq.device
    _check_i8(dev, xq=xq, w1q_s=w1q_s, w1q0=w1q0, w2pq_s=w2pq_s, w3q_s=w3q_s, wdq=wdq)
    if cin % 4 or c % 4:
        raise ValueError(f"channel counts must be multiples of 4, got cin={cin}, c={c}")
    # The kernel folds each block's scales itself (as _fold_run does).
    n = n_blocks
    v = _f32_vectors(dev, sw1_s=(sw1_s, (n, c)), b1_s=(b1_s, (n, c)),
                     sw2p_s=(sw2p_s, (n, 3 * c)), b2_s=(b2_s, (n, c)),
                     sw3_s=(sw3_s, (n, c4)), b3_s=(b3_s, (n, c4)), scales_s=(scales_s, (n, 4)),
                     swd=(swd, c4) if wdq is not None else None,
                     bd=(bd, c4) if wdq is not None else None)
    return _build.call("bottleneck_run_chained_int8", CHAIN_RUN_INT8,
        xq, _kmajor(w1q_s, w1q_nk_s, "w1q_nk_s", dev), _kmajor(w1q0, w1q0_nk, "w1q0_nk", dev),
        v["sw1_s"], v["b1_s"], _kmajor(w2pq_s, w2pq_nk_s, "w2pq_nk_s", dev), v["sw2p_s"],
        v["b2_s"], _kmajor(w3q_s, w3q_nk_s, "w3q_nk_s", dev), v["sw3_s"], v["b3_s"],
        v["scales_s"], _kmajor(wdq, wdq_nk, "wdq_nk", dev), v["swd"], v["bd"],
        h, w_sp, not emit_i8,
    )


def _chain_run_plain(x, w1s_nk, w10_nk, sw1s, b1s, w2ps_nk, sw2ps, b2s, w3s_nk, sw3s, b3s,
                     scales_s, wd_nk, swd, bd, h, w, last_bf16):
    return bottleneck_run_chained_int8_plain(
        x, None, sw1s, b1s, None, sw2ps, b2s, None, sw3s, b3s, scales_s, h=h, w_sp=w,
        emit_i8=not last_bf16, swd=swd, bd=bd, w1q_nk_s=w1s_nk, w2pq_nk_s=w2ps_nk,
        w3q_nk_s=w3s_nk, w1q0_nk=w10_nk, wdq_nk=wd_nk,
    )


def _chain_run_fake(x, w1s_nk, w10_nk, sw1s, b1s, w2ps_nk, sw2ps, b2s, w3s_nk, sw3s, b3s,
                    scales_s, wd_nk, swd, bd, h, w, last_bf16):
    return x.new_empty((x.shape[0], w3s_nk.shape[1]), dtype=_out_dtype(int(last_bf16)))


#: Kernel 2 (block.py:2908): ``csrc/chain_block.cu``'s ``chain_run_int8``,
#: the per-block vectors stacked (N, .).
CHAIN_RUN_INT8 = _build.kernel_op(
    "chain_run_int8",
    "(Tensor x, Tensor w1s_nk, Tensor? w10_nk, Tensor sw1s, Tensor b1s, Tensor w2ps_nk, "
    "Tensor sw2ps, Tensor b2s, Tensor w3s_nk, Tensor sw3s, Tensor b3s, Tensor scales_s, "
    "Tensor? wd_nk, Tensor? swd, Tensor? bd, int h, int w, bool last_bf16) -> Tensor",
    plain=_chain_run_plain, fake=_chain_run_fake,
)


# ---------------------------------------------------------------------------
# Kernel 3: the stride-2 transition block
# ---------------------------------------------------------------------------


def _fold_ds(scales, sw1, b1, sw2, b2, sw3, b3, swd, bd, emit_i8):
    """Host-side scale folding of block.py:3545-3554, op for op (the plain
    version's; the kernel folds in its epilogue)."""
    s_x, s_z1, s_z2 = scales[0], scales[1], scales[2]
    s_y = scales[3] if emit_i8 else _one(scales)
    return {
        "a1": sw1.float() * (s_x / s_z1),
        "c1": b1.float() * (1.0 / s_z1),
        "a2": sw2.float() * (s_z1 / s_z2),
        "c2": b2.float() * (1.0 / s_z2),
        "a3": sw3.float() * (s_z2 / s_y),
        "c3": b3.float() * (1.0 / s_y),
        "ad": swd.float() * (s_x / s_y),
        "cd": bd.float() * (1.0 / s_y),
    }


def _ds_geometry(xr, h, w_sp):
    hp, wp = chain_meta(0, h, w_sp)
    rows, cin = xr.shape
    b = rows // (hp * wp)
    if b * hp * wp != rows:
        raise ValueError(f"xr {tuple(xr.shape)} is not a ({hp}x{wp}) chain")
    oh, ow = (h + 1) // 2, (w_sp + 1) // 2
    hp2, wp2 = chain_meta(0, oh, ow)
    return b, hp, wp, cin, oh, ow, hp2, wp2


def _ds_flat(w2q):
    """The transition's 3x3 as its (9c, c) matrix, rows (kh, kw, k)."""
    return w2q.reshape(-1, w2q.shape[-1])


def downsample_block_s2_int8_plain(
    xr, w1q, sw1, b1, w2q, sw2, b2, w3q, sw3, b3, wdq, swd, bd, scales, *,
    h, w_sp, emit_i8=True, bt=None, pair_dma=False, onedot=False,
    pipe_out=False, interpret=False,
    w1q_nk=None, w2q_nk=None, w3q_nk=None, wdq_nk=None,
):
    """Plain PyTorch version of ``downsample_block_s2_int8`` (the weights
    read from their K-major copies where given)."""
    w1q, w3q, wdq = _from_kmajor(w1q, w1q_nk), _from_kmajor(w3q, w3q_nk), _from_kmajor(wdq, wdq_nk)
    w2 = _from_kmajor(None if w2q is None else _ds_flat(w2q), w2q_nk)
    b, hp, wp, cin, oh, ow, hp2, wp2 = _ds_geometry(xr, h, w_sp)
    f = _fold_ds(scales, sw1, b1, sw2, b2, sw3, b3, swd, bd, emit_i8)
    x = xr.reshape(b, hp, wp, cin)[:, 1 : 1 + h, 1 : 1 + w_sp]
    z1 = _requant(torch.relu(_fma(_idot(x, w1q).float(), f["a1"], f["c1"])))
    z1p = F.pad(z1, (0, 0, 1, 1, 1, 1))
    taps = torch.cat(
        [
            z1p[:, u : u + 2 * oh - 1 : 2, v : v + 2 * ow - 1 : 2]
            for u in range(3)
            for v in range(3)
        ],
        dim=-1,
    )
    acc2 = _idot(taps, w2)
    z2 = _requant(torch.relu(_fma(acc2.float(), f["a2"], f["c2"])))
    y = _fma(_idot(z2, w3q).float(), f["a3"], f["c3"])
    y = y + _fma(_idot(x[:, ::2, ::2], wdq).float(), f["ad"], f["cd"])
    y = torch.relu(y)
    return _chain_from_interior(_requant(y) if emit_i8 else y.to(torch.bfloat16), hp2, wp2)


def downsample_block_s2_int8(
    xr, w1q, sw1, b1, w2q, sw2, b2, w3q, sw3, b3, wdq, swd, bd, scales, *,
    h, w_sp, emit_i8=True, bt=None, pair_dma=False, onedot=False,
    pipe_out=False, interpret=False,
    w1q_nk=None, w2q_nk=None, w3q_nk=None, wdq_nk=None,
):
    """Whole stride-2 bottleneck downsample block, chain to chain.

    xr: (B*Hp*Wp, cin) int8 chain of the (h, w_sp) input stage at scale
    scales[0]; weights per ``quantize_ds_block``; scales [s_x, s_z1, s_z2,
    s_y].  Output: the (ceil(h/2), ceil(w_sp/2)) stage's chain, (.., 4c).
    Output pixel (i, j) taps z1 at (2i+u-1, 2j+v-1), zero outside the
    image; the shortcut reads x[2i, 2j].

    ``w1q_nk`` (c, cin), ``w2q_nk`` (c, 9c), ``w3q_nk`` (c4, c), ``wdq_nk``
    (c4, cin): the K-major copies that the int8 tensor-core tile reads,
    made once per engine by ``fused.pack_chain_kmajor``; without them the
    wrapper transposes once per call.  The kernel folds the requant scales
    itself, as ``_fold_ds`` does, op for op.
    """
    kmajor = dict(w1q_nk=w1q_nk, w2q_nk=w2q_nk, w3q_nk=w3q_nk, wdq_nk=wdq_nk)
    if _build.runs_plain():
        return downsample_block_s2_int8_plain(
            xr, w1q, sw1, b1, w2q, sw2, b2, w3q, sw3, b3, wdq, swd, bd, scales,
            h=h, w_sp=w_sp, emit_i8=emit_i8, **kmajor,
        )
    b, hp, wp, cin, oh, ow, hp2, wp2 = _ds_geometry(xr, h, w_sp)
    c = w1q.shape[-1]
    c4 = w3q.shape[-1]
    dev = xr.device
    _check_i8(dev, xr=xr)
    if cin % 4 or c % 4:
        raise ValueError(f"channel counts must be multiples of 4, got cin={cin}, c={c}")
    if tuple(w1q.shape) != (cin, c) or tuple(w2q.shape) != (3, 3, c, c) \
            or tuple(w3q.shape) != (c, c4) or tuple(wdq.shape) != (cin, c4):
        raise ValueError("weights do not match a (cin, c, 4c) transition: "
                         f"{[tuple(w.shape) for w in (w1q, w2q, w3q, wdq)]}")
    v = _f32_vectors(dev, sw1=(sw1, c), b1=(b1, c), sw2=(sw2, c), b2=(b2, c), sw3=(sw3, c4),
                     b3=(b3, c4), swd=(swd, c4), bd=(bd, c4), scales=(scales, 4))
    return _build.call("downsample_block_s2_int8", DS_BLOCK_S2_INT8,
        xr, _kmajor(w1q, w1q_nk, "w1q_nk", dev), v["sw1"], v["b1"],
        _kmajor(_ds_flat(w2q), w2q_nk, "w2q_nk", dev), v["sw2"], v["b2"],
        _kmajor(w3q, w3q_nk, "w3q_nk", dev), v["sw3"], v["b3"],
        _kmajor(wdq, wdq_nk, "wdq_nk", dev), v["swd"], v["bd"], v["scales"],
        h, w_sp, _kind(emit_i8),
    )


def _ds_plain(x, w1_nk, sw1, b1, w2_nk, sw2, b2, w3_nk, sw3, b3, wd_nk, swd, bd, scales,
              h, w, out_kind):
    return downsample_block_s2_int8_plain(
        x, None, sw1, b1, None, sw2, b2, None, sw3, b3, None, swd, bd, scales, h=h, w_sp=w,
        emit_i8=out_kind == 0, w1q_nk=w1_nk, w2q_nk=w2_nk, w3q_nk=w3_nk, wdq_nk=wd_nk,
    )


def _ds_rows(x, h, w) -> int:
    """Rows of a transition's output chain."""
    hp, wp = chain_meta(0, h, w)
    hp2, wp2 = chain_meta(0, (h + 1) // 2, (w + 1) // 2)
    return x.shape[0] // (hp * wp) * hp2 * wp2


def _ds_fake(x, w1_nk, sw1, b1, w2_nk, sw2, b2, w3_nk, sw3, b3, wd_nk, swd, bd, scales,
             h, w, out_kind):
    return x.new_empty((_ds_rows(x, h, w), w3_nk.shape[0]), dtype=_out_dtype(out_kind))


#: Kernel 3 (block.py:3460): ``csrc/chain_block.cu``'s ``ds_block_s2_int8``.
DS_BLOCK_S2_INT8 = _build.kernel_op(
    "ds_block_s2_int8",
    "(Tensor x, Tensor w1_nk, Tensor sw1, Tensor b1, Tensor w2_nk, Tensor sw2, Tensor b2, "
    "Tensor w3_nk, Tensor sw3, Tensor b3, Tensor wd_nk, Tensor swd, Tensor bd, Tensor scales, "
    "int h, int w, int out_kind) -> Tensor",
    plain=_ds_plain, fake=_ds_fake,
)


# ---------------------------------------------------------------------------
# The basic family (ResNet-18/34): csrc/basic_block.cu
# ---------------------------------------------------------------------------


def _fold_basic(scales, sw1p, b1, sw2p, b2, emit_i8):
    """Host-side scale folding of block.py:1684-1690, op for op."""
    s_x, s_z1 = scales[0], scales[1]
    s_y = scales[2] if emit_i8 else _one(scales)
    c = b1.shape[-1]
    return {
        "a1": (sw1p.float() * (s_x / s_z1)).reshape(3, c),
        "c1": b1.float() * (1.0 / s_z1),
        "a2": (sw2p.float() * (s_z1 / s_y)).reshape(3, c),
        "c2": b2.float() * (1.0 / s_y),
        "s_res": (s_x / s_y).float().reshape(1),
    }


def _fold_basic_run(scales_s, sw1p_s, b1_s, sw2p_s, b2_s, emit_i8):
    """Per-block host folding of block.py:1866-1879, op for op (s_y of the
    last block is 1 on a bf16 exit: a device op, no host scalar written
    into a device tensor, which would wait for the card)."""
    n_blocks, c = b1_s.shape
    s_x = scales_s[:, 0]
    s_z1 = scales_s[:, 1]
    s_y = scales_s[:, 2]
    if not emit_i8:
        s_y = torch.cat([s_y[:-1], torch.ones_like(s_y[-1:])])
    return {
        "a1": (sw1p_s.float() * (s_x / s_z1)[:, None]).reshape(n_blocks * 3, c),
        "c1": b1_s.float() * (1.0 / s_z1)[:, None],
        "a2": (sw2p_s.float() * (s_z1 / s_y)[:, None]).reshape(n_blocks * 3, c),
        "c2": b2_s.float() * (1.0 / s_y)[:, None],
        "s_res": (s_x / s_y).float(),
    }


def _basic_geometry(xq, c, h, w_sp):
    hp, wp = chain_meta(0, h, w_sp)
    rows, cin = xq.shape
    b = rows // (hp * wp)
    if b * hp * wp != rows or cin != c:
        raise ValueError(f"xq {tuple(xq.shape)} is not a ({hp}x{wp}) chain of {c} channels")
    return b, hp, wp


def _basic_plain_folded(xq, b, h, w_sp, hp, wp, w1pq, w2pq, f, *, emit_i8):
    c = xq.shape[1]
    x = xq.reshape(b, hp, wp, c)[:, 1 : 1 + h, 1 : 1 + w_sp]
    z1 = _requant(torch.relu(_kh3(x, w1pq, f["a1"], h, w_sp) + f["c1"]))
    y = _kh3(z1, w2pq, f["a2"], h, w_sp) + f["c2"]
    y = torch.relu(_fma(x.float(), f["s_res"], y))
    return _chain_from_interior(_requant(y) if emit_i8 else y.to(torch.bfloat16), hp, wp)


def _basic_weights(dev, c, lead, **weights) -> dict:
    """The K-major copies of a basic kernel's kh-batched 3x3s (``_kmajor``),
    each (K, N) weight checked for its shape (..., 3c, 3c) first."""
    out = {}
    for name, (w, w_nk) in weights.items():
        if tuple(w.shape) != (*lead, 3 * c, 3 * c):
            raise ValueError(f"{name}: shape {tuple(w.shape)}, expected {(*lead, 3 * c, 3 * c)}")
        out[name] = _kmajor(w, w_nk, name + "_nk", dev)
    return out


def basic_block_chained_int8_plain(
    xq, w1pq, sw1p, b1, w2pq, sw2p, b2, scales, *,
    h, w_sp, emit_i8=True, bt=None, interpret=False, w1pq_nk=None, w2pq_nk=None,
):
    """Plain PyTorch version of ``basic_block_chained_int8`` (the weights
    read from their K-major copies where given)."""
    w1pq, w2pq = _from_kmajor(w1pq, w1pq_nk), _from_kmajor(w2pq, w2pq_nk)
    b, hp, wp = _basic_geometry(xq, sw1p.shape[-1] // 3, h, w_sp)
    f = _fold_basic(scales, sw1p, b1, sw2p, b2, emit_i8)
    return _basic_plain_folded(xq, b, h, w_sp, hp, wp, w1pq, w2pq, f, emit_i8=emit_i8)


def basic_block_chained_int8(
    xq, w1pq, sw1p, b1, w2pq, sw2p, b2, scales, *,
    h, w_sp, emit_i8=True, bt=None, interpret=False, w1pq_nk=None, w2pq_nk=None,
):
    """Int8 stride-1 BasicBlock over the chained padded-row layout.

    xq: (B*Hp*Wp, c) int8 chain at scale scales[0]; w1pq/w2pq (3c, 3c) the
    kh-batched 3x3s (``quantize_basic_block``) with per-(kh, j) scales
    sw1p/sw2p (3c,); biases (c,) f32; scales (3,) = [s_x, s_z1, s_y].
    Returns the same chain layout, int8 at s_y (emit_i8) or unscaled bf16.

    ``w1pq_nk`` / ``w2pq_nk``: the K-major (N, K) copies that the int8
    tensor-core tile reads, made once per engine by
    ``fused.pack_chain_kmajor``; without them the wrapper transposes once
    per call.  The kernel folds the requant scales itself, as
    ``_fold_basic`` does, op for op.
    """
    if _build.runs_plain():
        return basic_block_chained_int8_plain(
            xq, w1pq, sw1p, b1, w2pq, sw2p, b2, scales, h=h, w_sp=w_sp, emit_i8=emit_i8,
            w1pq_nk=w1pq_nk, w2pq_nk=w2pq_nk,
        )
    c = sw1p.shape[-1] // 3
    b, hp, wp = _basic_geometry(xq, c, h, w_sp)
    dev = xq.device
    _check_i8(dev, xq=xq)
    if c % 4:
        raise ValueError(f"the channel count must be a multiple of 4, got c={c}")
    nk = _basic_weights(dev, c, (), w1pq=(w1pq, w1pq_nk), w2pq=(w2pq, w2pq_nk))
    v = _f32_vectors(dev, sw1p=(sw1p, 3 * c), b1=(b1, c), sw2p=(sw2p, 3 * c), b2=(b2, c),
                     scales=(scales, 3))
    return _build.call("basic_block_chained_int8", BASIC_BLOCK_INT8,
        xq, nk["w1pq"], v["sw1p"], v["b1"], nk["w2pq"], v["sw2p"], v["b2"], v["scales"],
        h, w_sp, _kind(emit_i8),
    )


def _basic_block_plain(x, w1_nk, sw1p, b1, w2_nk, sw2p, b2, scales, h, w, out_kind):
    return basic_block_chained_int8_plain(
        x, None, sw1p, b1, None, sw2p, b2, scales, h=h, w_sp=w, emit_i8=out_kind == 0,
        w1pq_nk=w1_nk, w2pq_nk=w2_nk,
    )


#: Kernel 7 (block.py:1646): ``csrc/basic_block.cu``'s ``basic_block_int8``.
BASIC_BLOCK_INT8 = _build.kernel_op(
    "basic_block_int8",
    "(Tensor x, Tensor w1_nk, Tensor sw1p, Tensor b1, Tensor w2_nk, Tensor sw2p, Tensor b2, "
    "Tensor scales, int h, int w, int out_kind) -> Tensor",
    plain=_basic_block_plain,
    fake=lambda x, *a: x.new_empty(x.shape, dtype=_out_dtype(a[-1])),
)


def basic_run_chained_int8_plain(
    xq, w1pq_s, sw1p_s, b1_s, w2pq_s, sw2p_s, b2_s, scales_s, *,
    h, w_sp, emit_i8=True, bt=None, interpret=False, w1pq_nk_s=None, w2pq_nk_s=None,
):
    """Plain PyTorch version of ``basic_run_chained_int8`` (the weights
    read from their K-major copies where given)."""
    w1pq_s, w2pq_s = _from_kmajor(w1pq_s, w1pq_nk_s), _from_kmajor(w2pq_s, w2pq_nk_s)
    n_blocks, c = b1_s.shape
    b, hp, wp = _basic_geometry(xq, c, h, w_sp)
    f = _fold_basic_run(scales_s, sw1p_s, b1_s, sw2p_s, b2_s, emit_i8)
    y = xq
    for n in range(n_blocks):
        fn = {
            "a1": f["a1"][3 * n : 3 * n + 3], "c1": f["c1"][n],
            "a2": f["a2"][3 * n : 3 * n + 3], "c2": f["c2"][n],
            "s_res": f["s_res"][n : n + 1],
        }
        y = _basic_plain_folded(
            y, b, h, w_sp, hp, wp, w1pq_s[n], w2pq_s[n], fn,
            emit_i8=emit_i8 or n < n_blocks - 1,
        )
    return y


def basic_run_chained_int8(
    xq, w1pq_s, sw1p_s, b1_s, w2pq_s, sw2p_s, b2_s, scales_s, *,
    h, w_sp, emit_i8=True, bt=None, interpret=False, w1pq_nk_s=None, w2pq_nk_s=None,
):
    """A run of N stride-1 BasicBlocks as one call: stacked w1pq_s/w2pq_s
    (N, 3c, 3c), sw1p_s/sw2p_s (N, 3c), b1_s/b2_s (N, c); scales_s (N, 3)
    rows [s_x, s_z1, s_y], row i's s_y equal to row i+1's s_x.  Blocks
    before the last always hand on int8; ``emit_i8`` picks the last one's
    exit.  ``w1pq_nk_s`` / ``w2pq_nk_s``: the stacked K-major copies (see
    ``basic_block_chained_int8``)."""
    if _build.runs_plain():
        return basic_run_chained_int8_plain(
            xq, w1pq_s, sw1p_s, b1_s, w2pq_s, sw2p_s, b2_s, scales_s,
            h=h, w_sp=w_sp, emit_i8=emit_i8, w1pq_nk_s=w1pq_nk_s, w2pq_nk_s=w2pq_nk_s,
        )
    n_blocks, c = b1_s.shape
    b, hp, wp = _basic_geometry(xq, c, h, w_sp)
    dev = xq.device
    _check_i8(dev, xq=xq)
    if c % 4:
        raise ValueError(f"the channel count must be a multiple of 4, got c={c}")
    nk = _basic_weights(dev, c, (n_blocks,), w1pq_s=(w1pq_s, w1pq_nk_s),
                        w2pq_s=(w2pq_s, w2pq_nk_s))
    n = n_blocks
    v = _f32_vectors(dev, sw1p_s=(sw1p_s, (n, 3 * c)), b1_s=(b1_s, (n, c)),
                     sw2p_s=(sw2p_s, (n, 3 * c)), b2_s=(b2_s, (n, c)),
                     scales_s=(scales_s, (n, 3)))
    return _build.call("basic_run_chained_int8", BASIC_RUN_INT8,
        xq, nk["w1pq_s"], v["sw1p_s"], v["b1_s"], nk["w2pq_s"], v["sw2p_s"], v["b2_s"],
        v["scales_s"], h, w_sp, not emit_i8,
    )


def _basic_run_plain(x, w1s_nk, sw1ps, b1s, w2s_nk, sw2ps, b2s, scales_s, h, w, last_bf16):
    return basic_run_chained_int8_plain(
        x, None, sw1ps, b1s, None, sw2ps, b2s, scales_s, h=h, w_sp=w, emit_i8=not last_bf16,
        w1pq_nk_s=w1s_nk, w2pq_nk_s=w2s_nk,
    )


#: Kernel 8 (block.py:1830): ``csrc/basic_block.cu``'s ``basic_run_int8``.
BASIC_RUN_INT8 = _build.kernel_op(
    "basic_run_int8",
    "(Tensor x, Tensor w1s_nk, Tensor sw1ps, Tensor b1s, Tensor w2s_nk, Tensor sw2ps, "
    "Tensor b2s, Tensor scales_s, int h, int w, bool last_bf16) -> Tensor",
    plain=_basic_run_plain,
    fake=lambda x, *a: x.new_empty(x.shape, dtype=_out_dtype(int(a[-1]))),
)


def _fold_basic_ds(scales, sw1, b1, sw2p, b2, swd, bd, emit_i8):
    """Host-side scale folding of block.py:2631-2641, op for op (the plain
    version's; the kernel folds in its epilogue)."""
    s_x, s_z1 = scales[0], scales[1]
    s_y = scales[2] if emit_i8 else _one(scales)
    c = sw1.shape[-1]
    return {
        "a1": sw1.float() * (s_x / s_z1),
        "c1": b1.float() * (1.0 / s_z1),
        "a2": (sw2p.float() * (s_z1 / s_y)).reshape(3, c),
        "c2": b2.float() * (1.0 / s_y),
        "ad": swd.float() * (s_x / s_y),
        "cd": bd.float() * (1.0 / s_y),
    }


def basic_ds_w1(w1pq: torch.Tensor) -> torch.Tensor:
    """The transition's conv1 as its (9cin, c) matrix, rows (kh, kw, k): the
    (3, 4cin, c) packing without the zero rows [3cin, 4cin) of each kernel
    row."""
    cin = w1pq.shape[1] // 4
    return w1pq[:, : 3 * cin].reshape(9 * cin, w1pq.shape[-1])


def basic_ds_block_s2_int8_plain(
    xr, w1pq, sw1, b1, w2pq, sw2p, b2, wdq, swd, bd, scales, *,
    h, w_sp, emit_i8=True, bt=None, onedot=False, interpret=False,
    w1pq_nk=None, w2pq_nk=None, wdq_nk=None,
):
    """Plain PyTorch version of ``basic_ds_block_s2_int8`` (the weights
    read from their K-major copies where given)."""
    w1 = _from_kmajor(None if w1pq is None else basic_ds_w1(w1pq), w1pq_nk)
    w2pq, wdq = _from_kmajor(w2pq, w2pq_nk), _from_kmajor(wdq, wdq_nk)
    b, hp, wp, cin, oh, ow, hp2, wp2 = _ds_geometry(xr, h, w_sp)
    f = _fold_basic_ds(scales, sw1, b1, sw2p, b2, swd, bd, emit_i8)
    x = xr.reshape(b, hp, wp, cin)[:, 1 : 1 + h, 1 : 1 + w_sp]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = torch.cat(
        [
            xp[:, u : u + 2 * oh - 1 : 2, v : v + 2 * ow - 1 : 2]
            for u in range(3)
            for v in range(3)
        ],
        dim=-1,
    )
    z1 = _requant(torch.relu(_fma(_idot(taps, w1).float(), f["a1"], f["c1"])))
    y = _kh3(z1, w2pq, f["a2"], oh, ow) + f["c2"]
    sc = _idot(x[:, ::2, ::2], wdq)
    y = torch.relu(_fma(sc.float(), f["ad"], y) + f["cd"])
    return _chain_from_interior(_requant(y) if emit_i8 else y.to(torch.bfloat16), hp2, wp2)


def basic_ds_block_s2_int8(
    xr, w1pq, sw1, b1, w2pq, sw2p, b2, wdq, swd, bd, scales, *,
    h, w_sp, emit_i8=True, bt=None, onedot=False, interpret=False,
    w1pq_nk=None, w2pq_nk=None, wdq_nk=None,
):
    """Whole stride-2 BasicBlock (a ResNet-18/34 stage transition), chain
    to chain.

    xr: (B*Hp*Wp, cin) int8 chain of the (h, w_sp) input stage at scale
    scales[0]; weights per ``quantize_basic_ds_block``: w1pq (3, 4cin, c)
    with joint per-channel scales sw1 (c,), w2pq (3c, 3c) kh-batched with
    sw2p (3c,), wdq (cin, c) the 1x1/2 projection; scales (3,) = [s_x,
    s_z1, s_y].  Output: the (ceil(h/2), ceil(w_sp/2)) stage's chain of c
    channels, int8 at s_y (emit_i8) or unscaled bf16.  Output pixel (i, j)
    of conv1 taps x at (2i+u-1, 2j+v-1), zero outside the image; the
    shortcut reads x[2i, 2j].

    ``w1pq_nk`` (c, 9cin: ``basic_ds_w1(w1pq)`` transposed), ``w2pq_nk``
    (3c, 3c), ``wdq_nk`` (c, cin): the K-major copies that the int8
    tensor-core tile reads, made once per engine by
    ``fused.pack_chain_kmajor``; without them the wrapper transposes once
    per call.  The kernel folds the requant scales itself, as
    ``_fold_basic_ds`` does, op for op.
    """
    kmajor = dict(w1pq_nk=w1pq_nk, w2pq_nk=w2pq_nk, wdq_nk=wdq_nk)
    if _build.runs_plain():
        return basic_ds_block_s2_int8_plain(
            xr, w1pq, sw1, b1, w2pq, sw2p, b2, wdq, swd, bd, scales,
            h=h, w_sp=w_sp, emit_i8=emit_i8, **kmajor,
        )
    b, hp, wp, cin, oh, ow, hp2, wp2 = _ds_geometry(xr, h, w_sp)
    c = sw1.shape[-1]
    dev = xr.device
    _check_i8(dev, xr=xr)
    if cin % 4 or c % 4:
        raise ValueError(f"channel counts must be multiples of 4, got cin={cin}, c={c}")
    if tuple(w1pq.shape) != (3, 4 * cin, c) or tuple(w2pq.shape) != (3 * c, 3 * c) \
            or tuple(wdq.shape) != (cin, c):
        raise ValueError("weights do not match a (cin, c) basic transition: "
                         f"{[tuple(w.shape) for w in (w1pq, w2pq, wdq)]}")
    w1_nk = basic_ds_w1(w1pq).t().contiguous() if w1pq_nk is None else w1pq_nk
    _build.require(w1_nk, "w1pq_nk", torch.int8, dev, (c, 9 * cin))
    v = _f32_vectors(dev, sw1=(sw1, c), b1=(b1, c), sw2p=(sw2p, 3 * c), b2=(b2, c),
                     swd=(swd, c), bd=(bd, c), scales=(scales, 3))
    return _build.call("basic_ds_block_s2_int8", BASIC_DS_BLOCK_S2_INT8,
        xr, w1_nk, v["sw1"], v["b1"], _kmajor(w2pq, w2pq_nk, "w2pq_nk", dev), v["sw2p"],
        v["b2"], _kmajor(wdq, wdq_nk, "wdq_nk", dev), v["swd"], v["bd"], v["scales"],
        h, w_sp, _kind(emit_i8),
    )


def _basic_ds_plain(x, w1_nk, sw1, b1, w2_nk, sw2p, b2, wd_nk, swd, bd, scales, h, w, out_kind):
    return basic_ds_block_s2_int8_plain(
        x, None, sw1, b1, None, sw2p, b2, None, swd, bd, scales, h=h, w_sp=w,
        emit_i8=out_kind == 0, w1pq_nk=w1_nk, w2pq_nk=w2_nk, wdq_nk=wd_nk,
    )


#: Kernel 11 (block.py:2542): ``csrc/basic_block.cu``'s ``basic_ds_block_s2_int8``.
BASIC_DS_BLOCK_S2_INT8 = _build.kernel_op(
    "basic_ds_block_s2_int8",
    "(Tensor x, Tensor w1_nk, Tensor sw1, Tensor b1, Tensor w2_nk, Tensor sw2p, Tensor b2, "
    "Tensor wd_nk, Tensor swd, Tensor bd, Tensor scales, int h, int w, int out_kind) -> Tensor",
    plain=_basic_ds_plain,
    fake=lambda x, w1_nk, sw1, *a: x.new_empty((_ds_rows(x, a[-3], a[-2]), sw1.shape[0]),
                                               dtype=_out_dtype(a[-1])),
)


# ---------------------------------------------------------------------------
# The pixel-paired stage-0 kernels (c = 64): csrc/pp_block.cu
#
# Two W-adjacent pixels per row: the chain (B*hp*wp, C) viewed as pair rows
# (B*hp*wp/2, 2C), a free view since wp is even.  The pairing lives in the
# weights: block-diagonal 1x1s and the pair-packed 3x3, whose K-major copies
# the engine makes once (``fused.pack_chain_kmajor``); a call without them
# builds them from the standard quantized tensors, as the JAX wrappers do.
# Each public wrapper keeps its JAX contract (chain rows in and out).  On a
# CUDA tensor the bottleneck wrappers launch the kernel with the standard
# block's raw vectors and device scales (the kernel folds and lane-tiles
# them in its epilogue); the basic ones fold and lane-tile on the host and
# hand the pair-space operands to a pair-space entry (``*_pp_pairs``), which
# every kernel also has: it takes the folded, lane-tiled vectors, launches
# the kernel for a CUDA tensor or runs its own plain version on the CPU.
# Interior-ness is per half of a pair row (the pad parity differs inside
# boundary pairs): every source half whose pixel lies outside the image
# reads as zero, and ring halves are written as zeros.
# ---------------------------------------------------------------------------


def _pp_block_diag(w: torch.Tensor) -> torch.Tensor:
    """(..., k, n) -> (..., 2k, 2n) block-diagonal [[w, 0], [0, w]]
    (block.py:1103)."""
    z = torch.zeros_like(w)
    return torch.cat([torch.cat([w, z], dim=-1), torch.cat([z, w], dim=-1)], dim=-2)


_PACK_INDEX: dict = {}


def _pp_pack_index(c: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """For each entry [(kwp, pi, k), (kh, pj, j)] of the (6c, 6c) pair-space
    3x3, its flat index into the (3c, 3c) kh-batched [(kw, k), (kh, j)]
    packing, kw = 2(kwp-1) + pi - pj + 1, and whether that kw exists (else
    the entry is zero).  Cached per channel count and device."""
    key = (c, str(device))
    if key not in _PACK_INDEX:
        kwp, pi, k, kh, pj, j = np.meshgrid(
            *(np.arange(n) for n in (3, 2, c, 3, 2, c)), indexing="ij"
        )
        kw = 2 * (kwp - 1) + pi - pj + 1
        valid = (kw >= 0) & (kw <= 2)
        src = np.where(valid, (kw * c + k) * (3 * c) + kh * c + j, 0)
        _PACK_INDEX[key] = (
            torch.from_numpy(src.reshape(6 * c, 6 * c)).to(device),
            torch.from_numpy(valid.reshape(6 * c, 6 * c)).to(device),
        )
    return _PACK_INDEX[key]


def _pp_pack_conv2(w2pq: torch.Tensor, c: int) -> torch.Tensor:
    """(..., 3c, 3c) kh-batched 3x3 -> the (..., 6c, 6c) pair-space packing
    [(kwp, pi, k), (kh, pj, j)] of block.py:1083: entry = W2[kh, kw, k, j]
    at kw = 2(kwp-1) + pi - pj + 1 where that is in 0..2, else 0.  The
    entries are copies of the int8 values, so each column keeps its
    per-(kh, j) scale.  One gather through a cached index map."""
    src, valid = _pp_pack_index(c, w2pq.device)
    flat = w2pq.reshape(*w2pq.shape[:-2], 9 * c * c)
    return torch.where(valid, flat[..., src], torch.zeros((), dtype=w2pq.dtype, device=w2pq.device))


def _pp_tile(f: dict) -> dict:
    """Lane-tile a fold's per-channel vectors to pair width, as the JAX
    wrappers' jnp.tile(v, 2) / (1, 2) do; the residual scale stays."""
    return {k: v if v is None or k == "s_res" else torch.cat([v, v], dim=-1) for k, v in f.items()}


def _pp_require(c: int, wp: int) -> None:
    if c != 64:
        raise ValueError(f"the pixel-paired kernels are for the c=64 stage only, got c={c}")
    if wp % 2:
        raise ValueError(f"pixel pairing needs an even padded width, got wp={wp}")


def _pp_geometry(xpp: torch.Tensor, h: int, w_sp: int) -> tuple[int, int, int]:
    hp, wp = chain_meta(0, h, w_sp)
    rows2 = xpp.shape[0]
    b = 2 * rows2 // (hp * wp)
    if b * hp * wp != 2 * rows2:
        raise ValueError(f"xpp {tuple(xpp.shape)} is not the pair view of a ({hp}x{wp}) chain")
    return b, hp, wp


def _pp_halves(b: int, hp: int, wp: int, h: int, w_sp: int, device) -> torch.Tensor:
    """(B*hp*wp/2, 2) bool: whether each half of each pair row is an
    interior pixel."""
    r = torch.arange(hp, device=device)[:, None]
    q = torch.arange(wp, device=device)[None, :]
    inner = (r >= 1) & (r <= h) & (q >= 1) & (q <= w_sp)
    return inner.reshape(1, hp * wp // 2, 2).expand(b, -1, -1).reshape(-1, 2)


def _pp_mask(a: torch.Tensor, halves: torch.Tensor) -> torch.Tensor:
    """Zero the halves of pair rows (rows, 2k) whose pixel is not interior."""
    rows, k2 = a.shape
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    return torch.where(halves[:, :, None], a.reshape(rows, 2, k2 // 2), zero).reshape(rows, k2)


def _pp_shift(a: torch.Tensor, s: int) -> torch.Tensor:
    """Pair row f -> a[f + s], zero outside the buffer."""
    out = torch.zeros_like(a)
    n = a.shape[0]
    if s >= 0:
        out[: n - s] = a[s:]
    else:
        out[-s:] = a[: n + s]
    return out


def _pp_kh3(z: torch.Tensor, w2pp: torch.Tensor, a: torch.Tensor, wpp: int,
            halves: torch.Tensor) -> torch.Tensor:
    """The pair-space kh-batched 3x3 over pair rows z (rows, c2): kernel row
    kh sums, over kwp, the masked pair rows f + (kh-1)*wpp + (kwp-1) times
    w2pp's (kwp, half, k) rows and its kh column block; the three sums are
    dequantized with a (3, c2) as XLA fuses them (``_kh3``)."""
    c2 = w2pp.shape[1] // 3
    zm = _pp_mask(z, halves)
    p = []
    for kh in range(3):
        taps = torch.cat([_pp_shift(zm, (kh - 1) * wpp + kwp - 1) for kwp in range(3)], dim=-1)
        p.append(_idot(taps, w2pp[:, kh * c2 : (kh + 1) * c2]).float())
    return _fma(p[2], a[2], _fma(p[0], a[0], p[1] * a[1]))


def _pp_out(y: torch.Tensor, emit_i8: bool, halves: torch.Tensor) -> torch.Tensor:
    return _pp_mask(_requant(y) if emit_i8 else y.to(torch.bfloat16), halves)


# --- Kernel 5: one pixel-paired bottleneck block ----------------------------


def _pp_block_folded(xpp, halves, wpp, w1, w2pp, w3, wd, f, *, emit_i8):
    """One pair-space bottleneck block on folded, lane-tiled vectors f."""
    x = _pp_mask(xpp, halves)
    z1 = _pp_mask(_requant(torch.relu(_fma(_idot(x, w1).float(), f["a1"], f["c1"]))), halves)
    z2 = _pp_mask(_requant(torch.relu(_pp_kh3(z1, w2pp, f["a2"], wpp, halves) + f["c2"])), halves)
    y = _fma(_idot(z2, w3).float(), f["a3"], f["c3"])
    if wd is None:
        y = _fma(xpp.float(), f["s_res"], y)
    else:
        y = y + _fma(_idot(x, wd).float(), f["ad"], f["cd"])
    return _pp_out(torch.relu(y), emit_i8, halves)


def _pp_pair(w, w_nk, conv2=False):
    """A pair-space (K, N) weight from the standard (..., k, n) weight ``w``
    of a bottleneck block or run: the transposed view of the engine's
    K-major copy ``w_nk`` where given (checked against ``w``), else built
    here: the block-diagonal 1x1, or with ``conv2`` the pair-packed 3x3."""
    if w is None:
        return None
    if w_nk is None:
        return _pp_pack_conv2(w, w.shape[-1] // 3) if conv2 else _pp_block_diag(w)
    *lead, k, n = w.shape
    if tuple(w_nk.shape) != (*lead, 2 * n, 2 * k):
        raise ValueError(f"pair-space K-major copy of shape {tuple(w_nk.shape)} for a "
                         f"{tuple(w.shape)} weight")
    return w_nk.transpose(-1, -2)


def _pp_kmajor(w, w_nk, name, dev, conv2=False):
    """The K-major copy of a pair-space weight that the kernel reads:
    ``w_nk`` as given (checked against the standard weight ``w``), else
    built from ``w`` (``_pp_pair``) and transposed here, once per call."""
    return _kmajor(_pp_pair(w, w_nk, conv2), w_nk, name, dev)


def _pp_nk(dev, **weights) -> dict:
    """The K-major copies (``_kmajor``) of a pair-space entry's (K, N)
    weights, given as name=(w, w_nk, shape), each w checked for its shape
    first; an absent weight stays None."""
    out = {}
    for name, (w, w_nk, shape) in weights.items():
        if w is not None and tuple(w.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(w.shape)}, expected {shape}")
        out[name] = _kmajor(w, w_nk, name + "_nk", dev)
    return out


def _pp_call(xpp, geo, weights, vecs, scales, *, folded, emit_i8, n_blocks=None):
    """Call ``resnetc::pp_block_int8`` (``n_blocks`` None) or ``pp_run_int8``
    on pair rows xpp: ``geo`` (b, h, w_sp, hp, wp), the K-major pair-space
    ``weights`` (w1 [w10] w2 w3 wd) and fp32 ``vecs`` (sw1 b1 sw2 b2 sw3 b3
    swd bd), ``scales`` the device residual scales (folded) or [s_x, s_z1,
    s_z2, s_y] rows (raw)."""
    _, h, w_sp, _, _ = geo
    cin2, cw = xpp.shape[1], weights["w3"].shape[-1]
    if cin2 % 8 or cw % 8:
        raise ValueError(f"pair widths must be multiples of 8, got cin2={cin2}, c2={cw}")
    v = [vecs[k] for k in ("sw1", "b1")] + [weights["w2"]] + [
        vecs[k] for k in ("sw2", "b2")] + [weights["w3"]] + [vecs[k] for k in ("sw3", "b3")]
    proj = [weights["wd"], vecs["swd"], vecs["bd"]]
    if n_blocks is None:
        return _build.call("bottleneck_block_chained_int8_pp", PP_BLOCK_INT8,
            xpp, weights["w1"], *v, scales, folded, *proj, h, w_sp, _kind(emit_i8))
    return _build.call("bottleneck_run_chained_int8_pp", PP_RUN_INT8,
        xpp, weights["w1"], weights["w10"], *v, scales, folded, *proj, h, w_sp, not emit_i8)


def _pp_folds(folded, emit_i8, fold, sw1, b1, sw2, b2, sw3, b3, scales, swd, bd) -> dict:
    """The folded, lane-tiled vectors of a pair-space call: as given
    (``folded``), else from the raw vectors and scales by ``fold`` then
    ``_pp_tile``, as the kernel folds them."""
    if folded:
        return {"a1": sw1, "c1": b1, "a2": sw2, "c2": b2, "a3": sw3, "c3": b3, "s_res": scales,
                "ad": swd, "cd": bd}
    return _pp_tile(fold(scales, sw1, b1, sw2, b2, sw3, b3, swd, bd, emit_i8))


def _pp_block_plain(x, w1_nk, sw1, b1, w2_nk, sw2, b2, w3_nk, sw3, b3, scales, folded,
                    wd_nk, swd, bd, h, w, out_kind):
    emit_i8 = out_kind == 0
    f = _pp_folds(folded, emit_i8, _fold_block, sw1, b1, sw2, b2, sw3, b3, scales, swd, bd)
    return bottleneck_block_pp_pairs_plain(
        x, None, f["a1"], f["c1"], None, f["a2"], f["c2"], None, f["a3"], f["c3"], f["s_res"],
        h=h, w_sp=w, emit_i8=emit_i8, ad=f["ad"], cd=f["cd"],
        w1bd_nk=w1_nk, w2pp_nk=w2_nk, w3bd_nk=w3_nk, wdbd_nk=wd_nk,
    )


#: Kernel 5 (block.py:1113): ``csrc/pp_block.cu``'s ``pp_block_int8``, on
#: pair rows; ``folded``: the vectors are folded and lane-tiled and
#: ``scales`` the residual scale, else raw vectors and [s_x, s_z1, s_z2, s_y].
PP_BLOCK_INT8 = _build.kernel_op(
    "pp_block_int8",
    "(Tensor x, Tensor w1_nk, Tensor sw1, Tensor b1, Tensor w2_nk, Tensor sw2, Tensor b2, "
    "Tensor w3_nk, Tensor sw3, Tensor b3, Tensor scales, bool folded, Tensor? wd_nk, "
    "Tensor? swd, Tensor? bd, int h, int w, int out_kind) -> Tensor",
    plain=_pp_block_plain,
    fake=lambda x, w1_nk, sw1, b1, w2_nk, sw2, b2, w3_nk, *a: x.new_empty(
        (x.shape[0], w3_nk.shape[0]), dtype=_out_dtype(a[-1])),
)


def _pp_run_plain(x, w1s_nk, w10_nk, sw1, b1, w2s_nk, sw2, b2, w3s_nk, sw3, b3, scales, folded,
                  wd_nk, swd, bd, h, w, last_bf16):
    emit_i8 = not last_bf16
    f = _pp_folds(folded, emit_i8, _fold_run, sw1, b1, sw2, b2, sw3, b3, scales, swd, bd)
    return bottleneck_run_pp_pairs_plain(
        x, None, f["a1"], f["c1"], None, f["a2"], f["c2"], None, f["a3"], f["c3"], f["s_res"],
        h=h, w_sp=w, emit_i8=emit_i8, ad=f["ad"], cd=f["cd"], w1bd_nk_s=w1s_nk,
        w2pp_nk_s=w2s_nk, w3bd_nk_s=w3s_nk, w10bd_nk=w10_nk, wdbd_nk=wd_nk,
    )


#: Kernel 6 (block.py:1387): ``csrc/pp_block.cu``'s ``pp_run_int8``, the
#: vectors stacked (N, .) (``sw2`` (3N, c2) folded, (N, 3c) raw).
PP_RUN_INT8 = _build.kernel_op(
    "pp_run_int8",
    "(Tensor x, Tensor w1s_nk, Tensor? w10_nk, Tensor sw1, Tensor b1, Tensor w2s_nk, "
    "Tensor sw2, Tensor b2, Tensor w3s_nk, Tensor sw3, Tensor b3, Tensor scales, bool folded, "
    "Tensor? wd_nk, Tensor? swd, Tensor? bd, int h, int w, bool last_bf16) -> Tensor",
    plain=_pp_run_plain,
    fake=lambda x, w1s_nk, w10_nk, sw1, b1, w2s_nk, sw2, b2, w3s_nk, *a: x.new_empty(
        (x.shape[0], w3s_nk.shape[1]), dtype=_out_dtype(int(a[-1]))),
)


def bottleneck_block_pp_pairs_plain(
    xpp, w1bd, a1, c1, w2pp, a2, c2, w3bd, a3, c3, s_res, *,
    h, w_sp, emit_i8=True, wdbd=None, ad=None, cd=None,
    w1bd_nk=None, w2pp_nk=None, w3bd_nk=None, wdbd_nk=None,
):
    """Plain PyTorch version of ``bottleneck_block_pp_pairs`` (the weights
    read from their K-major copies where given)."""
    w1bd, w2pp = _from_kmajor(w1bd, w1bd_nk), _from_kmajor(w2pp, w2pp_nk)
    w3bd, wdbd = _from_kmajor(w3bd, w3bd_nk), _from_kmajor(wdbd, wdbd_nk)
    b, hp, wp = _pp_geometry(xpp, h, w_sp)
    halves = _pp_halves(b, hp, wp, h, w_sp, xpp.device)
    f = {"a1": a1, "c1": c1, "a2": a2, "c2": c2, "a3": a3, "c3": c3, "s_res": s_res,
         "ad": ad, "cd": cd}
    return _pp_block_folded(xpp, halves, wp // 2, w1bd, w2pp, w3bd, wdbd, f, emit_i8=emit_i8)


def bottleneck_block_pp_pairs(
    xpp, w1bd, a1, c1, w2pp, a2, c2, w3bd, a3, c3, s_res, *,
    h, w_sp, emit_i8=True, wdbd=None, ad=None, cd=None,
    w1bd_nk=None, w2pp_nk=None, w3bd_nk=None, wdbd_nk=None,
):
    """The pair-space entry of ``bottleneck_block_chained_int8_pp``: xpp
    (B*hp*wp/2, cin2) int8 pair rows; w1bd (cin2, c2), w2pp (3c2, 3c2), w3bd
    (c2, c4p) int8 (their K-major copies ``*_nk``, else transposed per
    call); a1, c1, c2 (c2,), a2 (3, c2), a3, c3 (c4p,) fp32, folded and
    lane-tiled; s_res (1,); optional projection wdbd (cin2, c4p), ad, cd
    (c4p,).  Any int8 values: the kernel is a dense pair-space GEMM.
    Returns (B*hp*wp/2, c4p) pair rows, int8 or bf16, zero on ring halves."""
    kmajor = dict(w1bd_nk=w1bd_nk, w2pp_nk=w2pp_nk, w3bd_nk=w3bd_nk, wdbd_nk=wdbd_nk)
    if _build.runs_plain():
        return bottleneck_block_pp_pairs_plain(
            xpp, w1bd, a1, c1, w2pp, a2, c2, w3bd, a3, c3, s_res,
            h=h, w_sp=w_sp, emit_i8=emit_i8, wdbd=wdbd, ad=ad, cd=cd, **kmajor,
        )
    b, hp, wp = _pp_geometry(xpp, h, w_sp)
    cin2 = xpp.shape[1]
    cw, c4p = w1bd.shape[1], w3bd.shape[1]
    dev = xpp.device
    _check_i8(dev, xpp=xpp)
    weights = _pp_nk(dev, w1=(w1bd, w1bd_nk, (cin2, cw)), w2=(w2pp, w2pp_nk, (3 * cw, 3 * cw)),
                     w3=(w3bd, w3bd_nk, (cw, c4p)), wd=(wdbd, wdbd_nk, (cin2, c4p)))
    vecs = {"sw1": a1, "b1": c1, "sw2": a2, "b2": c2, "sw3": a3, "b3": c3, "swd": None,
            "bd": None}
    shapes = {"sw1": (cw,), "b1": (cw,), "sw2": (3, cw), "b2": (cw,), "sw3": (c4p,),
              "b3": (c4p,), "swd": (c4p,), "bd": (c4p,)}
    if wdbd is None:
        if cin2 != c4p:
            raise ValueError(f"identity shortcut needs cin2 == c4p, got {cin2} vs {c4p}")
    else:
        vecs.update(swd=ad, bd=cd)
    for name, v in vecs.items():
        if v is not None:
            _build.require(v, name, torch.float32, dev, shapes[name])
    _build.require(s_res, "s_res", torch.float32, dev, (1,))
    return _pp_call(xpp, (b, h, w_sp, hp, wp), weights, vecs, s_res, folded=True,
                    emit_i8=emit_i8)


def bottleneck_block_chained_int8_pp_plain(
    xq, w1q, sw1, b1, w2pq, sw2p, b2, w3q, sw3, b3, scales, *,
    h, w_sp, emit_i8=True, bt=None, interpret=False, wdq=None, swd=None, bd=None,
    w1bd_nk=None, w2pp_nk=None, w3bd_nk=None, wdbd_nk=None,
):
    """Plain PyTorch version of ``bottleneck_block_chained_int8_pp``: the
    pair-space operands folded and lane-tiled as block.py:1166-1175 and
    :1203-1204 do, through the pair-space entry's plain version."""
    _, _, wp, cin, c, c4 = _block_geometry(xq, w1q, w3q, wdq, h, w_sp, emit_i8, False)
    _pp_require(c, wp)
    f = _pp_tile(_fold_block(scales, sw1, b1, sw2p, b2, sw3, b3, swd, bd, emit_i8))
    return bottleneck_block_pp_pairs_plain(
        xq.reshape(-1, 2 * cin), _pp_pair(w1q, w1bd_nk), f["a1"], f["c1"],
        _pp_pair(w2pq, w2pp_nk, conv2=True), f["a2"], f["c2"], _pp_pair(w3q, w3bd_nk),
        f["a3"], f["c3"], f["s_res"], h=h, w_sp=w_sp, emit_i8=emit_i8,
        wdbd=_pp_pair(wdq, wdbd_nk), ad=f["ad"], cd=f["cd"],
    ).reshape(-1, c4)


def bottleneck_block_chained_int8_pp(
    xq, w1q, sw1, b1, w2pq, sw2p, b2, w3q, sw3, b3, scales, *,
    h, w_sp, emit_i8=True, bt=None, interpret=False, wdq=None, swd=None, bd=None,
    w1bd_nk=None, w2pp_nk=None, w3bd_nk=None, wdbd_nk=None,
):
    """Pixel-paired stride-1 bottleneck block for the c=64 stage: the same
    contract as ``bottleneck_block_chained_int8`` (chain rows (B*Hp*Wp, cin)
    in, (B*Hp*Wp, 4c) out, identity or projection shortcut, int8 or bf16
    exit), computed in pair space.  Needs c == 64 and an even wp.

    ``w1bd_nk``, ``w2pp_nk``, ``w3bd_nk``, ``wdbd_nk``: the K-major copies of
    the pair-space weights (block-diagonal 1x1s, the pair-packed 3x3), made
    once per engine by ``fused.pack_chain_kmajor``; without them the wrapper
    packs and transposes once per call.  The kernel folds the requant scales
    from the raw vectors and the device scales, as ``_fold_block`` then
    ``_pp_tile`` do, op for op."""
    if _build.runs_plain():
        return bottleneck_block_chained_int8_pp_plain(
            xq, w1q, sw1, b1, w2pq, sw2p, b2, w3q, sw3, b3, scales, h=h, w_sp=w_sp,
            emit_i8=emit_i8, wdq=wdq, swd=swd, bd=bd,
            w1bd_nk=w1bd_nk, w2pp_nk=w2pp_nk, w3bd_nk=w3bd_nk, wdbd_nk=wdbd_nk,
        )
    b, hp, wp, cin, c, c4 = _block_geometry(xq, w1q, w3q, wdq, h, w_sp, emit_i8, False)
    _pp_require(c, wp)
    dev = xq.device
    _check_i8(dev, xq=xq)
    weights = {"w1": _pp_kmajor(w1q, w1bd_nk, "w1bd_nk", dev),
               "w2": _pp_kmajor(w2pq, w2pp_nk, "w2pp_nk", dev, conv2=True),
               "w3": _pp_kmajor(w3q, w3bd_nk, "w3bd_nk", dev),
               "wd": _pp_kmajor(wdq, wdbd_nk, "wdbd_nk", dev)}
    vecs = _f32_vectors(dev, sw1=(sw1, c), b1=(b1, c), sw2=(sw2p, 3 * c), b2=(b2, c),
                        sw3=(sw3, c4), b3=(b3, c4), scales=(scales, 4),
                        swd=(swd, c4) if wdq is not None else None,
                        bd=(bd, c4) if wdq is not None else None)
    return _pp_call(xq.reshape(-1, 2 * cin), (b, h, w_sp, hp, wp), weights, vecs,
                    vecs["scales"], folded=False, emit_i8=emit_i8).reshape(-1, c4)


# --- Kernel 6: a pixel-paired run of bottleneck blocks ----------------------


def bottleneck_run_pp_pairs_plain(
    xpp, w1bd_s, a1s, c1s, w2pp_s, a2s, c2s, w3bd_s, a3s, c3s, s_res, *,
    h, w_sp, emit_i8=True, w10bd=None, wdbd=None, ad=None, cd=None,
    w1bd_nk_s=None, w2pp_nk_s=None, w3bd_nk_s=None, w10bd_nk=None, wdbd_nk=None,
):
    """Plain PyTorch version of ``bottleneck_run_pp_pairs`` (the weights
    read from their K-major copies where given)."""
    w1bd_s, w2pp_s = _from_kmajor(w1bd_s, w1bd_nk_s), _from_kmajor(w2pp_s, w2pp_nk_s)
    w3bd_s = _from_kmajor(w3bd_s, w3bd_nk_s)
    w10bd, wdbd = _from_kmajor(w10bd, w10bd_nk), _from_kmajor(wdbd, wdbd_nk)
    b, hp, wp = _pp_geometry(xpp, h, w_sp)
    halves = _pp_halves(b, hp, wp, h, w_sp, xpp.device)
    n_blocks = w2pp_s.shape[0]
    has_proj = w10bd is not None
    y = xpp
    for n in range(n_blocks):
        proj_n = has_proj and n == 0
        w1 = w10bd if proj_n else w1bd_s[n - 1 if has_proj else n]
        fn = {
            "a1": a1s[n], "c1": c1s[n], "a2": a2s[3 * n : 3 * n + 3], "c2": c2s[n],
            "a3": a3s[n], "c3": c3s[n], "s_res": s_res[n : n + 1],
            "ad": ad if proj_n else None, "cd": cd if proj_n else None,
        }
        y = _pp_block_folded(y, halves, wp // 2, w1, w2pp_s[n], w3bd_s[n],
                             wdbd if proj_n else None, fn,
                             emit_i8=emit_i8 or n < n_blocks - 1)
    return y


def bottleneck_run_pp_pairs(
    xpp, w1bd_s, a1s, c1s, w2pp_s, a2s, c2s, w3bd_s, a3s, c3s, s_res, *,
    h, w_sp, emit_i8=True, w10bd=None, wdbd=None, ad=None, cd=None,
    w1bd_nk_s=None, w2pp_nk_s=None, w3bd_nk_s=None, w10bd_nk=None, wdbd_nk=None,
):
    """The pair-space entry of ``bottleneck_run_chained_int8_pp``: stacked
    w1bd_s (N, c4p, c2) (N-1 with the projection form), w2pp_s (N, 3c2, 3c2),
    w3bd_s (N, c2, c4p) int8 (their stacked K-major copies ``*_nk_s``, else
    transposed per call); a1s, c1s, c2s (N, c2), a2s (3N, c2), a3s, c3s (N,
    c4p), s_res (N,) fp32; the projection form adds w10bd (cin2, c2), wdbd
    (cin2, c4p) (``w10bd_nk``, ``wdbd_nk``), ad, cd (c4p,).  Dense pair-space
    GEMMs, as kernel 5."""
    kmajor = dict(w1bd_nk_s=w1bd_nk_s, w2pp_nk_s=w2pp_nk_s, w3bd_nk_s=w3bd_nk_s,
                  w10bd_nk=w10bd_nk, wdbd_nk=wdbd_nk)
    if _build.runs_plain():
        return bottleneck_run_pp_pairs_plain(
            xpp, w1bd_s, a1s, c1s, w2pp_s, a2s, c2s, w3bd_s, a3s, c3s, s_res,
            h=h, w_sp=w_sp, emit_i8=emit_i8, w10bd=w10bd, wdbd=wdbd, ad=ad, cd=cd, **kmajor,
        )
    b, hp, wp = _pp_geometry(xpp, h, w_sp)
    cin2 = xpp.shape[1]
    n_blocks, cw, c4p = w3bd_s.shape
    has_proj = w10bd is not None
    dev = xpp.device
    _check_i8(dev, xpp=xpp)
    weights = _pp_nk(dev, w1=(w1bd_s, w1bd_nk_s, (n_blocks - has_proj, c4p, cw)),
                     w10=(w10bd, w10bd_nk, (cin2, cw)),
                     w2=(w2pp_s, w2pp_nk_s, (n_blocks, 3 * cw, 3 * cw)),
                     w3=(w3bd_s, w3bd_nk_s, (n_blocks, cw, c4p)), wd=(wdbd, wdbd_nk, (cin2, c4p)))
    vecs = {"sw1": a1s, "b1": c1s, "sw2": a2s, "b2": c2s, "sw3": a3s, "b3": c3s,
            "swd": None, "bd": None}
    shapes = {"sw1": (n_blocks, cw), "b1": (n_blocks, cw), "sw2": (3 * n_blocks, cw),
              "b2": (n_blocks, cw), "sw3": (n_blocks, c4p), "b3": (n_blocks, c4p),
              "swd": (c4p,), "bd": (c4p,)}
    if has_proj:
        if n_blocks < 2:
            raise ValueError("a lone projection block is bottleneck_block_pp_pairs' job")
        vecs.update(swd=ad, bd=cd)
    elif cin2 != c4p:
        raise ValueError(f"identity runs need cin2 == c4p, got {cin2} vs {c4p}")
    for name, v in vecs.items():
        if v is not None:
            _build.require(v, name, torch.float32, dev, shapes[name])
    _build.require(s_res, "s_res", torch.float32, dev, (n_blocks,))
    return _pp_call(xpp, (b, h, w_sp, hp, wp), weights, vecs, s_res, folded=True,
                    emit_i8=emit_i8, n_blocks=n_blocks)


def bottleneck_run_chained_int8_pp_plain(
    xq, w1q_s, sw1_s, b1_s, w2pq_s, sw2p_s, b2_s, w3q_s, sw3_s, b3_s, scales_s, *,
    h, w_sp, emit_i8=True, bt=None, interpret=False,
    w1q0=None, wdq=None, swd=None, bd=None,
    w1bd_nk_s=None, w2pp_nk_s=None, w3bd_nk_s=None, w10bd_nk=None, wdbd_nk=None,
):
    """Plain PyTorch version of ``bottleneck_run_chained_int8_pp``: the
    pair-space operands folded and lane-tiled as block.py:1444-1461 and
    :1490-1491 do, through the pair-space entry's plain version."""
    _, _, _, wp, cin, c, c4 = _run_geometry(xq, w1q_s, w3q_s, w1q0, wdq, h, w_sp)
    _pp_require(c, wp)
    f = _pp_tile(_fold_run(scales_s, sw1_s, b1_s, sw2p_s, b2_s, sw3_s, b3_s, swd, bd, emit_i8))
    return bottleneck_run_pp_pairs_plain(
        xq.reshape(-1, 2 * cin), _pp_pair(w1q_s, w1bd_nk_s), f["a1"], f["c1"],
        _pp_pair(w2pq_s, w2pp_nk_s, conv2=True), f["a2"], f["c2"], _pp_pair(w3q_s, w3bd_nk_s),
        f["a3"], f["c3"], f["s_res"], h=h, w_sp=w_sp, emit_i8=emit_i8,
        w10bd=_pp_pair(w1q0, w10bd_nk), wdbd=_pp_pair(wdq, wdbd_nk), ad=f["ad"], cd=f["cd"],
    ).reshape(-1, c4)


def bottleneck_run_chained_int8_pp(
    xq, w1q_s, sw1_s, b1_s, w2pq_s, sw2p_s, b2_s, w3q_s, sw3_s, b3_s, scales_s, *,
    h, w_sp, emit_i8=True, bt=None, interpret=False,
    w1q0=None, wdq=None, swd=None, bd=None,
    w1bd_nk_s=None, w2pp_nk_s=None, w3bd_nk_s=None, w10bd_nk=None, wdbd_nk=None,
):
    """Pixel-paired run of N stride-1 bottleneck blocks for the c=64 stage:
    the contract of ``bottleneck_run_chained_int8`` (stacked weights, the
    projection form with w1q0/wdq/swd/bd), computed in pair space.
    ``w1bd_nk_s``, ``w2pp_nk_s``, ``w3bd_nk_s`` (and ``w10bd_nk``,
    ``wdbd_nk``): the stacked K-major copies of the pair-space weights (see
    ``bottleneck_block_chained_int8_pp``).  The kernel folds each block's
    scales itself (as ``_fold_run`` then ``_pp_tile`` do)."""
    if _build.runs_plain():
        return bottleneck_run_chained_int8_pp_plain(
            xq, w1q_s, sw1_s, b1_s, w2pq_s, sw2p_s, b2_s, w3q_s, sw3_s, b3_s, scales_s,
            h=h, w_sp=w_sp, emit_i8=emit_i8, w1q0=w1q0, wdq=wdq, swd=swd, bd=bd,
            w1bd_nk_s=w1bd_nk_s, w2pp_nk_s=w2pp_nk_s, w3bd_nk_s=w3bd_nk_s, w10bd_nk=w10bd_nk,
            wdbd_nk=wdbd_nk,
        )
    n_blocks, b, hp, wp, cin, c, c4 = _run_geometry(xq, w1q_s, w3q_s, w1q0, wdq, h, w_sp)
    _pp_require(c, wp)
    dev = xq.device
    _check_i8(dev, xq=xq)
    weights = {"w1": _pp_kmajor(w1q_s, w1bd_nk_s, "w1bd_nk_s", dev),
               "w10": _pp_kmajor(w1q0, w10bd_nk, "w10bd_nk", dev),
               "w2": _pp_kmajor(w2pq_s, w2pp_nk_s, "w2pp_nk_s", dev, conv2=True),
               "w3": _pp_kmajor(w3q_s, w3bd_nk_s, "w3bd_nk_s", dev),
               "wd": _pp_kmajor(wdq, wdbd_nk, "wdbd_nk", dev)}
    n, has_proj = n_blocks, w1q0 is not None
    vecs = _f32_vectors(dev, sw1=(sw1_s, (n, c)), b1=(b1_s, (n, c)),
                        sw2=(sw2p_s, (n, 3 * c)), b2=(b2_s, (n, c)),
                        sw3=(sw3_s, (n, c4)), b3=(b3_s, (n, c4)), scales=(scales_s, (n, 4)),
                        swd=(swd, c4) if has_proj else None, bd=(bd, c4) if has_proj else None)
    return _pp_call(xq.reshape(-1, 2 * cin), (b, h, w_sp, hp, wp), weights, vecs,
                    vecs["scales"], folded=False, emit_i8=emit_i8,
                    n_blocks=n_blocks).reshape(-1, c4)


# --- Kernels 9 and 10: the pixel-paired basic block and run -----------------


def _pp_basic_folded(xpp, halves, wpp, w1pp, w2pp, f, *, emit_i8):
    """One pair-space BasicBlock: x enters conv1 masked (block.py:1960), the
    residual reads it as it is."""
    z1 = _pp_mask(
        _requant(torch.relu(_pp_kh3(xpp, w1pp, f["a1"], wpp, halves) + f["c1"])), halves
    )
    y = _pp_kh3(z1, w2pp, f["a2"], wpp, halves) + f["c2"]
    return _pp_out(torch.relu(_fma(xpp.float(), f["s_res"], y)), emit_i8, halves)


def basic_block_pp_pairs_plain(
    xpp, w1pp, a1, c1, w2pp, a2, c2, s_res, *, h, w_sp, emit_i8=True,
    w1pp_nk=None, w2pp_nk=None,
):
    """Plain PyTorch version of ``basic_block_pp_pairs`` (the weights read
    from their K-major copies where given)."""
    w1pp, w2pp = _from_kmajor(w1pp, w1pp_nk), _from_kmajor(w2pp, w2pp_nk)
    b, hp, wp = _pp_geometry(xpp, h, w_sp)
    halves = _pp_halves(b, hp, wp, h, w_sp, xpp.device)
    f = {"a1": a1, "c1": c1, "a2": a2, "c2": c2, "s_res": s_res}
    return _pp_basic_folded(xpp, halves, wp // 2, w1pp, w2pp, f, emit_i8=emit_i8)


def _check_basic_pp(xpp, vecs, n_blocks, **weights) -> dict:
    """Validate a pair-space basic call; returns the K-major copies of its
    two pair-packed 3x3s (``_kmajor``)."""
    dev = xpp.device
    c2 = xpp.shape[1]
    lead = () if n_blocks is None else (n_blocks,)
    n = 1 if n_blocks is None else n_blocks
    _check_i8(dev, xpp=xpp)
    shapes = {"a1": (3 * n, c2), "c1": (*lead, c2), "a2": (3 * n, c2), "c2": (*lead, c2),
              "s_res": (n,)}
    for name, v in vecs.items():
        _build.require(v, name, torch.float32, dev, shapes[name])
    if c2 % 8:
        raise ValueError(f"the pair width must be a multiple of 8, got c2={c2}")
    return _basic_weights(dev, c2, lead, **weights)


def basic_block_pp_pairs(
    xpp, w1pp, a1, c1, w2pp, a2, c2, s_res, *, h, w_sp, emit_i8=True,
    w1pp_nk=None, w2pp_nk=None,
):
    """The pair-space entry of ``basic_block_chained_int8_pp``: xpp
    (B*hp*wp/2, c2) int8 pair rows; w1pp, w2pp (3c2, 3c2) int8 (their K-major
    copies ``w1pp_nk``, ``w2pp_nk``, else transposed per call); a1, a2 (3,
    c2), c1, c2 (c2,), s_res (1,) fp32, folded and lane-tiled.  Dense
    pair-space GEMMs on the int8 tile.  Returns (B*hp*wp/2, c2) pair rows,
    int8 or bf16, zero on ring halves."""
    if _build.runs_plain():
        return basic_block_pp_pairs_plain(
            xpp, w1pp, a1, c1, w2pp, a2, c2, s_res, h=h, w_sp=w_sp, emit_i8=emit_i8,
            w1pp_nk=w1pp_nk, w2pp_nk=w2pp_nk,
        )
    _pp_geometry(xpp, h, w_sp)
    nk = _check_basic_pp(xpp, {"a1": a1, "c1": c1, "a2": a2, "c2": c2, "s_res": s_res}, None,
                         w1pp=(w1pp, w1pp_nk), w2pp=(w2pp, w2pp_nk))
    return _build.call("basic_block_chained_int8_pp", PP_BASIC_BLOCK_INT8,
        xpp, nk["w1pp"], a1, c1, nk["w2pp"], a2, c2, s_res, h, w_sp, _kind(emit_i8))


#: Kernel 9 (block.py:2002): ``csrc/pp_block.cu``'s ``pp_basic_block_int8``,
#: on pair rows, the vectors folded and lane-tiled.
PP_BASIC_BLOCK_INT8 = _build.kernel_op(
    "pp_basic_block_int8",
    "(Tensor x, Tensor w1_nk, Tensor a1, Tensor c1, Tensor w2_nk, Tensor a2, Tensor c2, "
    "Tensor s_res, int h, int w, int out_kind) -> Tensor",
    plain=lambda x, w1_nk, a1, c1, w2_nk, a2, c2, s_res, h, w, out_kind: (
        basic_block_pp_pairs_plain(x, None, a1, c1, None, a2, c2, s_res, h=h, w_sp=w,
                                   emit_i8=out_kind == 0, w1pp_nk=w1_nk, w2pp_nk=w2_nk)),
    fake=lambda x, *a: x.new_empty(x.shape, dtype=_out_dtype(a[-1])),
)


def _pp_packed(wpq, c, wpp_nk):
    """A pair-packed 3x3 (..., 6c, 6c): the transposed view of the engine's
    K-major copy where given, else packed here from the kh-batched wpq (the
    pair entry then transposes it once)."""
    return _pp_pack_conv2(wpq, c) if wpp_nk is None else wpp_nk.transpose(-1, -2)


def _basic_pp_operands(xq, w1pq, sw1p, b1, w2pq, sw2p, b2, scales, h, w_sp, emit_i8,
                       w1pp_nk, w2pp_nk):
    """The pair-space operands of kernel 9, folded and lane-tiled as
    block.py:2033-2041 do."""
    c = sw1p.shape[-1] // 3
    _, _, wp = _basic_geometry(xq, c, h, w_sp)
    _pp_require(c, wp)
    f = _pp_tile(_fold_basic(scales, sw1p, b1, sw2p, b2, emit_i8))
    return (
        xq.reshape(-1, 2 * c), _pp_packed(w1pq, c, w1pp_nk), f["a1"], f["c1"],
        _pp_packed(w2pq, c, w2pp_nk), f["a2"], f["c2"], f["s_res"],
    ), c


def basic_block_chained_int8_pp_plain(
    xq, w1pq, sw1p, b1, w2pq, sw2p, b2, scales, *,
    h, w_sp, emit_i8=True, bt=None, interpret=False, w1pp_nk=None, w2pp_nk=None,
):
    """Plain PyTorch version of ``basic_block_chained_int8_pp``."""
    args, c = _basic_pp_operands(xq, w1pq, sw1p, b1, w2pq, sw2p, b2, scales, h, w_sp,
                                 emit_i8, w1pp_nk, w2pp_nk)
    return basic_block_pp_pairs_plain(*args, h=h, w_sp=w_sp, emit_i8=emit_i8, w1pp_nk=w1pp_nk,
                                      w2pp_nk=w2pp_nk).reshape(-1, c)


def basic_block_chained_int8_pp(
    xq, w1pq, sw1p, b1, w2pq, sw2p, b2, scales, *,
    h, w_sp, emit_i8=True, bt=None, interpret=False, w1pp_nk=None, w2pp_nk=None,
):
    """Pixel-paired stride-1 BasicBlock for the c=64 stage: the contract of
    ``basic_block_chained_int8``, computed in pair space.  ``w1pp_nk`` /
    ``w2pp_nk``: the K-major copies of the pair-packed (6c, 6c) 3x3s, made
    once per engine by ``fused.pack_chain_kmajor``; without them the
    wrapper packs and transposes once per call."""
    args, c = _basic_pp_operands(xq, w1pq, sw1p, b1, w2pq, sw2p, b2, scales, h, w_sp,
                                 emit_i8, w1pp_nk, w2pp_nk)
    return basic_block_pp_pairs(*args, h=h, w_sp=w_sp, emit_i8=emit_i8, w1pp_nk=w1pp_nk,
                                w2pp_nk=w2pp_nk).reshape(-1, c)


def basic_run_pp_pairs_plain(
    xpp, w1pp_s, a1s, c1s, w2pp_s, a2s, c2s, s_res, *, h, w_sp, emit_i8=True,
    w1pp_nk_s=None, w2pp_nk_s=None,
):
    """Plain PyTorch version of ``basic_run_pp_pairs`` (the weights read
    from their K-major copies where given)."""
    w1pp_s, w2pp_s = _from_kmajor(w1pp_s, w1pp_nk_s), _from_kmajor(w2pp_s, w2pp_nk_s)
    b, hp, wp = _pp_geometry(xpp, h, w_sp)
    halves = _pp_halves(b, hp, wp, h, w_sp, xpp.device)
    n_blocks = w1pp_s.shape[0]
    y = xpp
    for n in range(n_blocks):
        fn = {
            "a1": a1s[3 * n : 3 * n + 3], "c1": c1s[n],
            "a2": a2s[3 * n : 3 * n + 3], "c2": c2s[n], "s_res": s_res[n : n + 1],
        }
        y = _pp_basic_folded(y, halves, wp // 2, w1pp_s[n], w2pp_s[n], fn,
                             emit_i8=emit_i8 or n < n_blocks - 1)
    return y


def basic_run_pp_pairs(
    xpp, w1pp_s, a1s, c1s, w2pp_s, a2s, c2s, s_res, *, h, w_sp, emit_i8=True,
    w1pp_nk_s=None, w2pp_nk_s=None,
):
    """The pair-space entry of ``basic_run_chained_int8_pp``: stacked w1pp_s,
    w2pp_s (N, 3c2, 3c2) int8 (their K-major copies ``w1pp_nk_s``,
    ``w2pp_nk_s``, else transposed per call); a1s, a2s (3N, c2), c1s, c2s
    (N, c2), s_res (N,) fp32.  Dense pair-space GEMMs, as kernel 9."""
    if _build.runs_plain():
        return basic_run_pp_pairs_plain(
            xpp, w1pp_s, a1s, c1s, w2pp_s, a2s, c2s, s_res, h=h, w_sp=w_sp, emit_i8=emit_i8,
            w1pp_nk_s=w1pp_nk_s, w2pp_nk_s=w2pp_nk_s,
        )
    _pp_geometry(xpp, h, w_sp)
    nk = _check_basic_pp(xpp, {"a1": a1s, "c1": c1s, "a2": a2s, "c2": c2s, "s_res": s_res},
                         w1pp_s.shape[0], w1pp_s=(w1pp_s, w1pp_nk_s), w2pp_s=(w2pp_s, w2pp_nk_s))
    return _build.call("basic_run_chained_int8_pp", PP_BASIC_RUN_INT8,
        xpp, nk["w1pp_s"], a1s, c1s, nk["w2pp_s"], a2s, c2s, s_res, h, w_sp, not emit_i8)


#: Kernel 10 (block.py:2175): ``csrc/pp_block.cu``'s ``pp_basic_run_int8``.
PP_BASIC_RUN_INT8 = _build.kernel_op(
    "pp_basic_run_int8",
    "(Tensor x, Tensor w1s_nk, Tensor a1s, Tensor c1s, Tensor w2s_nk, Tensor a2s, Tensor c2s, "
    "Tensor s_res, int h, int w, bool last_bf16) -> Tensor",
    plain=lambda x, w1s_nk, a1s, c1s, w2s_nk, a2s, c2s, s_res, h, w, last_bf16: (
        basic_run_pp_pairs_plain(x, None, a1s, c1s, None, a2s, c2s, s_res, h=h, w_sp=w,
                                 emit_i8=not last_bf16, w1pp_nk_s=w1s_nk, w2pp_nk_s=w2s_nk)),
    fake=lambda x, *a: x.new_empty(x.shape, dtype=_out_dtype(int(a[-1]))),
)


def _basic_run_pp_operands(xq, w1pq_s, sw1p_s, b1_s, w2pq_s, sw2p_s, b2_s, scales_s,
                           h, w_sp, emit_i8, w1pp_nk_s, w2pp_nk_s):
    """The pair-space operands of kernel 10, folded and lane-tiled as
    block.py:2211-2230 do."""
    c = b1_s.shape[-1]
    _, _, wp = _basic_geometry(xq, c, h, w_sp)
    _pp_require(c, wp)
    f = _pp_tile(_fold_basic_run(scales_s, sw1p_s, b1_s, sw2p_s, b2_s, emit_i8))
    return (
        xq.reshape(-1, 2 * c), _pp_packed(w1pq_s, c, w1pp_nk_s), f["a1"], f["c1"],
        _pp_packed(w2pq_s, c, w2pp_nk_s), f["a2"], f["c2"], f["s_res"],
    ), c


def basic_run_chained_int8_pp_plain(
    xq, w1pq_s, sw1p_s, b1_s, w2pq_s, sw2p_s, b2_s, scales_s, *,
    h, w_sp, emit_i8=True, bt=None, interpret=False, w1pp_nk_s=None, w2pp_nk_s=None,
):
    """Plain PyTorch version of ``basic_run_chained_int8_pp``."""
    args, c = _basic_run_pp_operands(xq, w1pq_s, sw1p_s, b1_s, w2pq_s, sw2p_s, b2_s,
                                     scales_s, h, w_sp, emit_i8, w1pp_nk_s, w2pp_nk_s)
    return basic_run_pp_pairs_plain(*args, h=h, w_sp=w_sp, emit_i8=emit_i8,
                                    w1pp_nk_s=w1pp_nk_s, w2pp_nk_s=w2pp_nk_s).reshape(-1, c)


def basic_run_chained_int8_pp(
    xq, w1pq_s, sw1p_s, b1_s, w2pq_s, sw2p_s, b2_s, scales_s, *,
    h, w_sp, emit_i8=True, bt=None, interpret=False, w1pp_nk_s=None, w2pp_nk_s=None,
):
    """Pixel-paired run of N stride-1 BasicBlocks for the c=64 stage: the
    contract of ``basic_run_chained_int8``, computed in pair space.
    ``w1pp_nk_s`` / ``w2pp_nk_s``: the stacked K-major copies of the
    pair-packed 3x3s (see ``basic_block_chained_int8_pp``)."""
    args, c = _basic_run_pp_operands(xq, w1pq_s, sw1p_s, b1_s, w2pq_s, sw2p_s, b2_s,
                                     scales_s, h, w_sp, emit_i8, w1pp_nk_s, w2pp_nk_s)
    return basic_run_pp_pairs(*args, h=h, w_sp=w_sp, emit_i8=emit_i8, w1pp_nk_s=w1pp_nk_s,
                              w2pp_nk_s=w2pp_nk_s).reshape(-1, c)


# ---------------------------------------------------------------------------
# Kernels 17-18: the bf16 / fp32 stride-1 bottleneck block
#
# One block, ``y = relu(conv1x1(relu(conv3x3(relu(conv1x1(x) + b1)) + b2))
# + b3 + x)``, every dot in fp32 with z1 and z2 rounded to the compute type,
# the 3x3 summed per kernel row and then as (P0 + P1) + P2, as in
# block.py:152 ``_chained_kernel`` and :95 ``_block_kernel``.  The chained
# form reads only the interior rows of its input (a ring row may hold
# anything) and writes zeros to the ring rows of its output.
# ---------------------------------------------------------------------------

_FP_KIND = {torch.bfloat16: 1, torch.float32: 2}


def _fp_block_nhwc_plain(x, w1, b1, w2, b2, w3, b3):
    """The block on a (B, h, w, 4c) interior, every dot an fp32 matmul of
    upcast operands (bf16 products are exact in fp32)."""
    dt = x.dtype
    _, h, w_sp, _ = x.shape
    c = w1.shape[-1]
    xf = x.float()
    z1 = torch.relu(torch.matmul(xf, w1.float()) + b1.float()).to(dt)
    zp = F.pad(z1.float(), (0, 0, 1, 1, 1, 1))
    w2f = w2.float()
    acc = None
    for kh in range(3):
        taps = torch.cat([zp[:, kh : kh + h, kw : kw + w_sp] for kw in range(3)], dim=-1)
        part = torch.matmul(taps, w2f[kh].reshape(3 * c, c))
        acc = part if acc is None else acc + part
    z2 = torch.relu(acc + b2.float()).to(dt)
    y = torch.matmul(z2.float(), w3.float()) + b3.float()
    return torch.relu(y + xf).to(dt)


def _fp_weights(x, w1, w2, w3):
    """The 1x1 weights as matrices; checks the shapes against x's channels."""
    w1, w3 = _as_1x1(w1), _as_1x1(w3)
    c4, c = w1.shape
    if tuple(w2.shape) != (3, 3, c, c) or tuple(w3.shape) != (c, c4) or x.shape[-1] != c4:
        raise ValueError(f"weights {tuple(w1.shape)}, {tuple(w2.shape)}, {tuple(w3.shape)} "
                         f"do not make a bottleneck over {x.shape[-1]} channels")
    return w1, w3


def _fp_chain_geometry(xr, h, w_sp):
    hp, wp = chain_meta(0, h, w_sp)
    rows = xr.shape[0]
    b = rows // (hp * wp)
    if xr.ndim != 2 or b * hp * wp != rows:
        raise ValueError(f"xr {tuple(xr.shape)} is not a ({hp}x{wp}) chain")
    return b, hp, wp


def _fp_call(x, w1, b1, w2, b2, w3, b3, *, chain, h, w_sp):
    """Check a bf16 / fp32 block's operands, then call ``resnetc::fp_block``."""
    dt = x.dtype
    if dt not in _FP_KIND:
        raise ValueError(f"x: dtype {dt}, expected bf16 or fp32")
    dev = x.device
    c4, c = w1.shape
    x = x.contiguous()
    _build.require(x, "x", dt, dev)
    w1, w2, w3 = w1.contiguous(), w2.contiguous(), w3.contiguous()
    _build.require(w1, "w1", dt, dev, (c4, c))
    _build.require(w2, "w2", dt, dev, (3, 3, c, c))
    _build.require(w3, "w3", dt, dev, (c, c4))
    b1, b2, b3 = (v.float().contiguous() for v in (b1, b2, b3))
    _build.require(b1, "b1", torch.float32, dev, (c,))
    _build.require(b2, "b2", torch.float32, dev, (c,))
    _build.require(b3, "b3", torch.float32, dev, (c4,))
    name = "bottleneck_block_chained" if chain else "bottleneck_block_fused"
    return _build.call(name, FP_BLOCK, x, w1, b1, w2, b2, w3, b3, chain, h, w_sp)


def _fp_block_plain(x, w1, b1, w2, b2, w3, b3, chain, h, w):
    if chain:
        return bottleneck_block_chained_plain(x, w1, b1, w2, b2, w3, b3, h=h, w_sp=w)
    return bottleneck_block_fused_plain(x, w1, b1, w2, b2, w3, b3)


#: Kernels 17 and 18 (block.py:278, :3688): ``csrc/fp_block.cu``'s
#: ``fp_block``, over the chain layout (``chain``) or NHWC; counted under the
#: wrapper's name.
FP_BLOCK = _build.kernel_op(
    "fp_block",
    "(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, Tensor w3, Tensor b3, bool chain, "
    "int h, int w) -> Tensor",
    plain=_fp_block_plain, fake=lambda x, *a: torch.empty_like(x),
)


def bottleneck_block_chained_plain(xr, w1, b1, w2, b2, w3, b3, *, h, w_sp, bt=None,
                                   interpret=False):
    """Plain PyTorch version of ``bottleneck_block_chained``."""
    w1, w3 = _fp_weights(xr, w1, w2, w3)
    b, hp, wp = _fp_chain_geometry(xr, h, w_sp)
    x = xr.reshape(b, hp, wp, xr.shape[-1])[:, 1 : 1 + h, 1 : 1 + w_sp]
    return _chain_from_interior(_fp_block_nhwc_plain(x, w1, b1, w2, b2, w3, b3), hp, wp)


def bottleneck_block_chained(xr, w1, b1, w2, b2, w3, b3, *, h, w_sp, bt=None, interpret=False):
    """One stride-1 bottleneck block over the chained padded-row layout.

    xr: (B*Hp*Wp, 4c) bf16 / fp32 from ``pad_for_chain`` or a previous
    block; w1 (4c, c) or (1, 1, 4c, c), w2 (3, 3, c, c), w3 (c, 4c) or (1,
    1, c, 4c) in xr's type; fp32 biases.  Returns the same layout and type,
    with zeros on the ring rows."""
    if _build.runs_plain():
        return bottleneck_block_chained_plain(xr, w1, b1, w2, b2, w3, b3, h=h, w_sp=w_sp)
    w1, w3 = _fp_weights(xr, w1, w2, w3)
    _fp_chain_geometry(xr, h, w_sp)
    return _fp_call(xr, w1, b1, w2, b2, w3, b3, chain=True, h=h, w_sp=w_sp)


def bottleneck_block_fused_plain(x, w1, b1, w2, b2, w3, b3, *, bt=None, interpret=False):
    """Plain PyTorch version of ``bottleneck_block_fused``."""
    w1, w3 = _fp_weights(x, w1, w2, w3)
    return _fp_block_nhwc_plain(x, w1, b1, w2, b2, w3, b3)


def bottleneck_block_fused(x, w1, b1, w2, b2, w3, b3, *, bt=None, interpret=False):
    """One stride-1 bottleneck block, NHWC (B, H, W, 4c) bf16 / fp32 in and
    out, the zero ring implicit; weights as for ``bottleneck_block_chained``."""
    if _build.runs_plain():
        return bottleneck_block_fused_plain(x, w1, b1, w2, b2, w3, b3)
    w1, w3 = _fp_weights(x, w1, w2, w3)
    if x.ndim != 4:
        raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
    return _fp_call(x, w1, b1, w2, b2, w3, b3, chain=False, h=x.shape[1], w_sp=x.shape[2])
