#!/usr/bin/env python3
"""Chip smoke test of resnetc_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py [--batch 32] [--out results.json]

Builds the CUDA kernels from ``resnetc_tpu_torch/csrc``, checks that the
tensor-core kernels hold wgmma instructions in their SASS (HGMMA in the
bf16 tile's instantiations for rows 4, 13 and 14, stride 1 and stride 2
counted apart, and for row 17's bf16 block; IGMMA in the int8 tile of row
12 and in the block tile of rows 1-3 and 5-11, each library's
instantiations apart; no dp4a ``igemm_kernel`` left in the libraries of
the int8 blocks, and no serialized wgmma, C7515, in ptxas's report), and
then:

1. holds every kernel of the serving paths against its plain PyTorch
   version on the card, at the shapes of ResNet-152 (the bottleneck
   kernels, every 1x1 conv and the fc for ``int8_matmul`` and ``matmul``)
   and ResNet-34 (the basic kernels), both models' 3x3 shapes for the
   fused convolutions and the stem pool, 224 px, batch 8: int8 and bf16
   block outputs, ``int8_matmul`` and ``max_pool2d`` must be equal, the
   fused convolutions (and the bf16 GEMM) within 1 bf16 ulp or, in fp32,
   rtol 1e-4, fp32 per-image means and the fp32 GEMM within rtol 1e-4.  The
   pixel-paired stage-0 kernels are also held against their standard twins
   (equal) and, through their pair-space entries, checked on dense random
   pair-space weights, and the basic transition (row 11, x's ring random
   bytes) from the engine's K-major copies also against a per-call
   transpose (equal).  The kernels of the ``pallas_block`` backend and the
   op library at batch 8: ``bottleneck_block_chained`` at ResNet-152's four
   stage shapes in bf16, one in fp32, and as a 3-block chain at 7x7 (wp = w
   + 1) whose input ring holds NaN; ``bottleneck_block_fused`` at the four
   stage shapes; ``avg_pool2d`` (the 7x7 head pool in fp32 and bf16, and
   3x3/2/p1); ``relu``, ``add`` and ``add_relu`` at (8, 56, 56, 256) and
   (3, 17, 50) in bf16 and fp32.  The blocks within max error / max |plain|
   1e-2 in bf16 (z1 and z2 are rounded to bf16 inside the block) and rtol
   1e-4 in fp32, the pool and the elementwise ops equal;
2. prints the TUNED.json flags the port laid over its code defaults (they
   must turn on L1_PIXEL_PAIR and BASIC_DS_INT8), then serves ResNet-152
   and ResNet-34 at full width and depth (random weights from seed 0) at
   batch 32, the launch counters set to 0 just before each forward and read
   just after, every kernel of the route launched exactly as often as the
   model has convolutions or blocks of its kind:
   - ``InferenceEngine(backend="int8_chain")`` on the served route
     (pixel-paired stage 0) and on the standard route (L1_PIXEL_PAIR off),
     the two routes' logits equal bit for bit, within the JAX package's
     gate of the fp32 folded forward (rel-MAE 0.05 for the bottleneck route,
     0.08 for the basic one, argmax agreement 0.9; the bf16 fp engine's
     agreement is reported too); for ResNet-34 also the BASIC_DS_INT8=False
     route (transitions through the conv kernels), within the same gate;
   - ``InferenceEngine(backend="int8")``, ``backend="pallas"`` and
     ``backend="pallas_block"``, each under BF16 (served) and FP32, and on
     ResNet-152 ``fused_forward_int8_static`` under FP32, gated under FP32
     as the JAX package gates them: int8 rel-MAE 0.15 of the fp32 forward,
     int8_static 0.2, pallas and pallas_block max error 1e-3 of max
     |logit|; a ResNet-34 pallas_block forward launches what a pallas one
     does;
   every forward within 1e-2 (max error over max |logit|) of the same
   forward run through the plain versions, the int8 ones within 5e-2 (see
   INT8_PLAIN_LIMIT).  A ResNet-152 cut to (3, 2, 2, 2)
   blocks then runs with STAGE_FUSE_PROJ (all of layer1 one run kernel),
   paired and standard, equal bit for bit to the served route.  The op
   library is driven once through ``resnetc_tpu_torch.ops.cuda`` at batch
   32: a residual join (``add``, ``relu``, ``add_relu``) at ResNet-152's
   layer1 shape, and a layer4 block (``bottleneck_block_fused``) followed
   by the 7x7 head pool (``avg_pool2d``), each counted;
3. times the engines (images/s, p50 / p99 ms per batch) for int8_chain on
   both routes (and ResNet-34's BASIC_DS_INT8=False route), int8, pallas,
   pallas_block and fp, and each kernel per launch at the main paths'
   shapes: on the card (``ms``: ten launches queued behind a spin kernel,
   so that they run back to back, the median of five runs) and as called
   from Python (``eager_ms``: the median of five event-timed loops, host
   cost included), beside the plain version, the bound (for a pixel-paired
   kernel, the work of its standard twin), the TFLOP/s and share of the
   bound of each shape (printed for the tensor-core kernels, rows 1-14
   and 17, with the ratio to the library call; TOP/s for the int8 ones;
   and for the average pool's shapes, with its ratio to F.avg_pool2d), and a
   library call that the port never makes, timed like ``ms``:
   torch.matmul for the GEMM, torch._int_mm for int8_matmul (int32 out, no
   epilogue), F.conv2d (bf16, channels-last) for the fused convolutions,
   F.max_pool2d and F.avg_pool2d for the pools, torch.relu and torch.add
   for relu and add (none computes add_relu or a whole block).

Prints the card (``nvidia-smi`` name and power limit), one JSON line of
per-kernel results, and as its last line ``{"ok": true, "device": ...}``.
Exits non-zero, without that line, when CUDA is absent or a phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
import warnings

#: Peak rates of one H100 SXM (dense): int8 tensor cores, bf16 tensor
#: cores, fp32 outside the tensor cores, HBM bandwidth.
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# ResNet-152 at 224 px: (h, c, c4) per stage after the stem and pool.
STAGES = [(56, 64, 256), (28, 128, 512), (14, 256, 1024), (7, 512, 2048)]
# ResNet-34 at 224 px: (h, c) per stage.
BASIC_STAGES = [(56, 64), (28, 128), (14, 256), (7, 512)]


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


#: Repeats of each timing loop; the median is kept (one mean of one loop
#: caught 2.7-3.8x outliers).
REPEATS = 5


def time_ms(fn, iters: int, warmup: int = 2, repeats: int = REPEATS) -> float:
    """ms per call: the median over ``repeats`` of the mean of ``iters``
    back-to-back calls between two CUDA events.  Where the host cannot keep
    ahead of the card (a short kernel behind a ctypes wrapper) this is the
    host's time per call."""
    import statistics

    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(fn, iters: int, repeats: int = REPEATS) -> float | None:
    """ms per call on the card: ``iters`` calls enqueued while the card is
    still busy with a spin kernel, so that they run back to back with no
    host time between them (the start event fires after the spin); the
    median over ``repeats``.  The spin doubles until the host is ahead; a
    call that waits for the card itself (a copy from pageable host memory)
    never lets it get ahead, and then this returns None.  Inputs stay in L2
    where they fit, for a kernel and its library call alike."""
    import statistics

    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    times = []
    while len(times) < repeats:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()  # the spin still ran when the last call was queued
        torch.cuda.synchronize()
        if ahead:
            times.append(start.elapsed_time(end) / iters)
        elif cycles >= 1 << 27:
            return None
        else:
            cycles *= 2
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Kernel cases at ResNet-152 shapes
# ---------------------------------------------------------------------------


class Case:
    """One kernel call: the wrapper, its plain version, the arguments, and
    the least work it must do (ops at the peak rate, bytes at HBM rate)."""

    def __init__(self, name, kernel, fn, plain, args, kwargs, ops, nbytes, peak, check,
                 twin=None, per_forward=None, twin_kwargs=None):
        self.name, self.kernel = name, kernel
        self.fn, self.plain, self.args, self.kwargs = fn, plain, args, kwargs
        self.ops, self.nbytes, self.peak, self.check = ops, nbytes, peak, check
        # The call this one must equal: a pixel-paired kernel's standard twin,
        # or the basic transition without the engine's K-major copies.
        self.twin = twin
        # The twin's keyword arguments (the pixel-paired kernels' pair-packed
        # weight copies are theirs alone).
        self.twin_kwargs = kwargs if twin_kwargs is None else twin_kwargs
        # Launches per forward on the route that runs it, where
        # main_path_counts has no entry for the case.
        self.per_forward = per_forward

    def run(self):
        return self.fn(*self.args, **self.kwargs)

    def run_plain(self):
        return self.plain(*self.args, **self.kwargs)

    @property
    def bound_ms(self) -> float:
        return max(self.ops / self.peak, self.nbytes / PEAK_BYTES) * 1e3

    @property
    def bound_by(self) -> str:
        return "operations" if self.ops / self.peak >= self.nbytes / PEAK_BYTES else "bytes"

    def library(self):
        """One PyTorch call computing the same function on these inputs (a
        yardstick the port never calls), or None: torch.matmul for the GEMM
        (no epilogue), torch._int_mm for int8_matmul (int32 out, no
        epilogue; it takes M > 16 and K, N multiples of 8), F.conv2d with
        the bias in bf16 / fp32 channels-last for the fused convolutions
        (no residual), F.max_pool2d and F.avg_pool2d (channels-last) for the
        pools, torch.relu and torch.add."""
        import torch
        import torch.nn.functional as F

        a = self.args
        if self.kernel == "matmul":
            return lambda: torch.matmul(a[0], a[1])
        if self.kernel == "int8_matmul":
            m, k = a[0].shape
            n = a[1].shape[1]
            if m <= 16 or k % 8 or n % 8:
                return None
            return lambda: torch._int_mm(a[0], a[1])
        if self.kernel in ("conv3x3_s1_fused", "conv_s2_fused"):
            x = a[0].permute(0, 3, 1, 2)  # NHWC memory: channels-last NCHW
            w = a[1].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            stride = 1 if self.kernel == "conv3x3_s1_fused" else 2
            return lambda: F.conv2d(x, w, a[2].to(x.dtype), stride=stride,
                                    padding=w.shape[-1] // 2)
        if self.kernel in ("max_pool2d", "avg_pool2d"):
            x = a[0].permute(0, 3, 1, 2)
            pool = F.max_pool2d if self.kernel == "max_pool2d" else F.avg_pool2d
            return lambda: pool(x, self.kwargs["kernel_size"], self.kwargs["stride"],
                                self.kwargs["padding"])
        if self.kernel == "relu":
            return lambda: torch.relu(a[0])
        if self.kernel == "add":
            return lambda: torch.add(a[0], a[1])
        return None


def _block_weights(gen, cin, c, c4, dev, *, proj=False, ds=False):
    import torch

    from resnetc_tpu_torch.ops.cuda import block

    def entry(shape, fan_in):
        return {
            "weight": torch.randn(shape, generator=gen) / fan_in**0.5,
            "bias": torch.randn(shape[-1], generator=gen) * 0.02,
        }

    blk = {
        "conv1": entry((1, 1, cin, c), cin),
        "conv2": entry((3, 3, c, c), 9 * c),
        "conv3": entry((1, 1, c, c4), c),
    }
    if proj or ds:
        blk["downsample"] = entry((1, 1, cin, c4), cin)
    if ds:
        q = block.quantize_ds_block(blk)
    else:
        q = block.quantize_chain_block(blk)
        if proj:
            from resnetc_tpu_torch.ops.cuda.quant import quantize_per_channel

            q["wdq"], q["swd"] = quantize_per_channel(blk["downsample"]["weight"][0, 0])
            q["bd"] = blk["downsample"]["bias"]
    return {k: v.to(dev) for k, v in q.items()}


def _chain(gen, b, h, cin, dev):
    import torch

    from resnetc_tpu_torch.ops.cuda.block import chain_meta

    hp, wp = chain_meta(b, h, h)
    return torch.randint(-127, 128, (b * hp * wp, cin), generator=gen, dtype=torch.int8).to(dev)


def _dense_pairs(gen, dev, rows2):
    """Makers of dense random pair-space operands: pair rows, int8 weights in
    [-20, 20] over every block (no zero block), multipliers sized to the
    dot's depth k (an output spread of about ten int8 steps), biases."""
    import torch

    def x(width):
        return torch.randint(-127, 128, (rows2, width), generator=gen, dtype=torch.int8).to(dev)

    def wq(*shape):
        return torch.randint(-20, 21, shape, generator=gen, dtype=torch.int8).to(dev)

    def mul(*shape, k):
        u = torch.rand(shape, generator=gen) + 0.5
        return (u * 10.0 / (k**0.5 * 40.0 * 12.0)).to(dev)

    def bias(*shape):
        return (torch.randn(shape, generator=gen) * 0.5).to(dev)

    return x, wq, mul, bias


KEYS = ("w1q", "sw1", "b1", "w2pq", "sw2p", "b2", "w3q", "sw3", "b3")
BASIC_KEYS = ("w1pq", "sw1p", "b1", "w2pq", "sw2p", "b2")


def make_cases(b: int, dev) -> list:
    """Every bottleneck kernel at the main path's ResNet-152 shapes, plus
    the bf16 exit form of kernel 1 (not on the path; checked all the same),
    the pixel-paired stage-0 kernels in every form, and those on dense
    pair-space weights."""
    import torch

    from resnetc_tpu_torch.models import get_config
    from resnetc_tpu_torch.ops.cuda import block, gemm
    from resnetc_tpu_torch.ops.cuda.block import chain_meta
    from resnetc_tpu_torch.ops.cuda.fused import (kmajor_copies, kmajor_kwargs,
                                                  kmajor_run_kwargs, pack_chain_kmajor,
                                                  pp_run_operands)

    gen = torch.Generator().manual_seed(1234)

    def pp_packed(blocks):
        """The engine's tree (pack_chain_kmajor) of stage-0 blocks."""
        layer = {str(i): q for i, q in enumerate(blocks)}
        return pack_chain_kmajor(get_config("resnet152"), {f"layer{s + 1}": layer for s in range(4)})

    scales = torch.full((4,), 0.05, dtype=torch.float32, device=dev)
    cases = []

    def block_case(label, h, cin, c, c4, *, proj=False, emit_i8=True, emit_mean=False,
                   pp=False):
        q = _block_weights(gen, cin, c, c4, dev, proj=proj)
        x = _chain(gen, b, h, cin, dev)
        kw = dict(h=h, w_sp=h, emit_i8=emit_i8)
        if emit_mean:
            kw["emit_mean"] = True
        if proj:
            kw.update(wdq=q["wdq"], swd=q["swd"], bd=q["bd"])
        # The engine's K-major copies (pack_chain_kmajor): the pair-space
        # ones for the pixel-paired kernel, the standard ones for its twin.
        twin_kw = dict(kw, **kmajor_copies(q))
        kw = dict(kw, **kmajor_kwargs(pp_packed([q])["layer1"]["0"], pp=True)) if pp else twin_kw
        hp, wp = chain_meta(b, h, h)
        px = b * h * h
        ops = 2 * px * (cin * c + 9 * c * c + c * c4 + (cin * c4 if proj else 0))
        w_bytes = cin * c + 9 * c * c + c * c4 + (cin * c4 if proj else 0)
        out_bytes = b * c4 * 4 if emit_mean else b * hp * wp * c4 * (1 if emit_i8 else 2)
        nbytes = b * hp * wp * cin + w_bytes + out_bytes
        check = "int8" if emit_i8 else ("f32" if emit_mean else "bf16")
        if pp:
            kernel, fn, plain = ("bottleneck_block_chained_int8_pp",
                                 block.bottleneck_block_chained_int8_pp,
                                 block.bottleneck_block_chained_int8_pp_plain)
        else:
            kernel, fn, plain = ("bottleneck_block_chained_int8",
                                 block.bottleneck_block_chained_int8,
                                 block.bottleneck_block_chained_int8_plain)
        cases.append(Case(
            label, kernel, fn, plain, (x, *(q[k] for k in KEYS), scales), kw, ops, nbytes,
            PEAK_INT8_OPS, check, twin=block.bottleneck_block_chained_int8 if pp else None,
            twin_kwargs=twin_kw,
        ))

    h0, c0, c40 = STAGES[0]
    block_case("block/proj/s0", h0, c0, c0, c40, proj=True)
    for s in (1, 2, 3):
        h, c, c4 = STAGES[s]
        block_case(f"block/identity/s{s}", h, c4, c, c4)
    h3, c3, c43 = STAGES[3]
    block_case("block/emit_mean/s3", h3, c43, c3, c43, emit_i8=False, emit_mean=True)
    block_case("block/bf16_exit/s3", h3, c43, c3, c43, emit_i8=False)

    # Kernels 2 and 6: layer1 blocks 1-2 as one run; the projection form
    # (all of layer1, STAGE_FUSE_PROJ).
    def run_case(label, n, *, proj=False, emit_i8=True, pp=False):
        qs = [_block_weights(gen, c40, c0, c40, dev) for _ in range(n)]
        kw = dict(h=h0, w_sp=h0, emit_i8=emit_i8)
        cin = c40
        if proj:
            cin = c0
            qs[0] = _block_weights(gen, c0, c0, c40, dev, proj=True)
            kw.update(w1q0=qs[0]["w1q"], wdq=qs[0]["wdq"], swd=qs[0]["swd"], bd=qs[0]["bd"])
        twin_kw = dict(kw, **kmajor_run_kwargs([{**q, **kmajor_copies(q)} for q in qs],
                                               proj=proj))
        if pp:  # the engine's pair copies: qs[0] stands in as block 0 ahead of a run
            blocks = qs if proj else [qs[0], *qs]
            packed = pp_packed(blocks)
            layer = [packed["layer1"][str(i)] for i in range(len(blocks))]
            kw.update(pp_run_operands(layer, packed["runs"]["layer1"], 0 if proj else 1)[1])
        else:
            kw = twin_kw
        hp, wp = chain_meta(b, h0, h0)
        px = b * h0 * h0
        w_elems = n * (c40 * c0 + 9 * c0 * c0 + c0 * c40) + (
            (c0 - c40) * c0 + c0 * c40 if proj else 0)
        kernel = "bottleneck_run_chained_int8" + ("_pp" if pp else "")
        fn = getattr(block, kernel)
        cases.append(Case(
            label, kernel, fn, getattr(block, kernel + "_plain"),
            (_chain(gen, b, h0, cin, dev),
             torch.stack([q["w1q"] for q in qs[1 if proj else 0:]]),
             *(torch.stack([q[k] for q in qs]) for k in KEYS[1:]),
             torch.full((n, 4), 0.05, dtype=torch.float32, device=dev)),
            kw, 2 * px * w_elems,
            b * hp * wp * (cin + c40 * (1 if emit_i8 else 2)) + w_elems,
            PEAK_INT8_OPS, "int8" if emit_i8 else "bf16",
            twin=block.bottleneck_run_chained_int8 if pp else None, twin_kwargs=twin_kw,
        ))

    run_case("run/n2/s0", 2)

    # Kernel 3: the three stride-2 transitions.
    dkeys = ("w1q", "sw1", "b1", "w2q", "sw2", "b2", "w3q", "sw3", "b3", "wdq", "swd", "bd")
    for s in (1, 2, 3):
        h_in, _, cin = STAGES[s - 1]
        h, c, c4 = STAGES[s]
        q = _block_weights(gen, cin, c, c4, dev, ds=True)
        x = _chain(gen, b, h_in, cin, dev)
        hp, wp = chain_meta(b, h_in, h_in)
        hp2, wp2 = chain_meta(b, h, h)
        ops = 2 * (b * h_in * h_in * cin * c + b * h * h * (9 * c * c + c * c4 + cin * c4))
        nbytes = (b * hp * wp * cin + cin * c + 9 * c * c + c * c4 + cin * c4
                  + b * hp2 * wp2 * c4)
        cases.append(Case(
            f"ds/s{s}", "downsample_block_s2_int8", block.downsample_block_s2_int8,
            block.downsample_block_s2_int8_plain,
            (x, *(q[k] for k in dkeys), scales),
            dict(h=h_in, w_sp=h_in, **kmajor_copies(q)),  # the engine's K-major copies
            ops, nbytes, PEAK_INT8_OPS, "int8",
        ))

    # Kernel 4: the fc head.
    feats = torch.randn((b, 2048), generator=gen).to(dev, torch.bfloat16)
    w = (torch.randn((2048, 1000), generator=gen) / 2048**0.5).to(dev, torch.bfloat16)
    bias = (torch.randn(1000, generator=gen) * 0.01).to(dev)
    cases.append(Case(
        "matmul/fc", "matmul", gemm.matmul, gemm.matmul_plain,
        (feats, w, bias), dict(out_dtype=torch.float32),
        2 * b * 2048 * 1000, b * 2048 * 2 + 2048 * 1000 * 2 + 1000 * 4 + b * 1000 * 4,
        PEAK_BF16_FLOPS, "f32",
    ))

    # Kernels 5 and 6, the pixel-paired stage 0 (the served route).  The
    # bound counts the standard twin's work.
    block_case("pp/block/proj/s0", h0, c0, c0, c40, proj=True, pp=True)
    block_case("pp/block/identity/s0", h0, c40, c0, c40, pp=True)
    block_case("pp/block/bf16_exit/s0", h0, c40, c0, c40, emit_i8=False, pp=True)
    run_case("pp/run/n2/s0", 2, pp=True)
    run_case("pp/run/bf16_exit/n2/s0", 2, emit_i8=False, pp=True)
    run_case("pp/run/proj/n3/s0", 3, proj=True, pp=True)

    # ... and their pair-space entries on dense random pair-space weights.
    hp, wp = chain_meta(b, h0, h0)
    x, wq, mul, bias = _dense_pairs(gen, dev, b * hp * wp // 2)
    c2, c4p, n = 2 * c0, 2 * c40, 3
    s_res = torch.full((n,), 0.5, dtype=torch.float32, device=dev)
    px = b * h0 * h0
    twin_ops = 2 * px * (c40 * c0 + 9 * c0 * c0 + c0 * c40)
    cases.append(Case(
        "pp/dense/block/s0", "bottleneck_block_chained_int8_pp", block.bottleneck_block_pp_pairs,
        block.bottleneck_block_pp_pairs_plain,
        (x(c4p), wq(c4p, c2), mul(c2, k=c4p), bias(c2), wq(3 * c2, 3 * c2),
         mul(3, c2, k=3 * c2), bias(c2), wq(c2, c4p), mul(c4p, k=c2), bias(c4p), s_res[:1]),
        dict(h=h0, w_sp=h0), twin_ops, 2 * b * hp * wp * c40, PEAK_INT8_OPS, "int8",
    ))
    cases.append(Case(
        "pp/dense/run/proj/n3/s0", "bottleneck_run_chained_int8_pp",
        block.bottleneck_run_pp_pairs, block.bottleneck_run_pp_pairs_plain,
        (x(c2), wq(n - 1, c4p, c2), mul(n, c2, k=c4p), bias(n, c2), wq(n, 3 * c2, 3 * c2),
         mul(3 * n, c2, k=3 * c2), bias(n, c2), wq(n, c2, c4p), mul(n, c4p, k=c2),
         bias(n, c4p), s_res),
        dict(h=h0, w_sp=h0, w10bd=wq(c2, c2), wdbd=wq(c2, c4p), ad=mul(c4p, k=c2),
             cd=bias(c4p)),
        n * twin_ops, b * hp * wp * (c0 + c40), PEAK_INT8_OPS, "int8",
    ))
    return cases


def _basic_weights(gen, cin, c, dev, *, ds=False):
    import torch

    from resnetc_tpu_torch.ops.cuda import block

    def entry(shape, fan_in):
        return {
            "weight": torch.randn(shape, generator=gen) / fan_in**0.5,
            "bias": torch.randn(shape[-1], generator=gen) * 0.02,
        }

    blk = {"conv1": entry((3, 3, cin, c), 9 * cin), "conv2": entry((3, 3, c, c), 9 * c)}
    if ds:
        blk["downsample"] = entry((1, 1, cin, c), cin)
        q = block.quantize_basic_ds_block(blk)
    else:
        q = block.quantize_basic_block(blk)
    return {k: v.to(dev) for k, v in q.items() if isinstance(v, torch.Tensor)}


def make_basic_cases(b: int, dev) -> list:
    """Every basic kernel at the ResNet-34 main path's shapes: the stage-0
    run of three blocks, the stride-1 block at stages 1-3 (int8 exit, and
    the bf16 exit of the network's last block at 7x7, where wp = w+1), the
    three stride-2 transitions; and the pixel-paired stage-0 block and run,
    also on dense pair-space weights."""
    import torch

    from resnetc_tpu_torch.models import get_config
    from resnetc_tpu_torch.ops.cuda import block, fused
    from resnetc_tpu_torch.ops.cuda.block import chain_meta

    gen = torch.Generator().manual_seed(4321)
    scales = torch.full((3,), 0.05, dtype=torch.float32, device=dev)
    cases = []

    def packed(qs):
        """The engine's copies of stacked blocks (fused.pack_chain_kmajor):
        the K-major kh-batched 3x3s and, at c = 64, the pair-packed ones."""
        tree = {f"layer{s + 1}": {str(i): q for i, q in enumerate(qs)} for s in range(4)}
        return fused.pack_chain_kmajor(get_config("resnet34"), tree)["runs"]["layer1"]

    def block_case(label, h, c, *, emit_i8=True, pp=False):
        q = _basic_weights(gen, c, c, dev)
        hp, wp = chain_meta(b, h, h)
        ops = 2 * b * h * h * 18 * c * c
        nbytes = b * hp * wp * c * (2 if emit_i8 else 3) + 18 * c * c
        kernel = "basic_block_chained_int8" + ("_pp" if pp else "")
        kw = dict(h=h, w_sp=h, emit_i8=emit_i8)
        run = packed([q])
        nk = {"w1pq_nk": run["w1pq_nk_s"][0], "w2pq_nk": run["w2pq_nk_s"][0]}
        pp_nk = {"w1pp_nk": run["w1pp_nk_s"][0], "w2pp_nk": run["w2pp_nk_s"][0]} if pp else {}
        cases.append(Case(
            label, kernel, getattr(block, kernel), getattr(block, kernel + "_plain"),
            (_chain(gen, b, h, c, dev), *(q[k] for k in BASIC_KEYS), scales),
            dict(kw, **(pp_nk if pp else nk)), ops, nbytes, PEAK_INT8_OPS,
            "int8" if emit_i8 else "bf16",
            twin=block.basic_block_chained_int8 if pp else None, twin_kwargs=dict(kw, **nk),
        ))

    for s in (1, 2, 3):
        h, c = BASIC_STAGES[s]
        block_case(f"basic/block/s{s}", h, c)
    h3, c3 = BASIC_STAGES[3]
    block_case("basic/block/bf16_exit/s3", h3, c3, emit_i8=False)

    h0, c0 = BASIC_STAGES[0]

    def run_case(label, n, *, emit_i8=True, pp=False):
        qs = [_basic_weights(gen, c0, c0, dev) for _ in range(n)]
        hp, wp = chain_meta(b, h0, h0)
        kernel = "basic_run_chained_int8" + ("_pp" if pp else "")
        kw = dict(h=h0, w_sp=h0, emit_i8=emit_i8)
        run = packed(qs)
        nk = {k: run[k] for k in ("w1pq_nk_s", "w2pq_nk_s")}
        pp_nk = {k: run[k] for k in ("w1pp_nk_s", "w2pp_nk_s")}
        cases.append(Case(
            label, kernel, getattr(block, kernel), getattr(block, kernel + "_plain"),
            (_chain(gen, b, h0, c0, dev), *(torch.stack([q[k] for q in qs]) for k in BASIC_KEYS),
             torch.full((n, 3), 0.05, dtype=torch.float32, device=dev)),
            dict(kw, **(pp_nk if pp else nk)),
            n * 2 * b * h0 * h0 * 18 * c0 * c0,
            b * hp * wp * c0 * (2 if emit_i8 else 3) + n * 18 * c0 * c0,
            PEAK_INT8_OPS, "int8" if emit_i8 else "bf16",
            twin=block.basic_run_chained_int8 if pp else None, twin_kwargs=dict(kw, **nk),
        ))

    run_case("basic/run/n3/s0", 3)

    dkeys = ("w1pq", "sw1", "b1", "w2pq", "sw2p", "b2", "wdq", "swd", "bd")
    for s in (1, 2, 3):
        h_in, cin = BASIC_STAGES[s - 1]
        h, c = BASIC_STAGES[s]
        q = _basic_weights(gen, cin, c, dev, ds=True)
        hp, wp = chain_meta(b, h_in, h_in)
        hp2, wp2 = chain_meta(b, h, h)
        ops = 2 * b * h * h * (9 * cin * c + 9 * c * c + cin * c)
        nbytes = b * hp * wp * cin + 9 * cin * c + 9 * c * c + cin * c + b * hp2 * wp2 * c
        kw = dict(h=h_in, w_sp=h_in)
        cases.append(Case(
            f"basic/ds/s{s}", "basic_ds_block_s2_int8", block.basic_ds_block_s2_int8,
            block.basic_ds_block_s2_int8_plain,
            (_chain(gen, b, h_in, cin, dev), *(q[k] for k in dkeys), scales),
            dict(kw, **fused.basic_ds_kmajor_copies(q)), ops, nbytes, PEAK_INT8_OPS, "int8",
            twin=block.basic_ds_block_s2_int8, twin_kwargs=kw,
        ))

    # The fc head of ResNet-34 (512 -> 1000).
    from resnetc_tpu_torch.ops.cuda import gemm

    feats = torch.randn((b, 512), generator=gen).to(dev, torch.bfloat16)
    w = (torch.randn((512, 1000), generator=gen) / 512**0.5).to(dev, torch.bfloat16)
    bias = (torch.randn(1000, generator=gen) * 0.01).to(dev)
    cases.append(Case(
        "basic/matmul/fc", "matmul", gemm.matmul, gemm.matmul_plain,
        (feats, w, bias), dict(out_dtype=torch.float32),
        2 * b * 512 * 1000, b * 512 * 2 + 512 * 1000 * 2 + 1000 * 4 + b * 1000 * 4,
        PEAK_BF16_FLOPS, "f32",
    ))

    # Kernels 9 and 10, the pixel-paired stage 0 (the served route, a run of
    # three in ResNet-34); bound: the standard twin's work.
    block_case("pp/basic/block/s0", h0, c0, pp=True)
    block_case("pp/basic/block/bf16_exit/s0", h0, c0, emit_i8=False, pp=True)
    run_case("pp/basic/run/n3/s0", 3, pp=True)
    run_case("pp/basic/run/bf16_exit/n3/s0", 3, emit_i8=False, pp=True)

    hp, wp = chain_meta(b, h0, h0)
    x, wq, mul, bias = _dense_pairs(gen, dev, b * hp * wp // 2)
    c2, n = 2 * c0, 3
    s_res = torch.full((n,), 0.5, dtype=torch.float32, device=dev)
    twin_ops = 2 * b * h0 * h0 * 18 * c0 * c0
    cases.append(Case(
        "pp/dense/basic/block/s0", "basic_block_chained_int8_pp", block.basic_block_pp_pairs,
        block.basic_block_pp_pairs_plain,
        (x(c2), wq(3 * c2, 3 * c2), mul(3, c2, k=3 * c2), bias(c2), wq(3 * c2, 3 * c2),
         mul(3, c2, k=3 * c2), bias(c2), s_res[:1]),
        dict(h=h0, w_sp=h0), twin_ops, 2 * b * hp * wp * c0, PEAK_INT8_OPS, "int8",
    ))
    cases.append(Case(
        "pp/dense/basic/run/n3/s0", "basic_run_chained_int8_pp", block.basic_run_pp_pairs,
        block.basic_run_pp_pairs_plain,
        (x(c2), wq(n, 3 * c2, 3 * c2), mul(3 * n, c2, k=3 * c2), bias(n, c2),
         wq(n, 3 * c2, 3 * c2), mul(3 * n, c2, k=3 * c2), bias(n, c2), s_res),
        dict(h=h0, w_sp=h0), n * twin_ops, 2 * b * hp * wp * c0, PEAK_INT8_OPS, "int8",
    ))
    return cases


# ResNet-152's 1x1 convolutions at 224 px on the int8 and pallas paths,
# per stage: (label, output h, K, N, residual, relu, launches per forward).
# Block 0's conv1 runs at the stage's input size (the stride is on conv2).
def _one_by_one_shapes() -> list:
    blocks = (3, 8, 36, 3)
    out = []
    for s, (h, c, c4) in enumerate(STAGES):
        cin = 64 if s == 0 else STAGES[s - 1][2]
        out += [
            (f"s{s}/b0/conv1", h if s == 0 else 2 * h, cin, c, False, True, 1),
            (f"s{s}/b0/downsample", h, cin, c4, False, False, 1),
            (f"s{s}/b0/conv3", h, c, c4, True, True, 1),
            (f"s{s}/id/conv1", h, c4, c, False, True, blocks[s] - 1),
            (f"s{s}/id/conv3", h, c, c4, True, True, blocks[s] - 1),
        ]
    return out


def make_backend_cases(b: int, dev) -> list:
    """The kernels of the int8 and pallas backends at the main paths'
    shapes: every 1x1 conv and the fc of ResNet-152 through int8_matmul
    (given the K-major weight copy, as the int8 engine's packed tree gives
    it; and, for the pallas backend, through matmul in bf16), every 3x3 of
    ResNet-152 and ResNet-34 through the fused convolutions (bf16, plus an
    fp32 form of two shapes, off the served path), and the stem pool."""
    import torch

    from resnetc_tpu_torch.ops.cuda import conv, gemm, pool, quant

    gen = torch.Generator().manual_seed(5678)
    cases = []

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    for label, h, k, n, res, relu, count in _one_by_one_shapes():
        m = b * h * h
        xq = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8).to(dev)
        wq = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8).to(dev)
        sw = (torch.rand(n, generator=gen) * 2e-4 + 1e-5).to(dev)
        bias = randn(n, scale=0.1, dtype=torch.float32)
        r = randn(m, n) if res else None
        cases.append(Case(
            f"int8/{label}", "int8_matmul", quant.int8_matmul, quant.int8_matmul_plain,
            (xq, wq, torch.tensor(0.02, device=dev), sw, bias, r),
            dict(relu=relu, out_dtype=torch.bfloat16, w_nk=wq.t().contiguous()), 2 * m * k * n,
            m * k + k * n + 8 * n + m * n * (4 if res else 2), PEAK_INT8_OPS, "bf16",
            per_forward=count,
        ))
        cases.append(Case(
            f"pallas/{label}", "matmul", gemm.matmul, gemm.matmul_plain,
            (randn(m, k), randn(k, n, scale=k**-0.5), bias, r), dict(relu=relu),
            2 * m * k * n, 2 * (m * k + k * n) + 4 * n + m * n * (4 if res else 2),
            PEAK_BF16_FLOPS, "bf16ulp", per_forward=count,
        ))
    m, k, n = b, 2048, 1000
    wq = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8).to(dev)
    cases.append(Case(
        "int8/fc", "int8_matmul", quant.int8_matmul, quant.int8_matmul_plain,
        (torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8).to(dev), wq,
         torch.tensor(0.02, device=dev), (torch.rand(n, generator=gen) * 2e-4).to(dev),
         randn(n, scale=0.1, dtype=torch.float32)),
        dict(out_dtype=torch.float32, w_nk=wq.t().contiguous()), 2 * m * k * n,
        m * k + k * n + 8 * n + 4 * m * n,
        PEAK_INT8_OPS, "f32eq", per_forward=1,
    ))

    def conv_case(label, kernel, h, cin, cout, k, stride, count, *, res=False,
                  dtype=torch.bfloat16):
        oh = (h + 2 * (k // 2) - k) // stride + 1
        x = randn(b, h, h, cin, dtype=dtype)
        w = randn(k, k, cin, cout, scale=(k * k * cin) ** -0.5, dtype=dtype)
        bias = randn(cout, scale=0.1, dtype=torch.float32)
        args = (x, w, bias) + ((randn(b, oh, oh, cout, dtype=dtype),) if res else ())
        fn, plain = ((conv.conv3x3_s1_fused, conv.conv3x3_s1_fused_plain) if stride == 1
                     else (conv.conv_s2_fused, conv.conv_s2_fused_plain))
        size = 2 if dtype == torch.bfloat16 else 4
        nbytes = size * (b * h * h * cin + k * k * cin * cout
                         + b * oh * oh * cout * (2 if res else 1))
        cases.append(Case(
            label, kernel, fn, plain, args, dict(relu=True),
            2 * b * oh * oh * k * k * cin * cout, nbytes + 4 * cout,
            PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS,
            "bf16ulp" if dtype == torch.bfloat16 else "f32", per_forward=count,
        ))

    blocks = (3, 8, 36, 3)
    for s, (h, c, _) in enumerate(STAGES):
        conv_case(f"conv3x3/r152/s{s}", "conv3x3_s1_fused", h, c, c, 3, 1,
                  blocks[s] - (s > 0))
    basic = (3, 4, 6, 3)
    for s, (h, c) in enumerate(BASIC_STAGES):
        conv_case(f"conv3x3/r34/s{s}/conv1", "conv3x3_s1_fused", h, c, c, 3, 1,
                  basic[s] - (s > 0))
        conv_case(f"conv3x3/r34/s{s}/conv2", "conv3x3_s1_fused", h, c, c, 3, 1, basic[s],
                  res=True)
    for s in (1, 2, 3):
        h, c, _ = STAGES[s]
        conv_case(f"conv_s2/r152/s{s}", "conv_s2_fused", 2 * h, c, c, 3, 2, 1)
        h, c = BASIC_STAGES[s]
        conv_case(f"conv_s2/r34/s{s}", "conv_s2_fused", 2 * h, c // 2, c, 3, 2, 1)
    conv_case("conv3x3/fp32/s1", "conv3x3_s1_fused", 28, 128, 128, 3, 1, 0, res=True,
              dtype=torch.float32)
    conv_case("conv_s2/fp32/s1", "conv_s2_fused", 56, 128, 128, 3, 2, 0, dtype=torch.float32)

    x = randn(b, 112, 112, 64)
    cases.append(Case(
        "max_pool/stem", "max_pool2d", pool.max_pool2d, pool.max_pool2d_plain, (x,),
        dict(kernel_size=3, stride=2, padding=1), 0, 2 * b * 64 * (112 * 112 + 56 * 56),
        PEAK_BF16_FLOPS, "bf16", per_forward=1,
    ))
    return cases


def _fp_block_weights(randn, c, c4, dtype):
    """One bottleneck's weights for the bf16 / fp32 blocks: w1, b1, w2, b2,
    w3, b3 (weights in ``dtype``, fp32 biases)."""
    import torch

    f32 = torch.float32
    return (randn(c4, c, scale=c4**-0.5, dtype=dtype), randn(c, scale=0.1, dtype=f32),
            randn(3, 3, c, c, scale=(9 * c) ** -0.5, dtype=dtype), randn(c, scale=0.1, dtype=f32),
            randn(c, c4, scale=c**-0.5, dtype=dtype), randn(c4, scale=0.1, dtype=f32))


def _repeat(fn, n: int):
    """``fn`` applied ``n`` times, its output the next call's input."""
    def run(x, *args, **kwargs):
        for _ in range(n):
            x = fn(x, *args, **kwargs)
        return x

    return run


def make_fp_cases(b: int, dev) -> list:
    """The kernels of the pallas_block backend (bottleneck_block_chained at
    ResNet-152's four stage shapes in bf16, one stage in fp32, and a chain of
    three at 7x7, where wp = w + 1, whose input ring holds NaN) and of the
    op library: bottleneck_block_fused at the four stage shapes, the 7x7
    head pool (fp32 and bf16) and the 3x3/2/p1 pool, relu / add / add_relu
    at ResNet-152's layer1 shape and at an odd size, bf16 and fp32."""
    import torch

    from resnetc_tpu_torch.ops.cuda import block, elementwise, pool
    from resnetc_tpu_torch.ops.cuda.block import chain_meta

    gen = torch.Generator().manual_seed(8765)
    cases = []

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    blocks = (3, 8, 36, 3)

    def fp_case(label, kernel, s, dtype, *, n=1, count=0, nan_ring=False):
        h, c, c4 = STAGES[s]
        size = 2 if dtype == torch.bfloat16 else 4
        x = randn(b, h, h, c4, dtype=dtype)
        if kernel == "bottleneck_block_chained":
            hp, wp = chain_meta(b, h, h)
            x = block.pad_for_chain(x)
            if nan_ring:
                ring = ~block.pad_for_chain(torch.ones((b, h, h, 1), device=dev)).bool()[:, 0]
                x[ring] = float("nan")
            kw = dict(h=h, w_sp=h)
            rows = b * hp * wp
        else:
            kw, rows = {}, b * h * h
        fn, plain = getattr(block, kernel), getattr(block, kernel + "_plain")
        if n > 1:
            fn, plain = _repeat(fn, n), _repeat(plain, n)
        cases.append(Case(
            label, kernel, fn, plain, (x, *_fp_block_weights(randn, c, c4, dtype)), kw,
            n * 2 * b * h * h * 17 * c * c,
            size * (2 * rows * c4 + 17 * c * c) + 4 * (2 * c + c4),
            PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS,
            "rel" if dtype == torch.bfloat16 else "f32", per_forward=count,
        ))

    for s in range(4):
        fp_case(f"fp_block/s{s}", "bottleneck_block_chained", s, torch.bfloat16,
                count=blocks[s] - 1)
    fp_case("fp_block/fp32/s1", "bottleneck_block_chained", 1, torch.float32)
    fp_case("fp_block/chain3/nan_ring/s3", "bottleneck_block_chained", 3, torch.bfloat16, n=3,
            nan_ring=True)
    for s in range(4):
        fp_case(f"fp_block_fused/s{s}", "bottleneck_block_fused", s, torch.bfloat16)

    for label, shape, k, st, p, dtype in (
        ("avg_pool/head/fp32", (b, 7, 7, 2048), 7, 1, 0, torch.float32),
        ("avg_pool/head", (b, 7, 7, 2048), 7, 1, 0, torch.bfloat16),
        ("avg_pool/3x3s2", (b, 112, 112, 64), 3, 2, 1, torch.bfloat16),
    ):
        oh = (shape[1] + 2 * p - k) // st + 1
        size = 2 if dtype == torch.bfloat16 else 4
        cases.append(Case(
            label, "avg_pool2d", pool.avg_pool2d, pool.avg_pool2d_plain, (randn(*shape, dtype=dtype),),
            dict(kernel_size=k, stride=st, padding=p), 0,
            size * shape[0] * shape[3] * (shape[1] * shape[2] + oh * oh), PEAK_F32_FLOPS,
            "bf16" if dtype == torch.bfloat16 else "f32eq",
        ))

    for op in ("relu", "add", "add_relu"):
        for where, shape in (("l1", (b, 56, 56, 256)), ("odd", (3, 17, 50))):
            for dtype in (torch.bfloat16, torch.float32):
                n_in = 1 if op == "relu" else 2
                numel = 1
                for d in shape:
                    numel *= d
                size = 2 if dtype == torch.bfloat16 else 4
                tag = where + ("" if dtype == torch.bfloat16 else "/fp32")
                cases.append(Case(
                    f"{op}/{tag}", op, getattr(elementwise, op),
                    getattr(elementwise, op + "_plain"),
                    tuple(randn(*shape, dtype=dtype) for _ in range(n_in)), {}, 0,
                    size * numel * (n_in + 1), PEAK_F32_FLOPS,
                    "bf16" if dtype == torch.bfloat16 else "f32eq",
                ))
    return cases


def check_case(case) -> float:
    """Kernel vs plain on the same inputs (and vs its twin: a pixel-paired
    kernel's standard one, the basic transition without the engine's
    copies); returns the max abs error against the plain version."""
    import torch

    got = case.run()
    want = case.run_plain()
    twin = case.twin(*case.args, **case.twin_kwargs) if case.twin else None
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{case.name}: {got.dtype} {tuple(got.shape)} vs plain "
                             f"{want.dtype} {tuple(want.shape)}")
    if case.check in ("int8", "bf16", "f32eq"):
        if not torch.equal(got, want):
            raise AssertionError(f"{case.name}: {case.check} output differs from plain (max {err})")
        distinct = int(torch.unique(got).numel())
        if distinct < 20:
            raise AssertionError(f"{case.name}: degenerate output ({distinct} values)")
    elif case.check == "rel":
        # z1 and z2 are rounded to bf16 inside a block: a summation-order
        # difference that straddles a rounding boundary moves a value by a
        # bf16 step, so the bound is on the largest error over the largest
        # value.
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{case.name}: non-finite output")
        rel = err / float(want.float().abs().max())
        if not rel <= 1e-2:
            raise AssertionError(f"{case.name}: max error / max |plain| {rel} > 1e-2")
        log(f"[kernels] {case.name}: max error / max |plain| = {rel}")
    elif case.check == "bf16ulp":
        # The same fp32 sums in another order, rounded to bf16: within one
        # bf16 step of the larger magnitude, or of zero where relu cuts a
        # sum that is zero to fp32 rounding.
        g, w = got.float(), want.float()
        diff = (g - w).abs()
        _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
        ulp = torch.ldexp(torch.ones_like(g), e - 8)
        bad = int(((diff > ulp) & (diff > 1e-5 * w.abs().max())).sum())
        if bad:
            raise AssertionError(f"{case.name}: {bad} elements beyond 1 bf16 ulp (max {err})")
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"{case.name}: {m}")
    if twin is not None and not torch.equal(got, twin):
        raise AssertionError(f"{case.name}: differs from its standard twin")
    return err


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


#: The tensor-core kernels and the SASS opcode their wgmma compiles to:
#: (library, a regular expression on the mangled kernel names, the opcode).
#: Every kernel of the library that the expression matches must hold the
#: opcode, and one kernel at least must match.
SASS_CHECKS = (
    # rows 13 and 14: conv3x3_s1_fused, conv_s2_fused (bf16)
    ("libconv.so", r"tile_kernel.*ConvALoaderILi\d+ELb[01]ELi1E", "HGMMA"),
    ("libconv.so", r"tile_kernel.*ConvALoaderILi\d+ELb[01]ELi2E", "HGMMA"),
    # row 4: matmul (bf16)
    ("libgemm.so", r"tile_kernel.*GemmALoader", "HGMMA"),
    # row 12: int8_matmul
    ("libint8_gemm.so", r"s8_tile_kernel", "IGMMA"),
    # rows 17 and 18: bottleneck_block_chained / _fused in bf16 (conv1 and
    # conv3 through the GEMM loader, conv2 through the im2col one)
    ("libfp_block.so", r"tile_kernel.*GemmALoader", "HGMMA"),
    ("libfp_block.so", r"tile_kernel.*ConvALoader", "HGMMA"),
    # rows 1-3: bottleneck_block_chained_int8, the run and the stride-2
    # transition downsample_block_s2_int8
    ("libchain_block.so", r"chain_tile_kernel", "IGMMA"),
    # rows 7, 8 and 11: basic_block_chained_int8, the run and the stride-2
    # transition basic_ds_block_s2_int8
    ("libbasic_block.so", r"chain_tile_kernel", "IGMMA"),
    # rows 5, 6, 9 and 10: the pixel-paired bottleneck and basic blocks and
    # runs
    ("libpp_block.so", r"chain_tile_kernel", "IGMMA"),
)
#: Libraries that must hold no dp4a implicit GEMM (``igemm_kernel``, the
#: CUDA-core kernel the int8 blocks ran before the int8 tile) any more.
NO_IGEMM = ("libchain_block.so", "libbasic_block.so", "libpp_block.so")


def _sass_functions(path) -> dict:
    """{mangled kernel name: its SASS} of a shared library, read with the
    toolkit's cuobjdump."""
    from pathlib import Path

    from resnetc_tpu_torch.ops.cuda import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    funcs = {}
    for chunk in sass.split("Function : ")[1:]:
        name, _, body = chunk.partition("\n")
        funcs[name.strip()] = body
    return funcs


def phase_sass(build_dir) -> dict:
    """The tensor-core kernels hold wgmma instructions in their SASS
    (``SASS_CHECKS``): HGMMA in the bf16 tile's instantiations, IGMMA in
    the int8 tiles.  Counted per kernel, not per library, so another
    kernel's wgmma cannot stand in.  ``NO_IGEMM``'s libraries hold no dp4a
    kernel, and ptxas reported no serialized wgmma (C7515) for a source
    built in this run."""
    import re

    from resnetc_tpu_torch.ops.cuda import _build

    counts, libs = {}, {}
    for lib, pattern, opcode in SASS_CHECKS:
        if lib not in libs:
            libs[lib] = _sass_functions(build_dir / lib)
        mine = {name: len(re.findall(rf"\b{opcode}\b", body))
                for name, body in libs[lib].items() if re.search(pattern, name)}
        if not mine:
            raise AssertionError(f"{lib}: no kernel matches {pattern}")
        for name, n in mine.items():
            if not n:
                raise AssertionError(f"{lib}: {name} holds no {opcode}; it is off the tensor cores")
        counts[f"{lib} {pattern}"] = {"kernels": len(mine), opcode: sum(mine.values())}
        log(f"[sass] {lib}: {len(mine)} kernels matching {pattern}, each with {opcode}; "
            f"{sum(mine.values())} in all")
    for lib in NO_IGEMM:
        left = [name for name in libs[lib] if "igemm_kernel" in name]
        if left:
            raise AssertionError(f"{lib}: still holds the dp4a kernel {left[0]}")
        log(f"[sass] {lib}: no igemm_kernel")
    # ptxas's C7515 ("wgmma ... serialized") in any source built this run.
    built = sorted(_build.BUILD_LOG)
    serialized = [name for name in built if "C7515" in _build.BUILD_LOG[name]]
    if serialized:
        raise AssertionError(f"ptxas serialized wgmma (C7515) in {serialized}")
    log(f"[sass] no C7515 in the ptxas output of {len(built)} sources built in this run"
        + ("" if built else " (every library was already built)"))
    return counts


def phase_kernels(cases: list) -> dict:
    errs = {}
    for case in cases:
        errs[case.name] = check_case(case)
        twin = " and to its twin" if case.twin else ""
        how = {"bf16ulp": "within 1 bf16 ulp of", "f32": "within rtol 1e-4 of",
               "rel": "within 1e-2 of max |plain| of"}.get(case.check, "equal to")
        log(f"[kernels] {case.name}: {how} plain{twin}, max_abs_err={errs[case.name]}")
    return errs


def main_path_counts() -> dict:
    """Launches of each kernel case per forward of its model (ResNet-152
    for the bottleneck cases, ResNet-34 for the basic ones) on the route
    that runs it, by case name."""
    from resnetc_tpu_torch.models import get_config

    blocks = get_config("resnet152").stage_blocks
    basic = get_config("resnet34").stage_blocks
    return {
        "block/proj/s0": 1,
        "block/identity/s1": blocks[1] - 1,
        "block/identity/s2": blocks[2] - 1,
        "block/identity/s3": blocks[3] - 2,
        "block/emit_mean/s3": 1,
        "run/n2/s0": 1,
        "ds/s1": 1, "ds/s2": 1, "ds/s3": 1,
        "matmul/fc": 1,
        "pp/block/proj/s0": 1,
        "pp/run/n2/s0": 1,
        "basic/run/n3/s0": 1,
        "basic/block/s1": basic[1] - 1,
        "basic/block/s2": basic[2] - 1,
        "basic/block/s3": basic[3] - 2,
        "basic/block/bf16_exit/s3": 1,
        "basic/ds/s1": 1, "basic/ds/s2": 1, "basic/ds/s3": 1,
        "basic/matmul/fc": 1,
        "pp/basic/run/n3/s0": 1,
        "pp/basic/block/s0": basic[0],
    }


#: The stage-0 cases of each full-depth route: the served (pixel-paired)
#: one and the standard one (L1_PIXEL_PAIR off).
ROUTE_ONLY = {
    True: {"pp/block/proj/s0", "pp/run/n2/s0", "pp/basic/run/n3/s0"},
    False: {"block/proj/s0", "run/n2/s0", "basic/run/n3/s0"},
}
#: Cases whose stage-0 route runs only in phase_reduced_routes (per block).
REDUCED_ONLY = {"pp/basic/block/s0"}


def expected_launches(cases: list, pp: bool) -> dict:
    """Launches of each kernel in one forward of the cases' model, on the
    pixel-paired route or the standard one."""
    counts = main_path_counts()
    want: dict = {}
    for case in cases:
        if counts.get(case.name, 0) and case.name not in ROUTE_ONLY[not pp] | REDUCED_ONLY:
            want[case.kernel] = want.get(case.kernel, 0) + counts[case.name]
    return want


#: The main paths driven end to end: the model, the rel-MAE bound of the JAX
#: package's own gate for its route against the fp forward
#: (tests/test_pallas.py:573-598 bottleneck, :1444-1446 basic), and the
#: kernel cases at its shapes.
MODELS = (("resnet152", 0.05, make_cases), ("resnet34", 0.08, make_basic_cases))


@contextlib.contextmanager
def module_flags(**flags):
    """Set module flags of ``fused`` (the route) for the duration."""
    from resnetc_tpu_torch.ops.cuda import fused

    saved = {k: getattr(fused, k) for k in flags}
    for k, v in flags.items():
        setattr(fused, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(fused, k, v)


def counted(fn, **flags):
    """``fn()`` under the given flags, the launch counters set to 0 just
    before it and read just after: (result, launches)."""
    import torch

    from resnetc_tpu_torch.ops.cuda import _build

    with module_flags(**flags):
        _build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(_build.LAUNCHES)


def forward_counted(eng, x, **flags):
    """One engine forward with the given module flags of ``fused`` (the
    route), the launch counters set to 0 just before it and read just
    after; the flags restored."""
    return counted(lambda: eng.logits(x), **flags)


def phase_tuned() -> dict:
    """The flags TUNED.json laid over the code defaults: the served
    configuration must pair stage 0 and serve the basic transitions int8."""
    from resnetc_tpu_torch.ops.cuda import fused

    log(f"[tuned] TUNED_DEFAULTS={json.dumps(fused.TUNED_DEFAULTS)} "
        f"L1_PIXEL_PAIR={fused.L1_PIXEL_PAIR} STAGE_FUSE_PROJ={fused.STAGE_FUSE_PROJ} "
        f"BASIC_DS_INT8={fused.BASIC_DS_INT8}")
    if not (fused.TUNED_DEFAULTS.get("L1_PIXEL_PAIR") is True
            and fused.TUNED_DEFAULTS.get("BASIC_DS_INT8") is True):
        raise AssertionError("TUNED.json did not turn on L1_PIXEL_PAIR and BASIC_DS_INT8")
    return dict(fused.TUNED_DEFAULTS)


def phase_end_to_end(name: str, rel_mae_gate: float, cases: list, batch: int, dev) -> dict:
    import torch

    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.ops.cuda.fused import PLAIN, fused_forward_int8_chain
    from resnetc_tpu_torch.serve import InferenceEngine
    from resnetc_tpu_torch.tensor import FP32
    from resnetc_tpu_torch.verify import compare_logits

    tag = f"[e2e {name}]"
    cfg = resnet.get_config(name)
    t0 = time.perf_counter()
    variables = resnet.init(cfg, torch.Generator().manual_seed(0))
    calib = torch.randn((8, 224, 224, 3), generator=torch.Generator().manual_seed(1))
    eng = InferenceEngine(cfg, variables, backend="int8_chain", calib_batch=calib, device=dev)
    fp = InferenceEngine(cfg, variables, backend="fp", device=dev)
    x = torch.randn((batch, 224, 224, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    torch.cuda.synchronize()
    log(f"{tag} engines built in {time.perf_counter() - t0:.1f} s")

    launches, logits_of = {}, {}
    for pp in (True, False):
        route = "pp" if pp else "standard"
        logits_of[pp], launches[route] = forward_counted(eng, x, L1_PIXEL_PAIR=pp)
        want = expected_launches(cases, pp)
        log(f"{tag} launches in one int8_chain forward, {route} route: "
            f"{json.dumps(launches[route])}")
        if launches[route] != want:
            raise AssertionError(f"{tag} {route} route launched {launches[route]}, expected {want}")
    if not torch.equal(logits_of[True], logits_of[False]):
        diff = float((logits_of[True] - logits_of[False]).abs().max())
        raise AssertionError(f"{tag} pp and standard routes differ (max {diff})")
    log(f"{tag} pixel-paired and standard routes: logits equal bit for bit")
    logits = logits_of[True]
    if tuple(logits.shape) != (batch, 1000) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag} bad logits: shape {tuple(logits.shape)}")
    classes = eng.classify(x)
    if classes.shape != (batch,):
        raise AssertionError(f"{tag} classify returned shape {classes.shape}")

    ref = fp.logits(x)
    with torch.inference_mode():
        ref32 = resnet.forward_folded(cfg, fp.folded, x, policy=FP32)
        plain = fused_forward_int8_chain(cfg, eng.folded, eng.chain_scales, x, kernels=PLAIN)
    top2 = ref32.topk(2, dim=-1).values
    log(f"{tag} fp32 logits: mean|logit|={float(ref32.abs().mean())} "
        f"median top1-top2 gap={float((top2[:, 0] - top2[:, 1]).median())}")
    rel_mae = float((logits - ref).abs().mean() / ref.abs().mean())
    rep = compare_logits(logits, ref)
    log(f"{tag} int8_chain vs fp (bf16) folded forward: rel_mae={rel_mae} "
        f"argmax_agreement={rep.argmax_match_rate} mae={rep.mae}")
    rel_mae32 = float((logits - ref32).abs().mean() / ref32.abs().mean())
    rep32 = compare_logits(logits, ref32)
    log(f"{tag} int8_chain vs fp32 folded forward: rel_mae={rel_mae32} "
        f"argmax_agreement={rep32.argmax_match_rate}")
    plain_rel = float((logits - plain).abs().max() / plain.abs().max())
    prep = compare_logits(logits, plain)
    log(f"{tag} kernels vs plain versions, whole forward: max_err/max|logit|={plain_rel} "
        f"argmax_agreement={prep.argmax_match_rate}")
    # The gate's oracle is the fp32 folded forward (TF32 off): with random
    # weights the top-1 margins are ~1.5% of |logit|, inside the bf16 fp
    # path's own rounding error, so bf16-vs-fp32 argmax agreement is itself
    # ~0.6 here (measured); the bf16 comparison is reported, not gated.
    if not (rel_mae32 < rel_mae_gate and rep32.argmax_match_rate >= 0.9):
        raise AssertionError(f"{tag} int8_chain logits outside the fp gate")
    if plain_rel > 1e-2:
        raise AssertionError(f"{tag} the kernels' forward disagrees with the plain versions")
    return {
        "engine": eng, "fp": fp, "x": x, "ref32": ref32, "launches": launches,
        "rel_mae_vs_fp_bf16": rel_mae, "argmax_vs_fp_bf16": rep.argmax_match_rate,
        "rel_mae_vs_fp32": rel_mae32, "argmax_vs_fp32": rep32.argmax_match_rate,
        "plain_rel_max_err": plain_rel, "argmax_vs_plain": prep.argmax_match_rate,
        "routes_bit_equal": True,
    }


def backend_launches(cfg, backend: str) -> dict:
    """Launches of each kernel in one forward of the int8 backend (and of
    fused_forward_int8_static), the pallas backend or the pallas_block
    backend: one per convolution of its kind, the stem's pool, and the fc;
    under pallas_block one bottleneck_block_chained per identity block of a
    bottleneck net instead of its three convolutions (a basic net takes the
    pallas route)."""
    nb = sum(cfg.stage_blocks)
    if cfg.block == "bottleneck" and backend == "pallas_block":
        # The four projection blocks: conv1, conv3 and the projection each
        # through matmul, conv2 stride 1 in stage 0 and stride 2 after.
        return {"max_pool2d": 1, "conv_s2_fused": 3, "conv3x3_s1_fused": 1, "matmul": 13,
                "bottleneck_block_chained": nb - 4}
    if cfg.block == "bottleneck":
        n3, n1 = nb, 2 * nb + 4  # conv2 of each block; conv1, conv3, the projections
    else:
        n3, n1 = 2 * nb, 3
    gemm = "int8_matmul" if backend == "int8" else "matmul"
    return {"max_pool2d": 1, "conv_s2_fused": 3, "conv3x3_s1_fused": n3 - 3, gemm: n1 + 1}


def _against(tag: str, label: str, logits, ref32, plain, *, limit: float = 1e-2) -> dict:
    """A forward's logits against the fp32 folded forward and against the
    same forward on the plain versions; logged and returned.  Fails when
    the max error over max |logit| from the plain forward exceeds
    ``limit``."""
    import torch

    from resnetc_tpu_torch.verify import compare_logits

    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag} {label}: non-finite logits")
    logits, plain = logits.float(), plain.float()
    out = {
        "rel_mae_vs_fp32": float((logits - ref32).abs().mean() / ref32.abs().mean()),
        "rel_max_vs_fp32": float((logits - ref32).abs().max() / ref32.abs().max()),
        "argmax_vs_fp32": compare_logits(logits, ref32).argmax_match_rate,
        "plain_rel_max_err": float((logits - plain).abs().max() / plain.abs().max()),
        "plain_rel_mae": float((logits - plain).abs().mean() / plain.abs().mean()),
        "argmax_vs_plain": compare_logits(logits, plain).argmax_match_rate,
    }
    log(f"{tag} {label}: {json.dumps(out)}")
    if out["plain_rel_max_err"] > limit:
        raise AssertionError(f"{tag} {label}: the kernels' forward disagrees with the plain "
                             f"versions ({out['plain_rel_max_err']} > {limit})")
    return out


#: Kernels vs plain versions, whole forward, for the int8 backend (dynamic
#: and static scales).  Its fused convolutions sum in another order than
#: their plain versions, and the per-tensor requantization before each of
#: ResNet-152's 105 GEMMs turns a last-bit difference that straddles an
#: int8 rounding boundary into a whole int8 step: on an H100 with the
#: seed-0 weights, 1.5-1.7e-2 of max |logit| under both policies, about
#: what the same forward differs from the fp32 forward (rel-MAE 0.016),
#: where every other forward stays within 1e-2.  A kernel fault moves
#: logits by O(1).
INT8_PLAIN_LIMIT = 5e-2


def phase_backends(name: str, e2e: dict, batch: int, dev) -> dict:
    """The int8, pallas and pallas_block engines of one model at full width
    and depth, each forward counted and checked; fused_forward_int8_static
    on the bottleneck model.

    Each runs under the served BF16 policy and under FP32.  The gates
    against the fp32 forward are the JAX package's own, which it runs under
    FP32 (tests/test_quant.py:86-127, tests/test_pallas.py:95-106 and
    :194-202): int8 rel-MAE 0.15, int8_static 0.2, pallas and pallas_block
    max error 1e-3 of max |logit|.  Each forward stays within 1e-2 of max
    |logit| of the same forward on the plain versions, the int8 ones within
    INT8_PLAIN_LIMIT."""
    import torch

    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.ops.cuda import fused
    from resnetc_tpu_torch.serve import InferenceEngine
    from resnetc_tpu_torch.tensor import BF16, FP32

    tag = f"[backends {name}]"
    cfg = resnet.get_config(name)
    variables = resnet.init(cfg, torch.Generator().manual_seed(0))
    x, ref32 = e2e["x"], e2e["ref32"]
    policies = {"": BF16, "/fp32": FP32}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the pallas backend's deprecation notice
        engines = {b + p: InferenceEngine(cfg, variables, backend=b, policy=pol, device=dev)
                   for b in ("int8", "pallas", "pallas_block") for p, pol in policies.items()}
    forwards = {
        "int8": fused.fused_forward_int8, "pallas": fused.fused_forward,
        "pallas_block": lambda *a, **kw: fused.fused_forward(*a, block_fusion=True, **kw),
    }
    out = {"engines": engines, "launches": {}, "gates": {}}

    def check_launches(label, launches, want):
        log(f"{tag} launches in one {label} forward: {json.dumps(launches)}")
        if launches != want:
            raise AssertionError(f"{tag} {label} launched {launches}, expected {want}")
        out["launches"][label] = launches

    for label, eng in engines.items():
        backend = label.split("/")[0]
        logits, launches = forward_counted(eng, x)
        check_launches(label, launches, backend_launches(cfg, backend))
        if tuple(logits.shape) != (batch, 1000):
            raise AssertionError(f"{tag} {label}: logits of shape {tuple(logits.shape)}")
        with torch.inference_mode():
            plain = forwards[backend](cfg, eng.folded, x, policy=eng.policy, kernels=fused.PLAIN)
        out["gates"][label] = rep = _against(
            tag, label, logits, ref32, plain,
            limit=INT8_PLAIN_LIMIT if backend == "int8" else 1e-2)
        if label == "int8/fp32" and not rep["rel_mae_vs_fp32"] < 0.15:
            raise AssertionError(f"{tag} int8 logits outside the rel-MAE 0.15 gate")
        if backend.startswith("pallas") and label.endswith("/fp32") \
                and not rep["rel_max_vs_fp32"] < 1e-3:
            raise AssertionError(f"{tag} FP32 {backend} logits beyond 1e-3 of the fp32 forward")
    if cfg.block == "basic" and out["launches"]["pallas_block"] != out["launches"]["pallas"]:
        raise AssertionError(f"{tag} pallas_block launched other kernels than pallas")

    if cfg.block == "bottleneck":
        # Calibrated on the served batch, as the JAX package's own gate
        # (tests/test_quant.py:104-127) does.
        with torch.inference_mode():
            scales = fused.calibrate_activation_scales(cfg, e2e["fp"].folded, x, policy=FP32)
            qtree = engines["int8/fp32"].folded
            logits, launches = counted(lambda: fused.fused_forward_int8_static(
                cfg, qtree, scales, x, policy=FP32))
            plain = fused.fused_forward_int8_static(cfg, qtree, scales, x, policy=FP32,
                                                    kernels=fused.PLAIN)
        check_launches("int8_static/fp32", launches, backend_launches(cfg, "int8"))
        out["gates"]["int8_static/fp32"] = rep = _against(
            tag, "int8_static/fp32", logits, ref32, plain, limit=INT8_PLAIN_LIMIT)
        if not rep["rel_mae_vs_fp32"] < 0.2:
            raise AssertionError(f"{tag} int8_static logits outside the rel-MAE 0.2 gate")
    return out


def phase_basic_ds_off(e2e: dict, dev) -> dict:
    """ResNet-34's int8_chain forward on the BASIC_DS_INT8=False route (the
    JAX code default), standard stage 0: the transitions through the conv
    kernels between the int8 chains, counted and gated."""
    import torch

    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.ops.cuda import fused

    tag = "[e2e resnet34]"
    cfg = resnet.get_config("resnet34")
    eng, x = e2e["engine"], e2e["x"]
    flags = dict(BASIC_DS_INT8=False, L1_PIXEL_PAIR=False)
    logits, launches = forward_counted(eng, x, **flags)
    want = {"basic_run_chained_int8": 1, "basic_block_chained_int8": sum(cfg.stage_blocks[1:]) - 3,
            "conv3x3_s1_fused": 3, "conv_s2_fused": 3, "matmul": 4}
    log(f"{tag} launches in one int8_chain forward, BASIC_DS_INT8=False route: "
        f"{json.dumps(launches)}")
    if launches != want:
        raise AssertionError(
            f"{tag} BASIC_DS_INT8=False route launched {launches}, expected {want}")
    with module_flags(**flags), torch.inference_mode():
        plain = fused.fused_forward_int8_chain(cfg, eng.folded, eng.chain_scales, x,
                                               kernels=fused.PLAIN)
    rep = _against(tag, "int8_chain BASIC_DS_INT8=False", logits, e2e["ref32"], plain)
    if not (rep["rel_mae_vs_fp32"] < 0.08 and rep["argmax_vs_fp32"] >= 0.9):
        raise AssertionError(f"{tag} BASIC_DS_INT8=False logits outside the fp gate")
    return {"launches": launches, **rep}


def phase_reduced_routes(dev) -> dict:
    """The other stage-0 routes, at full width with the stages cut to
    (3, 2, 2, 2) blocks, batch 8, each equal bit for bit to the served
    route of its model: all of layer1 as one run kernel (STAGE_FUSE_PROJ),
    paired and standard; stage 0 per block (RUN_FUSE_STAGES /
    BASIC_RUN_FUSE_STAGES empty), which is where the pixel-paired block
    kernels 5 (identity form) and 9 run.  Returns each route's launches."""
    import torch

    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.serve import InferenceEngine

    tag = "[e2e reduced]"
    rest = {"downsample_block_s2_int8": 3, "bottleneck_block_chained_int8": 3, "matmul": 1}
    basic_rest = {"basic_ds_block_s2_int8": 3, "basic_block_chained_int8": 3, "matmul": 1}
    routes = {
        "resnet152": [
            ("stage_fuse_proj/pp", dict(STAGE_FUSE_PROJ=True),
             {"bottleneck_run_chained_int8_pp": 1, **rest}),
            ("stage_fuse_proj/standard", dict(STAGE_FUSE_PROJ=True, L1_PIXEL_PAIR=False),
             {"bottleneck_run_chained_int8": 1, **rest}),
            ("per_block/pp", dict(RUN_FUSE_STAGES=()),
             {"bottleneck_block_chained_int8_pp": 3, **rest}),
        ],
        "resnet34": [
            ("per_block/pp", dict(BASIC_RUN_FUSE_STAGES=()),
             {"basic_block_chained_int8_pp": 3, **basic_rest}),
        ],
    }
    out = {}
    for name, cuts in routes.items():
        cfg = resnet.get_config(name)
        cfg = cfg.__class__(**{**cfg.__dict__, "stage_blocks": (3, 2, 2, 2)})
        variables = resnet.init(cfg, torch.Generator().manual_seed(0))
        x = torch.randn((8, 224, 224, 3), generator=torch.Generator().manual_seed(2)).to(dev)
        eng = InferenceEngine(cfg, variables, backend="int8_chain", calib_batch=x, device=dev)
        served, _ = forward_counted(eng, x)
        for label, flags, want in cuts:
            logits, launches = forward_counted(eng, x, **flags)
            log(f"{tag} {name} {label} {json.dumps(flags)}: {json.dumps(launches)}")
            if launches != want:
                raise AssertionError(f"{tag} {name} {label} launched {launches}, expected {want}")
            if not torch.equal(logits, served):
                raise AssertionError(f"{tag} {name} {label} differs from the served route")
            out[f"{name}/{label}"] = launches
        log(f"{tag} {name}: every route equals the served route bit for bit")
    return out


def phase_op_library(batch: int, dev) -> dict:
    """The op library through its entry points (``resnetc_tpu_torch.ops.cuda``)
    as a caller composes it, at ResNet-152 shapes and batch ``batch``: the
    residual join of a layer1 block (``add_relu``, and ``relu`` after
    ``add``), and a layer4 identity block (``bottleneck_block_fused``) under
    the 7x7 head pool (``avg_pool2d``).  The launch counters are set to 0
    just before and read just after.  relu(add(a, b)) must equal
    add_relu(a, b) bit for bit, and the pooled block must be within 1e-2 of
    max |plain| of the same calls on the plain versions."""
    import torch

    from resnetc_tpu_torch.ops import cuda as ops
    from resnetc_tpu_torch.ops.cuda import block, pool

    tag = "[op library]"
    gen = torch.Generator().manual_seed(97)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    a, b = randn(batch, 56, 56, 256), randn(batch, 56, 56, 256)
    h, c, c4 = STAGES[3]
    x = randn(batch, h, h, c4)
    ws = _fp_block_weights(randn, c, c4, torch.bfloat16)

    def drive():
        joined = ops.add_relu(a, b)
        twice = ops.relu(ops.add(a, b))
        pooled = ops.avg_pool2d(ops.bottleneck_block_fused(x, *ws), kernel_size=7, stride=1)
        return joined, twice, pooled

    (joined, twice, pooled), launches = counted(drive)
    log(f"{tag} launches: {json.dumps(launches)}")
    want = {"add_relu": 1, "add": 1, "relu": 1, "bottleneck_block_fused": 1, "avg_pool2d": 1}
    if launches != want:
        raise AssertionError(f"{tag} launched {launches}, expected {want}")
    if not torch.equal(joined, twice):
        raise AssertionError(f"{tag} add_relu differs from relu(add)")
    plain = pool.avg_pool2d_plain(block.bottleneck_block_fused_plain(x, *ws), kernel_size=7,
                                  stride=1)
    if tuple(pooled.shape) != (batch, 1, 1, c4) or not bool(torch.isfinite(pooled).all()):
        raise AssertionError(f"{tag} pooled block of shape {tuple(pooled.shape)}")
    rel = float((pooled.float() - plain.float()).abs().max() / plain.float().abs().max())
    log(f"{tag} add_relu == relu(add); pooled layer4 block vs plain: "
        f"max error / max |plain| = {rel}")
    if rel > 1e-2:
        raise AssertionError(f"{tag} the pooled block disagrees with the plain versions")
    return {"launches": launches, "pooled_rel_max_err": rel}


def phase_engine_timing(name: str, runs: list, x, batch: int) -> dict:
    """Throughput and per-batch latency of each (label, engine, flags) on
    the images ``x``."""
    from resnetc_tpu_torch.serve import bench_latency, bench_throughput

    times = {}
    for label, eng, flags in runs:
        with module_flags(**flags):
            thr = bench_throughput(eng, x, steps=10, warmup=3)
            lat = bench_latency(eng, x, samples=10, warmup=2)
        times[label] = {
            "images_per_s": thr.images_per_sec, "p50_ms_per_batch": lat.p50_ms,
            "p99_ms_per_batch": lat.p99_ms, "batch": batch,
        }
        log(f"[timing {name}] {label}: {thr.images_per_sec:.1f} img/s, "
            f"p50 {lat.p50_ms:.3f} p99 {lat.p99_ms:.3f} ms per batch of {batch}")
    return times


#: Each kernel: its CUDA source and the TPU kernel it replaces.
SOURCES = {
    "bottleneck_block_chained_int8": ("resnetc_tpu_torch/csrc/chain_block.cu",
                                      "resnetc_tpu/ops/pallas/block.py:718"),
    "bottleneck_run_chained_int8": ("resnetc_tpu_torch/csrc/chain_block.cu",
                                    "resnetc_tpu/ops/pallas/block.py:2908"),
    "downsample_block_s2_int8": ("resnetc_tpu_torch/csrc/chain_block.cu",
                                 "resnetc_tpu/ops/pallas/block.py:3460"),
    "matmul": ("resnetc_tpu_torch/csrc/gemm.cu", "resnetc_tpu/ops/pallas/gemm.py:100"),
    "bottleneck_block_chained_int8_pp": ("resnetc_tpu_torch/csrc/pp_block.cu",
                                         "resnetc_tpu/ops/pallas/block.py:1113"),
    "bottleneck_run_chained_int8_pp": ("resnetc_tpu_torch/csrc/pp_block.cu",
                                       "resnetc_tpu/ops/pallas/block.py:1387"),
    "basic_block_chained_int8": ("resnetc_tpu_torch/csrc/basic_block.cu",
                                 "resnetc_tpu/ops/pallas/block.py:1646"),
    "basic_run_chained_int8": ("resnetc_tpu_torch/csrc/basic_block.cu",
                               "resnetc_tpu/ops/pallas/block.py:1830"),
    "basic_block_chained_int8_pp": ("resnetc_tpu_torch/csrc/pp_block.cu",
                                    "resnetc_tpu/ops/pallas/block.py:2002"),
    "basic_run_chained_int8_pp": ("resnetc_tpu_torch/csrc/pp_block.cu",
                                  "resnetc_tpu/ops/pallas/block.py:2175"),
    "basic_ds_block_s2_int8": ("resnetc_tpu_torch/csrc/basic_block.cu",
                               "resnetc_tpu/ops/pallas/block.py:2542"),
    "int8_matmul": ("resnetc_tpu_torch/csrc/int8_gemm.cu", "resnetc_tpu/ops/pallas/quant.py:78"),
    "conv3x3_s1_fused": ("resnetc_tpu_torch/csrc/conv.cu", "resnetc_tpu/ops/pallas/conv.py:150"),
    "conv_s2_fused": ("resnetc_tpu_torch/csrc/conv.cu", "resnetc_tpu/ops/pallas/conv.py:287"),
    "max_pool2d": ("resnetc_tpu_torch/csrc/pool.cu", "resnetc_tpu/ops/pallas/pool.py:65"),
    "avg_pool2d": ("resnetc_tpu_torch/csrc/pool.cu", "resnetc_tpu/ops/pallas/pool.py:174"),
    "bottleneck_block_chained": ("resnetc_tpu_torch/csrc/fp_block.cu",
                                 "resnetc_tpu/ops/pallas/block.py:278"),
    "bottleneck_block_fused": ("resnetc_tpu_torch/csrc/fp_block.cu",
                               "resnetc_tpu/ops/pallas/block.py:3688"),
    "relu": ("resnetc_tpu_torch/csrc/elementwise.cu",
             "resnetc_tpu/ops/pallas/elementwise.py:29"),
    "add, add_relu": ("resnetc_tpu_torch/csrc/elementwise.cu",
                      "resnetc_tpu/ops/pallas/elementwise.py:53"),
}
#: Wrappers that launch one TPU kernel's counterpart (one row of the table).
MEMBERS = {"add, add_relu": ("add", "add_relu")}
#: The kernels on the tensor-core tiles (bf16_tile.cuh and s8_tile.cuh):
#: their TFLOP/s (TOP/s for int8), share of the bound and ratio to the
#: library call are printed per shape.
TILE_KERNELS = ("conv3x3_s1_fused", "conv_s2_fused", "matmul", "int8_matmul",
                "bottleneck_block_chained", "bottleneck_block_chained_int8",
                "bottleneck_run_chained_int8", "downsample_block_s2_int8",
                "bottleneck_block_chained_int8_pp", "bottleneck_run_chained_int8_pp",
                "basic_block_chained_int8", "basic_run_chained_int8",
                "basic_block_chained_int8_pp", "basic_run_chained_int8_pp",
                "basic_ds_block_s2_int8")


def phase_kernel_timing(batch: int, dev, errs: dict, launches: dict) -> tuple[list, list]:
    """Every case timed at the main paths' batch; per kernel, ms / plain ms /
    bound weighted by its launches per forward over the shapes of the routes
    that run it (cases off every route are timed and listed, not weighed; a
    kernel off every route weighs each of its cases once), the largest
    error of all its cases, and its launches summed over every route
    driven."""
    import torch

    counts = main_path_counts()
    per_case = []
    makers = [make for _, _, make in MODELS] + [make_backend_cases, make_fp_cases]
    for case in [c for make in makers for c in make(batch, dev)]:
        eager_ms = time_ms(case.run, iters=10)
        ms = device_ms(case.run, iters=10)
        if ms is None:  # the wrapper waits for the card: only its eager time exists
            log(f"[timing] {case.name}: the wrapper synchronises; ms is its eager time")
            ms = eager_ms
        plain_ms = time_ms(case.run_plain, iters=2, warmup=1, repeats=3)
        lib_ms = None
        lib = case.library()
        if lib is not None:
            try:
                lib_ms = device_ms(lib, iters=20) or time_ms(lib, iters=20)
            except RuntimeError as e:  # a library call that refuses the shape
                log(f"[timing] {case.name}: library call refused: {e}")
        per_forward = case.per_forward if case.per_forward is not None else counts.get(case.name, 0)
        row = {
            "case": case.name, "kernel": case.kernel, "batch": batch,
            "per_forward": per_forward, "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": case.bound_ms, "bound_by": case.bound_by, "library_ms": lib_ms,
            "ops": case.ops, "bytes": case.nbytes,
            "tflops": case.ops / ms * 1e-9, "bound_share": case.bound_ms / ms,
        }
        per_case.append(row)
        log(f"[timing] {json.dumps(row)}")
        if case.kernel in TILE_KERNELS:
            vs = f", {ms / lib_ms:.2f}x the library's {lib_ms:.4f} ms" if lib_ms else ""
            rate = "TOP/s" if case.peak == PEAK_INT8_OPS else "TFLOP/s"
            log(f"[tile] {case.name}: {ms:.4f} ms, {row['tflops']:.1f} {rate}, "
                f"{100 * row['bound_share']:.1f}% of the bound{vs}")
        elif case.kernel == "avg_pool2d":
            vs = f", {ms / lib_ms:.2f}x F.avg_pool2d's {lib_ms:.4f} ms" if lib_ms else ""
            log(f"[pool] {case.name}: {ms:.4f} ms, {100 * row['bound_share']:.1f}% of the "
                f"bound{vs}")

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        members = MEMBERS.get(name, (name,))
        mine = [r for r in per_case if r["kernel"] in members]
        checked = [r["case"] for r in mine]
        rows = [r for r in mine if r["per_forward"] > 0] or [dict(r, per_forward=1) for r in mine]
        n = sum(r["per_forward"] for r in rows)

        def avg(key, rows=rows, n=n):
            return sum(r[key] * r["per_forward"] for r in rows) / n

        by_ops = sum(r["per_forward"] for r in rows if r["bound_by"] == "operations")
        lib = [r for r in rows if r["library_ms"] is not None]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches.get(m, 0) for m in members),
            "max_abs_err": max(errs[c] for c in checked),
            "ms": avg("ms"), "eager_ms": avg("eager_ms"), "plain_ms": avg("plain_ms"),
            "bound_ms": avg("bound_ms"),
            "bound_by": "operations" if 2 * by_ops >= n else "bytes",
            "library_ms": avg("library_ms", lib, sum(r["per_forward"] for r in lib))
            if lib else None,
        })
    return kernels, per_case


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32, help="end-to-end batch size")
    ap.add_argument("--out", default=None, help="also write all results to this JSON file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 1
    from resnetc_tpu_torch.ops.cuda import _build

    # The fp32 oracle must not run in TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = gpu_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    build_dir = _build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    log(f"[build] kernels built in {build_s:.1f} s")
    sass = phase_sass(build_dir)

    cases = {name: make(8, dev) for name, _, make in MODELS}
    errs = phase_kernels([c for cs in cases.values() for c in cs] + make_backend_cases(8, dev)
                         + make_fp_cases(8, dev))
    tuned = phase_tuned()
    summaries, engine_times, launches = {}, {}, {}

    def add(route_launches):
        for k, v in route_launches.items():
            launches[k] = launches.get(k, 0) + v

    for name, gate, _ in MODELS:
        e2e = phase_end_to_end(name, gate, cases[name], args.batch, dev)
        back = phase_backends(name, e2e, args.batch, dev)
        runs = [("int8_chain", e2e["engine"], {"L1_PIXEL_PAIR": True}),
                ("int8_chain_standard", e2e["engine"], {"L1_PIXEL_PAIR": False})]
        summary = {k: v for k, v in e2e.items() if k not in ("engine", "fp", "x", "ref32")}
        if name == "resnet34":
            summary["basic_ds_int8_off"] = off = phase_basic_ds_off(e2e, dev)
            add(off["launches"])
            runs.append(("int8_chain_basic_ds_int8_off", e2e["engine"],
                         {"BASIC_DS_INT8": False, "L1_PIXEL_PAIR": False}))
        runs += [(label, back["engines"][label], {})
                 for label in ("int8", "pallas", "pallas_block")]
        runs.append(("fp", e2e["fp"], {}))
        engine_times[name] = phase_engine_timing(name, runs, e2e["x"], args.batch)
        for route in list(e2e["launches"].values()) + list(back["launches"].values()):
            add(route)
        summary["backends"] = {"launches": back["launches"], "gates": back["gates"]}
        summaries[name] = summary
        del e2e, back, runs
        torch.cuda.empty_cache()
    summaries["reduced_routes"] = phase_reduced_routes(dev)
    for route in summaries["reduced_routes"].values():
        add(route)
    summaries["op_library"] = phase_op_library(args.batch, dev)
    add(summaries["op_library"]["launches"])
    torch.cuda.empty_cache()
    kernels, per_case = phase_kernel_timing(args.batch, dev, errs, launches)
    total_s = time.perf_counter() - t0
    log(f"[done] build and all phases in {total_s:.1f} s")

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "build_s": build_s, "sass": sass, "total_s": total_s,
                       "tuned": tuned,
                       "e2e": summaries, "engines": engine_times, "cases": per_case,
                       "kernels": kernels, "max_abs_err": errs}, f, indent=1)
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
