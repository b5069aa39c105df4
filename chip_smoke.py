#!/usr/bin/env python3
"""Chip smoke test of resnetc_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py [--batch 32] [--out results.json]

Builds the CUDA kernels from ``resnetc_tpu_torch/csrc``, checks that the
tensor-core kernels hold wgmma instructions in their SASS (HGMMA in the
bf16 tile's instantiations for rows 4, 13 and 14, stride 1 and stride 2
counted apart, in the split-fp32 tile's for the same rows in fp32, and
for row 17's block in bf16 and in fp32; IGMMA in the int8 tile of row 12
and in the block tile of rows 1-3 and 5-11, each library's instantiations
apart; no dp4a ``igemm_kernel`` left in the libraries of the int8 blocks,
no CUDA-core ``conv_f32_kernel`` / ``gemm_f32_kernel`` / ``fp_block_step``
left, no spill in the split-fp32 tile's kernels, and no serialized wgmma,
C7515, in ptxas's report), and then:

1. holds every kernel of the serving paths against its plain PyTorch
   version on the card, at the shapes of ResNet-152 (the bottleneck
   kernels, every 1x1 conv and the fc for ``int8_matmul`` and ``matmul``,
   the latter in bf16 and fp32) and ResNet-34 (the basic kernels), both
   models' 3x3 shapes for the fused convolutions (ResNet-152's in fp32
   too), the stem pool and the int8_chain stem's tail (``stem_pool_int8``,
   both models), 224 px, batch 8: int8 and bf16 block outputs,
   ``int8_matmul``, ``max_pool2d`` and ``stem_pool_int8`` must be equal, the
   fused convolutions (and the bf16 GEMM) within 1 bf16 ulp or, in fp32,
   rtol 1e-4, fp32 per-image means and the fp32 GEMM within rtol 1e-4.  The
   pixel-paired stage-0 kernels are also held against their standard twins
   (equal) and, through their pair-space entries, checked on dense random
   pair-space weights, and the basic transition (row 11, x's ring random
   bytes) from the engine's K-major copies also against a per-call
   transpose (equal).  The kernels of the ``pallas_block`` backend and the
   op library at batch 8: ``bottleneck_block_chained`` at ResNet-152's four
   stage shapes in bf16 and in fp32 (given the FP32 engine's split weight
   copies), and as a 3-block chain at 7x7 (wp = w + 1) whose input ring
   holds NaN, in both; ``bottleneck_block_fused`` at the four stage shapes
   in both (in fp32 also equal bit for bit to the chained form's interior);
   ``avg_pool2d`` (the 7x7 head pool in fp32 and bf16, and
   3x3/2/p1); ``relu``, ``add`` and ``add_relu`` at (32, 56, 56, 256),
   (3, 17, 50), a ragged (7, 37, 41, 67) and the same as views one element
   into their buffers, the last two holding NaN, +-Inf and -0, in bf16 and
   fp32.  The blocks within max error / max |plain| 1e-2 in bf16 (z1 and z2
   are rounded to bf16 inside the block) and 1e-4 in fp32 (and rtol 1e-4),
   the pool
   and the elementwise ops equal (bit for bit where they hold NaN or -0);
   ResNeXt-101 32x8d's grouped blocks (rows 21-22) at its stage shapes,
   batch 128, equal to their plain versions, with their ms a launch, and
   the served ResNeXt-101's launches a forward (``phase_grouped``);
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
   paired and standard, equal bit for bit to the served route.  On
   ResNet-152 the reference's own job runs from files: the model written
   as the reference's weight directory and as a ``.pth``, both read back
   equal, an engine built from the directory, and ``classify_files`` over
   two ``.bin`` inputs, a PNG and a JPEG, equal to ``classify`` of the
   port's own preprocessed arrays and launching one served forward's
   kernels; then the engine's two off-by-default options:
   ``calib_per_channel=True`` (the interior scales baked), and
   HYBRID_XLA_STAGES (0,) and (0, 1), and (0,) on the baked engine, each
   counted (no stage-0 kernel under the prefix, one block kernel a block
   after it) and held to the JAX package's gate (rel-MAE 0.05, argmax
   0.9) and to its plain-version forward.  The op library is driven once
   through ``resnetc_tpu_torch.ops.cuda`` at batch 32: a residual join
   (``add``, ``relu``, ``add_relu``) at ResNet-152's layer1 shape, and a
   layer4 block (``bottleneck_block_fused``) followed by the 7x7 head pool
   (``avg_pool2d``), each counted.  Then training and verification, on
   stock PyTorch ops (no kernel of the table lies on this path):
   ``[fp32]``, in a child process with torch's default TF32 settings,
   ``torch_ops.conv2d`` / ``linear`` at fp32 within 1e-5 of float64 while
   the same calls outside the port read worse; ``[train resnet50]``,
   ResNet-50 trained at full width and depth, 224 px, BF16, batch 128, 13
   steps on one synthetic batch (loss falls, every running stat moves;
   img/s, ms per step, share of the bf16 peak, peak memory);
   ``[train split]``, the step's device time by op family under
   ``torch.profiler`` and the idle share; ``[train parity]``, an FP32
   ResNet-18 step on the card with TF32 on against the CPU's and the
   float64 twin's, and ``remat`` against none; ``[train resnet152
   remat]``, ms per step and peak memory with and without ``remat``;
   ``[trained -> served]``, the trained ResNet-50's unfolded eval forward
   against the folded one and an ``int8_chain`` engine on it, gated and
   counted; ``[cli]``, ``python -m resnetc_tpu_torch train`` in process
   with a checkpoint, an export and a resume; ``[verify resnet152]``, the
   parity reports against the twin at 224 px under FP32.  Then data
   parallelism (``resnetc_tpu_torch.parallel``): ``[dp nccl1]``, an NCCL
   group of world size 1 in this process (after ResNet-152's serving
   phases), the sharded ``int8_chain`` forward equal to the engine's and
   counted, and ResNet-50's FP32 DP step within ``[train parity]``'s band
   of ``train_step``; ``[dp serve resnet152]`` and ``[dp train
   resnet50]``, two ranks spawned onto the one card over gloo (NCCL
   refuses two ranks on one device; the kernels are built before): the
   served engine with ``mesh=`` on a global batch of 32 held to the
   one-process engine by JAX's DP serving contract, each rank's launches
   counted, and ResNet-50's DP step at the global batch 128, FP32 against
   ``train_step`` at ``tests/test_parallel.py``'s tolerances, then three
   BF16 steps (ms, img/s, the gloo all-reduce's ms, peak memory); ``[cli
   dp]``, ``train --data-dim 2`` and the two-process ``--multihost`` form
   of the command, the same losses on both ranks of each; ``[dp serve
   backends]``, ``fp``, ``pallas``, ``pallas_block``, ``int8`` and
   ``int8_static`` on ResNet-50 b32 FP32 over two ranks against one
   process (float backends rtol 1e-4, atol 1e-4; int8 ones JAX's DP
   contract), each rank's launches counted, ms per global batch.  Then
   channel tensor parallelism (the mesh's model axis), a 1 x 2 mesh of two
   gloo ranks on the one card, ResNet-50 at full width, 224 px, FP32,
   batch 8: ``[tp serve]``, the ``fp``, ``pallas`` and ``pallas_block``
   engines against one process (rtol 1e-4, atol 1e-4), ``pallas`` launching
   rows 4, 13, 14 and 15 at shard widths on each rank (counted), ms per
   global batch; ``[tp train resnet50]``, two TP steps, each against
   ``train_step`` and the float64 twin's step from the same state, ms per
   step and the channel collectives' share of an instrumented step; ``[cli
   tp]``, ``classify --model-dim 2`` printing one process's lines and
   ``train --model-dim 2 --checkpoint-dir`` whose checkpoint loads in one
   process within a relative L2 distance of 1e-2 of each param and BN stat
   of the one-process run's, its momentum norm within 1e-3.  Then
   the serving CLI and the data pipeline, each phase's seconds printed:
   ``[native]``, whether the native host library built (it must where
   the libjpeg headers are), its ingest against PIL on 32 seeded JPEGs
   (within one uint8 level, > 90% exact), decode img/s at 1 and 4 threads
   against PIL, and ``read_f32_many`` against ``np.fromfile`` on
   ResNet-152's weight files (bit for bit, wall ms); ``[cli serve
   resnet152]``, the five commands as subprocesses on ResNet-152
   ``int8_chain`` from files: ``export-weights`` (byte for byte the files
   ``save_reference_format`` wrote), ``convert-images`` (byte for byte the
   port's preprocessing), ``classify`` on a ``.bin``, a JPEG and a PNG
   (in-process ``classify``'s indices), ``eval`` on a seeded 2 x 32-JPEG
   tree at batch 32 (count 64, the in-process ``evaluate``'s top-1 and
   top-5, counted: two forwards of the served route) and ``bench
   --batch-size 32 --steps 10 --latency-samples 10`` (JSON, platform
   "gpu"); ``[loader]``, ``BatchLoader`` / ``ImageFolderLoader`` device
   batches equal to their host arrays, and one ``evaluate`` epoch's wall
   ms with prefetch 2 and 0; ``[local latency]``, ``bench_local_latency``
   against ``bench_latency`` and ``fetch_seconds`` at batch 1 and 32, and
   the card's busy share under ``profile_trace``; ``[debug]``, a ResNet-34
   forward inside ``plain_kernels()`` launching nothing and equal to the
   plain-version forward, the served launches outside it, ``nan_debug``
   passing a finite forward and raising on a NaN input to ``relu``;
   ``[train data-dir]``, ``train --data-dir`` on the tree (ResNet-18,
   batch 32, 3 steps, finite losses); ``[cli dp serve]`` (after ``[cli
   serve resnet152]``), ``classify`` (four files: int8_chain refuses a
   batch the data axis does not divide), ``eval`` and ``bench`` (``fp``)
   with ``--data-dim 2`` on the same files, equal to the one-process
   commands.
   Then ``[artifact resnet50]``: ResNet-50 exported (``export.py``'s
   functions, in a child started before the nvcc build, beside the C++
   runner's build, on seeded weights whose fc bias is centred so that the
   classes vary over the images) as ``int8_chain`` on the served route at
   b1 and b32 and ``fp`` at b1, and ResNet-18 as ``int8_chain`` at b8 (the
   basic-block ops), each AOTInductor package loaded here within 1e-2 of
   max |logit| of the engine and calling the ops the engine's forward
   launches, its graph one ``resnetc::`` node per launch of the served
   route, and the C++ runner's logits within 1e-2 of max |logit| of the
   engine's, its classes the engine's, its latency beside
   ``bench_latency``'s.  Every launch of the run goes through the C++ ops
   library that the runner loads too (``csrc/torch_ops.cpp``), so the
   kernel checks above hold each of its ops against the plain version;
3. times the engines (images/s, p50 / p99 ms per batch) for int8_chain on
   both routes (and ResNet-34's BASIC_DS_INT8=False route, ResNet-152's
   per-channel and hybrid routes), int8, pallas, pallas_block (and on
   ResNet-152 the three under FP32) and fp, and
   each kernel per launch at the main paths'
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
   epilogue), F.conv2d (bf16, channels-last) for the fused convolutions
   (on fp32 operands both with TF32 off for cuDNN and cuBLAS, their TF32
   time logged beside, labelled; the fp32 cases' bound at the split
   product's 165 TFLOP/s, and their times summed per FP32 forward),
   F.max_pool2d and F.avg_pool2d for the pools, torch.relu and torch.add
   for relu and add (none computes add_relu or a whole block).  Rows 19-20
   are then printed case by case, beside torch.relu / torch.add, the
   bytes bound and an empty launch.

Prints the card (``nvidia-smi`` name and power limit), one JSON line of
per-kernel results, and as its last line ``{"ok": true, "device": ...}``.
Exits non-zero, without that line, when CUDA is absent or a phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import json
import os
import subprocess
import sys
import time
import warnings

#: Peak rates of one H100 SXM (dense): int8 tensor cores, bf16 tensor
#: cores, fp32 outside the tensor cores, HBM bandwidth.
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
#: The fp32 forms of matmul and the fused convolutions run three TF32
#: tensor-core products per fp32 product (the split-fp32 tile,
#: csrc/tf32x3_tile.cuh): 495 TFLOP/s of TF32 / 3.
PEAK_TF32X3_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12
#: How each peak is named in the log.
PEAK_NAMES = {PEAK_INT8_OPS: "int8 tensor cores", PEAK_BF16_FLOPS: "bf16 tensor cores",
              PEAK_F32_FLOPS: "fp32 CUDA cores",
              PEAK_TF32X3_FLOPS: "split fp32: 495 TFLOP/s of TF32 / 3 products"}

# ResNet-152 at 224 px: (h, c, c4) per stage after the stem and pool.
STAGES = [(56, 64, 256), (28, 128, 512), (14, 256, 1024), (7, 512, 2048)]
# ResNeXt-101 32x8d at 224 px: (h, W = C, group width) per stage.
GROUPED_STAGES = [(56, 256, 8), (28, 512, 16), (14, 1024, 32), (7, 2048, 64)]
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
    ahead of the card (a short kernel behind its wrapper and op) this is
    the host's time per call."""
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
        pools, torch.relu and torch.add.  On fp32 operands it runs with TF32
        off for cuDNN and cuBLAS (IEEE fp32, the kernels' arithmetic)."""
        import torch
        import torch.nn.functional as F

        a = self.args
        call = self._library_call(torch, F, a)
        if call is None or a[0].dtype != torch.float32:
            return call
        from resnetc_tpu_torch.ops.torch_ops import exact_fp32

        def ieee():  # TF32 off for cuDNN and cuBLAS: an fp32 yardstick
            with exact_fp32():
                return call()

        return ieee

    def library_tf32(self):
        """The fp32 cases' library call with TF32 on for cuDNN and cuBLAS
        (reported beside the IEEE one, labelled), or None."""
        import torch
        import torch.nn.functional as F

        call = self._library_call(torch, F, self.args)
        if call is None or self.args[0].dtype != torch.float32:
            return None

        def tf32():
            with tf32_on():
                return call()

        return tf32

    def _library_call(self, torch, F, a):
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
        if self.kernel == "stem_pool_int8":  # the composition the kernel replaced
            return lambda: self.plain(*a)
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
    cases.append(_stem_case("stem/r152", gen, b, dev))
    return cases


def _stem_case(label, gen, b, dev):
    """The int8_chain stem's tail at 224 px: the stem convolution's bias-free
    bf16 output (b, 112, 112, 64), the folded bias, the first block's input
    scale on the card.  Bound by bytes: the bf16 map read once, the pooled
    int8 map written once (``gpubench/metrics/roofline_pct.stem_pool_int8.py``
    counts the same)."""
    import torch

    from resnetc_tpu_torch.ops.cuda import pool

    y = torch.randn((b, 112, 112, 64), generator=gen).to(dev, torch.bfloat16)
    bias = (torch.randn(64, generator=gen) * 0.1).to(dev)
    s_in = torch.tensor(0.02, device=dev)
    return Case(label, "stem_pool_int8", pool.stem_pool_int8, pool.stem_pool_int8_plain,
                (y, bias, s_in), {}, 0, b * 64 * (2 * 112 * 112 + 56 * 56) + 2 * 64,
                PEAK_INT8_OPS, "int8")


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
    cases.append(_stem_case("basic/stem", gen, b, dev))
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
    it; and, for the pallas backend, through matmul in bf16 and in fp32,
    the FP32 route's, given the split (N, K) copy the FP32 engine keeps),
    every 3x3 of ResNet-152 and ResNet-34 through the fused convolutions in
    bf16, ResNet-152's also in fp32 (the FP32 routes': pallas, int8,
    int8_static), two fp32 shapes off every route, and the stem pool."""
    import torch

    from resnetc_tpu_torch.ops.cuda import conv, gemm, pool, quant

    gen = torch.Generator().manual_seed(5678)
    cases = []

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    def f32_matmul(label, m, k, n, res, relu, count):
        # The FP32 route's GEMM: fp32 operands and residual, fp32 out, given
        # w_nk (gemm.pack_nk) as the FP32 engine's tree gives it.
        w = randn(k, n, scale=k**-0.5, dtype=torch.float32)
        cases.append(Case(
            label, "matmul", gemm.matmul, gemm.matmul_plain,
            (randn(m, k, dtype=torch.float32), w, randn(n, scale=0.1, dtype=torch.float32),
             randn(m, n, dtype=torch.float32) if res else None),
            dict(relu=relu, w_nk=gemm.pack_nk(w)), 2 * m * k * n,
            4 * (m * k + k * n + n + m * n * (2 if res else 1)), PEAK_TF32X3_FLOPS, "f32",
            per_forward=count,
        ))

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
        f32_matmul(f"pallas/{label}/fp32", m, k, n, res, relu, count)
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
    f32_matmul("pallas/fc/fp32", m, k, n, False, False, 1)

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
        # fp32: given w_nk (gemm.pack_nk), as the FP32 engine's tree gives
        # it.
        kwargs = dict(relu=True) if dtype == torch.bfloat16 else dict(relu=True,
                                                                       w_nk=gemm.pack_nk(w))
        cases.append(Case(
            label, kernel, fn, plain, args, kwargs,
            2 * b * oh * oh * k * k * cin * cout, nbytes + 4 * cout,
            PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_TF32X3_FLOPS,
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
    # The FP32 route's convolutions (pallas, int8 and int8_static under
    # FP32) at ResNet-152's shapes, and the two fp32 cases timed before the
    # split-fp32 tile (off every route: a stride-1 3x3 with a residual).
    f32 = torch.float32
    for s, (h, c, _) in enumerate(STAGES):
        conv_case(f"conv3x3/r152/s{s}/fp32", "conv3x3_s1_fused", h, c, c, 3, 1,
                  blocks[s] - (s > 0), dtype=f32)
    for s in (1, 2, 3):
        h, c, _ = STAGES[s]
        conv_case(f"conv_s2/r152/s{s}/fp32", "conv_s2_fused", 2 * h, c, c, 3, 2, 1, dtype=f32)
    conv_case("conv3x3/fp32/s1", "conv3x3_s1_fused", 28, 128, 128, 3, 1, 0, res=True, dtype=f32)
    conv_case("conv_s2/fp32/s1", "conv_s2_fused", 56, 128, 128, 3, 2, 0, dtype=f32)

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
    ResNet-152's four stage shapes in bf16 and in fp32, the latter given the
    split (N, K) weight copies the FP32 engine keeps, and a chain of three
    at 7x7, where wp = w + 1, whose input ring holds NaN, in both) and of
    the op library: bottleneck_block_fused at the four stage shapes in both
    (in fp32 also equal bit for bit to the chained form between a pad and an
    unpad), the 7x7 head pool (fp32 and bf16) and the 3x3/2/p1 pool, and
    relu / add / add_relu (``make_ew_cases``)."""
    import torch

    from resnetc_tpu_torch.ops.cuda import block, gemm, pool
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
        ws = _fp_block_weights(randn, c, c4, dtype)
        # fp32: the split copies, as the FP32 engine's tree gives them.
        kw = {} if dtype == torch.bfloat16 else {
            "w1_nk": gemm.pack_nk(ws[0]), "w2_nk": gemm.pack_nk(ws[2]),
            "w3_nk": gemm.pack_nk(ws[4])}
        twin = None
        if kernel == "bottleneck_block_chained":
            hp, wp = chain_meta(b, h, h)
            x = block.pad_for_chain(x)
            if nan_ring:
                ring = ~block.pad_for_chain(torch.ones((b, h, h, 1), device=dev)).bool()[:, 0]
                x[ring] = float("nan")
            kw.update(h=h, w_sp=h)
            rows = b * hp * wp
        else:
            rows = b * h * h
            if dtype == torch.float32:
                def twin(xx, *ww, **kk):  # the chained form's interior
                    yr = block.bottleneck_block_chained(block.pad_for_chain(xx), *ww, h=h,
                                                        w_sp=h, **kk)
                    return block.unpad_from_chain(yr, b, h, h)
        fn, plain = getattr(block, kernel), getattr(block, kernel + "_plain")
        if n > 1:
            fn, plain = _repeat(fn, n), _repeat(plain, n)
        cases.append(Case(
            label, kernel, fn, plain, (x, *ws), kw,
            n * 2 * b * h * h * 17 * c * c,
            size * (2 * rows * c4 + 17 * c * c) + 4 * (2 * c + c4),
            PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_TF32X3_FLOPS,
            "rel" if dtype == torch.bfloat16 else "rel32", per_forward=count, twin=twin,
        ))

    # The bf16 cases, the fp32 stage-1 block and the pools draw the inputs
    # they drew before the fp32 block's redesign (the same generator, in
    # the same order); the other fp32 block cases come last.  The FP32
    # pallas_block route's 46 launches are the four fp32 stage shapes'.
    for s in range(4):
        fp_case(f"fp_block/s{s}", "bottleneck_block_chained", s, torch.bfloat16,
                count=blocks[s] - 1)
    fp_case("fp_block/s1/fp32", "bottleneck_block_chained", 1, torch.float32,
            count=blocks[1] - 1)
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

    for s in (0, 2, 3):
        fp_case(f"fp_block/s{s}/fp32", "bottleneck_block_chained", s, torch.float32,
                count=blocks[s] - 1)
    fp_case("fp_block/chain3/nan_ring/s3/fp32", "bottleneck_block_chained", 3, torch.float32,
            n=3, nan_ring=True)
    for s in range(4):
        fp_case(f"fp_block_fused/s{s}/fp32", "bottleneck_block_fused", s, torch.float32)
    return cases + make_ew_cases(dev)


def make_ew_cases(dev) -> list:
    """relu, add and add_relu (rows 19-20) at ``EW_SHAPES``, bf16 and fp32."""
    import torch

    from resnetc_tpu_torch.ops.cuda import elementwise

    gen = torch.Generator().manual_seed(8766)
    cases = []
    for op in ("relu", "add", "add_relu"):
        for where, (shape, off, specials) in EW_SHAPES.items():
            for dtype in (torch.bfloat16, torch.float32):
                n_in = 1 if op == "relu" else 2
                numel = 1
                for d in shape:
                    numel *= d
                size = 2 if dtype == torch.bfloat16 else 4
                tag = where + ("" if dtype == torch.bfloat16 else "/fp32")
                args = tuple(_ew_operand(gen, shape, off, specials, dtype, dev)
                             for _ in range(n_in))
                cases.append(Case(
                    f"{op}/{tag}", op, getattr(elementwise, op),
                    getattr(elementwise, op + "_plain"), args, {}, 0,
                    size * numel * (n_in + 1), PEAK_F32_FLOPS,
                    "bits" if specials else "bf16" if dtype == torch.bfloat16 else "f32eq",
                ))
    return cases


#: The elementwise cases (rows 19-20): shape, the operands' offset in
#: elements from the start of their buffers, and whether they hold NaN,
#: +-Inf and -0.  ResNet-152's layer1 join at the serving batch; a small
#: size (one block); a ragged size off the 16-byte grid, large enough for
#: the vector body; the same as views one element into their buffers.
EW_SHAPES = {
    "l1": ((32, 56, 56, 256), 0, False),
    "odd": ((3, 17, 50), 0, False),
    "ragged": ((7, 37, 41, 67), 0, True),
    "offset": ((7, 37, 41, 67), 1, True),
}


def _ew_operand(gen, shape, off, specials, dtype, dev):
    """A normal operand of ``shape`` (a view ``off`` elements into its
    buffer); with ``specials``, one value in 64 each of NaN, +Inf, -Inf, -0
    and +0 at random places."""
    import torch

    n = 1
    for d in shape:
        n *= d
    x = torch.randn(n + off, generator=gen)
    if specials:
        where = torch.randint(0, 64, (n + off,), generator=gen)
        for code, v in enumerate((float("nan"), float("inf"), float("-inf"), -0.0, 0.0)):
            x[where == code] = v
    return x.to(dev, dtype)[off:].view(shape)


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
    if case.check == "bits":
        # Bit for bit, NaN and the sign of a zero included.
        ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[got.dtype]
        bad = int((got.view(ints) != want.view(ints)).sum())
        if bad:
            raise AssertionError(f"{case.name}: {bad} values differ from plain in their bits")
        if not (bool(torch.isnan(want).any()) and bool(torch.isinf(want).any())):
            raise AssertionError(f"{case.name}: no NaN or Inf in the output to check")
    elif case.check in ("int8", "bf16", "f32eq"):
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
    elif case.check == "rel32":
        # The fp32 blocks: rtol 1e-4 elementwise, and max error / max |plain|
        # within 1e-4 (FP_BLOCK_TOL), finite where the plain version is.
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"{case.name}: {m}")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{case.name}: non-finite output")
        rel = err / float(want.abs().max())
        if not rel <= 1e-4:
            raise AssertionError(f"{case.name}: max error / max |plain| {rel} > 1e-4")
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
    # rows 13 and 14 in fp32: the split-fp32 tile (TF32 wgmma)
    ("libconv.so", r"tf32x3_kernel.*ConvA32LoaderILi\d+ELb[01]ELi1E", "HGMMA"),
    ("libconv.so", r"tf32x3_kernel.*ConvA32LoaderILi\d+ELb[01]ELi2E", "HGMMA"),
    # row 4: matmul (bf16, and fp32 on the split-fp32 tile)
    ("libgemm.so", r"tile_kernel.*GemmALoader", "HGMMA"),
    ("libgemm.so", r"tf32x3_kernel.*GemmA32LoaderT", "HGMMA"),
    # row 12: int8_matmul
    ("libint8_gemm.so", r"s8_tile_kernel", "IGMMA"),
    # rows 17 and 18: bottleneck_block_chained / _fused in bf16 (conv1 and
    # conv3 through the GEMM loader, conv2 through the im2col one)
    ("libfp_block.so", r"tile_kernel.*GemmALoader", "HGMMA"),
    ("libfp_block.so", r"tile_kernel.*ConvALoader", "HGMMA"),
    # rows 17 and 18 in fp32: the split-fp32 tile (conv1 and conv3 through
    # its GEMM loader over the chain row maps, ChainA32Loader, conv2 through
    # its im2col one)
    ("libfp_block.so", r"tf32x3_kernel.*GemmA32LoaderTILi\d+ELb[01]ELb1E", "HGMMA"),
    ("libfp_block.so", r"tf32x3_kernel.*ConvA32Loader", "HGMMA"),
    # rows 1-3: bottleneck_block_chained_int8, the run and the stride-2
    # transition downsample_block_s2_int8
    ("libchain_block.so", r"chain_tile_kernel", "IGMMA"),
    # rows 7, 8 and 11: basic_block_chained_int8, the run and the stride-2
    # transition basic_ds_block_s2_int8
    ("libbasic_block.so", r"chain_tile_kernel", "IGMMA"),
    # rows 5, 6, 9 and 10: the pixel-paired bottleneck and basic blocks and
    # runs
    ("libpp_block.so", r"chain_tile_kernel", "IGMMA"),
    # rows 21 and 22: the ResNeXt blocks, grouped_block_int8 and
    # grouped_ds_block_s2_int8 (their 1x1s, and the grouped 3x3 apart)
    ("libgrouped_block.so", r"chain_tile_kernel", "IGMMA"),
    ("libgrouped_block.so", r"grouped_tile_kernel", "IGMMA"),
)
#: Libraries that must hold no dp4a implicit GEMM (``igemm_kernel``, the
#: CUDA-core kernel the int8 blocks ran before the int8 tile) any more.
NO_IGEMM = ("libchain_block.so", "libbasic_block.so", "libpp_block.so")
#: Sources whose split-fp32 tile kernels must not spill (ptxas's report of
#: a source built in this run).
NO_SPILL = ("gemm", "conv", "fp_block")
#: The CUDA-core fp32 tiles that the split-fp32 tile replaced: gone.
GONE = (("libconv.so", "conv_f32_kernel"), ("libgemm.so", "gemm_f32_kernel"),
        ("libfp_block.so", "fp_block_step"))


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


def _spills(report: str) -> dict:
    """{kernel: (bytes of spill stores, of spill loads)} from ptxas's -v
    report of one source."""
    import re

    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            out[cur] = (int(m.group(1)), int(m.group(2)))
            cur = None
    return out


def phase_sass(build_dir) -> dict:
    """The tensor-core kernels hold wgmma instructions in their SASS
    (``SASS_CHECKS``): HGMMA in the bf16 tile's instantiations, IGMMA in
    the int8 tiles.  Counted per kernel, not per library, so another
    kernel's wgmma cannot stand in.  ``NO_IGEMM``'s libraries hold no dp4a
    kernel, ptxas reported no serialized wgmma (C7515) for a source built
    in this run, and no spill in the split-fp32 tile's kernels of
    ``NO_SPILL``'s sources built in this run."""
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
    for lib, kernel in GONE:
        left = [name for name in libs[lib] if kernel in name]
        if left:
            raise AssertionError(f"{lib}: still holds {left[0]}")
        log(f"[sass] {lib}: no {kernel}")
    # ptxas's C7515 ("wgmma ... serialized") in any source built this run.
    built = sorted(_build.BUILD_LOG)
    serialized = [name for name in built if "C7515" in _build.BUILD_LOG[name]]
    if serialized:
        raise AssertionError(f"ptxas serialized wgmma (C7515) in {serialized}")
    log(f"[sass] no C7515 in the ptxas output of {len(built)} sources built in this run"
        + ("" if built else " (every library was already built)"))
    for name in NO_SPILL:
        if name not in _build.BUILD_LOG:
            log(f"[sass] lib{name}.so was already built: its spills are not checked")
            continue
        tile = {k: v for k, v in _spills(_build.BUILD_LOG[name]).items() if "tf32x3_kernel" in k}
        if not tile:
            raise AssertionError(f"{name}: no ptxas report of a tf32x3_kernel")
        spilled = [k for k, v in tile.items() if v != (0, 0)]
        if spilled:
            raise AssertionError(f"{name}: ptxas spilled in {spilled[0]} ({tile[spilled[0]]})")
        log(f"[sass] {name}: {len(tile)} tf32x3_kernel instantiations, no spill")
    return counts


def phase_kernels(cases: list) -> dict:
    errs = {}
    for case in cases:
        errs[case.name] = check_case(case)
        twin = " and to its twin" if case.twin else ""
        how = {"bf16ulp": "within 1 bf16 ulp of", "f32": "within rtol 1e-4 of",
               "rel": "within 1e-2 of max |plain| of",
               "rel32": "within rtol 1e-4 and 1e-4 of max |plain| of",
               "bits": "equal bit for bit to"}.get(case.check, "equal to")
        log(f"[kernels] {case.name}: {how} plain{twin}, max_abs_err={errs[case.name]}")
    return errs


def main_path_counts(blocks: tuple | None = None, basic: tuple | None = None) -> dict:
    """Launches of each kernel case per forward of its model (ResNet-152
    for the bottleneck cases, or another bottleneck net's ``blocks``, and
    ResNet-34 for the basic ones, or another basic net's ``basic``) on the
    route that runs it, by case name."""
    from resnetc_tpu_torch.models import get_config

    blocks = blocks or get_config("resnet152").stage_blocks
    basic = basic or get_config("resnet34").stage_blocks
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
        "stem/r152": 1,
        "basic/stem": 1,
    }


#: The stage-0 cases of each full-depth route: the served (pixel-paired)
#: one and the standard one (L1_PIXEL_PAIR off).
ROUTE_ONLY = {
    True: {"pp/block/proj/s0", "pp/run/n2/s0", "pp/basic/run/n3/s0"},
    False: {"block/proj/s0", "run/n2/s0", "basic/run/n3/s0"},
}
#: Cases whose stage-0 route runs only in phase_reduced_routes (per block).
REDUCED_ONLY = {"pp/basic/block/s0"}


def expected_launches(cases: list, pp: bool, blocks: tuple | None = None,
                      basic: tuple | None = None) -> dict:
    """Launches of each kernel in one forward of the cases' model (or of the
    bottleneck net with ``blocks``, the basic net with ``basic``), on the
    pixel-paired route or the standard one."""
    counts = main_path_counts(blocks, basic)
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
    want = {"stem_pool_int8": 1, "basic_run_chained_int8": 1,
            "basic_block_chained_int8": sum(cfg.stage_blocks[1:]) - 3,
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
    rest = {"stem_pool_int8": 1, "downsample_block_s2_int8": 3,
            "bottleneck_block_chained_int8": 3, "matmul": 1}
    basic_rest = {"stem_pool_int8": 1, "basic_ds_block_s2_int8": 3,
                  "basic_block_chained_int8": 3, "matmul": 1}
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


def _trees_equal(got: dict, want: dict) -> bool:
    import torch

    from resnetc_tpu_torch.tensor import flatten_tree

    got, want = flatten_tree(got), flatten_tree(want)
    return set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


def phase_files(e2e: dict, cases: list, dev) -> dict:
    """The reference's own job on ResNet-152 at full width and depth:
    ResNet-152 (seed 0) written as the reference's weight directory
    (``save_reference_format``) and read back (``load_reference_format``),
    also as a torch file (``torch_state_dict_from_variables``,
    ``torch.save``, ``variables_from_torch_file``): the three trees equal.
    An int8_chain engine built from the directory's tree gives the served
    engine's logits bit for bit; then ``classify_files`` over two ``.bin``
    inputs and a PNG and a JPEG of odd sizes gives ``classify`` of the
    port's own preprocessed arrays, and launches what one forward of the
    served route launches.  Its wall time (host preprocessing included) is
    printed."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    from PIL import Image

    from resnetc_tpu_torch import checkpoint
    from resnetc_tpu_torch.data import preprocess
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.serve import InferenceEngine, classify_files

    tag = "[files resnet152]"
    cfg = resnet.get_config("resnet152")
    variables = resnet.init(cfg, torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        n = checkpoint.save_reference_format(variables, tmp / "weights")
        loaded = checkpoint.load_reference_format(cfg, tmp / "weights")
        torch.save(checkpoint.torch_state_dict_from_variables(loaded), tmp / "resnet152.pth")
        from_pth = checkpoint.variables_from_torch_file(tmp / "resnet152.pth")
        io_s = time.perf_counter() - t0
        if not (_trees_equal(loaded, variables) and _trees_equal(from_pth, variables)):
            raise AssertionError(f"{tag} the weight files do not give back the tree written")
        log(f"{tag} {n} weight files and a .pth written and read back in {io_s:.1f} s: "
            "the three trees equal")

        rng = np.random.default_rng(0)
        paths = []
        for i in range(2):
            path = tmp / f"input{i}.bin"
            preprocess.save_input_bin(rng.standard_normal((1, 3, 224, 224)).astype(np.float32),
                                      path)
            paths.append(str(path))
        for name, shape in (("a.png", (301, 257, 3)), ("b.jpeg", (263, 389, 3))):
            Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(tmp / name)
            paths.append(str(tmp / name))

        calib = torch.randn((8, 224, 224, 3), generator=torch.Generator().manual_seed(1))
        eng = InferenceEngine(cfg, loaded, backend="int8_chain", calib_batch=calib, device=dev)
        with torch.inference_mode():
            same = torch.equal(eng.logits(e2e["x"]), e2e["engine"].logits(e2e["x"]))
        if not same:
            raise AssertionError(f"{tag} the engine from the weight files differs from the "
                                 "served one")
        t0 = time.perf_counter()
        got, launches = counted(lambda: classify_files(eng, paths))
        wall_ms = (time.perf_counter() - t0) * 1e3
        arrays = np.concatenate([preprocess.load_input_bin(p) if p.endswith(".bin")
                                 else preprocess.preprocess_file(p) for p in paths])
        want = [int(i) for i in eng.classify(arrays)]
    log(f"{tag} classify_files({[Path(p).name for p in paths]}) = {got} in {wall_ms:.1f} ms "
        f"wall (host preprocessing included); launches {json.dumps(launches)}")
    if got != want:
        raise AssertionError(f"{tag} classify_files gave {got}, classify of the arrays {want}")
    expected = expected_launches(cases, pp=True)
    if launches != expected:
        raise AssertionError(f"{tag} classify_files launched {launches}, expected {expected}")
    return {"classes": got, "launches": launches, "classify_files_wall_ms": wall_ms,
            "weights_io_s": io_s}


def hybrid_launches(cfg, stages: tuple) -> dict:
    """Launches of one int8_chain forward of a bottleneck net under
    HYBRID_XLA_STAGES ``stages``: the transition kernel at each later
    stage, the block kernel at every other block of those stages, the fc."""
    rest = range(len(stages), 4)
    return {"downsample_block_s2_int8": len(rest),
            "bottleneck_block_chained_int8": sum(cfg.stage_blocks[s] - 1 for s in rest),
            "matmul": 1}


def phase_options(e2e: dict, cases: list, dev) -> dict:
    """The int8_chain engine's two off-by-default options on ResNet-152 at
    full width and depth, batch 32: the engine with
    ``calib_per_channel=True`` (the bake), and HYBRID_XLA_STAGES (0,) and
    (0, 1) on the served engine and (0,) on the baked one.  Each forward is
    counted (the served route's launches for the baked engine; under the
    hybrid prefix, ``hybrid_launches``), held to the JAX package's gate
    against the fp32 forward (rel-MAE 0.05, argmax agreement 0.9,
    tests/test_pallas.py:1806-1875) and within 1e-2 of max |logit| of the
    same forward on the plain versions.  Returns the routes for timing."""
    import torch

    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.ops.cuda import fused
    from resnetc_tpu_torch.serve import InferenceEngine

    tag = "[options resnet152]"
    cfg = resnet.get_config("resnet152")
    variables = resnet.init(cfg, torch.Generator().manual_seed(0))
    calib = torch.randn((8, 224, 224, 3), generator=torch.Generator().manual_seed(1))
    baked = InferenceEngine(cfg, variables, backend="int8_chain", calib_batch=calib,
                            calib_per_channel=True, device=dev)
    if any(float(v) != 1.0 for blocks in baked.chain_scales.values()
           for sites in blocks.values() for k, v in sites.items() if k != "in"):
        raise AssertionError(f"{tag} the baked engine kept interior runtime scales")
    x, eng = e2e["x"], e2e["engine"]
    routes = [
        ("int8_chain_per_channel", baked, {}, expected_launches(cases, pp=True)),
        ("int8_chain_hybrid_0", eng, {"HYBRID_XLA_STAGES": (0,)}, hybrid_launches(cfg, (0,))),
        ("int8_chain_hybrid_0_1", eng, {"HYBRID_XLA_STAGES": (0, 1)},
         hybrid_launches(cfg, (0, 1))),
        ("int8_chain_hybrid_0_per_channel", baked, {"HYBRID_XLA_STAGES": (0,)},
         hybrid_launches(cfg, (0,))),
    ]
    out = {"routes": [(label, e, flags) for label, e, flags, _ in routes], "gates": {},
           "launches": {}}
    for label, e, flags, want in routes:
        logits, launches = forward_counted(e, x, **flags)
        log(f"{tag} launches in one {label} forward {json.dumps(flags)}: {json.dumps(launches)}")
        if launches != want:
            raise AssertionError(f"{tag} {label} launched {launches}, expected {want}")
        with module_flags(**flags), torch.inference_mode():
            plain = fused.fused_forward_int8_chain(cfg, e.folded, e.chain_scales, x,
                                                   kernels=fused.PLAIN)
        rep = _against(tag, label, logits, e2e["ref32"], plain)
        if not (rep["rel_mae_vs_fp32"] < 0.05 and rep["argmax_vs_fp32"] >= 0.9):
            raise AssertionError(f"{tag} {label} logits outside the fp gate")
        out["gates"][label], out["launches"][label] = rep, launches
    return out


# ---------------------------------------------------------------------------
# Training and verification (no kernel of the table lies on this path)
# ---------------------------------------------------------------------------

#: Run in a child process with torch's default TF32 settings: the port's
#: fp32 conv2d / linear against float64 on the CPU, beside the same calls
#: made outside the port with TF32 on.
FP32_CHILD = r"""
import json
import torch
import torch.nn.functional as F
from resnetc_tpu_torch.ops import torch_ops

conv, mm = torch.backends.cudnn.conv, torch.backends.cuda.matmul
defaults = {"cudnn.conv": conv.fp32_precision, "cuda.matmul": mm.fp32_precision}
g = torch.Generator().manual_seed(0)
x = torch.randn(8, 56, 56, 64, generator=g)
w = torch.randn(3, 3, 64, 64, generator=g) / 24
a = torch.randn(8, 2048, generator=g)
wl = torch.randn(1000, 2048, generator=g) / 45
bl = torch.randn(1000, generator=g)
conv64 = F.conv2d(x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
                  padding=1).permute(0, 2, 3, 1)
lin64 = a.double() @ wl.double().t() + bl.double()


def rel(got, want):
    return float((got.double().cpu() - want).abs().max() / want.abs().max())


xc, wc, ac, wlc, blc = (t.cuda() for t in (x, w, a, wl, bl))
out = {"defaults": defaults}
out["conv2d"] = rel(torch_ops.conv2d(xc, wc, padding=1), conv64)
out["conv2d_tf32"] = rel(F.conv2d(xc.permute(0, 3, 1, 2), wc.permute(3, 2, 0, 1),
                                  padding=1).permute(0, 2, 3, 1), conv64)
out["linear"] = rel(torch_ops.linear(ac, wlc, blc), lin64)
mm.fp32_precision = "tf32"
out["linear_tf32"] = rel(ac @ wlc.t() + blc, lin64)
out["linear_under_tf32"] = rel(torch_ops.linear(ac, wlc, blc), lin64)
out["after"] = {"cudnn.conv": conv.fp32_precision, "cuda.matmul": mm.fp32_precision}
print(json.dumps(out))
"""


def phase_fp32() -> dict:
    """The FP32 policy computes in IEEE fp32 on the card: in a fresh process
    with torch's default TF32 settings, ``torch_ops.conv2d`` (ResNet-50's
    3x3 at 56x56x64, batch 8) and ``linear`` (the fc, batch 8) within 1e-5
    of max |float64| of the same math on the CPU; the same convolution and
    matmul made outside the port with TF32 on must read worse, and the
    port's guard must hand the settings back."""
    import os

    tag = "[fp32]"
    out = subprocess.run([sys.executable, "-c", FP32_CHILD], capture_output=True, text=True,
                         timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    if out.returncode != 0:
        raise AssertionError(f"{tag} child process failed:\n{out.stderr[-3000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    log(f"{tag} torch defaults {json.dumps(res['defaults'])}; max error / max |fp64|: "
        f"conv2d {res['conv2d']} (TF32 outside the port: {res['conv2d_tf32']}), "
        f"linear {res['linear']} (TF32: {res['linear_tf32']}; the port's under "
        f"TF32: {res['linear_under_tf32']}); settings after {json.dumps(res['after'])}")
    for key in ("conv2d", "linear", "linear_under_tf32"):
        if res[key] > 1e-5:
            raise AssertionError(f"{tag} {key} is not IEEE fp32: {res[key]}")
    if not (res["conv2d_tf32"] > res["conv2d"] and res["linear_tf32"] > res["linear"]):
        raise AssertionError(f"{tag} the TF32 calls did not read worse: {res}")
    if res["after"]["cudnn.conv"] != res["defaults"]["cudnn.conv"] or \
            res["after"]["cuda.matmul"] != "tf32":
        raise AssertionError(f"{tag} the guard did not give the settings back: {res}")
    return res


@contextlib.contextmanager
def tf32_on():
    """TF32 for cuDNN convolutions and cuBLAS matmuls for the duration."""
    import torch

    conv, mm = torch.backends.cudnn.conv, torch.backends.cuda.matmul
    saved = conv.fp32_precision, mm.fp32_precision
    conv.fp32_precision = mm.fp32_precision = "tf32"
    try:
        yield
    finally:
        conv.fp32_precision, mm.fp32_precision = saved


#: ResNet-50 training on the card: batch, warm-up and timed steps, and the
#: peak learning rate.  At the JAX CLI's 0.1 the JAX package itself
#: diverges on one fixed batch over 13 steps (on the CPU at ResNet-50,
#: 112 px, batch 32: 6.94 -> 39.7 at step 8 -> 7.50 at step 13), so this
#: trains at 0.02, where JAX and the port both fall (6.94 -> 3.16, 6.96 ->
#: 3.44); ``python tests/test_torch_train.py trajectory`` measures both.
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_TIMED, TRAIN_LR = 128, 3, 10, 0.02


def phase_train_resnet50(dev) -> dict:
    """ResNet-50 at full width and depth, 224 px, BF16, batch 128, the JAX
    CLI's defaults but the peak rate (lr 0.02, see TRAIN_LR; momentum 0.9,
    weight decay 1e-4, cosine with 5 warm-up steps over the 13 steps) on
    ``synthetic_batches`` (one fixed batch): 3 warm-up steps, then 10 timed between CUDA events.  The loss
    must be finite and lower at step 13 than at step 1, and every BN
    running stat must have moved.  Prints img/s, ms per step, the step's
    share of the bf16 peak (3 x model_flops x batch per step over 989
    TFLOP/s) and the peak memory allocated."""
    import torch

    from resnetc_tpu_torch import train
    from resnetc_tpu_torch.data.loader import synthetic_batches
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.tensor import flatten_tree
    from resnetc_tpu_torch.utils.flops import model_flops

    tag = "[train resnet50]"
    cfg = resnet.get_config("resnet50")
    tcfg = train.TrainConfig(lr=TRAIN_LR)
    steps = TRAIN_WARMUP + TRAIN_TIMED
    sched = train.cosine_schedule(tcfg.lr, steps, warmup_steps=5)
    t0 = time.perf_counter()
    ts = train.init_train_state(cfg, torch.Generator().manual_seed(0), device=dev)
    stats0 = {k: v.clone() for k, v in flatten_tree(ts.bn_state).items()}
    x, y = next(iter(synthetic_batches(batch_size=TRAIN_BATCH, steps=1, seed=0, device=dev)))
    torch.cuda.synchronize()
    log(f"{tag} state and batch on the card in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for _ in range(TRAIN_WARMUP):
        ts, m = train.train_step(cfg, tcfg, ts, x, y, sched(ts.step))
        losses.append(m["loss"])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(TRAIN_TIMED):
        ts, m = train.train_step(cfg, tcfg, ts, x, y, sched(ts.step))
        losses.append(m["loss"])
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / TRAIN_TIMED
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    flops = 3 * model_flops(cfg, 224) * TRAIN_BATCH
    share = flops / (ms / 1e3) / PEAK_BF16_FLOPS
    res = {"batch": TRAIN_BATCH, "ms_per_step": ms, "images_per_s": TRAIN_BATCH / (ms / 1e3),
           "bf16_peak_share": share, "max_memory_allocated_gib": peak / 2**30,
           "losses": losses, "accuracy_last": float(m["accuracy"]),
           "grad_norm_last": float(m["grad_norm"]), "step": int(ts.step)}
    log(f"{tag} batch {TRAIN_BATCH}: {res['images_per_s']:.1f} img/s, {ms:.3f} ms per step "
        f"(mean of {TRAIN_TIMED} after {TRAIN_WARMUP} warm-up), {share:.4f} of the bf16 peak "
        f"(3 x {model_flops(cfg, 224) / 1e9:.3f} GFLOP per image), "
        f"max_memory_allocated {res['max_memory_allocated_gib']:.2f} GiB")
    log(f"{tag} loss by step: {[round(v, 4) for v in losses]}")
    if not all(v == v and abs(v) != float("inf") for v in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"{tag} the loss is not finite or did not fall: {losses}")
    stats = flatten_tree(ts.bn_state)
    unmoved = [k for k, v in stats0.items() if torch.equal(stats[k], v)]
    if unmoved:
        raise AssertionError(f"{tag} running stats that did not move: {unmoved[:4]}")
    log(f"{tag} all {len(stats)} BN running stats moved; the loss fell "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"ts": ts, "x": x, "y": y, "tcfg": tcfg, **res}


#: Op families of the training step's device time (``[train split]``).
CONV_FWD_OPS = ("aten::cudnn_convolution", "aten::_convolution", "aten::convolution")
ELEMENTWISE_OPS = ("aten::mul", "aten::add", "aten::sub", "aten::div", "aten::mean",
                   "aten::sum", "aten::square", "aten::pow", "aten::rsqrt", "aten::neg",
                   "aten::_to_copy", "aten::copy_", "aten::mul_", "aten::add_", "aten::fill_",
                   "aten::zero_", "aten::expand", "aten::where")


def _op_family(op: str) -> str:
    if op.startswith("aten::_foreach") or op == "aten::linalg_vector_norm":
        return "optimizer update"
    if op in CONV_FWD_OPS:
        return "convolution forward"
    if "convolution_backward" in op:
        return "convolution backward"
    if op in ELEMENTWISE_OPS:
        return "BN formula, residual add and casts (elementwise, reductions)"
    return "other"


def phase_train_split(tr: dict) -> dict:
    """One ``torch.profiler`` run over 3 of the ResNet-50 steps: device time
    summed by op family (each kernel under the op that launched it; what
    no op holds counts as other) and the device's idle share of the
    window, with the top ops and kernels (``--out`` keeps them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from resnetc_tpu_torch import train
    from resnetc_tpu_torch.models import resnet

    tag = "[train split]"
    cfg = resnet.get_config("resnet50")
    ts, x, y, tcfg = tr["ts"], tr["x"], tr["y"], tr["tcfg"]
    n = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            ts, _ = train.train_step(cfg, tcfg, ts, x, y, 1e-4)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    tr["ts"] = ts

    ops, kernels = {}, {}
    for evt in prof.key_averages():
        us = float(evt.self_device_time_total)
        if not us:
            continue
        if str(evt.device_type).endswith("CPU"):
            ops[evt.key] = ops.get(evt.key, 0.0) + us
        else:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us
    busy_us = sum(kernels.values())
    if busy_us <= 0:
        raise AssertionError(f"{tag} the profiler saw no device time")
    families: dict = {}
    for name, us in ops.items():
        fam = _op_family(name)
        families[fam] = families.get(fam, 0.0) + us / 1e3 / n
    unattributed = busy_us / 1e3 / n - sum(families.values())
    if abs(unattributed) > 1e-3:
        families["other"] = families.get("other", 0.0) + unattributed
    step_ms = busy_us / 1e3 / n
    idle = 1 - busy_us / 1e3 / wall_ms
    log(f"{tag} ResNet-50 b{tr['batch']} BF16, {n} profiled steps: device {step_ms:.3f} ms "
        f"per step, wall {wall_ms / n:.3f} ms per step, device idle share {idle:.4f}")
    for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
        log(f"{tag}   {fam}: {ms:.3f} ms per step ({ms / step_ms:.3f})")
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:25]
    top_kernels = sorted(kernels.items(), key=lambda kv: -kv[1])[:25]
    for name, us in top_ops[:12]:
        log(f"{tag}   op {name}: {us / 1e3 / n:.3f} ms per step")
    return {"families_ms_per_step": families, "device_ms_per_step": step_ms,
            "wall_ms_per_step": wall_ms / n, "idle_share": idle,
            "top_ops_us": top_ops, "top_kernels_us": top_kernels}


def phase_train_parity(dev) -> dict:
    """ResNet-18 at 64 px, batch 8, FP32 (lr 0.1, momentum 0.9, weight decay
    1e-4): one ``train_step`` on the card, with TF32 turned on in the
    process, and one on the CPU from the same state and batch, beside the
    exact step (the twin in float64, ``torch.optim.SGD``).  The losses
    within 5e-4; every parameter and running stat of the card's step
    within rtol 1e-3, atol 1e-5 of the exact step, a band widened by twice
    the CPU step's own distance from it where that is larger: the stem's
    weight gradient, a sum over 8,192 pixels through train-mode BN, is
    poorly resolved in fp32 for some draws (on the CPU, 3 of 6 init seeds
    put conv1.weight 16-63 band-widths from the exact step, this one 16,
    with five of layer1's leaves 2-8: ``python tests/test_torch_train.py
    step_seeds``).
    Then ``remat=True`` against ``remat=False`` on the card at batch 16:
    gradients' difference norm within 1e-4 of their norm, running stats
    within 1e-5."""
    import torch
    import torch.nn.functional as F

    from resnetc_tpu_torch import checkpoint, train
    from resnetc_tpu_torch.data.loader import synthetic_batches
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.ops.torch_ops import exact_fp32
    from resnetc_tpu_torch.tensor import FP32, flatten_tree, tree_map
    from resnetc_tpu_torch.verify.twin import build_twin

    tag = "[train parity]"
    cfg = resnet.get_config("resnet18")
    tcfg = train.TrainConfig(policy_name="fp32")
    cpu = train.init_train_state(cfg, torch.Generator().manual_seed(4), device="cpu")
    card = train.TrainState(step=cpu.step.to(dev, copy=True),
                            **{k: tree_map(lambda t: t.to(dev, copy=True), getattr(cpu, k))
                               for k in ("params", "bn_state", "momentum")})
    twin = build_twin(cfg).double().train()
    sd = checkpoint.torch_state_dict_from_variables(
        resnet.merge_params_state(cpu.params, cpu.bn_state))
    twin.load_state_dict({k: v.double() for k, v in sd.items()}, strict=False)
    x, y = next(iter(synthetic_batches(batch_size=8, image_size=64, steps=1, seed=5,
                                       device="cpu")))
    with tf32_on():
        card, mg = train.train_step(cfg, tcfg, card, x.to(dev), y.to(dev), tcfg.lr)
        torch.cuda.synchronize()
    cpu, mc = train.train_step(cfg, tcfg, cpu, x, y, tcfg.lr)
    opt = torch.optim.SGD(twin.parameters(), lr=tcfg.lr, momentum=tcfg.momentum,
                          weight_decay=tcfg.weight_decay)
    exact_loss = F.cross_entropy(twin(x.double().permute(0, 3, 1, 2)), y.long())
    exact_loss.backward()
    opt.step()
    exact = flatten_tree(checkpoint.variables_from_torch_state_dict(twin.state_dict()))
    dloss = abs(float(mg["loss"]) - float(mc["loss"]))
    worst, worst_key, plain_worst, cpu_worst = 0.0, None, 0.0, 0.0
    for name in ("params", "bn_state"):
        got = flatten_tree(getattr(card, name))
        want = flatten_tree(getattr(cpu, name))
        for k, w in want.items():
            e = exact[k].double()
            band = 1e-5 + 1e-3 * e.abs()
            cpu_err = (w.double() - e).abs()
            ratio = float(((got[k].cpu().double() - e).abs()
                           / torch.maximum(band, 2 * cpu_err)).max())
            if ratio > worst:
                worst, worst_key = ratio, k
            plain_worst = max(plain_worst, float(((got[k].cpu() - w).abs()
                                                  / (1e-5 + 1e-3 * w.abs())).max()))
            cpu_worst = max(cpu_worst, float((cpu_err / band).max()))
    log(f"{tag} ResNet-18 64 px b8 FP32, TF32 on in the process: loss card {float(mg['loss'])} "
        f"cpu {float(mc['loss'])} float64 {float(exact_loss)}; parameters and running stats "
        f"in band-widths (rtol 1e-3, atol 1e-5): card vs CPU {plain_worst}, CPU vs float64 "
        f"{cpu_worst}, card vs float64 in the widened band {worst} ({worst_key})")
    if dloss > 5e-4 or worst > 1.0:
        raise AssertionError(f"{tag} the card's FP32 step disagrees with the CPU's")

    variables = resnet.init(cfg, torch.Generator().manual_seed(8))
    params, bn_state = resnet.split_params_state(tree_map(lambda t: t.to(dev), variables))
    x16, y16 = next(iter(synthetic_batches(batch_size=16, image_size=64, steps=1, seed=9,
                                           device=dev)))

    def grads(remat):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
        with exact_fp32():
            loss, (state, _) = train.loss_fn(cfg, p, bn_state, x16, y16, policy=FP32,
                                             remat=remat)
            flat = flatten_tree(p)
            return torch.autograd.grad(loss, list(flat.values())), flatten_tree(state)

    (g0, s0), (g1, s1) = grads(False), grads(True)
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(g0, g1))
    den = sum(float((a**2).sum()) for a in g0)
    rel = (num / den) ** 0.5
    stat_err = max(float(((s0[k] - s1[k]).abs() / (1e-6 + s0[k].abs())).max()) for k in s0)
    log(f"{tag} remat vs no remat on the card, b16: gradient difference norm / norm = {rel}; "
        f"running stats max relative difference {stat_err}")
    if rel > 1e-4 or stat_err > 1e-5:
        raise AssertionError(f"{tag} remat changes the gradients or the running stats")
    return {"loss_diff": dloss, "worst_ratio": worst, "card_vs_cpu_ratio": plain_worst,
            "cpu_vs_float64_ratio": cpu_worst, "remat_grad_rel": rel,
            "remat_stat_rel": stat_err}


def phase_train_remat_resnet152(dev) -> dict:
    """The reference's model, ResNet-152 at 224 px, batch 32, BF16: 3 steps
    with ``remat=True`` and 3 without, from one state; ms per step (the
    mean of the last two, between CUDA events) and the peak memory of
    each."""
    import dataclasses

    import torch

    from resnetc_tpu_torch import train
    from resnetc_tpu_torch.data.loader import synthetic_batches
    from resnetc_tpu_torch.models import resnet

    tag = "[train resnet152 remat]"
    cfg = resnet.get_config("resnet152")
    ts = train.init_train_state(cfg, torch.Generator().manual_seed(0), device=dev)
    x, y = next(iter(synthetic_batches(batch_size=32, steps=1, seed=1, device=dev)))
    out = {}
    for remat in (True, False):
        tcfg = dataclasses.replace(train.TrainConfig(), remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ts, m = train.train_step(cfg, tcfg, ts, x, y, 0.01)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(2):
            ts, m = train.train_step(cfg, tcfg, ts, x, y, 0.01)
        end.record()
        torch.cuda.synchronize()
        label = "remat" if remat else "no_remat"
        out[label] = {"ms_per_step": start.elapsed_time(end) / 2,
                      "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "loss": float(m["loss"])}
        if not out[label]["loss"] == out[label]["loss"]:
            raise AssertionError(f"{tag} {label}: the loss is NaN")
    log(f"{tag} b32 BF16: remat {out['remat']['ms_per_step']:.3f} ms per step, peak "
        f"{out['remat']['max_memory_allocated_gib']:.2f} GiB; without remat "
        f"{out['no_remat']['ms_per_step']:.3f} ms, {out['no_remat']['max_memory_allocated_gib']:.2f} GiB")
    if out["remat"]["max_memory_allocated_gib"] >= out["no_remat"]["max_memory_allocated_gib"]:
        raise AssertionError(f"{tag} remat did not lower the peak memory")
    return out


def phase_trained_served(tr: dict, cases: list, batch: int, dev) -> dict:
    """The ResNet-50 state after its steps, merged: its running stats are no
    longer the identity.  ``forward(train=False)`` equals
    ``forward_folded`` under FP32 within 1e-3 of max |logit|; an int8_chain
    engine on the tree passes the JAX gate against the fp32 folded forward
    (rel-MAE < 0.05, argmax agreement >= 0.9), and its forward, counted,
    launches the served route's kernels at ResNet-50's block counts."""
    import torch

    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.serve import InferenceEngine
    from resnetc_tpu_torch.tensor import FP32, flatten_tree
    from resnetc_tpu_torch.verify import compare_logits

    tag = "[trained -> served]"
    cfg = resnet.get_config("resnet50")
    ts = tr["ts"]
    variables = resnet.merge_params_state(ts.params, ts.bn_state)
    flat = flatten_tree(variables)
    identity = [k for k, v in flat.items()
                if (k.endswith("running_mean") and not bool(v.any()))
                or (k.endswith("running_var") and bool((v == 1).all()))]
    if identity:
        raise AssertionError(f"{tag} running stats still the identity: {identity[:4]}")
    x = torch.randn((batch, 224, 224, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    with torch.no_grad():
        unfolded, _ = resnet.forward(cfg, variables, x, train=False, policy=FP32)
        ref32 = resnet.forward_folded(cfg, resnet.fold_inference_params(cfg, variables), x,
                                      policy=FP32)
    fold_rel = float((unfolded - ref32).abs().max() / ref32.abs().max())
    calib = torch.randn((8, 224, 224, 3), generator=torch.Generator().manual_seed(1))
    eng = InferenceEngine(cfg, variables, backend="int8_chain", calib_batch=calib, device=dev)
    logits, launches = forward_counted(eng, x, L1_PIXEL_PAIR=True)
    rel_mae = float((logits - ref32).abs().mean() / ref32.abs().mean())
    rep = compare_logits(logits, ref32)
    want = expected_launches(cases, pp=True, blocks=cfg.stage_blocks)
    log(f"{tag} ResNet-50 after {int(ts.step)} steps: forward(train=False) vs forward_folded "
        f"(FP32) max error / max |logit| = {fold_rel}; int8_chain vs fp32 folded: rel_mae="
        f"{rel_mae} argmax_agreement={rep.argmax_match_rate}; launches {json.dumps(launches)}")
    if fold_rel > 1e-3:
        raise AssertionError(f"{tag} the unfolded eval forward disagrees with the folded one")
    if not (rel_mae < 0.05 and rep.argmax_match_rate >= 0.9):
        raise AssertionError(f"{tag} int8_chain on the trained tree is outside the JAX gate")
    if launches != want:
        raise AssertionError(f"{tag} launched {launches}, expected {want}")
    return {"fold_rel": fold_rel, "rel_mae_vs_fp32": rel_mae,
            "argmax_vs_fp32": rep.argmax_match_rate, "launches": launches}


def phase_cli() -> dict:
    """The ``train`` command in process: ResNet-18, batch 32, 3 steps, a
    checkpoint and the reference-format export; then ``--resume`` for 2
    more steps, which must log steps 4 and 5; the exported weights read
    back with ``load_reference_format`` equal the checkpoint's tree bit for
    bit."""
    import io
    import tempfile
    from pathlib import Path

    import torch

    from resnetc_tpu_torch import checkpoint, train
    from resnetc_tpu_torch.__main__ import main as cli_main
    from resnetc_tpu_torch.models import resnet

    tag = "[cli]"
    base = ["train", "--model", "resnet18", "--batch-size", "32", "--log-every", "1"]
    with tempfile.TemporaryDirectory() as tmp:
        d1, d2 = str(Path(tmp) / "ckpt"), str(Path(tmp) / "weights")
        outs = []
        for argv in (base + ["--steps", "3", "--checkpoint-dir", d1, "--export-weights-dir", d2],
                     base + ["--steps", "2", "--resume", d1]):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli_main(argv)
            outs.append(buf.getvalue())
            for line in buf.getvalue().splitlines():
                log(f"{tag} {line}")
            log(f"{tag} rc {rc} in {time.perf_counter() - t0:.1f} s")
            if rc != 0:
                raise AssertionError(f"{tag} {argv} returned {rc}")
        steps = [json.loads(ln)["step"] for ln in outs[1].splitlines() if ln.startswith("{")]
        if steps != [4, 5]:
            raise AssertionError(f"{tag} the resumed run logged steps {steps}, expected [4, 5]")
        cfg = resnet.get_config("resnet18")
        like = train.init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        saved = checkpoint.load_train_state(d1, like)
        exported = checkpoint.load_reference_format(cfg, d2)
        if not _trees_equal(exported, resnet.merge_params_state(saved.params, saved.bn_state)):
            raise AssertionError(f"{tag} the exported weights differ from the checkpoint's")
    log(f"{tag} resumed run logged steps {steps}; the export equals the checkpoint bit for bit")
    return {"resumed_steps": steps}


def phase_verify_resnet152() -> dict:
    """``logit_report`` and ``stage_parity_report`` of ResNet-152 against its
    twin at 224 px, batch 2, FP32, on the card; the JAX CLI's pass rule
    (argmax match, logit MAE <= 1e-3)."""
    import numpy as np

    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.tensor import FP32
    from resnetc_tpu_torch.verify.harness import (
        LOGIT_MAE_GATE, logit_report, stage_parity_report,
    )
    from resnetc_tpu_torch.verify.twin import build_twin

    tag = "[verify resnet152]"
    cfg = resnet.get_config("resnet152")
    t0 = time.perf_counter()
    twin = build_twin(cfg, seed=0)
    x = np.random.default_rng(0).standard_normal((2, 3, 224, 224)).astype(np.float32)
    rep = logit_report(cfg, twin, x, policy=FP32)
    stages = stage_parity_report(cfg, twin, x, policy=FP32)
    ok = rep.argmax_match and rep.mae <= LOGIT_MAE_GATE
    log(f"{tag} logit_mae={rep.mae} max_abs_err={rep.max_abs_err} "
        f"argmax_match_rate={rep.argmax_match_rate} pass={ok} "
        f"({time.perf_counter() - t0:.1f} s)")
    log(f"{tag} stage max error: " + ", ".join(f"{k} {v['max']:.3g}" for k, v in stages.items()))
    if not ok:
        raise AssertionError(f"{tag} the port's forward fails the parity gate")
    return {"logit_mae": rep.mae, "max_abs_err": rep.max_abs_err,
            "argmax_match_rate": rep.argmax_match_rate, "stages": stages}


#: Data parallelism (``[dp ...]``): the served model's global batch (16 a
#: rank on two ranks), ResNet-50's global training batch, the FP32 step's
#: rate (``tests/test_parallel.py``'s DP test), and the FP32 step's bands.
DP_SERVE_BATCH, DP_TRAIN_BATCH, DP_LR = 32, 128, 0.1
#: ``tests/test_parallel.py:151-172``'s tolerances: loss, grad_norm, leaves.
DP_LOSS_RTOL, DP_NORM_RTOL, DP_RTOL, DP_ATOL = 1e-5, 1e-4, 1e-4, 5e-6
#: The FP32 DP steps: (model, classes, image size, global batch).  The
#: first is ``tests/test_parallel.py``'s DP test, held to the one-process
#: step at its tolerances.  At the second, ResNet-50 b128 224 px, the
#: one-process FP32 step itself stands hundreds of band-widths of those
#: tolerances from the float64 step (on an H100 about 220 at the farthest
#: leaf, against that leaf's largest value; the phase prints it), and the
#: DP step as far: BN's raw fp32 moments over up to 1.6 M values a
#: channel, and the stem's scale-invariant gradient, a difference of large
#: sums.  So it is held to the float64 twin's step: every leaf no further
#: from it than twice the one-process step's distance (or one band-width),
#: the gradient norm likewise.
DP_FP32 = (("resnet18", 10, 32, 16), ("resnet50", 1000, 224, DP_TRAIN_BATCH))


def _served_resnet152(dev, mesh=None):
    """``phase_end_to_end``'s ResNet-152 ``int8_chain`` engine and batch,
    from the same seeds (weights 0, calibration 1, images 2)."""
    import torch

    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.serve import InferenceEngine

    cfg = resnet.get_config("resnet152")
    variables = resnet.init(cfg, torch.Generator().manual_seed(0))
    calib = torch.randn((8, 224, 224, 3), generator=torch.Generator().manual_seed(1))
    eng = InferenceEngine(cfg, variables, backend="int8_chain", calib_batch=calib, device=dev,
                          mesh=mesh)
    x = torch.randn((DP_SERVE_BATCH, 224, 224, 3), generator=torch.Generator().manual_seed(2))
    return eng, x.to(dev)


def _flat_state(ts) -> dict:
    """A train state's parameters and running stats by torchvision key."""
    from resnetc_tpu_torch.tensor import flatten_tree

    return {k: v for name in ("params", "bn_state")
            for k, v in flatten_tree(getattr(ts, name)).items()}


def _leaf_ratio(got: dict, want: dict, rtol: float, atol: float) -> tuple[float, str]:
    """The largest |got - want| / (atol + rtol |want|) over every leaf, and
    its leaf."""
    worst, key = 0.0, ""
    for k, w in want.items():
        w = w.double().cpu()
        r = float(((got[k].double().cpu() - w).abs() / (atol + rtol * w.abs())).max())
        if r > worst:
            worst, key = r, k
    return worst, key


def _init_resnet50(dev, seed: int = 0):
    import torch

    from resnetc_tpu_torch import train
    from resnetc_tpu_torch.models import resnet

    return train.init_train_state(resnet.get_config("resnet50"),
                                  torch.Generator().manual_seed(seed), device=dev)


def _fp32_case(case, dev, seed: int = 0):
    """(config, train config, state from ``seed``, global batch) of a
    ``DP_FP32`` case."""
    import torch

    from resnetc_tpu_torch import train
    from resnetc_tpu_torch.data.loader import synthetic_batches
    from resnetc_tpu_torch.models import resnet

    model, classes, size, batch = case
    cfg = resnet.get_config(model, num_classes=classes)
    ts = train.init_train_state(cfg, torch.Generator().manual_seed(seed), device=dev)
    x, y = next(iter(synthetic_batches(batch_size=batch, image_size=size, steps=1,
                                       num_classes=classes, seed=0, device=dev)))
    return cfg, train.TrainConfig(policy_name="fp32", lr=DP_LR), ts, x, y


def _exact_step(cfg, ts, x, y, *, lr: float = DP_LR,
                momentum: bool = False) -> tuple[dict, float, float]:
    """The float64 twin's SGD step (``torch.optim.SGD`` at ``lr``, the
    port's momentum and weight decay) from ``ts`` on (x, y): its leaves,
    loss and gradient norm.  ``momentum``: the step starts from ``ts``'s
    momentum buffers (a later step), else from none (a first one)."""
    import torch
    import torch.nn.functional as F

    from resnetc_tpu_torch import checkpoint
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.tensor import flatten_tree
    from resnetc_tpu_torch.verify.twin import build_twin

    twin = build_twin(cfg).double().train().to(x.device)
    sd = checkpoint.torch_state_dict_from_variables(resnet.merge_params_state(ts.params,
                                                                             ts.bn_state))
    twin.load_state_dict({k: v.double() for k, v in sd.items()}, strict=False)
    opt = torch.optim.SGD(twin.parameters(), lr=lr, momentum=0.9, weight_decay=1e-4)
    if momentum:
        bufs = checkpoint.torch_state_dict_from_variables(ts.momentum)
        for name, p in twin.named_parameters():
            opt.state[p]["momentum_buffer"] = bufs[name].double().to(x.device)
    loss = F.cross_entropy(twin(x.double().permute(0, 3, 1, 2)), y.long())
    loss.backward()
    norm = float(torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in twin.parameters()])))
    opt.step()
    flat = flatten_tree(checkpoint.variables_from_torch_state_dict(twin.state_dict()))
    return {k: v.detach().double().cpu() for k, v in flat.items()}, float(loss.detach()), norm


def phase_dp_nccl1(e2e: dict, cases: list, dev) -> dict:
    """An NCCL process group of world size 1 in this process: the DP step
    (``sharded_train_step``) on ResNet-50, FP32, 224 px, batch 32, against
    ``train_step`` on copies of the same state and batch (the ``[train
    parity]`` band: loss 5e-4, leaves rtol 1e-3, atol 1e-5; bit equality
    reported), and ``fused_forward_int8_chain_sharded`` on ResNet-152's
    served route against the engine's forward on the same batch (equal,
    counted).  The group is torn down after."""
    import torch

    from resnetc_tpu_torch import train
    from resnetc_tpu_torch.data.loader import synthetic_batches
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.ops.cuda import fused
    from resnetc_tpu_torch.parallel import create_mesh, distributed

    tag = "[dp nccl1]"
    t0 = time.perf_counter()
    distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0)
    try:
        backend = torch.distributed.get_backend()
        mesh = create_mesh()
        log(f"{tag} process group: backend {backend}, world 1, mesh {mesh} "
            f"({time.perf_counter() - t0:.1f} s)")
        if backend != "nccl":
            raise AssertionError(f"{tag} one rank on one card chose {backend}, not nccl")
        eng, x = e2e["engine"], e2e["x"]
        engine_logits = eng.logits(x)
        got, launches = counted(lambda: fused.fused_forward_int8_chain_sharded(
            eng.model_cfg, eng.folded, eng.chain_scales, x, mesh, policy=eng.policy))
        expect = expected_launches(cases, pp=fused.L1_PIXEL_PAIR)
        equal = torch.equal(got, engine_logits)
        log(f"{tag} ResNet-152 int8_chain b{x.shape[0]} through the sharded forward: logits "
            f"equal to the engine's {equal}; launches {json.dumps(launches)}")
        if not equal or launches != expect:
            raise AssertionError(f"{tag} the sharded forward differs from the engine's "
                                 f"or launched {launches}, expected {expect}")

        cfg = resnet.get_config("resnet50")
        tcfg = train.TrainConfig(policy_name="fp32", lr=DP_LR)
        xb, yb = next(iter(synthetic_batches(batch_size=32, steps=1, seed=0, device=dev)))
        step, shard_state, _ = train.sharded_train_step(cfg, tcfg, mesh)
        dp, mdp = step(shard_state(_init_resnet50(dev)), xb, yb, DP_LR)
        one, mone = train.train_step(cfg, tcfg, _init_resnet50(dev), xb, yb, DP_LR)
        got, want = _flat_state(dp), _flat_state(one)
        bits = all(torch.equal(got[k], want[k]) for k in want) and all(
            torch.equal(mdp[k], mone[k]) for k in mone)
        worst, key = _leaf_ratio(got, want, 1e-3, 1e-5)
        dloss = abs(float(mdp["loss"]) - float(mone["loss"]))
        log(f"{tag} ResNet-50 FP32 b32 DP step vs train_step: loss {float(mdp['loss'])} / "
            f"{float(mone['loss'])}, grad_norm {float(mdp['grad_norm'])} / "
            f"{float(mone['grad_norm'])}; worst leaf {worst} band-widths ({key}); "
            f"bit for bit: {bits}")
        if dloss > 5e-4 or worst > 1.0:
            raise AssertionError(f"{tag} the world-1 DP step differs from train_step")
    finally:
        distributed.shutdown()
    torch.cuda.empty_cache()
    return {"backend": backend, "launches": launches, "step_bit_equal": bits,
            "step_worst_band": worst, "seconds": time.perf_counter() - t0,
            "engine_logits": engine_logits.float().cpu().numpy()}


def dp_rank(dev) -> dict:
    """One of the two ranks of ``[dp serve resnet152]`` and ``[dp train
    resnet50]``, sharing the card over gloo (run by
    ``parallel.distributed.spawn``): the served ResNet-152 engine with the
    mesh on the global batch (counted, timed), then one FP32 DP step of
    each ``DP_FP32`` case from rank 0's state (shared by ``shard_state``
    though this rank starts from its own seed), then three BF16 steps of
    ResNet-50 at the global batch 128, timed, then the gradient all-reduce
    alone.  Returns small numbers, and rank 0 also the FP32 steps' leaves."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from resnetc_tpu_torch import train
    from resnetc_tpu_torch.data.loader import synthetic_batches
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.parallel import create_mesh
    from resnetc_tpu_torch.tensor import flatten_tree

    rank = dist.get_rank()
    mesh = create_mesh()
    out: dict = {"rank": rank, "device": str(dev), "backend": dist.get_backend()}

    eng, x = _served_resnet152(dev, mesh)
    logits, launches = counted(lambda: eng.logits(x))
    ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.logits(x)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out["serve"] = {"logits": logits.float().cpu().numpy(), "launches": launches,
                    "ms_per_global_batch": sorted(ms)[2]}
    del eng, x, logits
    torch.cuda.empty_cache()

    out["fp32"] = []
    for case in DP_FP32:
        cfg, tcfg, ts, xb, yb = _fp32_case(case, dev, seed=rank)
        step, shard_state, _ = train.sharded_train_step(cfg, tcfg, mesh)
        ts, m = step(shard_state(ts), xb, yb, DP_LR)
        flat = {k: v.cpu().numpy() for k, v in _flat_state(ts).items()}
        digest = hashlib.sha256(b"".join(flat[k].tobytes() for k in sorted(flat))).hexdigest()
        out["fp32"].append({"metrics": {k: float(v) for k, v in m.items()}, "digest": digest,
                            "leaves": flat if rank == 0 else None})
        del ts, m, flat
        torch.cuda.empty_cache()

    cfg = resnet.get_config("resnet50")
    tcfg = train.TrainConfig(lr=TRAIN_LR)
    sched = train.cosine_schedule(tcfg.lr, 3, warmup_steps=1)
    xb, yb = next(iter(synthetic_batches(batch_size=DP_TRAIN_BATCH, steps=1, seed=0,
                                         device=dev)))
    step, shard_state, _ = train.sharded_train_step(cfg, tcfg, mesh)
    ts = shard_state(_init_resnet50(dev))
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, m = step(ts, xb, yb, sched(ts.step))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    n = sum(v.numel() for v in flatten_tree(ts.params).values())
    buf = torch.zeros(n + 2, device=dev)
    dist.all_reduce(buf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        dist.all_reduce(buf)
    torch.cuda.synchronize()
    out["bf16"] = {"ms_per_step": ms, "losses": losses, "peak_gib": peak / 2**30,
                   "all_reduce_ms": (time.perf_counter() - t0) / 3 * 1e3,
                   "all_reduce_mb": buf.numel() * 4 / 1e6,
                   "finite": bool(np.isfinite(losses).all())}
    return out


def phase_dp_two_ranks(engine_logits, want_launches: dict, dev) -> dict:
    """``[dp serve resnet152]`` and ``[dp train resnet50]``: two ranks on the
    one card over gloo (``dp_rank``; NCCL refuses two ranks on one device).
    Serving: the gathered logits of the global batch of 32 against the
    one-process engine's (``[dp nccl1]``) by JAX's DP serving contract
    (``tests/test_parallel.py:57-65``: rel-MAE < 0.02, argmax agreement >=
    0.85; the stem is a stock convolution at another batch, so exactness is
    not the contract: the bit-equal share is reported), equal on both
    ranks, and each rank's launches those of one served forward.  Training:
    one FP32 DP step of each ``DP_FP32`` case against ``train_step`` on the
    same global batch in this process, the ranks' leaves equal:
    ``tests/test_parallel.py``'s configuration at its tolerances
    (:132-172), ResNet-50 b128 224 px against the float64 twin's step as
    well; then the BF16 steps' times, the all-reduce's time (gloo stages
    CUDA tensors through the host: not an NCCL number) and each rank's
    peak memory."""
    import numpy as np
    import torch

    from resnetc_tpu_torch import train
    from resnetc_tpu_torch.parallel import distributed

    refs = []
    for case in DP_FP32:
        cfg, tcfg, ts, xb, yb = _fp32_case(case, dev)
        exact = _exact_step(cfg, ts, xb, yb) if case[0] == "resnet50" else None
        one, mone = train.train_step(cfg, tcfg, ts, xb, yb, DP_LR)
        refs.append(({k: v.cpu() for k, v in _flat_state(one).items()},
                     {k: float(v) for k, v in mone.items()}, exact))
        del ts, one, mone, xb, yb
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    res = distributed.spawn(dp_rank, 2, timeout=900)
    secs = time.perf_counter() - t0

    tag = "[dp serve resnet152]"
    logits = res[0]["serve"]["logits"]
    want = np.asarray(engine_logits, np.float32)
    rel_mae = float(np.mean(np.abs(logits - want)) / np.mean(np.abs(want)))
    agreement = float((logits.argmax(-1) == want.argmax(-1)).mean())
    bit_share = float((logits == want).mean())
    log(f"{tag} two ranks over {res[0]['backend']} on {res[0]['device']} / {res[1]['device']} "
        f"({secs:.1f} s with the training below): global b{DP_SERVE_BATCH}, 16 a rank; "
        f"vs the one-process engine rel_mae={rel_mae} argmax_agreement={agreement} "
        f"bit-equal share {bit_share}; ms per DP forward (p50 of 5, host clock) "
        f"{[r['serve']['ms_per_global_batch'] for r in res]}")
    for r in res:
        log(f"{tag} rank {r['rank']} launches {json.dumps(r['serve']['launches'])}")
        if r["serve"]["launches"] != want_launches:
            raise AssertionError(f"{tag} rank {r['rank']} launched {r['serve']['launches']}, "
                                 f"expected {want_launches}")
    if not np.array_equal(res[1]["serve"]["logits"], logits):
        raise AssertionError(f"{tag} the ranks gathered different logits")
    if not (rel_mae < 0.02 and agreement >= 0.85) or logits.shape != (DP_SERVE_BATCH, 1000):
        raise AssertionError(f"{tag} DP serving outside JAX's contract")

    tag = "[dp train resnet50]"
    fp32 = []
    for i, (case, (ref, mref, exact)) in enumerate(zip(DP_FP32, refs)):
        fp = [r["fp32"][i] for r in res]
        got = {k: torch.from_numpy(v) for k, v in fp[0]["leaves"].items()}
        m = fp[0]["metrics"]
        loss_rel = abs(m["loss"] / mref["loss"] - 1)
        norm_rel = abs(m["grad_norm"] / mref["grad_norm"] - 1)
        worst, key = _leaf_ratio(got, ref, DP_RTOL, DP_ATOL)
        name = f"{case[0]} FP32 b{case[3]} ({case[3] // 2} a rank) at {case[2]} px, lr {DP_LR}"
        log(f"{tag} {name}: loss {m['loss']} vs one process {mref['loss']} (rel {loss_rel}), "
            f"grad_norm {m['grad_norm']} vs {mref['grad_norm']} (rel {norm_rel}), worst leaf "
            f"{worst} band-widths of rtol {DP_RTOL}, atol {DP_ATOL} ({key}); ranks' leaves "
            f"equal: {fp[0]['digest'] == fp[1]['digest']}")
        if fp[0]["digest"] != fp[1]["digest"] or fp[0]["metrics"] != fp[1]["metrics"]:
            raise AssertionError(f"{tag} {name}: the ranks' states differ after the step")
        row = {"case": list(case), "loss_rel": loss_rel, "grad_norm_rel": norm_rel,
               "worst_band_vs_one_process": worst, "worst_leaf": key}
        if exact is None:
            ok = loss_rel <= DP_LOSS_RTOL and norm_rel <= DP_NORM_RTOL and worst <= 1.0
        else:
            leaves, exact_loss, exact_norm = exact
            dp_far, one_far, ratio, rkey = 0.0, 0.0, 0.0, ""
            for k in ref:
                e = leaves[k]
                band = float((DP_ATOL + DP_RTOL * e.abs()).max())
                d = float((got[k].double() - e).abs().max())
                o = float((ref[k].double() - e).abs().max())
                dp_far, one_far = max(dp_far, d / band), max(one_far, o / band)
                if d / max(band, 2 * o) > ratio:
                    ratio, rkey = d / max(band, 2 * o), k
            norm_ok = abs(m["grad_norm"] - exact_norm) <= max(
                DP_NORM_RTOL * exact_norm, 2 * abs(mref["grad_norm"] - exact_norm))
            log(f"{tag} {name} against the float64 twin's step: loss {exact_loss}, grad_norm "
                f"{exact_norm} (DP {m['grad_norm']}, one process {mref['grad_norm']}); "
                f"farthest leaf, in band-widths: DP {dp_far}, one process {one_far}; DP's "
                f"distance over twice the one process's, worst leaf {ratio} ({rkey})")
            ok = loss_rel <= DP_LOSS_RTOL and norm_ok and ratio <= 1.0
            row.update(exact_loss=exact_loss, exact_grad_norm=exact_norm, dp_vs_exact=dp_far,
                       one_vs_exact=one_far, dp_over_twice_one=ratio)
        if not ok:
            raise AssertionError(f"{tag} {name}: the DP step differs from the one-process step")
        fp32.append(row)
    bf = [r["bf16"] for r in res]
    for r, b in zip(res, bf):
        steady = sum(b["ms_per_step"][1:]) / 2
        log(f"{tag} rank {r['rank']} BF16 ms per step {[round(v, 3) for v in b['ms_per_step']]} "
            f"(steps 2-3: {steady:.3f} ms, {DP_TRAIN_BATCH / (steady / 1e3):.1f} img/s global); "
            f"losses {b['losses']}; peak memory {b['peak_gib']:.2f} GiB; gradient all-reduce "
            f"alone {b['all_reduce_ms']:.2f} ms for {b['all_reduce_mb']:.1f} MB (gloo, staged "
            "through the host: not an NCCL number)")
        if not b["finite"] or b["losses"] != bf[0]["losses"]:
            raise AssertionError(f"{tag} BF16 losses not finite or not equal on the ranks")
    return {"seconds": secs, "launches": [r["serve"]["launches"] for r in res],
            "serve": {"rel_mae": rel_mae, "argmax_agreement": agreement, "bit_share": bit_share,
                      "ms_per_global_batch": [r["serve"]["ms_per_global_batch"] for r in res]},
            "fp32": fp32, "bf16": bf}


#: ``[dp serve backends]``: every backend but int8_chain served over two
#: ranks, ResNet-50 at 224 px, global batch 32, FP32 as the CPU tests serve
#: them (tests/test_torch_parallel.py).
DP_BACKENDS = ("fp", "pallas", "pallas_block", "int8", "int8_static")


def _dp_backend_runs(dev, mesh=None) -> tuple:
    """(forwards, images, scales digest): per backend of ``DP_BACKENDS`` a
    function of the images giving the logits, ResNet-50 from seed 0 under
    FP32, in one process (``mesh`` None) or over ``mesh``'s data axis (the
    engine's ``mesh=``; int8_static through ``fused_forward_sharded``,
    calibrated on the served batch itself as in ``phase_backends``, the
    digest of its scales returned); the images from seed 3."""
    import hashlib

    import torch

    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.ops.cuda import fused, quant
    from resnetc_tpu_torch.serve import InferenceEngine
    from resnetc_tpu_torch.tensor import FP32, flatten_tree, tree_map

    cfg = resnet.get_config("resnet50")
    variables = resnet.init(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((DP_SERVE_BATCH, 224, 224, 3),
                    generator=torch.Generator().manual_seed(3)).to(dev)
    runs = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the pallas backends' notice
        for b in DP_BACKENDS[:-1]:
            runs[b] = InferenceEngine(cfg, variables, backend=b, policy=FP32, device=dev,
                                      mesh=mesh).logits
    with torch.inference_mode():
        folded = resnet.fold_inference_params(cfg, tree_map(lambda a: a.to(dev), variables))
        scales = fused.calibrate_activation_scales(cfg, folded, x, policy=FP32)
        tree = quant.pack_kmajor(quant.quantize_folded(folded))
    digest = hashlib.sha256(b"".join(
        v.cpu().numpy().tobytes() for _, v in sorted(flatten_tree(scales).items()))).hexdigest()

    def static(xx):
        with torch.inference_mode():
            if mesh is None:
                return fused.fused_forward_int8_static(cfg, tree, scales, xx, policy=FP32)
            return fused.fused_forward_sharded(cfg, tree, xx, mesh, backend="int8_static",
                                               scales=scales, policy=FP32)

    runs["int8_static"] = static
    return runs, x, digest


def dp_backends_rank(dev) -> dict:
    """One of the two ranks of ``[dp serve backends]``: each backend's
    gathered logits of the global batch (its launches counted on this
    rank), then the median of three timed forwards (host clock, each ending
    in a synchronize)."""
    import torch
    import torch.distributed as dist

    from resnetc_tpu_torch.parallel import create_mesh

    runs, x, digest = _dp_backend_runs(dev, create_mesh())
    out = {"rank": dist.get_rank(), "device": str(dev), "backend": dist.get_backend(),
           "scales_digest": digest}
    for b, run in runs.items():
        logits, launches = counted(lambda: run(x))
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(x)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[b] = {"logits": logits.float().cpu().numpy(), "launches": launches,
                  "ms_per_global_batch": sorted(ms)[1]}
    return out


def phase_dp_serve_backends(card: str, dev) -> dict:
    """``[dp serve backends]``: ``fp``, ``pallas``, ``pallas_block``,
    ``int8`` and ``int8_static`` on ResNet-50, 224 px, FP32, the global
    batch of 32 over two ranks on the one card over gloo
    (``dp_backends_rank``), against the same forwards in this process with
    the CPU tests' gates (tests/test_torch_parallel.py): the float backends
    within rtol 1e-4, atol 1e-4 (tests/test_parallel.py:175-193), the int8
    ones by JAX's DP serving contract (rel-MAE < 0.02, argmax agreement >=
    0.85).  Both ranks gather the same logits, launch one forward's kernels
    of a ResNet-50 forward on its slice (``backend_launches``; int8_static
    the int8 backend's), and calibrate int8_static's scales alike; each
    backend's ms per global batch is printed with the card."""
    import numpy as np
    import torch

    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.parallel import distributed

    tag = "[dp serve backends]"
    cfg = resnet.get_config("resnet50")
    runs, x, digest = _dp_backend_runs(dev)
    want = {}
    for b, run in runs.items():
        want[b] = run(x).float().cpu().numpy()
    del runs, x
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = distributed.spawn(dp_backends_rank, 2, timeout=900)
    secs = time.perf_counter() - t0
    out = {"seconds": secs, "launches": [], "backends": {}}
    if not res[0]["scales_digest"] == res[1]["scales_digest"] == digest:
        raise AssertionError(f"{tag} the ranks calibrated other int8_static scales")
    for b in DP_BACKENDS:
        got = res[0][b]["logits"]
        rel_mae = float(np.mean(np.abs(got - want[b])) / np.mean(np.abs(want[b])))
        rel_max = float(np.max(np.abs(got - want[b])) / np.max(np.abs(want[b])))
        agreement = float((got.argmax(-1) == want[b].argmax(-1)).mean())
        ms = [r[b]["ms_per_global_batch"] for r in res]
        log(f"{tag} {b} FP32 b{DP_SERVE_BATCH} over two ranks ({res[0]['backend']}): vs one "
            f"process rel_mae={rel_mae} rel_max={rel_max} argmax_agreement={agreement}; ms per "
            f"global batch (median of 3, host clock) {ms} on {card}")
        want_launches = backend_launches(cfg, "int8" if b == "int8_static" else b) \
            if b != "fp" else {}
        for r in res:
            if r[b]["launches"] != want_launches:
                raise AssertionError(f"{tag} {b} rank {r['rank']} launched {r[b]['launches']}, "
                                     f"expected {want_launches}")
        if not np.array_equal(res[1][b]["logits"], got):
            raise AssertionError(f"{tag} {b}: the ranks gathered different logits")
        if "int8" in b:
            ok = rel_mae < 0.02 and agreement >= 0.85
        else:
            ok = bool(np.allclose(got, want[b], rtol=1e-4, atol=1e-4))
        if not ok or got.shape != (DP_SERVE_BATCH, 1000):
            raise AssertionError(f"{tag} {b}: DP serving outside the gate")
        out["launches"].append(res[0][b]["launches"])
        out["backends"][b] = {"rel_mae": rel_mae, "rel_max": rel_max, "argmax": agreement,
                              "ms_per_global_batch": ms}
    log(f"{tag} {secs:.1f} s for the two ranks")
    return out


def phase_cli_dp() -> dict:
    """``[cli dp]``: ``python -m resnetc_tpu_torch train --model resnet18
    --steps 3 --log-every 1`` with ``--data-dim 2`` (two ranks spawned by
    the command) and as two ``--multihost`` processes meeting at a free
    localhost port, both runs at once, each rc 0; both ranks of each run
    log the same losses (rank 0 to stdout, rank 1 to stderr)."""
    import os

    from resnetc_tpu_torch.parallel.distributed import free_port

    tag = "[cli dp]"
    root = os.path.dirname(os.path.abspath(__file__))
    base = [sys.executable, "-m", "resnetc_tpu_torch", "train", "--model", "resnet18",
            "--steps", "3", "--log-every", "1"]
    port = free_port()
    cmds = {"data-dim": [base + ["--data-dim", "2"]],
            "multihost": [base + ["--multihost", "--coordinator", f"127.0.0.1:{port}",
                                  "--num-processes", "2", "--process-id", str(i)]
                          for i in range(2)]}
    t0 = time.perf_counter()
    procs = {name: [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True, cwd=root) for c in cs]
             for name, cs in cmds.items()}
    try:
        outs = {name: [p.communicate(timeout=600) for p in ps] for name, ps in procs.items()}
    finally:
        for p in (p for ps in procs.values() for p in ps):
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    res = {}
    for name, ps in procs.items():
        for p, (so, se) in zip(ps, outs[name]):
            if p.returncode != 0:
                raise AssertionError(f"{tag} {name} exited {p.returncode}:\n{se[-3000:]}")
        rank0, rank1 = outs[name][0][0], outs[name][-1][1]
        recs = [[json.loads(ln) for ln in text.splitlines() if ln.startswith('{"tag": "train"')]
                for text in (rank0, rank1)]
        losses = [[r["loss"] for r in rr] for rr in recs]
        backends = sorted({ln.split(", ")[1].split(" ")[0] for so, se in outs[name]
                           for ln in se.splitlines() if ln.startswith("[parallel]")})
        log(f"{tag} {name}: rc 0, backend {backends}, losses rank 0 {losses[0]}, rank 1 "
            f"{losses[1]}; images/s {[round(r['images_per_sec'], 1) for r in recs[0]]}")
        if len(losses[0]) != 3 or losses[0] != losses[1]:
            raise AssertionError(f"{tag} {name}: the ranks logged different losses")
        res[name] = {"losses": losses[0], "backends": backends}
    log(f"{tag} both runs in {secs:.1f} s")
    return {**res, "seconds": secs}


# ---------------------------------------------------------------------------
# Channel tensor parallelism: [tp serve], [tp train resnet50], [cli tp]
# ---------------------------------------------------------------------------

#: ``[tp ...]``: a 1 x 2 (data, model) mesh of two ranks on the one card over
#: gloo; ResNet-50 at full width, 224 px, FP32, batch 8; the backends that
#: take a model axis (fp and pallas split channels, pallas_block runs whole
#: on both model ranks); the train steps' rate.
TP_BATCH, TP_BACKENDS, TP_LR = 8, ("fp", "pallas", "pallas_block"), 0.1
#: The TP logits against one process (tests/test_parallel.py:175-193's
#: float gate); ``[cli tp]``'s TP train run against the one-process run:
#: per step the loss's rtol, and each param and BN stat of the checkpoints
#: within this relative L2 distance.  Under the command's warm-up the first
#: step's rate is 0, so both checkpoints hold one update from one state;
#: its fp32 noise through train-mode BN moves single elements (a BN bias's
#: 1.4% of its leaf's largest on an H100), which ``[tp train resnet50]``
#: holds to the float64 twin; here a misplaced or missing shard would
#: stand O(1) off.
TP_SERVE_RTOL, TP_SERVE_ATOL = 1e-4, 1e-4
TP_LOSS_RTOL, TP_LEAF_TOL = (1e-5, 1e-4), 1e-2
#: ``[tp train resnet50]``'s gradient norm against the float64 twin's (and
#: ``[cli tp]``'s momentum norm against one process's): the second step's
#: fp32 norm moves ~3e-4 between runs on the card (cuDNN's backward
#: convolutions are not deterministic), one process's and TP's alike; an
#: M-fold or a missing gradient moves it by far more.
TP_NORM_RTOL = 1e-3


def _tp_model(dev):
    """(ResNet-50 config, variables from seed 0, images from seed 3 on the
    card) of ``[tp serve]``."""
    import torch

    from resnetc_tpu_torch.models import resnet

    cfg = resnet.get_config("resnet50")
    variables = resnet.init(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((TP_BATCH, 224, 224, 3), generator=torch.Generator().manual_seed(3))
    return cfg, variables, x.to(dev)


def _tp_engines(dev, mesh=None):
    """Each of ``TP_BACKENDS``' engines (FP32) in turn, with the images:
    yields (backend, engine, x)."""
    from resnetc_tpu_torch.serve import InferenceEngine
    from resnetc_tpu_torch.tensor import FP32

    cfg, variables, x = _tp_model(dev)
    for b in TP_BACKENDS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the pallas backends' notice
            eng = InferenceEngine(cfg, variables, backend=b, policy=FP32, device=dev, mesh=mesh)
        yield b, eng, x


def _tp_train_case(dev):
    """(config, FP32 train config, state from seed 0, batch) of ``[tp train
    resnet50]``."""
    from resnetc_tpu_torch import train
    from resnetc_tpu_torch.data.loader import synthetic_batches

    cfg = _tp_model("cpu")[0]
    ts = _init_resnet50(dev)
    x, y = next(iter(synthetic_batches(batch_size=TP_BATCH, steps=1, seed=0, device=dev)))
    return cfg, train.TrainConfig(policy_name="fp32", lr=TP_LR), ts, x, y


def _timed_ms(fn, n: int = 3) -> list:
    """``fn()`` ``n`` times, each between two synchronizes on the host
    clock: the ms of each."""
    import torch

    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def tp_rank(dev, work: str) -> dict:
    """One of the two ranks of ``[tp serve]`` and ``[tp train resnet50]``
    (a 1 x 2 mesh, gloo on the one card): each backend's engine with the
    mesh, its forward counted and timed, the shape of the fc it holds; then
    two FP32 TP train steps from seed 0, the whole state gathered and saved
    after each (``work/step1``, ``work/step2``), three more steps timed,
    and one step with every channel collective timed (a synchronize before
    and after each: the collectives' share of a step)."""
    import torch
    import torch.distributed as dist

    from resnetc_tpu_torch import checkpoint, train
    from resnetc_tpu_torch.parallel import create_mesh, tp

    rank = dist.get_rank()
    mesh = create_mesh(1, 2)
    out: dict = {"rank": rank, "device": str(dev), "backend": dist.get_backend(), "serve": {}}
    for b, eng, x in _tp_engines(dev, mesh):
        logits, launches = counted(lambda: eng.logits(x))
        out["serve"][b] = {"logits": logits.float().cpu().numpy(), "launches": launches,
                           "fc": tuple(eng.folded["fc"]["weight"].shape),
                           "ms": sorted(_timed_ms(lambda: eng.logits(x)))[1]}
        del eng
        torch.cuda.empty_cache()

    cfg, tcfg, ts, x, y = _tp_train_case(dev)
    step, shard_state, _ = train.sharded_train_step(cfg, tcfg, mesh)
    ts = shard_state(ts)
    metrics = []
    for i in range(2):
        ts, m = step(ts, x, y, TP_LR)
        metrics.append({k: float(v) for k, v in m.items()})
        # The whole state after each step, as a one-process checkpoint.
        checkpoint.save_train_state(os.path.join(work, f"step{i + 1}"),
                                    train.gather_train_state(cfg, mesh, ts))
    step_ms = _timed_ms(lambda: step(ts, x, y, TP_LR))

    spent = {"gathers": 0, "ms": 0.0}
    originals = tp._gather_last, tp._reduce_scatter_last

    def timed(fn):
        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a)
            torch.cuda.synchronize()
            spent["gathers"] += 1
            spent["ms"] += (time.perf_counter() - t0) * 1e3
            return r
        return run

    tp._gather_last, tp._reduce_scatter_last = (timed(f) for f in originals)
    try:
        instrumented = _timed_ms(lambda: step(ts, x, y, TP_LR), n=1)[0]
    finally:
        tp._gather_last, tp._reduce_scatter_last = originals
    out["train"] = {"metrics": metrics, "ms_per_step": step_ms, "instrumented_ms": instrumented,
                    "collectives": spent["gathers"], "collectives_ms": spent["ms"],
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    return out


def phase_tp(card: str, dev) -> dict:
    """``[tp serve]`` and ``[tp train resnet50]``: two ranks of a 1 x 2
    (data, model) mesh on the one card over gloo (``tp_rank``), ResNet-50 at
    full width, 224 px, FP32, batch 8.  Serving: ``fp``, ``pallas`` and
    ``pallas_block`` against the same engines in this process, within
    ``TP_SERVE_RTOL`` / ``TP_SERVE_ATOL`` (each error printed against the
    gate); both ranks' logits equal; ``fp`` and ``pallas`` hold the fc's
    shard (500 of 1000 classes), ``pallas_block`` the whole fc; each rank's
    launches those of one forward of its backend (``backend_launches``:
    ``pallas`` runs rows 4, 13, 14 and 15 at shard widths, ``fp`` no
    kernel); ms per global batch beside one process's.  Training: each of
    two TP steps against ``train_step`` and the float64 twin's step from
    the same state (seed 0, then the TP run's own state after step 1, read
    from the checkpoint its ranks wrote): the loss within
    ``DP_LOSS_RTOL`` of one process, the gradient norm within
    ``TP_NORM_RTOL`` of the twin's, and the farthest param or BN stat from
    the twin's, in band-widths of rtol ``DP_RTOL``, atol ``DP_ATOL``, no
    further than twice the one-process step's (or one band-width).  Both
    steps stand up to ~200
    band-widths from the twin at their farthest leaf (fp32 noise through
    train-mode BN at batch 8), and which of the two lands closer on a
    given leaf is chance, so the bound is over the tree; a fault in the
    channel collectives (an M-fold or a missing gradient) stands orders
    of magnitude further.  A single FP32 trajectory at lr 0.1 is chaotic:
    two runs that differ in the last bits of one step's gradients part by
    percents a step later, so each step starts from one state.  ms per step (= per global batch) and the
    channel collectives' share of an instrumented step, with the card."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from resnetc_tpu_torch import checkpoint, train
    from resnetc_tpu_torch.parallel import distributed

    want, one_ms = {}, {}
    for b, eng, x in _tp_engines(dev):
        want[b] = eng.logits(x).float().cpu().numpy()
        one_ms[b] = sorted(_timed_ms(lambda: eng.logits(x)))[1]
        del eng
    torch.cuda.empty_cache()

    work = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        t0 = time.perf_counter()
        res = distributed.spawn(tp_rank, 2, work, timeout=900)
        secs = time.perf_counter() - t0
        out = {"seconds": secs, "launches": [], "serve": {}}
        tag = "[tp serve]"
        cfg = _tp_model("cpu")[0]
        for b in TP_BACKENDS:
            got = res[0]["serve"][b]["logits"]
            err = float(np.max(np.abs(got - want[b])
                               / (TP_SERVE_ATOL + TP_SERVE_RTOL * np.abs(want[b]))))
            rel_max = float(np.max(np.abs(got - want[b])) / np.max(np.abs(want[b])))
            launches = [r["serve"][b]["launches"] for r in res]
            want_launches = backend_launches(cfg, b) if b != "fp" else {}
            fc = [r["serve"][b]["fc"] for r in res]
            log(f"{tag} {b} FP32 b{TP_BATCH} on a 1 x 2 mesh ({res[0]['backend']}): vs one "
                f"process max |err| / (atol {TP_SERVE_ATOL} + rtol {TP_SERVE_RTOL} |want|) = "
                f"{err} (gate 1), max err / max |logit| {rel_max}; fc held {fc}; ms per global "
                f"batch (median of 3, host clock) {[r['serve'][b]['ms'] for r in res]}, one "
                f"process {one_ms[b]:.3f}, on {card}")
            for r, n in zip(res, launches):
                log(f"{tag} {b} rank {r['rank']} launches {json.dumps(n)}")
            if any(n != want_launches for n in launches):
                raise AssertionError(f"{tag} {b} launched {launches}, expected {want_launches}")
            if not np.array_equal(res[1]["serve"][b]["logits"], got):
                raise AssertionError(f"{tag} {b}: the ranks returned different logits")
            if fc != [(1000 if b == "pallas_block" else 500, 2048)] * 2:
                raise AssertionError(f"{tag} {b}: the engines hold fc {fc}")
            if not err <= 1.0 or got.shape != (TP_BATCH, 1000):
                raise AssertionError(f"{tag} {b}: TP serving outside the gate")
            out["launches"] += launches
            out["serve"][b] = {"err_over_gate": err, "rel_max": rel_max, "one_process_ms":
                               one_ms[b], "ms": [r["serve"][b]["ms"] for r in res]}

        tag = "[tp train resnet50]"
        tr = [r["train"] for r in res]
        if tr[0]["metrics"] != tr[1]["metrics"]:
            raise AssertionError(f"{tag} the ranks logged different metrics")
        cfg, tcfg, start, x, y = _tp_train_case(dev)
        like = _init_resnet50(dev)
        steps, ok = [], True
        for i, m in enumerate(tr[0]["metrics"]):
            got = _flat_state(checkpoint.load_train_state(os.path.join(work, f"step{i + 1}"),
                                                          like))
            leaves, exact_loss, exact_norm = _exact_step(cfg, start, x, y, lr=TP_LR,
                                                         momentum=i > 0)
            one, mone = train.train_step(cfg, tcfg, start, x, y, TP_LR)
            ref = _flat_state(one)
            tp_far, one_far, ratio, rkey = 0.0, 0.0, 0.0, ""
            for k, e in leaves.items():
                band = float((DP_ATOL + DP_RTOL * e.abs()).max())
                d = float((got[k].double().cpu() - e).abs().max())
                o = float((ref[k].double().cpu() - e).abs().max())
                tp_far, one_far = max(tp_far, d / band), max(one_far, o / band)
                if d / max(band, 2 * o) > ratio:
                    ratio, rkey = d / max(band, 2 * o), k
            loss_rel = abs(m["loss"] / float(mone["loss"]) - 1)
            norm_rel = abs(m["grad_norm"] / exact_norm - 1)
            log(f"{tag} step {i + 1} from {'seed 0' if i == 0 else 'the TP state after step 1'}: "
                f"loss {m['loss']} vs one process {float(mone['loss'])} (rel {loss_rel}, gate "
                f"{DP_LOSS_RTOL}), float64 {exact_loss}; grad_norm {m['grad_norm']}, one process "
                f"{float(mone['grad_norm'])}, float64 {exact_norm} (TP rel {norm_rel}, gate "
                f"{TP_NORM_RTOL}); farthest leaf from the "
                f"float64 step, in band-widths: TP {tp_far}, one process {one_far} (gate: TP "
                f"within max(1, twice the one process's)); leaf by leaf, TP's distance over "
                f"twice the one process's at most {ratio} ({rkey})")
            ok = (ok and loss_rel <= DP_LOSS_RTOL and norm_rel <= TP_NORM_RTOL
                  and tp_far <= max(1.0, 2 * one_far))
            steps.append({"loss_rel": loss_rel, "norm_rel": norm_rel, "tp_vs_exact": tp_far,
                          "one_vs_exact": one_far,
                          "tp_over_twice_one": ratio, "worst_leaf": rkey})
            if i:  # updates ``one`` in place; it is not read again
                one_ms = sorted(_timed_ms(lambda: train.train_step(cfg, tcfg, one, x, y, TP_LR)))[1]
            del one, ref, got, leaves
            start = checkpoint.load_train_state(os.path.join(work, f"step{i + 1}"), like)
        del start, like
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    steady = sorted(tr[0]["ms_per_step"])[1]
    share = tr[0]["collectives_ms"] / tr[0]["instrumented_ms"]
    log(f"{tag} FP32 b{TP_BATCH} at 224 px, lr {TP_LR}: ms per TP step (= per global batch) "
        f"{[round(v, 3) for v in tr[0]['ms_per_step']]}, median {steady:.3f} ms "
        f"({TP_BATCH / (steady / 1e3):.1f} img/s), one process {one_ms:.3f} ms; an "
        f"instrumented step "
        f"{tr[0]['instrumented_ms']:.3f} ms of which the {tr[0]['collectives']} channel "
        f"collectives (gathers and reduce-scatters, gloo through the host) "
        f"{tr[0]['collectives_ms']:.3f} ms ({share:.1%}); peak memory a rank "
        f"{[round(t['peak_gib'], 2) for t in tr]} GiB; {secs:.1f} s for the two ranks, on {card}")
    if not ok:
        raise AssertionError(f"{tag} a TP step is further from the float64 step than one "
                             "process's")
    out["train"] = {"steps": steps, "metrics": tr[0]["metrics"], "one_process_ms": one_ms,
                    "ms_per_step": tr[0]["ms_per_step"], "collectives_share": share,
                    "collectives": tr[0]["collectives"]}
    return out


def phase_cli_tp(card: str) -> dict:
    """``[cli tp]``: ``classify --model-dim 2`` (ResNet-50, fp, FP32, four
    seeded ``.bin`` images: two ranks spawned by the command) beside the
    one-process command, and ``train --model-dim 2 --steps 2
    --checkpoint-dir`` (ResNet-18, FP32, batch 8, 224 px) beside the
    one-process command, all four at once: classify prints one process's
    lines; the TP checkpoint loads in this process and equals the
    one-process run's, its step 2, every param and BN stat within a
    relative L2 distance of ``TP_LEAF_TOL`` and the momentum buffers'
    norm within ``TP_NORM_RTOL``; both runs log the same losses within
    ``TP_LOSS_RTOL``."""
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from resnetc_tpu_torch import checkpoint, train
    from resnetc_tpu_torch.data.preprocess import save_input_bin
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.tensor import flatten_tree

    tag = "[cli tp]"
    root = os.path.dirname(os.path.abspath(__file__))
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_"))
    try:
        rng = np.random.default_rng(12)
        bins = []
        for i in range(4):
            bins.append(str(work / f"{i}.bin"))
            save_input_bin(rng.standard_normal((1, 3, 224, 224)).astype(np.float32), bins[-1])
        serve = ["classify", "--model", "resnet50", "--policy", "fp32", *bins]
        fit = ["train", "--model", "resnet18", "--policy", "fp32", "--batch-size", "8",
               "--steps", "2", "--log-every", "1"]
        t0 = time.perf_counter()
        outs = _finish(tag, {
            "classify tp": _cli(*serve, "--model-dim", "2", cwd=root),
            "classify": _cli(*serve, cwd=root),
            "train tp": _cli(*fit, "--model-dim", "2", "--checkpoint-dir", str(work / "tp"),
                             cwd=root),
            "train": _cli(*fit, "--checkpoint-dir", str(work / "one"), cwd=root),
        }, t0)
        lines = {k: outs[k][0].splitlines() for k in ("classify tp", "classify")}
        log(f"{tag} classify --model-dim 2: {lines['classify tp']}; one process "
            f"{lines['classify']}")
        if lines["classify tp"] != lines["classify"] or len(lines["classify"]) != 4:
            raise AssertionError(f"{tag} classify printed other lines over the model axis")
        losses = {k: [json.loads(ln)["loss"] for ln in outs[k][0].splitlines()
                      if ln.startswith('{"tag": "train"')] for k in ("train tp", "train")}
        cfg = resnet.get_config("resnet18")
        like = train.init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        tp_state = checkpoint.load_train_state(work / "tp", like)
        one_state = checkpoint.load_train_state(work / "one", like)
        # Each param and BN stat by its relative L2 distance; the farthest
        # element, against its leaf's largest, is printed beside it.
        worst, key, far, far_key = 0.0, "", 0.0, ""
        got, want = _flat_state(tp_state), _flat_state(one_state)
        for k, w in want.items():
            e = float((got[k] - w).norm() / w.norm())
            if e > worst:
                worst, key = e, k
            e = float((got[k] - w).abs().max() / w.abs().max())
            if e > far:
                far, far_key = e, k
        # The momentum buffers are sums of raw gradients, whose fp32 noise in
        # a conv weight ahead of BN is large against the weight's own
        # gradient: held by their norm, as a step's grad_norm is.
        norms = [float(torch.linalg.vector_norm(torch.stack([
            v.norm() for v in flatten_tree(st.momentum).values()]))) for st in (tp_state, one_state)]
        norm_rel = abs(norms[0] / norms[1] - 1)
        loss_rel = [abs(a / b - 1) for a, b in zip(losses["train tp"], losses["train"])]
        log(f"{tag} train --model-dim 2: losses {losses['train tp']}, one process "
            f"{losses['train']} (rel {loss_rel}); its checkpoint (step {int(tp_state.step)}) "
            f"loaded in one process: farthest param or BN stat from the one-process "
            f"checkpoint's, relative L2 {worst} ({key}; gate {TP_LEAF_TOL}), farthest element "
            f"{far} of its leaf's max ({far_key}), momentum norm "
            f"{norms[0]} vs {norms[1]} (rel {norm_rel}, gate {TP_NORM_RTOL}); wall ms "
            f"{json.dumps({k: round(ms) for k, (_, ms) in outs.items()})} on {card}")
        if (int(tp_state.step) != 2 or worst > TP_LEAF_TOL or norm_rel > TP_NORM_RTOL
                or len(loss_rel) != 2 or any(r > g for r, g in zip(loss_rel, TP_LOSS_RTOL))):
            raise AssertionError(f"{tag} the TP train run differs from the one-process run")
        return {"classify": lines["classify tp"], "losses": losses, "worst_leaf": worst,
                "seconds": time.perf_counter() - t0}
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# The serving CLI and the data pipeline: [native], [cli serve
# resnet152], [loader], [local latency], [debug], [train data-dir]
# ---------------------------------------------------------------------------

#: The data phases' inputs: JPEGs of ImageNet-like sizes (300-500 px a
#: side), smooth enough to hold structure, from numpy seeds.
DATA_JPEGS, TREE_PER_CLASS, CLI_BATCH = 32, 32, 32


def _write_jpegs(directory, n: int, seed: int, prefix: str = "img") -> list:
    """``n`` seeded JPEGs of 300-500 px a side in ``directory``."""
    import numpy as np
    from PIL import Image

    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(300, 501, 2))
        small = rng.integers(0, 256, (h // 8, w // 8, 3), dtype=np.uint8)
        img = Image.fromarray(small).resize((w, h), Image.BICUBIC)
        noise = rng.integers(-12, 13, (h, w, 3))
        arr = np.clip(np.asarray(img, np.int16) + noise, 0, 255).astype(np.uint8)
        path = directory / f"{prefix}{i:03d}.jpeg"
        Image.fromarray(arr).save(path, quality=90)
        paths.append(str(path))
    return paths


def _wall(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def phase_native(work) -> dict:
    """``[native]``: whether the native host libraries built (and why not):
    the reader wherever ``g++`` is, the ingest where the libjpeg headers
    are too.  Then the ingest against PIL on 32 seeded JPEGs (within one
    uint8 level, exact on > 90% of values), decode img/s at 1 and 4 threads
    against PIL's, and ``read_f32_many`` against ``np.fromfile`` on
    ResNet-152's weight files (bit for bit; wall ms of each, the better of
    two turns, and of ``load_reference_format``)."""
    import numpy as np
    import torch

    from resnetc_tpu_torch import checkpoint, native
    from resnetc_tpu_torch.data import preprocess
    from resnetc_tpu_torch.models import resnet

    tag = "[native]"
    headers = native.jpeg_headers()
    built = {name: native.available(name) for name in native.LIBS}
    out = {"headers": headers, "built": built, "why_not": native.why_unavailable()}
    for name, ok in built.items():
        log(f"{tag} lib{name}.so built: {ok}"
            + (f" ({native.build(name)})" if ok else f"; why not: {native.why_unavailable(name)}"))
    log(f"{tag} jpeglib.h found by the compiler: {headers}")
    if native._cxx() and not built["binio"] or headers and not built["ingest"]:
        raise AssertionError(f"{tag} a library whose compiler and headers are present failed "
                             f"to build: {out['why_not']}")
    built = built["ingest"]

    paths = _write_jpegs(work / "jpegs", DATA_JPEGS, seed=3)
    pil, pil_ms = _wall(lambda: np.concatenate([preprocess.preprocess_file(p) for p in paths]))
    out["pil_img_per_s"] = len(paths) / pil_ms * 1e3
    if built:
        kw = dict(resize=preprocess.DEFAULT_RESIZE, crop=preprocess.DEFAULT_CROP,
                  mean=preprocess.IMAGENET_MEAN, std=preprocess.IMAGENET_STD)
        nat = {}
        for threads in (1, 4):
            native.preprocess_files(paths[:2], num_threads=threads, **kw)  # warm the page cache
            nat[threads], ms = _wall(lambda t=threads: native.preprocess_files(
                paths, num_threads=t, **kw))
            out[f"native_img_per_s_{threads}t"] = len(paths) / ms * 1e3
        if not np.array_equal(nat[1], nat[4]):
            raise AssertionError(f"{tag} 1 and 4 threads decode differently")
        one_level = 1.0 / 255.0 / preprocess.IMAGENET_STD
        diff = np.abs(pil - nat[4])
        exact = float((diff < 1e-6).mean())
        if not ((diff <= one_level[None, None, None, :] + 1e-5).all() and exact > 0.9):
            raise AssertionError(f"{tag} native vs PIL: max {diff.max()}, exact {exact}")
        out["exact_share_vs_pil"] = exact
        log(f"{tag} native vs PIL on {len(paths)} JPEGs: within one uint8 level, exact on "
            f"{100 * exact:.2f}% of values")
        log(f"{tag} decode + preprocess: native {out['native_img_per_s_1t']:.1f} img/s on 1 "
            f"thread, {out['native_img_per_s_4t']:.1f} on 4; PIL {out['pil_img_per_s']:.1f}")
    else:
        log(f"{tag} decode + preprocess: PIL {out['pil_img_per_s']:.1f} img/s (no library)")

    cfg = resnet.get_config("resnet152")
    weights = work / "weights"
    n = checkpoint.save_reference_format(resnet.init(cfg, torch.Generator().manual_seed(0)),
                                         weights)
    keys = list(resnet.param_shapes(cfg))
    files = [str(weights / k) for k in keys]
    counts = [int(np.prod(s)) for s in resnet.param_shapes(cfg).values()]
    mb = sum(counts) * 4 / 1e6
    readers = {"fromfile": lambda: [np.fromfile(f, dtype="<f4") for f in files]}
    if native.available("binio"):
        readers["read_f32_many"] = lambda: native.read_f32_many(files, counts)
    got = {}
    for _ in range(2):  # in turns; the better of two
        for name, read in readers.items():
            got[name], ms = _wall(read)
            out[f"{name}_ms"] = min(ms, out.get(f"{name}_ms", ms))
    _, out["load_reference_format_ms"] = _wall(lambda: checkpoint.load_reference_format(
        cfg, weights))
    if "read_f32_many" in got and not all(
            np.array_equal(a, b) for a, b in zip(got["read_f32_many"], got["fromfile"])):
        raise AssertionError(f"{tag} read_f32_many differs from np.fromfile")
    log(f"{tag} {n} weight files, {mb:.1f} MB (page cache warm): "
        + ", ".join(f"{name} {out[f'{name}_ms']:.1f} ms" for name in readers)
        + (", bit for bit" if len(readers) > 1 else "")
        + f"; load_reference_format {out['load_reference_format_ms']:.1f} ms")
    out["weight_files"], out["weight_mb"] = n, mb
    return out


def _cli(*argv, cwd):
    """``python -m resnetc_tpu_torch *argv`` started in ``cwd``."""
    return subprocess.Popen([sys.executable, "-m", "resnetc_tpu_torch", *argv], cwd=cwd,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(tag: str, procs: dict, t0: float) -> dict:
    """Wait for the named commands, started at ``t0``: each one's (stdout,
    wall ms to its own exit), or raise with its stderr."""
    ends: dict = {}
    try:
        while len(ends) < len(procs):  # the outputs are short: no pipe fills
            for name, p in procs.items():
                if name not in ends and p.poll() is not None:
                    ends[name] = (time.perf_counter() - t0) * 1e3
            if time.perf_counter() - t0 > 600:
                raise AssertionError(f"{tag} {sorted(set(procs) - set(ends))} outlasted 600 s")
            time.sleep(0.05)
        outs = {}
        for name, p in procs.items():
            so, se = p.communicate()
            if p.returncode != 0:
                raise AssertionError(f"{tag} {name} exited {p.returncode}:\n{se[-3000:]}")
            outs[name] = (so, ends[name])
            log(f"{tag} {name}: rc 0, {ends[name]:.0f} ms wall")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _tree(work):
    """The seeded 2-class ImageFolder tree of 2 x 32 JPEGs."""
    root = work / "tree"
    if not root.exists():
        for c, cls in enumerate(("n01440764", "n01443537")):
            _write_jpegs(root / cls, TREE_PER_CLASS, seed=100 + c)
    return root


def phase_cli_serve(work, cases: list, dev) -> dict:
    """``[cli serve resnet152]``: the five commands as subprocesses
    (``python -m resnetc_tpu_torch``), ResNet-152 ``int8_chain`` from files:
    ``export-weights`` (the files ``save_reference_format`` wrote for the
    same seed, byte for byte) and ``convert-images`` (the ``.bin``s of the
    port's own preprocessing, byte for byte) together; then ``classify``
    (a ``.bin``, a JPEG and a PNG: the indices of in-process ``classify``
    of the same arrays) and ``eval`` (the 2 x 32-JPEG tree at batch 32:
    count 64, top-1 / top-5 those of the engine's logits over the same
    batches, run in process with the launch counters set to 0 just before
    and read just after: two forwards of the served route) together; then
    ``bench --batch-size 32 --steps 10 --latency-samples 10`` alone
    (parseable JSON, platform "gpu").  Returns the in-process engine for
    the phases after it."""
    import filecmp

    import numpy as np
    import torch
    from PIL import Image

    from resnetc_tpu_torch import checkpoint
    from resnetc_tpu_torch.data import evaluate, preprocess
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.serve import InferenceEngine, classify_files

    tag = "[cli serve resnet152]"
    root = os.path.dirname(os.path.abspath(__file__))
    imgs, bins, exported = work / "imgs", work / "bins", work / "exported"
    jpegs = _write_jpegs(imgs, 2, seed=7)
    rng = np.random.default_rng(8)
    Image.fromarray(rng.integers(0, 256, (333, 271, 3), dtype=np.uint8)).save(imgs / "c.png")
    tree = _tree(work)
    model = ["--model", "resnet152", "--backend", "int8_chain"]

    t0 = time.perf_counter()
    outs = _finish(tag, {
        "export-weights": _cli("export-weights", "--model", "resnet152", str(exported), cwd=root),
        "convert-images": _cli("convert-images", str(imgs), str(bins), cwd=root),
    }, t0)
    names = sorted(os.listdir(work / "weights"))
    same, diff, err = filecmp.cmpfiles(work / "weights", exported, names, shallow=False)
    if diff or err or len(os.listdir(exported)) != len(names):
        raise AssertionError(f"{tag} export-weights wrote other files: {diff + err}")
    for p in jpegs + [str(imgs / "c.png")]:
        want = preprocess.preprocess_file(p).transpose(0, 3, 1, 2).astype("<f4").tobytes()
        if (bins / (os.path.basename(p).rsplit(".", 1)[0] + ".bin")).read_bytes() != want:
            raise AssertionError(f"{tag} convert-images wrote another .bin for {p}")
    log(f"{tag} export-weights: {len(same)} files equal to save_reference_format's; "
        f"convert-images: 3 .bins equal to the port's preprocessing")

    inputs = [str(bins / "img000.bin"), jpegs[1], str(imgs / "c.png")]
    t0 = time.perf_counter()
    procs = {
        "classify": _cli("classify", *model, "--weights-dir", str(work / "weights"), *inputs,
                         cwd=root),
        "eval": _cli("eval", *model, "--weights-dir", str(work / "weights"),
                     "--batch-size", str(CLI_BATCH), str(tree), cwd=root),
    }
    # The same engine in this process, while the commands run.
    cfg = resnet.get_config("resnet152")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # calibration on noise, as the CLI's
        eng = InferenceEngine(cfg, checkpoint.load_reference_format(cfg, work / "weights"),
                              backend="int8_chain", device=dev)
    outs.update(_finish(tag, procs, t0))
    got = [int(ln.rsplit(" ", 1)[1]) for ln in outs["classify"][0].splitlines()]
    arrays = np.concatenate([preprocess.load_input_bin(p) if p.endswith(".bin")
                             else preprocess.preprocess_file(p) for p in inputs])
    want = [int(i) for i in eng.classify(arrays)]
    in_proc, files_ms = _wall(lambda: classify_files(eng, inputs))
    log(f"{tag} classify {[os.path.basename(p) for p in inputs]}: {got}; in-process classify "
        f"{want}, classify_files {in_proc} in {files_ms:.1f} ms wall")
    if not got == want == in_proc:
        raise AssertionError(f"{tag} classify printed {got}, the engine gives {want}")

    cli_eval = json.loads(outs["eval"][0].splitlines()[-1])
    (res, launches), eval_ms = _wall(lambda: counted(
        lambda: evaluate(eng, tree, batch_size=CLI_BATCH)))
    per_forward = expected_launches(cases, pp=True)
    want_launches = {k: 2 * v for k, v in per_forward.items()}
    log(f"{tag} eval: {json.dumps(cli_eval)}; in process {json.dumps(res)} in "
        f"{eval_ms:.1f} ms wall, launches {json.dumps(launches)}")
    if cli_eval["count"] != 2 * TREE_PER_CLASS or {**res, "model": "resnet152"} != cli_eval:
        raise AssertionError(f"{tag} eval gave {cli_eval}, the engine {res}")
    if launches != want_launches:
        raise AssertionError(f"{tag} evaluate launched {launches}, expected {want_launches}")

    t0 = time.perf_counter()
    outs.update(_finish(tag, {"bench": _cli(
        "bench", *model, "--batch-size", str(CLI_BATCH), "--steps", "10",
        "--latency-samples", "10", cwd=root)}, t0))
    bench = json.loads(outs["bench"][0].splitlines()[-1])
    log(f"{tag} bench: {json.dumps(bench)}")
    if bench.get("platform") != "gpu" or not bench.get("images_per_sec", 0) > 0:
        raise AssertionError(f"{tag} bench printed {bench}")
    return {"engine": eng, "launches": launches, "classes": got, "eval": cli_eval,
            "bench": bench, "classify_files_ms": files_ms, "evaluate_ms": eval_ms,
            "wall_ms": {k: ms for k, (_, ms) in outs.items()}, "inputs": inputs}


def phase_cli_dp_serve(work, serve: dict, card: str) -> dict:
    """``[cli dp serve]``: ``classify``, ``eval`` and ``bench`` with
    ``--data-dim 2`` (two ranks each, spawned by the command, sharing the
    card over gloo), all three at once, on ``[cli serve resnet152]``'s
    ResNet-152 files: classify's indices (``int8_chain``; its three files
    and the first again: int8_chain refuses a batch the data axis does not
    divide, as JAX's shard_map does) and eval's record (``int8_chain``)
    equal the one-process commands'; bench (``fp``: the latency request's
    one image is such a batch for ``int8_chain``) prints its JSON
    (platform "gpu").  Each command's wall ms is printed."""
    tag = "[cli dp serve]"
    root = os.path.dirname(os.path.abspath(__file__))
    weights = ["--model", "resnet152", "--weights-dir", str(work / "weights"), "--data-dim", "2"]
    model = [*weights, "--backend", "int8_chain"]
    inputs, classes = serve["inputs"] + serve["inputs"][:1], serve["classes"] + serve["classes"][:1]
    t0 = time.perf_counter()
    outs = _finish(tag, {
        "classify": _cli("classify", *model, *inputs, cwd=root),
        "eval": _cli("eval", *model, "--batch-size", str(CLI_BATCH), str(_tree(work)), cwd=root),
        "bench": _cli("bench", *weights, "--backend", "fp", "--batch-size", str(CLI_BATCH),
                      "--steps", "10", "--latency-samples", "10", cwd=root),
    }, t0)
    got = [int(ln.rsplit(" ", 1)[1]) for ln in outs["classify"][0].splitlines()]
    cli_eval = json.loads(outs["eval"][0].splitlines()[-1])
    bench = json.loads(outs["bench"][0].splitlines()[-1])
    wall = {k: ms for k, (_, ms) in outs.items()}
    log(f"{tag} classify {got} (one process {classes}); eval {json.dumps(cli_eval)}; "
        f"bench {json.dumps(bench)}; wall ms {json.dumps(wall)} (one process "
        f"{json.dumps(serve['wall_ms'])}) on {card}")
    if got != classes:
        raise AssertionError(f"{tag} classify printed {got}, one process {classes}")
    if cli_eval != serve["eval"]:
        raise AssertionError(f"{tag} eval printed {cli_eval}, one process {serve['eval']}")
    if bench.get("platform") != "gpu" or not bench.get("images_per_sec", 0) > 0:
        raise AssertionError(f"{tag} bench printed {bench}")
    return {"classes": got, "eval": cli_eval, "bench": bench, "wall_ms": wall}


def phase_loader(work, eng, dev) -> dict:
    """``[loader]``: ``BatchLoader`` over the 32 JPEGs and
    ``ImageFolderLoader`` over the tree (eval, and train-mode crops) give,
    on the card, the host arrays bit for bit; the wall time of one
    ``evaluate`` epoch over the tree at batch 32 with prefetch 2 and with
    prefetch 0 (each run twice, the second kept)."""
    import numpy as np
    import torch

    from resnetc_tpu_torch.data import BatchLoader, ImageFolderLoader, evaluate
    from resnetc_tpu_torch.data.preprocess import preprocess_files_batch

    tag = "[loader]"
    paths = sorted(str(p) for p in (work / "jpegs").iterdir())
    got = [b.cpu().numpy() for b in BatchLoader(paths, batch_size=8, device=dev)]
    want = [preprocess_files_batch(paths[i:i + 8], num_threads=2) for i in range(0, 32, 8)]
    if len(got) != 4 or not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{tag} BatchLoader's device batches differ from the host arrays")
    tree = _tree(work)
    for train in (False, True):
        kw = dict(batch_size=16, train=train, seed=5)
        host = list(ImageFolderLoader(tree, to_device=False, **kw))
        on_card = list(ImageFolderLoader(tree, device=dev, **kw))
        if not all(x.device.type == dev.type and np.array_equal(x.cpu().numpy(), hx) and
                   np.array_equal(y.cpu().numpy(), hy)
                   for (x, y), (hx, hy) in zip(on_card, host)) or len(host) != 4:
            raise AssertionError(f"{tag} ImageFolderLoader (train={train}) differs on the card")
    log(f"{tag} BatchLoader (4 x 8) and ImageFolderLoader (eval and train, 4 x 16) device "
        "batches equal the host arrays bit for bit")
    out = {}
    for prefetch in (2, 0, 2, 0):
        torch.cuda.synchronize()
        res, ms = _wall(lambda p=prefetch: evaluate(eng, tree, batch_size=CLI_BATCH, prefetch=p))
        out[f"evaluate_ms_prefetch{prefetch}"] = ms
    log(f"{tag} one evaluate epoch (2 x 32 JPEGs, ResNet-152 int8_chain): "
        f"{out['evaluate_ms_prefetch2']:.1f} ms wall with prefetch 2, "
        f"{out['evaluate_ms_prefetch0']:.1f} ms with prefetch 0")
    return out


def phase_local_latency(work, eng, dev) -> dict:
    """``[local latency]``: ``bench_local_latency`` (the marginal time of
    one of 16 chained forwards, host included, five samples) against
    ``bench_latency`` (CUDA events around each forward, 10 samples) and
    ``utils.timing.fetch_seconds`` (host clock to a fetched scalar, 10
    samples), the ResNet-152 ``int8_chain`` engine at batch 1 and 32; then
    10 forwards of each under ``utils.metrics.profile_trace``: the kernels'
    device time over the wall time (the card's busy share, under the
    profiler).  The kernels' time from the trace is the device time; the
    chained and event timings include the host's issue time."""
    import statistics

    import torch

    from resnetc_tpu_torch.serve import bench_latency, bench_local_latency
    from resnetc_tpu_torch.utils.metrics import annotate, profile_trace
    from resnetc_tpu_torch.utils.timing import fetch_seconds

    tag = "[local latency]"
    x = torch.randn((CLI_BATCH, 224, 224, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    out = {}
    for b in (1, CLI_BATCH):
        local = bench_local_latency(eng, x[:b], runs=5, iters=16)
        lat = bench_latency(eng, x[:b], samples=10, warmup=2)
        fetch_ms = 1e3 * statistics.median(fetch_seconds(eng.logits, x[:b], samples=10))
        logdir = work / f"trace_b{b}"
        with profile_trace(str(logdir)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with annotate(f"forwards_b{b}"):
                for _ in range(10):
                    eng.logits(x[:b])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
        kernel_ms = sum(e.get("dur", 0) for e in events if e.get("cat") == "kernel") / 1e3
        out[b] = {"local_p50_ms": local.p50_ms, "local_mean_ms": local.mean_ms,
                  "p50_ms": lat.p50_ms, "p99_ms": lat.p99_ms, "fetch_p50_ms": fetch_ms,
                  "profiled_ms_per_forward": wall_ms / 10, "kernel_ms_per_forward": kernel_ms / 10,
                  "busy_share": kernel_ms / wall_ms}
        log(f"{tag} batch {b}: bench_local_latency p50 {local.p50_ms:.3f} ms "
            f"(mean {local.mean_ms:.3f}); bench_latency p50 {lat.p50_ms:.3f} p99 "
            f"{lat.p99_ms:.3f} ms; fetch_seconds p50 {fetch_ms:.3f} ms; under the profiler "
            f"{wall_ms / 10:.3f} ms a forward, {kernel_ms / 10:.3f} of it in kernels: busy "
            f"share {kernel_ms / wall_ms:.3f}")
        if not (0 < local.p50_ms < 1e3 and 0 < kernel_ms <= wall_ms):
            raise AssertionError(f"{tag} bench_local_latency gave {local}; kernels {kernel_ms} "
                                 f"ms of {wall_ms} ms")
    return out


def phase_debug(cases: list, batch: int, dev) -> dict:
    """``[debug]``: a ResNet-34 ``int8_chain`` forward (served route) inside
    ``plain_kernels()`` launches nothing and gives the plain-version
    forward's logits (``kernels=PLAIN``) bit for bit; outside it, the served
    route's launches.  ``nan_debug()`` raises at a kernel wrapper whose
    input holds a NaN (``relu``) and passes a finite forward."""
    import torch

    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.ops.cuda import relu
    from resnetc_tpu_torch.ops.cuda.fused import PLAIN, fused_forward_int8_chain
    from resnetc_tpu_torch.serve import InferenceEngine
    from resnetc_tpu_torch.utils.debug import nan_debug, plain_kernels

    tag = "[debug]"
    cfg = resnet.get_config("resnet34")
    variables = resnet.init(cfg, torch.Generator().manual_seed(0))
    calib = torch.randn((8, 224, 224, 3), generator=torch.Generator().manual_seed(1))
    eng = InferenceEngine(cfg, variables, backend="int8_chain", calib_batch=calib, device=dev)
    x = torch.randn((batch, 224, 224, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    with plain_kernels():
        inside, launches_in = forward_counted(eng, x)
    with torch.inference_mode():
        plain = fused_forward_int8_chain(cfg, eng.folded, eng.chain_scales, x, kernels=PLAIN)
    served, launches = forward_counted(eng, x)
    want = expected_launches(cases, pp=True)
    log(f"{tag} inside plain_kernels(): launches {json.dumps(launches_in)}, logits equal to "
        f"the plain-version forward: {torch.equal(inside, plain)}; outside: "
        f"{json.dumps(launches)}")
    if launches_in or not torch.equal(inside, plain) or launches != want:
        raise AssertionError(f"{tag} plain_kernels() did not run the plain versions alone")
    with nan_debug():
        clean, _ = forward_counted(eng, x)
    if not torch.equal(clean, served):
        raise AssertionError(f"{tag} the forward under nan_debug differs")
    log(f"{tag} a finite forward under nan_debug: no error, logits equal")
    bad = torch.randn((4, 56, 56, 64), generator=torch.Generator().manual_seed(3)).to(dev)
    bad[1, 2, 3, 4] = float("nan")
    try:
        with nan_debug():
            relu(bad)
        raise AssertionError(f"{tag} nan_debug did not raise on a NaN input to relu")
    except FloatingPointError as e:
        log(f"{tag} nan_debug on a NaN input: FloatingPointError({e})")
    return {"launches": launches}


def phase_train_data_dir(work) -> dict:
    """``[train data-dir]``: ``train --model resnet18 --data-dir`` on the
    tree (2 classes), batch 32, 3 steps, in process: three finite losses."""
    import io
    import math

    from resnetc_tpu_torch.__main__ import main as cli_main

    tag = "[train data-dir]"
    buf = io.StringIO()
    argv = ["train", "--model", "resnet18", "--num-classes", "2", "--batch-size", "32",
            "--steps", "3", "--log-every", "1", "--data-dir", str(_tree(work))]
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    recs = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    for r in recs:
        log(f"{tag} {json.dumps(r)}")
    if rc != 0 or [r["step"] for r in recs] != [1, 2, 3] or not all(
            math.isfinite(r["loss"]) for r in recs):
        raise AssertionError(f"{tag} rc {rc}, records {recs}")
    return {"losses": [r["loss"] for r in recs],
            "images_per_sec": [r["images_per_sec"] for r in recs]}


def run_data_phases(cases: dict, batch: int, card: str, dev, add) -> dict:
    """The data and serving-CLI phases in order, each's seconds printed;
    ``add`` takes the launches of the forwards counted in them."""
    import shutil
    import tempfile
    from pathlib import Path

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_data_"))
    out = {}
    try:
        seconds = out["seconds"] = {}

        def timed(name, fn):
            t0 = time.perf_counter()
            out[name] = fn()
            seconds[name] = time.perf_counter() - t0
            log(f"[phase] {name}: {seconds[name]:.1f} s")
            return out[name]

        timed("native", lambda: phase_native(work))
        serve = timed("cli_serve", lambda: phase_cli_serve(work, cases["resnet152"], dev))
        add(serve["launches"])
        eng = serve.pop("engine")
        timed("cli_dp_serve", lambda: phase_cli_dp_serve(work, serve, card))
        timed("loader", lambda: phase_loader(work, eng, dev))
        timed("local_latency", lambda: phase_local_latency(work, eng, dev))
        del eng
        debug = timed("debug", lambda: phase_debug(cases["resnet34"], batch, dev))
        add(debug["launches"])
        timed("train_data_dir", lambda: phase_train_data_dir(work))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# The serving artifact: [artifact resnet50]
# ---------------------------------------------------------------------------

#: The exported programs: (name, model, backend, batch) at 224 px on the
#: served route's flags: ResNet-50 (the JAX exporter's default model) and a
#: ResNet-18, whose program calls the basic-block ops.
ARTIFACTS = (("int8_chain_b1", "resnet50", "int8_chain", 1),
             ("fp_b1", "resnet50", "fp", 1),
             ("int8_chain_b32", "resnet50", "int8_chain", DP_SERVE_BATCH),
             ("resnet18_int8_chain_b8", "resnet18", "int8_chain", 8))
#: The seed of the artifacts' images, and how many the fc bias is centred on.
ARTIFACT_SEED, ARTIFACT_IMAGES = 11, DP_SERVE_BATCH
#: Each ``resnetc::`` op of the served routes, by the launch counter of the
#: wrapper that calls it.
OP_COUNTER = {"chain_block_int8": "bottleneck_block_chained_int8",
              "chain_run_int8": "bottleneck_run_chained_int8",
              "ds_block_s2_int8": "downsample_block_s2_int8",
              "pp_block_int8": "bottleneck_block_chained_int8_pp",
              "pp_run_int8": "bottleneck_run_chained_int8_pp",
              "basic_block_int8": "basic_block_chained_int8",
              "basic_run_int8": "basic_run_chained_int8",
              "basic_ds_block_s2_int8": "basic_ds_block_s2_int8",
              "pp_basic_block_int8": "basic_block_chained_int8_pp",
              "pp_basic_run_int8": "basic_run_chained_int8_pp",
              "gemm_f32acc": "matmul",
              "stem_pool_int8": "stem_pool_int8"}
RUNNER_LATENCY_SAMPLES = 20


def artifact_images(batch: int):
    """The artifacts' seeded images: the first ``batch`` of one draw."""
    import torch

    gen = torch.Generator().manual_seed(ARTIFACT_SEED)
    return torch.randn((ARTIFACT_IMAGES, 224, 224, 3), generator=gen)[:batch].contiguous()


def centred_weights(model: str, path, dev) -> str:
    """Write ``model``'s seeded weights (seed 0, the exporter's) to the
    ``.pth`` ``path`` with the fc bias moved by minus the mean of the fp
    engine's logits over the artifacts' images, and return the path.  The
    seeded init alone puts every image in one class; centred, the classes
    vary over the images, so that equal classes say something."""
    import torch

    from resnetc_tpu_torch import checkpoint, export
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.serve import InferenceEngine
    from resnetc_tpu_torch.tensor import BF16

    cfg = resnet.get_config(model)
    variables = export.load_variables(cfg, None)
    eng = InferenceEngine(cfg, variables, policy=BF16, backend="fp", device=dev)
    with torch.inference_mode():
        mean = eng.logits(artifact_images(ARTIFACT_IMAGES).to(dev)).float().mean(0).cpu()
    variables["fc"]["bias"] = variables["fc"]["bias"] - mean
    torch.save(checkpoint.torch_state_dict_from_variables(variables), path)
    return str(path)


def build_artifacts(out_dir: str) -> int:
    """``chip_smoke.py --artifacts DIR``, a child the main run starts before
    the kernels build (none is launched here: the fp engine that centres
    the weights runs stock ops): the C++ runner built with g++ in a thread
    while ``ARTIFACTS`` are exported one after the other
    (``export.export_artifact``: engine, ``torch.export``, AOTInductor) on
    ``centred_weights``.  Writes DIR/artifacts.json with the paths, the
    nodes and the seconds of each step."""
    import concurrent.futures
    from pathlib import Path

    import torch

    from resnetc_tpu_torch import export, native

    out = Path(out_dir)
    t0 = time.perf_counter()
    res: dict = {"artifacts": {}, "weights": {}}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        runner = pool.submit(native.build_runner)
        for name, model, backend, batch in ARTIFACTS:
            if model not in res["weights"]:
                res["weights"][model] = centred_weights(model, out / f"{model}.pth",
                                                        torch.device("cuda"))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)  # calibrated on noise, as the CLI's
                res["artifacts"][name] = export.export_artifact(
                    model=model, backend=backend, batch=batch, image_size=224,
                    out=out / name, weights=res["weights"][model])
        res["runner"] = str(runner.result())
        res["runner_built_s"] = time.perf_counter() - t0
    res["seconds"] = time.perf_counter() - t0
    (out / "artifacts.json").write_text(json.dumps(res))
    return 0


class _OpCalls:
    """A dispatch mode counting the ``resnetc::`` op calls made under it,
    by the launch counter of the wrapper that calls each op (the loaded
    package calls the ops itself, past the wrappers)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        calls: dict = {}

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func.namespace == "resnetc":
                    name = OP_COUNTER[func._schema.name.split("::")[1]]
                    calls[name] = calls.get(name, 0) + 1
                return func(*args, **(kwargs or {}))

        self.calls, self.mode = calls, Mode()


def phase_artifact(child, art_dir, cases: dict, card: str, dev) -> dict:
    """``[artifact resnet50]``: the programs exported by
    ``build_artifacts`` (started at the beginning of the run) on
    ``centred_weights``, ResNet-50 as ``int8_chain`` on the served route at
    b1 and b32 and ``fp`` at b1, and ResNet-18 as ``int8_chain`` at b8, each
    held against the eager engine built from the same weights in this
    process: the package loaded here (``aoti_load_package``) within 1e-2 of
    max |logit| of the engine's logits, calling the ops the engine's
    forward launches; the graph's ``resnetc::`` nodes one per launch of
    that forward, the served route's count (``expected_launches``); the C++
    runner (``native/aoti_serve.cpp``, ``--ops`` the ops library this
    process loaded) on a raw f32 file of the seeded images, its logits
    (``--out``) within 1e-2 of max |logit| of the engine's and its classes
    the engine's, which vary over the images at b > 1; and its latency
    (each request: upload, run, fetch, argmax) beside ``bench_latency`` of
    the engine at the same batch.  The export, compile and build seconds
    are printed with the card."""
    from pathlib import Path

    import numpy as np
    import torch

    from resnetc_tpu_torch import export
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.ops.cuda import _build
    from resnetc_tpu_torch.serve import bench_latency

    tag = "[artifact resnet50]"
    t0 = time.perf_counter()
    try:
        rc = child.wait(timeout=900)
    except subprocess.TimeoutExpired:
        child.kill()
        raise AssertionError(f"{tag} the export child outlasted 900 s")
    log_text = (Path(art_dir) / "build.log").read_text()
    if rc != 0:
        raise AssertionError(f"{tag} the export child exited {rc}:\n{log_text[-4000:]}")
    built = json.loads((Path(art_dir) / "artifacts.json").read_text())
    ops_library = str(_build.build_ops_library())
    log(f"{tag} export child done {time.perf_counter() - t0:.1f} s after the phases before "
        f"it ({built['seconds']:.1f} s in all): runner built in {built['runner_built_s']:.1f} s "
        f"(in a thread beside the exports), on {card}")
    want_nodes = {
        "resnet50": expected_launches(cases["resnet152"], pp=True,
                                      blocks=resnet.get_config("resnet50").stage_blocks),
        "resnet18": expected_launches(cases["resnet34"], pp=True,
                                      basic=resnet.get_config("resnet18").stage_blocks),
    }
    out = {"built": built, "launches": [], "artifacts": {}}
    for name, model, backend, batch in ARTIFACTS:
        art = built["artifacts"][name]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            eng = export.build_engine(model, backend, weights=built["weights"][model], device=dev)
        x = artifact_images(batch)
        xpath = Path(art_dir) / f"{name}.f32"
        lpath = Path(art_dir) / f"{name}.logits.f32"
        x.numpy().astype("<f4").tofile(xpath)
        x = x.to(dev)
        want, eager = counted(lambda: eng.logits(x).float())
        cmd = [built["runner"], art["path"], str(xpath), str(batch), "224", "224", "3",
               "--latency", str(RUNNER_LATENCY_SAMPLES), "--out", str(lpath)]
        if backend == "int8_chain":
            cmd += ["--ops", ops_library]
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if run.returncode != 0:
            raise AssertionError(f"{tag} {name}: the runner exited {run.returncode}:\n"
                                 f"{run.stdout[-2000:]}\n{run.stderr[:4000]}")
        lines = run.stdout.splitlines()
        classes = [int(ln.split("class ")[1].split(" ")[0]) for ln in lines[:-1]]
        runner_lat = json.loads(lines[-1].split(" ", 1)[1])
        runner_logits = torch.from_numpy(
            np.fromfile(lpath, dtype="<f4").reshape(tuple(want.shape))).to(dev)
        runner_err = float((runner_logits - want).abs().max() / want.abs().max())
        log(f"{tag} {name}: the runner printed {len(classes)} classes, latency_ms "
            f"{json.dumps(runner_lat)}")
        loaded = torch._inductor.aoti_load_package(art["path"])
        with torch.inference_mode():
            loaded(x)  # the first run loads the program onto the card
        calls = _OpCalls()
        with torch.inference_mode(), calls.mode:
            got = loaded(x)
        torch.cuda.synchronize()
        in_proc = calls.calls
        got = got.float() if torch.is_tensor(got) else got[0].float()
        err = float((got - want).abs().max() / want.abs().max())
        nodes = {OP_COUNTER[k]: v for k, v in art["kernel_nodes"].items()}
        lat = bench_latency(eng, x, samples=RUNNER_LATENCY_SAMPLES, warmup=3)
        eng_classes = want.argmax(-1).cpu().tolist()
        row = {"model": model, "export_s": art["export_s"], "compile_s": art["compile_s"],
               "engine_s": art["engine_s"], "package_mib": Path(art["path"]).stat().st_size / 2**20,
               "kernel_nodes": art["kernel_nodes"], "eager_launches": eager,
               "loaded_op_calls": in_proc, "loaded_rel_max_err": err,
               "runner_rel_max_err": runner_err, "engine_classes": eng_classes,
               "runner_classes_equal": classes == eng_classes, "runner_latency_ms": runner_lat,
               "bench_latency_p50_ms": lat.p50_ms, "bench_latency_p99_ms": lat.p99_ms}
        log(f"{tag} {name}: {model}, export {art['export_s']:.1f} s, AOTInductor compile "
            f"{art['compile_s']:.1f} s, package {row['package_mib']:.1f} MiB; graph nodes "
            f"{json.dumps(art['kernel_nodes'])}; eager launches {json.dumps(eager)}, the loaded "
            f"package's op calls {json.dumps(in_proc)}; max err / max |logit| against the "
            f"engine: loaded package {err}, runner {runner_err}; engine classes "
            f"{eng_classes[:8]}{'...' if batch > 8 else ''} ({len(set(eng_classes))} distinct), "
            f"the runner's equal: {classes == eng_classes}; runner latency_ms "
            f"{json.dumps(runner_lat)} (upload, run, fetch, argmax) vs in-process bench_latency "
            f"p50 {lat.p50_ms:.3f} p99 {lat.p99_ms:.3f} ms (CUDA events around engine.logits) "
            f"at b{batch} on {card}")
        if backend == "int8_chain" and not nodes == eager == in_proc == want_nodes[model]:
            raise AssertionError(f"{tag} {name}: graph nodes {nodes}, eager launches {eager}, "
                                 f"loaded op calls {in_proc}, served route {want_nodes[model]}")
        if backend == "fp" and (nodes or eager or in_proc):
            raise AssertionError(f"{tag} {name}: the fp program launched kernels")
        if batch > 1 and len(set(eng_classes)) == 1:
            raise AssertionError(f"{tag} {name}: the engine puts every image in one class")
        if err > 1e-2 or runner_err > 1e-2 or classes != eng_classes:
            raise AssertionError(f"{tag} {name}: the artifact disagrees with the engine")
        out["launches"] += [eager]
        out["artifacts"][name] = row
        del eng, loaded
        torch.cuda.empty_cache()
    return out


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
    # No Pallas kernel: XLA's fusion of the stem's bias, relu, quantize, pool
    # and chain pad; bound by bytes (the bf16 map read once, the pooled int8
    # map written once); one thread an 8-channel column over a band of rows,
    # the window's max before the quantizer (see the source's header).
    "stem_pool_int8": ("resnetc_tpu_torch/csrc/pool.cu",
                       "none: XLA's fusion of resnetc_tpu/ops/pallas/fused.py:857-863"),
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
                "bottleneck_block_chained", "bottleneck_block_fused",
                "bottleneck_block_chained_int8",
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
        tf32 = case.library_tf32()
        lib_tf32_ms = device_ms(tf32, iters=20) if tf32 is not None else None
        per_forward = case.per_forward if case.per_forward is not None else counts.get(case.name, 0)
        row = {
            "case": case.name, "kernel": case.kernel, "batch": batch,
            "per_forward": per_forward, "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": case.bound_ms, "bound_by": case.bound_by, "library_ms": lib_ms,
            "ops": case.ops, "bytes": case.nbytes,
            "tflops": case.ops / ms * 1e-9, "bound_share": case.bound_ms / ms,
            "peak": case.peak,
        }
        if tf32 is not None:
            row["library_tf32_ms"] = lib_tf32_ms
        per_case.append(row)
        log(f"[timing] {json.dumps(row)}")
        if case.kernel in TILE_KERNELS:
            ieee = " (IEEE fp32: TF32 off for cuDNN and cuBLAS)" if tf32 is not None else ""
            vs = f", {ms / lib_ms:.2f}x the library's {lib_ms:.4f} ms{ieee}" if lib_ms else ""
            if lib_tf32_ms:
                vs += f"; the library in TF32 {lib_tf32_ms:.4f} ms"
            rate = "TOP/s" if case.peak == PEAK_INT8_OPS else "TFLOP/s"
            log(f"[tile] {case.name}: {ms:.4f} ms, {row['tflops']:.1f} {rate}, "
                f"{100 * row['bound_share']:.1f}% of the bound at {case.peak / 1e12:.0f} "
                f"{rate} ({PEAK_NAMES[case.peak]}){vs}")
        elif case.kernel == "avg_pool2d":
            vs = f", {ms / lib_ms:.2f}x F.avg_pool2d's {lib_ms:.4f} ms" if lib_ms else ""
            log(f"[pool] {case.name}: {ms:.4f} ms, {100 * row['bound_share']:.1f}% of the "
                f"bound{vs}")

    # The FP32 routes' fp32 GEMMs, convolutions and blocks, summed per
    # forward of ResNet-152 at this batch (the cases' per_forward weights).
    for kernel in ("matmul", "conv3x3_s1_fused", "conv_s2_fused", "bottleneck_block_chained"):
        rows = [r for r in per_case if r["kernel"] == kernel and r["case"].endswith("/fp32")
                and r["per_forward"] > 0]
        tot = {key: sum(r[key] * r["per_forward"] for r in rows)
               for key in ("ms", "bound_ms", "library_ms", "library_tf32_ms")
               if all(r.get(key) is not None for r in rows)}
        log(f"[fp32] {kernel}: {sum(r['per_forward'] for r in rows)} launches a forward, "
            f"{json.dumps(tot)} ms a forward (library in IEEE fp32 and in TF32)")

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


def phase_ew_timing(dev) -> dict:
    """Rows 19-20 case by case: the kernel's device ms, torch.relu /
    torch.add on the same inputs, the bytes bound, and the device time of an
    empty launch (``torch.cuda._sleep(0)``), all timed as ``device_ms``."""
    import torch

    empty_ms = device_ms(lambda: torch.cuda._sleep(0), iters=10)
    log(f"[ew] empty launch (torch.cuda._sleep(0)): {empty_ms:.4f} ms on the card")
    out = {"empty_launch_ms": empty_ms, "cases": {}}
    for case in make_ew_cases(dev):
        ms = device_ms(case.run, iters=10)
        lib = case.library()
        row = {"ms": ms, "library_ms": device_ms(lib, iters=10) if lib else None,
               "bound_ms": case.bound_ms, "bound_share": case.bound_ms / ms}
        vs = f", {ms / row['library_ms']:.3f}x torch's {row['library_ms']:.4f}" \
            if row["library_ms"] else ""
        log(f"[ew] {case.name}: {ms:.4f} ms; bound {case.bound_ms:.4f} ms ({case.nbytes} bytes), "
            f"{100 * row['bound_share']:.1f}% of it{vs}")
        out["cases"][case.name] = row
    return out


def phase_grouped(dev, batch: int = 128) -> dict:
    """The ResNeXt blocks at ResNeXt-101 32x8d's stage shapes, batch 128:
    each stage's stride-1 block and transition (stage 0's projection block)
    equal to its plain version, its device ms a launch and its share of the
    int8 peak and of its roofline (operations and bytes counted from the
    model's shapes, conv2 at its grouped MACs), and its launches a forward
    of the served ResNeXt-101 (30 stride-1, 3 stride-2, no other block
    kernel), the forward's ms and images/s."""
    import warnings

    import torch

    from resnetc_tpu_torch.models import get_config
    from resnetc_tpu_torch.models import resnet as tresnet
    from resnetc_tpu_torch.ops.cuda import _build, block
    from resnetc_tpu_torch.ops.cuda.fused import grouped_kmajor_copies
    from resnetc_tpu_torch.serve import InferenceEngine

    gen = torch.Generator().manual_seed(2024)
    scales = torch.full((4,), 0.05, dtype=torch.float32, device=dev)
    keys = ("w1q", "sw1", "b1", "w2q", "sw2", "b2", "w3q", "sw3", "b3")

    def weights(cin, w, c, gw, proj):
        def entry(shape):
            return {"weight": torch.randn(shape, generator=gen) * 0.05,
                    "bias": torch.randn(shape[-1], generator=gen) * 0.1}

        blk = {"conv1": entry((1, 1, cin, w)), "conv2": entry((3, 3, gw, w)),
               "conv3": entry((1, 1, w, c))}
        if proj:
            blk["downsample"] = entry((1, 1, cin, c))
        return {k: v.to(dev) for k, v in block.quantize_grouped_block(blk).items()}

    out = {"kernels": {}}
    for s, (h, w, gw) in enumerate(GROUPED_STAGES):
        # (op, input side, input width, the stage's first block: a projection)
        forms = [("grouped_ds_block_s2_int8", 2 * h, w // 2, True) if s else
                 ("grouped_block_int8", h, 64, True), ("grouped_block_int8", h, w, False)]
        for name, hin, ci, proj in forms:
            q = weights(ci, w, w, gw, proj)
            x = _chain(gen, batch, hin, ci, dev)
            kw = dict(h=hin, w_sp=hin, **grouped_kmajor_copies(q))
            if name == "grouped_ds_block_s2_int8":
                args = (x, *(q[k] for k in keys), q["wdq"], q["swd"], q["bd"], scales)
                fn, plain = block.grouped_ds_block_s2_int8, block.grouped_ds_block_s2_int8_plain
            else:
                args = (x, *(q[k] for k in keys), scales)
                kw.update(wdq=q.get("wdq"), swd=q.get("swd"), bd=q.get("bd"))
                fn, plain = block.grouped_block_int8, block.grouped_block_int8_plain
            got = fn(*args, **kw)
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"[grouped] {name} at stage {s}: differs from plain")
            if int(torch.unique(got).numel()) < 20:
                raise AssertionError(f"[grouped] {name} at stage {s}: degenerate output")
            del want
            ms = device_ms(lambda: fn(*args, **kw), 10)
            px, px_in = batch * h * h, batch * hin * hin
            conv2 = 9 * w * gw
            ops = 2 * (px_in * ci * w + px * (conv2 + w * w + (ci * w if proj else 0)))
            wbytes = ci * w + conv2 + w * w + (ci * w if proj else 0)
            nbytes = px_in * ci + px * w + wbytes
            least = max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3
            tag = f"{name}/s{s}" + ("/first" if proj else "")
            out["kernels"][tag] = {"ms": ms, "roofline_pct": 100 * least / ms,
                                   "int8_peak_pct": 100 * ops / PEAK_INT8_OPS / (ms / 1e3),
                                   "conv2_padding": max(32, gw) // gw}
            log(f"[grouped] {tag}: equal to plain; {ms:.4f} ms a launch, "
                f"{100 * least / ms:.1f}% of its roofline, conv2 tiles {max(32, gw) // gw}x "
                f"its grouped MACs")
            del got, x, q
            torch.cuda.empty_cache()

    cfg = get_config("resnext101_32x8d")
    variables = tresnet.init(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((batch, 224, 224, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        eng = InferenceEngine(cfg, variables, backend="int8_chain", calib_batch=x[:8],
                              device=dev)
    eng.logits(x)
    _build.reset_launches()
    eng.logits(x)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = {"stem_pool_int8": 1, "grouped_block_int8": 30, "grouped_ds_block_s2_int8": 3,
            "matmul": 1}
    if launches != want:
        raise AssertionError(f"[grouped] ResNeXt-101 launches {launches}, expected {want}")
    ms = time_ms(lambda: eng.logits(x), 5)
    out.update(launches=launches, forward_ms=ms, images_per_s=batch * 1e3 / ms)
    log(f"[grouped] ResNeXt-101 32x8d int8_chain b{batch}: launches a forward {launches}; "
        f"{ms:.3f} ms a forward, {batch * 1e3 / ms:.1f} images/s")
    del eng
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32, help="end-to-end batch size")
    ap.add_argument("--out", default=None, help="also write all results to this JSON file")
    ap.add_argument("--artifacts", default=None, help=argparse.SUPPRESS)  # build_artifacts
    args = ap.parse_args()
    faulthandler.enable()  # a crash in native code prints the Python stack

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 1
    if args.artifacts:
        return build_artifacts(args.artifacts)
    import shutil
    import tempfile

    # No TF32 setting here: the port's fp32 ops compute in IEEE fp32
    # whatever the process's settings (torch_ops.exact_fp32).
    dev = torch.device("cuda")
    card = gpu_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # The serving artifact's exports and builds, in a child from the start:
    # they launch no kernel, so they overlap the nvcc build.
    art_dir = tempfile.mkdtemp(prefix="chip_smoke_artifacts_")
    with open(os.path.join(art_dir, "build.log"), "w") as art_log:
        art_child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--artifacts",
                                      art_dir], stdout=art_log, stderr=subprocess.STDOUT)
    try:
        return _run(args, card, dev, art_child, art_dir)
    finally:
        if art_child.poll() is None:
            art_child.kill()
            art_child.wait()
        shutil.rmtree(art_dir, ignore_errors=True)


def _run(args, card: str, dev, art_child, art_dir) -> int:
    """The phases, in order (``main``)."""
    import torch

    from resnetc_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    build_dir = _build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    log(f"[build] kernels and the ops library built in {build_s:.1f} s")
    sass = phase_sass(build_dir)
    grouped = phase_grouped(dev)
    torch.cuda.empty_cache()

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
        if name == "resnet152":
            summary["files"] = files = phase_files(e2e, cases[name], dev)
            add(files["launches"])
            options = phase_options(e2e, cases[name], dev)
            for route in options["launches"].values():
                add(route)
            runs += options.pop("routes")
            summary["options"] = options
            summary["dp_nccl1"] = nccl1 = phase_dp_nccl1(e2e, cases[name], dev)
            add(nccl1["launches"])
            dp_engine_logits = nccl1.pop("engine_logits")
        if name == "resnet34":
            summary["basic_ds_int8_off"] = off = phase_basic_ds_off(e2e, dev)
            add(off["launches"])
            runs.append(("int8_chain_basic_ds_int8_off", e2e["engine"],
                         {"BASIC_DS_INT8": False, "L1_PIXEL_PAIR": False}))
        runs += [(label, back["engines"][label], {})
                 for label in ("int8", "pallas", "pallas_block")]
        if name == "resnet152":  # the FP32 routes: the split-fp32 tile's forwards
            runs += [(label, back["engines"][label], {})
                     for label in ("int8/fp32", "pallas/fp32", "pallas_block/fp32")]
        runs.append(("fp", e2e["fp"], {}))
        engine_times[name] = phase_engine_timing(name, runs, e2e["x"], args.batch)
        for route in list(e2e["launches"].values()) + list(back["launches"].values()):
            add(route)
        summary["backends"] = {"launches": back["launches"], "gates": back["gates"]}
        summaries[name] = summary
        del e2e, back, runs
        torch.cuda.empty_cache()
    log(f"[phase] serving: {time.perf_counter() - t0:.1f} s since the start")
    summaries["reduced_routes"] = phase_reduced_routes(dev)
    for route in summaries["reduced_routes"].values():
        add(route)
    summaries["op_library"] = phase_op_library(args.batch, dev)
    add(summaries["op_library"]["launches"])
    torch.cuda.empty_cache()
    summaries["fp32"] = phase_fp32()
    tr = phase_train_resnet50(dev)
    summaries["train_split"] = phase_train_split(tr)
    summaries["train_parity"] = phase_train_parity(dev)
    torch.cuda.empty_cache()
    summaries["train_resnet152_remat"] = phase_train_remat_resnet152(dev)
    torch.cuda.empty_cache()
    served = phase_trained_served(tr, cases["resnet152"], args.batch, dev)
    add(served["launches"])
    summaries["trained_served"] = served
    summaries["train_resnet50"] = {k: v for k, v in tr.items() if k not in ("ts", "x", "y", "tcfg")}
    del tr
    torch.cuda.empty_cache()
    summaries["cli"] = phase_cli()
    summaries["verify_resnet152"] = phase_verify_resnet152()
    torch.cuda.empty_cache()
    log(f"[phase] training and verification: {time.perf_counter() - t0:.1f} s since the start")
    summaries["dp"] = dp = phase_dp_two_ranks(
        dp_engine_logits, expected_launches(cases["resnet152"], pp=True), dev)
    for route in dp["launches"]:
        add(route)
    summaries["cli_dp"] = phase_cli_dp()
    summaries["dp_serve_backends"] = dpb = phase_dp_serve_backends(card, dev)
    for route in dpb["launches"]:
        add(route)
    torch.cuda.empty_cache()
    log(f"[phase] data parallelism: {time.perf_counter() - t0:.1f} s since the start")
    t1 = time.perf_counter()
    summaries["tp"] = tps = phase_tp(card, dev)
    for route in tps["launches"]:
        add(route)
    summaries["cli_tp"] = phase_cli_tp(card)
    log(f"[phase] tp: {time.perf_counter() - t1:.1f} s")
    torch.cuda.empty_cache()
    summaries["data"] = run_data_phases(cases, args.batch, card, dev, add)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    summaries["artifact"] = art = phase_artifact(art_child, art_dir, cases, card, dev)
    for route in art["launches"]:
        add(route)
    log(f"[phase] artifact: {time.perf_counter() - t1:.1f} s")
    torch.cuda.empty_cache()
    log(f"[phase] data, cli and artifact: {time.perf_counter() - t0:.1f} s since the start")
    kernels, per_case = phase_kernel_timing(args.batch, dev, errs, launches)
    ew = phase_ew_timing(dev)
    total_s = time.perf_counter() - t0
    log(f"[done] build and all phases in {total_s:.1f} s")

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "build_s": build_s, "sass": sass, "total_s": total_s,
                       "tuned": tuned, "grouped": grouped,
                       "e2e": summaries, "engines": engine_times, "cases": per_case,
                       "kernels": kernels, "max_abs_err": errs, "elementwise": ew}, f, indent=1)
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
