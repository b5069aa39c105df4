"""The serving forwards of the ``pallas``, ``pallas_block``, ``int8`` and
``int8_chain`` backends.

Counterpart of ``resnetc_tpu/ops/pallas/fused.py``: the tunable flags and
their ``TUNED.json`` overlay (fused.py:32-211), the conv router ``_conv``
(:221), ``fused_forward`` (:260), ``fused_forward_int8`` (:372),
``calibrate_activation_scales`` (:425), ``calibrate_chain_scales`` (:497),
``quantize_chain`` (:637), ``bake_interior_scales`` (:705),
``_chain_scale_lookups`` (:802), ``_basic_int8_chain_forward`` (:821),
``_xla_bottleneck_stage`` (:1005), ``fused_forward_int8_chain`` (:1025),
``fused_forward_int8_chain_sharded`` (:1336, per-rank data parallelism)
and ``fused_forward_int8_static`` (:1397).  The flags are read at forward
time, so the engine serves what the module holds: the code defaults with
``TUNED.json`` laid over them at import (``L1_PIXEL_PAIR`` and
``BASIC_DS_INT8`` on, the JAX package's serving configuration) unless
``RESNETC_NO_TUNED=1``.

The ``pallas`` forward routes every folded conv through ``_conv``: 1x1 to
``conv1x1_fused`` (the ``matmul`` GEMM), 3x3/1 to ``conv3x3_s1_fused``,
3x3/2 to ``conv3x3_s2_fused``, the 7x7 stem to a stock convolution; the
stem's pool is ``max_pool2d`` and the head ``matmul``.  With
``block_fusion=True`` (the ``pallas_block`` backend) every run of
consecutive stride-1 bottleneck blocks without a projection is instead one
``pad_for_chain``, one ``bottleneck_block_chained`` per block and one
``unpad_from_chain`` (fused.py:288-321).  The ``int8`` forward
is the same with every 1x1 conv and the fc dynamically quantized per tensor
through ``int8_matmul``; ``fused_forward_int8_static`` takes calibrated
scales instead.

The int8_chain bottleneck forward: the 7x7 stem is a stock convolution
without its bias (XLA's in the JAX package); one kernel, ``stem_pool_int8``,
then adds the bias, applies relu, quantizes at the first block's input
scale (as the JAX package does BEFORE the 3x3/2 max pool: max commutes with
the monotone quantizer), pools and writes the chain layout, and from
there every bottleneck block is an int8 kernel — the layer1 projection
block and every identity block of stages 2-4 through
``bottleneck_block_chained_int8``, layer1 blocks 1..n-1 through
``bottleneck_run_chained_int8``, the three stride-2 transitions through
``downsample_block_s2_int8`` — and the network's last block pools in-kernel
(``emit_mean``) for the fc GEMM (``matmul``).  Under ``L1_PIXEL_PAIR`` stage
0 (c = 64) takes the pixel-paired twins instead
(``bottleneck_block_chained_int8_pp``, ``bottleneck_run_chained_int8_pp``);
under ``STAGE_FUSE_PROJ`` the whole of layer1 is one run kernel, projection
block included, standard or paired.  The kernels read the K-major weight
copies (and at c = 64 stage 0's pair-space copies and stacked run) from
the engine's tree (``pack_chain_kmajor``) where it has them, and make them
per call where it does not.

The int8_chain basic forward (ResNet-18/34) shares the stem and the chain:
the stage-0 blocks run as one ``basic_run_chained_int8``
(``basic_run_chained_int8_pp`` under ``L1_PIXEL_PAIR``), each stride-2
transition is one ``basic_ds_block_s2_int8`` under ``BASIC_DS_INT8``, or
else is dequantized and run through ``_conv`` (two 3x3 kernels and the 1x1
projection) and requantized, and every other block is one
``basic_block_chained_int8``; the last block exits bf16 and the head pools
outside the kernel, as in the JAX package.  Its stride-1 kernels read the
K-major weight copies and each stage's stacked run from the engine's tree
(``pack_chain_kmajor``) where it has them, and make them per call where it
does not.

The int8_chain grouped forward (ResNeXt, ``groups > 1``) shares the stem,
the chain, the head and the fc: every block is one
``grouped_block_int8`` (stage 0's projection block and every stride-1
block) or ``grouped_ds_block_s2_int8`` (the first block of stages 1-3),
whose conv2 is the grouped 3x3 on the int8 tile; the last block exits bf16
and the head pools outside the kernel.  The pixel-paired, run and hybrid
routes are the ungrouped nets' only.

Under ``HYBRID_XLA_STAGES`` (a prefix of the stages, off by default and
not in TUNED.json) the bottleneck forward serves those stages as stock
convolutions over the bf16 copies of the folded fp entries that
``quantize_chain`` keeps on stages 0-1 (the JAX package leaves them to
XLA), the stem's pool in the compute type, and enters the int8 chain at
the next stage's input scale.  ``calibrate_chain_scales(
per_channel_interior=True)`` gives the blocks' interior sites per-channel
scale vectors, and ``bake_interior_scales`` folds them into the quantized
weights and the producers' epilogue vectors, so the kernels are the same.

Every forward takes ``kernels=`` (``PLAIN`` runs the plain versions, the
on-card reference).
"""

from __future__ import annotations

import json
import os
import typing
from pathlib import Path

import torch

from resnetc_tpu_torch.models.resnet import ResNetConfig
from resnetc_tpu_torch.ops import torch_ops
from resnetc_tpu_torch.ops.cuda import block, conv, gemm, pool, quant
from resnetc_tpu_torch.ops.cuda.quant import quantize_per_channel, quantize_with_scale
from resnetc_tpu_torch.parallel import tp
from resnetc_tpu_torch.tensor import BF16, DtypePolicy
from resnetc_tpu_torch.utils.metrics import HEAD, STAGES, STEM, annotate

Tree = dict

#: Stages (0-based) whose identity blocks 1..n-1 run through
#: bottleneck_run_chained_int8 (the JAX package's code default).
RUN_FUSE_STAGES: tuple = (0,)

#: Stages (0-based) whose stride-1 basic blocks run as one
#: basic_run_chained_int8 (the JAX package's code default).  The run kernel
#: takes any stage.
BASIC_RUN_FUSE_STAGES: tuple = (0,)

#: Serve the basic family's stride-2 transitions through
#: basic_ds_block_s2_int8.  False (the JAX package's code default) serves
#: each transition through _conv instead — dequantize, conv3x3_s2_fused,
#: conv3x3_s1_fused with the residual, the 1x1 projection through matmul —
#: and requantizes at the next block's scale.  TUNED.json turns it on.
BASIC_DS_INT8: bool = False

#: Serve stage 0 (c = 64) through the pixel-paired kernels: two W-adjacent
#: pixels per row, the pairing carried by block-diagonal / pair-packed
#: weights (block.py's pp section).  Bit-identical to the standard route.
#: Off by default; TUNED.json turns it on.
L1_PIXEL_PAIR: bool = False

#: When stage 0 run-fuses, pull the projection block 0 into the run too:
#: all of layer1 as one run kernel (standard, or pixel-paired under
#: L1_PIXEL_PAIR).  Bit-identical to the per-block route.
STAGE_FUSE_PROJ: bool = False

#: Stages (0-based, a prefix) of a bottleneck net served as stock
#: convolutions in ``policy.compute`` (the JAX package's XLA bf16 prefix)
#: ahead of the int8 chain.  Stages 0-1 at most: ``quantize_chain`` keeps
#: the fp entries there.
HYBRID_XLA_STAGES: tuple = ()

#: The JAX package's other tunable flags, accepted with its code defaults
#: and no effect here: TPU scheduling of the same computation (the
#: transition's pair DMA and one-dot conv3, the pipelined chain DMA), or an
#: exact re-layout (STEM_CIN_PAD zero-pads the stem's input channels, which
#: tests/test_pallas.py pins exact).
STEM_CIN_PAD: int = 0
DS_PAIR_DMA: bool = False
DS_PAIR_DMA_STAGES: tuple = ()
DS_CONV3_ONEDOT: bool = False
CHAIN_PIPE_DMA: bool = False

#: The flags TUNED.json may set (fused.py:152).
_TUNABLE_FLAGS = (
    "STAGE_FUSE_PROJ",
    "STEM_CIN_PAD",
    "DS_PAIR_DMA",
    "DS_PAIR_DMA_STAGES",
    "DS_CONV3_ONEDOT",
    "BASIC_DS_INT8",
    "RUN_FUSE_STAGES",
    "BASIC_RUN_FUSE_STAGES",
    "CHAIN_PIPE_DMA",
    "HYBRID_XLA_STAGES",
    "L1_PIXEL_PAIR",
)


def _apply_tuned_defaults() -> dict:
    """Lay TUNED.json's flags over the code defaults (fused.py:167).

    Resolution order: RESNETC_NO_TUNED=1 applies nothing (the CPU test
    suite sets it, so tests pin the code defaults and opt into flags
    explicitly); else RESNETC_TUNED_JSON names the file; else
    <repo>/TUNED.json.  Keys outside _TUNABLE_FLAGS are ignored; a value
    applies only if its type is exactly the default's (a bool is not an
    int), a list becoming a tuple of ints for a tuple flag.  A malformed or
    missing file applies nothing.  Returns what was applied.
    """
    if os.environ.get("RESNETC_NO_TUNED") == "1":
        return {}
    path = os.environ.get("RESNETC_TUNED_JSON") or str(
        Path(__file__).resolve().parents[3] / "TUNED.json"
    )
    try:
        data = json.loads(Path(path).read_text())
        flags = data.get("flags") if isinstance(data, dict) else None
        if not isinstance(flags, dict):
            return {}
        applied = {}
        for k, v in flags.items():
            if k not in _TUNABLE_FLAGS:
                continue
            default = globals()[k]
            if isinstance(default, tuple) and isinstance(v, list):
                if not all(type(e) is int for e in v):
                    continue
                v = tuple(v)
            if type(v) is not type(default):
                continue
            globals()[k] = v
            applied[k] = v
        return applied
    except Exception:
        # A bad TUNED.json must never break importing the serving path.
        return {}


#: What TUNED.json set at import (empty when absent or disabled).
TUNED_DEFAULTS = _apply_tuned_defaults()

#: The flags ``fused_forward_int8_chain`` reads at forward time, and so what
#: a captured forward (``serve.InferenceEngine.classify``) is keyed on.
ROUTE_FLAGS = ("RUN_FUSE_STAGES", "BASIC_RUN_FUSE_STAGES", "BASIC_DS_INT8", "L1_PIXEL_PAIR",
               "STAGE_FUSE_PROJ", "HYBRID_XLA_STAGES")


def route_flags() -> tuple:
    """The current values of ``ROUTE_FLAGS``, in their order."""
    return tuple(globals()[k] for k in ROUTE_FLAGS)


class Kernels(typing.NamedTuple):
    """The kernels of the path.  ``KERNELS`` dispatches on the device
    (CUDA kernel for a CUDA tensor, plain version on the CPU or inside
    ``utils.debug.plain_kernels()``); ``PLAIN`` runs the plain versions
    anywhere — the on-card reference."""

    block: typing.Callable
    run: typing.Callable
    ds: typing.Callable
    matmul: typing.Callable
    basic_block: typing.Callable
    basic_run: typing.Callable
    basic_ds: typing.Callable
    block_pp: typing.Callable
    run_pp: typing.Callable
    basic_block_pp: typing.Callable
    basic_run_pp: typing.Callable
    int8_matmul: typing.Callable
    conv3x3_s1: typing.Callable
    conv_s2: typing.Callable
    max_pool: typing.Callable
    fp_block: typing.Callable
    stem_pool: typing.Callable
    grouped_block: typing.Callable
    grouped_ds: typing.Callable


KERNELS = Kernels(
    block.bottleneck_block_chained_int8,
    block.bottleneck_run_chained_int8,
    block.downsample_block_s2_int8,
    gemm.matmul,
    block.basic_block_chained_int8,
    block.basic_run_chained_int8,
    block.basic_ds_block_s2_int8,
    block.bottleneck_block_chained_int8_pp,
    block.bottleneck_run_chained_int8_pp,
    block.basic_block_chained_int8_pp,
    block.basic_run_chained_int8_pp,
    quant.int8_matmul,
    conv.conv3x3_s1_fused,
    conv.conv_s2_fused,
    pool.max_pool2d,
    block.bottleneck_block_chained,
    pool.stem_pool_int8,
    block.grouped_block_int8,
    block.grouped_ds_block_s2_int8,
)
PLAIN = Kernels(
    block.bottleneck_block_chained_int8_plain,
    block.bottleneck_run_chained_int8_plain,
    block.downsample_block_s2_int8_plain,
    gemm.matmul_plain,
    block.basic_block_chained_int8_plain,
    block.basic_run_chained_int8_plain,
    block.basic_ds_block_s2_int8_plain,
    block.bottleneck_block_chained_int8_pp_plain,
    block.bottleneck_run_chained_int8_pp_plain,
    block.basic_block_chained_int8_pp_plain,
    block.basic_run_chained_int8_pp_plain,
    quant.int8_matmul_plain,
    conv.conv3x3_s1_fused_plain,
    conv.conv_s2_fused_plain,
    pool.max_pool2d_plain,
    block.bottleneck_block_chained_plain,
    pool.stem_pool_int8_plain,
    block.grouped_block_int8_plain,
    block.grouped_ds_block_s2_int8_plain,
)


def _require_ungrouped(cfg: ResNetConfig, route: str) -> None:
    """Refuse a grouped net (ResNeXt) on a route that computes every 3x3 as
    a dense one."""
    if cfg.groups != 1:
        raise ValueError(
            f"{route} does not support grouped convolutions (ResNeXt, groups={cfg.groups}); "
            "the int8_chain and fp backends serve grouped models"
        )


def _xla_conv(x, entry, *, stride, relu, policy, groups=1):
    """A folded conv(+bias)(+relu) as a stock convolution (XLA's in the JAX
    package): the 7x7 stem, and every conv of the fp calibration passes
    (``groups``: a ResNeXt conv2)."""
    w = entry["weight"].to(policy.compute)
    y = torch_ops.conv2d(x, w, stride=stride, padding=w.shape[0] // 2, groups=groups)
    y = y + entry["bias"].to(y.dtype)
    return torch_ops.relu(y) if relu else y


def _conv(x, entry, *, stride, relu, residual=None, policy, kernels):
    """Route one folded conv (+bias+residual+relu) to a kernel: 1x1 to
    ``conv1x1_fused``, 3x3/1 to ``conv3x3_s1_fused``, 3x3/2 without a
    residual to ``conv3x3_s2_fused``, anything else (the 7x7 stem) to a
    stock convolution.  In fp32 the kernels read the entry's split (N, K)
    copy ``weight_nk`` (``pack_f32_kmajor``) where the tree has one."""
    w = entry["weight"].to(policy.compute)
    bias = entry["bias"]
    w_nk = entry.get("weight_nk") if w.dtype == torch.float32 else None
    kh, kw_ = w.shape[:2]
    if (kh, kw_) == (1, 1):
        return conv.conv1x1_fused(
            x, w, bias, residual, stride=stride, relu=relu, matmul_fn=kernels.matmul,
            w_nk=w_nk,
        )
    if (kh, kw_) == (3, 3) and stride == 1:
        return kernels.conv3x3_s1(x, w, bias, residual, relu=relu, w_nk=w_nk)
    if (kh, kw_) == (3, 3) and stride == 2 and residual is None:
        return kernels.conv_s2(x, w, bias, relu=relu, w_nk=w_nk)
    y = _xla_conv(x, entry, stride=stride, relu=False, policy=policy)
    if residual is not None:
        y = y + residual.to(y.dtype)
    return torch_ops.relu(y) if relu else y


def _fc_nk(tree: Tree, policy: DtypePolicy):
    """The fc's ``pack_f32_kmajor`` entry for the fp32 GEMM where the tree
    has one; None in bf16."""
    return tree["fc"].get("weight_nk") if policy.compute == torch.float32 else None


def pack_f32_kmajor(tree: Tree) -> Tree:
    """A copy of a folded (or ``quantize_folded``) tree with ``"weight_nk"``
    (``gemm.pack_nk``: the TF32 heads and tails of the weight's (N, K) copy,
    (2, N, K)) beside the weight of every 1x1 and 3x3 conv and of the fc
    (whose (num_classes, features) weight is the (N, K) order already):
    what the fp32 kernels of ``matmul`` and the fused convolutions read
    (TF32 wgmma takes both operands K-major), made once per engine instead
    of once per call.  The other leaves are shared, not copied."""

    def walk(node, key=None):
        if not isinstance(node, dict):
            return node
        w = node.get("weight")
        if isinstance(w, torch.Tensor) and w.ndim == 4 and w.shape[0] == w.shape[1] \
                and w.shape[0] in (1, 3):
            return {**node, "weight_nk": gemm.pack_nk(w.float())}
        if key == "fc" and isinstance(w, torch.Tensor) and w.ndim == 2:
            return {**node, "weight_nk": gemm.pack_nk(w.float().t())}
        return {k: walk(v, k) for k, v in node.items()}

    return walk(tree)


# ---------------------------------------------------------------------------
# The pallas and int8 forwards
# ---------------------------------------------------------------------------


def _residual_blocks(cfg: ResNetConfig, y, tree: Tree, conv_fn, run_fn=None, gather=None):
    """Every residual block of the network over ``tree``, each conv through
    ``conv_fn(x, entry, stride=, relu=, residual=, site=, key=)``, where
    ``site`` names the block ("layerN", "b") and ``key`` the conv.  With
    ``run_fn``, each run of consecutive stride-1 bottleneck blocks without
    a projection goes through ``run_fn(y, [block entries])`` instead.
    ``gather`` (channel tensor parallelism): every conv's input goes
    through it first, the block input's once for conv1 and the projection;
    the residual is the block input's local shard.  Ungrouped nets only."""
    _require_ungrouped(cfg, "the pallas, pallas_block, int8 and int8_static forwards")
    g = gather or tp.input_gather(None)
    for stage in range(4):
        blocks = tree[f"layer{stage + 1}"]
        stage_stride = 1 if stage == 0 else 2
        n = cfg.stage_blocks[stage]
        b = 0
        while b < n:
            blk = blocks[str(b)]
            s = stage_stride if b == 0 else 1
            if (run_fn is not None and cfg.block == "bottleneck" and s == 1
                    and "downsample" not in blk):
                run = []
                while b < n and "downsample" not in blocks[str(b)]:
                    run.append(blocks[str(b)])
                    b += 1
                y = run_fn(y, run)
                continue
            site = (f"layer{stage + 1}", str(b))
            b += 1

            def c(x, key, stride, relu, residual=None):
                return conv_fn(x, blk[key], stride=stride, relu=relu, residual=residual,
                               site=site, key=key)

            yg = g(y)
            short = c(yg, "downsample", s, False) if "downsample" in blk else y
            if cfg.block == "bottleneck":
                z = c(yg, "conv1", 1, True)
                z = c(g(z), "conv2", s, True)
                # Final 1x1: residual add and relu in the GEMM epilogue.
                y = c(g(z), "conv3", 1, True, short)
            else:
                z = c(yg, "conv1", s, True)
                y = c(g(z), "conv2", 1, True, short)
    return y


def fused_forward(
    cfg: ResNetConfig,
    folded: Tree,
    x: torch.Tensor,
    *,
    policy: DtypePolicy = BF16,
    block_fusion: bool = False,
    interpret: bool = False,
    kernels: Kernels = KERNELS,
    model_group=None,
) -> torch.Tensor:
    """The ``pallas`` backend: every conv of a BN-folded tree through
    ``_conv``, the stem's pool through ``max_pool2d``, global mean and the fc
    through ``matmul``.  ``x`` is NHWC; returns (B, num_classes) logits in
    ``policy.output``.  ``block_fusion=True`` is the ``pallas_block``
    backend: each run of stride-1 bottleneck blocks without a projection is
    padded once into the chain layout, runs one ``bottleneck_block_chained``
    per block (weights in ``policy.compute``, fp32 biases) and is unpadded
    once; a basic net takes the ``pallas`` route unchanged.

    ``model_group`` (channel tensor parallelism; not with
    ``block_fusion``): ``folded`` is this rank's shard
    (``parallel.mesh.shard_tree``) and the kernels run at shard widths, the
    stem's pool on its channel shard, each conv on its gathered input
    (``parallel.tp``), the residual fused into the last conv's epilogue on
    the block input's local shard; the logits come back whole on every
    rank.  JAX's partitioner cannot split an opaque ``pallas_call`` and runs
    each kernel whole on gathered operands: the logits are the same."""
    if model_group is not None:
        if block_fusion:
            raise ValueError("block_fusion fuses a whole block in one kernel and does not "
                             "split channels: serve pallas_block replicated over a model axis")
        tp.check_config(cfg, torch.distributed.get_world_size(model_group))
    x = x.to(policy.compute)
    y = _conv(x, folded["conv1"], stride=2, relu=True, policy=policy, kernels=kernels)
    y = kernels.max_pool(y, kernel_size=3, stride=2, padding=1)

    def conv_fn(xx, entry, *, stride, relu, residual, site, key):
        return _conv(xx, entry, stride=stride, relu=relu, residual=residual, policy=policy,
                     kernels=kernels)

    def run_fn(yy, run):
        bsz, h, w_sp, _ = yy.shape
        yr = block.pad_for_chain(yy)
        f32 = policy.compute == torch.float32
        for blk in run:
            # In fp32 the kernel reads the split (N, K) copies where the tree
            # has them (pack_f32_kmajor), as _conv does.
            nk = {f"w{i}_nk": blk[f"conv{i}"].get("weight_nk") if f32 else None
                  for i in (1, 2, 3)}
            yr = kernels.fp_block(
                yr,
                blk["conv1"]["weight"].to(policy.compute), blk["conv1"]["bias"],
                blk["conv2"]["weight"].to(policy.compute), blk["conv2"]["bias"],
                blk["conv3"]["weight"].to(policy.compute), blk["conv3"]["bias"],
                h=h, w_sp=w_sp, **nk,
            )
        return block.unpad_from_chain(yr, bsz, h, w_sp)

    y = _residual_blocks(cfg, y, folded, conv_fn, run_fn if block_fusion else None,
                         tp.input_gather(model_group))
    feats = y.float().mean(dim=(1, 2)).to(policy.compute)

    def head(f):
        return kernels.matmul(
            f,
            folded["fc"]["weight"].t().to(policy.compute).contiguous(),
            folded["fc"]["bias"],
            out_dtype=policy.output,
            w_nk=_fc_nk(folded, policy),
        )

    if model_group is None:
        return head(feats)
    return tp.fc(feats, head, cfg.num_classes, model_group)


def _conv_q(x, entry, *, stride, relu, residual=None, policy, kernels, group=None):
    """Like ``_conv``, but an int8-quantized 1x1 entry goes through the
    dynamically quantized ``conv1x1_int8`` (its scale over ``group``'s
    global batch)."""
    if "w_q" in entry:
        return quant.conv1x1_int8(
            x, entry["w_q"], entry["scale_w"], entry["bias"], residual,
            stride=stride, relu=relu, out_dtype=policy.compute, w_nk=entry.get("w_nk"),
            matmul_fn=kernels.int8_matmul, group=group,
        )
    return _conv(x, entry, stride=stride, relu=relu, residual=residual, policy=policy,
                 kernels=kernels)


def fused_forward_int8(
    cfg: ResNetConfig,
    qfolded: Tree,
    x: torch.Tensor,
    *,
    policy: DtypePolicy = BF16,
    interpret: bool = False,
    kernels: Kernels = KERNELS,
    group=None,
) -> torch.Tensor:
    """The ``int8`` backend over a ``quantize_folded`` tree: every 1x1 conv
    and the fc through ``int8_matmul`` with a per-tensor scale taken over
    the whole batch at each call, the 3x3 / 7x7 convs in ``policy.compute``
    as in ``fused_forward``.  The K-major weight copies of a
    ``quant.pack_kmajor`` tree (the engine's) go to the kernel; the logits
    do not depend on them.  ``group``: ``x`` is this rank's slice of a
    global batch split over the group's ranks, and every scale is the
    global batch's (one ``MAX`` all-reduce per quantization)."""
    x = x.to(policy.compute)
    y = _conv(x, qfolded["conv1"], stride=2, relu=True, policy=policy, kernels=kernels)
    y = kernels.max_pool(y, kernel_size=3, stride=2, padding=1)

    def conv_fn(xx, entry, *, stride, relu, residual, site, key):
        return _conv_q(xx, entry, stride=stride, relu=relu, residual=residual, policy=policy,
                       kernels=kernels, group=group)

    y = _residual_blocks(cfg, y, qfolded, conv_fn)
    feats = y.float().mean(dim=(1, 2))
    fc = qfolded["fc"]
    fq, fscale = quant.quantize_per_tensor(feats, group)
    return kernels.int8_matmul(fq, fc["w_q"], fscale, fc["scale_w"], fc["bias"],
                               out_dtype=policy.output, w_nk=fc.get("w_nk"))


def calibrate_activation_scales(
    cfg: ResNetConfig,
    folded: Tree,
    x: torch.Tensor,
    *,
    policy: DtypePolicy = BF16,
) -> Tree:
    """Static per-site activation scales (absmax / 127, at least 1e-8) for
    ``fused_forward_int8_static``: runs the fp folded forward on stock ops
    over ``x`` (NHWC) and records the input of every op the int8 path
    quantizes — each downsample, a bottleneck's conv1 and conv3 — and the
    pooled features ("fc").  Returns {layerN: {b: {site: s}}, "fc": s} of
    0-d fp32 tensors."""

    def s_of(act):
        return torch.clamp(act.float().abs().max() / 127.0, min=1e-8)

    with torch.no_grad():
        x = x.to(policy.compute)
        y = _xla_conv(x, folded["conv1"], stride=2, relu=True, policy=policy)
        y = torch_ops.max_pool2d(y, kernel_size=3, stride=2, padding=1)
        scales: Tree = {}
        for stage in range(4):
            blocks = folded[f"layer{stage + 1}"]
            stage_stride = 1 if stage == 0 else 2
            layer_scales: Tree = {}
            for b in range(cfg.stage_blocks[stage]):
                blk = blocks[str(b)]
                s = stage_stride if b == 0 else 1
                site: Tree = {}
                if "downsample" in blk:
                    site["downsample"] = s_of(y)
                    short = _xla_conv(y, blk["downsample"], stride=s, relu=False, policy=policy)
                else:
                    short = y
                if cfg.block == "bottleneck":
                    site["conv1"] = s_of(y)
                    z = _xla_conv(y, blk["conv1"], stride=1, relu=True, policy=policy)
                    z = _xla_conv(z, blk["conv2"], stride=s, relu=True, policy=policy)
                    site["conv3"] = s_of(z)
                    z = _xla_conv(z, blk["conv3"], stride=1, relu=False, policy=policy)
                else:
                    z = _xla_conv(y, blk["conv1"], stride=s, relu=True, policy=policy)
                    z = _xla_conv(z, blk["conv2"], stride=1, relu=False, policy=policy)
                y = torch_ops.relu(z + short)
                if site:
                    layer_scales[str(b)] = site
            if layer_scales:
                scales[f"layer{stage + 1}"] = layer_scales
        scales["fc"] = s_of(y.float().mean(dim=(1, 2)))
    return scales


def _conv_q_static(x, entry, scale_x, *, stride, relu, residual=None, policy, kernels):
    """An int8 1x1 conv at a calibrated activation scale (no absmax); other
    entries, or a site without a scale, as ``_conv_q``."""
    if "w_q" not in entry or scale_x is None:
        return _conv_q(x, entry, stride=stride, relu=relu, residual=residual, policy=policy,
                       kernels=kernels)
    if stride > 1:
        x = x[:, ::stride, ::stride, :]
    b, h, w_sp, cin = x.shape
    cout = entry["w_q"].shape[-1]
    x_q = quantize_with_scale(x, scale_x)
    res2d = residual.reshape(b * h * w_sp, cout) if residual is not None else None
    out = kernels.int8_matmul(
        x_q.reshape(b * h * w_sp, cin), entry["w_q"], scale_x, entry["scale_w"],
        entry["bias"], res2d, relu=relu, out_dtype=policy.compute, w_nk=entry.get("w_nk"),
    )
    return out.reshape(b, h, w_sp, cout)


def fused_forward_int8_static(
    cfg: ResNetConfig,
    qfolded: Tree,
    act_scales: Tree,
    x: torch.Tensor,
    *,
    policy: DtypePolicy = BF16,
    interpret: bool = False,
    kernels: Kernels = KERNELS,
) -> torch.Tensor:
    """``fused_forward_int8`` with the activation scales of
    ``calibrate_activation_scales`` in place of the per-call absmax (a
    bottleneck's conv2 and a basic block's convs are 3x3 and stay fp, as
    in the JAX package)."""
    x = x.to(policy.compute)
    y = _conv(x, qfolded["conv1"], stride=2, relu=True, policy=policy, kernels=kernels)
    y = kernels.max_pool(y, kernel_size=3, stride=2, padding=1)

    def conv_fn(xx, entry, *, stride, relu, residual, site, key):
        scale = act_scales.get(site[0], {}).get(site[1], {}).get(key)
        return _conv_q_static(xx, entry, scale, stride=stride, relu=relu, residual=residual,
                              policy=policy, kernels=kernels)

    y = _residual_blocks(cfg, y, qfolded, conv_fn)
    feats = y.float().mean(dim=(1, 2))
    fc = qfolded["fc"]
    fq = quantize_with_scale(feats, act_scales["fc"])
    return kernels.int8_matmul(fq, fc["w_q"], act_scales["fc"], fc["scale_w"], fc["bias"],
                               out_dtype=policy.output, w_nk=fc.get("w_nk"))


# ---------------------------------------------------------------------------
# Calibration and quantization
# ---------------------------------------------------------------------------


def _percentile(a2: torch.Tensor, pct: float) -> torch.Tensor:
    """numpy's default ("linear") percentile of each column of a (rows, C)
    tensor, through two order statistics (torch.quantile caps its input
    size): (C,)."""
    n = a2.shape[0]
    pos = (n - 1) * (pct / 100.0)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    v_lo = torch.kthvalue(a2, lo + 1, dim=0).values
    v_hi = torch.kthvalue(a2, hi + 1, dim=0).values if hi != lo else v_lo
    return v_lo + (v_hi - v_lo) * (pos - lo)


def _mse_clip(a2: torch.Tensor) -> torch.Tensor:
    """For each column of a (rows, C) tensor, the argmin over 24 clip
    candidates in [0.25, 1] x its max of the int8 quantization MSE, on a
    strided subsample of about 2^18 values in all (fused.py:539-555, and
    per channel :583-595): (C,)."""
    c = a2.shape[1]
    step = max(1, a2.shape[0] // max(1, (1 << 18) // c))
    sample = a2[::step]  # (S, C)
    hi = sample.amax(dim=0)
    cands = hi[None, :] * torch.linspace(0.25, 1.0, 24, device=a2.device)[:, None]  # (24, C)
    s = torch.clamp(cands / 127.0, min=1e-8)[:, None, :]  # (24, 1, C)
    q = torch.clamp(torch.round(sample[None] / s), -127.0, 127.0) * s
    err = ((q - sample[None]) ** 2).mean(dim=1)  # (24, C)
    return torch.gather(cands, 0, torch.argmin(err, dim=0)[None, :])[0]


def calibrate_chain_scales(
    cfg: ResNetConfig,
    folded: Tree,
    x: torch.Tensor,
    *,
    policy: DtypePolicy = BF16,
    method: str = "absmax",
    pct: float = 99.9,
    per_channel_interior: bool = False,
) -> Tree:
    """Static activation scales for the int8 block kernels.

    Runs the fp folded forward over ``x`` (NHWC) and records a range
    statistic /127 at every residual block: its input ("in"), conv1's
    post-relu output ("z1") and, for a bottleneck block, conv2's ("z2").
    Block k's output scale is block k+1's "in".  ``method``: "absmax",
    "percentile" (at ``pct``) or "mse".  Returns {layerN: {b: {"in", "z1"
    [, "z2"]}}} of 0-d fp32 tensors.

    ``per_channel_interior``: z1 and z2 (each read by one conv only) get
    (C,) vectors, one statistic per channel by the same method, for
    ``bake_interior_scales``; "in" stays a scalar.
    """
    if method not in ("absmax", "percentile", "mse"):
        raise ValueError(f"unknown calibration method {method!r}")

    def stat(act, channels: int):
        """The statistic /127 of |act| over (rows, channels) columns."""
        a2 = act.float().abs().reshape(-1, channels)
        if method == "absmax":
            v = a2.amax(dim=0)
        elif method == "percentile":
            v = _percentile(a2, pct)
        else:
            v = _mse_clip(a2)
        return torch.clamp(v / 127.0, min=1e-8)

    def s_of(act):
        return stat(act, 1)[0]

    def s_interior(act):
        return stat(act, act.shape[-1]) if per_channel_interior else s_of(act)

    with torch.no_grad():
        x = x.to(policy.compute)
        y = _xla_conv(x, folded["conv1"], stride=2, relu=True, policy=policy)
        y = torch_ops.max_pool2d(y, kernel_size=3, stride=2, padding=1)
        scales: Tree = {}
        for stage in range(4):
            blocks = folded[f"layer{stage + 1}"]
            stage_stride = 1 if stage == 0 else 2
            layer_scales: Tree = {}
            for b in range(cfg.stage_blocks[stage]):
                blk = blocks[str(b)]
                s = stage_stride if b == 0 else 1
                short = (
                    _xla_conv(y, blk["downsample"], stride=s, relu=False, policy=policy)
                    if "downsample" in blk
                    else y
                )
                if cfg.block == "bottleneck":
                    z1 = _xla_conv(y, blk["conv1"], stride=1, relu=True, policy=policy)
                    z2 = _xla_conv(z1, blk["conv2"], stride=s, relu=True, policy=policy,
                                   groups=cfg.groups)
                    layer_scales[str(b)] = {"in": s_of(y), "z1": s_interior(z1),
                                            "z2": s_interior(z2)}
                    z = _xla_conv(z2, blk["conv3"], stride=1, relu=False, policy=policy)
                else:
                    z1 = _xla_conv(y, blk["conv1"], stride=s, relu=True, policy=policy)
                    layer_scales[str(b)] = {"in": s_of(y), "z1": s_interior(z1)}
                    z = _xla_conv(z1, blk["conv2"], stride=1, relu=False, policy=policy)
                y = torch_ops.relu(z + short)
            scales[f"layer{stage + 1}"] = layer_scales
    return scales


#: The bottleneck stages whose blocks keep bf16 copies of their folded fp
#: entries beside the quantized ones, for the HYBRID_XLA_STAGES prefix.
HYBRID_KEPT_STAGES = (0, 1)
#: The folded fp entries of a block, by key.
FP_ENTRIES = ("conv1", "conv2", "conv3", "downsample")


def quantize_chain(cfg: ResNetConfig, folded: Tree) -> Tree:
    """Quantize every residual block for the int8 kernels.  Bottleneck:
    stride-1 blocks (layer1's projection block included, with its
    wdq/swd/bd) for the chain kernel, stride-2 blocks for the transition
    kernel, and on stages 0-1 bf16 copies of the block's folded fp entries
    beside them (``HYBRID_XLA_STAGES`` serves those, fused.py:688-700).
    Basic: stride-1 blocks for the basic block kernel, stride-2 blocks for
    the basic transition kernel (with their folded fp entries kept, as in
    JAX).  Grouped (ResNeXt): every block for the grouped kernels
    (``block.quantize_grouped_block``), no fp entries kept.  Other entries
    (stem, fc) pass through."""
    out = {k: v for k, v in folded.items() if not k.startswith("layer")}
    for stage in range(4):
        blocks = folded[f"layer{stage + 1}"]
        qblocks = {}
        for b_str, blk in blocks.items():
            if cfg.groups > 1:
                qblocks[b_str] = block.quantize_grouped_block(blk)
                continue
            if cfg.block != "bottleneck":
                transition = b_str == "0" and stage > 0
                qblocks[b_str] = (
                    block.quantize_basic_ds_block(blk) if transition
                    else block.quantize_basic_block(blk)
                )
                continue
            if b_str == "0" and stage > 0:
                qblocks[b_str] = block.quantize_ds_block(blk)
                continue
            q = block.quantize_chain_block(blk)
            if "downsample" in blk:  # layer1 block 0: stride-1 projection
                wd = blk["downsample"]["weight"]
                q["wdq"], q["swd"] = quantize_per_channel(wd[0, 0] if wd.ndim == 4 else wd)
                q["bd"] = blk["downsample"]["bias"]
            qblocks[b_str] = q
        if cfg.block == "bottleneck" and cfg.groups == 1 and stage in HYBRID_KEPT_STAGES:
            for b_str, blk in blocks.items():
                qblocks[b_str].update(_bf16_entries(blk))
        out[f"layer{stage + 1}"] = qblocks
    return out


def _bf16_entries(blk: dict) -> dict:
    """bf16 copies of a block's folded fp entries (fp32 biases)."""
    return {k: {"weight": blk[k]["weight"].to(torch.bfloat16), "bias": blk[k]["bias"]}
            for k in FP_ENTRIES if k in blk}


def bake_interior_scales(cfg: ResNetConfig, folded: Tree, scales_pc: Tree) -> tuple[Tree, Tree]:
    """Fold per-channel interior scales into host constants (fused.py:705).

    ``scales_pc`` is ``calibrate_chain_scales(per_channel_interior=True)``'s:
    z1 / z2 vectors, "in" scalars.  Each interior site has one producer and
    one consumer, so its vector folds away: the consumer's weights are
    scaled along their input channels before quantization (the scale rides
    in the int8 values and their per-output-channel scales), the
    producer's epilogue vectors are divided by it per output channel, and
    the runtime scale there is 1.  The fp entries kept beside the quantized
    ones (the hybrid prefix's, the basic transitions') are restored
    un-scaled.  Returns (quantized tree, runtime scales); the kernels are
    the same."""
    one = torch.ones((), dtype=torch.float32, device=scales_pc["layer1"]["0"]["in"].device)

    def prescale(entry, vec):
        # The input-channel axis is -2 of a (cin, cout) and an HWIO weight;
        # of a grouped (3, 3, gw, W) weight, output n's input i is channel
        # (n // gw) * gw + i of the vector.
        w = entry["weight"]
        gw = w.shape[-2]
        if gw != vec.shape[0]:
            vec = vec.reshape(-1, gw).t().repeat_interleave(gw, dim=1)  # (gw, W)
            return {"weight": w * vec, "bias": entry["bias"]}
        return {"weight": w * vec[:, None], "bias": entry["bias"]}

    folded2 = {k: v for k, v in folded.items() if not k.startswith("layer")}
    runtime: Tree = {}
    bottleneck = cfg.block == "bottleneck"
    for stage in range(4):
        name = f"layer{stage + 1}"
        f2b, rb = {}, {}
        for b_str, blk in folded[name].items():
            st = scales_pc[name][b_str]
            blk2 = dict(blk)
            blk2["conv2"] = prescale(blk["conv2"], st["z1"])
            rb[b_str] = {"in": st["in"], "z1": one}
            if bottleneck:
                blk2["conv3"] = prescale(blk["conv3"], st["z2"])
                rb[b_str]["z2"] = one
            f2b[b_str] = blk2
        folded2[name] = f2b
        runtime[name] = rb

    qtree = quantize_chain(cfg, folded2)

    # The producers' epilogue vectors, and the fp entries restored.
    for stage in range(4):
        name = f"layer{stage + 1}"
        for b_str, q in qtree[name].items():
            st = scales_pc[name][b_str]
            orig = folded[name][b_str]
            if bottleneck:
                q["sw1"] = q["sw1"] / st["z1"]
                q["b1"] = q["b1"] / st["z1"]
                if "sw2p" in q:  # stride-1 block: conv2's scales per (kh, j)
                    q["sw2p"] = q["sw2p"] / st["z2"].repeat(3)
                else:  # transition, grouped block: joint per-j scales over the nine taps
                    q["sw2"] = q["sw2"] / st["z2"]
                q["b2"] = q["b2"] / st["z2"]
                if stage in HYBRID_KEPT_STAGES and cfg.groups == 1:
                    q.update(_bf16_entries(orig))
            elif "wdq" in q:  # basic transition: conv1's joint per-j scales
                q["sw1"] = q["sw1"] / st["z1"]
                q["b1"] = q["b1"] / st["z1"]
                q.update({k: orig[k] for k in FP_ENTRIES if k in orig})
            else:  # basic stride-1 block: conv1's scales per (kh, j)
                q["sw1p"] = q["sw1p"] / st["z1"].repeat(3)
                q["b1"] = q["b1"] / st["z1"]
    return qtree, runtime


#: The weights of a bottleneck block that the int8 tile reads, and the keys
#: of their K-major copies (a transition's 3x3 ``w2q`` as its (9c, c) matrix).
KMAJOR_KEYS = {"w1q": "w1q_nk", "w2pq": "w2pq_nk", "w2q": "w2q_nk", "w3q": "w3q_nk",
               "wdq": "wdq_nk"}
#: The 1x1 weights of a grouped block and the keys of their K-major copies.
GROUPED_KMAJOR_KEYS = {"w1q": "w1q_nk", "w3q": "w3q_nk", "wdq": "wdq_nk"}
#: The per-block keys of a grouped block's operands, in the kernels' order.
GROUPED_KEYS = ("w1q", "sw1", "b1", "w2q", "sw2", "b2", "w3q", "sw3", "b3")
#: The keys of the K-major copies of a pixel-paired block's pair-space weights.
PP_KMAJOR_KEYS = ("w1bd_nk", "w2pp_nk", "w3bd_nk", "wdbd_nk")
#: The per-block keys of a bottleneck block's operands, in the kernels' order.
KEYS = ("w1q", "sw1", "b1", "w2pq", "sw2p", "b2", "w3q", "sw3", "b3")


def pack_chain_kmajor(cfg: ResNetConfig, qtree: Tree) -> Tree:
    """A copy of a ``quantize_chain`` tree with what the int8 tile reads
    made once per engine instead of once per call.  Bottleneck: beside each
    block's weights their contiguous K-major (N, K) copies (8-bit wgmma
    takes both operands K-major), ``w1q_nk``, ``w2pq_nk`` (row kh*c + j:
    output j of kernel row kh) or a transition's ``w2q_nk`` (c, 9c),
    ``w3q_nk`` and ``wdq_nk``; and at c = 64 stage 0's pixel-paired
    operands (``_pack_pp_stage0``).  Grouped: the 1x1s' copies and the
    grouped 3x3's (W, 9 bn) copy ``w2g_nk`` (``block.pack_grouped_nk``).
    Basic: see ``_pack_basic``.  Other entries are shared, not copied."""
    if cfg.block != "bottleneck":
        return _pack_basic(qtree)
    out = dict(qtree)
    copies = grouped_kmajor_copies if cfg.groups > 1 else kmajor_copies
    for stage in range(4):
        name = f"layer{stage + 1}"
        out[name] = {b: {**blk, **copies(blk)} for b, blk in qtree[name].items()}
    if cfg.groups == 1 and out["layer1"]["0"]["w1q"].shape[-1] == 64:
        out["layer1"], out["runs"] = _pack_pp_stage0(out["layer1"])
    return out


def _pack_pp_stage0(layer: dict) -> tuple[dict, dict]:
    """Stage 0's pixel-paired operands (c = 64) for ``pack_chain_kmajor``:
    the K-major copies of each block's pair-space weights (``w1bd_nk``,
    ``w2pp_nk``, ``w3bd_nk``, and ``wdbd_nk`` on a projection block: the
    block-diagonal 1x1s, the pair-packed 3x3), and the stage's run stacked
    once, under ``"runs"`` / ``"layer1"``: every block's vectors, ``w2pq``,
    ``w3q`` and their pair copies (``sw1_s`` ... ``b3_s``, ``w2pp_nk_s``,
    ``w3bd_nk_s``), and the conv1 of blocks 1.. (``w1q_s``, ``w1bd_nk_s``).
    A run over blocks i.. reads the slices [i:]; each block's copies are
    views of the stacks, block 0's conv1 and projection copies its own."""
    ids = sorted(layer, key=int)
    blocks = [layer[b] for b in ids]
    run = {k + "_s": _stack(blocks, k) for k in KEYS[1:]}
    run["w2pp_nk_s"] = block._pp_pack_conv2(run["w2pq_s"], 64).transpose(-1, -2).contiguous()
    run["w3bd_nk_s"] = block._pp_block_diag(run["w3q_s"].transpose(-1, -2)).contiguous()
    if len(blocks) > 1:
        run["w1q_s"] = _stack(blocks[1:], "w1q")
        run["w1bd_nk_s"] = block._pp_block_diag(run["w1q_s"].transpose(-1, -2)).contiguous()
    out = {}
    for i, (b, blk) in enumerate(zip(ids, blocks)):
        pair = {"w2pp_nk": run["w2pp_nk_s"][i], "w3bd_nk": run["w3bd_nk_s"][i],
                "w1bd_nk": run["w1bd_nk_s"][i - 1] if i
                else block._pp_block_diag(blk["w1q"].t()).contiguous()}
        if "wdq" in blk:
            pair["wdbd_nk"] = block._pp_block_diag(blk["wdq"].t()).contiguous()
        out[b] = {**blk, **pair}
    return out, {"layer1": run}


def pp_run_operands(blocks: list, packed: dict | None, first: int) -> tuple[list, dict]:
    """The stacked operands (``KEYS``; conv1 of blocks 1.. only, block 0's
    coming in as ``w1q0``) of a pixel-paired run over stage 0's blocks
    ``first``.. (``blocks``: all of the stage), and the K-major copies of
    its pair-space weights as keyword arguments: slices of the engine's
    stacks (``_pack_pp_stage0``) where the tree has them, else stacked here
    (the wrapper then packs once)."""
    if packed is None:
        return [_stack(blocks[1:], "w1q"), *(_stack(blocks[first:], k) for k in KEYS[1:])], {}
    args = [packed["w1q_s"], *(packed[k + "_s"][first:] for k in KEYS[1:])]
    kw = {"w1bd_nk_s": packed["w1bd_nk_s"], "w2pp_nk_s": packed["w2pp_nk_s"][first:],
          "w3bd_nk_s": packed["w3bd_nk_s"][first:]}
    if first == 0:
        kw.update(w10bd_nk=blocks[0]["w1bd_nk"], wdbd_nk=blocks[0]["wdbd_nk"])
    return args, kw


#: The per-block keys of a basic run's operands, in the kernels' order.
BASIC_KEYS = ("w1pq", "sw1p", "b1", "w2pq", "sw2p", "b2")


def basic_ds_kmajor_copies(blk: dict) -> dict:
    """The K-major copies of a basic transition's weights, by their keys:
    ``w1pq_nk`` (c, 9cin), conv1 without the zero rows of its (3, 4cin, c)
    packing (``block.basic_ds_w1``), ``w2pq_nk`` (3c, 3c), ``wdq_nk`` (c,
    cin)."""
    return {"w1pq_nk": block.basic_ds_w1(blk["w1pq"]).t().contiguous(),
            "w2pq_nk": blk["w2pq"].t().contiguous(), "wdq_nk": blk["wdq"].t().contiguous()}


def _pack_basic(qtree: Tree) -> Tree:
    """``pack_chain_kmajor`` for the basic family.  Each stage transition
    gets its K-major copies beside its weights (``basic_ds_kmajor_copies``).
    Each stage's stride-1 blocks (all of stage 0, blocks 1.. of the others:
    the blocks of the stage's run) are stacked once, under ``"runs"`` /
    ``"layer<s>"``: the K-major copies ``w1pq_nk_s`` / ``w2pq_nk_s`` of the
    kh-batched 3x3s, their vectors ``sw1p_s``, ``b1_s``, ``sw2p_s``,
    ``b2_s``, and for stage 0 at c = 64 (the pixel-paired width)
    ``w1pp_nk_s`` / ``w2pp_nk_s``, the K-major copies of the pair-packed
    (6c, 6c) 3x3s.  Each block gets its slice of the K-major stacks beside
    its weights (``w1pq_nk``, ``w2pq_nk``, ``w1pp_nk``, ``w2pp_nk``: views,
    not copies)."""
    out, runs = dict(qtree), {}
    for stage in range(4):
        name = f"layer{stage + 1}"
        layer = dict(qtree[name])
        for b, blk in layer.items():
            if "wdq" in blk:  # the stage transition
                layer[b] = {**blk, **basic_ds_kmajor_copies(blk)}
        out[name] = layer
        ids = sorted((b for b, blk in layer.items() if "sw1p" in blk), key=int)  # stride 1
        if not ids:
            continue
        blocks = [layer[b] for b in ids]
        run = {k + "_s": _stack(blocks, k) for k in BASIC_KEYS if not k.startswith("w")}
        c = run["b1_s"].shape[-1]
        for k in ("w1pq", "w2pq"):
            wq_s = _stack(blocks, k)
            run[k + "_nk_s"] = wq_s.transpose(-1, -2).contiguous()
            if stage == 0 and c == 64:
                pp = "w1pp" if k == "w1pq" else "w2pp"
                run[pp + "_nk_s"] = block._pp_pack_conv2(wq_s, c).transpose(-1, -2).contiguous()
        nk = {k[: -len("_s")]: v for k, v in run.items() if k.endswith("_nk_s")}
        for i, b in enumerate(ids):
            layer[b] = {**layer[b], **{k: v[i] for k, v in nk.items()}}
        runs[name] = run
    out["runs"] = runs
    return out


def _basic_run_operands(run: list, packed: dict | None, pp: bool) -> tuple[list, dict]:
    """The stacked operands of a basic run (``BASIC_KEYS``) and the K-major
    copies as keyword arguments: the engine's (``_pack_basic``) where the
    tree has them, the (K, N) weights then their transposed views; else
    stacked here (the wrapper then transposes, or packs, once)."""
    if packed is None:
        return [_stack(run, k) for k in BASIC_KEYS], {}
    args = [packed[k + "_nk_s"].transpose(-1, -2) if k.startswith("w") else packed[k + "_s"]
            for k in BASIC_KEYS]
    keys = ("w1pp_nk_s", "w2pp_nk_s") if pp else ("w1pq_nk_s", "w2pq_nk_s")
    return args, {k: packed[k] for k in keys if k in packed}


def _basic_kmajor_kwargs(blk: dict, pp: bool) -> dict:
    """The K-major copies a basic block carries for its kernel (the pair
    ones for the pixel-paired kernel), as keyword arguments."""
    keys = ("w1pp_nk", "w2pp_nk") if pp else ("w1pq_nk", "w2pq_nk")
    return {k: blk[k] for k in keys if k in blk}


def grouped_kmajor_copies(blk: dict) -> dict:
    """The copies a grouped block's kernel reads, by their keys: the 1x1s'
    K-major copies and the grouped 3x3's ``w2g_nk``."""
    return {**{nk: blk[k].t().contiguous() for k, nk in GROUPED_KMAJOR_KEYS.items() if k in blk},
            "w2g_nk": block.pack_grouped_nk(blk["w2q"])}


def kmajor_copies(blk: dict) -> dict:
    """The K-major copies of one block's weights, by their keys."""
    return {nk: blk[k].reshape(-1, blk[k].shape[-1]).t().contiguous()
            for k, nk in KMAJOR_KEYS.items() if k in blk}


def kmajor_kwargs(blk: dict, pp: bool = False) -> dict:
    """The K-major copies a block carries for its kernel (the pair-space
    ones for the pixel-paired kernel), as keyword arguments."""
    return {nk: blk[nk] for nk in (PP_KMAJOR_KEYS if pp else KMAJOR_KEYS.values()) if nk in blk}


def kmajor_run_kwargs(run: list, proj: bool) -> dict:
    """The stacked K-major copies of a run's blocks (block 0's w1q and wdq
    apart when it is the projection block), where every block has them."""
    if not all("w1q_nk" in blk for blk in run):
        return {}
    kw = {"w1q_nk_s": _stack(run[1:] if proj else run, "w1q_nk"),
          "w2pq_nk_s": _stack(run, "w2pq_nk"), "w3q_nk_s": _stack(run, "w3q_nk")}
    if proj:
        kw.update(w1q0_nk=run[0]["w1q_nk"], wdq_nk=run[0]["wdq_nk"])
    return kw


def _chain_scale_lookups(cfg: ResNetConfig, chain_scales: Tree):
    """(scale_row, s_after): block k's output scale is block k+1's "in",
    across stage boundaries too; s_after is None at the network tail.
    scale_row(stage, b) is the (4,) [s_x, s_z1, s_z2, s_y] of a bottleneck
    block or the (3,) [s_x, s_z1, s_y] of a basic block, s_y = 1 at the
    tail."""
    keys = ("in", "z1", "z2") if cfg.block == "bottleneck" else ("in", "z1")

    def site(stage, b):
        return chain_scales[f"layer{stage + 1}"][str(b)]

    def s_after(stage, b):
        if b + 1 < cfg.stage_blocks[stage]:
            return site(stage, b + 1)["in"]
        if stage + 1 < 4:
            return site(stage + 1, 0)["in"]
        return None

    def scale_row(stage, b):
        st = site(stage, b)
        s_y = s_after(stage, b)
        if s_y is None:
            s_y = torch.ones((), dtype=torch.float32, device=st["in"].device)
        return torch.stack([*(st[k] for k in keys), s_y]).float()

    return scale_row, s_after


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------


def _stem_chain(qtree: Tree, x: torch.Tensor, s_in: torch.Tensor, policy: DtypePolicy,
                kernels: Kernels):
    """Stem conv without its bias, then ``kernels.stem_pool``: bias, relu,
    quantize at the first block's input scale, 3x3/2 max pool, chain pad.
    Returns (chain rows, B, h, w)."""
    x = x.to(policy.compute)
    w = qtree["conv1"]["weight"].to(policy.compute)
    y = torch_ops.conv2d(x, w, stride=2, padding=w.shape[0] // 2).contiguous()
    h, w_sp, _, _ = pool.stem_pool_geometry(y)
    return kernels.stem_pool(y, qtree["conv1"]["bias"], s_in), y.shape[0], h, w_sp


def _head(qtree: Tree, feats: torch.Tensor, policy: DtypePolicy, kernels: Kernels):
    return kernels.matmul(
        feats,
        qtree["fc"]["weight"].t().to(policy.compute).contiguous(),
        qtree["fc"]["bias"],
        out_dtype=policy.output,
        w_nk=_fc_nk(qtree, policy),
    )


def _mean_feats(yr, bsz, h, w_sp, policy):
    y = block.unpad_from_chain(yr, bsz, h, w_sp)
    return y.float().mean(dim=(1, 2)).to(policy.compute)


def _tap(stage_taps, yr, bsz, h, w_sp, s_out):
    if stage_taps is not None:
        tap = block.unpad_from_chain(yr, bsz, h, w_sp).float()
        stage_taps.append(tap * s_out if s_out is not None else tap)


def _stack(blocks: list, key: str) -> torch.Tensor:
    return torch.stack([blk[key] for blk in blocks])


def _hybrid_stages(qtree: Tree) -> tuple:
    """HYBRID_XLA_STAGES, checked (fused.py:1074-1087): a contiguous prefix
    of the stages, each holding the fp entries ``quantize_chain`` keeps."""
    stages = tuple(HYBRID_XLA_STAGES)
    if stages != tuple(range(len(stages))):
        raise ValueError(f"HYBRID_XLA_STAGES must be a contiguous prefix, got {stages}")
    if any("conv1" not in qtree[f"layer{s + 1}"]["0"] for s in stages):
        raise ValueError(
            "HYBRID_XLA_STAGES needs the folded fp entries quantize_chain "
            f"keeps on stages 0-1; got stages {stages}"
        )
    return stages


def _xla_bottleneck_stage(y, blocks: dict, nb: int, *, stride: int, policy: DtypePolicy):
    """One bottleneck stage as stock convolutions over the fp entries kept
    on stages 0-1 (fused.py:1005; ``resnet.forward_folded``'s math)."""
    for b in range(nb):
        blk = blocks[str(b)]
        s = stride if b == 0 else 1
        z = _xla_conv(y, blk["conv1"], stride=1, relu=True, policy=policy)
        z = _xla_conv(z, blk["conv2"], stride=s, relu=True, policy=policy)
        z = _xla_conv(z, blk["conv3"], stride=1, relu=False, policy=policy)
        short = (_xla_conv(y, blk["downsample"], stride=s, relu=False, policy=policy)
                 if "downsample" in blk else y)
        y = torch_ops.relu(torch_ops.add(z, short))
    return y


def _hybrid_chain(cfg: ResNetConfig, qtree: Tree, chain_scales: Tree, x: torch.Tensor,
                  stages: tuple, policy: DtypePolicy, stage_taps: list | None):
    """The HYBRID_XLA_STAGES prefix (fused.py:1092-1104): stem, the pool in
    the compute type, the listed stages as stock convolutions (a tap after
    each), then quantize at the next stage's input scale and pad into the
    chain.  Returns (chain rows, B, h, w)."""
    y = _xla_conv(x.to(policy.compute), qtree["conv1"], stride=2, relu=True, policy=policy)
    y = torch_ops.max_pool2d(y, kernel_size=3, stride=2, padding=1)
    for stage in stages:
        y = _xla_bottleneck_stage(y, qtree[f"layer{stage + 1}"], cfg.stage_blocks[stage],
                                  stride=1 if stage == 0 else 2, policy=policy)
        if stage_taps is not None:
            stage_taps.append(y.float())
    yq = quantize_with_scale(y, chain_scales[f"layer{len(stages) + 1}"]["0"]["in"])
    bsz, h, w_sp, _ = yq.shape
    return block.pad_for_chain(yq), bsz, h, w_sp


def fused_forward_int8_chain(
    cfg: ResNetConfig,
    qtree: Tree,
    chain_scales: Tree,
    x: torch.Tensor,
    *,
    policy: DtypePolicy = BF16,
    stage_taps: list | None = None,
    kernels: Kernels = KERNELS,
) -> torch.Tensor:
    """Serving forward with every residual block as an int8 kernel call.
    ``x`` is NHWC; returns (B, num_classes) logits in ``policy.output``.
    Basic configs (ResNet-18/34) go through ``_basic_int8_chain_forward``
    (which ignores HYBRID_XLA_STAGES, as in the JAX package).  Under
    HYBRID_XLA_STAGES the listed stages run ahead of the chain
    (``_hybrid_chain``) and the chain starts at the next one.

    ``stage_taps``: pass a list to receive the dequantized fp32 NHWC
    activation after each stage (then the tail block exits bf16 and the
    head pools outside the kernel, as in the JAX package).  ``kernels``
    picks the implementations (``PLAIN`` for the on-card reference).

    Under a running profiler the stem (with any hybrid prefix), each stage
    and the head are spans (``utils.metrics.STEM``, ``STAGES``, ``HEAD``),
    on the basic and grouped forwards too.
    """
    if cfg.groups > 1:
        return _grouped_int8_chain_forward(
            cfg, qtree, chain_scales, x, policy=policy, stage_taps=stage_taps, kernels=kernels,
        )
    if cfg.block != "bottleneck":
        return _basic_int8_chain_forward(
            cfg, qtree, chain_scales, x, policy=policy, stage_taps=stage_taps, kernels=kernels,
        )
    scale_row, s_after = _chain_scale_lookups(cfg, chain_scales)
    xla_stages = _hybrid_stages(qtree)
    with annotate(STEM):
        if xla_stages:
            yr, bsz, h, w_sp = _hybrid_chain(cfg, qtree, chain_scales, x, xla_stages, policy,
                                             stage_taps)
        else:
            yr, bsz, h, w_sp = _stem_chain(qtree, x, chain_scales["layer1"]["0"]["in"], policy,
                                           kernels)
    packed_pp = qtree.get("runs", {}).get("layer1")  # stage 0's pair operands, if packed

    head_folded = False
    for stage in range(len(xla_stages), 4):
        with annotate(STAGES[stage]):
            blocks = qtree[f"layer{stage + 1}"]
            nb = cfg.stage_blocks[stage]

            # Whole-stage fusion (stage 0 only, fused.py:1125-1179): the
            # projection block 0 joins the identity run, all of layer1 one
            # kernel; the pixel-paired form under L1_PIXEL_PAIR at c = 64.
            stage_fused = False
            if stage == 0 and nb > 1 and stage in RUN_FUSE_STAGES and STAGE_FUSE_PROJ:
                blk0 = blocks["0"]
                if "wdq" in blk0:
                    _, wp = block.chain_meta(0, h, w_sp)
                    c = blocks["1"]["w1q"].shape[-1]
                    use_pp = L1_PIXEL_PAIR and c == 64 and wp % 2 == 0
                    run = [blocks[str(i)] for i in range(nb)]
                    if use_pp:
                        args, nk = pp_run_operands(run, packed_pp, 0)
                    else:
                        args = [_stack(run[1:], "w1q"), *(_stack(run, k) for k in KEYS[1:])]
                        nk = kmajor_run_kwargs(run, proj=True)
                    yr = (kernels.run_pp if use_pp else kernels.run)(
                        yr, *args,
                        torch.stack([scale_row(stage, i) for i in range(nb)]),
                        h=h, w_sp=w_sp, emit_i8=s_after(stage, nb - 1) is not None,
                        w1q0=blk0["w1q"], wdq=blk0["wdq"], swd=blk0["swd"], bd=blk0["bd"], **nk,
                    )
                    stage_fused = True

            if not stage_fused:
                blk = blocks["0"]
                last0 = s_after(stage, 0) is None
                if stage > 0:
                    yr = kernels.ds(
                        yr,
                        blk["w1q"], blk["sw1"], blk["b1"],
                        blk["w2q"], blk["sw2"], blk["b2"],
                        blk["w3q"], blk["sw3"], blk["b3"],
                        blk["wdq"], blk["swd"], blk["bd"],
                        scale_row(stage, 0),
                        h=h, w_sp=w_sp, emit_i8=not last0, **kmajor_kwargs(blk),
                    )
                    h, w_sp = (h + 1) // 2, (w_sp + 1) // 2
                else:
                    # Pixel-paired only at c = 64: wide variants run stage 0 at
                    # c >= 128 through the standard kernel.
                    pp0 = L1_PIXEL_PAIR and blk["w1q"].shape[-1] == 64
                    yr = (kernels.block_pp if pp0 else kernels.block)(
                        yr,
                        *(blk[k] for k in KEYS),
                        scale_row(stage, 0),
                        h=h, w_sp=w_sp, emit_i8=not last0,
                        wdq=blk.get("wdq"), swd=blk.get("swd"), bd=blk.get("bd"),
                        **kmajor_kwargs(blk, pp=pp0),
                    )

                # Blocks 1..nb-1: one run kernel, or per block.  Under
                # L1_PIXEL_PAIR a stage 0 at c != 64 takes no run fusion
                # (fused.py:1250).  The JAX package also falls back to per-block
                # kernels when a run would not fit VMEM; the card has no such
                # limit.
                use_run = False
                pp_stage = stage == 0 and L1_PIXEL_PAIR
                if nb > 1 and stage in RUN_FUSE_STAGES:
                    if pp_stage:
                        _, wp = block.chain_meta(0, h, w_sp)
                        use_run = blocks["1"]["w1q"].shape[-1] == 64 and wp % 2 == 0
                    else:
                        use_run = True
                if use_run:
                    run = [blocks[str(i)] for i in range(1, nb)]
                    if pp_stage:
                        args, nk = pp_run_operands([blocks["0"], *run], packed_pp, 1)
                    else:
                        args = [_stack(run, k) for k in KEYS]
                        nk = kmajor_run_kwargs(run, proj=False)
                    yr = (kernels.run_pp if pp_stage else kernels.run)(
                        yr, *args,
                        torch.stack([scale_row(stage, i) for i in range(1, nb)]),
                        h=h, w_sp=w_sp, emit_i8=s_after(stage, nb - 1) is not None, **nk,
                    )
                else:
                    for i in range(1, nb):
                        blk = blocks[str(i)]
                        last_i = s_after(stage, i) is None
                        # Head fold on the tail block (not when taps are asked
                        # for): the kernel emits (B, 4c) pooled features.
                        fold_head = last_i and stage_taps is None
                        args = (yr, *(blk[k] for k in KEYS), scale_row(stage, i))
                        if pp_stage and not fold_head and blk["w1q"].shape[-1] == 64:
                            yr = kernels.block_pp(*args, h=h, w_sp=w_sp, emit_i8=not last_i,
                                                  **kmajor_kwargs(blk, pp=True))
                        else:
                            yr = kernels.block(*args, h=h, w_sp=w_sp, emit_i8=not last_i,
                                               emit_mean=fold_head, **kmajor_kwargs(blk))
                            head_folded = head_folded or fold_head

            _tap(stage_taps, yr, bsz, h, w_sp, s_after(stage, nb - 1))

    with annotate(HEAD):
        if head_folded:
            feats = yr.to(policy.compute)  # (B, 4c): pooled in-kernel
        else:
            feats = _mean_feats(yr, bsz, h, w_sp, policy)
        return _head(qtree, feats, policy, kernels)


def _grouped_int8_chain_forward(
    cfg: ResNetConfig,
    qtree: Tree,
    chain_scales: Tree,
    x: torch.Tensor,
    *,
    policy: DtypePolicy,
    stage_taps: list | None,
    kernels: Kernels,
) -> torch.Tensor:
    """``fused_forward_int8_chain`` for a grouped net (ResNeXt): the stem
    into the chain, every block one grouped kernel (the transition's at the
    first block of stages 1-3), the last exiting bf16, then the head pool
    and the fc."""
    if HYBRID_XLA_STAGES:
        raise ValueError("HYBRID_XLA_STAGES serves ungrouped bottleneck nets only; a grouped "
                         "net enters the int8 chain at the stem")
    scale_row, s_after = _chain_scale_lookups(cfg, chain_scales)
    with annotate(STEM):
        yr, bsz, h, w_sp = _stem_chain(qtree, x, chain_scales["layer1"]["0"]["in"], policy,
                                       kernels)
    for stage in range(4):
        with annotate(STAGES[stage]):
            blocks = qtree[f"layer{stage + 1}"]
            nb = cfg.stage_blocks[stage]
            for i in range(nb):
                blk = blocks[str(i)]
                args = (yr, *(blk[k] for k in GROUPED_KEYS))
                kw = dict(h=h, w_sp=w_sp, emit_i8=s_after(stage, i) is not None,
                          w1q_nk=blk.get("w1q_nk"), w2g_nk=blk.get("w2g_nk"),
                          w3q_nk=blk.get("w3q_nk"), wdq_nk=blk.get("wdq_nk"))
                if stage > 0 and i == 0:
                    yr = kernels.grouped_ds(*args, blk["wdq"], blk["swd"], blk["bd"],
                                            scale_row(stage, 0), **kw)
                    h, w_sp = (h + 1) // 2, (w_sp + 1) // 2
                else:
                    yr = kernels.grouped_block(*args, scale_row(stage, i), wdq=blk.get("wdq"),
                                               swd=blk.get("swd"), bd=blk.get("bd"), **kw)
            _tap(stage_taps, yr, bsz, h, w_sp, s_after(stage, nb - 1))
    with annotate(HEAD):
        return _head(qtree, _mean_feats(yr, bsz, h, w_sp, policy), policy, kernels)


def fused_forward_int8_chain_sharded(
    cfg: ResNetConfig,
    qtree: Tree,
    chain_scales: Tree,
    x: torch.Tensor,
    mesh,
    *,
    policy: DtypePolicy = BF16,
    kernels: Kernels = KERNELS,
) -> torch.Tensor:
    """Data-parallel ``int8_chain`` serving over ``mesh``'s data axis;
    counterpart of the JAX ``fused_forward_int8_chain_sharded``
    (fused.py:1336).  Every rank holds the quantized tree and the scales
    (replicated), takes the global batch ``x``, runs
    ``fused_forward_int8_chain`` on its slice, and the logits are gathered
    in rank order: every rank returns the global (B, num_classes) logits,
    JAX's ``out_specs=P(axis)`` read as one array.  No collective but the
    gather.  A batch the data axis does not divide raises JAX's
    ``shard_map`` error."""
    from resnetc_tpu_torch.parallel import distributed
    from resnetc_tpu_torch.parallel import mesh as pmesh

    n = pmesh.axis_sizes(mesh)[pmesh.DATA_AXIS]
    if x.shape[0] % n:
        raise ValueError(_undivided_batch(x.shape[0], n))
    group = pmesh.data_group(mesh)
    local = pmesh.batch_sharding(mesh)(x)
    logits = fused_forward_int8_chain(cfg, qtree, chain_scales, local, policy=policy,
                                      kernels=kernels)
    return distributed.host_local_to_global(logits, group)


#: The backends ``fused_forward_sharded`` serves: the engine's five and
#: ``int8_static`` (``fused_forward_int8_static`` with its calibrated scales).
SHARDED_BACKENDS = ("fp", "pallas", "pallas_block", "int8", "int8_static", "int8_chain")


def _undivided_batch(b: int, n: int) -> str:
    """JAX's ``shard_map`` error for a batch the data axis does not divide
    (``fused_forward_int8_chain_sharded``'s ``in_specs=P('data')``)."""
    return (
        "shard_map applied to the function 'body' was given argument arrays with axis "
        "sizes that are not evenly divisible by the corresponding mesh axis sizes: "
        f"array axis 0 (of size {b}) maps to mesh axis 'data' (of size {n}), but {n} "
        f"does not evenly divide {b}"
    )


#: The backends that split channels over a model axis; ``pallas_block``
#: replicates over it, and the int8 backends refuse it.
TP_BACKENDS = ("fp", "pallas")


def model_axis_refusal(backend: str, ranks: int) -> str:
    """Why an int8 backend takes no model axis > 1.  ``int8_chain``: JAX's
    CLI wording (``resnetc_tpu/__main__.py:51-59``).  ``int8`` /
    ``int8_static``: JAX's engine cannot place a quantized tree under a
    mesh (``resnetc_tpu/serve.py:146-147``: its keys are not the folded
    tree's)."""
    if backend == "int8_chain":
        return ("--backend int8_chain does not support --model-dim > 1 (channel TP applies "
                f"to the XLA backends only); use --data-dim {ranks} instead")
    return (f"--backend {backend} does not support --model-dim > 1: channel tensor "
            "parallelism (ROADMAP Queue 1 item 3b) splits fp and pallas and replicates "
            "pallas_block, and JAX's engine cannot place the quantized tree under a mesh "
            f"(resnetc_tpu/serve.py:146-147); use --data-dim {ranks} instead")


def fused_forward_sharded(
    cfg: ResNetConfig,
    tree: Tree,
    x: torch.Tensor,
    mesh,
    *,
    backend: str,
    scales: Tree | None = None,
    policy: DtypePolicy = BF16,
    kernels: Kernels = KERNELS,
) -> torch.Tensor:
    """Serving of any backend over ``mesh``: every rank holds ``tree`` (the
    backend's: folded for ``fp`` / ``pallas`` / ``pallas_block``,
    ``quantize_folded`` for ``int8`` / ``int8_static``, the chain tree for
    ``int8_chain``) and ``scales`` (``int8_static``'s calibrated activation
    scales, ``int8_chain``'s chain scales: the same on every rank,
    calibrated on one batch), takes the global batch ``x``, runs the
    backend on its data slice and gets the gathered (B, num_classes) logits
    (``distributed.host_local_to_global``).  The ``int8`` backend's scales
    are the global batch's (``fused_forward_int8(group=)``).

    A model axis above 1: ``fp`` and ``pallas`` (``TP_BACKENDS``) split
    channels, ``tree`` being this rank's shard of the folded tree
    (``parallel.mesh.shard_tree``) and the forward gathering over the model
    group; ``pallas_block`` runs whole on every model rank, as JAX's
    partitioner runs an opaque ``pallas_call`` (the ranks of one data index
    compute the same slice); the int8 backends raise (``serve`` says why).

    ``int8_chain`` raises on a batch the data axis does not divide, with
    JAX's ``shard_map`` error (fused.py:1336).  The other backends pad such
    a batch with copies of its last image, whose logits are dropped (JAX's
    XLA backends serve any batch under a mesh, their input not being
    sharded).  A copy of a real image is what makes this exact for
    ``int8``: its activations equal the original's at every layer, so no
    per-tensor absmax moves, where a zero image's bias-driven activations
    could raise a later one."""
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.parallel import distributed
    from resnetc_tpu_torch.parallel import mesh as pmesh

    if backend not in SHARDED_BACKENDS:
        raise ValueError(f"backend must be one of {SHARDED_BACKENDS}, got {backend!r}")
    sizes = pmesh.axis_sizes(mesh)
    n, split = sizes[pmesh.DATA_AXIS], sizes[pmesh.MODEL_AXIS] > 1
    if split and backend not in TP_BACKENDS + ("pallas_block",):
        raise ValueError(model_axis_refusal(backend, n * sizes[pmesh.MODEL_AXIS]))
    if backend == "int8_chain":
        return fused_forward_int8_chain_sharded(cfg, tree, scales, x, mesh, policy=policy,
                                                kernels=kernels)
    group = pmesh.data_group(mesh)
    b = x.shape[0]
    if b % n:
        x = torch.cat([x, x[-1:].expand(n - b % n, *x.shape[1:])])
    local = pmesh.batch_sharding(mesh)(x)
    model_group = pmesh.model_group(mesh) if split and backend in TP_BACKENDS else None
    if backend == "fp":
        logits = resnet.forward_folded(cfg, tree, local, policy=policy, model_group=model_group)
    elif backend in ("pallas", "pallas_block"):
        logits = fused_forward(cfg, tree, local, policy=policy,
                               block_fusion=backend == "pallas_block", kernels=kernels,
                               model_group=model_group)
    elif backend == "int8":
        logits = fused_forward_int8(cfg, tree, local, policy=policy, kernels=kernels,
                                    group=group)
    else:
        logits = fused_forward_int8_static(cfg, tree, scales, local, policy=policy,
                                           kernels=kernels)
    return distributed.host_local_to_global(logits, group)[:b]


def _basic_int8_chain_forward(
    cfg: ResNetConfig,
    qtree: Tree,
    chain_scales: Tree,
    x: torch.Tensor,
    *,
    policy: DtypePolicy,
    stage_taps: list | None,
    kernels: Kernels,
) -> torch.Tensor:
    """The int8_chain forward for basic configs (ResNet-18/34), fused.py:821:
    the stride-1 blocks of a stage in BASIC_RUN_FUSE_STAGES as one
    ``basic_run_chained_int8``, every other stride-1 block one
    ``basic_block_chained_int8`` (at stage 0 under L1_PIXEL_PAIR their
    pixel-paired twins).  A stride-2 transition is one
    ``basic_ds_block_s2_int8`` under BASIC_DS_INT8; without it the chain is
    dequantized at the block's input scale, the block runs through ``_conv``
    in ``policy.compute`` and its output is requantized at the next block's
    scale and padded back into the chain (fused.py:905-933).  Same
    calibration contract as the bottleneck path; the last block exits bf16
    and the head pools outside the kernel.  The JAX package falls back to
    per-block kernels or XLA when a TPU kernel would not fit VMEM; the card
    has no such limit, so the kernel route is always taken (at every size
    served here the JAX guards pass too, and the two routes agree)."""
    scale_row, s_after = _chain_scale_lookups(cfg, chain_scales)
    with annotate(STEM):
        yr, bsz, h, w_sp = _stem_chain(qtree, x, chain_scales["layer1"]["0"]["in"], policy,
                                       kernels)

    for stage in range(4):
        with annotate(STAGES[stage]):
            blocks = qtree[f"layer{stage + 1}"]
            nb = cfg.stage_blocks[stage]
            start = 0
            if stage > 0 and BASIC_DS_INT8:
                blk = blocks["0"]
                yr = kernels.basic_ds(
                    yr,
                    blk["w1pq"], blk["sw1"], blk["b1"],
                    blk["w2pq"], blk["sw2p"], blk["b2"],
                    blk["wdq"], blk["swd"], blk["bd"],
                    scale_row(stage, 0),
                    h=h, w_sp=w_sp, emit_i8=s_after(stage, 0) is not None,
                    **{k: blk[k] for k in ("w1pq_nk", "w2pq_nk", "wdq_nk") if k in blk},
                )
                h, w_sp = (h + 1) // 2, (w_sp + 1) // 2
                start = 1
            elif stage > 0:
                blk = blocks["0"]
                s_in = chain_scales[f"layer{stage + 1}"]["0"]["in"]
                y = (block.unpad_from_chain(yr, bsz, h, w_sp).float() * s_in).to(policy.compute)

                def c(xx, key, stride, relu, residual=None):
                    return _conv(xx, blk[key], stride=stride, relu=relu, residual=residual,
                                 policy=policy, kernels=kernels)

                short = c(y, "downsample", 2, False) if "downsample" in blk else y
                y = c(c(y, "conv1", 2, True), "conv2", 1, True, short)
                h, w_sp = (h + 1) // 2, (w_sp + 1) // 2
                s_out0 = s_after(stage, 0)
                yr = block.pad_for_chain(y if s_out0 is None else quantize_with_scale(y, s_out0))
                start = 1

            # Pixel-paired stage 0 (fused.py:935-986): c = 64 and an even wp.
            pp_stage = (
                stage == 0 and L1_PIXEL_PAIR
                and blocks[str(start)]["sw1p"].shape[-1] // 3 == 64
                and block.chain_meta(0, h, w_sp)[1] % 2 == 0
            )
            if nb - start > 1 and stage in BASIC_RUN_FUSE_STAGES:
                args, kw = _basic_run_operands(
                    [blocks[str(i)] for i in range(start, nb)],
                    qtree.get("runs", {}).get(f"layer{stage + 1}"), pp_stage,
                )
                yr = (kernels.basic_run_pp if pp_stage else kernels.basic_run)(
                    yr, *args, torch.stack([scale_row(stage, i) for i in range(start, nb)]),
                    h=h, w_sp=w_sp, emit_i8=s_after(stage, nb - 1) is not None, **kw,
                )
            else:
                for i in range(start, nb):
                    blk = blocks[str(i)]
                    yr = (kernels.basic_block_pp if pp_stage else kernels.basic_block)(
                        yr, *(blk[k] for k in BASIC_KEYS), scale_row(stage, i),
                        h=h, w_sp=w_sp, emit_i8=s_after(stage, i) is not None,
                        **_basic_kmajor_kwargs(blk, pp_stage),
                    )

            _tap(stage_taps, yr, bsz, h, w_sp, s_after(stage, nb - 1))

    with annotate(HEAD):
        return _head(qtree, _mean_feats(yr, bsz, h, w_sp, policy), policy, kernels)
