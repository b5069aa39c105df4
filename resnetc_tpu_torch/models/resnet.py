"""Declarative ResNet family: config table, torchvision init, the params /
state split, the unfolded forward (BN in train and eval mode), BN fold and
the folded fp forward.

Counterpart of ``resnetc_tpu/models/resnet.py``.  The architecture is
torchvision's ResNet v1.5 (stride on the 3x3 of each bottleneck), which is
what the reference implements (cuda/inference/main.cu:109-125).  The
parameter tree is a nested dict whose joined keys are exactly torchvision
``state_dict()`` keys (``layer1.0.conv1.weight``...); conv weights are HWIO
and activations NHWC, as in the JAX package.

``forward`` is the training path's network: every op differentiable with
autograd, BN on batch statistics under ``train=True``.
``forward_folded`` is the fp serving path: the oracle that int8 calibration
runs, and the counterpart of the JAX ``xla`` backend.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.utils.checkpoint

from resnetc_tpu_torch.ops import torch_ops
from resnetc_tpu_torch.parallel import tp
from resnetc_tpu_torch.tensor import BF16, DtypePolicy, unflatten_tree

Tree = dict[str, Any]

# Bottleneck expansion ratio: out_channels = 4 * inter_channels.
BOTTLENECK_EXPANSION = 4


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str
    block: str  # "basic" | "bottleneck"
    stage_blocks: tuple[int, int, int, int]
    num_classes: int = 1000
    stem_width: int = 64
    #: torchvision's bottleneck width parameterization (wide / ResNeXt).
    groups: int = 1
    width_per_group: int = 64

    @property
    def expansion(self) -> int:
        return BOTTLENECK_EXPANSION if self.block == "bottleneck" else 1

    @property
    def feature_dim(self) -> int:
        """Channel count entering the classifier (2048 for bottleneck nets)."""
        return self.stem_width * 8 * self.expansion

    def stage_channels(self, stage: int) -> tuple[int, int]:
        """(inter_channels, out_channels) for stage in [0, 4)."""
        base = self.stem_width * (2**stage)
        if self.block == "bottleneck":
            inter = base * self.width_per_group // 64 * self.groups
        else:
            inter = base
        return inter, base * self.expansion


RESNET_CONFIGS: dict[str, ResNetConfig] = {
    "resnet18": ResNetConfig("resnet18", "basic", (2, 2, 2, 2)),
    "resnet34": ResNetConfig("resnet34", "basic", (3, 4, 6, 3)),
    "resnet50": ResNetConfig("resnet50", "bottleneck", (3, 4, 6, 3)),
    "resnet101": ResNetConfig("resnet101", "bottleneck", (3, 4, 23, 3)),
    # The reference's model: 3+8+36+3 bottleneck blocks (main.cu:116-119).
    "resnet152": ResNetConfig("resnet152", "bottleneck", (3, 8, 36, 3)),
    "wide_resnet50_2": ResNetConfig(
        "wide_resnet50_2", "bottleneck", (3, 4, 6, 3), width_per_group=128
    ),
    "wide_resnet101_2": ResNetConfig(
        "wide_resnet101_2", "bottleneck", (3, 4, 23, 3), width_per_group=128
    ),
    "resnext50_32x4d": ResNetConfig(
        "resnext50_32x4d", "bottleneck", (3, 4, 6, 3),
        groups=32, width_per_group=4,
    ),
    "resnext101_32x8d": ResNetConfig(
        "resnext101_32x8d", "bottleneck", (3, 4, 23, 3),
        groups=32, width_per_group=8,
    ),
}


def get_config(name: str, num_classes: int = 1000) -> ResNetConfig:
    try:
        cfg = RESNET_CONFIGS[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; have {sorted(RESNET_CONFIGS)}")
    return dataclasses.replace(cfg, num_classes=num_classes)


def _block_param_names(cfg: ResNetConfig) -> list[tuple[str, str]]:
    if cfg.block == "bottleneck":
        return [("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3")]
    return [("conv1", "bn1"), ("conv2", "bn2")]


def param_shapes(cfg: ResNetConfig) -> dict[str, tuple[int, ...]]:
    """HWIO / torchvision-keyed shape of every parameter, in init order."""
    shapes: dict[str, tuple[int, ...]] = {}

    def conv(prefix, h, w, cin, cout):
        shapes[f"{prefix}.weight"] = (h, w, cin, cout)

    def bn(prefix, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{prefix}.{leaf}"] = (c,)

    conv("conv1", 7, 7, 3, cfg.stem_width)
    bn("bn1", cfg.stem_width)
    in_c = cfg.stem_width
    for stage in range(4):
        inter, out_c = cfg.stage_channels(stage)
        stride = 1 if stage == 0 else 2
        for b in range(cfg.stage_blocks[stage]):
            p = f"layer{stage + 1}.{b}"
            if cfg.block == "bottleneck":
                conv(f"{p}.conv1", 1, 1, in_c, inter)
                bn(f"{p}.bn1", inter)
                conv(f"{p}.conv2", 3, 3, inter // cfg.groups, inter)
                bn(f"{p}.bn2", inter)
                conv(f"{p}.conv3", 1, 1, inter, out_c)
                bn(f"{p}.bn3", out_c)
            else:
                conv(f"{p}.conv1", 3, 3, in_c, inter)
                bn(f"{p}.bn1", inter)
                conv(f"{p}.conv2", 3, 3, inter, out_c)
                bn(f"{p}.bn2", out_c)
            blk_stride = stride if b == 0 else 1
            if b == 0 and (blk_stride != 1 or in_c != out_c):
                conv(f"{p}.downsample.0", 1, 1, in_c, out_c)
                bn(f"{p}.downsample.1", out_c)
            in_c = out_c
    shapes["fc.weight"] = (cfg.num_classes, cfg.feature_dim)
    shapes["fc.bias"] = (cfg.num_classes,)
    return shapes


def init(
    cfg: ResNetConfig,
    generator: torch.Generator,
    *,
    dtype: torch.dtype = torch.float32,
) -> Tree:
    """Random-init a variables tree on the CPU with torchvision's init:
    kaiming-normal fan_out convs, BN scale 1 / bias 0 / identity stats, fc
    uniform(+-1/sqrt(in)).  Numbers differ from the JAX package's init (a
    different generator); tests carry the JAX tree across instead."""
    flat: dict[str, torch.Tensor] = {}
    fc_bound = 1.0 / math.sqrt(cfg.feature_dim)
    for key, shape in param_shapes(cfg).items():
        leaf = key.rsplit(".", 1)[1]
        if len(shape) == 4:
            std = math.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
            flat[key] = std * torch.randn(shape, generator=generator, dtype=dtype)
        elif key.startswith("fc."):
            u = torch.rand(shape, generator=generator, dtype=dtype)
            flat[key] = (2 * u - 1) * fc_bound
        elif leaf in ("weight", "running_var"):
            flat[key] = torch.ones(shape, dtype=dtype)
        else:
            flat[key] = torch.zeros(shape, dtype=dtype)
    return unflatten_tree(flat)


# ---------------------------------------------------------------------------
# params/state split: BN running stats are state (updated by forward passes in
# train mode), everything else is trainable.
# ---------------------------------------------------------------------------

_STATE_LEAVES = ("running_mean", "running_var")


def split_params_state(variables: Tree) -> tuple[Tree, Tree]:
    """Split one variables tree into (trainable params, BN running stats).

    Both keep the full nesting (empty branches dropped), so
    ``merge_params_state`` puts them back together."""

    def walk(node):
        params, state = {}, {}
        for k, v in node.items():
            if isinstance(v, dict):
                p, s = walk(v)
                if p:
                    params[k] = p
                if s:
                    state[k] = s
            elif k in _STATE_LEAVES:
                state[k] = v
            else:
                params[k] = v
        return params, state

    return walk(variables)


def merge_params_state(params: Tree, state: Tree) -> Tree:
    def walk(p, s):
        out = {}
        for k in set(p) | set(s):
            if k in p and k in s:
                out[k] = walk(p[k], s[k])
            elif k in p:
                out[k] = p[k] if not isinstance(p[k], dict) else walk(p[k], {})
            else:
                out[k] = s[k] if not isinstance(s[k], dict) else walk({}, s[k])
        return out

    return walk(params, state)


# ---------------------------------------------------------------------------
# Forward pass (BN unfolded, train or eval mode).
# ---------------------------------------------------------------------------


def _bn(x, bn_vars, *, train: bool, group=None):
    if not train:
        out = torch_ops.batch_norm_inference(
            x, bn_vars["weight"], bn_vars["bias"],
            bn_vars["running_mean"], bn_vars["running_var"],
        )
        return out, None
    out, new_mean, new_var = torch_ops.batch_norm_train(
        x, bn_vars["weight"], bn_vars["bias"],
        bn_vars["running_mean"], bn_vars["running_var"], group=group,
    )
    return out, {"running_mean": new_mean, "running_var": new_var}


def _conv(x, w, *, stride, padding, groups=1, model_group=None):
    """``torch_ops.conv2d`` of an input and weight as the forward holds
    them.  Under a model group ``x`` is the gathered input and ``w`` this
    rank's O-shard, except for a grouped convolution, whose input is the
    local shard: a shard of O needs only its own groups' input channels.
    Where the axis divides the groups, those channels are exactly this
    rank's shard of the input (a grouped conv's input and output widths are
    equal and split alike), so it runs on the shard with ``groups // M``
    groups.  Otherwise the input and the weight are gathered, the conv runs
    whole and the output is sliced to the shard."""
    if model_group is None or groups == 1:
        return torch_ops.conv2d(x, w, stride=stride, padding=padding, groups=groups)
    m = torch.distributed.get_world_size(model_group)
    if groups % m == 0:
        return torch_ops.conv2d(x, w, stride=stride, padding=padding, groups=groups // m)
    y = torch_ops.conv2d(tp.gather_for_sharded(x, model_group),
                         tp.gather_for_sharded(w, model_group),
                         stride=stride, padding=padding, groups=groups)
    n = w.shape[-1]
    return y.narrow(-1, torch.distributed.get_rank(model_group) * n, n)


def _logits(cfg, feats, fc, policy, model_group):
    def linear(f):
        return torch_ops.linear(f.to(policy.compute), fc["weight"].to(policy.compute), fc["bias"])

    if model_group is None:
        return linear(feats)
    return tp.fc(feats, linear, cfg.num_classes, model_group)


def _conv_bn_act(x, conv_vars, bn_vars, *, stride, padding, act, train, policy, groups=1,
                 bn_group=None, model_group=None):
    w = conv_vars["weight"].to(policy.compute)
    y = _conv(x, w, stride=stride, padding=padding, groups=groups, model_group=model_group)
    y, new_stats = _bn(y, bn_vars, train=train, group=bn_group)
    if act:
        y = torch_ops.relu(y)
    return y, new_stats


def _block_forward(x, blk, cfg: ResNetConfig, stride: int, *, train: bool, policy,
                   bn_group=None, model_group=None):
    """One residual block.  Bottleneck: 1x1 -> bn -> relu, 3x3 stride s
    pad 1 -> bn -> relu, 1x1 -> bn, + shortcut, relu.  Basic: 3x3 stride s
    pad 1 -> bn -> relu, 3x3 pad 1 -> bn, + shortcut, relu.  Returns
    ``(y, new BN stats of the block)``; ``bn_group`` syncs every BN.
    ``model_group``: ``x`` and the result are channel shards, each conv's
    input is gathered first (conv1 and the projection share one gather)
    and the shortcut adds the local shard."""
    new_state: Tree = {}
    gather = tp.input_gather(model_group)

    def bn_step(name, y, conv_name, s, p, act, groups=1):
        y, stats = _conv_bn_act(
            y, blk[conv_name], blk[name], stride=s, padding=p, act=act,
            train=train, policy=policy, groups=groups, bn_group=bn_group,
            model_group=model_group,
        )
        if stats is not None:
            new_state[name] = stats
        return y

    xg = gather(x)
    if cfg.block == "bottleneck":
        y = bn_step("bn1", xg, "conv1", 1, 0, True)
        y = bn_step("bn2", y if cfg.groups > 1 else gather(y), "conv2", stride, 1, True,
                    groups=cfg.groups)
        y = bn_step("bn3", gather(y), "conv3", 1, 0, False)
    else:
        y = bn_step("bn1", xg, "conv1", stride, 1, True)
        y = bn_step("bn2", gather(y), "conv2", 1, 1, False)

    if "downsample" in blk:
        w = blk["downsample"]["0"]["weight"].to(policy.compute)
        short = torch_ops.conv2d(xg, w, stride=stride, padding=0)
        short, stats = _bn(short, blk["downsample"]["1"], train=train, group=bn_group)
        if stats is not None:
            new_state["downsample"] = {"1": stats}
    else:
        short = x

    y = torch_ops.relu(torch_ops.add(y, short))
    return y, new_state


def forward(
    cfg: ResNetConfig,
    variables: Tree,
    x: torch.Tensor,
    *,
    train: bool = False,
    policy: DtypePolicy = BF16,
    remat: bool = False,
    bn_group=None,
    model_group=None,
) -> tuple[torch.Tensor, Tree]:
    """Run the network on NHWC ``x``; counterpart of the JAX ``forward``
    (``models/resnet.py:320``).

    Returns ``(logits [B, num_classes] in policy.output, new_state)``:
    ``new_state`` holds the updated BN running stats under ``train=True``,
    with exactly the structure of the tree's BN state, and is empty
    otherwise.  Differentiable through autograd.

    ``remat=True`` checkpoints each residual block
    (``torch.utils.checkpoint``, non-reentrant): the backward recomputes
    the block's activations instead of keeping them.  The running stats are
    those of the first forward; the recomputation's are discarded.

    ``bn_group`` (a process group; JAX's ``axis_name``) computes every
    train-mode BN over the group's global batch (sync-BN).  Under
    ``remat`` the backward's recomputation all-reduces again; every rank
    recomputes the same blocks in the same order, so the collectives
    match.

    ``model_group`` (the mesh's model axis, ``parallel.mesh.model_group``):
    channel tensor parallelism.  ``variables`` is this rank's shard of the
    tree (``parallel.mesh.shard_tree``), activations flow channel-sharded,
    each conv and the fc gather their input over the group
    (``parallel.tp``; the stem's 3-channel input is replicated and is not
    gathered) and the logits come back whole on every rank.  ``bn_group``
    stays the data axis: a BN's channels are local to its model rank.
    Under ``remat`` the backward recomputes the gathers, in the same order
    on every rank."""
    if model_group is not None:
        tp.check_config(cfg, torch.distributed.get_world_size(model_group))
    x = x.to(policy.compute)
    new_state: Tree = {}

    y, stats = _conv_bn_act(
        x, variables["conv1"], variables["bn1"], stride=2, padding=3, act=True,
        train=train, policy=policy, bn_group=bn_group,
    )
    if stats is not None:
        new_state["bn1"] = stats
    y = torch_ops.max_pool2d(y, kernel_size=3, stride=2, padding=1)

    for stage in range(4):
        layer_name = f"layer{stage + 1}"
        stage_stride = 1 if stage == 0 else 2
        layer_state: Tree = {}
        for b in range(cfg.stage_blocks[stage]):
            blk_stride = stage_stride if b == 0 else 1
            blk = variables[layer_name][str(b)]
            if remat:
                y, blk_state = torch.utils.checkpoint.checkpoint(
                    _block_forward, y, blk, cfg, blk_stride, train=train, policy=policy,
                    bn_group=bn_group, model_group=model_group, use_reentrant=False,
                    preserve_rng_state=False,
                )
            else:
                y, blk_state = _block_forward(y, blk, cfg, blk_stride, train=train,
                                              policy=policy, bn_group=bn_group,
                                              model_group=model_group)
            if blk_state:
                layer_state[str(b)] = blk_state
        if layer_state:
            new_state[layer_name] = layer_state

    feats = torch_ops.global_avg_pool(y)
    logits = _logits(cfg, feats, variables["fc"], policy, model_group)
    return logits.to(policy.output), new_state


# ---------------------------------------------------------------------------
# Folded inference: BN affine folded into conv weights (exact).
# ---------------------------------------------------------------------------


def fold_inference_params(cfg: ResNetConfig, variables: Tree) -> Tree:
    """Serving-mode tree: every conv+BN pair becomes {"weight" HWIO,
    "bias" [O]}; the fc layer passes through unchanged."""

    def fold(conv_vars, bn_vars):
        w, b = torch_ops.fold_bn_into_conv(
            conv_vars["weight"], bn_vars["weight"], bn_vars["bias"],
            bn_vars["running_mean"], bn_vars["running_var"],
        )
        return {"weight": w, "bias": b}

    out: Tree = {"conv1": fold(variables["conv1"], variables["bn1"])}
    for stage in range(4):
        layer_name = f"layer{stage + 1}"
        blocks = {}
        for bname, blk in variables[layer_name].items():
            fblk = {}
            for conv_name, bn_name in _block_param_names(cfg):
                if conv_name in blk:
                    fblk[conv_name] = fold(blk[conv_name], blk[bn_name])
            if "downsample" in blk:
                fblk["downsample"] = fold(blk["downsample"]["0"], blk["downsample"]["1"])
            blocks[bname] = fblk
        out[layer_name] = blocks
    out["fc"] = dict(variables["fc"])
    return out


def _folded_conv(x, entry, *, stride, padding, act, policy, groups=1, model_group=None):
    w = entry["weight"].to(policy.compute)
    y = _conv(x, w, stride=stride, padding=padding, groups=groups, model_group=model_group)
    y = y + entry["bias"].to(y.dtype)
    return torch_ops.relu(y) if act else y


def forward_folded(
    cfg: ResNetConfig,
    folded: Tree,
    x: torch.Tensor,
    *,
    policy: DtypePolicy = BF16,
    model_group=None,
) -> torch.Tensor:
    """Serving-path fp forward over a BN-folded tree; ``x`` is NHWC.
    Returns logits in ``policy.output``.  ``model_group``: channel tensor
    parallelism over this rank's shard of the folded tree, as ``forward``;
    the logits come back whole on every rank."""
    if model_group is not None:
        tp.check_config(cfg, torch.distributed.get_world_size(model_group))
    gather = tp.input_gather(model_group)
    x = x.to(policy.compute)
    y = _folded_conv(x, folded["conv1"], stride=2, padding=3, act=True, policy=policy)
    y = torch_ops.max_pool2d(y, kernel_size=3, stride=2, padding=1)

    def conv(t, entry, stride, padding, act, groups=1):
        return _folded_conv(t, entry, stride=stride, padding=padding, act=act, policy=policy,
                            groups=groups, model_group=model_group)

    for stage in range(4):
        blocks = folded[f"layer{stage + 1}"]
        stage_stride = 1 if stage == 0 else 2
        for b in range(cfg.stage_blocks[stage]):
            blk = blocks[str(b)]
            blk_stride = stage_stride if b == 0 else 1
            yg = gather(y)
            if cfg.block == "bottleneck":
                z = conv(yg, blk["conv1"], 1, 0, True)
                z = conv(z if cfg.groups > 1 else gather(z), blk["conv2"], blk_stride, 1, True,
                         groups=cfg.groups)
                z = conv(gather(z), blk["conv3"], 1, 0, False)
            else:
                z = conv(yg, blk["conv1"], blk_stride, 1, True)
                z = conv(gather(z), blk["conv2"], 1, 1, False)
            short = conv(yg, blk["downsample"], blk_stride, 0, False) if "downsample" in blk else y
            y = torch_ops.relu(torch_ops.add(z, short))

    feats = torch_ops.global_avg_pool(y)
    logits = _logits(cfg, feats, folded["fc"], policy, model_group)
    return logits.to(policy.output)
