"""Declarative ResNet family: config table, torchvision init, BN fold and the
folded fp forward.

Counterpart of ``resnetc_tpu/models/resnet.py``.  The architecture is
torchvision's ResNet v1.5 (stride on the 3x3 of each bottleneck), which is
what the reference implements (cuda/inference/main.cu:109-125).  The
parameter tree is a nested dict whose joined keys are exactly torchvision
``state_dict()`` keys (``layer1.0.conv1.weight``...); conv weights are HWIO
and activations NHWC, as in the JAX package.

``forward_folded`` is the fp serving path: the oracle that int8 calibration
runs, and the counterpart of the JAX ``xla`` backend.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from resnetc_tpu_torch.ops import torch_ops
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


def _folded_conv(x, entry, *, stride, padding, act, policy, groups=1):
    w = entry["weight"].to(policy.compute)
    y = torch_ops.conv2d(x, w, stride=stride, padding=padding, groups=groups)
    y = y + entry["bias"].to(y.dtype)
    return torch_ops.relu(y) if act else y


def forward_folded(
    cfg: ResNetConfig,
    folded: Tree,
    x: torch.Tensor,
    *,
    policy: DtypePolicy = BF16,
) -> torch.Tensor:
    """Serving-path fp forward over a BN-folded tree; ``x`` is NHWC.
    Returns logits in ``policy.output``."""
    x = x.to(policy.compute)
    y = _folded_conv(x, folded["conv1"], stride=2, padding=3, act=True, policy=policy)
    y = torch_ops.max_pool2d(y, kernel_size=3, stride=2, padding=1)

    for stage in range(4):
        blocks = folded[f"layer{stage + 1}"]
        stage_stride = 1 if stage == 0 else 2
        for b in range(cfg.stage_blocks[stage]):
            blk = blocks[str(b)]
            blk_stride = stage_stride if b == 0 else 1
            if cfg.block == "bottleneck":
                z = _folded_conv(y, blk["conv1"], stride=1, padding=0, act=True, policy=policy)
                z = _folded_conv(
                    z, blk["conv2"], stride=blk_stride, padding=1, act=True,
                    policy=policy, groups=cfg.groups,
                )
                z = _folded_conv(z, blk["conv3"], stride=1, padding=0, act=False, policy=policy)
            else:
                z = _folded_conv(y, blk["conv1"], stride=blk_stride, padding=1, act=True, policy=policy)
                z = _folded_conv(z, blk["conv2"], stride=1, padding=1, act=False, policy=policy)
            if "downsample" in blk:
                short = _folded_conv(
                    y, blk["downsample"], stride=blk_stride, padding=0, act=False, policy=policy
                )
            else:
                short = y
            y = torch_ops.relu(torch_ops.add(z, short))

    feats = torch_ops.global_avg_pool(y)
    logits = torch_ops.linear(
        feats.to(policy.compute),
        folded["fc"]["weight"].to(policy.compute),
        folded["fc"]["bias"],
    )
    return logits.to(policy.output)
