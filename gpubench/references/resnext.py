"""The plain reference of the ResNeXt configurations: torchvision's ResNeXt
(Xie et al., arXiv:1611.05431, Table 1: the 32xd template; torchvision's
``resnext101_32x8d``), the ResNet v1.5 bottleneck of ``references.resnet``
whose 3x3 is a grouped convolution of ``groups`` groups and whose inner
width is ``stem_width * 2**stage * width_per_group / 64 * groups``, in
float32, NCHW, with BN applied unfolded from its running statistics.

It imports nothing of the program, nor of the harness: ``exact_fp32``,
``kaiming_std``, ``plain_linear`` and ``stage_size`` are those of
``references.resnet``, repeated.  The weights are a flat dict under
torchvision's ``state_dict()`` names, convolutions OIHW, a grouped 3x3
(W, W / groups, 3, 3).  ``forward`` runs the grouped 3x3 as
``F.conv2d(..., groups=)`` through the module's own ``plain_conv``; a
``conv`` hook that is not this module's (``gpubench.control``'s takes no
``groups``) is handed each grouped weight's block-diagonal expansion, a
dense (W, W, 3, 3) weight with the same products and the same
per-output-channel absolute maximum, so the int4 control runs unchanged.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Iterator

import torch
import torch.nn.functional as F

EXPANSION = 4


def stage_size(cfg: dict, stage: int) -> int:
    """The side of a stage's output feature map: the stem and its pool take
    the image to a quarter, each later stage halves it."""
    side = cfg["image_size"]
    for _ in range(2 + stage):
        side = (side - 1) // 2 + 1
    return side


def stage_widths(cfg: dict, stage: int) -> tuple[int, int]:
    """(inner width, output width) of a stage's blocks."""
    base = cfg["stem_width"] * 2**stage
    return base * cfg["width_per_group"] // 64 * cfg["groups"], base * EXPANSION


def blocks(cfg: dict) -> Iterator[tuple[str, int, int, int, int, int, bool]]:
    """(name, stage, cin, inner, cout, stride, projection) of every block in order."""
    cin = cfg["stem_width"]
    for stage, n in enumerate(cfg["stage_blocks"]):
        inner, cout = stage_widths(cfg, stage)
        for b in range(n):
            stride = 2 if (stage > 0 and b == 0) else 1
            proj = b == 0 and (stride != 1 or cin != cout)
            yield f"layer{stage + 1}.{b}", stage, cin, inner, cout, stride, proj
            cin = cout


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """torchvision name -> shape of every parameter and BN statistic."""
    if cfg["block"] != "bottleneck":
        raise ValueError("ResNeXt is a bottleneck family")
    g = cfg["groups"]
    shapes: dict[str, tuple[int, ...]] = {}

    def conv_bn(conv: str, bn: str, k: int, cin: int, cout: int) -> None:
        shapes[f"{conv}.weight"] = (cout, cin, k, k)
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{bn}.{leaf}"] = (cout,)

    conv_bn("conv1", "bn1", 7, 3, cfg["stem_width"])
    for name, _, cin, inner, cout, _, proj in blocks(cfg):
        conv_bn(f"{name}.conv1", f"{name}.bn1", 1, cin, inner)
        conv_bn(f"{name}.conv2", f"{name}.bn2", 3, inner // g, inner)
        conv_bn(f"{name}.conv3", f"{name}.bn3", 1, inner, cout)
        if proj:
            conv_bn(f"{name}.downsample.0", f"{name}.downsample.1", 1, cin, cout)
    feat = stage_widths(cfg, 3)[1]
    shapes["fc.weight"] = (cfg["num_classes"], feat)
    shapes["fc.bias"] = (cfg["num_classes"],)
    return shapes


@contextlib.contextmanager
def exact_fp32() -> Iterator[None]:
    """IEEE float32 in cuDNN convolutions and cuBLAS matmuls inside the
    block: the legacy ``allow_tf32`` flags off, and the per-op
    ``fp32_precision`` settings, which take precedence where torch has
    them, at "ieee".  Everything is given back on exit."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, dnn.allow_tf32)
    per_op = [o for o in (mm, getattr(dnn, "conv", None)) if hasattr(o, "fp32_precision")]
    saved_per_op = [o.fp32_precision for o in per_op]
    mm.allow_tf32 = dnn.allow_tf32 = False
    for o in per_op:
        o.fp32_precision = "ieee"
    try:
        with dnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
            yield
    finally:
        mm.allow_tf32, dnn.allow_tf32 = saved
        for o, p in zip(per_op, saved_per_op):
            o.fp32_precision = p


def kaiming_std(shape: tuple[int, ...]) -> float:
    """torchvision's conv init: kaiming normal, fan out (the output channels
    times the kernel's area, a grouped conv's too), for a relu."""
    cout, _, kh, kw = shape
    return math.sqrt(2.0 / (cout * kh * kw))


def plain_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.linear(x, w, b)


def plain_conv(name: str, x: torch.Tensor, w: torch.Tensor, stride: int, padding: int,
               groups: int = 1):
    """A float32 convolution; ``name`` is the conv's torchvision name."""
    del name
    return F.conv2d(x, w, stride=stride, padding=padding, groups=groups)


def expand_grouped(w: torch.Tensor, groups: int) -> torch.Tensor:
    """A grouped weight (W, W / groups, k, k) as the dense (W, W, k, k)
    weight of the same convolution: zero outside each output's group."""
    cout, gw = w.shape[:2]
    dense = w.new_zeros((cout, gw * groups, *w.shape[2:]))
    per = cout // groups
    for j in range(groups):
        dense[j * per:(j + 1) * per, j * gw:(j + 1) * gw] = w[j * per:(j + 1) * per]
    return dense


def forward(
    cfg: dict,
    params: dict[str, torch.Tensor],
    x_nhwc: torch.Tensor,
    *,
    conv: Callable = plain_conv,
    linear: Callable = plain_linear,
    bn_hook: Callable | None = None,
) -> torch.Tensor:
    """Logits (B, classes) in float32 for NHWC float32 images.

    ``bn_hook(bn_name, x)`` is called with each BN's input before the BN
    reads its statistics (``gpubench.inputs`` sets them there)."""
    x = x_nhwc.permute(0, 3, 1, 2).float()
    g = cfg["groups"]

    def bn(name: str, y: torch.Tensor) -> torch.Tensor:
        if bn_hook is not None:
            bn_hook(name, y)
        return F.batch_norm(
            y, params[f"{name}.running_mean"], params[f"{name}.running_var"],
            params[f"{name}.weight"], params[f"{name}.bias"], training=False, eps=1e-5,
        )

    def conv_bn(cname: str, bname: str, y: torch.Tensor, stride: int, k: int,
                groups: int = 1) -> torch.Tensor:
        w = params[f"{cname}.weight"]
        if groups == 1:
            out = conv(cname, y, w, stride, k // 2)
        elif conv is plain_conv:
            out = plain_conv(cname, y, w, stride, k // 2, groups=groups)
        else:
            out = conv(cname, y, expand_grouped(w, groups), stride, k // 2)
        return bn(bname, out)

    y = F.relu(conv_bn("conv1", "bn1", x, 2, 7))
    y = F.max_pool2d(y, kernel_size=3, stride=2, padding=1)
    for name, _, _, _, _, stride, proj in blocks(cfg):
        z = F.relu(conv_bn(f"{name}.conv1", f"{name}.bn1", y, 1, 1))
        z = F.relu(conv_bn(f"{name}.conv2", f"{name}.bn2", z, stride, 3, groups=g))
        z = conv_bn(f"{name}.conv3", f"{name}.bn3", z, 1, 1)
        short = (conv_bn(f"{name}.downsample.0", f"{name}.downsample.1", y, stride, 1)
                 if proj else y)
        y = F.relu(z + short)
    feats = y.mean(dim=(2, 3))
    return linear(feats, params["fc.weight"], params["fc.bias"])
