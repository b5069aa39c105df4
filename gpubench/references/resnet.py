"""The plain reference of the ResNet configurations: torchvision's ResNet v1.5
(He et al., arXiv:1512.03385, Table 1; the stride on each bottleneck's 3x3)
in float32, NCHW, with BN applied unfolded from its running statistics.

It imports nothing of the program.  Its weights are a flat dict under
torchvision's ``state_dict()`` names, convolutions OIHW.  ``forward`` takes a
``conv`` hook, through which the control of ``gpubench.control`` computes
the same network in a lower precision, and a ``bn_hook``, through which
``gpubench.inputs`` sets each BN's running statistics from the activations
that reach it.  ``exact_fp32()`` keeps cuDNN and cuBLAS from computing
float32 work in TF32 while the reference runs.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Iterator

import torch
import torch.nn.functional as F

EXPANSION = {"bottleneck": 4, "basic": 1}


def stage_widths(cfg: dict, stage: int) -> tuple[int, int]:
    """(inner width, output width) of a stage's blocks."""
    base = cfg["stem_width"] * 2**stage
    return base, base * EXPANSION[cfg["block"]]


def stage_size(cfg: dict, stage: int) -> int:
    """The side of a stage's output feature map: the stem and its pool take
    the image to a quarter, each later stage halves it."""
    side = cfg["image_size"]
    for _ in range(2):  # stem conv, then max pool: k3 s2 p1 and k7 s2 p3
        side = (side - 1) // 2 + 1
    for _ in range(stage):
        side = (side - 1) // 2 + 1
    return side


def blocks(cfg: dict) -> Iterator[tuple[str, int, int, int, int, bool]]:
    """(name, stage, cin, inner, cout, stride, projection) of every block in order."""
    cin = cfg["stem_width"]
    for stage, n in enumerate(cfg["stage_blocks"]):
        inner, cout = stage_widths(cfg, stage)
        for b in range(n):
            stride = 2 if (stage > 0 and b == 0) else 1
            proj = b == 0 and (stride != 1 or cin != cout)
            yield f"layer{stage + 1}.{b}", stage, cin, inner, cout, stride, proj
            cin = cout


def block_convs(cfg: dict, cin: int, inner: int, cout: int) -> list[tuple[str, int, int, int]]:
    """(conv name, kernel side, cin, cout) of one block's branch."""
    if cfg["block"] == "bottleneck":
        return [("conv1", 1, cin, inner), ("conv2", 3, inner, inner), ("conv3", 1, inner, cout)]
    return [("conv1", 3, cin, inner), ("conv2", 3, inner, cout)]


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """torchvision name -> shape of every parameter and BN statistic."""
    if cfg.get("groups", 1) != 1 or cfg.get("width_per_group", 64) != 64:
        raise ValueError("the reference covers ungrouped ResNets of width 64 a group")
    shapes: dict[str, tuple[int, ...]] = {}

    def conv_bn(conv: str, bn: str, k: int, cin: int, cout: int) -> None:
        shapes[f"{conv}.weight"] = (cout, cin, k, k)
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{bn}.{leaf}"] = (cout,)

    conv_bn("conv1", "bn1", 7, 3, cfg["stem_width"])
    for name, _, cin, inner, cout, _, proj in blocks(cfg):
        for i, (conv, k, ci, co) in enumerate(block_convs(cfg, cin, inner, cout)):
            conv_bn(f"{name}.{conv}", f"{name}.bn{i + 1}", k, ci, co)
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


def plain_conv(name: str, x: torch.Tensor, w: torch.Tensor, stride: int, padding: int):
    """A float32 convolution; ``name`` is the conv's torchvision name."""
    del name
    return F.conv2d(x, w, stride=stride, padding=padding)


def plain_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.linear(x, w, b)


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

    def bn(name: str, y: torch.Tensor) -> torch.Tensor:
        if bn_hook is not None:
            bn_hook(name, y)
        return F.batch_norm(
            y, params[f"{name}.running_mean"], params[f"{name}.running_var"],
            params[f"{name}.weight"], params[f"{name}.bias"], training=False, eps=1e-5,
        )

    def conv_bn(cname: str, bname: str, y: torch.Tensor, stride: int, k: int) -> torch.Tensor:
        return bn(bname, conv(cname, y, params[f"{cname}.weight"], stride, k // 2))

    y = F.relu(conv_bn("conv1", "bn1", x, 2, 7))
    y = F.max_pool2d(y, kernel_size=3, stride=2, padding=1)
    for name, _, cin, inner, cout, stride, proj in blocks(cfg):
        z = y
        convs = block_convs(cfg, cin, inner, cout)
        strided = 1 if cfg["block"] == "bottleneck" else 0  # v1.5: the 3x3 strides
        for i, (cname, k, _, _) in enumerate(convs):
            z = conv_bn(f"{name}.{cname}", f"{name}.bn{i + 1}", z, stride if i == strided else 1, k)
            if i + 1 < len(convs):
                z = F.relu(z)
        short = (conv_bn(f"{name}.downsample.0", f"{name}.downsample.1", y, stride, 1)
                 if proj else y)
        y = F.relu(z + short)
    feats = y.mean(dim=(2, 3))
    return linear(feats, params["fc.weight"], params["fc.bias"])


def kaiming_std(shape: tuple[int, ...]) -> float:
    """torchvision's conv init: kaiming normal, fan out, for a relu."""
    cout, _, kh, kw = shape
    return math.sqrt(2.0 / (cout * kh * kw))
