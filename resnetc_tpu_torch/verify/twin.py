"""Pure-PyTorch ResNet twin: the numerical ground truth for parity checks.

A copy of ``resnetc_tpu/verify/twin.py`` (``TorchResNet`` :90,
``build_twin`` :149) over the port's ``ResNetConfig``.  The reference
verifies its CUDA engine against a hand-written PyTorch model that mirrors
torchvision's ResNet-152 (pytorch_inference.py:29-162); this twin is that
model for the whole family, written without torchvision, with
``state_dict()`` keys exactly torchvision's.  It is a weights donor and a
numerics oracle (``verify.harness``), never on the serving or training path.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from resnetc_tpu_torch.models.resnet import ResNetConfig


def _conv3x3(cin: int, cout: int, stride: int = 1, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(
        cin, cout, 3, stride=stride, padding=1, groups=groups, bias=False
    )


def _conv1x1(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, stride=stride, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample=None):
        super().__init__()
        self.conv1 = _conv3x3(cin, planes, stride)
        self.bn1 = nn.BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = _conv3x3(planes, planes)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    # v1.5 bottleneck: stride lives on the 3x3 conv — same as the reference
    # (cuda/inference/main.cu:18-46) and torchvision.
    expansion = 4

    def __init__(
        self, cin: int, planes: int, stride: int = 1, downsample=None,
        width: int | None = None, groups: int = 1,
    ):
        super().__init__()
        # torchvision wide/ResNeXt variants: the inner 1x1/3x3 width scales
        # (and the 3x3 may be grouped) while the block output stays
        # planes * expansion.
        width = width or planes
        self.conv1 = _conv1x1(cin, width)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = _conv3x3(width, width, stride, groups)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = _conv1x1(width, planes * self.expansion)
        self.bn3 = nn.BatchNorm2d(planes * self.expansion)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class TorchResNet(nn.Module):
    """torchvision-compatible ResNet (state_dict keys match exactly)."""

    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        block = Bottleneck if cfg.block == "bottleneck" else BasicBlock
        self.cfg = cfg
        self.inplanes = cfg.stem_width

        self.conv1 = nn.Conv2d(3, cfg.stem_width, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(cfg.stem_width)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)

        for stage in range(4):
            planes = cfg.stem_width * (2**stage)
            stride = 1 if stage == 0 else 2
            self.add_module(
                f"layer{stage + 1}",
                self._make_layer(block, planes, cfg.stage_blocks[stage], stride),
            )

        self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
        self.fc = nn.Linear(cfg.feature_dim, cfg.num_classes)

    def _make_layer(self, block, planes, n_blocks, stride):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                _conv1x1(self.inplanes, planes * block.expansion, stride),
                nn.BatchNorm2d(planes * block.expansion),
            )
        kw = (
            {
                "width": planes * self.cfg.width_per_group // 64
                * self.cfg.groups,
                "groups": self.cfg.groups,
            }
            if block is Bottleneck
            else {}
        )
        layers = [block(self.inplanes, planes, stride, downsample, **kw)]
        self.inplanes = planes * block.expansion
        layers += [
            block(self.inplanes, planes, **kw) for _ in range(1, n_blocks)
        ]
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        x = self.avgpool(x)
        x = torch.flatten(x, 1)
        return self.fc(x)


def build_twin(cfg: ResNetConfig, seed: int = 0) -> TorchResNet:
    """The twin with ``nn.Module``'s default init drawn from ``seed`` on the
    CPU; the same seed gives the JAX package's twin, bit for bit.  The
    caller's global RNG is left as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(seed)
        return TorchResNet(cfg)
