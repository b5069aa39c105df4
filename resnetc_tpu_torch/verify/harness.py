"""Parity comparisons: the port's model vs the PyTorch twin.

Counterpart of ``resnetc_tpu/verify/harness.py``: assertable metrics in
place of the reference's manual dump/allclose loop
(pytorch_inference.py:8-11).  The gates come from BASELINE.md: top-1
argmax match and logit MAE <= 1e-3 against the twin under FP32; under BF16
only the argmax, so that dtype error is told apart from bugs.

``logit_report`` and ``stage_parity_report`` run both models on the card
unless ``device="cpu"`` is asked for.  The twin runs under
``torch_ops.exact_fp32``, so the oracle is IEEE fp32 whatever the process's
TF32 settings.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from resnetc_tpu_torch.checkpoint import variables_from_torch_state_dict
from resnetc_tpu_torch.models.resnet import (
    ResNetConfig, _block_forward, _conv_bn_act, forward,
)
from resnetc_tpu_torch.ops import torch_ops
from resnetc_tpu_torch.tensor import FP32, DtypePolicy, nchw_to_nhwc, resolve_device, tree_map

#: End-to-end fp32 logit gate (BASELINE.json north star).
LOGIT_MAE_GATE = 1e-3


@dataclasses.dataclass(frozen=True)
class LogitReport:
    mae: float
    max_abs_err: float
    argmax_match_rate: float
    top1_ours: np.ndarray
    top1_ref: np.ndarray

    @property
    def argmax_match(self) -> bool:
        return self.argmax_match_rate == 1.0


def compare_logits(ours, ref) -> LogitReport:
    """Compare two (B, classes) logit arrays (numpy or CPU/GPU tensors)."""
    ours = _to_numpy(ours)
    ref = _to_numpy(ref)
    if ours.shape != ref.shape:
        raise ValueError(f"logit shape mismatch: {ours.shape} vs {ref.shape}")
    err = np.abs(ours - ref)
    top1_ours = ours.argmax(axis=-1)
    top1_ref = ref.argmax(axis=-1)
    return LogitReport(
        mae=float(err.mean()),
        max_abs_err=float(err.max()),
        argmax_match_rate=float((top1_ours == top1_ref).mean()),
        top1_ours=top1_ours,
        top1_ref=top1_ref,
    )


def _to_numpy(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def _setup(twin, x_nchw, device):
    """(variables, NCHW input, eval-mode twin), all on the device.  A twin
    on another device is copied there; the caller's stays where it is."""
    dev = resolve_device(device)
    variables = tree_map(lambda t: t.to(dev), variables_from_torch_state_dict(twin.state_dict()))
    x = torch.as_tensor(np.asarray(x_nchw, np.float32)).to(dev)
    if next(twin.parameters()).device != dev:
        twin = copy.deepcopy(twin).to(dev)
    twin.eval()
    return variables, x, twin


def logit_report(
    cfg: ResNetConfig,
    twin,  # verify.twin.TorchResNet
    x_nchw,
    *,
    policy: DtypePolicy = FP32,
    device: str | torch.device | None = None,
) -> LogitReport:
    """The same NCHW fp32 batch through the twin (eval mode) and the port's
    ``forward`` (weights imported from the twin); compare the logits."""
    variables, x, twin = _setup(twin, x_nchw, device)
    with torch.no_grad():
        ours, _ = forward(cfg, variables, nchw_to_nhwc(x), train=False, policy=policy)
        with torch_ops.exact_fp32():
            ref = twin(x)
    return compare_logits(ours, ref)


def stage_parity_report(
    cfg: ResNetConfig,
    twin,  # verify.twin.TorchResNet
    x_nchw,
    *,
    policy: DtypePolicy = FP32,
    device: str | torch.device | None = None,
) -> dict[str, dict[str, float]]:
    """Per-stage activation comparison: stem, layer1..4, logits.

    Runs both models, taps each stage boundary and returns
    ``{'stage': {'mae': ..., 'max': ...}}``, so that a numerics regression
    is localised to the first stage that diverges."""
    variables, x, twin = _setup(twin, x_nchw, device)
    taps: dict[str, torch.Tensor] = {}
    ref: dict[str, torch.Tensor] = {}
    with torch.no_grad():
        y = nchw_to_nhwc(x).to(policy.compute)
        y, _ = _conv_bn_act(
            y, variables["conv1"], variables["bn1"], stride=2, padding=3, act=True,
            train=False, policy=policy,
        )
        taps["stem"] = torch_ops.max_pool2d(y, kernel_size=3, stride=2, padding=1)
        y = taps["stem"]
        for stage in range(4):
            layer = f"layer{stage + 1}"
            stage_stride = 1 if stage == 0 else 2
            for b in range(cfg.stage_blocks[stage]):
                s = stage_stride if b == 0 else 1
                y, _ = _block_forward(y, variables[layer][str(b)], cfg, s, train=False,
                                      policy=policy)
            taps[layer] = y
        feats = torch_ops.global_avg_pool(y)
        taps["logits"] = torch_ops.linear(
            feats.to(policy.compute),
            variables["fc"]["weight"].to(policy.compute),
            variables["fc"]["bias"],
        )

        with torch_ops.exact_fp32():
            t = twin.maxpool(twin.relu(twin.bn1(twin.conv1(x))))
            ref["stem"] = nchw_to_nhwc(t)
            for stage in range(4):
                t = getattr(twin, f"layer{stage + 1}")(t)
                ref[f"layer{stage + 1}"] = nchw_to_nhwc(t)
            ref["logits"] = twin.fc(torch.flatten(twin.avgpool(t), 1))

    report = {}
    for name, tap in taps.items():
        err = (tap.float() - ref[name].float()).abs()
        report[name] = {"mae": float(err.mean()), "max": float(err.max())}
    return report
