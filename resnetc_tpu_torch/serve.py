"""Serving path: an inference engine over BN-folded weights, and benchmarks.

Counterpart of ``resnetc_tpu/serve.py:34-363``.  Five backends:

- ``"int8_chain"`` — calibrate static activation scales, quantize (and
  ``pack_chain_kmajor``: the (N, K) weight copies the stride-1 block
  kernels read on the int8 tensor cores, and each basic stage's run
  stacked once), and run
  ``fused_forward_int8_chain`` (every residual block an int8 CUDA kernel,
  for the bottleneck family and the basic family, ResNet-18/34, alike).
  The route follows the flags of ``ops.cuda.fused`` at forward time, as in
  the JAX engine: the code defaults with the repository's ``TUNED.json``
  laid over them at import (stage 0 through the pixel-paired kernels),
  unless ``RESNETC_NO_TUNED=1``;
- ``"int8"`` — ``quantize_folded`` at construction (and
  ``pack_kmajor``: the (N, K) weight copies the int8 kernel reads), then
  ``fused_forward_int8``: every 1x1 conv and the fc through ``int8_matmul``
  with a per-tensor scale taken over the batch at each call, the 3x3 convs
  through ``conv3x3_s1_fused`` / ``conv3x3_s2_fused``;
- ``"pallas"`` — ``fused_forward`` over the folded tree, every conv a
  kernel in ``policy.compute``;
- ``"pallas_block"`` — ``fused_forward(block_fusion=True)``: as ``pallas``,
  but every stride-1 bottleneck block without a projection is one
  ``bottleneck_block_chained`` over the chain layout (a basic net takes the
  ``pallas`` route);
- ``"fp"`` — ``forward_folded`` on stock PyTorch ops (the JAX package's
  ``xla`` backend).

``pallas`` and ``pallas_block`` are reference paths: the engine warns when
one is built, as the JAX engine does.

The engine runs on the card unless ``device="cpu"`` is asked for; on the
CPU the kernels' plain versions run.  Benchmarks time on the card only,
with CUDA events.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from resnetc_tpu_torch.models import resnet
from resnetc_tpu_torch.tensor import BF16, DtypePolicy, resolve_device, tree_map

Tree = dict
BACKENDS = ("fp", "pallas", "pallas_block", "int8", "int8_chain")


class InferenceEngine:
    """A classifier: folded (and for int8 / int8_chain, quantized) weights
    resident on the device.  The kernel backends serve every ungrouped
    config of ``models.resnet`` (``int8_chain``: ResNet-18/34 through the
    basic kernels, the bottleneck nets through theirs); ``fp`` serves every
    config."""

    def __init__(
        self,
        model_cfg: resnet.ResNetConfig,
        variables: Tree,
        *,
        policy: DtypePolicy = BF16,
        backend: str = "fp",
        calib_batch=None,
        calib_method: str = "absmax",
        device: str | torch.device | None = None,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        if backend != "fp" and model_cfg.groups > 1:
            raise ValueError(
                f"backend {backend!r} does not support grouped convolutions (ResNeXt, "
                f"groups={model_cfg.groups}); serve grouped models with backend='fp'"
            )
        if backend in ("pallas", "pallas_block"):
            # The JAX engine's deprecation notice (serve.py:69-82), with the
            # port's names: the bf16 kernel paths are a reference, not a
            # server.  PERF.md has their times on the card.
            warnings.warn(
                f"backend {backend!r} is a bf16 kernel reference path (see PERF.md "
                "for its times); use 'int8_chain' or 'fp' for serving.",
                stacklevel=2,
            )
        self.model_cfg = model_cfg
        self.policy = policy
        self.backend = backend
        self.device = resolve_device(device)
        variables = tree_map(lambda a: torch.as_tensor(a).to(self.device), variables)
        folded = resnet.fold_inference_params(model_cfg, variables)
        self.chain_scales = None
        if backend == "int8_chain":
            from resnetc_tpu_torch.ops.cuda.fused import (
                calibrate_chain_scales, pack_chain_kmajor, quantize_chain,
            )

            if calib_batch is None:
                warnings.warn(
                    "int8_chain engine built without calib_batch: activation "
                    "scales are calibrated on unit-normal noise. Fine for "
                    "benchmarking; pass real preprocessed images for serving.",
                    stacklevel=2,
                )
                gen = torch.Generator().manual_seed(0)
                calib_batch = torch.randn((8, 224, 224, 3), generator=gen)
            calib = torch.as_tensor(calib_batch, dtype=torch.float32).to(self.device)
            self.chain_scales = calibrate_chain_scales(
                model_cfg, folded, calib, policy=policy, method=calib_method
            )
            folded = pack_chain_kmajor(model_cfg, quantize_chain(model_cfg, folded))
        elif backend == "int8":
            from resnetc_tpu_torch.ops.cuda.quant import pack_kmajor, quantize_folded

            folded = pack_kmajor(quantize_folded(folded))
        self.folded = folded

    def logits(self, images) -> torch.Tensor:
        """(B, num_classes) logits for NHWC images (numpy or tensor)."""
        images = torch.as_tensor(images)
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError(
                f"expected NHWC images [B, H, W, 3], got {tuple(images.shape)} — "
                "NCHW inputs must go through resnetc_tpu_torch.tensor.nchw_to_nhwc"
            )
        images = images.to(self.device)
        with torch.inference_mode():
            if self.backend == "fp":
                return resnet.forward_folded(
                    self.model_cfg, self.folded, images, policy=self.policy
                )
            from resnetc_tpu_torch.ops.cuda import fused

            if self.backend in ("pallas", "pallas_block"):
                return fused.fused_forward(
                    self.model_cfg, self.folded, images, policy=self.policy,
                    block_fusion=self.backend == "pallas_block",
                )
            if self.backend == "int8":
                return fused.fused_forward_int8(
                    self.model_cfg, self.folded, images, policy=self.policy
                )
            return fused.fused_forward_int8_chain(
                self.model_cfg, self.folded, self.chain_scales, images,
                policy=self.policy,
            )

    def classify(self, images) -> np.ndarray:
        """Argmax class indices — the reference's readout."""
        return self.logits(images).argmax(dim=-1).cpu().numpy()


# ---------------------------------------------------------------------------
# Benchmarks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ThroughputResult:
    images_per_sec: float
    batch_size: int
    steps: int
    seconds: float


@dataclasses.dataclass(frozen=True)
class LatencyResult:
    p50_ms: float
    p99_ms: float
    mean_ms: float
    samples: int


def _require_card(engine: InferenceEngine) -> None:
    if engine.device.type != "cuda":
        raise RuntimeError("benchmarks time the card; build the engine on a CUDA device")


def bench_throughput(
    engine: InferenceEngine, images, *, steps: int = 20, warmup: int = 3
) -> ThroughputResult:
    """Steady-state batched throughput: ``steps`` back-to-back forwards
    between two CUDA events, after ``warmup`` forwards."""
    _require_card(engine)
    images = torch.as_tensor(images).to(engine.device)
    for _ in range(warmup):
        engine.logits(images)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(steps):
        engine.logits(images)
    end.record()
    torch.cuda.synchronize()
    sec = start.elapsed_time(end) / 1e3
    return ThroughputResult(
        images_per_sec=images.shape[0] * steps / sec,
        batch_size=images.shape[0],
        steps=steps,
        seconds=sec,
    )


def bench_latency(
    engine: InferenceEngine, images, *, samples: int = 50, warmup: int = 5
) -> LatencyResult:
    """Per-request latency distribution: each sample is one forward between
    two CUDA events recorded around it, waited on before the next sample."""
    _require_card(engine)
    images = torch.as_tensor(images)
    if images.ndim == 3:
        images = images[None]
    images = images.to(engine.device)
    for _ in range(warmup):
        engine.logits(images)
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        engine.logits(images)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    arr = np.asarray(times)
    return LatencyResult(
        p50_ms=float(np.percentile(arr, 50)),
        p99_ms=float(np.percentile(arr, 99)),
        mean_ms=float(arr.mean()),
        samples=samples,
    )
