"""Serving path: an inference engine over BN-folded weights, the file-in,
index-out job, and benchmarks.

Counterpart of ``resnetc_tpu/serve.py:34-388``.  Five backends:

- ``"int8_chain"`` — calibrate static activation scales, quantize (and
  ``pack_chain_kmajor``: the (N, K) weight copies the stride-1 block
  kernels read on the int8 tensor cores, and each basic stage's run
  stacked once), and run
  ``fused_forward_int8_chain`` (every residual block an int8 CUDA kernel,
  for the bottleneck family and the basic family, ResNet-18/34, alike).
  The route follows the flags of ``ops.cuda.fused`` at forward time, as in
  the JAX engine: the code defaults with the repository's ``TUNED.json``
  laid over them at import (stage 0 through the pixel-paired kernels),
  unless ``RESNETC_NO_TUNED=1``.  ``calib_per_channel=True`` calibrates
  the blocks' interior sites per channel and bakes the vectors into the
  weights and epilogue vectors (``bake_interior_scales``), as the JAX
  engine does; the kernels are the same;
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

``classify_files`` is the reference's whole job (convert_imgs_to_bin.py,
then main.cu): image files or ``.bin`` inputs in, class indices out.

The engine runs on the card unless ``device="cpu"`` is asked for; on the
CPU the kernels' plain versions run.  ``mesh=`` (a ``parallel.create_mesh``
mesh) serves any backend data-parallel: every rank builds the engine,
holds its own copy of the weights and calls ``logits`` with the same global
batch, computes its slice and gets the gathered logits
(``fused_forward_sharded``: the ``int8`` backend's scales are the global
batch's; a batch the axis does not divide is padded with copies of a real
image, except under ``int8_chain``, which raises as JAX's does).  A model
axis above 1 (channel tensor parallelism): ``fp`` and ``pallas`` keep
this rank's shard of the folded tree and split every conv's channels over
the axis; ``pallas_block`` keeps the whole tree on every model rank (its
block kernel fuses a whole block, which a channel shard would cut, so it
runs whole, as JAX's partitioner runs an opaque ``pallas_call``); ``int8``
and ``int8_chain`` refuse it, as JAX's engine and CLI do.
Benchmarks time on the card only,
with CUDA events; ``bench_local_latency`` is the engine-local view (the
marginal time of one of a chain of forwards, host included,
``utils.timing``).
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
        calib_per_channel: bool = False,
        device: str | torch.device | None = None,
        mesh=None,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        split = False
        if mesh is not None:
            from resnetc_tpu_torch.ops.cuda.fused import model_axis_refusal
            from resnetc_tpu_torch.parallel import mesh as pmesh

            sizes = pmesh.axis_sizes(mesh)
            split = sizes[pmesh.MODEL_AXIS] > 1
            if split and backend in ("int8", "int8_chain"):
                raise ValueError(model_axis_refusal(
                    backend, sizes[pmesh.DATA_AXIS] * sizes[pmesh.MODEL_AXIS]))
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
        self.mesh = mesh
        self.device = resolve_device(device)
        variables = tree_map(lambda a: torch.as_tensor(a).to(self.device), variables)
        folded = resnet.fold_inference_params(model_cfg, variables)
        self.chain_scales = None
        if backend == "int8_chain":
            from resnetc_tpu_torch.ops.cuda.fused import (
                bake_interior_scales, calibrate_chain_scales, pack_chain_kmajor, quantize_chain,
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
            scales = calibrate_chain_scales(
                model_cfg, folded, calib, policy=policy, method=calib_method,
                per_channel_interior=calib_per_channel,
            )
            # Per-channel interior scales fold into the quantized weights and
            # the producers' epilogue vectors (serve.py:128-133); the runtime
            # scales are then 1 at those sites.  Off by default, as in JAX.
            if calib_per_channel:
                folded, scales = bake_interior_scales(model_cfg, folded, scales)
            else:
                folded = quantize_chain(model_cfg, folded)
            self.chain_scales = scales
            folded = pack_chain_kmajor(model_cfg, folded)
        elif backend == "int8":
            from resnetc_tpu_torch.ops.cuda.quant import pack_kmajor, quantize_folded

            folded = pack_kmajor(quantize_folded(folded))
        elif split and backend != "pallas_block":
            folded = pmesh.shard_tree(mesh, folded)  # this rank's channel shard
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
            if self.mesh is not None and self._ranks() > 1:
                from resnetc_tpu_torch.ops.cuda import fused

                return fused.fused_forward_sharded(
                    self.model_cfg, self.folded, images, self.mesh, backend=self.backend,
                    scales=self.chain_scales, policy=self.policy,
                )
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

    def _ranks(self) -> int:
        from resnetc_tpu_torch.parallel import mesh as pmesh

        sizes = pmesh.axis_sizes(self.mesh)
        return sizes[pmesh.DATA_AXIS] * sizes[pmesh.MODEL_AXIS]

    def classify(self, images) -> np.ndarray:
        """Argmax class indices — the reference's readout."""
        return self.logits(images).argmax(dim=-1).cpu().numpy()


def classify_files(
    engine: InferenceEngine, paths, *, image_size: int = 224
) -> list[int]:
    """Files in, class indices out, one batch through ``engine.classify``
    (``resnetc_tpu/serve.py:364``).  A ``.bin`` is read as the reference's
    preprocessed input (flat NCHW f32, ``image_size`` square, main.cu:236-237);
    any other file is decoded and preprocessed on the host
    (``data.preprocess``)."""
    from resnetc_tpu_torch.data.preprocess import load_input_bin, preprocess_file

    arrays = []
    for p in paths:
        if str(p).endswith(".bin"):
            arrays.append(load_input_bin(p, height=image_size, width=image_size))
        else:
            arrays.append(preprocess_file(p, crop=image_size))
    return [int(i) for i in engine.classify(np.concatenate(arrays))]


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
    p99_ms: float | None
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


def bench_local_latency(
    engine: InferenceEngine, images, *, runs: int = 7, iters: int = 32
) -> LatencyResult:
    """Engine-local latency of one forward on the card: each of ``runs``
    samples is ``utils.timing.chained_seconds_per_iter`` over ``iters``
    chained forwards, the marginal time of one without the host's wait for
    a result (``resnetc_tpu/serve.py:322``).  This is host-inclusive, not
    device time: the eager forward's launches are issued by the host, and
    where the host issues them slower than the card runs them the sample
    is the host's time per forward.  For device time, sum the kernels'
    events of a ``utils.metrics.profile_trace``.  No p99: each sample
    is already a mean over ``iters`` forwards, and a percentile over a
    handful of means is not a tail (``bench_latency`` has the tail)."""
    from resnetc_tpu_torch.utils.timing import chained_seconds_per_iter

    _require_card(engine)
    images = torch.as_tensor(images)
    if images.ndim == 3:
        images = images[None]
    images = images.to(engine.device)
    samples = [chained_seconds_per_iter(engine.logits, images, iters=iters)
               for _ in range(runs)]
    arr = np.asarray(samples) * 1e3
    return LatencyResult(
        p50_ms=float(np.percentile(arr, 50)),
        p99_ms=None,
        mean_ms=float(arr.mean()),
        samples=runs,
    )
