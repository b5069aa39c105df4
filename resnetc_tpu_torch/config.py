"""Config layer: every constant the reference compiles in becomes a flag.

A copy of ``resnetc_tpu/config.py:29-136`` (``RunConfig``,
``add_run_args``, ``run_config_from_args``) for the port: the model
variant, batch, dtype policy, mesh shape, serving backend, paths and seed.
The backends are the port's (``serve.BACKENDS``; ``fp`` is the JAX
package's ``xla``).
"""

from __future__ import annotations

import argparse
import dataclasses

from resnetc_tpu_torch.models.resnet import RESNET_CONFIGS

# Serving backends, as ``resnetc_tpu_torch.serve.BACKENDS`` (not imported:
# the config layer stays free of the serving code).
BACKENDS = ("int8_chain", "fp", "int8", "pallas_block", "pallas")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Top-level invocation config shared by the CLI commands."""

    model: str = "resnet50"
    num_classes: int = 1000
    batch_size: int = 256
    image_size: int = 224
    policy: str = "bf16"  # "bf16" | "fp32"
    #: "fp" (bf16, cuDNN) is the accuracy-safe default; "int8_chain" is
    #: the fastest serving backend (PERF.md section 6).
    backend: str = "fp"  # one of BACKENDS
    weights_dir: str | None = None  # reference raw-f32 weight directory
    data_dim: int = 1  # mesh data axis
    model_dim: int = 1  # mesh model axis (channel TP)
    calib_method: str = "absmax"  # int8 calibration: absmax | percentile | mse
    calib_per_channel: bool = False  # per-channel interior activation scales
    seed: int = 0
    # Multi-process training (one rank per process; ``train`` only).
    multihost: bool = False
    coordinator: str | None = None  # "host:port"
    num_processes: int | None = None
    process_id: int | None = None


def add_run_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", default="resnet50", choices=sorted(RESNET_CONFIGS))
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--policy", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--backend", default="fp", choices=list(BACKENDS))
    p.add_argument(
        "--weights-dir",
        default=None,
        help="directory of raw-f32 weight files named by state_dict key "
        "(the reference's save_weights.py format); random init if omitted",
    )
    p.add_argument(
        "--calib-method",
        default="absmax",
        choices=["absmax", "percentile", "mse"],
        help="int8 activation-scale calibration (percentile clips at the "
        "99.9th percentile of |act|; mse picks the per-site clip that "
        "minimizes quantization MSE — both robust to outlier activations)",
    )
    p.add_argument(
        "--calib-per-channel", action=argparse.BooleanOptionalAction,
        default=False,
        help="per-channel scales at the interior int8 sites (baked into "
        "the weights and epilogue vectors; the kernels are the same). Off "
        "by default, as in the JAX package",
    )
    p.add_argument(
        "--data-dim", type=int, default=1,
        help="mesh data-parallel axis size (train: ranks, spawned on this host "
        "unless --multihost)",
    )
    p.add_argument(
        "--model-dim", type=int, default=1,
        help="mesh channel-TP axis size (not ported yet: only 1 is taken)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--multihost", action="store_true",
        help="multi-process training: this process is one rank (train only)",
    )
    p.add_argument("--coordinator", default=None, help='multi-host coordinator "host:port"')
    p.add_argument("--num-processes", type=int, default=None, help="multi-host total process count")
    p.add_argument("--process-id", type=int, default=None, help="this process's multi-host index")


def run_config_from_args(args: argparse.Namespace) -> RunConfig:
    multihost = bool(
        getattr(args, "multihost", False)
        or getattr(args, "coordinator", None) is not None
    )
    if not multihost and (
        getattr(args, "num_processes", None) is not None
        or getattr(args, "process_id", None) is not None
    ):
        # Silently dropping these would leave every worker training the
        # full global batch independently with no all-reduce — the exact
        # looks-distributed-but-isn't failure the serving commands guard.
        raise SystemExit(
            "--num-processes/--process-id require --multihost or "
            "--coordinator host:port"
        )
    return RunConfig(
        model=args.model,
        num_classes=args.num_classes,
        batch_size=args.batch_size,
        image_size=args.image_size,
        policy=args.policy,
        backend=args.backend,
        weights_dir=args.weights_dir,
        data_dim=args.data_dim,
        model_dim=args.model_dim,
        calib_method=args.calib_method,
        calib_per_channel=getattr(args, "calib_per_channel", False),
        seed=args.seed,
        multihost=multihost,
        coordinator=getattr(args, "coordinator", None),
        num_processes=getattr(args, "num_processes", None),
        process_id=getattr(args, "process_id", None),
    )
