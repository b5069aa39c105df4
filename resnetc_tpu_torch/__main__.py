"""CLI of the port:

  python -m resnetc_tpu_torch train     # training loop on synthetic data
  python -m resnetc_tpu_torch verify    # parity report against the torch twin

Counterpart of ``resnetc_tpu/__main__.py`` (``train`` :130-283, ``verify``
:337-369, the parser :372-450), with the same flags.  Both run on the card
and raise where there is none.  ``train`` trains data-parallel with
``--data-dim N`` (N ranks on this host) or ``--multihost --coordinator
host:port --num-processes N --process-id i`` (one rank a process); a
``--model-dim`` above 1 is refused.  The serving commands (classify, bench,
eval, export-weights, convert-images) are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _refuse_unported(run, args) -> None:
    if run.model_dim > 1:
        raise SystemExit(
            "--model-dim > 1 (channel tensor parallelism) is not ported yet "
            "(ROADMAP Queue 1 item 3b); train data-parallel with --data-dim"
        )
    if getattr(args, "data_dir", None):
        raise SystemExit(
            "--data-dir is not ported yet (ROADMAP Queue 1 item 4: the "
            "ImageFolder pipeline); omit it to train on synthetic batches"
        )


def run_train(args: argparse.Namespace, *, device=None):
    """The ``train`` command's body.  ``device=None`` is the card, as for
    every entry point; ``device="cpu"`` runs every rank on the CPU.

    One process: returns the final ``TrainState``.  ``--multihost``: this
    process is rank ``--process-id`` of ``--num-processes``, meeting at
    ``--coordinator``; it draws its own slice of the global batch from
    ``seed + rank`` (JAX ``__main__.py:194-217``) and returns its final
    state.  ``--data-dim N`` on one host: N ranks spawned here
    (``parallel.distributed.spawn``), each taking its slice of the one
    global batch drawn from ``seed``, so the run logs what the one-rank
    run logs; returns None.  Rank 0 writes the metrics log to stdout, the
    checkpoint and the export; the other ranks write their records to
    stderr."""
    from resnetc_tpu_torch.config import run_config_from_args
    from resnetc_tpu_torch.parallel import distributed
    from resnetc_tpu_torch.tensor import resolve_device

    run = run_config_from_args(args)
    _refuse_unported(run, args)
    if run.multihost:
        dev = distributed.initialize(run.coordinator, run.num_processes, run.process_id,
                                     device=device)
        try:
            return _train(run, args, dev, parallel=True, local_batch=True)
        finally:
            distributed.shutdown()
    if run.data_dim > 1:
        # A rank unpickles its target by module name, and under ``python -m``
        # this module is ``__main__``, which a spawned process does not
        # import: pass the function (and no ``args.fn``) under the package
        # name.
        from resnetc_tpu_torch import __main__ as cli

        rank_args = argparse.Namespace(**{k: v for k, v in vars(args).items() if k != "fn"})
        distributed.spawn(cli._train_rank, run.data_dim, run, rank_args, device=device)
        return None
    return _train(run, args, resolve_device(device), parallel=False, local_batch=False)


def _train_rank(dev, run, args) -> None:
    """One rank of a single-host ``--data-dim N`` run (``spawn``)."""
    _train(run, args, dev, parallel=True, local_batch=False)


def _train(run, args, dev, *, parallel: bool, local_batch: bool):
    import torch

    from resnetc_tpu_torch import train
    from resnetc_tpu_torch.data.loader import synthetic_batches
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.parallel import distributed
    from resnetc_tpu_torch.utils.metrics import MetricsLogger

    cfg = resnet.get_config(run.model, num_classes=run.num_classes)
    tcfg = train.TrainConfig(
        lr=args.lr, momentum=args.momentum, weight_decay=args.weight_decay,
        label_smoothing=args.label_smoothing, policy_name=run.policy,
        remat=args.remat,
    )
    sched = train.cosine_schedule(args.lr, args.steps, warmup_steps=args.warmup_steps)
    rank = torch.distributed.get_rank() if parallel else 0
    log = MetricsLogger(sys.stdout if rank == 0 else sys.stderr, prefix="train")

    ts = train.init_train_state(cfg, torch.Generator().manual_seed(run.seed), device=dev)
    if args.resume and rank == 0:
        from resnetc_tpu_torch.checkpoint import load_train_state

        ts = load_train_state(args.resume, ts)
        print(f"resumed from {args.resume} at step {int(ts.step)}")
    if parallel:
        from resnetc_tpu_torch.parallel import create_mesh

        # --data-dim sizes the data axis; a --multihost run left at 1 takes
        # every rank.
        mesh = create_mesh(run.data_dim if run.data_dim > 1 else None, run.model_dim,
                           device_type=dev.type)
        step_fn, shard_state, _ = train.sharded_train_step(cfg, tcfg, mesh,
                                                           local_batch=local_batch)
        ts = shard_state(ts)
    else:
        def step_fn(ts, x, y, lr):
            return train.train_step(cfg, tcfg, ts, x, y, lr)

    batch_size, seed = run.batch_size, run.seed
    if local_batch:
        _, batch_size = distributed.global_batch_slice(run.batch_size)
        seed += rank
    batches = synthetic_batches(
        batch_size=batch_size, image_size=run.image_size, steps=args.steps,
        num_classes=run.num_classes, seed=seed, device=dev,
    )
    t_last = time.perf_counter()
    for i, (x, y) in enumerate(batches):
        ts, m = step_fn(ts, x, y, sched(ts.step))
        if (i + 1) % args.log_every == 0:
            record = {
                "step": int(ts.step),
                "loss": float(m["loss"]),
                "accuracy": float(m["accuracy"]),
            }
            now = time.perf_counter()
            record["images_per_sec"] = run.batch_size * args.log_every / (now - t_last)
            log.log(record)
            t_last = now
    if args.checkpoint_dir:
        from resnetc_tpu_torch.checkpoint import save_train_state

        save_train_state(args.checkpoint_dir, ts)  # rank 0 writes; all ranks wait
        if rank == 0:
            print(f"saved checkpoint to {args.checkpoint_dir}")
    if args.export_weights_dir and rank == 0:
        # The serving engines load this format (load_reference_format).
        from resnetc_tpu_torch.checkpoint import save_reference_format

        variables = resnet.merge_params_state(ts.params, ts.bn_state)
        n = save_reference_format(variables, args.export_weights_dir)
        print(f"exported {n} weight files to {args.export_weights_dir}")
    return ts


def cmd_train(args) -> int:
    run_train(args)
    return 0


def run_verify(args: argparse.Namespace, *, device=None) -> dict:
    """The ``verify`` command's body: the JSON record it prints.  ``pass``
    is the JAX CLI's rule: argmax match, and under FP32 also logit MAE
    <= 1e-3."""
    import numpy as np

    from resnetc_tpu_torch.config import run_config_from_args
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.tensor import policy as get_policy
    from resnetc_tpu_torch.verify.harness import (
        LOGIT_MAE_GATE, logit_report, stage_parity_report,
    )
    from resnetc_tpu_torch.verify.twin import build_twin

    run = run_config_from_args(args)
    _refuse_unported(run, args)
    if run.multihost or run.data_dim > 1:
        raise SystemExit(
            "verify runs in one process, as the JAX CLI's does (it takes no "
            "mesh); --data-dim and --multihost are for train (ROADMAP Queue 1 "
            "item 3)"
        )
    cfg = resnet.get_config(run.model, num_classes=run.num_classes)
    twin = build_twin(cfg, seed=run.seed)
    twin.eval()
    x = np.random.default_rng(run.seed).standard_normal(
        (args.verify_batch, 3, run.image_size, run.image_size)
    ).astype(np.float32)
    policy = get_policy(run.policy)
    rep = logit_report(cfg, twin, x, policy=policy, device=device)
    result = {
        "model": run.model,
        "policy": run.policy,
        "logit_mae": rep.mae,
        "max_abs_err": rep.max_abs_err,
        "argmax_match_rate": rep.argmax_match_rate,
        "pass": bool(rep.argmax_match and (run.policy != "fp32" or rep.mae <= LOGIT_MAE_GATE)),
    }
    if args.per_stage:
        result["stages"] = stage_parity_report(cfg, twin, x, policy=policy, device=device)
    return result


def cmd_verify(args) -> int:
    result = run_verify(args)
    print(json.dumps(result))
    return 0 if result["argmax_match_rate"] == 1.0 else 1


def build_parser() -> argparse.ArgumentParser:
    from resnetc_tpu_torch.config import add_run_args

    parser = argparse.ArgumentParser(prog="resnetc_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train", help="training loop (synthetic data)")
    add_run_args(p)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument(
        "--remat", action="store_true",
        help="checkpoint residual blocks in the backward pass (activation "
        "memory ~O(depth) smaller for a recomputed forward)",
    )
    p.add_argument("--warmup-steps", type=int, default=5)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume", default=None, help="checkpoint dir to resume from")
    p.add_argument(
        "--data-dir", default=None,
        help="ImageFolder tree (not ported yet: the command refuses it)",
    )
    p.add_argument(
        "--export-weights-dir", default=None,
        help="after training, also export the reference's raw-f32 weight "
        "files (what the serving engines load)",
    )
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("verify", help="numeric parity vs the torch twin")
    add_run_args(p)
    p.add_argument("--verify-batch", type=int, default=2)
    p.add_argument(
        "--per-stage", action="store_true",
        help="also report per-stage activation MAE (the check_out workflow)",
    )
    p.set_defaults(fn=cmd_verify)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
