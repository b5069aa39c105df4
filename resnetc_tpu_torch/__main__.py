"""CLI of the port:

  python -m resnetc_tpu_torch classify IMG [IMG...]   # files -> top-1 index
  python -m resnetc_tpu_torch bench                   # serving throughput/latency
  python -m resnetc_tpu_torch eval DIR                # top-1/top-5 over an ImageFolder tree
  python -m resnetc_tpu_torch train                   # training loop (synthetic or image dir)
  python -m resnetc_tpu_torch export-weights DIR      # random/loaded weights -> raw-f32 files
  python -m resnetc_tpu_torch convert-images SRC DST  # images -> reference .bin files
  python -m resnetc_tpu_torch verify                  # parity report vs the torch twin

Counterpart of ``resnetc_tpu/__main__.py``, with the same flags and
defaults (the backend ``fp`` is JAX's ``xla``).  Every command that touches
a model runs on the card and raises where there is none; each has a
``run_<command>(args, *, device=None)`` body the tests call with
``device="cpu"``.  ``train`` trains over a (data, model) mesh of
``--data-dim N --model-dim M`` (N * M ranks on this host) or ``--multihost
--coordinator host:port --num-processes N --process-id i`` (one rank a
process, ``--model-dim M`` of them to a replica).  The serving commands
(classify, bench, eval) serve over N * M ranks spawned on this host: each
rank builds the engine with the mesh and takes the same global batch, and
the command prints what rank 0 returns, which is what one process prints.
They refuse ``--multihost`` as JAX's do.  ``--model-dim M`` splits the
channels of ``fp`` and ``pallas`` (and of the train step) over M ranks,
replicates ``pallas_block`` over them, and is refused by ``int8`` and
``int8_chain``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _serving_run(args: argparse.Namespace):
    """The ``RunConfig`` of a serving command (classify, bench, eval), with
    the JAX CLI's refusals (``__main__.py:31-59``)."""
    from resnetc_tpu_torch.config import run_config_from_args

    run = run_config_from_args(args)
    if run.multihost:
        # The serving commands do not join ranks across processes: each
        # process would build the full batch locally and silently
        # benchmark/classify it alone, which is NOT a distributed run.  Only
        # `train` implements the multi-process data path.
        raise SystemExit(
            "--multihost/--coordinator are supported by the `train` "
            "command only; for serving over ranks on one host use --data-dim"
        )
    if run.backend in ("int8", "int8_chain") and run.model_dim > 1:
        # int8_chain replicates weights and shards only the 'data' axis;
        # JAX's int8 engine cannot place its tree under a mesh.
        from resnetc_tpu_torch.ops.cuda.fused import model_axis_refusal

        raise SystemExit(model_axis_refusal(run.backend, run.data_dim * run.model_dim))
    _check_model_axis(run)
    return run


def _check_model_axis(run) -> None:
    """Refuse, before any rank starts, a model axis that does not divide
    the model's channels (``parallel.tp.check_config``)."""
    if run.model_dim > 1:
        from resnetc_tpu_torch.models import resnet
        from resnetc_tpu_torch.parallel import tp

        try:
            tp.check_config(resnet.get_config(run.model), run.model_dim)
        except ValueError as e:
            raise SystemExit(str(e)) from None


def _serving(command: str, args: argparse.Namespace, device):
    """Run a serving command's body (``_SERVING[command]``) in this process,
    or with ``--data-dim N --model-dim M`` on N * M spawned ranks, and
    return rank 0's result.  ``bench`` refuses the CPU, and ``int8_chain``
    over a data axis: its latency request is one image, which
    ``int8_chain`` does not split over ranks (JAX's ``shard_map`` raises on
    it, ``fused_forward_int8_chain_sharded``)."""
    from resnetc_tpu_torch.tensor import resolve_device

    run = _serving_run(args)
    if command == "bench" and run.backend == "int8_chain" and run.data_dim > 1:
        raise SystemExit("bench --backend int8_chain does not run over --data-dim > 1: its "
                         "latency request is one image, and int8_chain does not split a "
                         f"batch that {run.data_dim} data ranks do not divide (JAX's "
                         "shard_map raises on it)")
    if command == "bench" and resolve_device(device).type != "cuda":
        raise SystemExit("bench times the card; it does not run on the CPU")
    if run.data_dim * run.model_dim > 1:
        from resnetc_tpu_torch import __main__ as cli
        from resnetc_tpu_torch.parallel import distributed

        # Under ``python -m`` this module is ``__main__``, which a spawned
        # rank does not import: pass the function under the package name.
        rank_args = argparse.Namespace(**{k: v for k, v in vars(args).items() if k != "fn"})
        return distributed.spawn(cli._serving_rank, run.data_dim * run.model_dim, command,
                                 run, rank_args, device=device)[0]
    return _SERVING[command](run, args, device, None)


def _serving_rank(dev, command, run, args):
    """One rank of a ``--data-dim N --model-dim M`` serving command
    (``spawn``)."""
    from resnetc_tpu_torch.parallel import create_mesh

    mesh = create_mesh(run.data_dim, run.model_dim, device_type=dev.type)
    return _SERVING[command](run, args, dev, mesh)


def _model(run):
    """(model config, variables on the CPU): the weights of
    ``--weights-dir``, or the model initialised from ``--seed``."""
    import torch

    from resnetc_tpu_torch import checkpoint
    from resnetc_tpu_torch.models import resnet

    cfg = resnet.get_config(run.model, num_classes=run.num_classes)
    if run.weights_dir:
        return cfg, checkpoint.load_reference_format(cfg, run.weights_dir)
    return cfg, resnet.init(cfg, torch.Generator().manual_seed(run.seed))


def _build_engine(run, device=None, mesh=None):
    """(model config, ``InferenceEngine``) for a serving command; JAX's
    ``__main__.py:24-72``: every backend replicated over ``mesh``'s data
    axis, and ``fp`` / ``pallas`` split over its model axis."""
    from resnetc_tpu_torch.serve import InferenceEngine
    from resnetc_tpu_torch.tensor import policy

    cfg, variables = _model(run)
    return cfg, InferenceEngine(
        cfg, variables, policy=policy(run.policy), backend=run.backend,
        calib_method=run.calib_method, calib_per_channel=run.calib_per_channel,
        device=device, mesh=mesh,
    )


def run_classify(args: argparse.Namespace, *, device=None) -> list[str]:
    """The ``classify`` command's body: one line per file,
    ``"{path}: class {cls}"`` (and `` ({name})`` from ``--labels-file``),
    the reference's "max index is N" (main.cu:250)."""
    return _serving("classify", args, device)


def _classify(run, args, device, mesh) -> list[str]:
    from resnetc_tpu_torch.serve import classify_files

    _, engine = _build_engine(run, device, mesh)
    labels = None
    if args.labels_file:
        # One class name per line, line i = class index i (the torchvision
        # categories format); indices past the file fall back to numbers.
        with open(args.labels_file) as f:
            labels = [ln.strip() for ln in f]
    classes = classify_files(engine, args.images, image_size=run.image_size)
    lines = []
    for path, cls in zip(args.images, classes):
        name = f" ({labels[cls]})" if labels and 0 <= cls < len(labels) else ""
        lines.append(f"{path}: class {cls}{name}")
    return lines


def cmd_classify(args) -> int:
    for line in run_classify(args):
        print(line)
    return 0


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them
    (``name, power.limit``), or torch's name where nvidia-smi is absent."""
    import subprocess

    import torch

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit unknown"


def run_bench(args: argparse.Namespace, *, device=None) -> dict:
    """The ``bench`` command's body: throughput over ``--steps`` forwards of
    a seeded batch, and the latency of one image over
    ``--latency-samples`` requests, as the JAX CLI's JSON record
    (``__main__.py:117-126``) plus the card.  Times the card: refuses the
    CPU.  Over ranks each forward is the sharded one (the one image of a
    latency request padded to a copy a rank; ``int8_chain`` refuses a data
    axis, ``_serving``)."""
    return _serving("bench", args, device)


def _bench(run, args, device, mesh) -> dict:
    import numpy as np

    from resnetc_tpu_torch.serve import bench_latency, bench_throughput
    from resnetc_tpu_torch.utils.flops import model_flops

    cfg, engine = _build_engine(run, device, mesh)
    images = np.random.default_rng(0).standard_normal(
        (run.batch_size, run.image_size, run.image_size, 3), dtype=np.float32
    )
    tp = bench_throughput(engine, images, steps=args.steps)
    lat = bench_latency(engine, images[:1], samples=args.latency_samples)
    flops = model_flops(cfg, run.image_size)
    return {
        "model": run.model,
        "backend": run.backend,
        "batch_size": run.batch_size,
        "images_per_sec": round(tp.images_per_sec, 2),
        "p50_latency_ms": round(lat.p50_ms, 3),
        "p99_latency_ms": round(lat.p99_ms, 3),
        "gflops_per_image": round(flops / 1e9, 2),
        "platform": "gpu",
        "card": card_line(),
    }


def cmd_bench(args) -> int:
    print(json.dumps(run_bench(args)))
    return 0


def run_eval(args: argparse.Namespace, *, device=None) -> dict:
    """The ``eval`` command's body: top-1 / top-5 and the image count over
    the ImageFolder tree ``args.data_dir`` (``data.imagefolder.evaluate``)."""
    return _serving("eval", args, device)


def _eval(run, args, device, mesh) -> dict:
    from resnetc_tpu_torch.data import evaluate

    _, engine = _build_engine(run, device, mesh)
    result = evaluate(engine, args.data_dir, batch_size=run.batch_size,
                      image_size=run.image_size)
    return {"model": run.model, **result}


#: The serving commands' bodies: ``(run, args, device, mesh) -> result``.
_SERVING = {"classify": _classify, "bench": _bench, "eval": _eval}


def cmd_eval(args) -> int:
    print(json.dumps(run_eval(args)))
    return 0


def run_export_weights(args: argparse.Namespace) -> int:
    """The ``export-weights`` command's body: the model's weights
    (``--weights-dir``, or initialised from ``--seed``) as the reference's
    raw-f32 files in ``args.out_dir``; returns the number of files.  Host
    only: no device is touched."""
    from resnetc_tpu_torch import checkpoint
    from resnetc_tpu_torch.config import run_config_from_args

    _, variables = _model(run_config_from_args(args))
    return checkpoint.save_reference_format(variables, args.out_dir)


def cmd_export_weights(args) -> int:
    n = run_export_weights(args)
    print(f"wrote {n} weight files to {args.out_dir} (save_weights.py format)")
    return 0


def run_convert_images(args: argparse.Namespace) -> int:
    """The ``convert-images`` command's body: every ``.jpg`` / ``.jpeg`` /
    ``.png`` in ``args.image_dir`` preprocessed with PIL (the eval
    transform, 224 px) and written as the reference's ``.bin`` input under
    ``args.out_dir`` (convert_imgs_to_bin.py); returns the number of
    files."""
    from pathlib import Path

    from resnetc_tpu_torch.data.preprocess import preprocess_file, save_input_bin

    out = Path(args.out_dir)
    n = 0
    for img in sorted(Path(args.image_dir).iterdir()):
        if img.suffix.lower() not in (".jpg", ".jpeg", ".png"):
            continue
        save_input_bin(preprocess_file(img), out / (img.stem + ".bin"))
        n += 1
    return n


def cmd_convert_images(args) -> int:
    n = run_convert_images(args)
    print(f"converted {n} images to {args.out_dir}")
    return 0


def run_train(args: argparse.Namespace, *, device=None):
    """The ``train`` command's body.  ``device=None`` is the card, as for
    every entry point; ``device="cpu"`` runs every rank on the CPU.

    One process: returns the final ``TrainState``.  ``--multihost``: this
    process is rank ``--process-id`` of ``--num-processes``, meeting at
    ``--coordinator``; it draws its own slice of the global batch from
    ``seed + rank`` (JAX ``__main__.py:194-217``), or with ``--data-dir``
    reads its strided shard of every epoch (``shard=(rank, n)``), and
    returns its final state.  ``--data-dim N --model-dim M`` on one host:
    N * M ranks spawned here (``parallel.distributed.spawn``), each taking
    its data slice of the one global batch (drawn from ``seed``, or read
    from ``--data-dir``), so the run logs what the one-rank run logs;
    returns None.  ``--model-dim M`` splits the channels of the state and
    the forward over M ranks (``train.sharded_train_step``); under
    ``--multihost`` the M ranks of one replica (consecutive ranks) draw the
    same slice.  ``--data-dir``: ``ImageFolderLoader(train=True,
    epochs=10**9, seed=seed)``, its random crops decoded on background
    threads, ``--steps`` batches.  Rank 0 writes the metrics log to stdout,
    the checkpoint and the export, of the whole state gathered over the
    model axis (what one process writes); the other ranks write their
    records to stderr.  ``--resume`` loads the whole state on the first
    replica's ranks, which ``shard_state`` shares and shards."""
    from resnetc_tpu_torch.config import run_config_from_args
    from resnetc_tpu_torch.parallel import distributed
    from resnetc_tpu_torch.tensor import resolve_device

    run = run_config_from_args(args)
    _check_model_axis(run)
    if run.multihost:
        dev = distributed.initialize(run.coordinator, run.num_processes, run.process_id,
                                     device=device)
        try:
            return _train(run, args, dev, parallel=True, local_batch=True)
        finally:
            distributed.shutdown()
    if run.data_dim * run.model_dim > 1:
        # A rank unpickles its target by module name, and under ``python -m``
        # this module is ``__main__``, which a spawned process does not
        # import: pass the function (and no ``args.fn``) under the package
        # name.
        from resnetc_tpu_torch import __main__ as cli

        rank_args = argparse.Namespace(**{k: v for k, v in vars(args).items() if k != "fn"})
        distributed.spawn(cli._train_rank, run.data_dim * run.model_dim, run, rank_args,
                          device=device)
        return None
    return _train(run, args, resolve_device(device), parallel=False, local_batch=False)


def _train_rank(dev, run, args) -> None:
    """One rank of a single-host ``--data-dim N --model-dim M`` run
    (``spawn``)."""
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
    # The ranks of the first replica (data index 0, ranks 0..M-1 of the
    # row-major mesh) hold what shard_state shares over the data axis.
    if args.resume and rank < run.model_dim:
        from resnetc_tpu_torch.checkpoint import load_train_state

        ts = load_train_state(args.resume, ts)
        if rank == 0:
            print(f"resumed from {args.resume} at step {int(ts.step)}")
    mesh = None
    shard = (0, 1)  # this rank's (data index, data ranks)
    if parallel:
        from resnetc_tpu_torch.parallel import create_mesh
        from resnetc_tpu_torch.parallel import mesh as pmesh

        # --data-dim sizes the data axis; a --multihost run left at 1 takes
        # every rank the model axis leaves.
        mesh = create_mesh(run.data_dim if run.data_dim > 1 else None, run.model_dim,
                           device_type=dev.type)
        shard = (mesh.get_local_rank(pmesh.DATA_AXIS), pmesh.axis_sizes(mesh)[pmesh.DATA_AXIS])
        step_fn, shard_state, _ = train.sharded_train_step(cfg, tcfg, mesh,
                                                           local_batch=local_batch)
        ts = shard_state(ts)
    else:
        def step_fn(ts, x, y, lr):
            return train.train_step(cfg, tcfg, ts, x, y, lr)

    batch_size, seed = run.batch_size, run.seed
    if local_batch:
        _, batch_size = distributed.global_batch_slice(run.batch_size, pmesh.data_group(mesh))
        seed += shard[0]
    if args.data_dir:
        batches = _folder_batches(run, args, dev, batch_size, local_batch, shard)
    else:
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
    if mesh is not None and (args.checkpoint_dir or args.export_weights_dir):
        whole = train.gather_train_state(cfg, mesh, ts)  # every rank takes part
    else:
        whole = ts
    if args.checkpoint_dir:
        from resnetc_tpu_torch.checkpoint import save_train_state

        save_train_state(args.checkpoint_dir, whole)  # rank 0 writes; all ranks wait
        if rank == 0:
            print(f"saved checkpoint to {args.checkpoint_dir}")
    if args.export_weights_dir and rank == 0:
        # The serving engines load this format (load_reference_format).
        from resnetc_tpu_torch.checkpoint import save_reference_format

        variables = resnet.merge_params_state(whole.params, whole.bn_state)
        n = save_reference_format(variables, args.export_weights_dir)
        print(f"exported {n} weight files to {args.export_weights_dir}")
    return ts


def _folder_batches(run, args, dev, batch_size, local_batch, shard):
    """``--steps`` (images, labels) batches on ``dev`` from the ImageFolder
    tree ``--data-dir``.  A ``--multihost`` rank reads its data index's
    strided shard of every epoch (``shard``: (index, data ranks)) as host
    arrays (JAX ``__main__.py:196-210``) and moves them itself; every other
    run reads the whole global batch.  The loader's producer stops when the
    steps are taken."""
    import torch

    from resnetc_tpu_torch.data import ImageFolderLoader

    loader = ImageFolderLoader(
        args.data_dir, batch_size=batch_size, image_size=run.image_size,
        train=True, epochs=10**9, seed=run.seed, device=dev,
        shard=shard if local_batch else None,
        to_device=not local_batch,
    )
    it = iter(loader)
    try:
        for _ in range(args.steps):
            x, y = next(it)
            if local_batch:
                x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
            yield x, y
    finally:
        it.close()  # stops the producer thread


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
    if run.model_dim > 1:
        raise SystemExit(
            "verify runs in one process, as the JAX CLI's does (it takes no "
            "mesh); --model-dim (channel tensor parallelism, ROADMAP Queue 1 "
            "item 3b) is for train and the serving commands"
        )
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

    p = sub.add_parser("classify", help="classify image files (top-1 index)")
    add_run_args(p)
    p.add_argument("images", nargs="+")
    p.add_argument(
        "--labels-file", default=None,
        help="class-name file (one name per line, line i = index i) to "
        "print names alongside indices",
    )
    p.set_defaults(fn=cmd_classify)

    p = sub.add_parser("bench", help="serving throughput + latency")
    add_run_args(p)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--latency-samples", type=int, default=50)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("train", help="training loop (synthetic data or an image dir)")
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
        help="ImageFolder tree (root/<class>/<img>); synthetic data if omitted",
    )
    p.add_argument(
        "--export-weights-dir", default=None,
        help="after training, also export the reference's raw-f32 weight "
        "files (what the serving engines load)",
    )
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="top-1 accuracy over an ImageFolder tree")
    add_run_args(p)
    p.add_argument("data_dir")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("export-weights", help="write raw-f32 weight files")
    add_run_args(p)
    p.add_argument("out_dir")
    p.set_defaults(fn=cmd_export_weights)

    p = sub.add_parser("convert-images", help="images -> reference .bin inputs")
    p.add_argument("image_dir")
    p.add_argument("out_dir")
    p.set_defaults(fn=cmd_convert_images)

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
