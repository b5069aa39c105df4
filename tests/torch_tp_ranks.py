"""Rank programs of ``tests/test_torch_tp.py`` and the inputs they share
with it.

Each rank is its own process, started by the test as

    python -c "import torch_tp_ranks as r; r.main()" RANK WORLD DATA PORT OUT

with this directory on ``sys.path``.  It joins a gloo group of WORLD ranks
on the CPU at ``127.0.0.1:PORT``, makes a (DATA, WORLD / DATA) mesh, runs
``library`` and pickles what it computed to ``OUT/<DATA>x<MODEL>/rank<RANK>.pkl``.
``OUT/inputs.pkl`` holds what the test made with the JAX package (the
weights and the image batch of the forward check).  Imports neither JAX
nor the JAX package, so that a rank pays only the torch import.
"""

from __future__ import annotations

import dataclasses
import pickle
import sys
import warnings
from pathlib import Path

import numpy as np
import torch

#: ``tests/test_parallel.py::test_tp_forward_matches_replicated``'s model
#: (ResNet-18, 8 classes) on its batch of 4 at 32 px, FP32.
FORWARD_MODEL = ("resnet18", 8)

#: The engines' model: ResNet-50 cut to (2, 1, 1, 1) blocks, so that
#: ``pallas_block`` fuses a stride-1 block (layer1.1), 8 classes.
ENGINE_BACKENDS = ("fp", "pallas", "pallas_block")

#: Two train steps from a seeded state: SGD with momentum at lr 0.01, FP32,
#: batch 4 at 32 px.
STEP_KW = dict(lr=0.01, momentum=0.9, weight_decay=1e-4, policy_name="fp32")
STEP_LR = 0.01
STEPS = 2

#: The train cases: name -> (config arguments, remat, meshes (data, model)).
#: 8 classes shard the fc over two model ranks, 11 replicate it; the
#: grouped configs (ResNeXt's shape at stem width 16) split their groups
#: over the axis (8 groups) or gather the weight (3 groups).  The 2 x 1
#: mesh (data parallelism alone) is what the 2 x 2 runs are held to.
TRAIN_CASES = {
    "resnet18-8": (("resnet18", 8), False, ((1, 2), (2, 2), (2, 1))),
    "resnet18-11-remat": (("resnet18", 11), True, ((1, 2), (2, 2), (2, 1))),
    "grouped-8": (("grouped", 8), False, ((1, 2),)),
    "grouped-3": (("grouped", 3), False, ((1, 2),)),
}

#: The CLI runs inside the 1 x 2 ranks: ResNet-18, 10 classes, 32 px.
CLI_MODEL = ["--model", "resnet18", "--num-classes", "10", "--image-size", "32"]
CLI_TRAIN = ["train", *CLI_MODEL, "--batch-size", "4", "--steps", "2", "--log-every", "1",
             "--policy", "fp32", "--lr", "0.01"]


def config(spec):
    """A case's ``ResNetConfig``: a named model, or the grouped bottleneck
    net cut to one block a stage at stem width 16 with ``groups`` groups."""
    from resnetc_tpu_torch.models import resnet

    name, n = spec
    if name != "grouped":
        return resnet.get_config(name, num_classes=n)
    return resnet.ResNetConfig(f"grouped{n}", "bottleneck", (1, 1, 1, 1), num_classes=8,
                               stem_width=16, groups=n, width_per_group=32)


def engine_config():
    from resnetc_tpu_torch.models import resnet

    return dataclasses.replace(resnet.get_config("resnet50", num_classes=8),
                               stage_blocks=(2, 1, 1, 1))


def engine_inputs():
    """(config, variables, images) of the engine checks."""
    from resnetc_tpu_torch.models import resnet

    cfg = engine_config()
    variables = resnet.init(cfg, torch.Generator().manual_seed(7))
    x = np.random.default_rng(8).standard_normal((4, 32, 32, 3)).astype(np.float32)
    return cfg, variables, x


def step_state(cfg):
    from resnetc_tpu_torch import train

    return train.init_train_state(cfg, torch.Generator().manual_seed(9), device="cpu")


def step_batch(num_classes: int):
    x = np.random.default_rng(10).standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = (np.arange(4) * 3 % num_classes).astype(np.int32)
    return x, y


def train_config(remat: bool):
    from resnetc_tpu_torch import train

    return train.TrainConfig(**STEP_KW, remat=remat)


def flat_np(tree) -> dict:
    from resnetc_tpu_torch.tensor import flatten_tree

    return {k: v.detach().numpy().copy() for k, v in flatten_tree(tree).items()}


def state_np(ts) -> dict:
    return {"step": int(ts.step), **{name: flat_np(getattr(ts, name))
                                     for name in ("params", "bn_state", "momentum")}}


def digest(state: dict) -> str:
    """One hash of a ``state_np``: the other ranks' replicas are held equal
    to rank 0's, which alone sends its state whole."""
    import hashlib

    h = hashlib.sha256(str(state["step"]).encode())
    for name in ("params", "bn_state", "momentum"):
        for k in sorted(state[name]):
            h.update(k.encode())
            h.update(state[name][k].tobytes())
    return h.hexdigest()


def library(mesh, out: Path, inputs: dict) -> dict:
    """Every check of one mesh shape on this rank."""
    from resnetc_tpu_torch import checkpoint, train
    from resnetc_tpu_torch.parallel import mesh as pmesh

    shape = (pmesh.axis_sizes(mesh)["data"], pmesh.axis_sizes(mesh)["model"])
    res: dict = {}
    if shape[1] > 1:
        res.update(forwards(mesh, inputs))
    if shape == (1, 2):
        res.update(engines(mesh))

    rank = torch.distributed.get_rank()
    for case, (spec, remat, meshes) in TRAIN_CASES.items():
        if shape not in meshes:
            continue
        cfg = config(spec)
        step, shard_state, _ = train.sharded_train_step(cfg, train_config(remat), mesh)
        ts = shard_state(step_state(cfg))
        xb, yb = step_batch(cfg.num_classes)
        metrics = []
        for _ in range(STEPS):
            ts, m = step(ts, torch.from_numpy(xb), torch.from_numpy(yb), STEP_LR)
            metrics.append({k: float(v) for k, v in m.items()})
        whole = train.gather_train_state(cfg, mesh, ts)
        state = state_np(whole)
        res[f"train/{case}"] = {"metrics": metrics, "digest": digest(state),
                                "state": state if rank == 0 else None}
        if case == "resnet18-8" and shape == (1, 2):
            checkpoint.save_train_state(out / "ck", whole)

    if shape == (1, 2):
        res["cli"] = cli(out)
    return res


def forwards(mesh, inputs: dict) -> dict:
    """The forward of tests/test_parallel.py's TP test on the JAX weights,
    unfolded and folded, and the shards of its tree."""
    from resnetc_tpu_torch import checkpoint
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.parallel import distributed
    from resnetc_tpu_torch.parallel import mesh as pmesh
    from resnetc_tpu_torch.tensor import FP32, flatten_tree

    dgroup, mgroup = pmesh.data_group(mesh), pmesh.model_group(mesh)
    take = pmesh.batch_sharding(mesh)
    res: dict = {}
    cfg = config(FORWARD_MODEL)
    variables = checkpoint.variables_from_jax_numpy(inputs["variables"])
    shards = pmesh.shard_tree(mesh, variables)
    x = torch.from_numpy(inputs["x"])
    logits, _ = resnet.forward(cfg, shards, take(x), policy=FP32, model_group=mgroup)
    res["forward"] = distributed.host_local_to_global(logits, dgroup).numpy()
    folded = resnet.fold_inference_params(cfg, variables)
    logits = resnet.forward_folded(cfg, pmesh.shard_tree(mesh, folded), take(x), policy=FP32,
                                   model_group=mgroup)
    res["forward_folded"] = distributed.host_local_to_global(logits, dgroup).numpy()
    # The shards: contiguous copies, and their gather is the whole tree.
    dims = pmesh.param_shardings(mesh, variables)
    whole = pmesh.gather_tree(mesh, shards, dims)
    res["shards"] = {
        "contiguous": all(t.is_contiguous() for t in flatten_tree(shards).values()),
        "shapes": {k: tuple(t.shape) for k, t in flatten_tree(shards).items()},
        "round_trip": all(torch.equal(whole_t, flatten_tree(variables)[k])
                          for k, whole_t in flatten_tree(whole).items()),
    }

    return res


def engines(mesh) -> dict:
    """The ``fp``, ``pallas`` and ``pallas_block`` engines' logits under the
    mesh, and the shape of the fc each holds."""
    from resnetc_tpu_torch.serve import InferenceEngine
    from resnetc_tpu_torch.tensor import FP32

    cfg, variables, x = engine_inputs()
    res: dict = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the pallas paths' notice
        for backend in ENGINE_BACKENDS:
            eng = InferenceEngine(cfg, variables, backend=backend, policy=FP32, device="cpu",
                                  mesh=mesh)
            res[f"engine/{backend}"] = eng.logits(x).numpy()
            res[f"engine/{backend}/fc"] = tuple(eng.folded["fc"]["weight"].shape)
    return res


def cli(out: Path) -> dict:
    """The CLI's rank bodies under ``--model-dim 2``, as ``spawn`` calls
    them on each rank: ``train`` with a checkpoint and an export, and
    ``classify`` (fp) of two ``.bin`` files."""
    import argparse
    import contextlib
    import io

    from resnetc_tpu_torch import __main__ as tcli
    from resnetc_tpu_torch.config import run_config_from_args

    def rank_args(argv):
        args = tcli.build_parser().parse_args(argv)
        return run_config_from_args(args), argparse.Namespace(
            **{k: v for k, v in vars(args).items() if k != "fn"})

    dev = torch.device("cpu")
    run, args = rank_args(CLI_TRAIN + ["--model-dim", "2", "--checkpoint-dir", str(out / "cli_ck"),
                                       "--export-weights-dir", str(out / "cli_export")])
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        tcli._train_rank(dev, run, args)
    run, args = rank_args(["classify", *CLI_MODEL, "--policy", "fp32", "--model-dim", "2",
                           *[str(out / f"{i}.bin") for i in range(2)]])
    return {"train_log": log.getvalue(), "classify": tcli._serving_rank(dev, "classify", run, args)}


def main() -> None:
    from resnetc_tpu_torch.parallel import create_mesh, distributed

    rank, world, n_data = (int(a) for a in sys.argv[1:4])
    port, out = sys.argv[4], Path(sys.argv[5])
    with open(out / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        mesh = create_mesh(n_data, world // n_data, device_type="cpu")
        res = library(mesh, out, inputs)
    finally:
        distributed.shutdown()
    d = out / f"{n_data}x{world // n_data}"
    d.mkdir(exist_ok=True)
    with open(d / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
