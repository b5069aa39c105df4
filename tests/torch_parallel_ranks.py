"""Rank programs of ``tests/test_torch_parallel.py`` and the inputs they
share with it.

Each rank is its own process, started by the test as

    python -c "import torch_parallel_ranks as r; r.main()" RANK PORT OUT

with this directory on ``sys.path``.  It joins a two-rank gloo group on the
CPU at ``127.0.0.1:PORT`` (``parallel.distributed.initialize``), runs
``library`` and pickles what it computed to ``OUT/rank<RANK>.pkl`` for the
test to compare.  Imports neither JAX nor the JAX package, so that a
rank pays only the torch import.
"""

from __future__ import annotations

import pickle
import sys

import numpy as np
import torch

WORLD = 2

#: The data-parallel step's model and optimiser (``tests/test_parallel.py``'s
#: DP test: ResNet-18, 10 classes, 32 px, batch 16, FP32).
STEP_MODEL = ("resnet18", 10)
STEP_KW = dict(lr=0.1, momentum=0.9, weight_decay=1e-4, policy_name="fp32")
STEP_LR = 0.1

#: The served model (``tests/test_parallel.py``'s DP serving tests:
#: ResNet-50, 11 classes, 64 px, batch 8).
SERVE_MODEL = ("resnet50", 11)

#: Every other backend served over the ranks, under FP32 as
#: ``tests/test_parallel.py:175-193`` serves (under BF16 the port's and the
#: JAX package's int8 logits already stand ~4% apart in one process: XLA
#: keeps excess precision across bf16 roundings, and the int8 backend's
#: per-tensor requantization turns that into whole steps).  ResNet-50, 11
#: classes, 32 px, a global batch of 8 and an uneven one of 7.
DP_BACKENDS = ("fp", "pallas", "pallas_block", "int8", "int8_static")
DP_BATCHES = {"even": 8, "uneven": 7}


def bn_inputs():
    """(x, scale, bias, running mean, running var, loss weights g) of the
    sync-BN check: the global batch of both ranks, NHWC, rank r's four
    images offset by 5r so that the ranks' means differ widely.  The loss is
    ``sum(out * g)``."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((WORLD, 4, 6, 6, 16)).astype(np.float32)
    x += np.arange(WORLD, dtype=np.float32)[:, None, None, None, None] * 5.0
    scale, bias, r_mean = (rng.standard_normal(16).astype(np.float32) for _ in range(3))
    r_var = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    g = rng.standard_normal((WORLD * 4, 6, 6, 16)).astype(np.float32)
    return x.reshape(-1, 6, 6, 16), scale, bias, r_mean, r_var, g


def step_config():
    from resnetc_tpu_torch.models import resnet

    return resnet.get_config(STEP_MODEL[0], num_classes=STEP_MODEL[1])


def step_state(seed: int = 0):
    from resnetc_tpu_torch import train

    return train.init_train_state(step_config(), torch.Generator().manual_seed(seed),
                                  device="cpu")


def step_batch():
    x = np.random.default_rng(1).standard_normal((16, 32, 32, 3)).astype(np.float32)
    y = (np.arange(16) % STEP_MODEL[1]).astype(np.int32)
    return x, y


def serve_inputs():
    """(config, variables, images) of the serving checks."""
    from resnetc_tpu_torch.models import resnet

    cfg = resnet.get_config(SERVE_MODEL[0], num_classes=SERVE_MODEL[1])
    variables = resnet.init(cfg, torch.Generator().manual_seed(3))
    x = np.random.default_rng(2).standard_normal((8, 64, 64, 3)).astype(np.float32)
    return cfg, variables, x


def dp_inputs():
    """(config, variables, images) of the every-backend DP serving checks."""
    from resnetc_tpu_torch.models import resnet

    cfg = resnet.get_config(SERVE_MODEL[0], num_classes=SERVE_MODEL[1])
    variables = resnet.init(cfg, torch.Generator().manual_seed(5))
    x = np.random.default_rng(6).standard_normal((8, 32, 32, 3)).astype(np.float32)
    return cfg, variables, x


def dp_serve(backend: str, mesh=None) -> dict:
    """``backend``'s logits of the even and the uneven batch: in one process
    (``mesh`` None) or over ``mesh``'s data axis; for ``int8_static`` also
    its calibrated scales (calibrated on the even batch, on every rank)."""
    import warnings

    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.ops.cuda import fused, quant
    from resnetc_tpu_torch.serve import InferenceEngine
    from resnetc_tpu_torch.tensor import FP32, flatten_tree

    cfg, variables, x = dp_inputs()
    pol = FP32
    xt = torch.from_numpy(x)
    res: dict = {}
    if backend == "int8_static":
        folded = resnet.fold_inference_params(cfg, variables)
        scales = fused.calibrate_activation_scales(cfg, folded, xt, policy=pol)
        tree = quant.pack_kmajor(quant.quantize_folded(folded))
        res["scales"] = {k: v.numpy() for k, v in flatten_tree(scales).items()}

        def run(b):
            if mesh is None:
                return fused.fused_forward_int8_static(cfg, tree, scales, b, policy=pol)
            return fused.fused_forward_sharded(cfg, tree, b, mesh, backend=backend,
                                               scales=scales, policy=pol)
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # the pallas paths' notice
            run = InferenceEngine(cfg, variables, backend=backend, policy=pol, device="cpu",
                                  mesh=mesh).logits
    for name, n in DP_BATCHES.items():
        res[name] = run(xt[:n]).float().numpy()
    return res


def _flat_np(tree) -> dict:
    from resnetc_tpu_torch.tensor import flatten_tree

    return {k: v.detach().numpy().copy() for k, v in flatten_tree(tree).items()}


def library(mesh) -> dict:
    """Sync-BN, the gather, the DP step (with and without remat), DP
    ``int8_chain`` serving, the ``int8`` backend's global scale and every
    other backend's DP serving on this rank."""
    from resnetc_tpu_torch import train
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.ops import torch_ops
    from resnetc_tpu_torch.ops.cuda import fused, quant
    from resnetc_tpu_torch.parallel import batch_sharding, distributed
    from resnetc_tpu_torch.parallel.mesh import data_group
    from resnetc_tpu_torch.serve import InferenceEngine

    group = data_group(mesh)
    take = batch_sharding(mesh)
    res: dict = {}

    x, scale, bias, r_mean, r_var, g = (torch.from_numpy(a) for a in bn_inputs())
    xs = take(x).clone().requires_grad_(True)
    sc, bi = scale.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    out, new_mean, new_var = torch_ops.batch_norm_train(xs, sc, bi, r_mean, r_var, group=group)
    (out * take(g)).sum().backward()
    res["bn"] = {"out": out.detach().numpy(), "mean": new_mean.numpy(), "var": new_var.numpy(),
                 "dx": xs.grad.numpy(), "dscale": sc.grad.numpy(), "dbias": bi.grad.numpy()}
    res["gather"] = distributed.host_local_to_global(take(x), group).numpy()

    xb, yb = step_batch()
    cfg = step_config()
    for remat in (False, True):
        # Rank 1 starts from another state: shard_state must make it rank 0's.
        ts = step_state(seed=torch.distributed.get_rank())
        step, shard_state, _ = train.sharded_train_step(
            cfg, train.TrainConfig(**STEP_KW, remat=remat), mesh)
        ts = shard_state(ts)
        ts, m = step(ts, torch.from_numpy(xb), torch.from_numpy(yb), STEP_LR)
        res[f"step/remat={remat}"] = {
            "metrics": {k: float(v) for k, v in m.items()}, "step": int(ts.step),
            "params": _flat_np(ts.params), "bn_state": _flat_np(ts.bn_state),
        }

    scfg, variables, xs_np = serve_inputs()
    images = torch.from_numpy(xs_np)
    folded = resnet.fold_inference_params(scfg, variables)
    scales = fused.calibrate_chain_scales(scfg, folded, images)
    qtree = fused.quantize_chain(scfg, folded)
    route = fused.L1_PIXEL_PAIR
    for pp in (False, True):
        fused.L1_PIXEL_PAIR = pp
        res[f"serve/pp={pp}"] = fused.fused_forward_int8_chain_sharded(
            scfg, qtree, scales, images, mesh).numpy()
    fused.L1_PIXEL_PAIR = route
    eng = InferenceEngine(scfg, variables, backend="int8_chain", calib_batch=xs_np, mesh=mesh,
                          device="cpu")
    res["engine"] = eng.logits(xs_np).numpy()

    # The int8 backend's scale over ranks whose slices lie 5 apart.
    q, scale = quant.quantize_per_tensor(take(x), group)
    res["quant"] = {"q": q.numpy(), "scale": scale.numpy()}
    for backend in DP_BACKENDS:
        res[f"dp/{backend}"] = dp_serve(backend, mesh)
    return res


def main() -> None:
    from resnetc_tpu_torch.parallel import create_mesh, distributed

    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    distributed.initialize(f"127.0.0.1:{port}", WORLD, rank, device="cpu")
    try:
        res = library(create_mesh(device_type="cpu"))
    finally:
        distributed.shutdown()
    with open(f"{out}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
