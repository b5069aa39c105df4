"""The port's data parallelism vs the JAX package's, on the CPU over gloo.

Pure parts in this process: the mesh arithmetic and its errors, the
sharding rules leaf by leaf, ``global_batch_slice`` and the backend choice,
against ``resnetc_tpu.parallel`` on the 8-device CPU mesh that
``tests/conftest.py`` sets up.  Multi-rank parts in three launches, all
started at once by the ``launches`` fixture (each rank a fresh process that
imports no JAX, one thread each):

1. two ranks of ``torch_parallel_ranks.library``: sync-BN, the gather, the
   DP step with and without ``remat``, DP ``int8_chain`` serving (plain
   versions) on both routes and through the engine's ``mesh=``, the
   ``int8`` backend's scale over ranks, and every other backend served
   over the ranks (``fp``, ``pallas``, ``pallas_block``, ``int8`` and
   ``int8_static`` under FP32, an even batch and one the axis does not
   divide);
2. the two-process ``train --multihost`` command;
3. ``train --data-dim 2``, two ranks spawned by the command.

Tolerances.  Sync-BN against JAX's ``batch_norm_train`` on the whole batch:
rtol 1e-5, atol 1e-6 for the output, both running stats and the gradients
with respect to x, scale and bias.  The DP step against JAX's
``sharded_train_step`` on ``create_mesh(n_data=2)`` and against the port's
``train_step`` on the global batch, with ``tests/test_parallel.py``'s
tolerances: loss rtol 1e-5, grad_norm rtol 1e-4, every parameter and BN
stat rtol 1e-4, atol 5e-6; the two ranks' replicas equal bit for bit.  DP
serving against the one-process forward (and the JAX package's): JAX's
serving contract (``tests/test_parallel.py:57-65``: rel-MAE < 0.02,
argmax agreement >= 0.85) for the int8 backends, and
``tests/test_parallel.py:175-193``'s rtol 1e-4, atol 1e-4 (FP32) for the
float ones.  The CLI runs (FP32): both ranks log identical losses, within rtol
1e-5 of the one-rank run (``--data-dim 2``) or of JAX's
``train_step`` on the concatenated ``seed`` / ``seed + 1`` batches
(``--multihost``) before the first update; after it rtol 1e-4 there (see
the test).  Sync-BN's scale and bias gradients against JAX: atol 3e-5 (see
the test).
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as ranks

from resnetc_tpu import train as jtrain
from resnetc_tpu.checkpoint import flatten_tree as jflatten
from resnetc_tpu.checkpoint import unflatten_tree as junflatten
from resnetc_tpu.data.loader import synthetic_batches as jsynthetic_batches
from resnetc_tpu.models import resnet as jresnet
from resnetc_tpu.ops import lax_ops
from resnetc_tpu.parallel import create_mesh as jcreate_mesh
from resnetc_tpu.parallel import distributed as jdistributed
from resnetc_tpu.parallel import param_shardings as jparam_shardings
from resnetc_tpu.ops.pallas import fused as jfused
from resnetc_tpu.ops.pallas import quant as jquant
from resnetc_tpu.serve import InferenceEngine as JEngine
from resnetc_tpu.tensor import FP32 as JFP32
from resnetc_tpu_torch import __main__ as tcli
from resnetc_tpu_torch import checkpoint as tckpt
from resnetc_tpu_torch import train as ttrain
from resnetc_tpu_torch.models import resnet as tresnet
from resnetc_tpu_torch.ops.cuda import fused as tfused
from resnetc_tpu_torch.ops.cuda import quant as tquant
from resnetc_tpu_torch.parallel import distributed as tdistributed
from resnetc_tpu_torch.parallel import mesh as tmesh
from resnetc_tpu_torch.serve import InferenceEngine
from resnetc_tpu_torch.tensor import flatten_tree

REPO = Path(__file__).resolve().parent.parent

#: The CLI runs: ResNet-18, 10 classes, 32 px, global batch 8, 3 steps, FP32.
CLI_BASE = ["train", "--model", "resnet18", "--num-classes", "10", "--image-size", "32",
            "--batch-size", "8", "--steps", "3", "--log-every", "1", "--policy", "fp32"]
LIBRARY = "import torch_parallel_ranks as r; r.main()"
CLI = ("import json, sys; from resnetc_tpu_torch import __main__ as cli; "
       "cli.run_train(cli.build_parser().parse_args(json.loads(sys.argv[1])), device='cpu')")
#: The command's functions defined in a module named ``__main__``, as
#: ``python -m resnetc_tpu_torch`` defines them, so that the spawned ranks
#: must find their target under the package's name.
CLI_AS_MAIN = ("import json, sys, types; import resnetc_tpu_torch.__main__ as pkg; "
               "m = types.ModuleType('__main__'); "
               "src = open(pkg.__file__).read().rsplit('if __name__', 1)[0]; "
               "exec(compile(src, pkg.__file__, 'exec'), m.__dict__); "
               "m.run_train(m.build_parser().parse_args(json.loads(sys.argv[1])), device='cpu')")


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Start the three multi-rank launches together; ``wait(name)`` gives a
    process's (returncode, stdout, stderr)."""
    out = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]))
    lib_port, mh_port = tdistributed.free_port(), tdistributed.free_port()
    procs = {}

    def start(name, code, *argv):
        with open(out / f"{name}.out", "w") as o, open(out / f"{name}.err", "w") as e:
            procs[name] = subprocess.Popen([sys.executable, "-c", code, *argv], stdout=o,
                                           stderr=e, cwd=REPO, env=env)

    for r in range(2):
        start(f"library{r}", LIBRARY, str(r), str(lib_port), str(out))
        start(f"multihost{r}", CLI, json.dumps(CLI_BASE + [
            "--multihost", "--coordinator", f"127.0.0.1:{mh_port}", "--num-processes", "2",
            "--process-id", str(r), "--checkpoint-dir", str(out / "ck")]))
    start("data_dim", CLI_AS_MAIN, json.dumps(CLI_BASE + ["--data-dim", "2"]))

    def wait(name):
        rc = procs[name].wait(timeout=600)
        return rc, (out / f"{name}.out").read_text(), (out / f"{name}.err").read_text()

    try:
        yield out, wait
    finally:
        # A rank whose peer failed blocks in a collective: never leak it.
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def _library(launches) -> list[dict]:
    out, wait = launches
    res = []
    for r in range(2):
        rc, so, se = wait(f"library{r}")
        assert rc == 0, f"rank {r} failed:\n{se[-3000:]}"
        with open(out / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


def _records(text: str) -> list[dict]:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith('{"tag": "train"')]


def _jax_state(ts):
    """A port ``TrainState`` as the JAX package's."""
    def tree(t):
        return junflatten({k: jnp.asarray(v.numpy()) for k, v in flatten_tree(t).items()})

    return jtrain.TrainState(step=jnp.asarray(int(ts.step), jnp.int32), params=tree(ts.params),
                             bn_state=tree(ts.bn_state), momentum=tree(ts.momentum))


def _jflat(tree) -> dict:
    return {k: np.asarray(v) for k, v in jflatten(jax.device_get(tree)).items()}


# ---------------------------------------------------------------------------
# Pure parts
# ---------------------------------------------------------------------------


def test_backend_follows_the_layout():
    assert tdistributed.choose_backend("cuda", 1, 1) == "nccl"
    assert tdistributed.choose_backend("cuda", 8, 8) == "nccl"
    assert tdistributed.choose_backend("cuda", 2, 1) == "gloo"  # ranks share a card
    assert tdistributed.choose_backend("cpu", 1, 0) == "gloo"


@pytest.mark.parametrize("n_data, n_model", [(None, 1), (4, 2), (8, 1), (2, 1), (16, 1),
                                             (None, 3)])
def test_mesh_shape_matches_jax(n_data, n_model):
    """``tests/test_parallel.py:95-103`` over the 8 CPU devices: the same
    shape, or the same error."""
    n = len(jax.devices())
    try:
        want = jcreate_mesh(n_data, n_model)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.mesh_shape(n, n_data, n_model)
        assert str(got.value) == str(e)
        return
    assert tmesh.mesh_shape(n, n_data, n_model) == (want.shape["data"], want.shape["model"])


def test_create_mesh_needs_the_process_group():
    with pytest.raises(RuntimeError, match="initialize"):
        tmesh.create_mesh()


def _hand_tree():
    """``tests/test_parallel.py:106``'s tree."""
    return {
        "conv": {"weight": np.zeros((3, 3, 64, 128), np.float32)},
        "stem": {"weight": np.zeros((7, 7, 3, 64), np.float32)},
        "bn": {"weight": np.zeros((128,), np.float32),
               "running_mean": np.zeros((128,), np.float32)},
        "odd": {"weight": np.zeros((7,), np.float32)},
        "fc": {"weight": np.zeros((1000, 512), np.float32),
               "bias": np.zeros((1000,), np.float32)},
    }


@pytest.mark.parametrize("which", ["resnet18", "hand"])
def test_param_shardings_match_jax(which):
    """The rules on a (data 4, model 2) mesh, leaf by leaf: the port's
    sharded dimension is where JAX's PartitionSpec names 'model' (an
    11-class fc does not divide and is replicated)."""
    if which == "resnet18":
        tree = jax.tree.map(np.asarray, jresnet.init(
            jresnet.get_config("resnet18", num_classes=11), jax.random.key(0)))
    else:
        tree = _hand_tree()
    want = jparam_shardings(jcreate_mesh(4, 2), jax.tree.map(jnp.asarray, tree))
    got = flatten_tree(tmesh.param_shardings({"data": 4, "model": 2}, tree))
    want = jflatten(want)
    assert set(got) == set(want)
    for k, sh in want.items():
        spec = tuple(sh.spec)
        dim = spec.index("model") if "model" in spec else None
        assert got[k] == dim, (k, spec)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_global_batch_slice_matches_jax(world, monkeypatch):
    """Every rank of the world, for a batch each world divides and one that
    3 and 4 do not: the same (start, size), or the same error."""
    for rank in range(world):
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        monkeypatch.setattr(tdistributed.dist, "is_initialized", lambda: True)
        monkeypatch.setattr(tdistributed.dist, "get_world_size", lambda group=None: world)
        monkeypatch.setattr(tdistributed.dist, "get_rank", lambda group=None: rank)
        for batch in (12, 10):
            try:
                want = jdistributed.global_batch_slice(batch)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    tdistributed.global_batch_slice(batch)
                assert str(got.value) == str(e)
                continue
            assert tdistributed.global_batch_slice(batch) == want


# ---------------------------------------------------------------------------
# Launch 1: the library on two ranks
# ---------------------------------------------------------------------------


def test_sync_bn_two_ranks_matches_jax_on_the_whole_batch(launches):
    """Sync-BN on two ranks whose means lie 5 apart against JAX's
    ``batch_norm_train`` on the whole batch, and against the port's on the
    whole batch in float64.  The gradients with respect to scale and bias
    sum 288 products whose magnitudes add up to ~240 per channel, so one
    fp32 ulp of that sum is 1.5e-5, and JAX's own fp32 gradient stands about
    that far from float64 there: against JAX those two take atol 3e-5 (two
    such ulps), against float64 the stated 1e-6."""
    from resnetc_tpu_torch.ops import torch_ops

    x, scale, bias, r_mean, r_var, g = ranks.bn_inputs()

    def loss(xx, s, b):
        out, nm, nv = lax_ops.batch_norm_train(xx, s, b, r_mean, r_var)
        return jnp.sum(out * g), (out, nm, nv)

    (_, (out, nm, nv)), (dx, ds, db) = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want = dict(out=out, mean=nm, var=nv, dx=dx, dscale=ds, dbias=db)
    xd, sd, bd = (torch.from_numpy(a).double().requires_grad_(True) for a in (x, scale, bias))
    o, m, v = torch_ops.batch_norm_train(xd, sd, bd, torch.from_numpy(r_mean).double(),
                                         torch.from_numpy(r_var).double())
    (o * torch.from_numpy(g).double()).sum().backward()
    exact = dict(out=o.detach(), mean=m, var=v, dx=xd.grad, dscale=sd.grad, dbias=bd.grad)

    res = [r["bn"] for r in _library(launches)]
    got = dict(out=np.concatenate([r["out"] for r in res]),
               dx=np.concatenate([r["dx"] for r in res]),
               dscale=sum(r["dscale"] for r in res), dbias=sum(r["dbias"] for r in res))
    for r in res:
        np.testing.assert_array_equal(r["mean"], res[0]["mean"])
        np.testing.assert_array_equal(r["var"], res[0]["var"])
    got.update(mean=res[0]["mean"], var=res[0]["var"])
    for k, v in got.items():
        np.testing.assert_allclose(v, exact[k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
        atol = 3e-5 if k in ("dscale", "dbias") else 1e-6
        np.testing.assert_allclose(v, np.asarray(want[k]), rtol=1e-5, atol=atol, err_msg=k)


def test_host_local_to_global_gathers_in_rank_order(launches):
    x = ranks.bn_inputs()[0]
    for r in _library(launches):
        np.testing.assert_array_equal(r["gather"], x)
    local = torch.arange(6.0).reshape(3, 2)  # outside a group: the local batch
    assert tdistributed.host_local_to_global(local) is local
    assert tdistributed.global_batch_slice(16) == (0, 16)
    assert not tdistributed.is_multiprocess()


@pytest.fixture(scope="module")
def step_references():
    """JAX's ``sharded_train_step`` on ``create_mesh(n_data=2)`` and the
    port's ``train_step``, both on the global batch from the port's seed-0
    state: (metrics, params, bn_state) each."""
    x, y = ranks.step_batch()
    jcfg = jresnet.get_config(ranks.STEP_MODEL[0], num_classes=ranks.STEP_MODEL[1])
    step, shard_state, _ = jtrain.sharded_train_step(
        jcfg, jtrain.TrainConfig(**ranks.STEP_KW), jcreate_mesh(n_data=2))
    jts, jm = step(shard_state(_jax_state(ranks.step_state(0))), jnp.asarray(x),
                   jnp.asarray(y), jnp.float32(ranks.STEP_LR))
    tts, tm = ttrain.train_step(ranks.step_config(), ttrain.TrainConfig(**ranks.STEP_KW),
                                ranks.step_state(0), torch.from_numpy(x), torch.from_numpy(y),
                                ranks.STEP_LR)
    return {
        "jax": ({k: float(v) for k, v in jm.items()}, _jflat(jts.params), _jflat(jts.bn_state)),
        "port": ({k: float(v) for k, v in tm.items()},
                 *({k: v.numpy() for k, v in flatten_tree(t).items()}
                   for t in (tts.params, tts.bn_state))),
    }


@pytest.mark.parametrize("remat", [False, True])
def test_dp_step_two_ranks_matches_jax_and_the_one_process_step(launches, step_references,
                                                                remat):
    res = [r[f"step/remat={remat}"] for r in _library(launches)]
    for name in ("params", "bn_state"):
        for k, v in res[0][name].items():
            np.testing.assert_array_equal(res[1][name][k], v, err_msg=f"replicas: {k}")
    got = res[0]
    assert got["step"] == 1 and got["metrics"] == res[1]["metrics"]
    for ref, (metrics, params, bn_state) in step_references.items():
        np.testing.assert_allclose(got["metrics"]["loss"], metrics["loss"], rtol=1e-5,
                                   err_msg=ref)
        np.testing.assert_allclose(got["metrics"]["grad_norm"], metrics["grad_norm"],
                                   rtol=1e-4, err_msg=ref)
        assert got["metrics"]["accuracy"] == metrics["accuracy"], ref
        for name, want in (("params", params), ("bn_state", bn_state)):
            assert set(got[name]) == set(want), (ref, name)
            for k, w in want.items():
                np.testing.assert_allclose(got[name][k], w, rtol=1e-4, atol=5e-6,
                                           err_msg=f"{ref}: {name}.{k}")


def _assert_int8_serving_close(got, want):
    """JAX's DP serving contract (``tests/test_parallel.py:57-65``)."""
    rel_mae = np.mean(np.abs(got - want)) / np.mean(np.abs(want))
    assert rel_mae < 0.02, rel_mae
    agreement = float((got.argmax(-1) == want.argmax(-1)).mean())
    assert agreement >= 0.85, agreement


@pytest.fixture(scope="module")
def serving():
    cfg, variables, x = ranks.serve_inputs()
    folded = tresnet.fold_inference_params(cfg, variables)
    scales = tfused.calibrate_chain_scales(cfg, folded, torch.from_numpy(x))
    return cfg, variables, x, tfused.quantize_chain(cfg, folded), scales


@pytest.mark.parametrize("pp", [False, True])
def test_dp_int8_chain_two_ranks_matches_one_process(launches, serving, pp, monkeypatch):
    """Both routes: the pixel-paired kernels pair images of the rank's own
    slice, so the flag must not break the DP path."""
    cfg, _, x, qtree, scales = serving
    monkeypatch.setattr(tfused, "L1_PIXEL_PAIR", pp)
    want = tfused.fused_forward_int8_chain(cfg, qtree, scales, torch.from_numpy(x)).numpy()
    for r in _library(launches):
        assert r[f"serve/pp={pp}"].shape == (8, 11)
        _assert_int8_serving_close(r[f"serve/pp={pp}"], want)


def test_dp_engine_round_trip(launches, serving):
    """``InferenceEngine(backend="int8_chain", mesh=...)`` on two ranks
    against the one-process engine on the same variables and calibration
    batch."""
    cfg, variables, x, _, _ = serving
    want = InferenceEngine(cfg, variables, backend="int8_chain", calib_batch=x,
                           device="cpu").logits(x).numpy()
    for r in _library(launches):
        _assert_int8_serving_close(r["engine"], want)


def test_int8_chain_stage_taps_do_not_depend_on_the_thread_count():
    """One process's ``int8_chain`` engine (calibration included) at 1 and 4
    threads: the calibrated scales, every stage's int8 taps and the logits
    are equal.  (An fp32 convolution on the CPU sums in an order that
    follows oneDNN's blocking, and so the thread count; the bf16 path sums
    in float64, ``torch_ops.conv2d``.)"""
    cfg, variables, x = ranks.serve_inputs()
    got = {}
    threads = torch.get_num_threads()
    try:
        for n in (1, 4):
            torch.set_num_threads(n)
            eng = InferenceEngine(cfg, variables, backend="int8_chain", calib_batch=x,
                                  device="cpu")
            taps = []
            logits = tfused.fused_forward_int8_chain(cfg, eng.folded, eng.chain_scales,
                                                     torch.from_numpy(x), stage_taps=taps)
            got[n] = (flatten_tree(eng.chain_scales), taps, logits)
    finally:
        torch.set_num_threads(threads)
    (s1, t1, l1), (s4, t4, l4) = got[1], got[4]
    assert all(torch.equal(s1[k], s4[k]) for k in s1)
    assert len(t1) == len(t4) == 4
    for a, b in zip(t1, t4):
        assert torch.equal(a, b)
    assert torch.equal(l1, l4)


def test_int8_scale_over_ranks_is_the_whole_batchs(launches):
    """``quantize_per_tensor(group=)`` on two ranks whose slices lie 5
    apart: every rank quantizes at the whole batch's scale, not its own."""
    x = torch.from_numpy(ranks.bn_inputs()[0])
    q, scale = tquant.quantize_per_tensor(x)
    assert tquant.quantize_per_tensor(x[:4])[1] != scale
    for r, res in enumerate(_library(launches)):
        assert res["quant"]["scale"] == scale.numpy()
        np.testing.assert_array_equal(res["quant"]["q"], q[4 * r:4 * (r + 1)].numpy())


@pytest.fixture(scope="module")
def dp_references():
    """Per backend of ``ranks.DP_BACKENDS``: the port's one-process logits
    of the even and the uneven batch, and the JAX package's (its engine,
    Pallas in interpret mode; ``int8_static`` through its functions) on the
    same variables."""
    cfg, variables, x = ranks.dp_inputs()
    jcfg = jresnet.get_config(ranks.SERVE_MODEL[0], num_classes=ranks.SERVE_MODEL[1])
    jvars = jax.tree.map(lambda t: jnp.asarray(t.numpy()), variables)
    port = {b: ranks.dp_serve(b) for b in ranks.DP_BACKENDS}
    want = {}
    jpol = JFP32
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        for b in ranks.DP_BACKENDS:
            if b == "int8_static":
                jfold = jresnet.fold_inference_params(jcfg, jvars)
                jscales = jfused.calibrate_activation_scales(jcfg, jfold, jnp.asarray(x),
                                                             policy=jpol)
                jq = jquant.quantize_folded(jfold)

                def run(xx):
                    return jfused.fused_forward_int8_static(jcfg, jq, jscales, xx, policy=jpol,
                                                            interpret=True)
            else:
                run = JEngine(jcfg, jvars, backend="xla" if b == "fp" else b,
                              policy=jpol).logits
            want[b] = {name: np.asarray(run(jnp.asarray(x[:n])), np.float32)
                       for name, n in ranks.DP_BATCHES.items()}
    return port, want


@pytest.mark.parametrize("batch", list(ranks.DP_BATCHES))
@pytest.mark.parametrize("backend", list(ranks.DP_BACKENDS))
def test_dp_serving_every_backend_two_ranks(launches, dp_references, backend, batch):
    """Each backend over two ranks (``InferenceEngine(mesh=)``; for
    ``int8_static`` ``fused_forward_sharded``), FP32, against one process of
    the port and against the JAX package: the float backends within
    ``tests/test_parallel.py:175-193``'s rtol 1e-4, atol 1e-4, the int8
    ones by its DP serving gate.  The uneven batch of 7 is padded to
    8 with a copy of its last image: its logits are the one-process run's
    on the 7, no more rows.  Both ranks get the same gathered logits, and
    ``int8_static``'s scales, calibrated on each rank, are equal."""
    port, jax_ref = dp_references
    res = [r[f"dp/{backend}"] for r in _library(launches)]
    got = res[0][batch]
    np.testing.assert_array_equal(res[1][batch], got)
    assert got.shape == (ranks.DP_BATCHES[batch], ranks.SERVE_MODEL[1])
    for want in (port[backend][batch], jax_ref[backend][batch]):
        if "int8" not in backend:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        else:
            _assert_int8_serving_close(got, want)
    if backend == "int8_static":
        # Each rank calibrates on the same batch: equal scales.  Against this
        # process, which may run more threads: the FP32 calibration's
        # convolutions sum in oneDNN's order (the fp32 CPU path keeps it).
        keys = port[backend]["scales"].keys()
        assert res[1]["scales"].keys() == res[0]["scales"].keys() == keys
        for k, v in port[backend]["scales"].items():
            np.testing.assert_array_equal(res[1]["scales"][k], res[0]["scales"][k], err_msg=k)
            np.testing.assert_allclose(res[0]["scales"][k], v, rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# Launches 2 and 3: the train command
# ---------------------------------------------------------------------------


def test_multihost_cli_two_processes_match_jax(launches):
    """Each process draws its 4 images from ``seed + rank``; both log the
    same losses, those of JAX's ``train_step`` on the 8 images together; rank
    0 writes the checkpoint."""
    out, wait = launches
    logs = []
    for r in range(2):
        rc, so, se = wait(f"multihost{r}")
        assert rc == 0, f"process {r} failed:\n{se[-3000:]}"
        logs.append(_records(so if r == 0 else se))
        assert "gloo" in se  # ranks on the CPU
    assert _records(wait("multihost1")[1]) == []  # only rank 0 logs to stdout
    assert [rec["loss"] for rec in logs[0]] == [rec["loss"] for rec in logs[1]]

    parts = [next(iter(jsynthetic_batches(batch_size=4, image_size=32, steps=1,
                                          num_classes=10, seed=s))) for s in (0, 1)]
    x = jnp.concatenate([p[0] for p in parts])
    y = jnp.concatenate([p[1] for p in parts])
    jcfg = jresnet.get_config("resnet18", num_classes=10)
    tcfg = jtrain.TrainConfig(lr=0.1, momentum=0.9, weight_decay=1e-4, policy_name="fp32")
    sched = jtrain.cosine_schedule(0.1, 3, warmup_steps=5)
    jts = _jax_state(ranks.step_state(0))
    want = []
    for _ in range(3):
        jts, m = jtrain.train_step(jcfg, tcfg, jts, x, y, sched(jts.step))
        want.append(float(m["loss"]))
    got = [rec["loss"] for rec in logs[0]]
    # Steps 1 and 2 run before any update moves a weight (the warm-up's rate
    # is 0 at step 0).  Step 3 follows one update at lr 0.02, after which the
    # port's own one-process step already stands more than 1e-5 from JAX's
    # on this ill-conditioned input (layer4's BN over 8 values).
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4)
    assert [rec["step"] for rec in logs[0]] == [1, 2, 3]
    saved = tckpt.load_train_state(out / "ck", ranks.step_state(0))
    assert int(saved.step) == 3


def test_data_dim_cli_logs_what_one_rank_logs(launches, capsys):
    """``--data-dim 2`` spawns two ranks on one global batch: rank 0 logs
    what the one-process run logs; rank 1 logs the same to stderr."""
    _, wait = launches
    rc, so, se = wait("data_dim")
    assert rc == 0, se[-3000:]
    dp, dp1 = _records(so), _records(se)
    tcli.run_train(tcli.build_parser().parse_args(CLI_BASE), device="cpu")
    one = _records(capsys.readouterr().out)
    assert len(dp) == len(one) == 3
    for a, b, c in zip(dp, dp1, one):
        assert a["step"] == b["step"] == c["step"]
        assert a["loss"] == b["loss"] and a["accuracy"] == b["accuracy"] == c["accuracy"]
        np.testing.assert_allclose(a["loss"], c["loss"], rtol=1e-5)


# ---------------------------------------------------------------------------
# What is still refused
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv, item", [
    (["verify", "--model-dim", "2"], "Queue 1 item 3b"),
    (["verify", "--data-dim", "2"], "Queue 1 item 3"),
    (["verify", "--multihost", "--coordinator", "127.0.0.1:1", "--num-processes", "2",
      "--process-id", "0"], "Queue 1 item 3"),
])
def test_unported_options_name_their_roadmap_items(argv, item):
    args = tcli.build_parser().parse_args(argv + ["--model", "resnet18"])
    run = tcli.run_train if argv[0] == "train" else tcli.run_verify
    with pytest.raises(SystemExit, match=item):
        run(args, device="cpu")


def test_model_axis_and_other_backends_refuse_a_mesh():
    """A model axis is refused by the int8 engines, with JAX's reasons
    (``fp``, ``pallas`` and ``pallas_block`` take it:
    ``test_torch_tp.py``; every backend takes a data axis:
    ``test_dp_serving_*``)."""
    cfg = ranks.step_config()
    variables = tresnet.init(cfg, torch.Generator().manual_seed(0))
    for backend in ("int8", "int8_chain"):
        with pytest.raises(ValueError, match="does not support --model-dim > 1"):
            InferenceEngine(cfg, variables, backend=backend, device="cpu",
                            calib_batch=np.zeros((1, 32, 32, 3), np.float32),
                            mesh={"data": 1, "model": 2})
