"""The port's channel tensor parallelism (the mesh's model axis) vs the JAX
package's and vs one process of the port, on the CPU over gloo.

Three launches, started together by the ``launches`` fixture, each rank a
fresh process that imports no JAX, one thread each: the ranks of a 1 x 2,
a 2 x 2 and a 2 x 1 (data, model) mesh, each running every check of its
shape (``torch_tp_ranks.library``): on the TP meshes the unfolded and the
folded forward on ``tests/test_parallel.py::test_tp_forward_matches_replicated``'s
ResNet-18 (8 classes, JAX's weights carried across with
``checkpoint.variables_from_jax_numpy``, batch 4 at 32 px, FP32) and the
shards of its tree; on 1 x 2 the ``fp``, ``pallas`` and ``pallas_block``
engines (ResNet-50 cut to (2, 1, 1, 1) blocks); two train steps per case
(ResNet-18 with 8 classes, the fc sharded, and with 11, the fc
replicated, under ``remat``, on all three meshes; on 1 x 2 also two
grouped nets, one whose 8 groups split over the axis and one whose 3
groups do not), a checkpoint of the gathered state, and the CLI's
``train`` and ``classify`` rank bodies under ``--model-dim 2``.

Tolerances.  Against JAX's forward on its 2 x 4 CPU mesh:
``tests/test_parallel.py``'s rtol 1e-4, atol 1e-5.  Against one process of
the port, the forwards and engines: rtol 1e-6, atol 1e-6 (they are equal
bit for bit where both run at one thread; this process may run more, and
an fp32 convolution on the CPU sums in an order that follows the thread
count).  The train steps (two SGD steps at lr 0.01) against the same
steps without a model axis (one process for 1 x 2; the 2 x 1 ranks for
2 x 2): per step loss rtol 1e-5 / 1e-4 and ``grad_norm`` rtol 1e-4 / 1e-3
(the whole model's: an M-fold gradient or a norm over one shard stands
far off at the first step), accuracy equal, and every parameter, momentum
buffer and BN stat within 1e-3 of its largest magnitude (the
reduce-scatter sums a conv's input gradient in another order, and
train-mode BN over 4 images amplifies that at the second step).  The 2 x 2
and 2 x 1 runs against one process: the first step as tightly, the second
loss rtol 1e-3, ``grad_norm`` rtol 1e-2, which data parallelism alone
needs there (sync-BN over two ranks of 2 images: layer4's BN over 4
values).
"""

from __future__ import annotations

import argparse
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
import torch_tp_ranks as ranks

from resnetc_tpu.models import resnet as jresnet
from resnetc_tpu.ops.pallas import fused as jfused
from resnetc_tpu.parallel import batch_sharding as jbatch_sharding
from resnetc_tpu.parallel import create_mesh as jcreate_mesh
from resnetc_tpu.parallel import param_shardings as jparam_shardings
from resnetc_tpu.serve import InferenceEngine as JEngine
from resnetc_tpu.tensor import FP32 as JFP32
from resnetc_tpu_torch import __main__ as tcli
from resnetc_tpu_torch import checkpoint as tckpt
from resnetc_tpu_torch import train as ttrain
from resnetc_tpu_torch.data import preprocess as tpre
from resnetc_tpu_torch.models import resnet as tresnet
from resnetc_tpu_torch.ops.cuda import fused as tfused
from resnetc_tpu_torch.parallel import distributed as tdistributed
from resnetc_tpu_torch.serve import InferenceEngine
from resnetc_tpu_torch.tensor import FP32, flatten_tree

REPO = Path(__file__).resolve().parent.parent
LIBRARY = "import torch_tp_ranks as r; r.main()"
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "2x1": (2, 1)}
TP_MESHES = ["1x2", "2x2"]
CLOSE = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Write the inputs, start both meshes' ranks together; ``results(name)``
    gives every rank's pickled results, ``out`` the directory."""
    out = tmp_path_factory.mktemp("tp")
    cfg = jresnet.get_config(ranks.FORWARD_MODEL[0], num_classes=ranks.FORWARD_MODEL[1])
    # tests/test_parallel.py's weights, drawn in one jitted call.
    variables = jax.tree.map(np.asarray,
                             jax.jit(jresnet.init, static_argnums=0)(cfg, jax.random.key(4)))
    x = np.asarray(jax.random.normal(jax.random.key(5), (4, 32, 32, 3), jnp.float32))
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump({"variables": variables, "x": x}, f)
    for i in range(2):
        tpre.save_input_bin(
            np.random.default_rng(20 + i).standard_normal((1, 3, 32, 32)).astype(np.float32),
            out / f"{i}.bin")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]))
    procs = {}
    for name, (n_data, n_model) in MESHES.items():
        port, world = tdistributed.free_port(), n_data * n_model
        for r in range(world):
            with open(out / f"{name}.{r}.err", "w") as e:
                procs[name, r] = subprocess.Popen(
                    [sys.executable, "-c", LIBRARY, str(r), str(world), str(n_data), str(port),
                     str(out)], stdout=subprocess.DEVNULL, stderr=e, cwd=REPO, env=env)

    def results(name):
        n_data, n_model = MESHES[name]
        res = []
        for r in range(n_data * n_model):
            rc = procs[name, r].wait(timeout=600)
            assert rc == 0, f"{name} rank {r} failed:\n{(out / f'{name}.{r}.err').read_text()[-3000:]}"
            with open(out / f"{n_data}x{n_model}" / f"rank{r}.pkl", "rb") as f:
                res.append(pickle.load(f))
        return res

    try:
        yield out, results, (variables, x)
    finally:
        # A rank whose peer failed blocks in a collective: never leak it.
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def jax_tp_forward(launches):
    """JAX's forward on its 2 x 4 CPU mesh, as ``tests/test_parallel.py``'s
    TP test runs it."""
    _, _, (variables, x) = launches
    cfg = jresnet.get_config(ranks.FORWARD_MODEL[0], num_classes=ranks.FORWARD_MODEL[1])
    mesh = jcreate_mesh(2, 4)
    jv = jax.tree.map(jnp.asarray, variables)
    vs = jax.device_put(jv, jparam_shardings(mesh, jv))
    xs = jax.device_put(jnp.asarray(x), jbatch_sharding(mesh))
    got, _ = jax.jit(lambda v, xx: jresnet.forward(cfg, v, xx, policy=JFP32))(vs, xs)
    return np.asarray(got)


def _one_process_forwards(variables, x):
    cfg = tresnet.get_config(ranks.FORWARD_MODEL[0], num_classes=ranks.FORWARD_MODEL[1])
    tv = tckpt.variables_from_jax_numpy(variables)
    xt = torch.from_numpy(x.copy())
    fwd, _ = tresnet.forward(cfg, tv, xt, policy=FP32)
    folded = tresnet.forward_folded(cfg, tresnet.fold_inference_params(cfg, tv), xt,
                                    policy=FP32)
    return fwd.numpy(), folded.numpy()


@pytest.mark.parametrize("mesh", TP_MESHES)
def test_tp_forward_matches_jax(launches, jax_tp_forward, mesh):
    """(a) The port's ``forward(model_group=)`` against JAX's TP forward on
    its 2 x 4 mesh, every rank's gathered logits."""
    _, results, _ = launches
    for r in results(mesh):
        assert r["forward"].shape == (4, ranks.FORWARD_MODEL[1])
        np.testing.assert_allclose(r["forward"], jax_tp_forward, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mesh", TP_MESHES)
def test_tp_forwards_equal_one_process(launches, mesh):
    """(b) ``forward`` and ``forward_folded`` under a model group against the
    port's one-process run."""
    _, results, (variables, x) = launches
    fwd, folded = _one_process_forwards(variables, x)
    for r in results(mesh):
        np.testing.assert_allclose(r["forward"], fwd, **CLOSE)
        np.testing.assert_allclose(r["forward_folded"], folded, **CLOSE)


@pytest.mark.parametrize("mesh", TP_MESHES)
def test_tp_shards_follow_the_rules_and_gather_back(launches, mesh):
    """``shard_tree``: each leaf halved on the dimension JAX's rules name
    (conv O, fc out, every vector), as a contiguous copy; ``gather_tree``
    gives back the whole tree bit for bit."""
    _, results, (variables, _) = launches
    whole = flatten_tree(tckpt.variables_from_jax_numpy(variables))
    for r in results(mesh):
        assert r["shards"]["contiguous"] and r["shards"]["round_trip"]
        shapes = r["shards"]["shapes"]
        assert set(shapes) == set(whole)
        for k, t in whole.items():
            want = list(t.shape)
            want[3 if t.ndim == 4 else 0] //= 2
            assert shapes[k] == tuple(want), k


@pytest.fixture(scope="module")
def engine_references():
    cfg, variables, x = ranks.engine_inputs()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return {b: InferenceEngine(cfg, variables, backend=b, policy=FP32,
                                   device="cpu").logits(x).numpy()
                for b in ranks.ENGINE_BACKENDS}


@pytest.mark.parametrize("backend", list(ranks.ENGINE_BACKENDS))
def test_tp_engine_matches_one_process(launches, engine_references, backend):
    """(c) The engine under a 1 x 2 mesh against one process: ``fp`` and
    ``pallas`` hold the fc's shard (4 of 8 classes) and split channels;
    ``pallas_block`` holds the whole tree on both model ranks."""
    _, results, _ = launches
    for r in results("1x2"):
        np.testing.assert_allclose(r[f"engine/{backend}"], engine_references[backend], **CLOSE)
        rows = 8 if backend == "pallas_block" else 4
        assert r[f"engine/{backend}/fc"] == (rows, 2048)


@pytest.fixture(scope="module")
def step_references():
    """Two one-process ``train_step``s per train case: metrics and state."""
    refs = {}
    for case, (spec, remat, _) in ranks.TRAIN_CASES.items():
        cfg = ranks.config(spec)
        ts = ranks.step_state(cfg)
        x, y = ranks.step_batch(cfg.num_classes)
        metrics = []
        for _ in range(ranks.STEPS):
            ts, m = ttrain.train_step(cfg, ranks.train_config(remat), ts, torch.from_numpy(x),
                                      torch.from_numpy(y), ranks.STEP_LR)
            metrics.append({k: float(v) for k, v in m.items()})
        refs[case] = {"metrics": metrics, "state": ranks.state_np(ts)}
    return refs


#: A leaf of a TP state against the run without a model axis: its largest
#: difference within this share of its largest magnitude.
STATE_TOL = 1e-3


def _assert_state_close(got, want, label):
    assert got["step"] == want["step"] == ranks.STEPS
    for name in ("params", "bn_state", "momentum"):
        assert set(got[name]) == set(want[name]), (label, name)
        for k, w in want[name].items():
            err = np.abs(got[name][k] - w).max() / np.abs(w).max()
            assert err <= STATE_TOL, f"{label}: {name}.{k} stands {err:.3g} of its max off"


def _assert_metrics_close(got, want, label, rtol):
    """``rtol``: per step, (loss, grad_norm)."""
    assert len(got) == len(want) == len(rtol) == ranks.STEPS
    for i, (g, w, (r_loss, r_norm)) in enumerate(zip(got, want, rtol)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=r_loss, err_msg=f"{label} {i}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=r_norm,
                                   err_msg=f"{label} {i}")
        assert g["accuracy"] == w["accuracy"], (label, i)


#: Against the run without a model axis (one process for 1 x 2, the 2 x 1
#: data-parallel ranks for 2 x 2), both steps: (loss, grad_norm) rtols.
TP_RTOL = ((1e-5, 1e-4), (1e-4, 1e-3))
#: The 2 x 2 runs against one process.  The second step of sync-BN over
#: this batch (4 images, layer4's BN over 4 values, its variance a
#: difference of near moments) moves ~3e-4 in the loss and ~3e-3 in
#: grad_norm with data parallelism alone (the 2 x 1 runs): held there.
DP_RTOL = ((1e-5, 1e-4), (1e-3, 1e-2))


def _train_results(results, mesh, case):
    res = [r[f"train/{case}"] for r in results(mesh)]
    for r in res[1:]:  # every rank's metrics and gathered state are rank 0's
        assert r["metrics"] == res[0]["metrics"] and r["digest"] == res[0]["digest"]
    return res[0]


@pytest.mark.parametrize("case, mesh", [(c, f"{d}x{m}") for c, (_, _, meshes)
                                        in ranks.TRAIN_CASES.items() for d, m in meshes
                                        if m > 1])
def test_tp_train_steps_match_one_process(launches, step_references, case, mesh):
    """(d) Two TP steps against two steps without a model axis (one
    process; for 2 x 2, the 2 x 1 ranks, themselves held to one process):
    loss, accuracy, ``grad_norm`` (the whole model's: an M-fold gradient or
    a norm over one shard stands far off at the first step), and the
    gathered params, momentum and BN state."""
    _, results, _ = launches
    got = _train_results(results, mesh, case)
    one = step_references[case]
    if mesh == "1x2":
        want = one
    else:
        want = _train_results(results, "2x1", case)
        _assert_metrics_close(want["metrics"], one["metrics"], f"{case} 2x1", DP_RTOL)
        _assert_metrics_close(got["metrics"], one["metrics"], f"{case} {mesh}", DP_RTOL)
    _assert_metrics_close(got["metrics"], want["metrics"], f"{case} {mesh}", TP_RTOL)
    _assert_state_close(got["state"], want["state"], f"{case} {mesh}")


def test_tp_checkpoint_loads_in_one_process(launches, step_references):
    """(e) The checkpoint of the gathered 1 x 2 state, loaded by one
    process: the ranks' whole state bit for bit, and within the train
    tolerances of the one-process steps."""
    out, results, _ = launches
    got = results("1x2")[0]["train/resnet18-8"]["state"]
    cfg = ranks.config(ranks.TRAIN_CASES["resnet18-8"][0])
    loaded = ranks.state_np(tckpt.load_train_state(out / "ck", ranks.step_state(cfg)))
    assert loaded["step"] == got["step"]
    for name in ("params", "bn_state", "momentum"):
        assert set(loaded[name]) == set(got[name])
        for k, v in got[name].items():
            np.testing.assert_array_equal(loaded[name][k], v, err_msg=k)
    _assert_state_close(loaded, step_references["resnet18-8"]["state"], "checkpoint")


def _train_log(text: str) -> list[dict]:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith('{"tag": "train"')]


def test_tp_cli_train_and_classify_equal_one_process(launches, capsys):
    """The CLI's rank bodies under ``--model-dim 2``: ``train`` logs the
    one-process run's losses and writes a checkpoint and an export of the
    whole state (the export equals the checkpoint's tree bit for bit, the
    checkpoint the one-process state within the train tolerances);
    ``classify`` prints one process's lines."""
    out, results, _ = launches
    cli = results("1x2")[0]["cli"]
    capsys.readouterr()
    one = tcli.run_train(tcli.build_parser().parse_args(ranks.CLI_TRAIN), device="cpu")
    want_log = _train_log(capsys.readouterr().out)
    got_log = _train_log(cli["train_log"])
    assert [r["step"] for r in got_log] == [r["step"] for r in want_log] == [1, 2]
    for a, b in zip(got_log, want_log):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        assert a["accuracy"] == b["accuracy"]
    cfg = tresnet.get_config("resnet18", num_classes=10)
    saved = tckpt.load_train_state(out / "cli_ck", ttrain.init_train_state(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    _assert_state_close(ranks.state_np(saved), ranks.state_np(one), "cli checkpoint")
    exported = flatten_tree(tckpt.load_reference_format(cfg, out / "cli_export"))
    want = flatten_tree(tresnet.merge_params_state(saved.params, saved.bn_state))
    assert set(exported) == set(want) and all(torch.equal(exported[k], want[k]) for k in want)

    argv = ["classify", *ranks.CLI_MODEL, "--policy", "fp32",
            *[str(out / f"{i}.bin") for i in range(2)]]
    assert cli["classify"] == tcli.run_classify(tcli.build_parser().parse_args(argv),
                                                device="cpu")


@pytest.mark.parametrize("command", ["classify", "eval", "train"])
def test_cli_spawns_data_times_model_ranks(monkeypatch, command):
    """``--data-dim 2 --model-dim 2``: the command spawns four ranks."""
    seen = []
    monkeypatch.setattr(tdistributed, "spawn",
                        lambda fn, n, *a, **kw: seen.append((fn.__name__, n)) or [None])
    extra = {"classify": ["x.bin"], "eval": ["tree"], "train": []}[command]
    args = tcli.build_parser().parse_args([command, "--model", "resnet18", "--data-dim", "2",
                                           "--model-dim", "2", *extra])
    {"classify": tcli.run_classify, "eval": tcli.run_eval, "train": tcli.run_train}[command](
        args, device="cpu")
    assert seen == [("_train_rank" if command == "train" else "_serving_rank", 4)]


# ---------------------------------------------------------------------------
# (f) What refuses a model axis, and int8_chain's undivided batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["int8", "int8_static", "int8_chain"])
def test_int8_backends_refuse_a_model_axis(backend):
    """The engine (``int8``, ``int8_chain``) and ``fused_forward_sharded``
    (all three) refuse a model axis with JAX's reason; the CLI does before
    any rank starts."""
    cfg = tresnet.get_config("resnet18", num_classes=8)
    mesh = {"data": 1, "model": 2}
    match = "use --data-dim 2 instead"
    if backend != "int8_static":
        variables = tresnet.init(cfg, torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match=match):
            InferenceEngine(cfg, variables, backend=backend, device="cpu", mesh=mesh,
                            calib_batch=np.zeros((1, 32, 32, 3), np.float32))
        with pytest.raises(SystemExit, match=match):
            tcli.run_classify(tcli.build_parser().parse_args(
                ["classify", "--backend", backend, "--model-dim", "2", "x.bin"]), device="cpu")
    with pytest.raises(ValueError, match=match):
        tfused.fused_forward_sharded(cfg, {}, torch.zeros(2, 32, 32, 3), mesh, backend=backend)


def test_jax_int8_engine_raises_under_a_mesh_where_the_port_refuses():
    """JAX's ``int8`` engine cannot place its quantized tree with the folded
    tree's shardings (``resnetc_tpu/serve.py:146-147``), under a model axis
    as under a data-only mesh; the port refuses a model axis with that
    reason (and serves ``int8`` over a data axis:
    ``test_torch_parallel.py``)."""
    cfg = jresnet.get_config("resnet18", num_classes=8)
    variables = jax.jit(jresnet.init, static_argnums=0)(cfg, jax.random.key(0))
    mesh = jcreate_mesh(4, 2)
    sharding = jparam_shardings(mesh, jresnet.fold_inference_params(cfg, variables))
    with pytest.raises(ValueError, match="tree prefix"):
        JEngine(cfg, variables, policy=JFP32, backend="int8", sharding=sharding, mesh=mesh)
    with pytest.raises(ValueError, match="serve.py:146-147"):
        InferenceEngine(tresnet.get_config("resnet18", num_classes=8),
                        tresnet.init(tresnet.get_config("resnet18", num_classes=8),
                                     torch.Generator().manual_seed(0)),
                        backend="int8", device="cpu", mesh={"data": 4, "model": 2})


def test_int8_chain_refuses_a_batch_the_data_axis_does_not_divide():
    """Three images over two data ranks: JAX's ``shard_map`` raises, and so
    does the port's ``int8_chain`` (its DP entry and ``fused_forward_sharded``),
    with JAX's words; the other backends pad (``test_torch_parallel.py``)."""
    x = np.zeros((3, 32, 32, 3), np.float32)
    with pytest.raises(ValueError) as want:
        jfused.fused_forward_int8_chain_sharded(
            jresnet.get_config("resnet18", num_classes=8), {}, {}, jnp.asarray(x),
            jcreate_mesh(2, 1), interpret=True)
    cfg = tresnet.get_config("resnet18", num_classes=8)
    mesh = {"data": 2, "model": 1}
    for fn in (lambda: tfused.fused_forward_int8_chain_sharded(cfg, {}, {}, torch.from_numpy(x),
                                                               mesh),
               lambda: tfused.fused_forward_sharded(cfg, {}, torch.from_numpy(x), mesh,
                                                    backend="int8_chain")):
        with pytest.raises(ValueError) as got:
            fn()
        for words in ("not evenly divisible by the corresponding mesh axis sizes",
                      "(of size 3)", "mesh axis 'data' (of size 2)",
                      "but 2 does not evenly divide 3"):
            assert words in str(want.value) and words in str(got.value), words


def test_cli_refuses_a_model_axis_that_does_not_divide_the_channels():
    """ResNet-18's 64 channels over 3 model ranks: refused before any rank
    starts (JAX's partitioner would replicate such layers)."""
    for argv in (["train", "--model", "resnet18", "--model-dim", "3"],
                 ["classify", "--model", "resnet18", "--model-dim", "3", "x.bin"]):
        run = tcli.run_train if argv[0] == "train" else tcli.run_classify
        with pytest.raises(SystemExit, match="does not divide the channels"):
            run(tcli.build_parser().parse_args(argv), device="cpu")
