"""The port's training path vs the JAX package's, on the CPU.

Inputs come from seeded numpy generators; JAX trees and train states are
carried into the port with ``variables_from_jax_numpy`` and
``train_state_from_jax_numpy``.  Models: the tiny bottleneck config of
``tests/test_torch_model.py`` (stem 16, 11 classes) at 32 px, batch 4, and
ResNet-18 with 10 classes at 32 px for the step.  The train-mode forward
and the gradients take the tiny config at 64 px: at 32 px its layer4 BN
normalises over 4 values (1x1 at batch 4), and there the JAX package and
the port each stand 3.1e-4 / 1.2e-4 (logits) and 2.3e-3 / 3.6e-4
(gradients) from the twin run in float64, so fp32 agreement to 1e-4 is not
to be had from either.  A gradient comparison also meets near-ties in the
max-pool windows, which fp32 rounding can resolve the other way in one
package (measured at batch 8: 3.8e-2 of JAX's gradient norm, 94% of it in
1% of one image's input pixels, while the port stood 9e-6 from float64),
so the port's gradients are held to the float64 twin as well as to JAX.

Tolerances (FP32): batch norm, cross-entropy and SGD 1e-6 (one fp32
rounding in another order; batch norm's outputs reach |6|, so rtol 1e-6
beside atol 1e-6 there); the train-mode forward atol 1e-4 (convolutions
sum in another order over 27 layers); gradients, and the momentum buffers
that hold them after a step, relative norm 1e-4 over all leaves; the train
step as ``tests/test_train.py`` holds JAX to torch: loss 5e-4, parameters
and BN stats rtol 1e-3, atol 1e-5.  One BF16 step (ResNet-18, 64 px,
batch 8): loss within 5e-3 relative and gradient norm within 2e-2 relative,
because XLA keeps excess precision across bf16 roundings that PyTorch
performs; over four seeds the spread measured at most 1.4e-3 and 6.6e-3
(at 32 px, batch 4, where layer4's BN sees 4 values, it reached 0.8% and
14%).  Those measurements come from the probes at the end of this file:
``PYTHONPATH=. python tests/test_torch_train.py [conditioning bf16
trajectory step_seeds]``.
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnetc_tpu import train as jtrain
from resnetc_tpu.models import resnet as jresnet
from resnetc_tpu.ops import lax_ops
from resnetc_tpu.tensor import FP32 as JFP32
from resnetc_tpu_torch import __main__ as tcli
from resnetc_tpu_torch import checkpoint as tckpt
from resnetc_tpu_torch import train as ttrain
from resnetc_tpu_torch.models import resnet as tresnet
from resnetc_tpu_torch.ops import torch_ops
from resnetc_tpu_torch.tensor import FP32, flatten_tree, policy, tree_map
from resnetc_tpu_torch.verify.twin import build_twin

TINY = dict(name="tiny", block="bottleneck", stage_blocks=(3, 2, 2, 2), num_classes=11,
            stem_width=16)


def _np(tree):
    """A JAX tree as numpy copies (safe across a donating call)."""
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _flat_np(tree) -> dict:
    return {k: np.asarray(v.detach().float() if hasattr(v, "detach") else v, np.float32)
            for k, v in flatten_tree(tree).items()}


def _jflat(tree) -> dict:
    return _flat_np(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def tiny():
    jcfg = jresnet.ResNetConfig(**TINY)
    tcfg = tresnet.ResNetConfig(**TINY)
    jvars = jresnet.init(jcfg, jax.random.key(11))
    return jcfg, tcfg, jvars


def test_policy_lookup():
    assert policy("fp32") is FP32 and policy("bf16").compute == torch.bfloat16
    with pytest.raises(ValueError):
        policy("fp16")


def test_batch_norm_train_matches_jax(rng):
    x = rng.standard_normal((4, 8, 8, 16)).astype(np.float32) * 2 + 0.5
    scale, bias, mean = (rng.standard_normal(16).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    want = lax_ops.batch_norm_train(*(jnp.asarray(a) for a in (x, scale, bias, mean, var)))
    got = torch_ops.batch_norm_train(*(torch.from_numpy(a) for a in (x, scale, bias, mean, var)))
    for g, w, name in zip(got, want, ("out", "running_mean", "running_var")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6, err_msg=name)
    assert not got[1].requires_grad and not got[2].requires_grad


def test_exact_fp32_sets_ieee_and_gives_the_settings_back():
    conv, mm = torch.backends.cudnn.conv, torch.backends.cuda.matmul
    saved = conv.fp32_precision, mm.fp32_precision
    conv.fp32_precision = mm.fp32_precision = "tf32"
    try:
        with pytest.raises(KeyError):
            with torch_ops.exact_fp32():
                assert (conv.fp32_precision, mm.fp32_precision) == ("ieee", "ieee")
                with torch_ops.exact_fp32():
                    pass
                assert (conv.fp32_precision, mm.fp32_precision) == ("ieee", "ieee")
                raise KeyError
        assert (conv.fp32_precision, mm.fp32_precision) == ("tf32", "tf32")
    finally:
        conv.fp32_precision, mm.fp32_precision = saved


@pytest.mark.parametrize("k, s, p, hw", [(3, 2, 1, 9), (7, 1, 0, 7), (2, 2, 0, 8)])
def test_avg_pool2d_matches_jax(rng, k, s, p, hw):
    x = rng.standard_normal((2, hw, hw, 5)).astype(np.float32)
    want = lax_ops.avg_pool2d(jnp.asarray(x), kernel_size=k, stride=s, padding=p)
    got = torch_ops.avg_pool2d(torch.from_numpy(x), kernel_size=k, stride=s, padding=p)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(rng, smoothing):
    logits = rng.standard_normal((8, 20)).astype(np.float32) * 3
    labels = rng.integers(0, 20, size=(8,)).astype(np.int32)
    want = jtrain.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                label_smoothing=smoothing)
    got = ttrain.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                               label_smoothing=smoothing)
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("momentum, nesterov", [(0.9, False), (0.9, True), (0.0, False)])
def test_sgd_update_matches_jax(rng, momentum, nesterov):
    shapes = {"a": {"weight": (3, 3, 4, 5)}, "b": {"bias": (7,)}}
    w0 = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                      is_leaf=lambda s: isinstance(s, tuple))
    jp, jbuf = jax.tree.map(jnp.asarray, w0), jtrain.init_momentum(jax.tree.map(jnp.asarray, w0))
    tp = tree_map(lambda a: torch.from_numpy(a.copy()), w0)
    tbuf = ttrain.init_momentum(tp)
    kw = dict(lr=0.05, momentum=momentum, weight_decay=0.01, nesterov=nesterov)
    for _ in range(3):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), w0)
        jp, jbuf = jtrain.sgd_update(jp, jax.tree.map(jnp.asarray, g), jbuf, **kw)
        tp, tbuf = ttrain.sgd_update(tp, tree_map(torch.from_numpy, g), tbuf, **kw)
    for got, want in ((tp, jp), (tbuf, jbuf)):
        g, w = _flat_np(got), _jflat(want)
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-6, err_msg=k)


def test_sgd_update_matches_torch_optim(rng):
    w0 = rng.standard_normal((5, 3)).astype(np.float32)
    tw = torch.tensor(w0.copy(), requires_grad=True)
    opt = torch.optim.SGD([tw], lr=0.1, momentum=0.9, weight_decay=0.01, nesterov=True)
    params, buf = {"w": torch.from_numpy(w0.copy())}, {"w": torch.zeros(5, 3)}
    for _ in range(5):
        opt.zero_grad()
        (tw**2).sum().backward()
        opt.step()
        params, buf = ttrain.sgd_update(params, {"w": 2 * params["w"]}, buf, lr=0.1,
                                        momentum=0.9, weight_decay=0.01, nesterov=True)
    np.testing.assert_allclose(params["w"].numpy(), tw.detach().numpy(), rtol=0, atol=1e-6)


def test_cosine_schedule_matches_jax():
    jl = jtrain.cosine_schedule(0.1, 100, warmup_steps=10)
    tl = ttrain.cosine_schedule(0.1, 100, warmup_steps=10)
    for step in (0, 5, 10, 55, 100):
        want = float(jl(step))
        assert float(tl(step)) == pytest.approx(want, rel=1e-6, abs=1e-9), step
        on_tensor = tl(torch.tensor(step, dtype=torch.int32))
        assert on_tensor.dtype == torch.float32 and float(on_tensor) == float(tl(step))


def test_split_merge_round_trip(tiny):
    jcfg, tcfg, jvars = tiny
    tvars = tckpt.variables_from_jax_numpy(_np(jvars))
    params, state = tresnet.split_params_state(tvars)
    jparams, jstate = jresnet.split_params_state(jvars)
    assert set(flatten_tree(params)) == set(_jflat(jparams))
    assert set(flatten_tree(state)) == set(_jflat(jstate))
    assert all(k.endswith(("running_mean", "running_var")) for k in flatten_tree(state))
    merged = flatten_tree(tresnet.merge_params_state(params, state))
    flat = flatten_tree(tvars)
    assert set(merged) == set(flat) and all(merged[k] is flat[k] for k in flat)


def test_forward_train_matches_jax(tiny, rng):
    jcfg, tcfg, jvars = tiny
    tvars = tckpt.variables_from_jax_numpy(_np(jvars))
    x = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    jlog, jstate = jresnet.forward(jcfg, jvars, jnp.asarray(x), train=True, policy=JFP32)
    tlog, tstate = tresnet.forward(tcfg, tvars, torch.from_numpy(x), train=True, policy=FP32)
    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog), rtol=0, atol=1e-4)
    _, bn_state = tresnet.split_params_state(tvars)
    got, want = _flat_np(tstate), _jflat(jstate)
    assert set(got) == set(flatten_tree(bn_state)) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    # Eval mode returns no state.
    assert tresnet.forward(tcfg, tvars, torch.from_numpy(x), policy=FP32)[1] == {}


def _rel_norm(got: dict, want: dict) -> float:
    """||got - want|| / ||want|| over every leaf of two flat trees."""
    num = sum(float(((np.asarray(got[k], np.float64) - want[k]) ** 2).sum()) for k in want)
    return (num / sum(float((np.asarray(want[k], np.float64) ** 2).sum()) for k in want)) ** 0.5


def test_loss_fn_gradients_match_jax():
    """FP32 gradients of ``loss_fn`` against ``jax.grad`` and against the
    twin's autograd in float64 (the exact gradient up to fp64 rounding)."""
    jcfg, tcfg = jresnet.ResNetConfig(**TINY), tresnet.ResNetConfig(**TINY)
    jvars = jresnet.init(jcfg, jax.random.key(5))
    jparams, jstate = jresnet.split_params_state(jvars)
    gen = np.random.default_rng(4)
    x = gen.standard_normal((4, 64, 64, 3)).astype(np.float32)
    y = gen.integers(0, 11, size=(4,)).astype(np.int32)
    jg = jax.grad(lambda p: jtrain.loss_fn(jcfg, p, jstate, jnp.asarray(x), jnp.asarray(y),
                                           policy=JFP32)[0])(jparams)
    tparams = tree_map(lambda t: t.requires_grad_(True),
                       tckpt.variables_from_jax_numpy(_np(jparams)))
    tstate = tckpt.variables_from_jax_numpy(_np(jstate))
    loss, _ = ttrain.loss_fn(tcfg, tparams, tstate, torch.from_numpy(x), torch.from_numpy(y),
                             policy=FP32)
    flat = flatten_tree(tparams)
    grads = {k: g.numpy() for k, g in zip(flat, torch.autograd.grad(loss, list(flat.values())))}
    want = _jflat(jg)
    assert set(grads) == set(want)
    assert _rel_norm(grads, want) <= 1e-4

    twin = build_twin(tcfg).double().train()
    sd = tckpt.torch_state_dict_from_variables(tckpt.variables_from_jax_numpy(_np(jvars)))
    twin.load_state_dict({k: v.double() for k, v in sd.items()}, strict=False)
    logits = twin(torch.from_numpy(x).double().permute(0, 3, 1, 2))
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(y).long()).backward()
    exact = {k: (p.grad.permute(2, 3, 1, 0) if p.ndim == 4 else p.grad).numpy()
             for k, p in twin.named_parameters()}
    assert _rel_norm(grads, exact) <= 1e-4


def _resnet18():
    return jresnet.get_config("resnet18", num_classes=10), tresnet.get_config(
        "resnet18", num_classes=10)


def test_train_steps_match_jax_with_resync():
    """Three steps on ResNet-18, each started from JAX's state (params, BN
    stats, momentum), so that every comparison is one step tight (a free
    trajectory through train-mode BN drifts chaotically)."""
    jcfg, tcfg = _resnet18()
    kw = dict(lr=0.01, momentum=0.9, weight_decay=1e-4, policy_name="fp32")
    jtc, ttc = jtrain.TrainConfig(**kw), ttrain.TrainConfig(**kw)
    jts = jtrain.init_train_state(jcfg, jax.random.key(3))
    gen = np.random.default_rng(4)
    for step in range(3):
        ts = tckpt.train_state_from_jax_numpy(_np(jts))
        x = gen.standard_normal((4, 32, 32, 3)).astype(np.float32)
        y = gen.integers(0, 10, size=(4,)).astype(np.int32)
        jts, jm = jtrain.train_step(jcfg, jtc, jts, jnp.asarray(x), jnp.asarray(y),
                                    jnp.float32(0.01))
        ts, tm = ttrain.train_step(tcfg, ttc, ts, torch.from_numpy(x), torch.from_numpy(y),
                                   0.01)
        assert abs(float(tm["loss"]) - float(jm["loss"])) < 5e-4, step
        assert int(ts.step) == int(jts.step) == step + 1
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
        assert float(tm["accuracy"]) == float(jm["accuracy"])
        for name in ("params", "bn_state"):
            got, want = _flat_np(getattr(ts, name)), _jflat(getattr(jts, name))
            assert set(got) == set(want), name
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-5,
                                           err_msg=f"step {step}: {name}.{k}")
        # The momentum buffers hold the step's gradients: the gradient bound.
        assert _rel_norm(_flat_np(ts.momentum), _jflat(jts.momentum)) <= 1e-4, step


def test_train_step_bf16_within_bound():
    jcfg, tcfg = _resnet18()
    kw = dict(lr=0.1, momentum=0.9, weight_decay=1e-4, policy_name="bf16")
    jts = jtrain.init_train_state(jcfg, jax.random.key(5))
    ts = tckpt.train_state_from_jax_numpy(_np(jts))
    gen = np.random.default_rng(6)
    x = gen.standard_normal((8, 64, 64, 3)).astype(np.float32)
    y = gen.integers(0, 10, size=(8,)).astype(np.int32)
    _, jm = jtrain.train_step(jcfg, jtrain.TrainConfig(**kw), jts, jnp.asarray(x),
                              jnp.asarray(y), jnp.float32(0.1))
    ts, tm = ttrain.train_step(tcfg, ttrain.TrainConfig(**kw), ts, torch.from_numpy(x),
                               torch.from_numpy(y), 0.1)
    assert ttrain.TrainConfig(**kw).policy.compute == torch.bfloat16
    assert abs(float(tm["loss"]) / float(jm["loss"]) - 1) < 5e-3
    assert abs(float(tm["grad_norm"]) / float(jm["grad_norm"]) - 1) < 2e-2


def test_remat_matches_no_remat():
    """Block rematerialisation changes no gradient and no running stat
    (batch 16: at tiny batches train-mode BN amplifies reassociation noise)."""
    cfg = tresnet.get_config("resnet18", num_classes=6)
    variables = tresnet.init(cfg, torch.Generator().manual_seed(8))
    params, bn_state = tresnet.split_params_state(variables)
    gen = np.random.default_rng(9)
    x = torch.from_numpy(gen.standard_normal((16, 24, 24, 3)).astype(np.float32))
    y = torch.arange(16) % 6

    def grads(remat):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
        loss, (new_state, _) = ttrain.loss_fn(cfg, p, bn_state, x, y, policy=FP32, remat=remat)
        flat = flatten_tree(p)
        return torch.autograd.grad(loss, list(flat.values())), flatten_tree(new_state)

    (g0, s0), (g1, s1) = grads(False), grads(True)
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(g0, g1))
    den = sum(float((a**2).sum()) for a in g0)
    assert (num / max(den, 1e-12)) ** 0.5 < 1e-4
    assert set(s0) == set(s1) and all(torch.equal(s0[k], s1[k]) for k in s0)


def test_metrics_logger_and_timer():
    import io

    from resnetc_tpu_torch.utils.metrics import MetricsLogger, timer

    buf = io.StringIO()
    MetricsLogger(buf, prefix="train").log({"step": 1, "loss": torch.tensor(0.5)})
    assert json.loads(buf.getvalue()) == {"tag": "train", "step": 1, "loss": 0.5}
    with timer() as t:
        pass
    assert t["seconds"] >= 0


def test_train_state_save_load_round_trip(tmp_path):
    cfg = tresnet.ResNetConfig(**TINY)
    ts = ttrain.init_train_state(cfg, torch.Generator().manual_seed(1), device="cpu")
    ts.step += 7
    for t in flatten_tree(ts.momentum).values():
        t.normal_(generator=torch.Generator().manual_seed(2))
    tckpt.save_train_state(tmp_path, ts)
    like = ttrain.init_train_state(cfg, torch.Generator().manual_seed(3), device="cpu")
    back = tckpt.load_train_state(tmp_path, like)
    assert int(back.step) == 7 and back.step.dtype == torch.int32
    for name in ("params", "bn_state", "momentum"):
        got, want = flatten_tree(getattr(back, name)), flatten_tree(getattr(ts, name))
        assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    other = ttrain.init_train_state(tresnet.get_config("resnet18", num_classes=11),
                                    torch.Generator().manual_seed(3), device="cpu")
    with pytest.raises(ValueError):
        tckpt.load_train_state(tmp_path, other)


def _train_args(*extra) -> argparse.Namespace:
    return tcli.build_parser().parse_args([
        "train", "--model", "resnet18", "--num-classes", "10", "--image-size", "32",
        "--batch-size", "4", "--log-every", "1", "--policy", "fp32", *extra,
    ])


def test_cli_train_resume_continues_the_step_count(tmp_path, capsys):
    ck, wd = tmp_path / "ck", tmp_path / "w"
    ts = tcli.run_train(_train_args("--steps", "3", "--checkpoint-dir", str(ck),
                                    "--export-weights-dir", str(wd)), device="cpu")
    assert int(ts.step) == 3
    exported = tckpt.load_reference_format(tresnet.get_config("resnet18", num_classes=10), wd)
    want = flatten_tree(tresnet.merge_params_state(ts.params, ts.bn_state))
    got = flatten_tree(exported)
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    capsys.readouterr()
    ts = tcli.run_train(_train_args("--steps", "2", "--resume", str(ck)), device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"resumed from {ck} at step 3"
    steps = [json.loads(line)["step"] for line in out if line.startswith("{")]
    assert steps == [4, 5] and int(ts.step) == 5


def test_cli_train_refuses_what_is_not_ported():
    """A model axis that does not divide the channels (JAX's partitioner
    would replicate such layers; the port refuses), before any rank
    starts."""
    with pytest.raises(SystemExit, match="does not divide the channels"):
        tcli.run_train(_train_args("--steps", "1", "--model-dim", "3"), device="cpu")


def test_training_entry_points_without_cuda_raise():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: device=None rightly selects it")
    cfg = tresnet.ResNetConfig(**TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.init_train_state(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["train", "--model", "resnet18", "--steps", "1", "--batch-size", "2",
                   "--image-size", "32"])


# ---------------------------------------------------------------------------
# Measurements quoted in this module's docstring, in chip_smoke.py and in
# ROADMAP.md (Queue 3): ``python tests/test_torch_train.py [name ...]``,
# with JAX on the CPU.  Not collected by pytest.
# ---------------------------------------------------------------------------


def _exact_grads(tcfg, variables, x, y):
    """Gradients of the twin in float64 (HWIO conv weights), and its logits."""
    twin = build_twin(tcfg).double().train()
    sd = tckpt.torch_state_dict_from_variables(variables)
    twin.load_state_dict({k: v.double() for k, v in sd.items()}, strict=False)
    xt = torch.from_numpy(x).double().requires_grad_(True)
    logits = twin(xt.permute(0, 3, 1, 2))
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(y).long()).backward()
    grads = {k: (p.grad.permute(2, 3, 1, 0) if p.ndim == 4 else p.grad).numpy()
             for k, p in twin.named_parameters()}
    return grads, logits.detach().numpy(), xt.grad.numpy()


def _probe_conditioning():
    """The tiny config's FP32 logits and gradients, JAX and the port, each
    against the float64 twin."""
    jcfg, tcfg = jresnet.ResNetConfig(**TINY), tresnet.ResNetConfig(**TINY)
    jvars = jresnet.init(jcfg, jax.random.key(11))
    jparams, jstate = jresnet.split_params_state(jvars)
    tvars = tckpt.variables_from_jax_numpy(_np(jvars))
    for b, hw in ((4, 32), (4, 64), (8, 64)):
        gen = np.random.default_rng(1234)
        x = gen.standard_normal((b, hw, hw, 3)).astype(np.float32)
        y = gen.integers(0, 11, size=(b,)).astype(np.int32)
        jlog = np.asarray(jresnet.forward(jcfg, jvars, jnp.asarray(x), train=True,
                                          policy=JFP32)[0])
        tlog = tresnet.forward(tcfg, tvars, torch.from_numpy(x), train=True,
                               policy=FP32)[0].detach().numpy()
        jg = _jflat(jax.grad(lambda p: jtrain.loss_fn(
            jcfg, p, jstate, jnp.asarray(x), jnp.asarray(y), policy=JFP32)[0])(jparams))
        tp = tree_map(lambda t: t.requires_grad_(True),
                      tckpt.variables_from_jax_numpy(_np(jparams)))
        loss, _ = ttrain.loss_fn(tcfg, tp, tckpt.variables_from_jax_numpy(_np(jstate)),
                                 torch.from_numpy(x), torch.from_numpy(y), policy=FP32)
        flat = flatten_tree(tp)
        tg = {k: g.numpy() for k, g in zip(flat, torch.autograd.grad(loss, list(flat.values())))}
        exact, elog, _ = _exact_grads(tcfg, tvars, x, y)
        print(f"tiny b{b} {hw}px: logits max |diff| from float64 JAX "
              f"{np.abs(jlog - elog).max():.2e} port {np.abs(tlog - elog).max():.2e}; "
              f"gradients (norm relative) JAX {_rel_norm(jg, exact):.2e} "
              f"port {_rel_norm(tg, exact):.2e} JAX-port {_rel_norm(tg, jg):.2e}")
        if b == 8:
            jx = np.asarray(jax.grad(lambda xx: jtrain.loss_fn(
                jcfg, jparams, jstate, xx, jnp.asarray(y), policy=JFP32)[0])(jnp.asarray(x)))
            _, _, ex = _exact_grads(tcfg, tvars, x, y)
            err = (jx - ex) ** 2
            top = np.sort(err.ravel())[-err.size // 100:].sum() / err.sum()
            worst = int(np.argmax(err.reshape(b, -1).sum(1)))
            print(f"  JAX's input gradient: {top:.2f} of its squared error in 1% of the "
                  f"pixels, most of it in image {worst} "
                  f"({err[worst].sum() / err.sum():.2f})")


def _probe_bf16():
    """One BF16 step on ResNet-18, JAX and the port, over four seeds."""
    jcfg, tcfg = _resnet18()
    kw = dict(lr=0.1, momentum=0.9, weight_decay=1e-4, policy_name="bf16")
    for b, hw in ((8, 64), (4, 32)):
        for seed in (5, 6, 7, 8):
            jts = jtrain.init_train_state(jcfg, jax.random.key(seed))
            ts = tckpt.train_state_from_jax_numpy(_np(jts))
            gen = np.random.default_rng(seed + 1)
            x = gen.standard_normal((b, hw, hw, 3)).astype(np.float32)
            y = gen.integers(0, 10, size=(b,)).astype(np.int32)
            _, jm = jtrain.train_step(jcfg, jtrain.TrainConfig(**kw), jts, jnp.asarray(x),
                                      jnp.asarray(y), jnp.float32(0.1))
            _, tm = ttrain.train_step(tcfg, ttrain.TrainConfig(**kw), ts, torch.from_numpy(x),
                                      torch.from_numpy(y), 0.1)
            print(f"bf16 b{b} {hw}px seed {seed}: loss {float(tm['loss']) / float(jm['loss']) - 1:+.2e} "
                  f"grad_norm {float(tm['grad_norm']) / float(jm['grad_norm']) - 1:+.2e}")


def _probe_trajectory():
    """ResNet-50, 112 px, batch 32, BF16: 13 steps on one synthetic batch,
    cosine with 5 warm-up steps, at lr 0.1 and 0.02, in both packages."""
    from resnetc_tpu.data import synthetic_batches as jbatches

    jcfg, tcfg = jresnet.get_config("resnet50"), tresnet.get_config("resnet50")
    x, y = next(iter(jbatches(batch_size=32, image_size=112, steps=1, seed=0)))
    xt, yt = torch.from_numpy(np.array(x)), torch.from_numpy(np.array(y))
    for lr in (0.1, 0.02):
        jts = jtrain.init_train_state(jcfg, jax.random.key(0))
        ts = tckpt.train_state_from_jax_numpy(_np(jts))
        jsched = jtrain.cosine_schedule(lr, 13, warmup_steps=5)
        tsched = ttrain.cosine_schedule(lr, 13, warmup_steps=5)
        jl, tl = [], []
        for _ in range(13):
            jts, jm = jtrain.train_step(jcfg, jtrain.TrainConfig(), jts, x, y, jsched(jts.step))
            ts, tm = ttrain.train_step(tcfg, ttrain.TrainConfig(), ts, xt, yt, tsched(ts.step))
            jl.append(round(float(jm["loss"]), 3))
            tl.append(round(float(tm["loss"]), 3))
        print(f"resnet50 lr {lr}: JAX {jl}\n  port {tl}")


def _probe_step_seeds():
    """An FP32 ResNet-18 step at 64 px, batch 8, lr 0.1 on the CPU against
    the float64 twin with ``torch.optim.SGD``, over six init seeds: the
    worst leaf in band-widths (rtol 1e-3, atol 1e-5)."""
    import torch.nn.functional as F

    cfg = tresnet.get_config("resnet18")
    tc = ttrain.TrainConfig(policy_name="fp32")
    from resnetc_tpu_torch.data.loader import synthetic_batches

    x, y = next(iter(synthetic_batches(batch_size=8, image_size=64, steps=1, seed=5,
                                       device="cpu")))
    for seed in range(1, 7):
        ts = ttrain.init_train_state(cfg, torch.Generator().manual_seed(seed), device="cpu")
        v0 = tree_map(torch.clone, tresnet.merge_params_state(ts.params, ts.bn_state))
        ts, _ = ttrain.train_step(cfg, tc, ts, x, y, tc.lr)
        twin = build_twin(cfg).double().train()
        sd = tckpt.torch_state_dict_from_variables(v0)
        twin.load_state_dict({k: v.double() for k, v in sd.items()}, strict=False)
        opt = torch.optim.SGD(twin.parameters(), lr=tc.lr, momentum=tc.momentum,
                              weight_decay=tc.weight_decay)
        F.cross_entropy(twin(x.double().permute(0, 3, 1, 2)), y.long()).backward()
        opt.step()
        exact = flatten_tree(tckpt.variables_from_torch_state_dict(twin.state_dict()))
        got = flatten_tree(tresnet.merge_params_state(ts.params, ts.bn_state))
        ratios = sorted(((float(((got[k].double() - e.double()).abs()
                                 / (1e-5 + 1e-3 * e.double().abs())).max()), k)
                         for k, e in exact.items()), reverse=True)
        print(f"resnet18 step seed {seed}: " + ", ".join(f"{k} {r:.2f}" for r, k in ratios[:6]))


PROBES = {"conditioning": _probe_conditioning, "bf16": _probe_bf16,
          "trajectory": _probe_trajectory, "step_seeds": _probe_step_seeds}

if __name__ == "__main__":
    import sys

    jax.config.update("jax_platforms", "cpu")
    for name in sys.argv[1:] or PROBES:
        PROBES[name]()
