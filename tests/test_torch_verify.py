"""The port's verification surface vs the JAX package's, on the CPU.

The twin (a copy in the port) must build the JAX twin's weights from the
same seed; ``logit_report`` / ``stage_parity_report`` and the ``verify``
command must give the JAX package's numbers (ResNet-18 and the tiny
bottleneck config of ``tests/test_torch_model.py``, 64 px, FP32: within
1e-5, both sides being fp32 errors against the same twin);
``synthetic_batches`` the same arrays bit for bit; ``model_flops`` the same
counts.  The unfolded eval-mode forward equals the folded one within 1e-4
(FP32; BN folded into the weights rounds differently).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

from resnetc_tpu import __main__ as jcli
from resnetc_tpu.data import synthetic_batches as jsynthetic
from resnetc_tpu.models import resnet as jresnet
from resnetc_tpu.utils.flops import model_flops as jflops
from resnetc_tpu.verify import harness as jharness
from resnetc_tpu.verify.twin import build_twin as jbuild_twin
from resnetc_tpu_torch import __main__ as tcli
from resnetc_tpu_torch import checkpoint as tckpt
from resnetc_tpu_torch.data.loader import synthetic_batches
from resnetc_tpu_torch.models import resnet as tresnet
from resnetc_tpu_torch.tensor import FP32, flatten_tree
from resnetc_tpu_torch.utils.flops import model_flops
from resnetc_tpu_torch.verify import harness
from resnetc_tpu_torch.verify.twin import build_twin

TINY = dict(name="tiny", block="bottleneck", stage_blocks=(3, 2, 2, 2), num_classes=11,
            stem_width=16)
CONFIGS = {"tiny": TINY, "resnet18": dict(name="resnet18", block="basic",
                                          stage_blocks=(2, 2, 2, 2), num_classes=1000)}


@pytest.mark.parametrize("name", ["tiny", "resnet18", "resnext50_32x4d"])
def test_twin_state_dict_equals_jax_twin(name):
    kw = CONFIGS.get(name) or {}
    jcfg = jresnet.ResNetConfig(**kw) if kw else jresnet.get_config(name)
    tcfg = tresnet.ResNetConfig(**kw) if kw else tresnet.get_config(name)
    want, got = jbuild_twin(jcfg, seed=7).state_dict(), build_twin(tcfg, seed=7).state_dict()
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_build_twin_leaves_the_global_rng_as_it_was():
    torch.manual_seed(123)
    before = torch.get_rng_state()
    build_twin(tresnet.ResNetConfig(**TINY), seed=0)
    assert torch.equal(torch.get_rng_state(), before)


@pytest.mark.parametrize("name", ["tiny", "resnet18"])
def test_reports_match_jax(name, rng):
    jcfg, tcfg = jresnet.ResNetConfig(**CONFIGS[name]), tresnet.ResNetConfig(**CONFIGS[name])
    twin = build_twin(tcfg, seed=3)
    x = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    want = jharness.logit_report(jcfg, twin, x)
    got = harness.logit_report(tcfg, twin, x, device="cpu")
    assert got.argmax_match_rate == want.argmax_match_rate == 1.0
    assert got.mae == pytest.approx(want.mae, abs=1e-5)
    assert got.max_abs_err == pytest.approx(want.max_abs_err, abs=1e-5)
    assert got.mae <= harness.LOGIT_MAE_GATE
    want_st = jharness.stage_parity_report(jcfg, twin, x)
    got_st = harness.stage_parity_report(tcfg, twin, x, device="cpu")
    assert list(got_st) == list(want_st) == ["stem", "layer1", "layer2", "layer3", "layer4",
                                             "logits"]
    for stage in want_st:
        for key in ("mae", "max"):
            assert got_st[stage][key] == pytest.approx(want_st[stage][key], abs=1e-5), stage
    assert next(twin.parameters()).device.type == "cpu"


def test_forward_eval_equals_forward_folded(rng):
    cfg = tresnet.ResNetConfig(**TINY)
    variables = tresnet.init(cfg, torch.Generator().manual_seed(2))
    # Non-identity running stats, as after training.
    g = torch.Generator().manual_seed(3)
    for k, v in flatten_tree(variables).items():
        if k.endswith("running_mean"):
            v.normal_(generator=g).mul_(0.1)
        elif k.endswith("running_var"):
            v.uniform_(0.5, 1.5, generator=g)
    x = torch.from_numpy(rng.standard_normal((2, 64, 64, 3)).astype(np.float32))
    logits, state = tresnet.forward(cfg, variables, x, policy=FP32)
    folded = tresnet.forward_folded(cfg, tresnet.fold_inference_params(cfg, variables), x,
                                    policy=FP32)
    assert state == {}
    np.testing.assert_allclose(logits.numpy(), folded.numpy(), rtol=0, atol=1e-4)


def _verify_args(*argv) -> argparse.Namespace:
    return tcli.build_parser().parse_args(["verify", *argv])


def test_verify_command_matches_jax():
    argv = ["--model", "resnet18", "--image-size", "64", "--policy", "fp32", "--per-stage",
            "--seed", "2"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = jcli.main(["verify", *argv])
    want = json.loads(out.getvalue().strip().splitlines()[-1])
    got = tcli.run_verify(_verify_args(*argv), device="cpu")
    assert rc == 0 and list(got) == list(want)
    assert got["pass"] is want["pass"] is True
    for key in ("logit_mae", "max_abs_err", "argmax_match_rate"):
        assert got[key] == pytest.approx(want[key], abs=1e-5), key
    assert list(got["stages"]) == list(want["stages"])
    json.dumps(got)


def test_verify_pass_rule():
    """FP32 passes on argmax and MAE <= 1e-3; BF16 on argmax alone."""
    got = tcli.run_verify(_verify_args("--model", "resnet18", "--image-size", "32",
                                       "--policy", "bf16"), device="cpu")
    assert got["pass"] == (got["argmax_match_rate"] == 1.0)
    assert "stages" not in got


def test_synthetic_batches_equal_jax():
    kw = dict(batch_size=3, image_size=16, steps=2, num_classes=7, seed=9)
    want = list(jsynthetic(**kw))
    got = list(synthetic_batches(**kw, device="cpu"))
    assert len(got) == len(want) == 2
    for (tx, ty), (jx, jy) in zip(got, want):
        assert tx.dtype == torch.float32 and ty.dtype == torch.int32
        assert np.array_equal(tx.numpy(), np.asarray(jx))
        assert np.array_equal(ty.numpy(), np.asarray(jy))


def test_model_flops_equal_jax():
    for name, jcfg in jresnet.RESNET_CONFIGS.items():
        for size in (224, 64):
            assert model_flops(tresnet.get_config(name), size) == jflops(jcfg, size), name


def test_synthetic_batches_without_cuda_raise():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: device=None rightly selects it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(synthetic_batches(batch_size=1, image_size=8, steps=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["verify", "--model", "resnet18", "--image-size", "32"])


def test_train_state_from_jax_numpy_carries_every_leaf():
    from resnetc_tpu import train as jtrain

    jcfg = jresnet.ResNetConfig(**TINY)
    jts = jtrain.init_train_state(jcfg, jax.random.key(0))
    ts = tckpt.train_state_from_jax_numpy(jax.tree.map(np.asarray, jts))
    assert int(ts.step) == 0 and ts.step.dtype == torch.int32
    for name in ("params", "bn_state", "momentum"):
        got = flatten_tree(getattr(ts, name))
        want = flatten_tree(jax.tree.map(np.asarray, getattr(jts, name)))
        assert set(got) == set(want)
        assert all(np.array_equal(got[k].numpy(), want[k]) for k in want)
