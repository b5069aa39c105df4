"""The port's ``pallas`` backend, its engine backends and the
``BASIC_DS_INT8=False`` route vs the JAX package's.

``fused_forward`` (the ``pallas`` backend) on ResNet-18 (10 classes) and a
bottleneck net cut to (2, 1, 1, 1) blocks at stem width 16, 32x32, batch 2;
the engines' ``int8`` and ``pallas`` ``classify`` on a basic net cut to
(1, 1, 1, 1) blocks at stem width 16; the ``pallas_block`` engine built and
run; and ``fused_forward_int8_chain`` with
``BASIC_DS_INT8=False`` on ResNet-18 ((2, 2, 2, 2) blocks), with its stage
taps.  One BN-folded tree (the port's seeded init, folded) goes to both
frameworks; the JAX Pallas kernels run with ``interpret=True``, the port's
on CPU tensors (their plain versions).

Tolerances as in ``tests/test_torch_serve.py``: every convolution sums in
another order than XLA's.  FP32 logits are held to a relative max error of
1e-4 (measured: ~1e-6 for ``pallas``, 0 for the chain) and stage taps to a
mean error of 1e-3 of their mean magnitude; under BF16 (XLA keeps excess
precision across bf16 roundings) 5e-2 for both (measured: ~7e-3 for
``pallas``), with equal argmax in every case.
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnetc_tpu import serve as jserve
from resnetc_tpu.models import resnet as jresnet
from resnetc_tpu.ops.pallas import fused as jfused
from resnetc_tpu.tensor import BF16 as JBF16
from resnetc_tpu.tensor import FP32 as JFP32
from resnetc_tpu_torch import serve as tserve
from resnetc_tpu_torch.models import resnet as tresnet
from resnetc_tpu_torch.ops.cuda import fused as tfused
from resnetc_tpu_torch.tensor import BF16, FP32

POLICIES = {"fp32": (JFP32, FP32), "bf16": (JBF16, BF16)}
CUT_BOTTLENECK = dict(name="cut_bottleneck", block="bottleneck", stage_blocks=(2, 1, 1, 1),
                      num_classes=11, stem_width=16)
CUT_BASIC = dict(name="cut_basic", block="basic", stage_blocks=(1, 1, 1, 1), num_classes=10,
                 stem_width=16)


def _configs(name):
    if name == "resnet18":
        return jresnet.get_config(name, num_classes=10), tresnet.get_config(name, num_classes=10)
    cut = {"bottleneck": CUT_BOTTLENECK, "basic": CUT_BASIC}[name]
    return jresnet.ResNetConfig(**cut), tresnet.ResNetConfig(**cut)


def _to_jax(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


@pytest.fixture(scope="module")
def models():
    """Per config: (jcfg, tcfg, port variables, port folded tree, the folded
    tree in JAX)."""
    out = {}
    for i, name in enumerate(("resnet18", "bottleneck", "basic")):
        jcfg, tcfg = _configs(name)
        tvars = tresnet.init(tcfg, torch.Generator().manual_seed(i))
        tfold = tresnet.fold_inference_params(tcfg, tvars)
        out[name] = (jcfg, tcfg, tvars, tfold, _to_jax(tfold))
    return out


def _x(seed, size):
    return np.random.default_rng(seed).standard_normal((2, size, size, 3)).astype(np.float32)


def _rel_max(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _check_logits(got, want, policy):
    got = got.float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    tol = 1e-4 if policy == "fp32" else 5e-2
    assert _rel_max(got, want) < tol, _rel_max(got, want)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _counting(kernels, counts):
    def spy(name, fn):
        def call(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)

        return call

    return kernels._replace(**{f: spy(f, getattr(kernels, f)) for f in kernels._fields})


@pytest.mark.parametrize(
    "name,policy", [("resnet18", "fp32"), ("bottleneck", "fp32"), ("bottleneck", "bf16")]
)
def test_fused_forward_matches_jax(models, name, policy):
    jcfg, tcfg, _, tfold, jfold = models[name]
    jpol, tpol = POLICIES[policy]
    x = _x(1, 32)
    want = np.asarray(
        jfused.fused_forward(jcfg, jfold, jnp.asarray(x), policy=jpol, interpret=True), np.float32
    )
    counts: dict = {}
    got = tfused.fused_forward(tcfg, tfold, torch.from_numpy(x), policy=tpol,
                               kernels=_counting(tfused.KERNELS, counts))
    assert got.dtype == tpol.output
    n3 = sum(tcfg.stage_blocks) * (2 if tcfg.block == "basic" else 1)
    n1 = 3 + (sum(tcfg.stage_blocks) * 2 + 1 if tcfg.block == "bottleneck" else 0)
    assert counts == {"max_pool": 1, "conv_s2": 3, "conv3x3_s1": n3 - 3, "matmul": n1 + 1}, counts
    _check_logits(got, want, policy)


@pytest.mark.parametrize("backend", ["int8", "pallas"])
def test_engine_classify_matches_jax_engine(models, backend):
    jcfg, tcfg, tvars, _, _ = models["basic"]
    x = _x(2, 32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the pallas backend's deprecation notice
        jeng = jserve.InferenceEngine(jcfg, _to_jax(tvars), policy=JFP32, backend=backend)
    if backend == "pallas":
        with pytest.warns(UserWarning, match="reference path"):
            teng = tserve.InferenceEngine(tcfg, tvars, policy=FP32, backend=backend,
                                          device="cpu")
    else:
        teng = tserve.InferenceEngine(tcfg, tvars, policy=FP32, backend=backend, device="cpu")
        assert teng.folded["fc"]["w_q"].dtype == torch.int8
    np.testing.assert_array_equal(teng.classify(x), jeng.classify(jnp.asarray(x)))
    _check_logits(teng.logits(x), np.asarray(jeng.logits(jnp.asarray(x))), "fp32")


def test_unported_block_fusion_raises(models):
    """``pallas_block`` raised until kernel row 17 was ported: it now builds
    and serves (``tests/test_torch_fp_block.py`` holds it against JAX).
    What the port does not serve still raises: the JAX name ``xla`` and
    grouped configs on a kernel backend."""
    _, tcfg, tvars, tfold, _ = models["bottleneck"]
    x = _x(3, 32)
    with pytest.warns(UserWarning, match="reference path"):
        eng = tserve.InferenceEngine(tcfg, tvars, backend="pallas_block", device="cpu")
    assert eng.classify(x).shape == (2,)
    counts: dict = {}
    logits = tfused.fused_forward(tcfg, tfold, torch.from_numpy(x), block_fusion=True,
                                  kernels=_counting(tfused.KERNELS, counts))
    assert counts["fp_block"] == 1 and torch.equal(logits, eng.logits(x))
    with pytest.raises(ValueError, match="backend must be one of"):
        tserve.InferenceEngine(tcfg, tvars, backend="xla", device="cpu")
    grouped = tresnet.get_config("resnext50_32x4d")
    with pytest.raises(ValueError, match="grouped"):
        tserve.InferenceEngine(grouped, {}, backend="int8", device="cpu")


@pytest.mark.parametrize("policy", list(POLICIES))
def test_basic_ds_int8_off_route_matches_jax(models, policy, monkeypatch):
    """The JAX code default: each stride-2 transition dequantized, run
    through the conv kernels and requantized between the int8 chains."""
    jcfg, tcfg, _, tfold, jfold = models["resnet18"]
    jpol, tpol = POLICIES[policy]
    monkeypatch.setattr(jfused, "BASIC_DS_INT8", False)
    monkeypatch.setattr(tfused, "BASIC_DS_INT8", False)
    x = _x(4, 32)
    # One quantized tree and one set of scales in both frameworks (their
    # parity is pinned in tests/test_torch_basic.py).
    tq = tfused.quantize_chain(tcfg, tfold)
    tscales = tfused.calibrate_chain_scales(tcfg, tfold, torch.from_numpy(x), policy=tpol)
    jtaps: list = []
    want = np.asarray(
        jfused.fused_forward_int8_chain(jcfg, _to_jax(tq), _to_jax(tscales), jnp.asarray(x),
                                        policy=jpol, interpret=True, stage_taps=jtaps),
        np.float32,
    )
    ttaps: list = []
    counts: dict = {}
    got = tfused.fused_forward_int8_chain(
        tcfg, tq, tscales, torch.from_numpy(x), policy=tpol, stage_taps=ttaps,
        kernels=_counting(tfused.KERNELS, counts),
    )
    assert counts == {"stem_pool": 1, "basic_run": 1, "conv_s2": 3, "conv3x3_s1": 3,
                      "matmul": 4, "basic_block": 3}, counts
    _check_logits(got, want, policy)
    tap_tol = 1e-3 if policy == "fp32" else 5e-2
    assert len(ttaps) == len(jtaps) == 4
    for stage, (gt, wt) in enumerate(zip(ttaps, jtaps)):
        gt, wt = gt.numpy(), np.asarray(wt)
        assert gt.shape == wt.shape, stage
        assert np.mean(np.abs(gt - wt)) <= tap_tol * np.mean(np.abs(wt)), stage
