"""The int8_chain engine's last two options vs the JAX package's: per-channel
interior calibration with its bake, and the HYBRID_XLA_STAGES prefix.

Tiny configs (3,2,2,2 blocks, stem width 16, 11 classes), bottleneck and
basic, at 64x64, batch 2.  The JAX side folds; its folded tree and its
scales are carried across (``variables_from_jax_numpy``: the two BN folds
differ in the last ulp), so each port function sees JAX's inputs.  The
Pallas kernels run with ``interpret=True``, the port's on CPU tensors (their
plain versions), all under FP32.

Tolerances.
- Per-channel scales: relative 1e-5, and absolute 1e-5 of the site's
  largest scale.  The fp32 activations differ by summation order only, so
  a statistic's error is a few ulps of the site's magnitude; a channel
  thousands of times quieter than its site (measured: 3e-5 against a
  largest 0.18, one part in 1e3 apart) carries that absolute error.  "in"
  as ``tests/test_torch_serve.py`` holds it (1e-5; 1e-3 for the sampled
  statistics).
- The baked tree: int8 leaves equal, float leaves within rtol 1e-6 (both
  packages do the same fp32 products and quotients), the restored fp
  entries equal to the un-scaled folded ones.
- Forwards: logits within 1e-4 of max |logit|, stage taps a mean error of
  1e-3 of their mean magnitude (``tests/test_torch_serve.py``).  Under
  HYBRID_XLA_STAGES a whole float stage runs before the chain's first
  quantization, so the two frameworks' summation orders put a few values on
  either side of an int8 rounding boundary (measured: 2 of 32,768 after
  stage 0, logits then 1.2e-2 apart, taps up to 2.5e-2).  The prefix's
  stages are therefore held to 1e-5 on their own, and the chain to the
  tolerances above from the same prefix activations (the port's prefix
  stage replaced by JAX's output); the whole hybrid forward as it runs is
  held to the BF16 bound of ``tests/test_torch_serve.py``, 5e-2 with equal
  argmax.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnetc_tpu import serve as jserve
from resnetc_tpu.models import resnet as jresnet
from resnetc_tpu.ops.pallas import fused as jfused
from resnetc_tpu.tensor import FP32 as JFP32
from resnetc_tpu_torch import serve as tserve
from resnetc_tpu_torch.checkpoint import variables_from_jax_numpy
from resnetc_tpu_torch.models import resnet as tresnet
from resnetc_tpu_torch.ops.cuda import fused as tfused
from resnetc_tpu_torch.tensor import FP32

TINY = dict(name="tiny", block="bottleneck", stage_blocks=(3, 2, 2, 2), num_classes=11,
            stem_width=16)


def _carry(tree):
    return variables_from_jax_numpy(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def nets():
    x = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(np.float32)
    out = {}
    for family in ("bottleneck", "basic"):
        spec = {**TINY, "block": family}
        jcfg, tcfg = jresnet.ResNetConfig(**spec), tresnet.ResNetConfig(**spec)
        jvars = jresnet.init(jcfg, jax.random.key(7))
        jfold = jresnet.fold_inference_params(jcfg, jvars)
        out[family] = dict(jcfg=jcfg, tcfg=tcfg, jvars=jvars, jfold=jfold, tfold=_carry(jfold),
                           x=x)
    return out


def _scales(net, **kw):
    """JAX's per-channel scales (FP32) and their port copy."""
    js = jfused.calibrate_chain_scales(net["jcfg"], net["jfold"], jnp.asarray(net["x"]),
                                       policy=JFP32, per_channel_interior=True, **kw)
    return js, _carry(js)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _rel_max(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _tap_err(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    return float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))


@pytest.mark.parametrize("method", ["absmax", "percentile", "mse"])
@pytest.mark.parametrize("family", ["bottleneck", "basic"])
def test_per_channel_scales_match_jax(nets, family, method):
    net = nets[family]
    want, _ = _scales(net, method=method)
    got = tfused.calibrate_chain_scales(net["tcfg"], net["tfold"], torch.from_numpy(net["x"]),
                                        policy=FP32, method=method, per_channel_interior=True)
    interior = ("z1", "z2") if family == "bottleneck" else ("z1",)
    for layer, blocks in want.items():
        for b, sites in blocks.items():
            assert set(got[layer][b]) == {"in", *interior}
            for k, v in sites.items():
                w, g = np.asarray(v), got[layer][b][k].numpy()
                msg = f"{layer}.{b}.{k}"
                if k == "in":
                    assert g.shape == ()
                    rtol = 1e-5 if method == "absmax" else 1e-3
                    np.testing.assert_allclose(g, w, rtol=rtol, err_msg=msg)
                else:
                    assert g.shape == w.shape == (w.size,) and w.size > 1, msg
                    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * w.max(), err_msg=msg)


@pytest.mark.parametrize("family", ["bottleneck", "basic"])
def test_bake_matches_jax(nets, family):
    net = nets[family]
    js, ts = _scales(net)
    jq, jrt = jfused.bake_interior_scales(net["jcfg"], net["jfold"], js)
    tq, trt = tfused.bake_interior_scales(net["tcfg"], net["tfold"], ts)
    jflat, tflat = _flat(jq), _flat(tq)
    assert set(tflat) == set(jflat)
    for k, t in tflat.items():
        w = np.asarray(jflat[k].astype(jnp.float32) if jflat[k].dtype == jnp.bfloat16
                       else jflat[k])
        if t.dtype == torch.int8:
            np.testing.assert_array_equal(t.numpy(), w, err_msg=k)
        else:
            np.testing.assert_allclose(t.float().numpy(), w, rtol=1e-6, err_msg=k)
    # The runtime scales: "in" as calibrated, 1 at the baked sites.
    for layer, blocks in jrt.items():
        for b, sites in blocks.items():
            for k, v in sites.items():
                assert float(trt[layer][b][k]) == float(v), (layer, b, k)
                assert k == "in" or float(v) == 1.0
    # The fp entries kept beside the quantized ones are the un-scaled folded
    # ones (bf16 copies on bottleneck stages 0-1, the basic transitions' fp32).
    kept = 0
    for layer, blocks in tq.items():
        if not layer.startswith("layer"):
            continue
        for b, q in blocks.items():
            for key in ("conv1", "conv2", "conv3", "downsample"):
                if key not in q:
                    continue
                orig = net["tfold"][layer][b][key]["weight"]
                want = orig.to(torch.bfloat16) if family == "bottleneck" else orig
                assert torch.equal(q[key]["weight"], want), (layer, b, key)
                kept += 1
    assert kept == ((4 + 3 + 3) + (4 + 3) if family == "bottleneck" else 3 * 3)


@pytest.mark.parametrize("family,ds_int8", [("bottleneck", False), ("basic", True),
                                            ("basic", False)],
                         ids=["bottleneck", "basic-ds-int8", "basic-ds-conv"])
def test_baked_forward_matches_jax(nets, monkeypatch, family, ds_int8):
    net = nets[family]
    monkeypatch.setattr(jfused, "BASIC_DS_INT8", ds_int8)
    monkeypatch.setattr(tfused, "BASIC_DS_INT8", ds_int8)
    js, ts = _scales(net)
    jq, jrt = jfused.bake_interior_scales(net["jcfg"], net["jfold"], js)
    tq, trt = tfused.bake_interior_scales(net["tcfg"], net["tfold"], ts)
    jtaps, ttaps = [], []
    want = np.asarray(jfused.fused_forward_int8_chain(
        net["jcfg"], jq, jrt, jnp.asarray(net["x"]), policy=JFP32, interpret=True,
        stage_taps=jtaps), np.float32)
    got = tfused.fused_forward_int8_chain(
        net["tcfg"], tfused.pack_chain_kmajor(net["tcfg"], tq), trt,
        torch.from_numpy(net["x"]), policy=FP32, stage_taps=ttaps).numpy()
    assert got.shape == (2, 11) and np.isfinite(got).all()
    assert _rel_max(got, want) < 1e-4, _rel_max(got, want)
    assert len(ttaps) == len(jtaps) == 4
    for stage, (g, w) in enumerate(zip(ttaps, jtaps)):
        assert _tap_err(g, w) <= 1e-3, stage


HYBRID = [((0,), False), ((0, 1), False), ((0,), True)]


@pytest.mark.parametrize("stages,bake", HYBRID, ids=["0", "0-1", "0-baked"])
def test_hybrid_forward_matches_jax(nets, monkeypatch, stages, bake):
    net = nets["bottleneck"]
    jcfg, tcfg, x = net["jcfg"], net["tcfg"], net["x"]
    if bake:
        js, ts = _scales(net)
        jq, jscales = jfused.bake_interior_scales(jcfg, net["jfold"], js)
        tq, tscales = tfused.bake_interior_scales(tcfg, net["tfold"], ts)
    else:
        jscales = jfused.calibrate_chain_scales(jcfg, net["jfold"], jnp.asarray(x), policy=JFP32)
        jq, tq = jfused.quantize_chain(jcfg, net["jfold"]), tfused.quantize_chain(tcfg, net["tfold"])
        tscales = _carry(jscales)
    tq = tfused.pack_chain_kmajor(tcfg, tq)
    monkeypatch.setattr(jfused, "HYBRID_XLA_STAGES", stages)
    monkeypatch.setattr(tfused, "HYBRID_XLA_STAGES", stages)
    jtaps: list = []
    want = np.asarray(jfused.fused_forward_int8_chain(
        jcfg, jq, jscales, jnp.asarray(x), policy=JFP32, interpret=True, stage_taps=jtaps),
        np.float32)
    assert len(jtaps) == 4

    def run():
        taps: list = []
        logits = tfused.fused_forward_int8_chain(tcfg, tq, tscales, torch.from_numpy(x),
                                                 policy=FP32, stage_taps=taps).numpy()
        assert logits.shape == (2, 11) and np.isfinite(logits).all() and len(taps) == 4
        return logits, taps

    # As it runs: the prefix's stages within fp32 summation order of JAX's,
    # the rest within the BF16 bound (a few int8 boundary values apart).
    got, taps = run()
    for stage in stages:
        assert _tap_err(taps[stage], jtaps[stage]) <= 1e-5, stage
    assert _rel_max(got, want) < 5e-2, _rel_max(got, want)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    for stage in range(len(stages), 4):
        assert _tap_err(taps[stage], jtaps[stage]) <= 5e-2, stage

    # From JAX's prefix activations, the chain and the head as the plain
    # int8_chain forward is held (the port's own prefix stage still runs).
    real_stage = tfused._xla_bottleneck_stage
    served = []

    def pinned(y, blocks, nb, *, stride, policy):
        mine = real_stage(y, blocks, nb, stride=stride, policy=policy)
        out = torch.from_numpy(np.array(jtaps[len(served)], np.float32)).to(mine.dtype)
        assert _tap_err(mine.float(), out) <= 1e-5
        served.append(out)
        return out

    monkeypatch.setattr(tfused, "_xla_bottleneck_stage", pinned)
    got, taps = run()
    assert len(served) == len(stages)
    assert _rel_max(got, want) < 1e-4, _rel_max(got, want)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    for stage, (g, w) in enumerate(zip(taps, jtaps)):
        assert _tap_err(g, w) <= 1e-3, stage


@pytest.mark.parametrize("stages,match", [((1,), "contiguous prefix"),
                                          ((0, 2), "contiguous prefix"),
                                          ((0, 1, 2), "fp entries")])
def test_hybrid_rejects_bad_stage_sets(nets, monkeypatch, stages, match):
    net = nets["bottleneck"]
    scales = tfused.calibrate_chain_scales(net["tcfg"], net["tfold"], torch.from_numpy(net["x"]))
    monkeypatch.setattr(jfused, "HYBRID_XLA_STAGES", stages)
    monkeypatch.setattr(tfused, "HYBRID_XLA_STAGES", stages)
    with pytest.raises(ValueError, match=match):
        jfused.fused_forward_int8_chain(
            net["jcfg"], jfused.quantize_chain(net["jcfg"], net["jfold"]),
            jax.tree.map(lambda t: t.numpy(), scales), jnp.asarray(net["x"]), interpret=True)
    with pytest.raises(ValueError, match=match):
        tfused.fused_forward_int8_chain(net["tcfg"], tfused.quantize_chain(net["tcfg"], net["tfold"]),
                                        scales, torch.from_numpy(net["x"]))


@pytest.mark.parametrize("family", ["bottleneck", "basic"])
def test_engine_calib_per_channel_matches_jax_engine(nets, family):
    net = nets[family]
    x = net["x"]
    jeng = jserve.InferenceEngine(net["jcfg"], net["jvars"], policy=JFP32, backend="int8_chain",
                                  calib_batch=jnp.asarray(x), calib_per_channel=True)
    teng = tserve.InferenceEngine(net["tcfg"], _carry(net["jvars"]), policy=FP32,
                                  backend="int8_chain", calib_batch=x, calib_per_channel=True,
                                  device="cpu")
    # The bake ran: unit runtime scales at the interior sites.
    for blocks in teng.chain_scales.values():
        for sites in blocks.values():
            assert all(float(v) == 1.0 for k, v in sites.items() if k != "in")
    want = np.asarray(jeng.logits(jnp.asarray(x)), np.float32)
    got = teng.logits(x).numpy()
    assert _rel_max(got, want) < 5e-2, _rel_max(got, want)
    np.testing.assert_array_equal(teng.classify(x), jeng.classify(jnp.asarray(x)))
