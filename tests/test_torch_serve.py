"""The port's int8_chain serving path vs the JAX package's, end to end.

A tiny bottleneck config (3,2,2,2 blocks, stem width 16, 11 classes) at
64x64, batch 2, so the path goes through the stage-0 run kernel, the
projection block, identity blocks, the three stride-2 transitions and the
head fold.  JAX's parameters and calibration scales are carried across
(``variables_from_jax_numpy``); the JAX Pallas kernels run with
``interpret=True`` and the port's on CPU tensors (their plain versions).

Tolerances.  The stem is a float convolution in both frameworks, summed in
another order, so a stem value on a rounding boundary of the int8 quantizer
may land one step apart; from there the int8 chain is exact.  Under FP32
(measured: identical taps, logits 4e-7 apart) logits are held to a
relative max error of 1e-4 and per-stage taps to a mean error of 1e-3 of
their mean magnitude.  Under BF16, XLA keeps excess precision across the
stem's bf16 roundings where PyTorch rounds each op, so quantized values
drift apart stage by stage (measured: taps 0.03% .. 1.4%, logits 0.9%);
the bound there is 5e-2 for both, with equal argmax in every case.

The engine's K-major weight copies (``pack_chain_kmajor``, what the int8
tensor-core block kernels read) are added beside ``quantize_chain``'s tree,
which stays equal to JAX's; the forward on the packed tree equals the
forward on the unpacked one bit for bit.
"""

from __future__ import annotations

import subprocess
import sys
import textwrap

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
from resnetc_tpu_torch.checkpoint import variables_from_jax_numpy
from resnetc_tpu_torch.models import resnet as tresnet
from resnetc_tpu_torch.ops.cuda import fused as tfused
from resnetc_tpu_torch.tensor import BF16, FP32

TINY = dict(name="tiny", block="bottleneck", stage_blocks=(3, 2, 2, 2), num_classes=11,
            stem_width=16)


@pytest.fixture(scope="module")
def setup():
    jcfg = jresnet.ResNetConfig(**TINY)
    tcfg = tresnet.ResNetConfig(**TINY)
    jvars = jresnet.init(jcfg, jax.random.key(7))
    np_vars = jax.tree.map(np.asarray, jvars)
    x = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(np.float32)
    return jcfg, tcfg, jvars, variables_from_jax_numpy(np_vars), x


def _rel_max(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_int8_chain_forward_matches_jax(setup, policy):
    jcfg, tcfg, jvars, tvars, x = setup
    jpol, tpol = (JFP32, FP32) if policy == "fp32" else (JBF16, BF16)
    jfold = jresnet.fold_inference_params(jcfg, jvars)
    jscales = jfused.calibrate_chain_scales(jcfg, jfold, jnp.asarray(x), policy=jpol)
    jq = jfused.quantize_chain(jcfg, jfold)
    jtaps: list = []
    want = np.asarray(
        jfused.fused_forward_int8_chain(
            jcfg, jq, jscales, jnp.asarray(x), policy=jpol, interpret=True,
            stage_taps=jtaps,
        ),
        np.float32,
    )
    want_folded = np.asarray(
        jfused.fused_forward_int8_chain(
            jcfg, jq, jscales, jnp.asarray(x), policy=jpol, interpret=True
        ),
        np.float32,
    )

    tq = tfused.quantize_chain(tcfg, tresnet.fold_inference_params(tcfg, tvars))
    tscales = variables_from_jax_numpy(jax.tree.map(np.asarray, jscales))
    ttaps: list = []
    got = tfused.fused_forward_int8_chain(
        tcfg, tq, tscales, torch.from_numpy(x), policy=tpol, stage_taps=ttaps
    ).numpy()
    got_folded = tfused.fused_forward_int8_chain(
        tcfg, tq, tscales, torch.from_numpy(x), policy=tpol
    ).numpy()

    tol = 1e-4 if policy == "fp32" else 5e-2
    tap_tol = 1e-3 if policy == "fp32" else 5e-2
    for g, w in ((got, want), (got_folded, want_folded)):
        assert g.shape == (2, 11) and np.isfinite(g).all()
        assert _rel_max(g, w) < tol, _rel_max(g, w)
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
    assert len(ttaps) == len(jtaps) == 4
    for stage, (gt, wt) in enumerate(zip(ttaps, jtaps)):
        gt, wt = gt.numpy(), np.asarray(wt)
        assert gt.shape == wt.shape, stage
        assert np.mean(np.abs(gt - wt)) <= tap_tol * np.mean(np.abs(wt)), stage


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def test_engine_packs_kmajor_copies_beside_the_jax_tree(setup):
    jcfg, tcfg, jvars, tvars, x = setup
    jfold = jresnet.fold_inference_params(jcfg, jvars)
    tfold = variables_from_jax_numpy(jax.tree.map(np.asarray, jfold))
    jflat = _flat(jfused.quantize_chain(jcfg, jfold))
    tq = tfused.quantize_chain(tcfg, tfold)
    tflat = _flat(tq)
    # Every leaf of the port's tree is JAX's: the quantized ones, and on
    # stages 0-1 the bf16 copies of the folded fp entries (the hybrid
    # prefix's).
    assert set(tflat) <= set(jflat)
    assert all(k.split("/")[2].startswith(("conv", "downsample")) for k in set(jflat) - set(tflat))
    for k in tflat:
        np.testing.assert_array_equal(tflat[k].float().numpy(),
                                      np.asarray(jflat[k], np.float32), err_msg=k)
    packed = _flat(tfused.pack_chain_kmajor(tcfg, tq))
    added = set(packed) - set(tflat)
    assert set(tflat) <= set(packed)
    for k in tflat:
        assert packed[k] is tflat[k], k  # shared, not copied
    stride1 = {k.rsplit("/", 1)[0] for k in tflat if k.endswith("/w2pq")}
    transitions = {k.rsplit("/", 1)[0] for k in tflat if k.endswith("/w2q")}
    assert len(stride1) == sum(tcfg.stage_blocks) - 3 and len(transitions) == 3
    assert added == {f"{blk}/{k}_nk" for blk in stride1 for k in ("w1q", "w2pq", "w3q")
                     } | {f"{blk}/{k}_nk" for blk in transitions
                          for k in ("w1q", "w2q", "w3q", "wdq")} | {"layer1/0/wdq_nk"}
    for k in added:  # a transition's 3x3 as its (9c, c) matrix, rows (kh, kw, k)
        orig = tflat[k[: -len("_nk")]]
        assert packed[k].is_contiguous(), k
        assert torch.equal(packed[k], orig.reshape(-1, orig.shape[-1]).t()), k
    # The engine's tree is the packed one.
    teng = tserve.InferenceEngine(tcfg, tvars, backend="int8_chain", calib_batch=x,
                                  device="cpu")
    assert set(_flat(teng.folded)) == set(packed)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_int8_chain_forward_on_packed_tree_equals_unpacked(setup, policy):
    jcfg, tcfg, jvars, tvars, x = setup
    jpol, tpol = (JFP32, FP32) if policy == "fp32" else (JBF16, BF16)
    jfold = jresnet.fold_inference_params(jcfg, jvars)
    jscales = jfused.calibrate_chain_scales(jcfg, jfold, jnp.asarray(x), policy=jpol)
    jq = jfused.quantize_chain(jcfg, jfold)
    want = np.asarray(jfused.fused_forward_int8_chain(
        jcfg, jq, jscales, jnp.asarray(x), policy=jpol, interpret=True), np.float32)
    tq = variables_from_jax_numpy(jax.tree.map(np.asarray, jq))
    tscales = variables_from_jax_numpy(jax.tree.map(np.asarray, jscales))
    packed = tfused.pack_chain_kmajor(tcfg, tq)
    got = tfused.fused_forward_int8_chain(tcfg, packed, tscales, torch.from_numpy(x),
                                          policy=tpol)
    unpacked = tfused.fused_forward_int8_chain(tcfg, tq, tscales, torch.from_numpy(x),
                                               policy=tpol)
    assert torch.equal(got, unpacked)
    tol = 1e-4 if policy == "fp32" else 5e-2
    assert _rel_max(got.numpy(), want) < tol
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


def test_calibrate_chain_scales_matches_jax_fp32(setup):
    jcfg, tcfg, jvars, tvars, x = setup
    jfold = jresnet.fold_inference_params(jcfg, jvars)
    want = jfused.calibrate_chain_scales(jcfg, jfold, jnp.asarray(x), policy=JFP32)
    got = tfused.calibrate_chain_scales(
        tcfg, tresnet.fold_inference_params(tcfg, tvars), torch.from_numpy(x), policy=FP32
    )
    for layer, blocks in want.items():
        for b, sites in blocks.items():
            for k, v in sites.items():
                np.testing.assert_allclose(
                    float(got[layer][b][k]), float(v), rtol=1e-5, err_msg=f"{layer}.{b}.{k}"
                )


@pytest.mark.parametrize("method", ["percentile", "mse"])
def test_calibration_methods_close_to_jax(setup, method):
    """The robust methods on a sampled statistic: held to 1e-3 relative
    (interpolation and candidate-grid arithmetic differ in the last bits)."""
    jcfg, tcfg, jvars, tvars, x = setup
    jfold = jresnet.fold_inference_params(jcfg, jvars)
    want = jfused.calibrate_chain_scales(
        jcfg, jfold, jnp.asarray(x), policy=JFP32, method=method
    )
    got = tfused.calibrate_chain_scales(
        tcfg, tresnet.fold_inference_params(tcfg, tvars), torch.from_numpy(x),
        policy=FP32, method=method,
    )
    w = np.asarray(want["layer3"]["1"]["z1"])
    np.testing.assert_allclose(float(got["layer3"]["1"]["z1"]), w, rtol=1e-3)
    w = np.asarray(want["layer1"]["0"]["in"])
    np.testing.assert_allclose(float(got["layer1"]["0"]["in"]), w, rtol=1e-3)


def test_engine_classify_matches_jax_engine(setup):
    jcfg, tcfg, jvars, tvars, x = setup
    jeng = jserve.InferenceEngine(
        jcfg, jvars, policy=JFP32, backend="int8_chain", calib_batch=jnp.asarray(x)
    )
    teng = tserve.InferenceEngine(
        tcfg, tvars, policy=FP32, backend="int8_chain", calib_batch=x, device="cpu"
    )
    np.testing.assert_array_equal(teng.classify(x), jeng.classify(jnp.asarray(x)))
    fp = tserve.InferenceEngine(tcfg, tvars, policy=FP32, backend="fp", device="cpu")
    jfp = jserve.InferenceEngine(jcfg, jvars, policy=JFP32, backend="xla")
    np.testing.assert_allclose(
        fp.logits(x).numpy(), np.asarray(jfp.logits(jnp.asarray(x))), rtol=1e-4, atol=1e-4
    )


def test_unported_flags_raise(setup, monkeypatch):
    _, tcfg, _, tvars, x = setup
    tq = tfused.quantize_chain(tcfg, tresnet.fold_inference_params(tcfg, tvars))
    scales = tfused.calibrate_chain_scales(
        tcfg, tresnet.fold_inference_params(tcfg, tvars), torch.from_numpy(x)
    )
    # The XLA bf16 prefix is ported (its JAX parity is in
    # tests/test_torch_calib.py); a stage set that is not a prefix raises.
    with monkeypatch.context() as m:
        m.setattr(tfused, "HYBRID_XLA_STAGES", (1,))
        with pytest.raises(ValueError, match="contiguous prefix"):
            tfused.fused_forward_int8_chain(tcfg, tq, scales, torch.from_numpy(x))
    # The basic family's transitions without BASIC_DS_INT8 are ported: the
    # route runs (its JAX parity is in tests/test_torch_backends.py).
    basic = tresnet.ResNetConfig(**{**TINY, "name": "tiny_basic", "block": "basic"})
    bvars = tresnet.init(basic, torch.Generator().manual_seed(0))
    bfold = tresnet.fold_inference_params(basic, bvars)
    bscales = tfused.calibrate_chain_scales(basic, bfold, torch.from_numpy(x))
    with monkeypatch.context() as m:
        m.setattr(tfused, "BASIC_DS_INT8", False)
        logits = tfused.fused_forward_int8_chain(
            basic, tfused.quantize_chain(basic, bfold), bscales, torch.from_numpy(x)
        )
    assert logits.shape == (2, 11) and torch.isfinite(logits).all()


def test_entry_point_without_cuda_raises_instead_of_running_on_cpu(setup):
    _, tcfg, _, tvars, _ = setup
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: device=None rightly selects it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.InferenceEngine(tcfg, tvars, backend="fp")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.InferenceEngine(tcfg, tvars, backend="int8_chain", calib_batch=np.zeros((1, 32, 32, 3)))


def test_benchmarks_refuse_the_cpu(setup):
    _, tcfg, _, tvars, x = setup
    eng = tserve.InferenceEngine(tcfg, tvars, backend="fp", device="cpu")
    with pytest.raises(RuntimeError, match="card"):
        tserve.bench_throughput(eng, x, steps=1, warmup=0)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing every module of the port pulls in no jax* and no
    resnetc_tpu.* module (run in a fresh interpreter)."""
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import resnetc_tpu_torch
        for m in pkgutil.walk_packages(resnetc_tpu_torch.__path__, "resnetc_tpu_torch."):
            importlib.import_module(m.name)
        bad = sorted(n for n in sys.modules
                     if n == "jax" or n.startswith(("jax.", "jaxlib"))
                     or n == "resnetc_tpu" or n.startswith("resnetc_tpu."))
        assert not bad, bad
        print(len([n for n in sys.modules if n.startswith("resnetc_tpu_torch")]))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
