"""The port's ``int8`` backend vs the JAX package's.

Kernel: the plain version of ``int8_matmul`` against the Pallas kernel run
with ``interpret=True``, on int8 operands from a seeded numpy generator,
with and without bias, residual and relu, fp32 and bf16 out: EQUAL, since
the int32 dot is exact and the epilogue keeps XLA's roundings (``scale =
sx * sw`` on its own, ``acc * scale + bias`` one fused multiply-add).  The
helpers ``quantize_per_tensor`` and ``quantize_folded`` must give JAX's
values bit for bit.

A NaN in the residual (and a -Inf) comes out as JAX's kernel gives it:
NaN where it does (its relu is ``jnp.maximum(v, 0)``), the rest equal.

The (N, K) weight copies that ``pack_kmajor`` adds for the int8 kernel
change no value: the plain version given them equals the Pallas kernel, and
both int8 forwards on a packed tree equal the same forwards on
``quantize_folded``'s tree bit for bit.

End to end: ``fused_forward_int8``, ``calibrate_activation_scales`` and
``fused_forward_int8_static`` on ResNet-18 (10 classes) and a bottleneck
net cut to (2, 1, 1, 1) blocks at stem width 16, 32x32, batch 2, the same
batch in both frameworks (the dynamic scale is an absmax over the whole
batch), one BN-folded tree (the port's seeded init, folded) in both.  Tolerances as in
``tests/test_torch_serve.py``: the 3x3 and stem convolutions sum in
another order, so an activation on a rounding boundary of a quantizer may
land one step apart.  FP32 logits are held to a relative max error of 1e-4
(measured: at most 2e-7 for the dynamic path, 0 for the static one); BF16
to 5e-2 (measured: up to 2e-2, XLA keeping excess precision across bf16
roundings), with equal argmax in every case.  Calibration scales to rtol
1e-5 (measured: 8e-7).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnetc_tpu.models import resnet as jresnet
from resnetc_tpu.ops.pallas import fused as jfused
from resnetc_tpu.ops.pallas import quant as jquant
from resnetc_tpu.tensor import BF16 as JBF16
from resnetc_tpu.tensor import FP32 as JFP32
from resnetc_tpu_torch.checkpoint import variables_from_jax_numpy
from resnetc_tpu_torch.models import resnet as tresnet
from resnetc_tpu_torch.ops.cuda import fused as tfused
from resnetc_tpu_torch.ops.cuda import quant as tquant
from resnetc_tpu_torch.tensor import BF16, FP32

POLICIES = {"fp32": (JFP32, FP32), "bf16": (JBF16, BF16)}
OUT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _rel_max(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


# ---------------------------------------------------------------------------
# Helpers and the kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["normal", "bf16", "zeros"])
def test_quantize_per_tensor_equals_jax(rng, kind):
    x = (rng.standard_normal((2, 5, 7, 24)) * 3).astype(np.float32)
    if kind == "zeros":
        x = np.zeros_like(x)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if kind == "bf16" else jnp.float32)
    tx = torch.from_numpy(_np(jx).copy()).to(torch.bfloat16 if kind == "bf16" else torch.float32)
    jq, js = jquant.quantize_per_tensor(jx)
    tq, ts = tquant.quantize_per_tensor(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.ndim == 0
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    if kind == "zeros":
        assert float(ts) == 1.0
    else:
        assert int(tq.abs().max()) == 127


def _gemm_inputs(rng, m, k, n):
    x = rng.integers(-127, 128, size=(m, k), dtype=np.int8)
    w = rng.integers(-127, 128, size=(k, n), dtype=np.int8)
    sx = np.float32(0.0371)
    sw = (rng.random(n) * 2e-3 + 1e-4).astype(np.float32)
    bias = (rng.standard_normal(n) * 4).astype(np.float32)
    res = (rng.standard_normal((m, n)) * 4).astype(np.float32)
    return x, w, sx, sw, bias, res


# (id, m, k, n, bias, residual dtype or None, relu, out)
GEMM_CASES = [
    ("bias-res-relu-f32", 200, 256, 130, True, "f32", True, "f32"),
    ("bias-relu-bf16", 96, 520, 64, True, None, True, "bf16"),
    ("bias-bf16res-bf16", 64, 64, 72, True, "bf16", False, "bf16"),
    ("res-only-f32", 130, 132, 40, False, "f32", True, "f32"),
    ("plain-f32", 32, 2048, 100, False, None, False, "f32"),
    ("fc-bias-f32-oddk", 3, 130, 16, True, None, False, "f32"),
]


@pytest.mark.parametrize(
    "m,k,n,bias,res,relu,out", [c[1:] for c in GEMM_CASES], ids=[c[0] for c in GEMM_CASES]
)
def test_int8_matmul_plain_equals_pallas(rng, m, k, n, bias, res, relu, out):
    x, w, sx, sw, b, r = _gemm_inputs(rng, m, k, n)
    jr = tr = None
    if res is not None:
        jr = jnp.asarray(r).astype(OUT[res][0])
        tr = torch.from_numpy(_np(jr).copy()).to(OUT[res][1])
    want = jquant.int8_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(sx), jnp.asarray(sw),
        jnp.asarray(b) if bias else None, jr, relu=relu, out_dtype=OUT[out][0], interpret=True,
    )
    got = tquant.int8_matmul(
        torch.from_numpy(x), torch.from_numpy(w), torch.tensor(sx), torch.from_numpy(sw),
        torch.from_numpy(b) if bias else None, tr, relu=relu, out_dtype=OUT[out][1],
    )
    assert got.dtype == OUT[out][1] and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert len(np.unique(_np(got))) > 20  # not a degenerate case


@pytest.mark.parametrize(
    "m,k,n,bias,res,relu,out", [c[1:] for c in GEMM_CASES], ids=[c[0] for c in GEMM_CASES]
)
def test_int8_matmul_plain_on_kmajor_weight_equals_pallas(rng, m, k, n, bias, res, relu, out):
    """The plain version reading the (N, K) copy of the weight, which the
    card's kernel reads, equals the Pallas kernel on the (K, N) weight."""
    x, w, sx, sw, b, r = _gemm_inputs(rng, m, k, n)
    jr = tr = None
    if res is not None:
        jr = jnp.asarray(r).astype(OUT[res][0])
        tr = torch.from_numpy(_np(jr).copy()).to(OUT[res][1])
    want = jquant.int8_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(sx), jnp.asarray(sw),
        jnp.asarray(b) if bias else None, jr, relu=relu, out_dtype=OUT[out][0], interpret=True,
    )
    tw = torch.from_numpy(w)
    w_nk = tquant.pack_kmajor({"w_q": tw})["w_nk"]
    assert tuple(w_nk.shape) == (n, k) and w_nk.is_contiguous()
    got = tquant.int8_matmul_plain(
        torch.from_numpy(x), tw, torch.tensor(sx), torch.from_numpy(sw),
        torch.from_numpy(b) if bias else None, tr, relu=relu, out_dtype=OUT[out][1], w_nk=w_nk,
    )
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("res", ["f32", "bf16"])
def test_int8_matmul_nan_residual_as_pallas(rng, res):
    m, k, n = 24, 64, 40
    x = rng.integers(-127, 128, size=(m, k), dtype=np.int8)
    w = rng.integers(-127, 128, size=(k, n), dtype=np.int8)
    sw = (rng.random(n) * 2e-3 + 1e-4).astype(np.float32)
    b = (rng.standard_normal(n) * 4).astype(np.float32)
    r = (rng.standard_normal((m, n)) * 4).astype(np.float32)
    r[2], r[5, ::3] = np.nan, -np.inf
    jr = jnp.asarray(r).astype(OUT[res][0])
    tr = torch.from_numpy(np.array(_np(jr))).to(OUT[res][1])
    sx = np.float32(0.0371)
    want = jquant.int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.float32(sx), jnp.asarray(sw),
                              jnp.asarray(b), jr, relu=True, out_dtype=jnp.float32,
                              interpret=True)
    got = tquant.int8_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.tensor(sx),
                             torch.from_numpy(sw), torch.from_numpy(b), tr, relu=True,
                             out_dtype=torch.float32)
    g, wt = _np(got), _np(want)
    assert np.isnan(wt[2]).all() and not np.isnan(wt[5]).any()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(wt))
    np.testing.assert_array_equal(g[~np.isnan(wt)], wt[~np.isnan(wt)])


def test_int8_matmul_rejects_a_weight_copy_of_another_shape(rng):
    x, w, sx, sw, *_ = _gemm_inputs(rng, 8, 64, 24)
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.tensor(sx), torch.from_numpy(sw))
    with pytest.raises(ValueError, match="w_nk"):
        tquant.int8_matmul(*args, w_nk=torch.from_numpy(w))  # (K, N), not (N, K)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "residual-only"])
def test_int8_epilogue_is_one_fma(rng, bias):
    """The Pallas epilogue as XLA evaluates it rounds ``acc * scale +
    bias`` (or ``+ residual`` without a bias) once; rounding the product on
    its own gives other fp32 values, so the plain version's equality above
    pins the fused multiply-add."""
    m, k, n = 256, 512, 128
    x, w, sx, sw, b, r = _gemm_inputs(rng, m, k, n)
    tb = torch.from_numpy(b) if bias else None
    tr = None if bias else torch.from_numpy(r)
    want = jquant.int8_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(sx), jnp.asarray(sw),
        jnp.asarray(b) if bias else None, None if bias else jnp.asarray(r),
        out_dtype=jnp.float32, interpret=True,
    )
    got = tquant.int8_matmul_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.tensor(sx), torch.from_numpy(sw),
        tb, tr, out_dtype=torch.float32,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    acc = tquant._idot(torch.from_numpy(x), torch.from_numpy(w)).float()
    scale = torch.tensor(sx) * torch.from_numpy(sw)
    unfused = acc * scale + (tb if bias else tr)
    assert (unfused.numpy() != np.asarray(want)).mean() > 0.05


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------

CONFIGS = ("resnet18", "bottleneck")


def _configs(name):
    if name == "resnet18":
        return jresnet.get_config("resnet18", num_classes=10), tresnet.get_config(
            "resnet18", num_classes=10)
    cut = dict(name="cut_bottleneck", block="bottleneck", stage_blocks=(2, 1, 1, 1),
               num_classes=11, stem_width=16)
    return jresnet.ResNetConfig(**cut), tresnet.ResNetConfig(**cut)


@pytest.fixture(scope="module")
def models():
    """Per config: (jcfg, tcfg, JAX folded tree, the same in the port, x,
    each framework's quantize_folded tree)."""
    out = {}
    for i, name in enumerate(CONFIGS):
        jcfg, tcfg = _configs(name)
        tfold = tresnet.fold_inference_params(
            tcfg, tresnet.init(tcfg, torch.Generator().manual_seed(i)))
        jfold = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tfold)
        x = np.random.default_rng(10 + i).standard_normal((2, 32, 32, 3)).astype(np.float32)
        out[name] = (jcfg, tcfg, jfold, tfold, x, jquant.quantize_folded(jfold),
                     tquant.quantize_folded(tfold))
    return out


def test_quantize_folded_equals_jax(models):
    *_, jq, tq = models["resnet18"]
    jflat, tflat = _flat(jq), _flat(tq)
    assert set(jflat) == set(tflat)
    for k, v in jflat.items():
        t = tflat[k]
        np.testing.assert_array_equal(_np(t), np.asarray(v), err_msg=k)
        assert t.dtype == (torch.int8 if v.dtype == jnp.int8 else torch.float32), k
        assert t.is_contiguous(), k
    # The 1x1 projections and the fc are int8; the 3x3 / 7x7 stay fp.
    assert tflat["layer2.0.downsample.w_q"].shape == (64, 128)
    assert tflat["fc.w_q"].shape == (512, 10)
    assert tflat["layer2.0.conv1.weight"].dtype == torch.float32
    assert "conv1.weight" in tflat


def test_pack_kmajor_adds_the_transposed_copies_only(models):
    *_, tq = models["bottleneck"]
    packed = tquant.pack_kmajor(tq)
    flat, pflat = _flat(tq), _flat(packed)
    copies = {k for k in pflat if k.endswith(".w_nk")}
    assert copies == {k[: -len("w_q")] + "w_nk" for k in flat if k.endswith(".w_q")}
    assert "fc.w_nk" in copies and "layer1.0.downsample.w_nk" in copies
    assert set(pflat) - copies == set(flat)
    for k, v in flat.items():
        assert pflat[k] is v, k  # shared, not copied
    for k in copies:
        w_q = pflat[k[: -len("w_nk")] + "w_q"]
        assert pflat[k].is_contiguous() and torch.equal(pflat[k], w_q.t()), k
    assert "w_nk" not in _flat(tquant.quantize_folded(models["bottleneck"][3]))


def _check_logits(got, want, policy, n_classes):
    got = got.float().numpy()
    assert got.shape == (2, n_classes) and np.isfinite(got).all()
    tol = 1e-4 if policy == "fp32" else 5e-2
    assert _rel_max(got, want) < tol, _rel_max(got, want)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


#: JAX's logits per (config, policy, forward), computed once per module:
#: the forwards on the packed trees are held to the same reference.
_JAX_LOGITS: dict = {}


def _jax_logits(models, name, policy, forward):
    key = (name, policy, forward)
    if key not in _JAX_LOGITS:
        jcfg, _, jfold, _, x, jq, _ = models[name]
        jpol = POLICIES[policy][0]
        if forward == "dynamic":
            out = jfused.fused_forward_int8(jcfg, jq, jnp.asarray(x), policy=jpol, interpret=True)
        else:
            jscales = jfused.calibrate_activation_scales(jcfg, jfold, jnp.asarray(x), policy=jpol)
            out = jfused.fused_forward_int8_static(jcfg, jq, jscales, jnp.asarray(x),
                                                   policy=jpol, interpret=True)
        _JAX_LOGITS[key] = np.asarray(out, np.float32)
    return _JAX_LOGITS[key]


def _port_int8_forward(models, name, policy, forward, tree):
    jcfg, tcfg, jfold, _, x, _, _ = models[name]
    jpol, tpol = POLICIES[policy]
    if forward == "dynamic":
        return tfused.fused_forward_int8(tcfg, tree, torch.from_numpy(x), policy=tpol)
    jscales = jfused.calibrate_activation_scales(jcfg, jfold, jnp.asarray(x), policy=jpol)
    tscales = variables_from_jax_numpy(jax.tree.map(np.asarray, jscales))
    return tfused.fused_forward_int8_static(tcfg, tree, tscales, torch.from_numpy(x),
                                            policy=tpol)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("name", CONFIGS)
def test_fused_forward_int8_matches_jax(models, name, policy):
    jcfg, tcfg, _, _, x, jq, tq = models[name]
    jpol, tpol = POLICIES[policy]
    want = _jax_logits(models, name, policy, "dynamic")
    got = tfused.fused_forward_int8(tcfg, tq, torch.from_numpy(x), policy=tpol)
    assert got.dtype == tpol.output
    _check_logits(got, want, policy, jcfg.num_classes)


@pytest.mark.parametrize("forward", ["dynamic", "static"])
@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("name", CONFIGS)
def test_int8_forwards_on_packed_tree_equal_unpacked(models, name, policy, forward):
    """The engine's tree (``pack_kmajor`` over ``quantize_folded``) gives the
    logits of the unpacked tree bit for bit, within the JAX bounds."""
    tq = models[name][-1]
    got = _port_int8_forward(models, name, policy, forward, tquant.pack_kmajor(tq))
    want = _port_int8_forward(models, name, policy, forward, tq)
    assert torch.equal(got, want)
    _check_logits(got, _jax_logits(models, name, policy, forward), policy,
                  models[name][0].num_classes)


def test_calibrate_activation_scales_matches_jax(models):
    for name in CONFIGS:
        jcfg, tcfg, jfold, tfold, x, _, _ = models[name]
        want = _flat(jax.tree.map(
            np.asarray, jfused.calibrate_activation_scales(jcfg, jfold, jnp.asarray(x),
                                                           policy=JFP32)))
        got = _flat(tfused.calibrate_activation_scales(tcfg, tfold, torch.from_numpy(x),
                                                       policy=FP32))
        assert set(got) == set(want)
        sites = {k.rsplit(".", 1)[-1] for k in got}
        assert sites == ({"downsample", "fc"} if name == "resnet18"
                         else {"downsample", "conv1", "conv3", "fc"}), sites
        for k, v in want.items():
            assert got[k].ndim == 0 and got[k].dtype == torch.float32
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, err_msg=f"{name} {k}")


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("name", CONFIGS)
def test_fused_forward_int8_static_matches_jax(models, name, policy):
    jcfg, tcfg, jfold, _, x, jq, tq = models[name]
    jpol, tpol = POLICIES[policy]
    jscales = jfused.calibrate_activation_scales(jcfg, jfold, jnp.asarray(x), policy=jpol)
    want = _jax_logits(models, name, policy, "static")
    tscales = variables_from_jax_numpy(jax.tree.map(np.asarray, jscales))
    got = tfused.fused_forward_int8_static(tcfg, tq, tscales, torch.from_numpy(x), policy=tpol)
    _check_logits(got, want, policy, jcfg.num_classes)
