"""The split-fp32 tile's helpers, on the CPU: ``gemm.tf32_round`` /
``gemm.tf32_split`` (the plain versions of what ``csrc/tf32x3_tile.cuh``
makes of each operand value), ``gemm.pack_nk`` (the (N, K) weight copy the
fp32 kernels read) and ``fused.pack_f32_kmajor`` (the engine's copies).

Bounds.  ``hi = tf32(v)`` rounds to 11 significant bits, so ``|v - hi| <=
2^-11 |v|``; ``lo = tf32(v - hi)`` rounds that to 11 bits again, so ``|v -
hi - lo| <= 2^-22 |v|``.  The three products the tile sums, ``a_hi*b_hi +
a_hi*b_lo + a_lo*b_hi``, differ from ``a*b`` by the dropped ``a_lo*b_lo``
and the two parts' errors: at most ``3 * 2^-22 |a*b|`` (plus terms of
2^-44).  The design's sum (each 32-value span of K summed exactly, as
float64 stands in for the tensor cores here, rounded to fp32 and added in
fp32 in K order) is held to the GEMM's card tolerance against float64
(rtol 1e-5, atol 1e-4) at ResNet-152's longest sums.  A CPU engine's FP32
``pallas`` logits with the engine's copies are those of the same forward
without them, and within ``tests/test_torch_backends.py``'s 1e-4 of the
JAX package's (interpret mode).
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
from resnetc_tpu.tensor import FP32 as JFP32
from resnetc_tpu_torch import serve as tserve
from resnetc_tpu_torch.models import resnet as tresnet
from resnetc_tpu_torch.ops.cuda import fused, gemm
from resnetc_tpu_torch.tensor import FP32

TWO_22 = 2.0**-22


def _values(n: int, seed: int = 0) -> torch.Tensor:
    """fp32 values over many binades, both signs."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n) * np.exp2(rng.integers(-30, 30, n))
    return torch.from_numpy(v.astype(np.float32))


def test_tf32_round_is_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0**-10  # TF32's mantissa step at 1
    v = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0**-23,
                      one + 1.5 * ulp, 3.0, 0.0, -0.0, float("inf"), float("-inf")])
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0, 0.0, -0.0,
                         float("inf"), float("-inf")])
    got = gemm.tf32_round(v)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool(torch.isnan(gemm.tf32_round(torch.tensor([float("nan")]))).all())
    r = gemm.tf32_round(_values(4096))
    assert int((r.view(torch.int32) & 0x1FFF).abs().sum()) == 0  # 13 low bits clear


def test_tf32_split_parts_and_their_bound():
    v = _values(1 << 16)
    hi, lo = gemm.tf32_split(v)
    for part in (hi, lo):
        assert part.dtype == torch.float32
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    vd = v.double()
    assert bool(((hi.double() - vd).abs() <= 2.0**-11 * vd.abs()).all())
    assert bool(((hi.double() + lo.double() - vd).abs() <= TWO_22 * vd.abs()).all())
    hi, lo = gemm.tf32_split(torch.tensor([float("inf"), float("-inf"), float("nan"), 2.5]))
    assert torch.equal(lo, torch.zeros(4))
    assert hi[0] == float("inf") and hi[1] == float("-inf") and bool(torch.isnan(hi[2]))


def test_three_product_sum_within_its_bound_of_float64():
    a, b = _values(1 << 16, 1), _values(1 << 16, 2)
    (ah, al), (bh, bl) = gemm.tf32_split(a), gemm.tf32_split(b)
    three = ah.double() * bh.double() + ah.double() * bl.double() + al.double() * bh.double()
    exact = a.double() * b.double()
    err = (three - exact).abs()
    assert bool((err <= 3 * TWO_22 * exact.abs()).all()), float((err / exact.abs()).max())
    # one TF32 product alone is nowhere near: the split is what buys fp32's digits
    assert float(((ah.double() * bh.double() - exact).abs() / exact.abs()).max()) > 1e-4


def _split_gemm(x: torch.Tensor, w: torch.Tensor, span: int = 32) -> torch.Tensor:
    """The tile's sum in plain PyTorch: per span of 32 values of K the three
    TF32 products summed (exactly here, in float64), rounded to fp32, the
    spans added in fp32 in K order."""
    (xh, xl), (wh, wl) = gemm.tf32_split(x), gemm.tf32_split(w)
    total = torch.zeros(x.shape[0], w.shape[1])
    for k0 in range(0, x.shape[1], span):
        s = slice(k0, k0 + span)
        part = (xl[:, s].double() @ wh[s].double() + xh[:, s].double() @ wl[s].double()
                + xh[:, s].double() @ wh[s].double())
        total = total + part.float()
    return total


@pytest.mark.parametrize("m,k,n", [(64, 4608, 64), (32, 2048, 1000)],
                         ids=["stage3-3x3-k4608", "fc-b32"])
def test_split_sum_holds_the_gemm_tolerance(m, k, n):
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, n)) * k**-0.5).astype(np.float32))
    want = gemm.matmul_plain(x, w, out_dtype=torch.float32)
    torch.testing.assert_close(_split_gemm(x, w), want, rtol=1e-5, atol=1e-4)


def test_pack_nk_is_the_kernels_k_order():
    """``pack_nk`` of an HWIO weight is (Cout, k*k*Cin) in (u, v, ci) order,
    the im2col loader's K order: the implicit GEMM over it is the conv."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 6, 5, 12)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 12, 8)).astype(np.float32))
    w_nk = gemm.pack_nk(w)
    assert w_nk.shape == (2, 8, 108) and w_nk.is_contiguous()
    hi, lo = gemm.tf32_split(w.reshape(108, 8).t())
    assert torch.equal(w_nk[0], hi) and torch.equal(w_nk[1], lo)
    xp = torch.nn.functional.pad(x.double(), (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, u:u + 6, v:v + 5, :] for u in range(3) for v in range(3)], dim=-1)
    w_kn = (w_nk[0].double() + w_nk[1].double()).t()  # w to 2^-22
    got = (cols.reshape(-1, 108) @ w_kn).reshape(2, 6, 5, 8)
    want = torch.nn.functional.conv2d(x.double().permute(0, 3, 1, 2),
                                      w.double().permute(3, 2, 0, 1), padding=1)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=0, atol=1e-5)
    exact = cols.reshape(-1, 108) @ w.double().reshape(108, 8)
    torch.testing.assert_close(got.reshape(-1, 8), exact, rtol=0, atol=1e-12 + 2.0**-22 * float(
        (cols.reshape(-1, 108).abs() @ w.double().reshape(108, 8).abs()).max()))
    fc = torch.from_numpy(rng.standard_normal((300, 10)).astype(np.float32))
    assert torch.equal(gemm.pack_nk(fc), torch.stack(gemm.tf32_split(fc.t())))


def test_pack_f32_kmajor_adds_the_conv_copies_only():
    cfg = tresnet.ResNetConfig("cut", "bottleneck", (1, 1, 1, 1), num_classes=7, stem_width=16)
    folded = tresnet.fold_inference_params(cfg, tresnet.init(cfg, torch.Generator().manual_seed(0)))
    packed = fused.pack_f32_kmajor(folded)
    assert "weight_nk" not in packed["conv1"]  # the 7x7 stem runs a stock convolution
    assert torch.equal(packed["fc"]["weight_nk"], gemm.pack_nk(folded["fc"]["weight"].t()))
    blk = packed["layer2"]["0"]
    for key in ("conv1", "conv2", "conv3", "downsample"):
        w = blk[key]["weight"]
        assert torch.equal(blk[key]["weight_nk"], gemm.pack_nk(w))
        assert blk[key]["weight"] is folded["layer2"]["0"][key]["weight"]  # shared


def test_fp32_pallas_engine_with_copies_matches_jax():
    """The FP32 ``pallas`` engine holds the (N, K) copies; its logits equal
    the same forward on the tree without them, and stay within 1e-4 of the
    JAX engine's."""
    kw = dict(name="cut_bottleneck", block="bottleneck", stage_blocks=(2, 1, 1, 1),
              num_classes=11, stem_width=16)
    tcfg, jcfg = tresnet.ResNetConfig(**kw), jresnet.ResNetConfig(**kw)
    tvars = tresnet.init(tcfg, torch.Generator().manual_seed(1))
    x = np.random.default_rng(4).standard_normal((2, 32, 32, 3)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        teng = tserve.InferenceEngine(tcfg, tvars, policy=FP32, backend="pallas", device="cpu")
        jeng = jserve.InferenceEngine(jcfg, jax.tree.map(lambda t: jnp.asarray(t.numpy()), tvars),
                                      policy=JFP32, backend="pallas")
    assert "weight_nk" in teng.folded["layer1"]["0"]["conv2"]
    got = teng.logits(x)
    bare = fused.fused_forward(tcfg, tresnet.fold_inference_params(tcfg, tvars),
                               torch.from_numpy(x), policy=FP32)
    assert torch.equal(got, bare)
    want = np.asarray(jeng.logits(jnp.asarray(x)), np.float32)
    rel = float(np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)))
    assert rel <= 1e-4, rel
