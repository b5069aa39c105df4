"""The port's fused convolutions and max pool vs the JAX package's kernels.

The plain versions of ``conv3x3_s1_fused``, ``conv_s2_fused`` (k = 3, 5, 7, 9)
and ``max_pool2d`` — what the wrappers run for a CPU tensor — and
``conv1x1_fused`` (stride 1 and 2, through ``gemm.matmul``'s plain version)
and ``gemm.matmul`` with a bf16 residual against the Pallas kernels run
with ``interpret=True``, on the same inputs made from a seeded numpy
generator, at the JAX tests' small shapes (``tests/test_pallas.py``).

Tolerances.  The convolutions sum up to 9*Cin fp32 products in another
order than XLA's per-tap dots: fp32 outputs are held to rtol 1e-4 (atol
1e-4), the JAX oracle tests' bound.  bf16 outputs are the same fp32 sums
rounded once more, so a sum within an fp32 rounding of a bf16 rounding
boundary may land one bf16 step apart: each element within 1 bf16 ulp (of
the larger magnitude), or within 1e-5 of the largest output where relu
cuts a sum that is zero to fp32 rounding.  The max pool compares values,
so its outputs are EQUAL, in bf16 and int8 alike.

NaN.  With a NaN in one input pixel and a -Inf in another, the plain
versions give NaN (and +-Inf) exactly where the Pallas kernels do: their
relu is ``jnp.maximum(v, 0)`` and the pool's max ``jnp.maximum``, both of
which keep a NaN.  The other values keep the tolerances above.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnetc_tpu.ops.pallas import conv as jconv
from resnetc_tpu.ops.pallas import gemm as jgemm
from resnetc_tpu.ops.pallas import pool as jpool
from resnetc_tpu_torch.ops.cuda import conv as tconv
from resnetc_tpu_torch.ops.cuda import gemm as tgemm
from resnetc_tpu_torch.ops.cuda import pool as tpool

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _pair(a: np.ndarray, dtype: str):
    """The same values in both frameworks (rounded to bf16 once, by JAX)."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(a).astype(jd)
    return j, torch.from_numpy(np.array(_np(j))).to(td)


def bf16_ulp(a: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |a| (8 significant bits)."""
    _, e = np.frexp(np.abs(a).astype(np.float32))
    return np.ldexp(np.float32(1.0), e - 8).astype(np.float32)


def assert_conv_close(got, want, dtype: str):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    if dtype == "f32":
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        return
    err = np.abs(g - w)
    ulp = np.maximum(bf16_ulp(g), bf16_ulp(w))
    ok = (err <= ulp) | (err <= 1e-5 * np.abs(w).max())
    assert ok.all(), f"{(~ok).sum()} elements beyond 1 bf16 ulp, max err {err.max()}"


def _inputs(rng, b, h, w, cin, cout, k, dtype, *, bias=True, residual=False):
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(wt, dtype)
    out = {"x": (jx, tx), "w": (jw, tw), "bias": (None, None), "res": (None, None)}
    if bias:
        bv = rng.standard_normal((cout,)).astype(np.float32)
        out["bias"] = (jnp.asarray(bv), torch.from_numpy(bv))
    if residual:
        out["res"] = _pair(rng.standard_normal((b, h, w, cout)).astype(np.float32), dtype)
    return out


# (b, h, w, cin, cout, dtype): tests/test_pallas.py:55-58, odd and
# non-square sizes, Cout off the kernel's 64-wide tile.
S1_CASES = [(2, 8, 8, 16, 32, "f32"), (2, 8, 8, 16, 32, "bf16"), (3, 9, 9, 24, 40, "f32"),
            (2, 7, 9, 8, 72, "bf16")]


@pytest.mark.parametrize("b,h,w,cin,cout,dtype", S1_CASES)
def test_conv3x3_s1_plain_matches_pallas(rng, b, h, w, cin, cout, dtype):
    t = _inputs(rng, b, h, w, cin, cout, 3, dtype, residual=True)
    (jx, tx), (jw, tw), (jb, tb), (jr, tr) = t["x"], t["w"], t["bias"], t["res"]
    want = jconv.conv3x3_s1_fused(jx, jw, jb, jr, relu=True, interpret=True)
    got = tconv.conv3x3_s1_fused(tx, tw, tb, tr, relu=True)
    assert got.dtype == DTYPES[dtype][1]
    assert_conv_close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_conv3x3_s1_no_bias_no_relu(rng, dtype):
    t = _inputs(rng, 2, 6, 6, 8, 16, 3, dtype, bias=False)
    (jx, tx), (jw, tw) = t["x"], t["w"]
    want = jconv.conv3x3_s1_fused(jx, jw, interpret=True)
    got = tconv.conv3x3_s1_fused_plain(tx, tw)
    assert_conv_close(got, want, dtype)
    assert (_np(got) < 0).any()  # no relu


# (b, h, cin, cout, k, dtype): tests/test_pallas.py:214-238, odd and even
# sizes, Cout off the tile, k = 5 and 7; k = 9 (81 taps: more than a
# 64-bit tap mask holds) and a stem-like 7x7 on Cin = 3.
S2_CASES = [(2, 8, 16, 32, 3, "f32"), (2, 8, 16, 32, 3, "bf16"), (2, 9, 16, 72, 3, "f32"),
            (2, 7, 8, 8, 3, "bf16"), (2, 13, 8, 16, 5, "f32"), (2, 13, 8, 16, 7, "bf16"),
            (2, 19, 8, 16, 9, "bf16"), (2, 15, 3, 16, 7, "bf16")]


@pytest.mark.parametrize("b,h,cin,cout,k,dtype", S2_CASES)
def test_conv_s2_plain_matches_pallas(rng, b, h, cin, cout, k, dtype):
    t = _inputs(rng, b, h, h, cin, cout, k, dtype, bias=k == 3)
    (jx, tx), (jw, tw), (jb, tb) = t["x"], t["w"], t["bias"]
    want = jconv.conv_s2_fused(jx, jw, jb, relu=k == 3, interpret=True)
    got = tconv.conv_s2_fused(tx, tw, tb, relu=k == 3)
    assert got.shape == (b, (h + 2 * (k // 2) - k) // 2 + 1, (h + 2 * (k // 2) - k) // 2 + 1, cout)
    assert_conv_close(got, want, dtype)
    if k == 3:
        alias = tconv.conv3x3_s2_fused(tx, tw, tb, relu=True)
        assert torch.equal(alias, got)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("stride", [1, 2])
def test_conv1x1_fused_matches_pallas(rng, stride, dtype):
    t = _inputs(rng, 2, 8, 8, 16, 32, 1, dtype, residual=False)
    (jx, tx), (jw, tw), (jb, tb) = t["x"], t["w"], t["bias"]
    res = rng.standard_normal((2, 8 // stride, 8 // stride, 32)).astype(np.float32)
    jr, tr = _pair(res, dtype)
    want = jconv.conv1x1_fused(jx, jw, jb, jr, stride=stride, relu=True, interpret=True)
    got = tconv.conv1x1_fused(tx, tw, tb, tr, stride=stride, relu=True,
                              matmul_fn=tgemm.matmul_plain)
    assert got.dtype == DTYPES[dtype][1]
    assert_conv_close(got, want, dtype)


@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_matmul_bf16_residual_plain_matches_pallas(rng, out):
    """A bf16 residual is read in its own dtype (widened exactly), as the
    Pallas kernel reads it: bf16 x, w and residual, fp32 bias, fp32 or bf16
    out."""
    x, w = rng.standard_normal((12, 72)), rng.standard_normal((72, 40)) * 72**-0.5
    (jx, tx), (jw, tw) = _pair(x, "bf16"), _pair(w, "bf16")
    jr, tr = _pair(rng.standard_normal((12, 40)), "bf16")
    bias = rng.standard_normal(40).astype(np.float32)
    jd, td = DTYPES[out]
    want = jgemm.matmul(jx, jw, jnp.asarray(bias), jr, relu=True, out_dtype=jd, interpret=True)
    got = tgemm.matmul(tx, tw, torch.from_numpy(bias), tr, relu=True, out_dtype=td)
    assert got.dtype == td and tr.dtype == torch.bfloat16
    if out == "f32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    else:
        assert_conv_close(got, want, "bf16")


def test_conv_wrappers_reject_a_mismatched_weight(rng):
    x = torch.zeros((1, 8, 8, 16))
    with pytest.raises(ValueError):
        tconv.conv3x3_s1_fused(x, torch.zeros((3, 3, 8, 16)))
    with pytest.raises(ValueError):
        tconv.conv3x3_s1_fused(x, torch.zeros((5, 5, 16, 16)))
    with pytest.raises(ValueError):
        tconv.conv_s2_fused(x, torch.zeros((2, 2, 16, 16)))


POOL_CASES = [(3, 2, 1, 12), (2, 2, 0, 8), (3, 1, 1, 7), (3, 3, 1, 9)]


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("k,s,p,hw", POOL_CASES)
def test_max_pool2d_plain_equals_pallas(rng, k, s, p, hw, dtype):
    if dtype == "int8":
        # -128 included: it must beat the integer-min padding only as itself.
        x = rng.integers(-128, 128, size=(4, hw, hw, 24), dtype=np.int8)
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    else:
        jx, tx = _pair(rng.standard_normal((4, hw, hw, 24)).astype(np.float32), "bf16")
    want = jpool.max_pool2d(jx, kernel_size=k, stride=s, padding=p, interpret=True)
    got = tpool.max_pool2d(tx, kernel_size=k, stride=s, padding=p)
    assert got.dtype == tx.dtype and got.is_contiguous()
    np.testing.assert_array_equal(_np(got), _np(want))


def test_max_pool2d_window_all_negative_keeps_its_max(rng):
    """A window of negative values at the border: the padding must not win."""
    x = -np.abs(rng.standard_normal((1, 5, 5, 3))).astype(np.float32) - 1.0
    got = tpool.max_pool2d_plain(torch.from_numpy(x), kernel_size=3, stride=2, padding=1)
    want = jpool.max_pool2d(jnp.asarray(x), kernel_size=3, stride=2, padding=1, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isfinite(got.numpy()).all()


# ---------------------------------------------------------------------------
# NaN and Inf: a NaN pixel and a -Inf pixel in the input
# ---------------------------------------------------------------------------


def _poisoned(rng, shape, dtype):
    """Random values with a NaN in every channel of one pixel (row, for a
    matrix) and -Inf in every channel of another, in both frameworks."""
    a = rng.standard_normal(shape).astype(np.float32)
    a.reshape(-1, shape[-1])[1] = np.nan
    a.reshape(-1, shape[-1])[-3] = -np.inf
    return _pair(a, dtype)


def assert_same_nan_and_close(got, want, dtype):
    """NaN and +-Inf at the same places; the finite values as
    ``assert_conv_close`` holds them."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and np.isnan(w).any()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
    np.testing.assert_array_equal(g[np.isinf(w)], w[np.isinf(w)])
    fin = np.isfinite(w)
    assert_conv_close(g[fin], w[fin], dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("op", ["conv3x3_s1", "conv_s2", "matmul"])
def test_relu_keeps_nan_as_pallas_does(rng, op, dtype):
    if op == "matmul":
        jx, tx = _poisoned(rng, (12, 40), dtype)
        jw, tw = _pair(rng.standard_normal((40, 24)) * 40**-0.5, dtype)
        bias = rng.standard_normal(24).astype(np.float32)
        jd, td = DTYPES[dtype]
        want = jgemm.matmul(jx, jw, jnp.asarray(bias), relu=True, out_dtype=jd, interpret=True)
        got = tgemm.matmul(tx, tw, torch.from_numpy(bias), relu=True, out_dtype=td)
    else:
        jx, tx = _poisoned(rng, (2, 8, 8, 16), dtype)
        jw, tw = _pair(rng.standard_normal((3, 3, 16, 24)) * 0.1, dtype)
        bias = rng.standard_normal(24).astype(np.float32)
        jb, tb = jnp.asarray(bias), torch.from_numpy(bias)
        jfn, tfn = getattr(jconv, op + "_fused"), getattr(tconv, op + "_fused")
        want = jfn(jx, jw, jb, relu=True, interpret=True)
        got = tfn(tx, tw, tb, relu=True)
    assert_same_nan_and_close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_max_pool2d_keeps_nan_as_pallas_does(rng, dtype):
    jx, tx = _poisoned(rng, (2, 9, 9, 8), dtype)
    want = jpool.max_pool2d(jx, kernel_size=3, stride=2, padding=1, interpret=True)
    got = tpool.max_pool2d(tx, kernel_size=3, stride=2, padding=1)
    g, w = _np(got), _np(want)
    assert np.isnan(w).any() and np.isinf(w).sum() == 0
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_array_equal(g[~np.isnan(w)], w[~np.isnan(w)])
