"""The port's plain ops (``resnetc_tpu_torch.ops.torch_ops``) vs ``lax_ops``.

Same seeded numpy inputs into both.  Tolerances: fp32 results 1e-5
(convolution and matmul sum in another order); bf16 outputs one bf16 step
(rtol 8e-3: the fp32 sums round to bf16 and may land on either side of a
rounding boundary); pooling, relu and the int8 max pool are exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnetc_tpu.ops import lax_ops
from resnetc_tpu.ops import shapes as jshapes
from resnetc_tpu_torch.ops import shapes as tshapes
from resnetc_tpu_torch.ops import torch_ops


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _j(a: np.ndarray, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


def _t(a: np.ndarray, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


# (k, stride, padding, groups)
CONVS = [(3, 1, 1, 1), (7, 2, 3, 1), (1, 2, 0, 1), (3, 2, 1, 1), (3, 1, 1, 4)]


@pytest.mark.parametrize("k,stride,padding,groups", CONVS)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_conv2d_matches_lax(rng, k, stride, padding, groups, dtype):
    x = rng.standard_normal((2, 13, 11, 8)).astype(np.float32)
    w = rng.standard_normal((k, k, 8 // groups, 12)).astype(np.float32) * 0.2
    jd, td = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    want = lax_ops.conv2d(_j(x, jd), _j(w, jd), stride=stride, padding=padding, groups=groups)
    got = torch_ops.conv2d(_t(x, td), _t(w, td), stride=stride, padding=padding, groups=groups)
    assert got.dtype == td and tuple(got.shape) == want.shape
    rtol = 1e-5 if dtype == "fp32" else 8e-3
    np.testing.assert_allclose(
        _np(got), np.asarray(want.astype(jnp.float32)), rtol=rtol, atol=rtol
    )


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_max_pool2d_matches_lax(rng, dtype):
    if dtype == "int8":
        x = rng.integers(-127, 128, size=(2, 9, 10, 5), dtype=np.int8)
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    else:
        x = rng.standard_normal((2, 9, 10, 5)).astype(np.float32) - 3.0  # padding must lose
        jd, td = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
        jx, tx = _j(x, jd), _t(x, td)
    want = lax_ops.max_pool2d(jx, kernel_size=3, stride=2, padding=1)
    got = torch_ops.max_pool2d(tx, kernel_size=3, stride=2, padding=1)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(_np(got), np.asarray(want.astype(jnp.float32)))


def test_relu_add_pool_linear_match_lax(rng):
    x = rng.standard_normal((3, 5, 4, 6)).astype(np.float32)
    np.testing.assert_array_equal(_np(torch_ops.relu(_t(x))), np.asarray(lax_ops.relu(_j(x))))
    np.testing.assert_array_equal(
        _np(torch_ops.add(_t(x), _t(x))), np.asarray(lax_ops.add(_j(x), _j(x)))
    )
    np.testing.assert_allclose(
        _np(torch_ops.global_avg_pool(_t(x))), np.asarray(lax_ops.global_avg_pool(_j(x))),
        rtol=1e-6, atol=1e-6,
    )
    a = rng.standard_normal((4, 32)).astype(np.float32)
    w = rng.standard_normal((10, 32)).astype(np.float32)
    b = rng.standard_normal(10).astype(np.float32)
    np.testing.assert_allclose(
        _np(torch_ops.linear(_t(a), _t(w), _t(b))),
        np.asarray(lax_ops.linear(_j(a), _j(w), _j(b))), rtol=1e-5, atol=1e-5,
    )


def test_batch_norm_and_fold_match_lax(rng):
    c = 7
    x = rng.standard_normal((2, 4, 5, c)).astype(np.float32)
    scale, bias, mean = (rng.standard_normal(c).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.2, 2.0, c).astype(np.float32)
    bn = (scale, bias, mean, var)
    np.testing.assert_allclose(
        _np(torch_ops.batch_norm_inference(_t(x), *map(_t, bn))),
        np.asarray(lax_ops.batch_norm_inference(_j(x), *map(_j, bn))),
        rtol=1e-6, atol=1e-6,
    )
    w = rng.standard_normal((3, 3, 5, c)).astype(np.float32)
    tw, tb = torch_ops.fold_bn_into_conv(_t(w), *map(_t, bn))
    jw, jb = lax_ops.fold_bn_into_conv(_j(w), *map(_j, bn))
    np.testing.assert_allclose(_np(tw), np.asarray(jw), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(tb), np.asarray(jb), rtol=1e-6, atol=1e-6)


def test_shapes_match():
    for args in ((224, 7, 2, 3), (112, 3, 2, 1), (7, 1, 1, 0), (5, 3, 2, 1)):
        assert tshapes.conv_output_size(*args) == jshapes.conv_output_size(*args)
    for bad in ((2, 7, 1, 0), (5, 3, 0, 1)):
        with pytest.raises(ValueError):
            tshapes.conv_output_size(*bad)
