"""The port's op library vs the JAX package's: ``avg_pool2d`` (kernel table
row 16) and ``relu`` / ``add`` / ``add_relu`` (rows 19-20), and the names
``resnetc_tpu_torch.ops.cuda`` exports.

The plain versions — what the wrappers run for a CPU tensor — against the
Pallas kernels run with ``interpret=True``, on the same inputs made from a
seeded numpy generator, at the JAX tests' shapes (``tests/test_pallas.py``):
the average pool at (k, s, p) = (7, 1, 0) over 7x7 (the head pool, also at
320 channels), (3, 2, 1) over 16x16 and (2, 2, 0) over 8x8, the elementwise
ops at (3, 17, 50) with NaN and infinities among the inputs.  bf16 and fp32.  Every output is
EQUAL to the Pallas kernel's, NaN where it has NaN: the pool sums in the
TPU kernel's order and multiplies by the same fp32 constant, and a
maximum, a sum rounded once and a selection are exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import resnetc_tpu.ops.pallas as jops
from resnetc_tpu.ops.pallas import elementwise as jew
from resnetc_tpu.ops.pallas import pool as jpool
from resnetc_tpu_torch.ops import cuda as tops
from resnetc_tpu_torch.ops.cuda import _build
from resnetc_tpu_torch.ops.cuda import elementwise as tew
from resnetc_tpu_torch.ops.cuda import pool as tpool

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
OP_LIBRARY = ("matmul", "conv1x1_fused", "conv3x3_s1_fused", "conv3x3_s2_fused", "max_pool2d",
              "avg_pool2d", "relu", "add", "add_relu", "bottleneck_block_fused", "fused_forward")


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


def _pair(a: np.ndarray, dtype: str):
    """The same values in both frameworks (rounded to bf16 once, by JAX)."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(a).astype(jd)
    return j, torch.from_numpy(np.array(_np(j))).to(td)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k,s,p,hw", [(7, 1, 0, 7), (3, 2, 1, 16), (2, 2, 0, 8)])
def test_avg_pool2d_equals_pallas(k, s, p, hw, dtype):
    rng = np.random.default_rng(100 + k)
    jx, tx = _pair(rng.standard_normal((4, hw, hw, 24)).astype(np.float32), dtype)
    want = jpool.avg_pool2d(jx, kernel_size=k, stride=s, padding=p, interpret=True)
    got = tpool.avg_pool2d(tx, kernel_size=k, stride=s, padding=p)
    assert got.dtype == tx.dtype and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_avg_pool2d_head_shape_equals_pallas(dtype):
    """The head pool's shape class (7x7 over a 7x7 map, one output pixel an
    image) at a few hundred channels, where the kernel spreads the window's
    rows over threads: equal to the Pallas pool."""
    rng = np.random.default_rng(7)
    jx, tx = _pair(rng.standard_normal((2, 7, 7, 320)).astype(np.float32), dtype)
    want = jpool.avg_pool2d(jx, kernel_size=7, stride=1, padding=0, interpret=True)
    got = tpool.avg_pool2d(tx, kernel_size=7, stride=1, padding=0)
    assert got.dtype == tx.dtype and tuple(got.shape) == tuple(want.shape) == (2, 1, 1, 320)
    np.testing.assert_array_equal(_np(got), _np(want))


def _operands(dtype: str):
    rng = np.random.default_rng(77)
    a = rng.standard_normal((3, 17, 50)).astype(np.float32)
    b = rng.standard_normal((3, 17, 50)).astype(np.float32)
    a[0, 0, :3] = np.nan
    b[1, 2, 4] = np.nan
    a[2, 3, 5], b[2, 3, 5] = np.inf, -np.inf  # inf - inf: NaN
    a[2, 4, 6] = -np.inf
    return _pair(a, dtype), _pair(b, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("op", ["relu", "add", "add_relu"])
def test_elementwise_equals_pallas(op, dtype):
    (ja, ta), (jb, tb) = _operands(dtype)
    if op == "relu":
        want, got = jew.relu(ja, interpret=True), tew.relu(ta)
    else:
        want = getattr(jew, op)(ja, jb, interpret=True)
        got = getattr(tew, op)(ta, tb)
    assert got.dtype == ta.dtype and got.shape == ta.shape
    want = _np(want)
    assert np.isnan(want).any()  # NaN propagates through max, as in jnp.maximum
    np.testing.assert_array_equal(_np(got), want)


def test_elementwise_rejects_mismatched_operands():
    a = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="operands differ"):
        tew.add(a, torch.zeros((3, 2)))
    with pytest.raises(ValueError, match="operands differ"):
        tew.add_relu(a, torch.zeros((2, 3), dtype=torch.bfloat16))


def test_op_library_exports_the_pallas_names():
    """The port exports the JAX op library's names, each a function, and
    importing it built and launched nothing."""
    public = {n for n in dir(jops) if not n.startswith("_")}
    assert set(OP_LIBRARY) <= public
    for name in OP_LIBRARY:
        assert callable(getattr(tops, name)), name
    assert tops.avg_pool2d is tpool.avg_pool2d and tops.add_relu is tew.add_relu
    assert not _build.LAUNCHES and not _build._OPS_LOADED
