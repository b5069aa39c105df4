"""The port's int8 chain kernels (plain versions) vs the JAX Pallas kernels.

Both sides get identical int8 inputs and weights, made from a seeded numpy
generator.  The JAX wrappers run with ``interpret=True`` (how the JAX
package's own tests run them on the CPU); the port's wrappers get CPU
tensors and so run their plain versions.  Tolerances: int8 and bf16 chain
interiors are compared for EQUALITY (the integer dots are exact and every
fp32 epilogue keeps the Pallas kernel's order of operations); the f32 head
fold (``emit_mean``) and the fp32-accumulating GEMM sum in another order,
so they are held to rtol 1e-5.  Chain ring rows carry no meaning and are
not compared.  The plain versions given the K-major (N, K) weight copies
that the int8 tensor-core kernels read (the engine's, from
``fused.pack_chain_kmajor``) compute the same values: EQUAL to the Pallas
kernel, and the run and the transition to themselves without them.

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnetc_tpu.ops.pallas import block as jblock
from resnetc_tpu.ops.pallas import gemm as jgemm
from resnetc_tpu.ops.pallas import quant as jquant
from resnetc_tpu_torch.ops.cuda import _build
from resnetc_tpu_torch.ops.cuda import block as tblock
from resnetc_tpu_torch.ops.cuda import gemm as tgemm
from resnetc_tpu_torch.ops.cuda import quant as tquant

SCALES = np.asarray([4.0 / 127, 3.0 / 127, 5.0 / 127, 6.0 / 127], np.float32)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy() if a.dtype == torch.bfloat16 else a.cpu().numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _pair(tree):
    """numpy tree -> (jnp tree, torch tree)."""
    if isinstance(tree, dict):
        j, t = {}, {}
        for k, v in tree.items():
            j[k], t[k] = _pair(v)
        return j, t
    return jnp.asarray(tree), torch.from_numpy(np.array(tree))


def _conv_entry(rng, shape):
    return {
        "weight": (rng.standard_normal(shape) * 0.1).astype(np.float32),
        "bias": (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32),
    }


def _chain_block(rng, cin, c, c4, proj=False, ds=False):
    blk = {
        "conv1": _conv_entry(rng, (1, 1, cin, c)),
        "conv2": _conv_entry(rng, (3, 3, c, c)),
        "conv3": _conv_entry(rng, (1, 1, c, c4)),
    }
    if proj or ds:
        blk["downsample"] = _conv_entry(rng, (1, 1, cin, c4))
    return blk


def _chain_input(rng, b, h, cin):
    """A full int8 chain, ring rows included (garbage the kernels must
    ignore)."""
    hp, wp = tblock.chain_meta(b, h, h)
    return rng.integers(-127, 128, size=(b * hp * wp, cin), dtype=np.int8)


def _interior(a, b, h, w):
    hp, wp = tblock.chain_meta(b, h, w)
    return _np(a).reshape(b, hp, wp, -1)[:, 1 : 1 + h, 1 : 1 + w]


def _quantized_pair(blk, *, ds=False):
    jb, tb = _pair(blk)
    if ds:
        return jblock.quantize_ds_block(jb), tblock.quantize_ds_block(tb)
    jq, tq = jblock.quantize_chain_block(jb), tblock.quantize_chain_block(tb)
    if "downsample" in blk:
        jq["wdq"], jq["swd"] = jquant.quantize_per_channel(jb["downsample"]["weight"][0, 0])
        tq["wdq"], tq["swd"] = tquant.quantize_per_channel(tb["downsample"]["weight"][0, 0])
        jq["bd"], tq["bd"] = jb["downsample"]["bias"], tb["downsample"]["bias"]
    return jq, tq


def test_quantize_per_channel_and_with_scale_equal_jax(rng):
    w = (rng.standard_normal((48, 24)) * 0.3).astype(np.float32)
    w[:, 3] = 0.0  # zero column: scale 1, as in JAX
    jq, js = jquant.quantize_per_channel(jnp.asarray(w))
    tq, ts = tquant.quantize_per_channel(torch.from_numpy(w))
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    x = (rng.standard_normal((5, 7)) * 3).astype(np.float32)
    x[0, :3] = [0.5 * 4 / 127, 1.5 * 4 / 127, 2.5 * 4 / 127]  # exact halves
    s = np.float32(4.0 / 127)
    np.testing.assert_array_equal(
        _np(tquant.quantize_with_scale(torch.from_numpy(x), torch.tensor(s))),
        np.asarray(jquant.quantize_with_scale(jnp.asarray(x), jnp.float32(s))),
    )


@pytest.mark.parametrize("ds", [False, True], ids=["chain", "ds"])
def test_quantize_block_equals_jax(rng, ds):
    blk = _chain_block(rng, 64, 16, 64, ds=ds)
    jq, tq = _quantized_pair(blk, ds=ds)
    assert set(jq) == set(tq)
    for k in jq:
        np.testing.assert_array_equal(_np(tq[k]), np.asarray(jq[k]), err_msg=k)


def test_chain_layout_round_trip(rng):
    for w_sp, wp in ((7, 8), (8, 16), (14, 16), (15, 16), (56, 64)):
        assert tblock.chain_meta(0, 5, w_sp) == jblock.chain_meta(0, 5, w_sp) == (7, wp)
    x = rng.integers(-127, 128, size=(2, 7, 7, 8), dtype=np.int8)
    tr = tblock.pad_for_chain(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(tr), np.asarray(jblock.pad_for_chain(jnp.asarray(x))))
    np.testing.assert_array_equal(_np(tblock.unpad_from_chain(tr, 2, 7, 7)), x)


# (id, h, cin, c, c4, proj, emit_i8, emit_mean)
BLOCK_CASES = [
    ("identity-h8", 8, 64, 16, 64, False, True, False),
    ("identity-h7", 7, 64, 16, 64, False, True, False),
    ("proj-h8", 8, 16, 16, 64, True, True, False),
    ("proj-h7", 7, 16, 16, 64, True, True, False),
    ("bf16-exit-h7", 7, 64, 16, 64, False, False, False),
    ("emit-mean-h8", 8, 64, 16, 64, False, False, True),
    ("emit-mean-h7", 7, 64, 16, 64, False, False, True),
]


@pytest.mark.parametrize(
    "h,cin,c,c4,proj,emit_i8,emit_mean",
    [case[1:] for case in BLOCK_CASES],
    ids=[case[0] for case in BLOCK_CASES],
)
def test_block_plain_equals_jax(rng, h, cin, c, c4, proj, emit_i8, emit_mean):
    b = 2
    jq, tq = _quantized_pair(_chain_block(rng, cin, c, c4, proj=proj))
    x = _chain_input(rng, b, h, cin)
    keys = ("w1q", "sw1", "b1", "w2pq", "sw2p", "b2", "w3q", "sw3", "b3")
    kw = dict(h=h, w_sp=h, emit_i8=emit_i8, emit_mean=emit_mean)
    jproj = {k: jq[k] for k in ("wdq", "swd", "bd")} if proj else {}
    tproj = {k: tq[k] for k in ("wdq", "swd", "bd")} if proj else {}
    want = jblock.bottleneck_block_chained_int8(
        jnp.asarray(x), *(jq[k] for k in keys), jnp.asarray(SCALES),
        interpret=True, **kw, **jproj,
    )
    got = tblock.bottleneck_block_chained_int8(
        torch.from_numpy(x), *(tq[k] for k in keys), torch.from_numpy(SCALES),
        **kw, **tproj,
    )
    if emit_mean:
        assert got.shape == (b, c4) and got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)
        return
    assert got.dtype == (torch.int8 if emit_i8 else torch.bfloat16)
    assert got.shape == tuple(want.shape)
    gi, wi = _interior(got, b, h, h), _interior(want, b, h, h)
    np.testing.assert_array_equal(gi, wi)
    # Not a degenerate case: the outputs span the int8 range.
    assert len(np.unique(gi)) > 20


def _kmajor(tq: dict) -> dict:
    return {k + "_nk": tq[k].t().contiguous() for k in ("w1q", "w2pq", "w3q", "wdq") if k in tq}


@pytest.mark.parametrize("proj", [False, True], ids=["identity", "proj"])
@pytest.mark.parametrize("h", [7, 8])
def test_block_plain_on_kmajor_weights_equals_jax(rng, h, proj):
    b, c = 2, 16
    cin, c4 = (c, 4 * c) if proj else (4 * c, 4 * c)
    jq, tq = _quantized_pair(_chain_block(rng, cin, c, c4, proj=proj))
    x = _chain_input(rng, b, h, cin)
    keys = ("w1q", "sw1", "b1", "w2pq", "sw2p", "b2", "w3q", "sw3", "b3")
    extra = ("wdq", "swd", "bd") if proj else ()
    want = jblock.bottleneck_block_chained_int8(
        jnp.asarray(x), *(jq[k] for k in keys), jnp.asarray(SCALES), h=h, w_sp=h,
        interpret=True, **{k: jq[k] for k in extra},
    )
    got = tblock.bottleneck_block_chained_int8_plain(
        torch.from_numpy(x), *(tq[k] for k in keys), torch.from_numpy(SCALES), h=h, w_sp=h,
        **{k: tq[k] for k in extra}, **_kmajor(tq),
    )
    gi, wi = _interior(got, b, h, h), _interior(want, b, h, h)
    np.testing.assert_array_equal(gi, wi)
    assert len(np.unique(gi)) > 20
    with pytest.raises(ValueError):  # a copy of another weight's shape
        tblock.bottleneck_block_chained_int8_plain(
            torch.from_numpy(x), *(tq[k] for k in keys), torch.from_numpy(SCALES), h=h,
            w_sp=h, **{k: tq[k] for k in extra}, w1q_nk=tq["w2pq"],
        )


@pytest.mark.parametrize("proj", [False, True], ids=["identity", "proj"])
def test_run_plain_on_kmajor_weights_equals_unpacked(rng, proj):
    b, h, c, c4, n = 2, 7, 16, 64, 3
    qs = [_quantized_pair(_chain_block(rng, c if proj and i == 0 else c4, c, c4,
                                       proj=proj and i == 0))[1] for i in range(n)]
    x = torch.from_numpy(_chain_input(rng, b, h, c if proj else c4))
    keys = ("sw1", "b1", "w2pq", "sw2p", "b2", "w3q", "sw3", "b3")
    w1 = [q["w1q"] for q in qs[1 if proj else 0:]]
    args = (x, torch.stack(w1), *(torch.stack([q[k] for q in qs]) for k in keys),
            torch.from_numpy(np.stack([SCALES] * n)))
    kw = dict(h=h, w_sp=h)
    nk = dict(w1q_nk_s=torch.stack([w.t().contiguous() for w in w1]),
              w2pq_nk_s=torch.stack([q["w2pq"].t().contiguous() for q in qs]),
              w3q_nk_s=torch.stack([q["w3q"].t().contiguous() for q in qs]))
    if proj:
        kw.update(w1q0=qs[0]["w1q"], wdq=qs[0]["wdq"], swd=qs[0]["swd"], bd=qs[0]["bd"])
        nk.update(w1q0_nk=qs[0]["w1q"].t().contiguous(), wdq_nk=qs[0]["wdq"].t().contiguous())
    for emit_i8 in (True, False):
        want = tblock.bottleneck_run_chained_int8_plain(*args, emit_i8=emit_i8, **kw)
        got = tblock.bottleneck_run_chained_int8(*args, emit_i8=emit_i8, **kw, **nk)
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("n_blocks", [2, 3])
def test_run_plain_equals_jax(rng, n_blocks):
    b, h, c, c4 = 2, 8, 16, 64
    pairs = [_quantized_pair(_chain_block(rng, c4, c, c4)) for _ in range(n_blocks)]
    keys = ("w1q", "sw1", "b1", "w2pq", "sw2p", "b2", "w3q", "sw3", "b3")
    scales = np.stack(
        [SCALES * np.float32(1.0 + 0.1 * i) for i in range(n_blocks)]
    ).astype(np.float32)
    scales[1:, 0] = scales[:-1, 3]  # block i's s_y is block i+1's s_x
    x = _chain_input(rng, b, h, c4)
    for emit_i8 in (True, False):
        want = jblock.bottleneck_run_chained_int8(
            jnp.asarray(x), *(jnp.stack([p[0][k] for p in pairs]) for k in keys),
            jnp.asarray(scales), h=h, w_sp=h, emit_i8=emit_i8, interpret=True,
        )
        got = tblock.bottleneck_run_chained_int8(
            torch.from_numpy(x), *(torch.stack([p[1][k] for p in pairs]) for k in keys),
            torch.from_numpy(scales), h=h, w_sp=h, emit_i8=emit_i8,
        )
        np.testing.assert_array_equal(_interior(got, b, h, h), _interior(want, b, h, h))


@pytest.mark.parametrize("h", [8, 16, 7], ids=["direct-h8", "generic-h16", "odd-h7"])
def test_ds_plain_equals_jax(rng, h):
    b, cin, c, c4 = 2, 64, 16, 64
    jq, tq = _quantized_pair(_chain_block(rng, cin, c, c4, ds=True), ds=True)
    x = _chain_input(rng, b, h, cin)
    keys = ("w1q", "sw1", "b1", "w2q", "sw2", "b2", "w3q", "sw3", "b3", "wdq", "swd", "bd")
    want = jblock.downsample_block_s2_int8(
        jnp.asarray(x), *(jq[k] for k in keys), jnp.asarray(SCALES),
        h=h, w_sp=h, interpret=True,
    )
    got = tblock.downsample_block_s2_int8(
        torch.from_numpy(x), *(tq[k] for k in keys), torch.from_numpy(SCALES), h=h, w_sp=h,
    )
    oh = (h + 1) // 2
    assert got.shape == tuple(want.shape) and got.dtype == torch.int8
    gi, wi = _interior(got, b, oh, oh), _interior(want, b, oh, oh)
    np.testing.assert_array_equal(gi, wi)
    assert len(np.unique(gi)) > 20


@pytest.mark.parametrize("emit_i8", [True, False], ids=["int8-exit", "bf16-exit"])
@pytest.mark.parametrize("h", [7, 8], ids=["odd-h7", "even-h8"])
def test_ds_plain_on_kmajor_weights_equals_jax(rng, h, emit_i8):
    """The transition's plain version reading the engine's K-major copies
    (``fused.kmajor_copies``: ``w2q_nk`` the (c, 9c) transpose of the
    nine-tap matrix) equals the Pallas kernel, and itself without them."""
    from resnetc_tpu_torch.ops.cuda.fused import kmajor_copies

    b, cin, c, c4 = 2, 64, 16, 64
    jq, tq = _quantized_pair(_chain_block(rng, cin, c, c4, ds=True), ds=True)
    x = _chain_input(rng, b, h, cin)
    keys = ("w1q", "sw1", "b1", "w2q", "sw2", "b2", "w3q", "sw3", "b3", "wdq", "swd", "bd")
    want = jblock.downsample_block_s2_int8(
        jnp.asarray(x), *(jq[k] for k in keys), jnp.asarray(SCALES),
        h=h, w_sp=h, emit_i8=emit_i8, interpret=True,
    )
    targs = (torch.from_numpy(x), *(tq[k] for k in keys), torch.from_numpy(SCALES))
    nk = kmajor_copies(tq)
    assert sorted(nk) == ["w1q_nk", "w2q_nk", "w3q_nk", "wdq_nk"]
    got = tblock.downsample_block_s2_int8_plain(*targs, h=h, w_sp=h, emit_i8=emit_i8, **nk)
    oh = (h + 1) // 2
    gi, wi = _interior(got, b, oh, oh), _interior(want, b, oh, oh)
    np.testing.assert_array_equal(gi, wi)
    assert len(np.unique(gi)) > 20
    unpacked = tblock.downsample_block_s2_int8(*targs, h=h, w_sp=h, emit_i8=emit_i8)
    assert got.dtype == unpacked.dtype and torch.equal(got, unpacked)
    with pytest.raises(ValueError):  # a copy of another weight's shape
        tblock.downsample_block_s2_int8_plain(*targs, h=h, w_sp=h, w2q_nk=nk["w1q_nk"])


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_matmul_plain_matches_jax(rng, dtype):
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    x = rng.standard_normal((4, 96)).astype(np.float32)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    bias = rng.standard_normal(40).astype(np.float32)
    res = rng.standard_normal((4, 40)).astype(np.float32)
    for kw in ({}, {"relu": True}):
        want = jgemm.matmul(
            jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd), jnp.asarray(bias),
            jnp.asarray(res), out_dtype=jnp.float32, interpret=True, **kw,
        )
        got = tgemm.matmul(
            torch.from_numpy(x).to(td), torch.from_numpy(w).to(td), torch.from_numpy(bias),
            torch.from_numpy(res), out_dtype=torch.float32, **kw,
        )
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cpu_wrappers_launch_nothing(rng):
    """On CPU tensors the wrappers run their plain versions: no launch is
    counted and nothing is built."""
    _build.reset_launches()
    tgemm.matmul(torch.ones(2, 4), torch.ones(4, 3))
    assert sum(_build.LAUNCHES.values()) == 0
