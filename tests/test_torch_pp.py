"""The port's pixel-paired stage-0 path and TUNED.json overlay vs the JAX
package's.

Kernels: the plain versions of ``bottleneck_block_chained_int8_pp``,
``bottleneck_run_chained_int8_pp``, ``basic_block_chained_int8_pp`` and
``basic_run_chained_int8_pp`` (through their wrappers on CPU tensors)
against the Pallas kernels run with ``interpret=True``, on identical int8
inputs and weights made from a seeded numpy generator, at c = 64, h = 8
(wp 16, eight pair rows per padded row).  int8 and bf16 chain interiors are
compared for EQUALITY (exact integer dots, fp32 epilogues in the Pallas
order with XLA's fused multiply-adds); ring rows carry no meaning in the
JAX kernels and are not compared.  Each pp plain version must also equal
the port's standard plain version bit for bit, ring zeros included: the
pairing only regroups exact sums.

End to end: a ResNet-50 with stage blocks (2, 2, 2, 2) and a ResNet-18, both
at full width, 64x64, batch 2, 11 classes, with JAX's quantized tree and
scales carried across.  Tolerances as in ``tests/test_torch_serve.py``: the
stems are float convolutions summed in another order, so under FP32 logits
are held to a relative max error of 1e-4 and under BF16 (XLA keeps excess
precision across the stem's bf16 roundings) to 5e-2, with equal argmax.
Between the port's own routes (pp or standard, per block or fused) the
logits are EQUAL, and so are those of the engine's packed tree
(``pack_chain_kmajor``: K-major and pair-space weight copies, stacked
runs) and of the tree without them; the plain versions reading those
copies equal the Pallas kernels.

The overlay: the port's own copy of ``_apply_tuned_defaults`` must return
what the JAX one returns for the same file.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnetc_tpu.models import resnet as jresnet
from resnetc_tpu.ops.pallas import block as jblock
from resnetc_tpu.ops.pallas import fused as jfused
from resnetc_tpu.tensor import BF16 as JBF16
from resnetc_tpu.tensor import FP32 as JFP32
from resnetc_tpu_torch.checkpoint import variables_from_jax_numpy
from resnetc_tpu_torch.models import resnet as tresnet
from resnetc_tpu_torch.ops.cuda import block as tblock
from resnetc_tpu_torch.ops.cuda import fused as tfused
from resnetc_tpu_torch.tensor import BF16, FP32

KEYS = ("w1q", "sw1", "b1", "w2pq", "sw2p", "b2", "w3q", "sw3", "b3")
BASIC_KEYS = ("w1pq", "sw1p", "b1", "w2pq", "sw2p", "b2")
SCALES = np.asarray([0.03, 0.02, 0.03, 0.02], np.float32)
BASIC_SCALES = np.asarray([0.03, 0.02, 0.025], np.float32)
H, C = 8, 64


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _pair(tree):
    """numpy tree -> (jnp tree, torch tree)."""
    if isinstance(tree, dict):
        j, t = {}, {}
        for k, v in tree.items():
            j[k], t[k] = _pair(v)
        return j, t
    return jnp.asarray(tree), torch.from_numpy(np.array(tree))


def _entry(rng, shape):
    return {
        "weight": (rng.standard_normal(shape) * 0.1).astype(np.float32),
        "bias": (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32),
    }


def _bottleneck(rng, cin, *, proj=False):
    blk = {"conv1": _entry(rng, (cin, C)), "conv2": _entry(rng, (3, 3, C, C)),
           "conv3": _entry(rng, (C, 4 * C))}
    jb, tb = _pair(blk)
    jq, tq = jblock.quantize_chain_block(jb), tblock.quantize_chain_block(tb)
    if proj:
        jd, td = _pair(_entry(rng, (cin, 4 * C)))
        jds = jblock.quantize_ds_block(dict(jb, downsample=jd))
        tds = tblock.quantize_ds_block(dict(tb, downsample=td))
        for k in ("wdq", "swd", "bd"):
            jq[k], tq[k] = jds[k], tds[k]
    return jq, tq


def _basic(rng):
    jb, tb = _pair({"conv1": _entry(rng, (3, 3, C, C)), "conv2": _entry(rng, (3, 3, C, C))})
    return jblock.quantize_basic_block(jb), tblock.quantize_basic_block(tb)


def _chain_input(rng, b, cin):
    """A full int8 chain, ring rows included (garbage the kernels must
    ignore)."""
    hp, wp = tblock.chain_meta(b, H, H)
    return rng.integers(-127, 128, size=(b * hp * wp, cin), dtype=np.int8)


def _interior(a, b):
    hp, wp = tblock.chain_meta(b, H, H)
    return _np(a).reshape(b, hp, wp, -1)[:, 1 : 1 + H, 1 : 1 + H]


def _check(got, want_jax, want_std, b, emit_i8):
    """Interiors equal to the JAX pp kernel's; the whole buffer equal to the
    port's standard plain version's."""
    assert got.dtype == (torch.int8 if emit_i8 else torch.bfloat16)
    assert tuple(got.shape) == tuple(want_jax.shape)
    gi = _interior(got, b)
    np.testing.assert_array_equal(gi, _interior(want_jax, b))
    assert len(np.unique(gi)) > 20  # not a degenerate case
    assert got.dtype == want_std.dtype and torch.equal(got, want_std)


def _stacks(pairs, keys):
    """Per-key stacks of (jax, torch) quantized block pairs."""
    return ({k: jnp.stack([p[0][k] for p in pairs]) for k in keys},
            {k: torch.stack([p[1][k] for p in pairs]) for k in keys})


# ---------------------------------------------------------------------------
# Pair-space weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("what", ["block_diag", "pack_conv2", "pack_conv2_stacked"])
def test_pp_weights_equal_jax(rng, what):
    if what == "block_diag":
        w = rng.integers(-127, 128, size=(64, 256), dtype=np.int8)
        want = jblock._pp_block_diag(jnp.asarray(w))
        got = tblock._pp_block_diag(torch.from_numpy(w))
    elif what == "pack_conv2":
        w = rng.integers(-127, 128, size=(3 * C, 3 * C), dtype=np.int8)
        want = jblock._pp_pack_conv2(jnp.asarray(w), C)
        got = tblock._pp_pack_conv2(torch.from_numpy(w), C)
    else:  # one gather over a stack equals the per-block packs
        w = rng.integers(-127, 128, size=(3, 3 * C, 3 * C), dtype=np.int8)
        want = jnp.stack([jblock._pp_pack_conv2(jnp.asarray(wi), C) for wi in w])
        got = tblock._pp_pack_conv2(torch.from_numpy(w), C)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Kernels 5 and 6: bottleneck
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("emit_i8", [True, False], ids=["int8-exit", "bf16-exit"])
@pytest.mark.parametrize("proj", [False, True], ids=["identity", "proj"])
def test_pp_block_plain_equals_jax(rng, proj, emit_i8):
    b = 4
    cin = 64 if proj else 4 * C
    jq, tq = _bottleneck(rng, cin, proj=proj)
    x = _chain_input(rng, b, cin)
    kw = dict(h=H, w_sp=H, emit_i8=emit_i8)
    jkw, tkw = dict(kw), dict(kw)
    if proj:
        jkw.update({k: jq[k] for k in ("wdq", "swd", "bd")})
        tkw.update({k: tq[k] for k in ("wdq", "swd", "bd")})
    want = jblock.bottleneck_block_chained_int8_pp(
        jnp.asarray(x), *(jq[k] for k in KEYS), jnp.asarray(SCALES), interpret=True, **jkw,
    )
    targs = (torch.from_numpy(x), *(tq[k] for k in KEYS), torch.from_numpy(SCALES))
    got = tblock.bottleneck_block_chained_int8_pp(*targs, **tkw)
    _check(got, want, tblock.bottleneck_block_chained_int8_plain(*targs, **tkw), b, emit_i8)


def _run_inputs(rng, n_blocks, b, proj):
    pairs = [_bottleneck(rng, 4 * C) for _ in range(n_blocks)]
    scales = np.stack(
        [SCALES * np.float32(1.0 + 0.1 * i) for i in range(n_blocks)]
    ).astype(np.float32)
    scales[1:, 0] = scales[:-1, 3]  # block i's s_y is block i+1's s_x
    jkw, tkw = {}, {}
    jstk, tstk = _stacks(pairs, KEYS)
    cin = 4 * C
    if proj:
        cin = 64
        jp, tp = _bottleneck(rng, cin, proj=True)
        jstk["w1q"], tstk["w1q"] = jstk["w1q"][1:], tstk["w1q"][1:]
        jkw = dict(w1q0=jp["w1q"], **{k: jp[k] for k in ("wdq", "swd", "bd")})
        tkw = dict(w1q0=tp["w1q"], **{k: tp[k] for k in ("wdq", "swd", "bd")})
    return jstk, tstk, scales, jkw, tkw, _chain_input(rng, b, cin)


@pytest.mark.parametrize(
    "n_blocks,proj", [(2, False), (3, False), (3, True)], ids=["n2", "n3", "proj-n3"]
)
def test_pp_run_plain_equals_jax(rng, n_blocks, proj):
    b = 2
    jstk, tstk, scales, jkw, tkw, x = _run_inputs(rng, n_blocks, b, proj)
    for emit_i8 in (True, False):
        want = jblock.bottleneck_run_chained_int8_pp(
            jnp.asarray(x), *(jstk[k] for k in KEYS), jnp.asarray(scales),
            h=H, w_sp=H, emit_i8=emit_i8, interpret=True, **jkw,
        )
        targs = (torch.from_numpy(x), *(tstk[k] for k in KEYS), torch.from_numpy(scales))
        kw = dict(h=H, w_sp=H, emit_i8=emit_i8, **tkw)
        got = tblock.bottleneck_run_chained_int8_pp(*targs, **kw)
        _check(got, want, tblock.bottleneck_run_chained_int8_plain(*targs, **kw), b, emit_i8)


@pytest.mark.parametrize("emit_i8", [True, False], ids=["int8-exit", "bf16-exit"])
def test_pp_run_equals_pp_blocks_one_by_one(rng, emit_i8):
    b, n_blocks = 2, 3
    _, tstk, scales, _, _, x = _run_inputs(rng, n_blocks, b, False)
    got = tblock.bottleneck_run_chained_int8_pp(
        torch.from_numpy(x), *(tstk[k] for k in KEYS), torch.from_numpy(scales),
        h=H, w_sp=H, emit_i8=emit_i8,
    )
    y = torch.from_numpy(x)
    for i in range(n_blocks):
        y = tblock.bottleneck_block_chained_int8_pp(
            y, *(tstk[k][i] for k in KEYS), torch.from_numpy(scales[i]),
            h=H, w_sp=H, emit_i8=emit_i8 or i < n_blocks - 1,
        )
    assert got.dtype == y.dtype and torch.equal(got, y)


def test_pp_wrappers_reject_other_widths(rng):
    _, tq = _bottleneck(rng, 4 * C)
    x = torch.from_numpy(_chain_input(rng, 2, 4 * C))
    narrow = {k: v for k, v in tq.items()}
    narrow["w1q"] = tq["w1q"][:, :32]
    with pytest.raises(ValueError, match="c=64"):
        tblock.bottleneck_block_chained_int8_pp(
            x, *(narrow[k] for k in KEYS), torch.from_numpy(SCALES), h=H, w_sp=H,
        )


# ---------------------------------------------------------------------------
# Kernels 9 and 10: basic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("emit_i8", [True, False], ids=["int8-exit", "bf16-exit"])
def test_pp_basic_block_plain_equals_jax(rng, emit_i8):
    b = 4
    jq, tq = _basic(rng)
    x = _chain_input(rng, b, C)
    want = jblock.basic_block_chained_int8_pp(
        jnp.asarray(x), *(jq[k] for k in BASIC_KEYS), jnp.asarray(BASIC_SCALES),
        h=H, w_sp=H, emit_i8=emit_i8, interpret=True,
    )
    targs = (torch.from_numpy(x), *(tq[k] for k in BASIC_KEYS), torch.from_numpy(BASIC_SCALES))
    kw = dict(h=H, w_sp=H, emit_i8=emit_i8)
    got = tblock.basic_block_chained_int8_pp(*targs, **kw)
    _check(got, want, tblock.basic_block_chained_int8_plain(*targs, **kw), b, emit_i8)


def _basic_run_inputs(rng, n_blocks, b):
    pairs = [_basic(rng) for _ in range(n_blocks)]
    scales = np.stack(
        [BASIC_SCALES * np.float32(1.0 + 0.1 * i) for i in range(n_blocks)]
    ).astype(np.float32)
    scales[1:, 0] = scales[:-1, 2]
    jstk, tstk = _stacks(pairs, BASIC_KEYS)
    return jstk, tstk, scales, _chain_input(rng, b, C)


@pytest.mark.parametrize("n_blocks", [2, 3])
def test_pp_basic_run_plain_equals_jax(rng, n_blocks):
    b = 2
    jstk, tstk, scales, x = _basic_run_inputs(rng, n_blocks, b)
    for emit_i8 in (True, False):
        want = jblock.basic_run_chained_int8_pp(
            jnp.asarray(x), *(jstk[k] for k in BASIC_KEYS), jnp.asarray(scales),
            h=H, w_sp=H, emit_i8=emit_i8, interpret=True,
        )
        targs = (torch.from_numpy(x), *(tstk[k] for k in BASIC_KEYS), torch.from_numpy(scales))
        kw = dict(h=H, w_sp=H, emit_i8=emit_i8)
        got = tblock.basic_run_chained_int8_pp(*targs, **kw)
        _check(got, want, tblock.basic_run_chained_int8_plain(*targs, **kw), b, emit_i8)


@pytest.mark.parametrize("emit_i8", [True, False], ids=["int8-exit", "bf16-exit"])
def test_pp_basic_run_equals_pp_blocks_one_by_one(rng, emit_i8):
    b, n_blocks = 2, 3
    _, tstk, scales, x = _basic_run_inputs(rng, n_blocks, b)
    got = tblock.basic_run_chained_int8_pp(
        torch.from_numpy(x), *(tstk[k] for k in BASIC_KEYS), torch.from_numpy(scales),
        h=H, w_sp=H, emit_i8=emit_i8,
    )
    y = torch.from_numpy(x)
    for i in range(n_blocks):
        y = tblock.basic_block_chained_int8_pp(
            y, *(tstk[k][i] for k in BASIC_KEYS), torch.from_numpy(scales[i]),
            h=H, w_sp=H, emit_i8=emit_i8 or i < n_blocks - 1,
        )
    assert got.dtype == y.dtype and torch.equal(got, y)


def test_pp_basic_plain_on_packed_pair_weights_equals_jax(rng):
    """The plain versions reading the engine's pre-packed pair operands (the
    K-major copies of the pair-packed 3x3s that ``pack_chain_kmajor`` makes,
    and each block's view of them) equal the Pallas kernels."""
    b, n_blocks = 2, 2
    jstk, tstk, scales, x = _basic_run_inputs(rng, n_blocks, b)
    tree = {f"layer{s + 1}": {str(i): {k: tstk[k][i] for k in BASIC_KEYS}
                              for i in range(n_blocks)} for s in range(4)}
    packed = tfused.pack_chain_kmajor(tresnet.get_config("resnet18"), tree)
    nk = {k: packed["runs"]["layer1"][k] for k in ("w1pp_nk_s", "w2pp_nk_s")}
    blk = packed["layer1"]["1"]
    for emit_i8 in (True, False):
        kw = dict(h=H, w_sp=H, emit_i8=emit_i8)
        want = jblock.basic_run_chained_int8_pp(
            jnp.asarray(x), *(jstk[k] for k in BASIC_KEYS), jnp.asarray(scales),
            interpret=True, **kw,
        )
        targs = (torch.from_numpy(x), *(tstk[k] for k in BASIC_KEYS), torch.from_numpy(scales))
        got = tblock.basic_run_chained_int8_pp_plain(*targs, **kw, **nk)
        _check(got, want, tblock.basic_run_chained_int8_plain(*targs, **kw), b, emit_i8)
        want = jblock.basic_block_chained_int8_pp(
            jnp.asarray(x), *(jstk[k][1] for k in BASIC_KEYS), jnp.asarray(scales[1]),
            interpret=True, **kw,
        )
        bargs = (torch.from_numpy(x), *(blk[k] for k in BASIC_KEYS),
                 torch.from_numpy(scales[1]))
        got = tblock.basic_block_chained_int8_pp(*bargs, **kw, w1pp_nk=blk["w1pp_nk"],
                                                 w2pp_nk=blk["w2pp_nk"])
        _check(got, want, tblock.basic_block_chained_int8_plain(*bargs, **kw), b, emit_i8)


def test_pp_bottleneck_plain_on_packed_pair_weights_equals_jax(rng):
    """The bottleneck plain versions reading the engine's pre-packed pair
    operands (``pack_chain_kmajor``: the K-major block-diagonal 1x1s and
    pair-packed 3x3s of stage 0, stacked once, each block's views of them)
    equal the Pallas kernels: the projection block, an identity block, the
    run of blocks 1.. and all of layer1 as one run."""
    b, n_blocks = 2, 3
    pairs = [_bottleneck(rng, 64, proj=True)] + [_bottleneck(rng, 4 * C)
                                                 for _ in range(n_blocks - 1)]
    scales = np.stack(
        [SCALES * np.float32(1.0 + 0.1 * i) for i in range(n_blocks)]
    ).astype(np.float32)
    scales[1:, 0] = scales[:-1, 3]
    tree = {f"layer{s + 1}": {str(i): p[1] for i, p in enumerate(pairs)} for s in range(4)}
    packed = tfused.pack_chain_kmajor(tresnet.get_config("resnet50"), tree)
    layer = [packed["layer1"][str(i)] for i in range(n_blocks)]
    proj_keys = ("wdq", "swd", "bd")
    xs = {0: _chain_input(rng, b, 64), 1: _chain_input(rng, b, 4 * C)}
    for emit_i8 in (True, False):
        kw = dict(h=H, w_sp=H, emit_i8=emit_i8)
        for i in (0, 1):
            jq, blk = pairs[i][0], layer[i]
            extra = proj_keys if i == 0 else ()
            want = jblock.bottleneck_block_chained_int8_pp(
                jnp.asarray(xs[i]), *(jq[k] for k in KEYS), jnp.asarray(scales[i]),
                interpret=True, **kw, **{k: jq[k] for k in extra})
            targs = (torch.from_numpy(xs[i]), *(blk[k] for k in KEYS),
                     torch.from_numpy(scales[i]))
            tkw = dict(kw, **{k: blk[k] for k in extra})
            nk = tfused.kmajor_kwargs(blk, pp=True)
            assert sorted(nk) == sorted(["w1bd_nk", "w2pp_nk", "w3bd_nk"]
                                        + (["wdbd_nk"] if i == 0 else []))
            got = tblock.bottleneck_block_chained_int8_pp_plain(*targs, **tkw, **nk)
            _check(got, want, tblock.bottleneck_block_chained_int8_plain(*targs, **tkw), b,
                   emit_i8)
        for first in (0, 1):
            jblocks = [p[0] for p in pairs]
            jargs = [jnp.stack([q["w1q"] for q in jblocks[1:]]),
                     *(jnp.stack([q[k] for q in jblocks[first:]]) for k in KEYS[1:])]
            jkw = dict(w1q0=jblocks[0]["w1q"], **{k: jblocks[0][k] for k in proj_keys}) \
                if first == 0 else {}
            want = jblock.bottleneck_run_chained_int8_pp(
                jnp.asarray(xs[first]), *jargs, jnp.asarray(scales[first:]), interpret=True,
                **kw, **jkw)
            args, nk = tfused.pp_run_operands(layer, packed["runs"]["layer1"], first)
            tkw = dict(kw, w1q0=layer[0]["w1q"], **{k: layer[0][k] for k in proj_keys}) \
                if first == 0 else dict(kw)
            targs = (torch.from_numpy(xs[first]), *args, torch.from_numpy(scales[first:]))
            got = tblock.bottleneck_run_chained_int8_pp_plain(*targs, **tkw, **nk)
            _check(got, want, tblock.bottleneck_run_chained_int8_plain(*targs, **tkw), b,
                   emit_i8)


# ---------------------------------------------------------------------------
# The pp bodies' epilogues, as XLA evaluates them
# ---------------------------------------------------------------------------


def _pp_epilogue_forms():
    """Each pp body's epilogue written as the Pallas body writes it (jitted
    XLA on the CPU fuses it), beside the port's form: lane-tiled (1, 2c)
    vectors, the lane-varying mask m."""
    fma = tblock._fma

    def kh3(p, a):
        return fma(p[2], a[2], fma(p[0], a[0], p[1] * a[1]))

    def xla_kh3(p, a):
        return p[0] * a[0] + p[1] * a[1] + p[2] * a[2]

    return {
        # conv1 (block.py:1021-1026): max(z1*sw1 + b1, 0) * mask
        "conv1-masked": (lambda p, a, c, x, s, m: jnp.maximum(p[0] * a[0] + c, 0.0) * m,
                         lambda p, a, c, x, s, m: torch.relu(fma(p[0], a[0], c)) * m),
        # conv2 (block.py:1036-1046) and the basic conv1 (:1962): kh3 + b
        "kh3": (lambda p, a, c, x, s, m: jnp.maximum(xla_kh3(p, a) + c, 0.0),
                lambda p, a, c, x, s, m: torch.relu(kh3(p, a) + c)),
        # conv3, identity (block.py:1060-1063): y*a3; y + b3; y + x*s_res
        "conv3-identity": (lambda p, a, c, x, s, m: ((p[0] * a[0]) + c) + x * s,
                           lambda p, a, c, x, s, m: fma(x, s, fma(p[0], a[0], c))),
        # conv3, projection (block.py:1070-1073): y + (sc*ad + cd)
        "conv3-projection": (lambda p, a, c, x, s, m: ((p[0] * a[0]) + c) + (p[1] * a[1] + c * s),
                             lambda p, a, c, x, s, m: fma(p[0], a[0], c) + fma(p[1], a[1], c * s)),
        # basic conv2 (block.py:1967-1968): (kh3 + b2) + x*s_res
        "basic-out": (lambda p, a, c, x, s, m: (xla_kh3(p, a) + c) + x * s,
                      lambda p, a, c, x, s, m: fma(x, s, kh3(p, a) + c)),
    }


@pytest.mark.parametrize("form", list(_pp_epilogue_forms()))
def test_pp_epilogue_rounding_matches_xla(rng, form):
    xla_form, port_form = _pp_epilogue_forms()[form]
    rows, c2 = 2048, 2 * C
    p = rng.integers(-30000, 30000, size=(3, rows, c2)).astype(np.float32)
    a = np.tile((rng.random((3, 1, C)) * 3e-3).astype(np.float32), (1, 1, 2))
    bias = np.tile((rng.standard_normal((1, C)) * 0.5).astype(np.float32), (1, 2))
    x = rng.integers(-127, 128, size=(rows, c2)).astype(np.float32)
    s = np.float32(0.8391361)
    m = (rng.random((rows, c2)) > 0.2).astype(np.float32)
    want = np.asarray(jax.jit(xla_form)(*map(jnp.asarray, (p, a, bias, x, s, m))))
    args = [torch.from_numpy(np.asarray(v)) for v in (p, a, bias, x, s, m)]
    np.testing.assert_array_equal(port_form(*args).numpy(), want)


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------


def _model(name, stage_blocks=None):
    jcfg = jresnet.get_config(name, num_classes=11)
    tcfg = tresnet.get_config(name, num_classes=11)
    if stage_blocks is not None:
        jcfg = jcfg.__class__(**{**jcfg.__dict__, "stage_blocks": stage_blocks})
        tcfg = tcfg.__class__(**{**tcfg.__dict__, "stage_blocks": stage_blocks})
    jvars = jresnet.init(jcfg, jax.random.key(0))
    jfold = jresnet.fold_inference_params(jcfg, jvars)
    x = np.random.default_rng(9).standard_normal((2, 64, 64, 3)).astype(np.float32)
    return jcfg, tcfg, jfold, x


def _served(jcfg, jfold, x, policy):
    """JAX's quantized tree and scales, and the same carried to the port."""
    jscales = jfused.calibrate_chain_scales(jcfg, jfold, jnp.asarray(x), policy=policy)
    jq = jfused.quantize_chain(jcfg, jfold)
    tq = variables_from_jax_numpy(jax.tree.map(np.asarray, jq))
    tscales = variables_from_jax_numpy(jax.tree.map(np.asarray, jscales))
    return jq, jscales, tq, tscales


@pytest.fixture(scope="module")
def bottleneck_model():
    return _model("resnet50", (2, 2, 2, 2))


@pytest.fixture(scope="module")
def basic_model():
    return _model("resnet18")


@pytest.fixture(scope="module")
def fp32_trees(bottleneck_model, basic_model):
    out = {}
    for name, (jcfg, tcfg, jfold, x) in (("bottleneck", bottleneck_model),
                                          ("basic", basic_model)):
        out[name] = (tcfg, *_served(jcfg, jfold, x, JFP32)[2:], x)
    return out


def _rel_max(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _counting(kernels, counts):
    def spy(name, fn):
        def call(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)

        return call

    return kernels._replace(**{f: spy(f, getattr(kernels, f)) for f in kernels._fields})


def _forward(tcfg, tq, tscales, x, policy=FP32):
    counts: dict = {}
    got = tfused.fused_forward_int8_chain(
        tcfg, tq, tscales, torch.from_numpy(x), policy=policy,
        kernels=_counting(tfused.KERNELS, counts),
    )
    return got, counts


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("family", ["bottleneck", "basic"])
def test_pp_forward_matches_jax(bottleneck_model, basic_model, family, policy, monkeypatch):
    jcfg, tcfg, jfold, x = bottleneck_model if family == "bottleneck" else basic_model
    jpol, tpol = (JFP32, FP32) if policy == "fp32" else (JBF16, BF16)
    monkeypatch.setattr(jfused, "BASIC_DS_INT8", True)
    monkeypatch.setattr(tfused, "BASIC_DS_INT8", True)
    monkeypatch.setattr(jfused, "L1_PIXEL_PAIR", True)
    monkeypatch.setattr(tfused, "L1_PIXEL_PAIR", True)
    jq, jscales, tq, tscales = _served(jcfg, jfold, x, jpol)
    want = np.asarray(
        jfused.fused_forward_int8_chain(jcfg, jq, jscales, jnp.asarray(x), policy=jpol,
                                        interpret=True),
        np.float32,
    )
    got, counts = _forward(tcfg, tq, tscales, x, tpol)
    if family == "bottleneck":
        assert counts == {"stem_pool": 1, "block_pp": 1, "run_pp": 1, "ds": 3, "block": 3,
                          "matmul": 1}, counts
    else:
        assert counts == {"stem_pool": 1, "basic_run_pp": 1, "basic_ds": 3, "basic_block": 3,
                          "matmul": 1}, counts
    got = got.float().numpy()
    tol = 1e-4 if policy == "fp32" else 5e-2
    assert got.shape == (2, 11) and np.isfinite(got).all()
    assert _rel_max(got, want) < tol, _rel_max(got, want)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# (id, family, flags, launches of the route with L1_PIXEL_PAIR on)
ROUTES = [
    ("bottleneck-run", "bottleneck", {},
     {"stem_pool": 1, "block_pp": 1, "run_pp": 1, "ds": 3, "block": 3, "matmul": 1}),
    ("bottleneck-per-block", "bottleneck", {"RUN_FUSE_STAGES": ()},
     {"stem_pool": 1, "block_pp": 2, "ds": 3, "block": 3, "matmul": 1}),
    ("bottleneck-stage-fuse-proj", "bottleneck", {"STAGE_FUSE_PROJ": True},
     {"stem_pool": 1, "run_pp": 1, "ds": 3, "block": 3, "matmul": 1}),
    ("basic-run", "basic", {},
     {"stem_pool": 1, "basic_run_pp": 1, "basic_ds": 3, "basic_block": 3, "matmul": 1}),
    ("basic-per-block", "basic", {"BASIC_RUN_FUSE_STAGES": ()},
     {"stem_pool": 1, "basic_block_pp": 2, "basic_ds": 3, "basic_block": 3, "matmul": 1}),
]


@pytest.mark.parametrize(
    "family,flags,want", [r[1:] for r in ROUTES], ids=[r[0] for r in ROUTES]
)
def test_pp_routes_equal_the_standard_route(fp32_trees, family, flags, want, monkeypatch):
    """Each route under L1_PIXEL_PAIR takes the kernels it should, and its
    logits equal, bit for bit, those of the same flags without pairing
    and of the slice-1/2 standard route (the basic transitions int8, as
    served)."""
    tcfg, tq, tscales, x = fp32_trees[family]
    monkeypatch.setattr(tfused, "BASIC_DS_INT8", True)
    base, _ = _forward(tcfg, tq, tscales, x)
    for k, v in flags.items():
        monkeypatch.setattr(tfused, k, v)
    std, std_counts = _forward(tcfg, tq, tscales, x)
    assert not any(k.endswith("_pp") for k in std_counts), std_counts
    monkeypatch.setattr(tfused, "L1_PIXEL_PAIR", True)
    pp, counts = _forward(tcfg, tq, tscales, x)
    assert counts == want, counts
    assert torch.equal(pp, std) and torch.equal(pp, base)


@pytest.mark.parametrize("run_stages", [(0,), ()], ids=["run", "per-block"])
def test_pp_basic_packed_tree_equals_unpacked(fp32_trees, run_stages, monkeypatch):
    """ResNet-18's engine tree (``pack_chain_kmajor``: the pre-packed pair
    operands of stage 0, the stacked runs) gives the logits of the tree
    without them, bit for bit, on the pixel-paired route."""
    tcfg, tq, tscales, x = fp32_trees["basic"]
    packed = tfused.pack_chain_kmajor(tcfg, tq)
    monkeypatch.setattr(tfused, "BASIC_DS_INT8", True)
    monkeypatch.setattr(tfused, "L1_PIXEL_PAIR", True)
    monkeypatch.setattr(tfused, "BASIC_RUN_FUSE_STAGES", run_stages)
    got, counts = _forward(tcfg, packed, tscales, x)
    want, _ = _forward(tcfg, tq, tscales, x)
    assert counts == ({"basic_run_pp": 1} if run_stages else {"basic_block_pp": 2}) | {
        "stem_pool": 1, "basic_ds": 3, "basic_block": 3, "matmul": 1}, counts
    assert torch.equal(got, want)


@pytest.mark.parametrize("stage_fuse_proj", [False, True], ids=["run", "stage-fuse-proj"])
@pytest.mark.parametrize("pp", [True, False], ids=["pp", "standard"])
def test_bottleneck_packed_tree_equals_unpacked(fp32_trees, pp, stage_fuse_proj, monkeypatch):
    """A cut ResNet-50's engine tree (``pack_chain_kmajor``: the K-major
    copies of every block and transition, stage 0's pair copies and its
    stacked run) gives the logits of the tree without them, bit for bit,
    with L1_PIXEL_PAIR on and off."""
    tcfg, tq, tscales, x = fp32_trees["bottleneck"]
    packed = tfused.pack_chain_kmajor(tcfg, tq)
    assert "w2q_nk" in packed["layer2"]["0"] and "w2pp_nk_s" in packed["runs"]["layer1"]
    monkeypatch.setattr(tfused, "L1_PIXEL_PAIR", pp)
    monkeypatch.setattr(tfused, "STAGE_FUSE_PROJ", stage_fuse_proj)
    got, counts = _forward(tcfg, packed, tscales, x)
    want, _ = _forward(tcfg, tq, tscales, x)
    suffix = "_pp" if pp else ""
    stage0 = {"run" + suffix: 1} if stage_fuse_proj else {"block" + suffix: 1, "run" + suffix: 1}
    want_counts = {"stem_pool": 1, "ds": 3, "block": 3, "matmul": 1}
    for k, v in stage0.items():
        want_counts[k] = want_counts.get(k, 0) + v
    assert counts == want_counts, counts
    assert torch.equal(got, want)


def test_pp_is_inert_on_a_wide_stage_0(monkeypatch):
    """wide_resnet50_2 runs stage 0 at c = 128: L1_PIXEL_PAIR must route it
    through the standard kernels, per block (no run fusion under
    L1_PIXEL_PAIR at c != 64, fused.py:1250), with the same logits."""
    jcfg, tcfg, jfold, x = _model("wide_resnet50_2", (2, 1, 1, 1))
    _, _, tq, tscales = _served(jcfg, jfold, x[:1], JFP32)
    base, base_counts = _forward(tcfg, tq, tscales, x[:1])
    assert base_counts == {"stem_pool": 1, "block": 1, "run": 1, "ds": 3,
                           "matmul": 1}, base_counts
    monkeypatch.setattr(tfused, "L1_PIXEL_PAIR", True)
    pp, counts = _forward(tcfg, tq, tscales, x[:1])
    assert counts == {"stem_pool": 1, "block": 2, "ds": 3, "matmul": 1}, counts
    assert torch.equal(pp, base)


def test_unported_hybrid_prefix_still_raises(fp32_trees, monkeypatch):
    """The hybrid prefix under L1_PIXEL_PAIR.  The name dates from before
    the prefix was ported and is kept so the test's history stays one;
    what it checks now: the prefix takes stage 0 itself, so no pixel-paired
    kernel runs, and a stage set that is not a prefix still raises.  Its
    JAX parity is in tests/test_torch_calib.py."""
    tcfg, tq, tscales, x = fp32_trees["bottleneck"]
    monkeypatch.setattr(tfused, "L1_PIXEL_PAIR", True)
    monkeypatch.setattr(tfused, "HYBRID_XLA_STAGES", (0,))
    _, counts = _forward(tcfg, tq, tscales, x)
    rest = sum(tcfg.stage_blocks[1:]) - 3
    assert counts == {"ds": 3, "block": rest, "matmul": 1}, counts
    monkeypatch.setattr(tfused, "HYBRID_XLA_STAGES", (0, 2))
    with pytest.raises(ValueError, match="HYBRID_XLA_STAGES"):
        _forward(tcfg, tq, tscales, x)


# ---------------------------------------------------------------------------
# The TUNED.json overlay
# ---------------------------------------------------------------------------

OVERLAYS = {
    "valid": {"flags": {"L1_PIXEL_PAIR": True, "BASIC_DS_INT8": True,
                        "RUN_FUSE_STAGES": [0, 1], "STEM_CIN_PAD": 4}},
    "unknown-keys": {"flags": {"NOT_A_FLAG": 1, "VMEM_CAP_BYTES": 7, "L1_PIXEL_PAIR": True},
                     "evidence": {}},
    "bool-as-int": {"flags": {"STEM_CIN_PAD": True, "L1_PIXEL_PAIR": 1,
                              "DS_CONV3_ONEDOT": True}},
    "list-with-non-int": {"flags": {"RUN_FUSE_STAGES": [0, "1"], "HYBRID_XLA_STAGES": [0, True],
                                    "BASIC_RUN_FUSE_STAGES": [1, 2], "DS_PAIR_DMA_STAGES": 1}},
    "non-dict-json": [1, 2, 3],
    "flags-not-a-dict": {"flags": ["L1_PIXEL_PAIR"]},
    "missing-file": None,
    "no-tuned": {"flags": {"L1_PIXEL_PAIR": True}},
    "repo-tuned-json": "repo",
}


@pytest.mark.parametrize("case", list(OVERLAYS))
def test_tuned_overlay_matches_jax(case, tmp_path, monkeypatch):
    for flag in jfused._TUNABLE_FLAGS:  # both modules' globals come back after
        monkeypatch.setattr(jfused, flag, getattr(jfused, flag))
        monkeypatch.setattr(tfused, flag, getattr(tfused, flag))
    monkeypatch.delenv("RESNETC_NO_TUNED", raising=False)
    monkeypatch.delenv("RESNETC_TUNED_JSON", raising=False)
    data = OVERLAYS[case]
    if case == "no-tuned":
        monkeypatch.setenv("RESNETC_NO_TUNED", "1")
    if data != "repo":
        path = tmp_path / "TUNED.json"
        if data is not None:
            path.write_text(json.dumps(data))
        monkeypatch.setenv("RESNETC_TUNED_JSON", str(path))
    assert tfused._TUNABLE_FLAGS == jfused._TUNABLE_FLAGS
    want = jfused._apply_tuned_defaults()
    got = tfused._apply_tuned_defaults()
    assert got == want
    for k, v in got.items():
        assert getattr(tfused, k) == v and type(getattr(tfused, k)) is type(v)
    if case in ("valid", "unknown-keys", "bool-as-int", "list-with-non-int", "repo-tuned-json"):
        assert got  # the case applies something
    else:
        assert got == {}


def test_repo_tuned_json_is_served_on_import():
    """Imported without RESNETC_NO_TUNED, the port serves the repository's
    TUNED.json: the pixel-paired stage 0 and the int8 basic transitions."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RESNETC_NO_TUNED", "RESNETC_TUNED_JSON")}
    code = ("from resnetc_tpu_torch.ops.cuda import fused; "
            "print(sorted(fused.TUNED_DEFAULTS.items()), fused.L1_PIXEL_PAIR)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[('BASIC_DS_INT8',", "True),", "('L1_PIXEL_PAIR',", "True)]",
                                  "True"], out.stdout
