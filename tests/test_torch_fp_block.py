"""The port's bf16 / fp32 bottleneck blocks and its ``pallas_block`` backend
vs the JAX package's.

The plain versions of ``bottleneck_block_chained`` (kernel table row 17)
and ``bottleneck_block_fused`` (row 18) — what the wrappers run for a CPU
tensor — against the Pallas kernels run with ``interpret=True``, on the same
inputs made from a seeded numpy generator, at the JAX tests' sizes
(``tests/test_pallas.py``: b = 2, c = 16, h = 9 and h = 7, where the chain
layout shares the pad column, wp = w + 1); the chained block as a 3-block
chain whose input ring holds NaN, interiors compared.  Then
``fused_forward(block_fusion=True)`` against JAX's on a bottleneck net cut to
(2, 2, 1, 1) blocks at stem width 16, 32x32, batch 2 (one eligible block in
each of stages 0 and 1), with its kernel counts, and the engines.

The plain versions sum each dot in float64 and round once, so they give
the same bits at any thread count.  The fp32 kernel's own order (the
split-fp32 tile of ``csrc/tf32x3_tile.cuh``: three TF32 products per fp32
product, every 32 values of K drained into one fp32 total) is emulated here
at ResNet-152's widest block and held to the plain version; the kernel reads
each weight's split (N, K) copy (``w1_nk``, ``w2_nk``, ``w3_nk``), which the
FP32 engine keeps and passes (a wrong-shaped copy raises).

Tolerances.  Every dot sums in another order than XLA's.  FP32 outputs and
logits are held to a relative max error (max |error| / max |want|) of 1e-4
(measured: ~1.5e-7 for the blocks).  Under BF16 z1 and z2 are rounded to
bf16 inside each block, so one summation-order difference that straddles a
rounding boundary moves a value by a bf16 step (2^-8 relative): blocks are
held to 1e-2 (measured: 0 at these inputs, 2.7e-5 at other seeds) and
logits to 5e-2 with equal argmax, as in
``tests/test_torch_backends.py``.
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
from resnetc_tpu.ops.pallas import block as jblock
from resnetc_tpu.ops.pallas import fused as jfused
from resnetc_tpu.tensor import BF16 as JBF16
from resnetc_tpu.tensor import FP32 as JFP32
from resnetc_tpu_torch import serve as tserve
from resnetc_tpu_torch.models import resnet as tresnet
from resnetc_tpu_torch.ops.cuda import block as tblock
from resnetc_tpu_torch.ops.cuda import fused as tfused
from resnetc_tpu_torch.ops.cuda import gemm as tgemm
from resnetc_tpu_torch.tensor import BF16, FP32

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
POLICIES = {"fp32": (JFP32, FP32), "bf16": (JBF16, BF16)}
BLOCK_TOL = {"fp32": 1e-4, "bf16": 1e-2}
CUT = dict(name="cut_fusion", block="bottleneck", stage_blocks=(2, 2, 1, 1), num_classes=9,
           stem_width=16)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


def _pair(a: np.ndarray, dtype: str):
    """The same values in both frameworks (rounded to bf16 once, by JAX)."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(a).astype(jd)
    return j, torch.from_numpy(np.array(_np(j))).to(td)


def _rel_max(got, want) -> float:
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _block_inputs(h: int, dtype: str, *, b: int = 2, c: int = 16):
    """x (b, h, h, 4c) and one block's weights, as in tests/test_pallas.py:
    (jax args, torch args) with x and the weights in ``dtype``, fp32 biases."""
    rng = np.random.default_rng(1234 + h)
    c4 = 4 * c
    x = rng.standard_normal((b, h, h, c4)).astype(np.float32)
    shapes = [((c4, c), True), ((c,), False), ((3, 3, c, c), True), ((c,), False),
              ((c, c4), True), ((c4,), False)]
    jargs, targs = [], []
    for shape, is_weight in shapes:
        a = rng.standard_normal(shape).astype(np.float32)
        if is_weight:
            j, t = _pair(a * 0.1, dtype)
        else:
            j, t = jnp.asarray(a), torch.from_numpy(a)
        jargs.append(j)
        targs.append(t)
    return _pair(x, dtype), jargs, targs


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("h", [9, 7])
def test_chained_block_matches_pallas(h, dtype):
    """Three chained blocks: one pad, three kernels, one unpad.  The input's
    ring rows hold NaN in both frameworks; it must never reach an interior
    value, and the port writes zeros to the output's ring rows."""
    b = 2
    (jx, tx), jargs, targs = _block_inputs(h, dtype)
    hp, wp = tblock.chain_meta(b, h, h)
    ring = ~tblock.pad_for_chain(torch.ones((b, h, h, 1))).bool()[:, 0]

    jr = jblock.pad_for_chain(jx)
    jr = jr.at[np.nonzero(ring.numpy())[0]].set(jnp.nan)
    for _ in range(3):
        jr = jblock.bottleneck_block_chained(jr, *jargs, h=h, w_sp=h, interpret=True)
    want = _np(jblock.unpad_from_chain(jr, b, h, h))

    tr = tblock.pad_for_chain(tx)
    tr[ring] = float("nan")
    for _ in range(3):
        tr = tblock.bottleneck_block_chained(tr, *targs, h=h, w_sp=h)
    assert tr.dtype == DTYPES[dtype][1] and tr.shape == (b * hp * wp, 4 * 16)
    got = _np(tblock.unpad_from_chain(tr, b, h, h))
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert _rel_max(got, want) < BLOCK_TOL[dtype], _rel_max(got, want)
    assert not tr[ring].any()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("h", [9, 7])
def test_fused_block_matches_pallas(h, dtype):
    (jx, tx), jargs, targs = _block_inputs(h, dtype)
    want = _np(jblock.bottleneck_block_fused(jx, *jargs, interpret=True))
    got = tblock.bottleneck_block_fused(tx, *targs)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert _rel_max(_np(got), want) < BLOCK_TOL[dtype], _rel_max(_np(got), want)
    # The NHWC block is the chained block between one pad and one unpad.
    chained = tblock.bottleneck_block_chained(tblock.pad_for_chain(tx), *targs, h=h, w_sp=h)
    assert torch.equal(tblock.unpad_from_chain(chained, 2, h, h), got)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_block_does_not_depend_on_the_thread_count(dtype):
    """Both plain forms at one and at four threads: the same bits (each dot
    sums in float64 and rounds to fp32 once; at this size fp32 matmuls gave
    other bits at four threads)."""
    h, b = 7, 2
    (_, tx), _, targs = _block_inputs(h, dtype, c=256)
    threads = torch.get_num_threads()
    out = {}
    try:
        for n in (1, 4):
            torch.set_num_threads(n)
            chained = tblock.bottleneck_block_chained_plain(tblock.pad_for_chain(tx), *targs,
                                                            h=h, w_sp=h)
            out[n] = (chained, tblock.bottleneck_block_fused_plain(tx, *targs))
    finally:
        torch.set_num_threads(threads)
    for one, four in zip(out[1], out[4]):
        assert torch.equal(one, four)
    assert torch.equal(tblock.unpad_from_chain(out[1][0], b, h, h), out[1][1])


def _split_sum(a: torch.Tensor, w_nk: torch.Tensor, span: int = 32) -> torch.Tensor:
    """The split-fp32 tile's sum of ``a`` (M, K) against the split copy
    ``w_nk`` (2, N, K): per span of 32 values of K the three TF32 products
    (``a_lo*w_hi + a_hi*w_lo + a_hi*w_hi``) summed exactly (float64 here),
    rounded to fp32 and drained into one fp32 total in K order."""
    ah, al = tgemm.tf32_split(a)
    wh, wl = w_nk[0].double().t(), w_nk[1].double().t()
    total = torch.zeros(a.shape[0], w_nk.shape[1])
    for k0 in range(0, a.shape[1], span):
        s = slice(k0, k0 + span)
        part = (al[:, s].double() @ wh[s] + ah[:, s].double() @ wl[s]
                + ah[:, s].double() @ wh[s])
        total = total + part.float()
    return total


def _split_block(x, w1, b1, w2, b2, w3, b3):
    """The fp32 kernel's three launches on an NHWC interior, in plain
    PyTorch: conv1 and conv3 as split sums, conv2 as one split sum over K
    = 9c in (kh, kw, ci) order (the im2col loader's), the same epilogues."""
    bsz, h, w_sp, c4 = x.shape
    c = w1.shape[-1]
    z1 = torch.relu(_split_sum(x.reshape(-1, c4), tgemm.pack_nk(w1)) + b1)
    zp = torch.nn.functional.pad(z1.reshape(bsz, h, w_sp, c), (0, 0, 1, 1, 1, 1))
    cols = torch.cat([zp[:, u:u + h, v:v + w_sp] for u in range(3) for v in range(3)], dim=-1)
    z2 = torch.relu(_split_sum(cols.reshape(-1, 9 * c), tgemm.pack_nk(w2)) + b2)
    y = _split_sum(z2, tgemm.pack_nk(w3)) + b3 + x.reshape(-1, c4)
    return torch.relu(y).reshape(x.shape)


def test_split_sum_order_close_to_plain_at_the_widest_block():
    """ResNet-152's widest block (c = 512: conv2 sums K = 4608, conv1 K =
    2048) on a few pixels: the kernel's sum order within 1e-4 of max |plain|
    of the float64 plain version (the card's tolerance, FP_BLOCK_TOL)."""
    rng = np.random.default_rng(19)
    c, c4 = 512, 2048

    def t(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    x = t((1, 3, 3, c4), 1.0)
    ws = (t((c4, c), c4**-0.5), t((c,), 0.1), t((3, 3, c, c), (9 * c) ** -0.5), t((c,), 0.1),
          t((c, c4), c**-0.5), t((c4,), 0.1))
    want = tblock.bottleneck_block_fused_plain(x, *ws)
    got = _split_block(x, *ws)
    rel = _rel_max(got.numpy(), want.numpy())
    assert rel <= 1e-4, rel
    assert not torch.equal(got, want)  # another order: the emulation is not the plain sum


@pytest.mark.parametrize("form", ["chained", "fused"])
@pytest.mark.parametrize("bad", ["w1_nk", "w2_nk", "w3_nk"])
def test_wrong_shaped_copy_raises(form, bad):
    h = 9
    (_, tx), _, targs = _block_inputs(h, "fp32")
    w1, _, w2, _, w3, _ = targs
    nk = {"w1_nk": tgemm.pack_nk(w1), "w2_nk": tgemm.pack_nk(w2), "w3_nk": tgemm.pack_nk(w3)}
    # The unsplit (N, K) copy, or the (K, N) weight split: never the (2, N, K) copy.
    nk[bad] = nk[bad][0] if bad == "w2_nk" else tgemm.pack_nk(nk[bad][0])
    if form == "chained":
        call = lambda: tblock.bottleneck_block_chained(  # noqa: E731
            tblock.pad_for_chain(tx), *targs, h=h, w_sp=h, **nk)
    else:
        call = lambda: tblock.bottleneck_block_fused(tx, *targs, **nk)  # noqa: E731
    with pytest.raises(ValueError, match=bad):
        call()


def test_bf16_block_refuses_the_fp32_copies():
    (_, tx), _, targs = _block_inputs(9, "bf16")
    with pytest.raises(ValueError, match="only fp32"):
        tblock.bottleneck_block_fused(tx, *targs, w2_nk=tgemm.pack_nk(targs[2].float()))


def _counting(kernels, counts):
    def spy(name, fn):
        def call(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)

        return call

    return kernels._replace(**{f: spy(f, getattr(kernels, f)) for f in kernels._fields})


@pytest.fixture(scope="module")
def cut_net():
    """(jcfg, tcfg, port variables, port folded tree, the folded tree in JAX)."""
    jcfg, tcfg = jresnet.ResNetConfig(**CUT), tresnet.ResNetConfig(**CUT)
    tvars = tresnet.init(tcfg, torch.Generator().manual_seed(5))
    tfold = tresnet.fold_inference_params(tcfg, tvars)
    return jcfg, tcfg, tvars, tfold, jax.tree.map(lambda t: jnp.asarray(t.numpy()), tfold)


def _x(seed):
    return np.random.default_rng(seed).standard_normal((2, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_block_fusion_forward_matches_jax(cut_net, policy):
    jcfg, tcfg, _, tfold, jfold = cut_net
    jpol, tpol = POLICIES[policy]
    x = _x(7)
    want = np.asarray(jfused.fused_forward(jcfg, jfold, jnp.asarray(x), policy=jpol,
                                           block_fusion=True, interpret=True), np.float32)
    counts: dict = {}
    got = tfused.fused_forward(tcfg, tfold, torch.from_numpy(x), policy=tpol, block_fusion=True,
                               kernels=_counting(tfused.KERNELS, counts))
    # Stages 0 and 1 each chain their block 1; the four projection blocks'
    # 1x1s, the fc, the stride-1 3x3 of block 0 and the stride-2 3x3s as in
    # the pallas backend.
    assert counts == {"max_pool": 1, "conv3x3_s1": 1, "conv_s2": 3, "matmul": 13,
                      "fp_block": 2}, counts
    assert got.dtype == tpol.output
    got = got.float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    tol = 1e-4 if policy == "fp32" else 5e-2
    assert _rel_max(got, want) < tol, _rel_max(got, want)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_fp32_pallas_block_engine_passes_its_copies(cut_net):
    """The FP32 ``pallas_block`` engine keeps the split (N, K) copies of
    every block weight and hands them to ``fp_block``; its forward equals
    the same forward on the tree without them and stays within 1e-4 of the
    JAX package's ``pallas_block`` engine."""
    jcfg, tcfg, tvars, tfold, _ = cut_net
    x = _x(10)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        teng = tserve.InferenceEngine(tcfg, tvars, policy=FP32, backend="pallas_block",
                                      device="cpu")
        jeng = jserve.InferenceEngine(jcfg, jax.tree.map(lambda t: jnp.asarray(t.numpy()), tvars),
                                      policy=JFP32, backend="pallas_block")
    seen = []

    def fp_block(*args, **kwargs):
        seen.append({k: v for k, v in kwargs.items() if k.endswith("_nk")})
        return tfused.KERNELS.fp_block(*args, **kwargs)

    got = tfused.fused_forward(tcfg, teng.folded, torch.from_numpy(x), policy=FP32,
                               block_fusion=True,
                               kernels=tfused.KERNELS._replace(fp_block=fp_block))
    blocks = [teng.folded["layer1"]["1"], teng.folded["layer2"]["1"]]
    assert len(seen) == len(blocks)
    for nk, blk in zip(seen, blocks):
        for i in (1, 2, 3):
            assert nk[f"w{i}_nk"] is blk[f"conv{i}"]["weight_nk"]
    bare = tfused.fused_forward(tcfg, tfold, torch.from_numpy(x), policy=FP32, block_fusion=True)
    assert torch.equal(got, bare)
    assert torch.equal(got, teng.logits(x))
    want = np.asarray(jeng.logits(jnp.asarray(x)), np.float32)
    assert _rel_max(got.numpy(), want) < 1e-4, _rel_max(got.numpy(), want)


def test_pallas_block_engine_classify_matches_jax_engine(cut_net):
    jcfg, tcfg, tvars, _, _ = cut_net
    x = _x(8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the deprecation notice
        jeng = jserve.InferenceEngine(jcfg, jax.tree.map(lambda t: jnp.asarray(t.numpy()), tvars),
                                      policy=JFP32, backend="pallas_block")
    with pytest.warns(UserWarning, match="reference path"):
        teng = tserve.InferenceEngine(tcfg, tvars, policy=FP32, backend="pallas_block",
                                      device="cpu")
    np.testing.assert_array_equal(teng.classify(x), jeng.classify(jnp.asarray(x)))
    got, want = teng.logits(x).numpy(), np.asarray(jeng.logits(jnp.asarray(x)))
    assert _rel_max(got, want) < 1e-4, _rel_max(got, want)


def test_pallas_block_on_a_basic_net_is_the_pallas_route():
    """No basic block is eligible: the same kernels, the same logits."""
    cfg = tresnet.ResNetConfig("cut_basic", "basic", (1, 2, 1, 1), num_classes=10,
                               stem_width=16)
    tvars = tresnet.init(cfg, torch.Generator().manual_seed(6))
    x = _x(9)
    out = {}
    for backend in ("pallas", "pallas_block"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            eng = tserve.InferenceEngine(cfg, tvars, policy=FP32, backend=backend, device="cpu")
        counts: dict = {}
        logits = tfused.fused_forward(cfg, eng.folded, torch.from_numpy(x), policy=FP32,
                                      block_fusion=backend == "pallas_block",
                                      kernels=_counting(tfused.KERNELS, counts))
        assert torch.equal(logits, eng.logits(x))
        out[backend] = (logits, counts)
    assert out["pallas"][1] == out["pallas_block"][1]
    assert "fp_block" not in out["pallas_block"][1]
    assert torch.equal(out["pallas"][0], out["pallas_block"][0])
