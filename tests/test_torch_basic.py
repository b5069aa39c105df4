"""The port's basic-family int8 path (ResNet-18/34) vs the JAX package's.

Kernels: the plain versions of ``basic_block_chained_int8``,
``basic_run_chained_int8`` and ``basic_ds_block_s2_int8`` against the Pallas
kernels run with ``interpret=True``, on identical int8 inputs and weights
made from a seeded numpy generator.  int8 and bf16 chain interiors are
compared for EQUALITY: the integer dots are exact and every fp32 epilogue
keeps the Pallas kernel's order of operations.  Ring rows carry no meaning
and are not compared.

End to end: a tiny basic config (3,2,2,2 blocks, stem width 16, 11
classes) at 64x64, batch 2, with JAX's weights and calibration scales
carried across, so the path goes through the stage-0 run, the three
stride-2 transitions and one stride-1 block per later stage.  The JAX side
runs with ``BASIC_DS_INT8`` on (its TUNED.json value; the suite pins code
defaults).  Tolerances as in ``tests/test_torch_serve.py``: the stems are
float convolutions summed in another order, so under FP32 logits are held
to a relative max error of 1e-4 and stage taps to a mean error of 1e-3 of
their mean magnitude; under BF16 (XLA keeps excess precision across the
stem's bf16 roundings) to 5e-2 for both, with equal argmax.
"""

from __future__ import annotations

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

SCALES = np.asarray([4.0 / 127, 3.0 / 127, 5.0 / 127], np.float32)
KEYS = ("w1pq", "sw1p", "b1", "w2pq", "sw2p", "b2")
DS_KEYS = ("w1pq", "sw1", "b1", "w2pq", "sw2p", "b2", "wdq", "swd", "bd")
TINY = dict(name="tiny_basic", block="basic", stage_blocks=(3, 2, 2, 2), num_classes=11,
            stem_width=16)


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


def _basic_block(rng, c):
    return {"conv1": _entry(rng, (3, 3, c, c)), "conv2": _entry(rng, (3, 3, c, c))}


def _basic_ds_block(rng, cin, c):
    return {"conv1": _entry(rng, (3, 3, cin, c)), "conv2": _entry(rng, (3, 3, c, c)),
            "downsample": _entry(rng, (1, 1, cin, c))}


def _quantized_pair(blk, *, ds=False):
    jb, tb = _pair(blk)
    if ds:
        return jblock.quantize_basic_ds_block(jb), tblock.quantize_basic_ds_block(tb)
    return jblock.quantize_basic_block(jb), tblock.quantize_basic_block(tb)


def _chain_input(rng, b, h, w, cin):
    """A full int8 chain, ring rows included (garbage the kernels must
    ignore)."""
    hp, wp = tblock.chain_meta(b, h, w)
    return rng.integers(-127, 128, size=(b * hp * wp, cin), dtype=np.int8)


def _interior(a, b, h, w):
    hp, wp = tblock.chain_meta(b, h, w)
    return _np(a).reshape(b, hp, wp, -1)[:, 1 : 1 + h, 1 : 1 + w]


def _assert_interiors_equal(got, want, b, h, w, emit_i8):
    assert got.dtype == (torch.int8 if emit_i8 else torch.bfloat16)
    assert tuple(got.shape) == tuple(want.shape)
    gi, wi = _interior(got, b, h, w), _interior(want, b, h, w)
    np.testing.assert_array_equal(gi, wi)
    # Not a degenerate case: the outputs spread over many values.
    assert len(np.unique(gi)) > 20


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("ds", [False, True], ids=["block", "ds"])
def test_quantize_basic_equals_jax(rng, ds):
    blk = _basic_ds_block(rng, 16, 32) if ds else _basic_block(rng, 32)
    jq, tq = _quantized_pair(blk, ds=ds)
    jflat, tflat = _flat(jq), _flat(tq)
    assert set(jflat) == set(tflat)
    for k in jflat:
        np.testing.assert_array_equal(_np(tflat[k]), np.asarray(jflat[k]), err_msg=k)
        assert tflat[k].dtype == (torch.int8 if jflat[k].dtype == jnp.int8 else torch.float32), k


# (id, h, c, emit_i8)
BLOCK_CASES = [
    ("c16-h8", 8, 16, True),
    ("c32-h8", 8, 32, True),
    ("c32-h7", 7, 32, True),
    ("c16-h7-bf16", 7, 16, False),
    ("c32-h8-bf16", 8, 32, False),
]


@pytest.mark.parametrize(
    "h,c,emit_i8", [case[1:] for case in BLOCK_CASES], ids=[case[0] for case in BLOCK_CASES]
)
def test_basic_block_plain_equals_jax(rng, h, c, emit_i8):
    b = 2
    jq, tq = _quantized_pair(_basic_block(rng, c))
    x = _chain_input(rng, b, h, h, c)
    want = jblock.basic_block_chained_int8(
        jnp.asarray(x), *(jq[k] for k in KEYS), jnp.asarray(SCALES),
        h=h, w_sp=h, emit_i8=emit_i8, interpret=True,
    )
    got = tblock.basic_block_chained_int8(
        torch.from_numpy(x), *(tq[k] for k in KEYS), torch.from_numpy(SCALES),
        h=h, w_sp=h, emit_i8=emit_i8,
    )
    _assert_interiors_equal(got, want, b, h, h, emit_i8)


def _run_inputs(rng, n_blocks, b, h, c):
    pairs = [_quantized_pair(_basic_block(rng, c)) for _ in range(n_blocks)]
    scales = np.stack(
        [SCALES * np.float32(1.0 + 0.1 * i) for i in range(n_blocks)]
    ).astype(np.float32)
    scales[1:, 0] = scales[:-1, 2]  # block i's s_y is block i+1's s_x
    return pairs, scales, _chain_input(rng, b, h, h, c)


@pytest.mark.parametrize("n_blocks", [2, 3])
def test_basic_run_plain_equals_jax(rng, n_blocks):
    b, h, c = 2, 8, 16
    pairs, scales, x = _run_inputs(rng, n_blocks, b, h, c)
    for emit_i8 in (True, False):
        want = jblock.basic_run_chained_int8(
            jnp.asarray(x), *(jnp.stack([p[0][k] for p in pairs]) for k in KEYS),
            jnp.asarray(scales), h=h, w_sp=h, emit_i8=emit_i8, interpret=True,
        )
        got = tblock.basic_run_chained_int8(
            torch.from_numpy(x), *(torch.stack([p[1][k] for p in pairs]) for k in KEYS),
            torch.from_numpy(scales), h=h, w_sp=h, emit_i8=emit_i8,
        )
        _assert_interiors_equal(got, want, b, h, h, emit_i8)


@pytest.mark.parametrize("emit_i8", [True, False], ids=["int8-exit", "bf16-exit"])
def test_basic_run_equals_blocks_one_by_one(rng, emit_i8):
    """The run is the same blocks applied in turn: int8 between blocks at
    row i's s_y, the last block's exit as asked."""
    b, h, c, n_blocks = 2, 7, 16, 3
    pairs, scales, x = _run_inputs(rng, n_blocks, b, h, c)
    tqs = [p[1] for p in pairs]
    got = tblock.basic_run_chained_int8(
        torch.from_numpy(x), *(torch.stack([q[k] for q in tqs]) for k in KEYS),
        torch.from_numpy(scales), h=h, w_sp=h, emit_i8=emit_i8,
    )
    y = torch.from_numpy(x)
    for i, q in enumerate(tqs):
        last = i == n_blocks - 1
        y = tblock.basic_block_chained_int8(
            y, *(q[k] for k in KEYS), torch.from_numpy(scales[i]),
            h=h, w_sp=h, emit_i8=emit_i8 or not last,
        )
    assert got.dtype == y.dtype and torch.equal(got, y)


def _kmajor(tq: dict) -> dict:
    return {k + "_nk": tq[k].t().contiguous() for k in ("w1pq", "w2pq")}


@pytest.mark.parametrize("h,c,emit_i8", [(8, 16, True), (7, 32, False)],
                         ids=["c16-h8", "c32-h7-bf16"])
def test_basic_block_plain_on_kmajor_weights_equals_jax(rng, h, c, emit_i8):
    """The plain version reading the engine's K-major copies (what the int8
    tile reads) equals the Pallas kernel."""
    b = 2
    jq, tq = _quantized_pair(_basic_block(rng, c))
    x = _chain_input(rng, b, h, h, c)
    want = jblock.basic_block_chained_int8(
        jnp.asarray(x), *(jq[k] for k in KEYS), jnp.asarray(SCALES),
        h=h, w_sp=h, emit_i8=emit_i8, interpret=True,
    )
    args = (torch.from_numpy(x), *(tq[k] for k in KEYS), torch.from_numpy(SCALES))
    got = tblock.basic_block_chained_int8_plain(*args, h=h, w_sp=h, emit_i8=emit_i8,
                                                **_kmajor(tq))
    _assert_interiors_equal(got, want, b, h, h, emit_i8)
    with pytest.raises(ValueError):  # a copy of another shape
        tblock.basic_block_chained_int8_plain(*args, h=h, w_sp=h, w1pq_nk=tq["w1pq"][:, :c])


def test_basic_run_plain_on_kmajor_weights_equals_jax(rng):
    b, h, c, n_blocks = 2, 8, 16, 2
    pairs, scales, x = _run_inputs(rng, n_blocks, b, h, c)
    nk = {k + "_nk_s": torch.stack([p[1][k].t().contiguous() for p in pairs])
          for k in ("w1pq", "w2pq")}
    for emit_i8 in (True, False):
        want = jblock.basic_run_chained_int8(
            jnp.asarray(x), *(jnp.stack([p[0][k] for p in pairs]) for k in KEYS),
            jnp.asarray(scales), h=h, w_sp=h, emit_i8=emit_i8, interpret=True,
        )
        got = tblock.basic_run_chained_int8(
            torch.from_numpy(x), *(torch.stack([p[1][k] for p in pairs]) for k in KEYS),
            torch.from_numpy(scales), h=h, w_sp=h, emit_i8=emit_i8, **nk,
        )
        _assert_interiors_equal(got, want, b, h, h, emit_i8)


@pytest.mark.parametrize(
    "h,w", [(10, 10), (7, 7), (10, 14)], ids=["direct-10x10", "generic-7x7", "nonsquare-10x14"]
)
def test_basic_ds_plain_equals_jax(rng, h, w):
    b, cin, c = 2, 16, 32
    oh, ow = (h + 1) // 2, (w + 1) // 2
    jq, tq = _quantized_pair(_basic_ds_block(rng, cin, c), ds=True)
    x = _chain_input(rng, b, h, w, cin)
    for emit_i8 in (True, False):
        want = jblock.basic_ds_block_s2_int8(
            jnp.asarray(x), *(jq[k] for k in DS_KEYS), jnp.asarray(SCALES),
            h=h, w_sp=w, emit_i8=emit_i8, interpret=True,
        )
        got = tblock.basic_ds_block_s2_int8(
            torch.from_numpy(x), *(tq[k] for k in DS_KEYS), torch.from_numpy(SCALES),
            h=h, w_sp=w, emit_i8=emit_i8,
        )
        _assert_interiors_equal(got, want, b, oh, ow, emit_i8)


@pytest.mark.parametrize(
    "h,w", [(10, 10), (7, 7), (10, 14)], ids=["direct-10x10", "generic-7x7", "nonsquare-10x14"]
)
def test_basic_ds_on_kmajor_copies_equals_jax(rng, h, w):
    """The transition reading the engine's K-major copies (what the int8 tile
    reads: conv1's nine taps without the packing's zero rows, conv2, the
    projection) equals the Pallas kernel, x's ring random bytes."""
    b, cin, c = 2, 16, 32
    oh, ow = (h + 1) // 2, (w + 1) // 2
    jq, tq = _quantized_pair(_basic_ds_block(rng, cin, c), ds=True)
    nk = tfused.basic_ds_kmajor_copies(tq)
    assert tuple(nk["w1pq_nk"].shape) == (c, 9 * cin)
    x = _chain_input(rng, b, h, w, cin)
    args = (torch.from_numpy(x), *(tq[k] for k in DS_KEYS), torch.from_numpy(SCALES))
    for emit_i8 in (True, False):
        want = jblock.basic_ds_block_s2_int8(
            jnp.asarray(x), *(jq[k] for k in DS_KEYS), jnp.asarray(SCALES),
            h=h, w_sp=w, emit_i8=emit_i8, interpret=True,
        )
        got = tblock.basic_ds_block_s2_int8(*args, h=h, w_sp=w, emit_i8=emit_i8, **nk)
        _assert_interiors_equal(got, want, b, oh, ow, emit_i8)
    with pytest.raises(ValueError):  # the copy of the packing with its zero rows
        tblock.basic_ds_block_s2_int8(*args, h=h, w_sp=w,
                                      w1pq_nk=tq["w1pq"].reshape(12 * cin, c).t())


# The epilogue forms of the Pallas kernels, as XLA evaluates them (jitted on
# the CPU, where the tests run the Pallas kernels) and as the port rounds
# them: each ``a*b + c`` one fused multiply-add (``block._fma``).
def _epilogue_forms():
    fma = tblock._fma

    def kh3(p, a):
        return fma(p[2], a[2], fma(p[0], a[0], p[1] * a[1]))

    return {
        # basic conv1 / bottleneck conv2: relu(kh3 + c)
        "kh3": (lambda p, a, c, x, s: p[0] * a[0] + p[1] * a[1] + p[2] * a[2] + c,
                lambda p, a, c, x, s: kh3(p, a) + c),
        # basic conv2: relu(kh3 + c2 + x*s_res)
        "kh3-identity": (lambda p, a, c, x, s: (p[0] * a[0] + p[1] * a[1] + p[2] * a[2] + c)
                         + x * s,
                         lambda p, a, c, x, s: fma(x, s, kh3(p, a) + c)),
        # basic ds out: relu((y_all + sc*ad) + cd)
        "kh3-projection": (lambda p, a, c, x, s: (p[0] * a[0] + p[1] * a[1] + p[2] * a[2] + c)
                           + p[1] * a[2] + s,
                           lambda p, a, c, x, s: fma(p[1], a[2], kh3(p, a) + c) + s),
        # every 1x1 / 9-tap conv: relu(acc*a + c)
        "affine": (lambda p, a, c, x, s: p[0] * a[0] + c,
                   lambda p, a, c, x, s: fma(p[0], a[0], c)),
        # bottleneck conv3, identity and projection shortcut
        "conv3-identity": (lambda p, a, c, x, s: (p[0] * a[0] + c) + x * s,
                           lambda p, a, c, x, s: fma(x, s, fma(p[0], a[0], c))),
        "conv3-projection": (lambda p, a, c, x, s: (p[0] * a[0] + c) + (p[1] * a[1] + c * s),
                             lambda p, a, c, x, s: fma(p[0], a[0], c) + fma(p[1], a[1], c * s)),
    }


@pytest.mark.parametrize("form", list(_epilogue_forms()))
def test_epilogue_rounding_matches_xla(rng, form):
    xla_form, port_form = _epilogue_forms()[form]
    rows, c = 2048, 64
    p = rng.integers(-30000, 30000, size=(3, rows, c)).astype(np.float32)
    a = (rng.random((3, 1, c)) * 3e-3).astype(np.float32)
    bias = (rng.standard_normal((1, c)) * 0.5).astype(np.float32)
    x = rng.integers(-127, 128, size=(rows, c)).astype(np.float32)
    s = np.float32(0.8391361)
    want = np.asarray(jax.jit(xla_form)(*map(jnp.asarray, (p, a, bias, x, s))))
    args = [torch.from_numpy(np.asarray(v)) for v in (p, a, bias, x, s)]
    np.testing.assert_array_equal(port_form(*args).numpy(), want)
    # The test has power: rounding each product apart gives other values.
    unfused = xla_form(*args).numpy()
    assert (unfused != want).mean() > 0.05


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    jcfg = jresnet.ResNetConfig(**TINY)
    tcfg = tresnet.ResNetConfig(**TINY)
    jvars = jresnet.init(jcfg, jax.random.key(11))
    np_vars = jax.tree.map(np.asarray, jvars)
    x = np.random.default_rng(5).standard_normal((2, 64, 64, 3)).astype(np.float32)
    return jcfg, tcfg, jvars, variables_from_jax_numpy(np_vars), x


def _rel_max(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _counting(kernels, counts):
    def spy(name, fn):
        def call(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)

        return call

    return kernels._replace(**{f: spy(f, getattr(kernels, f)) for f in kernels._fields})


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_basic_int8_chain_forward_matches_jax(setup, policy, monkeypatch):
    jcfg, tcfg, jvars, tvars, x = setup
    monkeypatch.setattr(jfused, "BASIC_DS_INT8", True)
    monkeypatch.setattr(tfused, "BASIC_DS_INT8", True)
    jpol, tpol = (JFP32, FP32) if policy == "fp32" else (JBF16, BF16)
    jfold = jresnet.fold_inference_params(jcfg, jvars)
    jscales = jfused.calibrate_chain_scales(jcfg, jfold, jnp.asarray(x), policy=jpol)
    jq = jfused.quantize_chain(jcfg, jfold)
    jtaps: list = []
    want = np.asarray(
        jfused.fused_forward_int8_chain(
            jcfg, jq, jscales, jnp.asarray(x), policy=jpol, interpret=True, stage_taps=jtaps,
        ),
        np.float32,
    )

    # JAX's quantized tree fits the port unchanged: its keys, layouts and
    # values are the port's (XLA's BN fold differs from PyTorch's in the
    # last ulp, which would move a per-channel weight scale).
    tq = variables_from_jax_numpy(jax.tree.map(np.asarray, jq))
    tscales = variables_from_jax_numpy(jax.tree.map(np.asarray, jscales))
    ttaps: list = []
    counts: dict = {}
    got = tfused.fused_forward_int8_chain(
        tcfg, tq, tscales, torch.from_numpy(x), policy=tpol, stage_taps=ttaps,
        kernels=_counting(tfused.KERNELS, counts),
    ).numpy()
    assert counts == {"stem_pool": 1, "basic_run": 1, "basic_ds": 3, "basic_block": 3,
                      "matmul": 1}, counts

    tol = 1e-4 if policy == "fp32" else 5e-2
    tap_tol = 1e-3 if policy == "fp32" else 5e-2
    assert got.shape == (2, 11) and np.isfinite(got).all()
    assert _rel_max(got, want) < tol, _rel_max(got, want)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert len(ttaps) == len(jtaps) == 4
    for stage, (gt, wt) in enumerate(zip(ttaps, jtaps)):
        gt, wt = gt.numpy(), np.asarray(wt)
        assert gt.shape == wt.shape, stage
        assert np.mean(np.abs(gt - wt)) <= tap_tol * np.mean(np.abs(wt)), stage


def test_basic_calibration_and_quantize_chain_match_jax(setup):
    jcfg, tcfg, jvars, tvars, x = setup
    jfold = jresnet.fold_inference_params(jcfg, jvars)
    tfold = variables_from_jax_numpy(jax.tree.map(np.asarray, jfold))
    want = jfused.calibrate_chain_scales(jcfg, jfold, jnp.asarray(x), policy=JFP32)
    got = tfused.calibrate_chain_scales(tcfg, tfold, torch.from_numpy(x), policy=FP32)
    for layer, blocks in want.items():
        for b, sites in blocks.items():
            assert set(got[layer][b]) == set(sites) == {"in", "z1"}
            for k, v in sites.items():
                np.testing.assert_allclose(
                    float(got[layer][b][k]), float(v), rtol=1e-5, err_msg=f"{layer}.{b}.{k}"
                )
    jflat = _flat(jfused.quantize_chain(jcfg, jfold))
    tflat = _flat(tfused.quantize_chain(tcfg, tfold))
    assert set(jflat) == set(tflat)
    for k in jflat:
        np.testing.assert_array_equal(_np(tflat[k]), np.asarray(jflat[k]), err_msg=k)


@pytest.mark.parametrize("run_stages", [(0,), (0, 1, 2, 3), ()], ids=["run0", "runs", "per-block"])
def test_basic_packed_tree_forward_equals_unpacked(setup, monkeypatch, run_stages):
    """The engine's tree (``pack_chain_kmajor``: per-block K-major copies,
    each stage's run stacked once) gives the logits of the tree without
    them, bit for bit, on every run route; every entry of the unpacked tree
    is shared, not copied."""
    _, tcfg, _, tvars, x = setup
    tfold = tresnet.fold_inference_params(tcfg, tvars)
    scales = tfused.calibrate_chain_scales(tcfg, tfold, torch.from_numpy(x))
    tq = tfused.quantize_chain(tcfg, tfold)
    packed = tfused.pack_chain_kmajor(tcfg, tq)
    flat, pflat = _flat(tq), _flat(packed)
    assert all(pflat[k] is flat[k] for k in flat)
    for stage, nb in enumerate(tcfg.stage_blocks):
        run = packed["runs"][f"layer{stage + 1}"]
        ids = range(0 if stage == 0 else 1, nb)
        assert run["w2pq_nk_s"].is_contiguous() and len(run["w2pq_nk_s"]) == len(ids)
        for j, i in enumerate(ids):
            blk = packed[f"layer{stage + 1}"][str(i)]
            assert torch.equal(blk["w1pq_nk"], blk["w1pq"].t()), (stage, i)
            assert blk["w2pq_nk"].data_ptr() == run["w2pq_nk_s"][j].data_ptr()  # a view
            assert torch.equal(run["sw2p_s"][j], blk["sw2p"])
    monkeypatch.setattr(tfused, "BASIC_DS_INT8", True)
    monkeypatch.setattr(tfused, "BASIC_RUN_FUSE_STAGES", run_stages)
    got = tfused.fused_forward_int8_chain(tcfg, packed, scales, torch.from_numpy(x))
    want = tfused.fused_forward_int8_chain(tcfg, tq, scales, torch.from_numpy(x))
    assert torch.equal(got, want)


def test_pack_chain_kmajor_gives_each_basic_transition_its_copies(setup):
    """Each stage transition of the engine's tree carries the three K-major
    copies of its weights: conv1 (c, 9cin) without the zero rows [3cin,
    4cin) of each kernel row of the (3, 4cin, c) packing, conv2 (3c, 3c),
    the projection (c, cin); the stride-1 blocks carry none of them."""
    _, tcfg, _, tvars, _ = setup
    tq = tfused.quantize_chain(tcfg, tresnet.fold_inference_params(tcfg, tvars))
    packed = tfused.pack_chain_kmajor(tcfg, tq)
    for stage, nb in enumerate(tcfg.stage_blocks):
        for i in range(nb):
            blk = packed[f"layer{stage + 1}"][str(i)]
            if stage == 0 or i > 0:
                assert "wdq_nk" not in blk and "sw1" not in blk, (stage, i)
                continue
            _, four_cin, c = blk["w1pq"].shape
            cin = four_cin // 4
            assert not blk["w1pq"][:, 3 * cin :].any()  # the dropped rows are the zero ones
            taps = blk["w1pq"][:, : 3 * cin].reshape(9 * cin, c)
            want = {"w1pq_nk": taps.t(), "w2pq_nk": blk["w2pq"].t(), "wdq_nk": blk["wdq"].t()}
            for k, v in want.items():
                assert blk[k].is_contiguous() and blk[k].dtype == torch.int8, (stage, k)
                assert tuple(blk[k].shape) == tuple(v.shape), (stage, k)
                assert torch.equal(blk[k], v), (stage, k)
            assert tuple(blk["w1pq_nk"].shape) == (c, 9 * cin)
            assert "w1pq_nk" not in tq[f"layer{stage + 1}"]["0"]  # the input tree unchanged


def test_basic_ds_int8_off_runs_and_equals_plain(setup, monkeypatch):
    """BASIC_DS_INT8=False (the code default): each stride-2 transition
    through the conv kernels between the int8 chains, the same as the
    forward on the plain versions (the JAX parity of this route is in
    tests/test_torch_backends.py)."""
    _, tcfg, _, tvars, x = setup
    tfold = tresnet.fold_inference_params(tcfg, tvars)
    scales = tfused.calibrate_chain_scales(tcfg, tfold, torch.from_numpy(x))
    tq = tfused.quantize_chain(tcfg, tfold)
    monkeypatch.setattr(tfused, "BASIC_DS_INT8", False)
    counts: dict = {}
    got = tfused.fused_forward_int8_chain(tcfg, tq, scales, torch.from_numpy(x),
                                          kernels=_counting(tfused.KERNELS, counts))
    assert counts == {"stem_pool": 1, "basic_run": 1, "conv_s2": 3, "conv3x3_s1": 3,
                      "matmul": 4, "basic_block": 3}, counts
    want = tfused.fused_forward_int8_chain(tcfg, tq, scales, torch.from_numpy(x),
                                           kernels=tfused.PLAIN)
    assert got.shape == (2, 11) and torch.isfinite(got).all()
    assert torch.equal(got, want)
