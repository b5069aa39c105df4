"""The grouped family (ResNeXt) on the ``int8_chain`` route, on the CPU.

The two grouped block kernels' plain versions (``block.grouped_block_int8``
and ``block.grouped_ds_block_s2_int8``, through their ops and directly)
against an independent composition of ``F.conv2d(groups=)`` on
integer-valued int8 data, with power-of-two scales so that every sum and
epilogue is exact in float64; the grouped 3x3's packing (whole groups a
column tile, no dense W x W weight); a tiny ResNeXt served through
``InferenceEngine(backend="int8_chain")`` against the benchmark's plain
reference (``gpubench/references/resnext.py``) at a stated ``class_gap``,
which the int4 control and an altered answer fail; the reference against
``references.resnet`` and the port's shapes; the work counts; the route's
launches, its export and its data-parallel entry; and the backends that
still refuse grouped models.  The file imports no JAX.
"""

from __future__ import annotations

import math
import socket
import warnings

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gpubench import check, control, inputs, work_grouped
from gpubench.references import resnet as ref_resnet
from gpubench.references import resnext as ref_resnext
from resnetc_tpu_torch import export as texport
from resnetc_tpu_torch.models import resnet as tresnet
from resnetc_tpu_torch.ops.cuda import block, fused
from resnetc_tpu_torch.serve import InferenceEngine

KEYS = ("w1q", "sw1", "b1", "w2q", "sw2", "b2", "w3q", "sw3", "b3")
#: [s_x, s_z1, s_z2, s_y]: powers of two, so every folded constant is exact.
SCALES = torch.tensor([2.0**-3, 2.0**-2, 2.0**-2, 2.0**-3])

#: A tiny ResNeXt: 4 groups of 8 channels at stage 0 (64 at stage 3).
TINY = dict(name="tiny_resnext", model=None, block="bottleneck", stage_blocks=[2, 1, 1, 1],
            stem_width=64, width_per_group=8, groups=4, num_classes=10, image_size=64,
            reference="resnext", calib_images=8,
            bn={"scale": [0.5, 1.0], "last_scale": [0.0, 0.1], "shift": 0.1,
                "mean_shift": 0.1, "var_scale": [0.8, 1.25]})
#: The widest class_gap the tiny engine may read against the reference
#: (images whose served class is not the reference's best lie within this
#: many standard deviations of the image's logits).  At the fixture's seed
#: the engine reads 0.17, the int4 control 1.83 and an altered answer 2.00
#: (0.05-0.24, 1.83-2.90 and 2.00-3.04 over three seeds).
TINY_CLASS_GAP = 0.5


def _tiny_cfg() -> tresnet.ResNetConfig:
    return tresnet.ResNetConfig(name=TINY["name"], block="bottleneck",
                                stage_blocks=tuple(TINY["stage_blocks"]),
                                num_classes=TINY["num_classes"], stem_width=TINY["stem_width"],
                                groups=TINY["groups"], width_per_group=TINY["width_per_group"])


def _ints(gen, *shape, lo=-127, hi=128):
    return torch.randint(lo, hi, shape, generator=gen).to(torch.int8)


def _pow2(gen, n, lo=-9, hi=-6):
    return 2.0 ** torch.randint(lo, hi, (n,), generator=gen).float()


def _block(gen, cin, w, c, gw, proj):
    """int8 weights, power-of-two per-channel scales, biases on a 1/16 grid."""
    q = {"w1q": _ints(gen, cin, w), "sw1": _pow2(gen, w), "b1": _ints(gen, w).float() / 16,
         "w2q": _ints(gen, 3, 3, gw, w), "sw2": _pow2(gen, w), "b2": _ints(gen, w).float() / 16,
         "w3q": _ints(gen, w, c), "sw3": _pow2(gen, c), "b3": _ints(gen, c).float() / 16}
    if proj:
        q.update(wdq=_ints(gen, cin, c), swd=_pow2(gen, c), bd=_ints(gen, c).float() / 16)
    return q


def _composition(xi, q, groups, stride, emit_i8):
    """The block from torch's convolutions in float64: NHWC int8 interior in,
    NHWC out (int8 at s_y, or the float values before the bf16 cast)."""
    s_x, s_z1, s_z2, s_y = (float(s) for s in SCALES)
    s_y = s_y if emit_i8 else 1.0

    def conv(t, w_hwio, stride=1, padding=0, groups=1):
        w = w_hwio.double().permute(3, 2, 0, 1)
        return F.conv2d(t.permute(0, 3, 1, 2).double(), w, stride=stride, padding=padding,
                        groups=groups).permute(0, 2, 3, 1)

    def q8(t):
        return torch.clamp(torch.round(t), -127, 127)

    x = xi.double()
    z1 = q8(torch.relu(conv(x, q["w1q"][None, None]) * q["sw1"].double() * (s_x / s_z1)
                       + q["b1"].double() / s_z1))
    z2 = q8(torch.relu(conv(z1, q["w2q"], stride, 1, groups) * q["sw2"].double() * (s_z1 / s_z2)
                       + q["b2"].double() / s_z2))
    y = conv(z2, q["w3q"][None, None]) * q["sw3"].double() * (s_z2 / s_y) + q["b3"].double() / s_y
    if "wdq" in q:
        y = y + (conv(x, q["wdq"][None, None], stride) * q["swd"].double() * (s_x / s_y)
                 + q["bd"].double() / s_y)
    else:
        y = y + x * (s_x / s_y)
    y = torch.relu(y)
    return q8(y) if emit_i8 else y


# (id, h, cin, W, C, gw, stride, proj, emit_i8)
CASES = [
    ("s1-identity-gw8", 8, 64, 64, 64, 8, 1, False, True),
    ("s1-proj-gw8-h7", 7, 32, 64, 64, 8, 1, True, True),
    ("s1-identity-gw64", 6, 128, 128, 128, 64, 1, False, True),
    ("s1-proj-gw64-bf16", 5, 64, 128, 128, 64, 1, True, False),
    ("s1-identity-gw16-bf16", 7, 64, 64, 64, 16, 1, False, False),
    ("s2-gw8-h9", 9, 32, 64, 64, 8, 2, True, True),
    ("s2-gw64-h8", 8, 64, 128, 256, 64, 2, True, True),
    ("s2-gw32-h7-bf16", 7, 64, 64, 128, 32, 2, True, False),
]


@pytest.mark.parametrize("h,cin,w,c,gw,stride,proj,emit_i8", [k[1:] for k in CASES],
                         ids=[k[0] for k in CASES])
def test_plain_equals_a_grouped_conv_composition(h, cin, w, c, gw, stride, proj, emit_i8):
    gen = torch.Generator().manual_seed(h * 1000 + w + gw)
    q = _block(gen, cin, w, c, gw, proj or stride == 2)
    b = 2
    hp, wp = block.chain_meta(b, h, h)
    x = _ints(gen, b * hp * wp, cin)
    xi = x.reshape(b, hp, wp, cin)[:, 1:1 + h, 1:1 + h]
    want = _composition(xi, q, w // gw, stride, emit_i8)
    kw = dict(h=h, w_sp=h, emit_i8=emit_i8)
    if stride == 1:
        args = (x, *(q[k] for k in KEYS), SCALES)
        extra = dict(wdq=q.get("wdq"), swd=q.get("swd"), bd=q.get("bd"))
        got = [block.grouped_block_int8_plain(*args, **kw, **extra),
               block.grouped_block_int8(*args, **kw, **extra,
                                        **fused.grouped_kmajor_copies(q))]
    else:
        args = (x, *(q[k] for k in KEYS), q["wdq"], q["swd"], q["bd"], SCALES)
        got = [block.grouped_ds_block_s2_int8_plain(*args, **kw),
               block.grouped_ds_block_s2_int8(*args, **kw, **fused.grouped_kmajor_copies(q))]
    oh = (h - 1) // stride + 1
    for out in got:
        assert out.dtype == (torch.int8 if emit_i8 else torch.bfloat16)
        interior = block.unpad_from_chain(out, b, oh, oh)
        if emit_i8:
            assert torch.equal(interior.double(), want)
            assert int(torch.unique(interior).numel()) > 20
        else:
            assert torch.equal(interior, want.to(torch.bfloat16))
        ring = out.reshape(b, oh + 2, -1, c).float().clone()
        ring[:, 1:1 + oh, 1:1 + oh] = 0
        assert not bool(ring.any())


@pytest.mark.parametrize("gw,bn,factor", [(8, 32, 4), (16, 32, 2), (32, 32, 1), (64, 64, 1)])
def test_the_grouped_tile_pads_conv2_at_most_four_times(gw, bn, factor):
    """ResNeXt-101 32x8d's group widths: the column tile holds whole groups
    and reads only their channels, so the tensor cores do bn / gw times the
    grouped MACs (4x at most), and the packed weight is (W, 9 bn), never a
    dense (W, 9 W)."""
    assert block.grouped_tile_n(gw) == bn and bn // gw == factor <= 4
    w = 32 * gw
    gen = torch.Generator().manual_seed(gw)
    w2q = _ints(gen, 3, 3, gw, w, lo=1)
    nk = block.pack_grouped_nk(w2q)
    assert tuple(nk.shape) == (w, 9 * bn)
    assert int((nk != 0).sum()) == w2q.numel()  # every weight once, zeros elsewhere
    n = 37 % w
    t, g = n // bn, n // gw
    row = nk[n].reshape(9, bn)
    cols = torch.arange(bn) + t * bn
    inside = (cols >= g * gw) & (cols < (g + 1) * gw)
    assert bool((row[:, inside] != 0).all()) and not bool(row[:, ~inside].any())
    assert torch.equal(row[:, inside], w2q[:, :, :, n].reshape(9, gw))


@pytest.mark.parametrize("gw", [128, 3, 48])
def test_group_widths_the_kernel_does_not_take_raise(gw):
    with pytest.raises(ValueError, match="group widths"):
        block.grouped_tile_n(gw)


def test_the_reference_at_one_group_is_the_resnet_reference():
    cfg = dict(TINY, groups=1, width_per_group=64, stage_blocks=[1, 2, 1, 1], image_size=32,
               reference="resnet")
    gen = inputs.generator(11, torch.device("cpu"))
    calib = inputs.images(gen, 2, 32, {"scales": [2, 7], "amplitude": 1.5, "offset": 1.5})
    params = inputs.weights(cfg, gen, calib)
    assert ref_resnext.param_shapes(cfg) == ref_resnet.param_shapes(cfg)
    with torch.no_grad():
        assert torch.equal(ref_resnext.forward(cfg, params, calib),
                           ref_resnet.forward(cfg, params, calib))


def test_the_reference_shapes_are_the_ports_resnext101():
    cfg = {"block": "bottleneck", "stage_blocks": [3, 4, 23, 3], "stem_width": 64,
           "width_per_group": 8, "groups": 32, "num_classes": 1000}
    want = tresnet.param_shapes(tresnet.get_config("resnext101_32x8d"))
    got = ref_resnext.param_shapes(cfg)
    assert list(got) == list(want)
    for k, s in got.items():
        assert (tuple(s[i] for i in (2, 3, 1, 0)) if len(s) == 4 else s) == want[k], k
    params = sum(math.prod(s) for k, s in got.items()
                 if not k.endswith(("running_mean", "running_var")))
    assert params == 88_791_336


def test_the_grouped_model_flops_are_32_83_gflop():
    cfg = {"name": "resnext101_32x8d", "block": "bottleneck", "stage_blocks": [3, 4, 23, 3],
           "stem_width": 64, "width_per_group": 8, "groups": 32, "num_classes": 1000,
           "image_size": 224}
    assert work_grouped.model_flops(cfg) == 32_828_030_976
    # One forward's launches add up to the model, less the stem and the fc.
    b, side = 4, 56
    ops = 2 * b * (112 * 112 * 49 * 3 * 64 + 2048 * 1000)
    for name, stage, cin, inner, cout, stride, _ in ref_resnext.blocks(cfg):
        hp, wp = block.chain_meta(b, side, side)
        shapes = [[b * hp * wp, cin], [inner, cin], [inner], [inner], [inner, 9 * 32],
                  [inner], [inner], [cout, inner]]
        count = work_grouped.grouped_ds_block if stride == 2 else work_grouped.grouped_block
        ops += count(cfg, b, shapes)[0]
        side = ref_resnext.stage_size(cfg, stage)
    assert ops == b * work_grouped.model_flops(cfg)
    ungrouped = dict(cfg, groups=1, width_per_group=64, stage_blocks=[3, 8, 36, 3])
    from gpubench import work

    assert work_grouped.model_flops(ungrouped) == work.model_flops(ungrouped)


@pytest.fixture(scope="module")
def tiny():
    """The tiny ResNeXt's benchmark weights and images, its engine on the
    CPU (the plain versions), and the reference's logits."""
    dev = torch.device("cpu")
    gen = inputs.generator(3_000_000_123, dev)
    spec = {"scales": [2, 7, 28], "amplitude": 1.5, "offset": 1.5}
    calib = inputs.images(gen, TINY["calib_images"], TINY["image_size"], spec)
    params = inputs.weights(TINY, gen, calib)
    pool = [inputs.images(gen, 8, TINY["image_size"], spec) for _ in range(3)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        eng = InferenceEngine(_tiny_cfg(), inputs.program_tree(params), backend="int8_chain",
                              calib_batch=calib, device=dev)
    return params, pool, eng, check.reference_logits(TINY, params, pool)


def test_the_tiny_engine_holds_to_the_reference_and_its_controls_do_not(tiny):
    params, pool, eng, ref = tiny
    answers = [(i, eng.classify(x)) for i, x in enumerate(pool)]
    served = check.readings(ref, answers)
    ctl = control.control_readings(TINY, params, pool, ref)
    fault = check.readings(ref, control.altered(answers, TINY["num_classes"]))
    limits = {"class_gap": TINY_CLASS_GAP}
    assert check.verdict(served, limits)[0], served
    assert not check.verdict(ctl, limits)[0], ctl
    assert not check.verdict(fault, limits)[0], fault


def test_the_tiny_engine_with_per_channel_scales_serves(tiny):
    params, pool, eng, ref = tiny
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        pc = InferenceEngine(_tiny_cfg(), inputs.program_tree(params), backend="int8_chain",
                             calib_batch=pool[0], calib_per_channel=True, device="cpu")
    served = check.readings(ref, [(i, pc.classify(x)) for i, x in enumerate(pool)])
    assert check.verdict(served, {"class_gap": TINY_CLASS_GAP})[0], served


def _spied(counts):
    def spy(name, fn):
        def call(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **k)
        return call

    return fused.KERNELS._replace(**{f: spy(f, getattr(fused.KERNELS, f))
                                     for f in fused.KERNELS._fields})


def test_the_grouped_route_calls_only_the_grouped_blocks(tiny):
    _, pool, eng, _ = tiny
    counts: dict = {}
    got = fused.fused_forward_int8_chain(eng.model_cfg, eng.folded, eng.chain_scales, pool[0],
                                         policy=eng.policy, kernels=_spied(counts))
    assert counts == {"stem_pool": 1, "grouped_block": 2, "grouped_ds": 3, "matmul": 1}
    assert torch.equal(got, eng.logits(pool[0]))
    plain = fused.fused_forward_int8_chain(eng.model_cfg, eng.folded, eng.chain_scales, pool[0],
                                           policy=eng.policy, kernels=fused.PLAIN)
    assert torch.equal(got, plain)
    layer = eng.folded["layer1"]["0"]
    assert {"w1q_nk", "w2g_nk", "w3q_nk", "wdq_nk"} <= set(layer) and "w2pq" not in layer
    assert "runs" not in eng.folded


def test_the_grouped_route_refuses_the_hybrid_prefix(tiny, monkeypatch):
    _, pool, eng, _ = tiny
    monkeypatch.setattr(fused, "HYBRID_XLA_STAGES", (0,))
    with pytest.raises(ValueError, match="HYBRID_XLA_STAGES"):
        eng.logits(pool[0])


def test_the_grouped_route_exports(tiny):
    """``export.py`` serves the grouped route as it comes through
    ``fused_forward_int8_chain``: one node a grouped block."""
    _, pool, eng, _ = tiny
    program = texport.export_program(eng, 2, TINY["image_size"])
    assert texport.kernel_nodes(program) == {"stem_pool_int8": 1, "grouped_block_int8": 2,
                                             "grouped_ds_block_s2_int8": 3, "gemm_f32acc": 1}
    x = pool[0][:2]
    assert torch.equal(program.module()(x), eng.logits(x).float())


def test_the_grouped_route_runs_through_the_data_parallel_entry(tiny):
    """``fused_forward_int8_chain_sharded`` over a one-rank gloo mesh runs the
    grouped route unchanged."""
    import torch.distributed as dist

    from resnetc_tpu_torch.parallel import distributed, mesh as pmesh

    _, pool, eng, _ = tiny
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    distributed.initialize(f"localhost:{port}", 1, 0, device="cpu")
    try:
        mesh = pmesh.create_mesh(1, device_type="cpu")
        got = fused.fused_forward_int8_chain_sharded(eng.model_cfg, eng.folded,
                                                     eng.chain_scales, pool[1], mesh,
                                                     policy=eng.policy)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, eng.logits(pool[1]))


@pytest.mark.parametrize("backend", ["int8", "pallas", "pallas_block"])
def test_the_other_kernel_backends_still_refuse_grouped_models(backend):
    cfg = tresnet.get_config("resnext50_32x4d")
    with pytest.raises(ValueError, match="grouped") as e:
        InferenceEngine(cfg, {}, backend=backend, device="cpu")
    assert "'int8_chain'" in str(e.value) and repr(backend) in str(e.value)


@pytest.mark.parametrize("forward", ["pallas", "int8"])
def test_the_ungrouped_forwards_refuse_a_grouped_tree(forward):
    cfg = _tiny_cfg()
    folded = tresnet.fold_inference_params(cfg, tresnet.init(cfg, torch.Generator().manual_seed(1)))
    fn = fused.fused_forward if forward == "pallas" else fused.fused_forward_int8
    with pytest.raises(ValueError, match="does not support grouped"):
        fn(cfg, folded, torch.zeros((1, 32, 32, 3)))


def test_the_served_resnext101_builds_from_its_name():
    """``get_config("resnext101_32x8d")`` on ``int8_chain``: the engine's
    tree holds the grouped copies at the published widths (built at 64 px
    calibration on the CPU; the card serves it at 224)."""
    cfg = tresnet.get_config("resnext101_32x8d", num_classes=10)
    variables = tresnet.init(cfg, torch.Generator().manual_seed(0))
    calib = np.random.default_rng(0).standard_normal((1, 32, 32, 3)).astype(np.float32)
    eng = InferenceEngine(cfg, variables, backend="int8_chain", calib_batch=calib, device="cpu")
    widths = [eng.folded[f"layer{s + 1}"]["0"]["w2g_nk"].shape for s in range(4)]
    assert [tuple(w) for w in widths] == [(256, 288), (512, 288), (1024, 288), (2048, 576)]
