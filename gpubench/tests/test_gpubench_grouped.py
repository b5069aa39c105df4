"""The grouped configuration's yardstick: the ResNeXt reference's contract,
its block-diagonal expansion for hooks without ``groups``, the grouped work
counts against the program's FLOP count and by hand, and the three new
readers over a trace made by hand."""

from __future__ import annotations

import json

import pytest
import torch
import torch.nn.functional as F

from gpubench import readers, run, trace, work, work_grouped
from gpubench.loops import Window
from gpubench.references import resnext

X101 = json.loads((run.HERE / "configs" / "resnext101_32x8d-int8_chain.json").read_text())


def test_the_configuration_counts_are_the_references():
    assert work_grouped.model_flops(X101) == round(X101["gflop_per_image"] * 1e9)
    shapes = resnext.param_shapes(X101)
    n = sum(torch.Size(s).numel() for k, s in shapes.items()
            if not k.endswith(("running_mean", "running_var")))
    assert n == X101["parameters"] == 88_791_336
    assert [resnext.stage_widths(X101, s) for s in range(4)] == [
        (256, 256), (512, 512), (1024, 1024), (2048, 2048)]


@pytest.mark.parametrize("name", ["resnext50_32x4d", "resnext101_32x8d", "resnet101"])
def test_model_flops_is_the_programs(name):
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.utils.flops import model_flops

    m = resnet.get_config(name)
    cfg = {"block": m.block, "stage_blocks": list(m.stage_blocks), "stem_width": 64,
           "groups": m.groups, "width_per_group": m.width_per_group, "num_classes": 1000,
           "image_size": 224}
    assert work_grouped.model_flops(cfg) == model_flops(m)


def test_resnet101s_count_reads_resnext101_as_resnet101():
    """Why ``mfu.bulk_grouped`` exists: ``work.model_flops`` ignores the
    groups and the inner width."""
    assert work.model_flops(X101) != work_grouped.model_flops(X101)
    assert round(work.model_flops(X101) / 1e9, 2) == 15.6


@pytest.mark.parametrize("groups", [2, 4])
def test_the_expansion_is_the_grouped_convolution(groups):
    gen = torch.Generator().manual_seed(groups)
    w = torch.randn((16, 16 // groups, 3, 3), generator=gen)
    x = torch.randn((2, 16, 5, 5), generator=gen)
    dense = resnext.expand_grouped(w, groups)
    assert dense.shape == (16, 16, 3, 3)
    assert torch.allclose(F.conv2d(x, dense, padding=1), F.conv2d(x, w, padding=1,
                                                                  groups=groups), atol=1e-5)
    assert torch.equal(dense.abs().amax(dim=(1, 2, 3)), w.abs().amax(dim=(1, 2, 3)))


def test_a_hook_without_groups_sees_dense_weights():
    cfg = dict(X101, stage_blocks=[1, 1, 1, 1], image_size=32, num_classes=5, groups=4,
               width_per_group=8)
    params = {k: torch.randn(s) * 0.05 for k, s in resnext.param_shapes(cfg).items()}
    for k in params:
        if k.endswith("running_var"):
            params[k] = params[k].abs() + 1
    seen = []

    def conv(name, x, w, stride, padding):
        seen.append((name, w.shape[1] == x.shape[1]))
        return F.conv2d(x, w, stride=stride, padding=padding)

    x = torch.randn((2, 32, 32, 3))
    with torch.no_grad():
        want = resnext.forward(cfg, params, x)
        got = resnext.forward(cfg, params, x, conv=conv)
    assert all(dense for _, dense in seen) and any(n.endswith("conv2") for n, _ in seen)
    assert torch.allclose(got, want, atol=1e-4)


def _reading(op: str, shapes: list, ns: int, images: int = 256) -> run.Reading:
    cell = run.Cell("x", 1, X101, {"batch": 128}, [], [])
    dev = [trace.DeviceOp("k", 0, ns, op=op, call=1, shapes=shapes)]
    tr = trace.Trace(span_ns=(0, ns), device=dev, host=[])
    return run.Reading(cell, 0.0, Window(seconds=1.0, images=images), trace=tr,
                       span=Window(attempted=1))


def test_the_roofline_readers_count_the_models_shapes():
    b, h = 128, 14
    rows = b * (h + 2) * 16
    shapes = [[rows, 1024], [1024, 1024], [1024], [1024], [1024, 288], [1024], [1024],
              [1024, 1024]]
    ops = 2 * b * h * h * (2 * 1024 * 1024 + 9 * 1024 * 32)
    got = run.reader("roofline_pct.grouped_block_int8")(
        _reading("resnetc::grouped_block_int8", shapes, 1_000_000))
    assert got == pytest.approx(100 * ops / work.PEAK_INT8_OPS / 1e-3)
    ds = [[b * 30 * 32, 512], [1024, 512], [1024], [1024], [1024, 288], [1024], [1024],
          [1024, 1024]]
    ops_ds = 2 * (b * 28 * 28 * 512 * 1024 + b * h * h * (9 * 1024 * 32 + 1024 * 1024
                                                          + 512 * 1024))
    got = run.reader("roofline_pct.grouped_ds_block_s2_int8")(
        _reading("resnetc::grouped_ds_block_s2_int8", ds, 1_000_000))
    assert got == pytest.approx(100 * ops_ds / work.PEAK_INT8_OPS / 1e-3)
    assert run.reader("roofline_pct.grouped_block_int8")(
        _reading("resnetc::chain_block_int8", shapes, 1000)) is None


def test_mfu_bulk_grouped_reads_the_grouped_count():
    r = _reading("resnetc::grouped_block_int8", [], 1, images=5000)
    assert run.reader("mfu.bulk_grouped")(r) == pytest.approx(
        100 * 32.828030976e9 * 5000 / 1979e12)
    assert run.reader("mfu.bulk")(r) == pytest.approx(readers.mfu_pct(r))
    assert run.reader("mfu.bulk_grouped")(r) > run.reader("mfu.bulk")(r)
