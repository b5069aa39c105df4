"""The work counting against figures worked out by hand."""

from __future__ import annotations

import json

import pytest

from gpubench import run, work


def _config(name: str) -> dict:
    return json.loads((run.HERE / "configs" / f"{name}.json").read_text())


R152, R34 = _config("resnet152-int8_chain"), _config("resnet34-int8_chain")


def test_model_flops():
    assert round(work.model_flops(R152) / 1e9, 2) == 23.03
    assert round(work.model_flops(R34) / 1e9, 2) == 7.33


@pytest.mark.parametrize("name", ["resnet18", "resnet34", "resnet50", "resnet152"])
def test_model_flops_is_the_programs(name):
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.utils.flops import model_flops

    m = resnet.get_config(name)
    cfg = {"block": m.block, "stage_blocks": list(m.stage_blocks), "stem_width": 64,
           "num_classes": 1000, "image_size": 224}
    assert work.model_flops(cfg) == model_flops(m)


@pytest.mark.parametrize("width", [512, 1024, 2048])
def test_row1_block_at_b32(width):
    ops, nbytes = work.bottleneck_block(R152, 32, width)
    assert round(ops / 1e9, 2) == 13.98  # 2 * px * (C^2/2 + 9 (C/4)^2), the same at every stage
    assert ops / work.PEAK_INT8_OPS == pytest.approx(7.06e-6, rel=1e-3)
    px = 32 * {512: 28, 1024: 14, 2048: 7}[width] ** 2
    assert nbytes == 2 * px * width + 2 * width * width // 4 + 9 * (width // 4) ** 2


def test_row1_bound_by_bytes_at_stage_1():
    ops, nbytes = work.bottleneck_block(R152, 32, 512)
    assert work.least_seconds(ops, nbytes) == nbytes / work.PEAK_HBM_BYTES > ops / 1979e12


@pytest.mark.parametrize("width", [128, 256, 512])
def test_row7_block_at_b32(width):
    ops, nbytes = work.basic_block(R34, 32, width)
    assert ops == 2 * 32 * {128: 28, 256: 14, 512: 7}[width] ** 2 * 18 * width * width
    assert work.least_seconds(ops, nbytes) * 1e3 == pytest.approx(0.00748, rel=1e-3)
