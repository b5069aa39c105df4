"""The inputs from the seed, and the reference against the program's own
float32 forward."""

from __future__ import annotations

import json

import pytest
import torch

from gpubench import inputs, run
from gpubench.references import resnet as ref

CPU = torch.device("cpu")
TRAFFIC = json.loads((run.HERE / "traffic" / "online-b32.json").read_text())


def tiny(block: str = "basic", blocks=(2, 2, 2, 2), side: int = 32) -> dict:
    cfg = json.loads((run.HERE / "configs" / "resnet34-int8_chain.json").read_text())
    return dict(cfg, block=block, stage_blocks=list(blocks), image_size=side,
                model={"basic": "resnet18", "bottleneck": "resnet50"}[block])


def _draw(seed: int, cfg: dict):
    gen = inputs.generator(seed, CPU)
    calib = inputs.images(gen, 4, cfg["image_size"], TRAFFIC["images"])
    params = inputs.weights(cfg, gen, calib)
    pool = [inputs.images(gen, 3, cfg["image_size"], TRAFFIC["images"]) for _ in range(2)]
    return calib, params, pool


def test_same_seed_same_inputs_and_traffic():
    cfg = tiny()
    a, b, c = _draw(2**31 + 11, cfg), _draw(2**31 + 11, cfg), _draw(2**31 + 12, cfg)
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))
    assert all(torch.equal(a[1][k], b[1][k]) for k in a[1])
    assert not torch.equal(a[2][0], c[2][0])
    sa = run.Cell("c", 1, cfg, dict(TRAFFIC, batch=3, pool_batches=2), [], [])
    orders = [run.setup(sa, s, CPU).order for s in (5, 5, 6, 7, 8)]
    assert orders[0] == orders[1] and sorted(orders[2]) == [0, 1]


def test_images_in_the_normalised_range():
    x = _draw(1, tiny())[2][0]
    assert x.shape == (3, 32, 32, 3) and x.dtype == torch.float32
    lo, hi = (float(torch.tensor(v, dtype=torch.float32)) for v in (inputs.PIXEL_LO,
                                                                     inputs.PIXEL_HI))
    assert float(x.min()) >= lo and float(x.max()) <= hi
    assert float(x.std()) > 0.5


def test_bn_is_off_the_identity_and_classes_vary():
    cfg = tiny(side=64)
    calib, params, pool = _draw(3, cfg)
    for k, v in params.items():
        if k.endswith("running_var"):
            assert not torch.allclose(v, torch.ones_like(v)), k
        if k.endswith("running_mean"):
            assert bool(v.abs().gt(0).any()), k
    with torch.no_grad():
        logits = ref.forward(cfg, params, torch.cat(pool))
    assert len(set(logits.argmax(1).tolist())) > 1


def test_program_tree_is_a_copy_in_hwio():
    params = _draw(4, tiny())[1]
    tree = inputs.program_tree(params)
    w = tree["layer1"]["0"]["conv1"]["weight"]
    assert torch.equal(w, params["layer1.0.conv1.weight"].permute(2, 3, 1, 0))
    w.zero_()
    assert bool(params["layer1.0.conv1.weight"].abs().gt(0).any())


@pytest.mark.parametrize("block,blocks", [("basic", (2, 2, 2, 2)), ("bottleneck", (1, 2, 1, 1))])
def test_reference_agrees_with_the_programs_forward(block, blocks):
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.tensor import FP32

    cfg = tiny(block, blocks)
    _, params, pool = _draw(5, cfg)
    model = resnet.ResNetConfig("tiny", block, tuple(blocks))
    with torch.no_grad():
        want = ref.forward(cfg, params, pool[0])
        got, _ = resnet.forward(model, inputs.program_tree(params), pool[0], policy=FP32)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
