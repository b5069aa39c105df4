"""The comparison that decides ``correct``, its control and the fault a served
answer can have, driven through the rest of a run on the CPU at a small size
(``run.measure`` without the card's look; the program's plain kernels)."""

from __future__ import annotations

import time

import pytest
import torch

from gpubench import check, control, run

CPU = torch.device("cpu")


def small_cell(cell: str) -> run.Cell:
    """The cell with its configuration's limits, at a size the CPU runs:
    ResNet-18 or ResNet-50 at 64 px, batches of 8, two in the pool."""
    c = run.Cell.find(run.load_spec(), cell)
    small = {"basic": ("resnet18", [2, 2, 2, 2]), "bottleneck": ("resnet50", [3, 4, 6, 3])}
    model, blocks = small[c.config["block"]]
    c.config = dict(c.config, model=model, stage_blocks=blocks, image_size=64)
    c.traffic = dict(c.traffic, batch=8, pool_batches=2, warmup_requests=2, trace_requests=2)
    return c


def _measure(cell: run.Cell, seed: int) -> dict:
    return run.measure(cell, seed, 0.5, False, CPU, time.perf_counter())


def test_readings_by_hand():
    ref = [torch.tensor([[0.0, 1.0, 2.0], [3.0, 0.0, 0.0]])]
    std = ref[0].std(dim=1)
    right = check.readings(ref, [(0, torch.tensor([2, 0]))])
    assert right == {"class_gap": 0.0, "mismatch_pct": 0.0}
    wrong = check.readings(ref, [(0, torch.tensor([2, 0])), (0, torch.tensor([1, 0]))])
    assert wrong["class_gap"] == pytest.approx(float(1.0 / std[0]))
    assert wrong["mismatch_pct"] == 25.0
    ok, shown = check.verdict(wrong, {"class_gap": 0.5})
    assert not ok and shown == {"class_gap": {"value": wrong["class_gap"], "limit": 0.5}}
    assert check.verdict(right, {"class_gap": 0.5})[0]


@pytest.mark.parametrize("cell", ["resnet34-int8_chain.online-b32",
                                  "resnet152-int8_chain.bulk-b128"])
def test_sound_run_is_correct(cell):
    res = _measure(small_cell(cell), 2**31 + 5)
    assert res["correct"], res["check"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("cell", ["resnet34-int8_chain.bulk-b256",
                                  "resnet152-int8_chain.online-b32"])
def test_control_is_not_correct(cell):
    """The reference one precision below the configuration's (int4 blocks,
    int8 stem and fc) in the program's place fails the limits."""
    c = small_cell(cell)
    for seed in (11, 12, 13):
        state = run.setup(c, seed, CPU)
        low = control.control_readings(c.config, state.params, state.pool, state.ref_logits())
        ok, shown = check.verdict(low, c.config["limits"])
        assert not ok, shown


def _alter(fn, moved: dict):
    """``fn`` with the classes of its first call's answer moved to the
    next class, where they are produced."""

    def broken(*args, **kw):
        out = fn(*args, **kw)
        if not moved:
            moved["done"] = True
            if isinstance(out, torch.Tensor):  # logits: every class's score moves up one
                return out.roll(1, dims=-1)
            return (out + 1) % 1000
        return out

    return broken


@pytest.mark.parametrize("cell,entry", [("resnet34-int8_chain.online-b32", "classify"),
                                        ("resnet152-int8_chain.bulk-b128", "logits")])
def test_altered_answer_is_not_correct(cell, entry, monkeypatch):
    c = small_cell(cell)
    real_warm = run.importlib.import_module(f"gpubench.loops.{c.traffic['loop']}").warm
    moved: dict = {}

    def warm_then_break(engine, *args):
        real_warm(engine, *args)
        monkeypatch.setattr(engine, entry, _alter(getattr(engine, entry), moved))

    monkeypatch.setattr(f"gpubench.loops.{c.traffic['loop']}.warm", warm_then_break)
    res = _measure(c, 2**31 + 5)
    assert moved and not res["correct"], res["check"]


def test_fault_readings_of_the_control_script():
    answers = [(0, torch.tensor([2, 0]))]
    ref = [torch.tensor([[0.0, 1.0, 2.0], [3.0, 0.0, 0.0]])]
    assert check.readings(ref, control.altered(answers, 3))["mismatch_pct"] == 100.0


def test_quantize_grid():
    x = torch.tensor([-1.0, -0.2, 0.0, 0.3, 1.0])
    q = control.quantize(x, 4, None)
    assert torch.allclose(q * 7, torch.round(q * 7)) and float(q.abs().max()) == 1.0
    w = torch.tensor([[1.0, 0.5], [0.1, 0.05]])
    assert torch.equal(control.quantize(w, 8, (1,)), torch.round(w / w.amax(1, True) * 127)
                       / 127 * w.amax(1, True))
