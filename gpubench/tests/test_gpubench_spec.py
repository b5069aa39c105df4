"""BENCHMARK.json against the harness: every name found as a file, the names,
units and keys within the contract's limits, the per-layer metrics tied to
cells that report what they move."""

from __future__ import annotations

import json
import math
import re

import pytest

from gpubench import run

SPEC = run.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["gpubench"]
    assert SPEC["command"][:3] == ["python3", "-m", "gpubench"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len((run.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_end_to_end_metrics_are_the_three():
    assert [m["name"] for m in SPEC["end_to_end"]] == ["images_per_s", "latency_p95_ms",
                                                       "setup_s"]


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]]
                         + CELLS + [m["name"] for m in METRICS])
def test_names_use_the_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert (run.HERE / "metrics" / f"{metric['name']}.py").is_file()


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=[m["name"] for m in SPEC["per_layer"]])
def test_per_layer_metric_has_cells_reporting_what_it_moves(metric):
    assert metric["workloads"] and set(metric["workloads"]) <= set(CELLS)
    assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
    moves = next(m for m in SPEC["end_to_end"] if m["name"] == metric["moves"])
    for cell in metric["workloads"]:
        assert cell in moves.get("workloads", [cell])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    c = run.Cell.find(SPEC, cell)
    assert (run.HERE / "loops" / f"{c.traffic['loop']}.py").is_file()
    assert (run.HERE / "references" / f"{c.config['reference']}.py").is_file()
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(run.reader(m["name"]))
    assert set(c.config["limits"]) == {"class_gap"}


@pytest.mark.parametrize("conf", SPEC["configs"], ids=[c["name"] for c in SPEC["configs"]])
def test_config_file_is_the_published_model(conf):
    from resnetc_tpu_torch.models import resnet

    cfg = json.loads((run.ROOT / conf["file"]).read_text())
    assert conf["file"].startswith("gpubench/configs/") and cfg["name"] == conf["name"]
    assert conf["reduced"] == [] and conf["source"].startswith("https://arxiv.org/abs/1512.03385")
    model = resnet.get_config(cfg["model"])
    assert (cfg["block"], tuple(cfg["stage_blocks"]), cfg["stem_width"]) == (
        model.block, model.stage_blocks, model.stem_width)
    assert cfg["image_size"] == 224 and cfg["num_classes"] == 1000
    from gpubench.references import resnet as ref

    assert sum(math.prod(s) for k, s in ref.param_shapes(cfg).items()
               if not k.endswith(("running_mean", "running_var"))) == cfg["parameters"]


def test_ordered_cells():
    assert CELLS == ["resnet152-int8_chain.bulk-b128", "resnet34-int8_chain.bulk-b256",
                     "resnet152-int8_chain.online-b32", "resnet34-int8_chain.online-b32"]
