"""What a run may load: no module of JAX or of the JAX package anywhere in the
harness, nothing of the program in the references, and a run on a machine
without a card fails with no result."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from gpubench import run

MODULES = sorted(p for p in run.HERE.rglob("*.py") if "tests" not in p.relative_to(run.HERE).parts)


def imported(path: Path) -> set[str]:
    """Top-level names of every absolute import in a file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(run.HERE)))
def test_no_module_of_the_harness_imports_jax(path):
    assert not imported(path) & set(run.FORBIDDEN), path


@pytest.mark.parametrize("path", sorted((run.HERE / "references").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert imported(path) <= {"__future__", "contextlib", "math", "typing", "importlib",
                              "torch"}, imported(path)


def test_the_whole_word_is_compared():
    assert run.forbidden_modules() == []
    fake = {"resnetc_tpu": types.ModuleType("resnetc_tpu"), "jaxlib.xla": types.ModuleType("x")}
    sys.modules.update(fake)
    try:
        assert run.forbidden_modules() == ["jaxlib", "resnetc_tpu"]
    finally:
        for k in fake:
            del sys.modules[k]
    assert "resnetc_tpu_torch" not in run.FORBIDDEN


def test_a_run_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "gpubench", "--workload",
                          "resnet34-int8_chain.online-b32", "--seed", "1", "--seconds", "1"],
                         cwd=run.ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "{" not in out.stdout


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "-m", "gpubench", "--workload",
                          "resnet34-int8_chain.online-b32", "--seed", str(2**31 + 3),
                          "--seconds", "2", "--trace", "1"],
                         cwd=run.ROOT, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-2000:]
    import json

    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert list(res)[-1] == "check"
