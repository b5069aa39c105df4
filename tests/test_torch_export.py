"""The kernels as torch custom ops, the export tool and the C++ runner, on
the CPU.

- Every ``extern "C"`` launcher of ``resnetc_tpu_torch/csrc/*.cu`` is one
  ``resnetc::`` op (``ops.cuda._build.kernel_op``).  Each passes
  ``torch.library.opcheck`` (schema, fake tensor, autograd registration,
  AOT dispatch) on the arguments a forward gives it, recorded from the
  int8_chain, int8, pallas and pallas_block forwards of a bottleneck and a
  basic net on their routes, and from the op library's calls; the C++
  registrations of ``csrc/torch_ops.cpp`` (parsed from its ``m.def``
  strings) hold the same schemas, op by op; Python registers a CPU
  implementation and a fake for each op and no CUDA one (the C++ library
  gives that), and a wrapper on CPU tensors counts no launch.
- ``python -m resnetc_tpu_torch.export``: the int8_chain ResNet-18 program
  at 32 px holds one ``resnetc::`` node per kernel call of the served
  route's eager forward, and its ``ExportedProgram.module()`` gives the
  engine's logits bit for bit; the fp program holds no ``resnetc::`` node;
  the three weight branches of ``tests/test_export_tool.py`` (seeded init,
  ``.pth``, reference directory) each write ``model.pt2`` and
  ``meta.json`` (the CPU package); and the C++ runner
  (``native/aoti_serve.cpp``) runs the fp package with ``--device cpu``
  and prints the engine's classes, its ``--out`` logits equal to the
  engine's.
"""

from __future__ import annotations

import collections
import json
import re
import subprocess
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from resnetc_tpu_torch import checkpoint as tckpt
from resnetc_tpu_torch import export as texport
from resnetc_tpu_torch import native as tnative
from resnetc_tpu_torch.models import resnet as tresnet
from resnetc_tpu_torch.ops import cuda as tops
from resnetc_tpu_torch.ops.cuda import fused as tfused
from resnetc_tpu_torch.serve import InferenceEngine
from resnetc_tpu_torch.tensor import FP32

CSRC = Path(__file__).resolve().parent.parent / "resnetc_tpu_torch" / "csrc"
#: The launchers: every ``extern "C" int`` entry of the kernel sources.
LAUNCHERS = sorted(
    name for src in CSRC.glob("*.cu")
    for name in re.findall(r'extern "C" int (\w+)\(', src.read_text())
)
#: The served route's flags (the repository's TUNED.json).
SERVED = {"L1_PIXEL_PAIR": True, "BASIC_DS_INT8": True}
#: A bottleneck net with ResNet-50's stage-0 width (c = 64, the pixel
#: pairing's) at reduced depth.
CUT_BOTTLENECK = tresnet.ResNetConfig(name="cut_bottleneck", block="bottleneck",
                                      stage_blocks=(3, 1, 1, 2), num_classes=10)
#: A ResNeXt (4 groups of 8 channels at stage 0) at reduced depth: the
#: grouped blocks' route.
CUT_GROUPED = tresnet.ResNetConfig(name="cut_grouped", block="bottleneck",
                                   stage_blocks=(2, 1, 1, 1), num_classes=10, groups=4,
                                   width_per_group=8)


class _Calls(TorchDispatchMode):
    """Record each ``resnetc::`` op call: the first arguments of each op, and
    the count of calls by op."""

    def __init__(self):
        super().__init__()
        self.first: dict = {}
        self.counts: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "resnetc":
            name = func._schema.name.split("::")[1]
            self.counts[name] += 1
            self.first.setdefault(name, (func, args, kwargs or {}))
        return func(*args, **(kwargs or {}))


def _x(size: int, batch: int = 2, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((batch, size, size, 3)).astype(np.float32)


def _engine(cfg, backend, seed=0, **kw):
    variables = tresnet.init(cfg, torch.Generator().manual_seed(seed))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return InferenceEngine(cfg, variables, backend=backend, device="cpu",
                               calib_batch=_x(32, seed=9), **kw)


@pytest.fixture(scope="module")
def op_calls():
    """The first call of every op, from forwards over each route."""
    rec = _Calls()
    basic = tresnet.get_config("resnet18", num_classes=10)
    x = _x(32)
    routes = [
        (CUT_BOTTLENECK, "int8_chain", {"L1_PIXEL_PAIR": False}),
        (CUT_BOTTLENECK, "int8_chain", {"L1_PIXEL_PAIR": True}),
        (basic, "int8_chain", {"L1_PIXEL_PAIR": False, "BASIC_DS_INT8": True}),
        (basic, "int8_chain", {"L1_PIXEL_PAIR": True, "BASIC_RUN_FUSE_STAGES": ()}),
        (basic, "int8_chain", SERVED),
        (CUT_GROUPED, "int8_chain", {}),
        (CUT_BOTTLENECK, "int8", {}),
        (CUT_BOTTLENECK, "pallas_block", {}),
    ]
    mp = pytest.MonkeyPatch()
    try:
        for cfg, backend, flags in routes:
            eng = _engine(cfg, backend)
            for k, v in flags.items():
                mp.setattr(tfused, k, v)
            with rec:
                eng.logits(x)
            mp.undo()
        y = torch.from_numpy(_x(8, seed=1))
        with rec:
            tops.avg_pool2d(y, kernel_size=3, stride=2, padding=1)
            tops.add_relu(y, tops.relu(y))
    finally:
        mp.undo()
    return rec.first


def test_every_launcher_is_an_op_reached_by_a_route(op_calls):
    assert len(LAUNCHERS) == 20
    registered = {n for n in dir(torch.ops.resnetc) if n not in ("name",)
                  and isinstance(getattr(torch.ops.resnetc, n), torch._ops.OpOverloadPacket)}
    assert registered == set(LAUNCHERS)
    assert set(op_calls) == set(LAUNCHERS)


@pytest.mark.parametrize("name", LAUNCHERS)
def test_opcheck(op_calls, name):
    """``torch.library.opcheck`` on the recorded arguments: the schema
    (no input written, no output aliasing one), the fake implementation's
    shapes and dtypes against the CPU implementation's, the autograd
    registration and AOT dispatch."""
    func, args, kwargs = op_calls[name]
    torch.library.opcheck(func, args, kwargs)


def _cpp_schemas() -> dict:
    """The ``m.def(...)`` schemas of ``csrc/torch_ops.cpp``, by op name."""
    text = (CSRC / "torch_ops.cpp").read_text()
    out = {}
    for call in re.findall(r"m\.def\(((?:\s*\"[^\"]*\")+)\s*\);", text):
        schema = "".join(re.findall(r"\"([^\"]*)\"", call))
        out[schema.split("(", 1)[0]] = torch._C.parse_schema(f"resnetc::{schema}")
    return out


def test_cpp_schemas_equal_the_python_ones():
    cpp = _cpp_schemas()
    assert sorted(cpp) == LAUNCHERS
    impls = re.findall(r'm\.impl\("(\w+)"', (CSRC / "torch_ops.cpp").read_text())
    assert sorted(impls) == LAUNCHERS
    for name, schema in cpp.items():
        assert str(schema) == str(getattr(torch.ops.resnetc, name).default._schema), name


@pytest.mark.parametrize("name", LAUNCHERS)
def test_the_cuda_implementation_is_the_cpp_one(name):
    """Python gives each op a CPU implementation (the plain version) and a
    fake, and no CUDA one: on the card the op runs the implementation of
    ``csrc/torch_ops.cpp``, which the runner loads too, and nothing else."""
    qualified = f"resnetc::{name}"
    assert torch._C._dispatch_has_kernel_for_dispatch_key(qualified, "CPU")
    assert torch._C._dispatch_has_kernel_for_dispatch_key(qualified, "Meta")
    assert not torch._C._dispatch_has_kernel_for_dispatch_key(qualified, "CUDA")


def test_a_wrapper_on_the_cpu_runs_the_plain_version_and_counts_nothing():
    """``_build.call`` on CPU tensors: the op's CPU implementation, the
    plain version, bit for bit, no launch counted and no library loaded."""
    from resnetc_tpu_torch.ops.cuda import _build
    from resnetc_tpu_torch.ops.cuda import pool as tpool

    y = torch.from_numpy(_x(9, seed=2))
    _build.reset_launches()
    got = tops.max_pool2d(y, kernel_size=3, stride=2, padding=1)
    assert torch.equal(got, tpool.max_pool2d_plain(y, kernel_size=3, stride=2, padding=1))
    assert not _build.LAUNCHES and not _build._OPS_LOADED


# ---------------------------------------------------------------------------
# The export tool
# ---------------------------------------------------------------------------


def test_int8_chain_export_holds_the_served_route(monkeypatch):
    """ResNet-18 at 32 px on the served route: one ``resnetc::`` node per
    kernel call of the eager forward (the stem's tail, stage 0 one
    pixel-paired run, three transitions, three blocks, the fc), and the
    program's logits equal the engine's bit for bit."""
    for k, v in SERVED.items():
        monkeypatch.setattr(tfused, k, v)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        eng = texport.build_engine("resnet18", "int8_chain", device="cpu")
    x = _x(32, batch=2, seed=3)
    rec = _Calls()
    with rec:
        want = eng.logits(x).float()
    program = texport.export_program(eng, 2, 32)
    nodes = texport.kernel_nodes(program)
    assert nodes == rec.counts == {"stem_pool_int8": 1, "pp_basic_run_int8": 1,
                                   "basic_ds_block_s2_int8": 3, "basic_block_int8": 3,
                                   "gemm_f32acc": 1}
    assert torch.equal(program.module()(torch.from_numpy(x)), want)


def test_int8_chain_package_runs_the_ops_in_process(tmp_path, monkeypatch):
    """The int8_chain ResNet-18 package (CPU) loaded in this process: its
    proxy executor calls the Python-registered ops (their plain versions
    here), and the logits equal the engine's bit for bit (the package keeps
    the program's bf16 roundings, ``export.package``)."""
    for k, v in SERVED.items():
        monkeypatch.setattr(tfused, k, v)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        eng = texport.build_engine("resnet18", "int8_chain", device="cpu")
    path = texport.package(texport.export_program(eng, 1, 32), tmp_path)
    x = torch.from_numpy(_x(32, batch=1, seed=8))
    rec = _Calls()
    with rec:
        got = torch._inductor.aoti_load_package(str(path))(x)
    assert rec.counts == {"stem_pool_int8": 1, "pp_basic_run_int8": 1,
                          "basic_ds_block_s2_int8": 3, "basic_block_int8": 3,
                          "gemm_f32acc": 1}
    assert torch.equal(got, eng.logits(x).float())


def test_fp_export_holds_no_kernel():
    eng = texport.build_engine("resnet18", "fp", device="cpu")
    program = texport.export_program(eng, 1, 32)
    assert not texport.kernel_nodes(program)
    x = torch.from_numpy(_x(32, batch=1, seed=4))
    assert torch.equal(program.module()(x), eng.logits(x).float())


def _export(tmp_path, extra) -> dict:
    out = tmp_path / "export"
    argv = ["--model", "resnet18", "--batch", "1", "--image-size", "32", "--out", str(out),
            "--device", "cpu", *extra]
    assert texport.main(argv) == 0
    assert (out / "model.pt2").stat().st_size > 0
    meta = json.loads((out / "meta.json").read_text())
    assert meta == {"model": "resnet18", "backend": "fp", "input": [1, 32, 32, 3],
                    "input_dtype": "f32", "output": [1, 1000],
                    "weights": meta["weights"], "calibration": None}
    return meta


@pytest.fixture(scope="module")
def random_init_package(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("export")
    return tmp / "export", _export(tmp, [])


def test_export_random_init(random_init_package):
    assert random_init_package[1]["weights"] == "random-init"


def test_export_torch_pth(tmp_path):
    cfg = tresnet.get_config("resnet18")
    variables = tresnet.init(cfg, torch.Generator().manual_seed(1))
    pth = tmp_path / "weights.pth"
    torch.save(tckpt.torch_state_dict_from_variables(variables), pth)
    assert _export(tmp_path, ["--weights", str(pth)])["weights"].endswith("weights.pth")


def test_export_reference_dir(tmp_path):
    cfg = tresnet.get_config("resnet18")
    wdir = tmp_path / "weights_bin"
    tckpt.save_reference_format(tresnet.init(cfg, torch.Generator().manual_seed(2)), wdir)
    assert _export(tmp_path, ["--weights", str(wdir)])["weights"] == str(wdir)


def test_cpp_runner_serves_the_fp_package(random_init_package, tmp_path):
    """The C++ runner on the seeded fp package, on the CPU: one line per
    image with the engine's class, the latency line, and ``--out``'s logits
    equal to the engine's."""
    out, _ = random_init_package
    x = _x(32, batch=1, seed=5)
    x.astype("<f4").tofile(tmp_path / "x.f32")
    run = subprocess.run([str(tnative.build_runner()), str(out / "model.pt2"),
                          str(tmp_path / "x.f32"), "1", "32", "32", "3", "--device", "cpu",
                          "--latency", "3", "--out", str(tmp_path / "logits.f32")],
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = run.stdout.splitlines()
    eng = texport.build_engine("resnet18", "fp", device="cpu")
    want = eng.logits(x).float().numpy()
    got = np.fromfile(tmp_path / "logits.f32", dtype="<f4").reshape(want.shape)
    np.testing.assert_array_equal(got, want)
    assert re.fullmatch(rf"image 0: class {want[0].argmax()} \(logit -?\d+\.\d{{4}}\)",
                        lines[0]), lines
    lat = json.loads(lines[1].split(" ", 1)[1])
    assert lines[1].startswith("latency_ms ") and lat["samples"] == 3 and lat["p99"] >= lat["p50"]


def test_package_without_openmp(tmp_path, monkeypatch):
    """Where Inductor's compiler cannot link ``-fopenmp``, the package is
    built without it, with a warning, and still equals the engine."""
    monkeypatch.setattr(texport, "_links_openmp", lambda cxx: False)  # nor the path's g++
    eng = texport.build_engine("resnet18", "fp", device="cpu")
    with pytest.warns(UserWarning, match="without OpenMP"):
        path = texport.package(texport.export_program(eng, 1, 32), tmp_path)
    x = torch.from_numpy(_x(32, batch=1, seed=9))
    assert torch.equal(torch._inductor.aoti_load_package(str(path))(x), eng.logits(x).float())


def test_fp32_export_module_equals_engine():
    """The FP32 policy's engine exports too (the policy is the engine's)."""
    cfg = tresnet.get_config("resnet18", num_classes=10)
    eng = InferenceEngine(cfg, tresnet.init(cfg, torch.Generator().manual_seed(6)),
                          policy=FP32, device="cpu")
    program = texport.export_program(eng, 2, 32)
    x = torch.from_numpy(_x(32, seed=7))
    assert torch.equal(program.module()(x), eng.logits(x))
