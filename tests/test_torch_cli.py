"""The port's CLI (classify, bench, eval, export-weights, convert-images,
``train --data-dir``) and utils (debug, profiling, timing) vs the JAX
package's.

Every input is made here: ResNet-18 (10 classes) weights from
``jax.random.key(3)`` written by the JAX package's
``save_reference_format``; images written with PIL from seeded uint8 numpy
arrays (PNG and JPEG, odd sizes) and a ``.bin`` from a seeded normal array;
two 2-class ImageFolder trees (8 and 12 images).  Everything at 32 px on
the CPU (``run_<command>(args, device="cpu")``).

Held EQUAL: the files ``export-weights`` and ``convert-images`` write
(byte for byte), ``classify --backend fp --policy fp32``'s lines against
JAX's ``--backend xla`` lines (and ``int8_chain``'s against in-process
``classify_files``), ``eval``'s count, top-1 and top-5 against JAX's (the
two FP32 engines' logits agree within 1e-4 of max |logit|, checked on an
eval batch: far inside the gaps between the classes they rank here), and
``dump_activation``'s bytes.  ``train --data-dir``: finite losses; ``--data-dim
2`` and two ``--multihost`` processes (gloo, each rank a fresh process
that imports no JAX) log the one-rank run's losses within the
data-parallel tests' tolerances (rtol 1e-5; after the first update rtol 1e-4 for the two
processes, whose sync-BN sums each half apart).  The multi-rank runs start
together in the ``launches`` fixture.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from resnetc_tpu import checkpoint as jckpt
from resnetc_tpu.__main__ import main as jmain
from resnetc_tpu.models import resnet as jresnet
from resnetc_tpu.serve import InferenceEngine as JEngine
from resnetc_tpu.tensor import FP32 as JFP32
from resnetc_tpu.utils import debug as jdebug
from resnetc_tpu_torch import __main__ as tcli
from resnetc_tpu_torch import checkpoint as tckpt
from resnetc_tpu_torch.data import preprocess as tpre
from resnetc_tpu_torch.models import resnet as tresnet
from resnetc_tpu_torch.ops.cuda import _build, relu
from resnetc_tpu_torch.parallel import distributed as tdistributed
from resnetc_tpu_torch.serve import InferenceEngine, bench_local_latency, classify_files
from resnetc_tpu_torch.tensor import FP32
from resnetc_tpu_torch.utils import debug as tdebug
from resnetc_tpu_torch.utils import metrics as tmetrics
from resnetc_tpu_torch.utils import timing as ttiming

REPO = Path(__file__).resolve().parent.parent
MODEL = ["--model", "resnet18", "--num-classes", "10", "--image-size", "32"]
#: The training runs: ResNet-18, 10 classes, 32 px, global batch 8, FP32.
TRAIN = ["train", *MODEL, "--batch-size", "8", "--log-every", "1", "--policy", "fp32"]
CLI = ("import json, sys; from resnetc_tpu_torch import __main__ as cli; "
       "cli.run_train(cli.build_parser().parse_args(json.loads(sys.argv[1])), device='cpu')")
#: The command's functions defined in a module named ``__main__``, as
#: ``python -m resnetc_tpu_torch`` defines them (see test_torch_parallel.py).
CLI_AS_MAIN = ("import json, sys, types; import resnetc_tpu_torch.__main__ as pkg; "
               "m = types.ModuleType('__main__'); "
               "src = open(pkg.__file__).read().rsplit('if __name__', 1)[0]; "
               "exec(compile(src, pkg.__file__, 'exec'), m.__dict__); "
               "m.run_train(m.build_parser().parse_args(json.loads(sys.argv[1])), device='cpu')")
#: A serving command's body run the same way, its result printed as JSON.
SERVE_AS_MAIN = CLI_AS_MAIN.replace(
    "m.run_train(m.build_parser().parse_args(json.loads(sys.argv[1])), device='cpu')",
    "a = m.build_parser().parse_args(json.loads(sys.argv[1])); "
    "print(json.dumps(getattr(m, 'run_' + a.command)(a, device='cpu')))")
#: The serving commands over two ranks: classify on int8_chain (three files,
#: a batch the two ranks do not divide: refused, as JAX's shard_map refuses
#: it), eval on fp under FP32 at batch 3.
SERVE_DP = {
    "classify": ["classify", "--backend", "int8_chain", *MODEL],
    "eval": ["eval", "--backend", "fp", *MODEL, "--policy", "fp32", "--batch-size", "3"],
}


def _image(path, shape, seed):
    Image.fromarray(np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)).save(path)


def _tree(root: Path, per_class: int, seed: int) -> Path:
    for c, cls in enumerate(("n01", "n02")):
        (root / cls).mkdir(parents=True)
        for i in range(per_class):
            ext = "png" if i % 2 else "jpeg"
            _image(root / cls / f"{i}.{ext}", (40 + 7 * i, 61 - 3 * i, 3), seed + 100 * c + i)
    return root


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Weights, classify inputs and the two trees."""
    d = tmp_path_factory.mktemp("cli")
    jckpt.save_reference_format(
        jresnet.init(jresnet.get_config("resnet18", num_classes=10), jax.random.key(3)),
        d / "weights")
    (d / "images").mkdir()
    _image(d / "images" / "p.png", (71, 45, 3), 1)
    _image(d / "images" / "q.JPEG", (40, 59, 3), 2)
    (d / "images" / "notes.txt").write_text("skipped")
    tpre.save_input_bin(np.random.default_rng(4).standard_normal((1, 3, 32, 32)).astype(np.float32),
                        d / "r.bin")
    (d / "labels.txt").write_text("".join(f"name{i}\n" for i in range(6)))
    return {"dir": d, "weights": str(d / "weights"),
            "inputs": [str(d / "r.bin"), str(d / "images" / "p.png"),
                       str(d / "images" / "q.JPEG")],
            "eval_tree": str(_tree(d / "eval", 4, 10)), "train_tree": str(_tree(d / "train", 6, 20))}


def _serve_argv(files, command: str, argv: list[str]) -> list[str]:
    inputs = files["inputs"] if command == "classify" else [files["eval_tree"]]
    return [*argv, "--weights-dir", files["weights"], *inputs]


@pytest.fixture(scope="module")
def launches(files, tmp_path_factory):
    """``train --data-dir`` over ranks: ``--data-dim 2`` and two
    ``--multihost`` processes; ``classify`` and ``eval`` with ``--data-dim
    2``; all started together; ``wait(name)`` gives a process's
    (returncode, stdout, stderr)."""
    out = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    base = TRAIN + ["--steps", "3", "--data-dir", files["train_tree"]]
    port = tdistributed.free_port()
    procs = {}

    def start(name, code, argv):
        with open(out / f"{name}.out", "w") as o, open(out / f"{name}.err", "w") as e:
            procs[name] = subprocess.Popen([sys.executable, "-c", code, json.dumps(argv)],
                                           stdout=o, stderr=e, cwd=REPO, env=env)

    start("data_dim", CLI_AS_MAIN, base + ["--data-dim", "2"])
    for command, argv in SERVE_DP.items():
        start(f"serve_{command}", SERVE_AS_MAIN, _serve_argv(files, command, argv)
              + ["--data-dim", "2"])
    for r in range(2):
        start(f"multihost{r}", CLI, base + ["--multihost", "--coordinator",
                                            f"127.0.0.1:{port}", "--num-processes", "2",
                                            "--process-id", str(r)])

    def wait(name):
        rc = procs[name].wait(timeout=600)
        return rc, (out / f"{name}.out").read_text(), (out / f"{name}.err").read_text()

    try:
        yield wait
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def _args(*argv) -> argparse.Namespace:
    return tcli.build_parser().parse_args(list(argv))


def _jax_out(capsys, *argv) -> str:
    capsys.readouterr()
    assert jmain(list(argv)) == 0
    return capsys.readouterr().out


def _records(text: str) -> list[dict]:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith('{"tag": "train"')]


# ---------------------------------------------------------------------------
# Serving commands
# ---------------------------------------------------------------------------


def _options(main, command, capsys) -> set[str]:
    capsys.readouterr()
    with pytest.raises(SystemExit):
        main([command, "--help"])
    return set(re.findall(r"(?<![\w-])--[a-z][a-z-]*", capsys.readouterr().out))


@pytest.mark.parametrize("command", ["classify", "bench", "eval", "export-weights",
                                     "convert-images", "train"])
def test_commands_take_the_jax_flags(command, capsys):
    want = _options(jmain, command, capsys)
    assert want and _options(tcli.main, command, capsys) == want


def test_export_weights_writes_jax_files(files, tmp_path, capsys):
    argv = [*MODEL, "--weights-dir", files["weights"]]
    jout = _jax_out(capsys, "export-weights", *argv, str(tmp_path / "jax"))
    assert tcli.main(["export-weights", *argv, str(tmp_path / "torch")]) == 0
    tout = capsys.readouterr().out
    assert tout == jout.replace(str(tmp_path / "jax"), str(tmp_path / "torch"))
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "torch").iterdir()) and len(names) == 102
    for n in names:
        assert (tmp_path / "torch" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n
    # Without --weights-dir: the model initialised from --seed, the same files.
    assert tcli.run_export_weights(_args("export-weights", *MODEL, str(tmp_path / "init"))) == 102


def test_convert_images_writes_jax_bins(files, tmp_path, capsys):
    src = str(files["dir"] / "images")
    jout = _jax_out(capsys, "convert-images", src, str(tmp_path / "jax"))
    assert tcli.main(["convert-images", src, str(tmp_path / "torch")]) == 0
    assert jout == f"converted 2 images to {tmp_path / 'jax'}\n"
    assert capsys.readouterr().out == f"converted 2 images to {tmp_path / 'torch'}\n"
    for name in ("p.bin", "q.bin"):
        got = (tmp_path / "torch" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes() and len(got) == 3 * 224 * 224 * 4


def test_classify_fp_prints_jax_xla_lines(files, capsys):
    argv = [*MODEL, "--policy", "fp32", "--weights-dir", files["weights"], *files["inputs"],
            "--labels-file", str(files["dir"] / "labels.txt")]
    jlines = _jax_out(capsys, "classify", "--backend", "xla", *argv).splitlines()
    lines = tcli.run_classify(_args("classify", "--backend", "fp", *argv), device="cpu")
    assert lines == jlines and len(lines) == 3
    assert lines[0].startswith(f"{files['inputs'][0]}: class ")


def test_classify_int8_chain_equals_classify_files(files):
    with pytest.warns(UserWarning, match="calib_batch"):
        lines = tcli.run_classify(_args("classify", "--backend", "int8_chain", *MODEL,
                                        "--weights-dir", files["weights"], *files["inputs"]),
                                  device="cpu")
        cfg = tresnet.get_config("resnet18", num_classes=10)
        eng = InferenceEngine(cfg, tckpt.load_reference_format(cfg, files["weights"]),
                              backend="int8_chain", device="cpu")
    want = classify_files(eng, files["inputs"], image_size=32)
    assert lines == [f"{p}: class {c}" for p, c in zip(files["inputs"], want)]


def test_eval_gives_jax_count_top1_top5(files, capsys):
    argv = [*MODEL, "--policy", "fp32", "--weights-dir", files["weights"], "--batch-size", "3",
            files["eval_tree"]]
    want = json.loads(_jax_out(capsys, "eval", "--backend", "xla", *argv))
    got = tcli.run_eval(_args("eval", "--backend", "fp", *argv), device="cpu")
    assert got == want and got["count"] == 6.0  # 8 images, batch 3: the remainder dropped
    # The logits the ranking rests on: FP32 engines within 1e-4 of max |logit|.
    jcfg = jresnet.get_config("resnet18", num_classes=10)
    cfg = tresnet.get_config("resnet18", num_classes=10)
    x = np.concatenate([tpre.preprocess_file(p, resize=33, crop=32) for p in
                        sorted(Path(files["eval_tree"]).glob("*/*"))[:3]])
    jl = np.asarray(JEngine(jcfg, jckpt.load_reference_format(jcfg, files["weights"]),
                            policy=JFP32, backend="xla").logits(jnp.asarray(x)))
    tl = InferenceEngine(cfg, tckpt.load_reference_format(cfg, files["weights"]), policy=FP32,
                         device="cpu").logits(x).numpy()
    assert np.abs(tl - jl).max() <= 1e-4 * np.abs(jl).max()


@pytest.mark.parametrize("command", ["classify", "eval", "bench"])
def test_serving_commands_over_two_ranks(files, launches, command):
    """``--data-dim 2``: two ranks spawned by the command (defined in a
    module named ``__main__``, as ``python -m`` defines it) print what one
    process prints: ``eval``'s record (fp, FP32, batches of 3).
    ``classify`` of three files on int8_chain fails in the ranks with JAX's
    ``shard_map`` error (two data ranks do not divide three images).
    ``bench`` refuses the CPU over ranks as in one process."""
    if command == "bench":
        with pytest.raises(SystemExit, match="times the card"):
            tcli.run_bench(_args("bench", *MODEL, "--data-dim", "2"), device="cpu")
        return
    rc, out, err = launches(f"serve_{command}")
    if command == "classify":
        assert rc != 0 and "but 2 does not evenly divide 3" in err, err[-3000:]
        return
    assert rc == 0, err[-3000:]
    got = json.loads(out.splitlines()[-1])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # int8_chain calibrated on noise
        run = {"classify": tcli.run_classify, "eval": tcli.run_eval}[command]
        want = run(_args(*_serve_argv(files, command, SERVE_DP[command])), device="cpu")
    assert got == want
    assert len(got) == 3 if command == "classify" else got["count"] == 6.0


def test_bench_refuses_the_cpu():
    with pytest.raises(SystemExit, match="times the card"):
        tcli.run_bench(_args("bench", *MODEL), device="cpu")


def test_bench_refuses_int8_chain_over_a_data_axis():
    """The latency request's one image is a batch two data ranks do not
    divide, which int8_chain refuses, as JAX's shard_map does: refused
    before any rank starts."""
    with pytest.raises(SystemExit, match="does not run over --data-dim > 1"):
        tcli.run_bench(_args("bench", *MODEL, "--backend", "int8_chain", "--data-dim", "2"),
                       device="cpu")


@pytest.mark.parametrize("command", ["classify", "bench", "eval"])
@pytest.mark.parametrize("flags, match", [
    (["--multihost"], "train"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2", "--process-id", "0"], "train"),
    (["--backend", "int8", "--model-dim", "2"], "Queue 1 item 3b"),
    (["--backend", "int8_chain", "--model-dim", "2"], "use --data-dim 2 instead"),
])
def test_serving_commands_run_in_one_process(files, command, flags, match):
    """The counterpart of tests/test_serve.py:88: the serving commands
    refuse the multi-process flags, and a model axis on the int8 backends
    (JAX's own message for int8_chain; for int8, that JAX's engine cannot
    place the quantized tree under a mesh), before any engine is built.  ``--data-dim`` serves over ranks
    (``test_torch_parallel.py::test_serving_commands_over_two_ranks``)."""
    extra = {"classify": files["inputs"][:1], "eval": [files["eval_tree"]], "bench": []}[command]
    run = {"classify": tcli.run_classify, "bench": tcli.run_bench, "eval": tcli.run_eval}[command]
    with pytest.raises(SystemExit, match=match):
        run(_args(command, *MODEL, *flags, *extra), device="cpu")


def test_serving_commands_without_cuda_raise(files):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: device=None rightly selects it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["classify", *MODEL, files["inputs"][0]])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["eval", *MODEL, files["eval_tree"]])


# ---------------------------------------------------------------------------
# train --data-dir
# ---------------------------------------------------------------------------


def test_train_data_dir_takes_its_steps(files, capsys):
    capsys.readouterr()
    ts = tcli.run_train(_args(*TRAIN, "--steps", "2", "--data-dir", files["train_tree"]),
                        device="cpu")
    recs = _records(capsys.readouterr().out)
    assert int(ts.step) == 2 and [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)


def _one_rank(files, capsys) -> list[dict]:
    capsys.readouterr()
    tcli.run_train(_args(*TRAIN, "--steps", "3", "--data-dir", files["train_tree"]),
                   device="cpu")
    return _records(capsys.readouterr().out)


def test_train_data_dir_data_dim_logs_what_one_rank_logs(files, launches, capsys):
    """Two spawned ranks, each reading the one global batch and taking its
    half: rank 0 logs the one-rank losses, rank 1 the same to stderr."""
    rc, so, se = launches("data_dim")
    assert rc == 0, se[-3000:]
    dp, dp1, one = _records(so), _records(se), _one_rank(files, capsys)
    assert len(dp) == len(one) == 3
    for a, b, c in zip(dp, dp1, one):
        assert a["step"] == b["step"] == c["step"] and a["loss"] == b["loss"]
        assert a["accuracy"] == c["accuracy"] and np.isfinite(a["loss"])
        np.testing.assert_allclose(a["loss"], c["loss"], rtol=1e-5)


def test_train_data_dir_multihost_reads_shards(files, launches, capsys):
    """Each process reads its strided shard of every epoch (4 images a
    step), drawing the crops the one-rank run draws for those images: the
    two shards make the one-rank global batch, so both log its losses."""
    logs = []
    for r in range(2):
        rc, so, se = launches(f"multihost{r}")
        assert rc == 0, f"process {r} failed:\n{se[-3000:]}"
        logs.append(_records(so if r == 0 else se))
    one = _one_rank(files, capsys)
    got = [rec["loss"] for rec in logs[0]]
    assert got == [rec["loss"] for rec in logs[1]] and len(got) == 3
    want = [rec["loss"] for rec in one]
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4)


def test_train_no_longer_refuses_data_dir(files):
    args = _args(*TRAIN, "--steps", "1", "--data-dir", "/nonexistent")
    with pytest.raises(FileNotFoundError):
        tcli.run_train(args, device="cpu")


# ---------------------------------------------------------------------------
# utils: debug, profiling, timing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
@pytest.mark.parametrize("kind", ["tensor", "array"])
def test_dump_activation_writes_jax_bytes(tmp_path, layout, kind):
    x = np.random.default_rng(6).standard_normal((2, 5, 3, 4)).astype(np.float32)
    jdebug.dump_activation(x, str(tmp_path / "jax.f32"), layout=layout)
    tdebug.dump_activation(torch.from_numpy(x) if kind == "tensor" else x,
                           str(tmp_path / "sub" / "torch.f32"), layout=layout)
    assert (tmp_path / "sub" / "torch.f32").read_bytes() == (tmp_path / "jax.f32").read_bytes()
    shape = (2, 4, 5, 3) if layout == "NHWC" else x.shape
    np.testing.assert_array_equal(tdebug.load_activation(str(tmp_path / "jax.f32"), shape),
                                  jdebug.load_activation(str(tmp_path / "jax.f32"), shape))


def test_activation_files_reject_bad_shapes_and_layouts(tmp_path):
    x = np.zeros((1, 2, 2, 3), np.float32)
    with pytest.raises(ValueError, match="layout"):
        tdebug.dump_activation(x, str(tmp_path / "a"), layout="CHWN")
    tdebug.dump_activation(x, str(tmp_path / "a"))
    with pytest.raises(ValueError, match="expected 13"):
        tdebug.load_activation(str(tmp_path / "a"), (13,))


def test_nan_debug_raises_at_the_first_nan():
    x = torch.tensor([[1.0, float("nan")], [2.0, 3.0]])
    with tdebug.nan_debug():
        y = torch.ones(2, 2) * 2 + 1  # finite: no error
        with pytest.raises(FloatingPointError, match="aten.mul"):
            y * float("nan")
        with pytest.raises(FloatingPointError):
            relu(x)  # a wrapper: its plain version's op on the CPU
        assert _build.SWITCHES.nan_check
    assert not _build.SWITCHES.nan_check
    assert torch.isnan(relu(x)).any()  # outside the context nothing raises


def test_nan_debug_passes_a_finite_forward():
    """Uninitialized allocations and views are not taken for NaN: a whole
    int8_chain forward (plain versions on the CPU) runs clean."""
    cfg = tresnet.get_config("resnet18", num_classes=10)
    variables = tresnet.init(cfg, torch.Generator().manual_seed(0))
    calib = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    eng = InferenceEngine(cfg, variables, backend="int8_chain", calib_batch=calib, device="cpu")
    with tdebug.nan_debug():
        out = eng.logits(calib)
    assert torch.equal(out, eng.logits(calib))


def test_plain_kernels_runs_the_plain_versions():
    x = torch.randn(3, 4, generator=torch.Generator().manual_seed(2))
    assert tdebug.interpret_kernels is tdebug.plain_kernels
    _build.reset_launches()
    with tdebug.plain_kernels():
        assert _build.SWITCHES.plain_depth == 1 and _build.runs_plain()
        with tdebug.plain_kernels():
            got = relu(x)
        assert _build.SWITCHES.plain_depth == 1
    assert _build.SWITCHES.plain_depth == 0 and not _build.LAUNCHES
    assert torch.equal(got, torch.relu(x))


def test_debug_switches_hold_only_for_the_thread_that_opened_them():
    """A thread inside plain_kernels() / nan_debug() leaves another thread's
    wrappers on their kernels: the other thread still calls the ops (which
    launch for a tensor on the card), counts its launch and does not check
    it."""
    nan = torch.tensor([float("nan")])
    inside, release, seen = threading.Event(), threading.Event(), {}

    def debugging_thread():
        with tdebug.plain_kernels(), tdebug.nan_debug():
            seen["own_plain"] = _build.runs_plain()
            try:
                _build.launched("probe", nan)
            except FloatingPointError:
                seen["own_raised"] = True
            inside.set()
            release.wait(timeout=30)

    t = threading.Thread(target=debugging_thread)
    _build.reset_launches()
    t.start()
    try:
        assert inside.wait(timeout=30)
        assert not _build.runs_plain()
        assert _build.launched("probe", nan) is nan  # counted, not checked
        assert _build.SWITCHES.plain_depth == 0 and not _build.SWITCHES.nan_check
    finally:
        release.set()
        t.join()
    assert seen == {"own_plain": True, "own_raised": True}
    assert _build.LAUNCHES["probe"] == 2
    _build.reset_launches()  # leave no count for a later test of this worker


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with tmetrics.profile_trace(str(tmp_path / "trace")):
        with tmetrics.annotate("resnetc_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(ev.get("name") == "resnetc_region" for ev in trace["traceEvents"])
    with tmetrics.profile_trace(str(tmp_path / "off"), enabled=False):
        torch.ones(2) + 1
    assert not (tmp_path / "off").exists()


def test_timing_refuses_the_cpu():
    x = torch.zeros(4)
    with pytest.raises(RuntimeError, match="card"):
        ttiming.chained_seconds_per_iter(lambda c: c * 2, x)
    with pytest.raises(RuntimeError, match="card"):
        ttiming.fetch_seconds(lambda c: c * 2, x)
    cfg = tresnet.get_config("resnet18", num_classes=10)
    eng = InferenceEngine(cfg, tresnet.init(cfg, torch.Generator().manual_seed(0)), device="cpu")
    with pytest.raises(RuntimeError, match="card"):
        bench_local_latency(eng, torch.zeros(1, 32, 32, 3))
