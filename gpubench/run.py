"""One run of one cell of ``BENCHMARK.json``.

    python -m gpubench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``BENCHMARK.json``'s ``file``, under
``configs/``) and a traffic mix (``traffic/<mix>.json``), whose ``loop``
names the client (``loops/<loop>.py``).  Each metric is read by
``metrics/<metric>.py``.  A run:

1. finds the cards the cell asks for, or fails;
2. sets up: makes the weights, the calibration images and the image pool
   from the seed on the card (``inputs``), builds the program's
   ``InferenceEngine`` (its kernels build on the first run in a checkout)
   and warms the cell's one batch shape through the client;
3. measures for ``--seconds`` on the host's clock;
4. with ``--trace 1``, also times each ``engine.logits`` call of that window
   and then profiles ``trace_requests`` more requests (``trace``);
5. frees the program, runs the float32 reference over the pool and holds
   every answer served against it (``check``);
6. fails if JAX or the JAX package was loaded, and prints one JSON line:
   the end-to-end metrics, or with ``--trace 1`` the per-layer ones.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path

import torch

from gpubench import check, inputs, readers, trace
from gpubench.loops import Window

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level module names that no run may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "resnetc_tpu")
#: Kernel and build caches a library may keep, each at a fixed path in the checkout.
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels"}


class NoCard(RuntimeError):
    pass


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    #: The metric entries of ``BENCHMARK.json`` this cell reports.
    end_to_end: list
    per_layer: list

    @classmethod
    def find(cls, spec: dict, name: str) -> "Cell":
        cell = next((w for w in spec["workloads"] if w["name"] == name), None)
        if cell is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
        config = json.loads((ROOT / conf["file"]).read_text())
        traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())

        def mine(metrics):
            return [m for m in metrics if name in m.get("workloads", [name])]

        return cls(name, cell["chips"], config, traffic, mine(spec["end_to_end"]),
                   mine(spec["per_layer"]))


def require_card(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark measures the card and has no CPU mode")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, {torch.cuda.device_count()} found")
    return torch.device("cuda", 0)


def build_engine(cfg: dict, params: dict, calib: torch.Tensor, dev: torch.device):
    """The program under test: its engine on the configuration's backend
    and policy, over the program's form of ``params``."""
    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.serve import InferenceEngine
    from resnetc_tpu_torch.tensor import policy

    model = resnet.get_config(cfg["model"], num_classes=cfg["num_classes"])
    if (model.block, list(model.stage_blocks), model.stem_width) != (
            cfg["block"], cfg["stage_blocks"], cfg["stem_width"]):
        raise ValueError(f"the program's {cfg['model']} is not the configuration's model")
    return InferenceEngine(model, inputs.program_tree(params), policy=policy(cfg["policy"]),
                           backend=cfg["backend"], calib_batch=calib, device=dev)


@dataclasses.dataclass
class State:
    """What set-up made: the benchmark's weights and images, the program's
    engine, and the client."""

    cell: Cell
    params: dict
    pool: list
    order: list
    engine: object
    loop: object
    _ref: list | None = None

    def window(self, **kw) -> Window:
        return self.loop.window(self.engine, self.pool, self.order, self.cell.traffic, **kw)

    def free_program(self) -> None:
        self.engine = None
        gc.collect()
        torch.cuda.empty_cache()

    def ref_logits(self) -> list:
        if self._ref is None:
            self._ref = check.reference_logits(self.cell.config, self.params, self.pool)
        return self._ref


def setup(cell: Cell, seed: int, dev: torch.device, phases: dict | None = None) -> State:
    """Inputs from the seed, the engine, the client; each phase's seconds
    into ``phases``."""
    phases = {} if phases is None else phases
    cfg, traffic = cell.config, cell.traffic
    t = time.perf_counter()
    gen = inputs.generator(seed, dev)
    side = cfg["image_size"]
    calib = inputs.images(gen, cfg["calib_images"], side, traffic["images"])
    params = inputs.weights(cfg, gen, calib)
    pool = [inputs.images(gen, traffic["batch"], side, traffic["images"])
            for _ in range(traffic["pool_batches"])]
    order = list(range(len(pool)))
    random.Random(seed).shuffle(order)
    _sync(dev)
    phases["inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    engine = build_engine(cfg, params, calib, dev)
    _sync(dev)
    phases["engine_s"] = time.perf_counter() - t
    loop = importlib.import_module(f"gpubench.loops.{traffic['loop']}")
    return State(cell, params, pool, order, engine, loop)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class Reading:
    """What a metric's reader may read."""

    cell: Cell
    setup_s: float
    #: The measured window (host clock).
    window: Window
    #: With --trace 1: each ``engine.logits`` call's host seconds in the window,
    #: the profiled requests and their trace.
    host_s: list | None = None
    span: Window | None = None
    trace: trace.Trace | None = None


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: list, r: Reading) -> dict:
    """Each metric its reader finds something for, with its unit."""
    out = {}
    for m in entries:
        v = reader(m["name"])(r)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _spanned(fn, spans: list):
    def call(*args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        spans.append(time.perf_counter() - t)
        return out
    return call


def card_line() -> str:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20).stdout
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi: {e}"
    return (f"[card] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
            f"{smi.strip()}; host: {len(os.sched_getaffinity(0))} cpus, load "
            f"{' '.join(f'{x:.2f}' for x in os.getloadavg())}")


def parse(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m gpubench", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(cell: Cell, seed: int, seconds: float, traced: bool, dev: torch.device,
            t0: float) -> dict:
    """Set up, measure, check: the run's result, without the card's look
    (``main`` makes it) and the import guard (``main`` applies it)."""
    on_card = dev.type == "cuda"
    phases: dict = {"imports_s": time.perf_counter() - t0}
    t = time.perf_counter()
    from resnetc_tpu_torch.ops.cuda import _build, fused

    phases["program_import_s"] = time.perf_counter() - t
    if on_card:
        t = time.perf_counter()
        _build.load_ops()
        phases["ops_library_s"] = time.perf_counter() - t
    print(f"[route] {cell.config['backend']}, TUNED.json flags applied: "
          f"{json.dumps(fused.TUNED_DEFAULTS)}", flush=True)
    state = setup(cell, seed, dev, phases)
    t = time.perf_counter()
    state.loop.warm(state.engine, state.pool, state.order, cell.traffic)
    _sync(dev)
    gc.collect()
    gc.freeze()  # set-up's objects out of the window's collections
    phases["warm_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t0
    print(f"[setup] {setup_s:.4f} s: {json.dumps(phases)}", flush=True)

    host_s = [] if traced else None
    if traced:
        state.engine.logits = _spanned(state.engine.logits, host_s)
    _build.reset_launches()
    window = state.window(seconds=seconds)
    gc.unfreeze()
    launches = {k: v / max(window.attempted, 1) for k, v in _build.LAUNCHES.items()}
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    n = len(window.latencies_s)
    fifths = [readers.percentile_ms(window.latencies_s[i * n // 5:(i + 1) * n // 5], 95)
              for i in range(5)]
    print(f"[window] {window.completed} requests of {window.attempted}, {window.images} "
          f"images in {window.seconds} s; p95 ms of each fifth of the window's requests: "
          f"{fifths}; launches a request: {json.dumps(launches)}", flush=True)
    reading = Reading(cell, setup_s, window, host_s=host_s)
    answers = list(window.answers)
    if traced:
        del state.engine.logits
        reading.span, reading.trace = trace.profiled(
            lambda: state.window(requests=cell.traffic["trace_requests"]))
        answers += reading.span.answers
        print(f"[trace] {reading.span.attempted} requests in {reading.trace.window_s} s, "
              f"{len(reading.trace.device)} device operations", flush=True)

    state.free_program()
    t = time.perf_counter()
    values = check.readings(state.ref_logits(), answers)
    ok, shown = check.verdict(values, cell.config["limits"])
    print(f"[check] {len(answers)} answers against the reference in "
          f"{time.perf_counter() - t:.2f} s: {json.dumps(values)}", flush=True)

    metrics = read_metrics(cell.per_layer if traced else cell.end_to_end, reading)
    device = {"platform": "gpu" if on_card else dev.type,
              "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
              "count": cell.chips, "memory_peak_bytes": memory_peak}
    result = {"correct": ok, "attempted": window.attempted,
              "failed": window.attempted - len(window.answers),
              "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = reading.trace.busy_s
        device["window_s"] = reading.trace.window_s
        result["breakdown"] = reading.trace.breakdown()
    result["check"] = shown
    return result


def main(argv: list[str], t0: float) -> int:
    args = parse(argv)
    cell = Cell.find(load_spec(), args.workload)
    for env, sub in CACHES.items():
        os.environ.setdefault(env, str(ROOT / ".gpubench_cache" / sub))
    try:
        dev = require_card(cell.chips)
    except NoCard as e:
        print(f"gpubench: {e}", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    result = measure(cell, args.seed, args.seconds, bool(args.trace), dev, t0)
    print(card_line(), flush=True)
    loaded = forbidden_modules()
    if loaded:
        print(f"gpubench: the run loaded {loaded}, which no run may import", file=sys.stderr)
        return 4
    for name, v in result["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
