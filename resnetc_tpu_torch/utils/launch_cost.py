"""Host cost of one kernel launch through an ``ops.cuda`` wrapper, and the
served engine's latency, on the card.

    python3 resnetc_tpu_torch/utils/launch_cost.py [--root DIR] [--calls 20000] [--repeats 7]
        [--engine] [--samples 50] [--engine-repeats 3]

Times a tight loop of ``ops.cuda.elementwise.relu`` on a tensor of 4,096
fp32 values, whose kernel runs in a few microseconds, so the loop is bound
by the host: wall time over calls is what the host spends issuing one
launch through the wrapper.  Also times, alone, the check and count that
every wrapper makes around its launch (``_build.runs_plain`` and
``_build.launched`` where the tree has them, else the inline ``is_cuda``
test and ``LAUNCHES`` increment).  ``--engine`` also builds the engine
``chip_smoke.py`` serves (ResNet-152 ``int8_chain``, seeded weights,
calibration and images) and reads ``serve.bench_latency``'s p50 at batch 1
and 32 (CUDA events around each forward under ``inference_mode``,
``--engine-repeats`` times ``--samples``): what the launches' host cost
does end to end.  ``--root`` imports ``resnetc_tpu_torch`` from another
checkout, so two trees can be compared on one card in one run, in
turns (parent, change, change, parent); the kernels build at the first
launch, or a copy of this tree's ``_build/`` serves when ``csrc/`` is
unchanged.  Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def _per_call_us(fn, calls: int, repeats: int, sync) -> list[float]:
    out = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        sync()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    return out


def _engine_p50_ms(samples: int, repeats: int) -> dict:
    import torch

    from resnetc_tpu_torch.models import resnet
    from resnetc_tpu_torch.serve import InferenceEngine, bench_latency

    cfg = resnet.get_config("resnet152")
    variables = resnet.init(cfg, torch.Generator().manual_seed(0))
    calib = torch.randn((8, 224, 224, 3), generator=torch.Generator().manual_seed(1))
    eng = InferenceEngine(cfg, variables, backend="int8_chain", calib_batch=calib, device="cuda")
    x = torch.randn((32, 224, 224, 3), generator=torch.Generator().manual_seed(2)).cuda()
    return {"samples": samples, **{
        f"b{b}_p50_ms": [bench_latency(eng, x[:b], samples=samples, warmup=10).p50_ms
                         for _ in range(repeats)] for b in (1, 32)}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose resnetc_tpu_torch is timed")
    ap.add_argument("--calls", type=int, default=20000)
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--engine", action="store_true",
                    help="also time the served ResNet-152 int8_chain engine")
    ap.add_argument("--samples", type=int, default=50)
    ap.add_argument("--engine-repeats", type=int, default=3)
    args = ap.parse_args()
    sys.path[0] = str(Path(args.root).resolve())  # not this file's directory

    import torch

    if not torch.cuda.is_available():
        print("launch_cost: CUDA is not available", file=sys.stderr)
        return 1
    from resnetc_tpu_torch.ops.cuda import _build
    from resnetc_tpu_torch.ops.cuda.elementwise import relu

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    print(card[0] if card else "nvidia-smi: no card listed", flush=True)
    x = torch.randn(4096, device="cuda")
    y = relu(x)  # builds the kernels; also the warm-up
    torch.cuda.synchronize()
    if not torch.equal(y, torch.relu(x)):
        raise AssertionError("relu disagrees with torch.relu")
    nothing = lambda: None  # noqa: E731

    if hasattr(_build, "runs_plain"):
        # A tree whose wrappers call ops tests only the switch; an older one
        # tests the tensor's device as well.
        plain_args = (x,) if inspect.signature(_build.runs_plain).parameters else ()

        def checks():
            _build.runs_plain(*plain_args)
            _build.launched("relu", y)
    else:
        def checks():
            not x.is_cuda  # noqa: B015
            _build.LAUNCHES["relu"] += 1

    wrapper = _per_call_us(lambda: relu(x), args.calls, args.repeats, torch.cuda.synchronize)
    alone = _per_call_us(checks, args.calls, args.repeats, nothing)
    loop = _per_call_us(nothing, args.calls, args.repeats, nothing)
    result = {
        "root": str(Path(args.root).resolve()), "torch": torch.__version__,
        "calls": args.calls, "repeats": args.repeats,
        "relu_call_us": wrapper, "relu_call_us_median": statistics.median(wrapper),
        "checks_us": alone, "checks_us_median": statistics.median(alone),
        "empty_loop_us_median": statistics.median(loop),
    }
    if args.engine:
        result.update(_engine_p50_ms(args.samples, args.engine_repeats))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
