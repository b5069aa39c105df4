"""Host cost of one kernel launch through an ``ops.cuda`` wrapper, on the card.

    python3 resnetc_tpu_torch/utils/launch_cost.py [--root DIR] [--calls 20000] [--repeats 7]

Times a tight loop of ``ops.cuda.elementwise.relu`` on a tensor of 4,096
fp32 values, whose kernel runs in a few microseconds, so the loop is bound
by the host: wall time over calls is what the host spends issuing one
launch through the wrapper.  Also times, alone, the check and count that
every wrapper makes around its launch (``_build.runs_plain`` and
``_build.launched`` where the tree has them, else the inline ``is_cuda``
test and ``LAUNCHES`` increment).  ``--root`` imports ``resnetc_tpu_torch``
from another checkout, so two trees can be compared in one session on one
card.  Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose resnetc_tpu_torch is timed")
    ap.add_argument("--calls", type=int, default=20000)
    ap.add_argument("--repeats", type=int, default=7)
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
        def checks():
            _build.runs_plain(x)
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
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
