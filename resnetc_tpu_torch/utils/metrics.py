"""Structured step metrics and profiling hooks: one JSON line per record,
a wall-clock timer, and ``torch.profiler`` traces.  Counterpart of
``resnetc_tpu/utils/metrics.py``: ``profile_trace`` writes a Chrome trace of
the host and the card (CPU and CUDA activities) where JAX writes an XProf
trace, and ``annotate`` names a region in it."""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import Any, Iterator, TextIO


class MetricsLogger:
    """Emit one JSON line per record; machine-parseable, human-skimmable."""

    def __init__(self, stream: TextIO | None = None, prefix: str = ""):
        self.stream = stream or sys.stdout
        self.prefix = prefix

    def log(self, record: dict[str, Any]) -> None:
        if self.prefix:
            record = {"tag": self.prefix, **record}
        self.stream.write(json.dumps(record, default=float) + "\n")
        self.stream.flush()


@contextlib.contextmanager
def timer() -> Iterator[dict[str, float]]:
    """``with timer() as t: ...; t['seconds']`` (host clock: the caller
    synchronises the card inside the block where it times device work)."""
    box: dict[str, float] = {}
    t0 = time.perf_counter()
    try:
        yield box
    finally:
        box["seconds"] = time.perf_counter() - t0


@contextlib.contextmanager
def profile_trace(logdir: str, *, enabled: bool = True) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block (CPU operations, and
    the card's kernels and copies where CUDA is available) and write it to
    ``logdir`` as a Chrome trace (``trace.json``, for chrome://tracing or
    Perfetto).  ``enabled=False`` runs the block without a profiler."""
    if not enabled:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Decorator/context: name a region in profiler traces."""
    from torch.profiler import record_function

    return record_function(name)
