"""Structured step metrics: one JSON line per record, and a wall-clock
timer.  Counterpart of ``resnetc_tpu/utils/metrics.py:19-43``; the
profiler helpers are not ported yet."""

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
