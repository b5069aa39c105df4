"""Structured step metrics and profiling hooks: one JSON line per record,
and ``torch.profiler`` traces.  Counterpart of
``resnetc_tpu/utils/metrics.py``: ``profile_trace`` writes a Chrome trace of
the host and the card (CPU and CUDA activities) where JAX writes an XProf
trace, and ``annotate`` names a region in it.

The serving path's spans (``annotate``, named by the constants below) mark
its layer boundaries on the profiler's timeline, on the clock of the
device operations they launch.  A request is one root span, ``CLASSIFY``
(or ``LOGITS`` where the caller calls ``logits`` itself), around ``UPLOAD``,
``FORWARD`` (``STEM``, ``STAGES``, ``HEAD`` inside it on the int8_chain
forwards) and ``READOUT``.  Where ``classify`` replays a captured graph of
the forward (``serve.InferenceEngine``), ``FORWARD`` holds ``CAPTURE``
around the capture, once per input shape, and ``REPLAY`` around each
replay; the stem, stage and head spans then appear only in the capture.
Their names start with ``resnetc.``, never with ``resnetc::``, the prefix
of the kernels' custom ops."""

from __future__ import annotations

import contextlib
import json
import sys
from typing import Any, Iterator, TextIO

from torch.autograd import profiler as _profiler

CLASSIFY = "resnetc.classify"
LOGITS = "resnetc.logits"
UPLOAD = "resnetc.upload"
FORWARD = "resnetc.forward"
READOUT = "resnetc.readout"
STEM = "resnetc.stem"
STAGES = ("resnetc.stage0", "resnetc.stage1", "resnetc.stage2", "resnetc.stage3")
HEAD = "resnetc.head"
REPLAY = "resnetc.replay"
CAPTURE = "resnetc.capture"


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


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """Context: name a region in profiler traces.  While a profiler runs it
    is ``record_function(name)``; otherwise one shared null context, so a
    span off costs one flag check and no dispatcher call."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF
