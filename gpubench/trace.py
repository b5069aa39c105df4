"""A span of the window under ``torch.profiler``, read in memory.

``profiled(fn)`` runs ``fn`` inside the profiler, between two marks of its
own, and returns a ``Trace``: every device operation (kernels, copies,
fills) with its interval on the device, the ``resnetc::`` op of the program
that launched it where there is one, that op's input shapes, and the host's
operations on the calling thread.  The span is the interval between the
marks.  ``busy_s`` is the union of the device intervals inside it, so that
operations that overlap count once.  An idle gap is named by the innermost
host operation running at its midpoint.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable

import torch

SPAN = "gpubench.span"
OP_PREFIX = "resnetc::"


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int
    #: The program's ``resnetc::`` op around the launch, or None.
    op: str | None = None
    #: That op's launch, one per call: the kernels of one call share it.
    call: int | None = None
    #: That op's input shapes, in its schema's order.
    shapes: list | None = None


@dataclasses.dataclass
class Trace:
    span_ns: tuple[int, int]
    device: list[DeviceOp]
    #: Host operations of the span's thread: (start_ns, end_ns, name), by start.
    host: list[tuple[int, int, str]]

    def __post_init__(self):
        self._host_starts = [h[0] for h in self.host]

    @property
    def window_s(self) -> float:
        return (self.span_ns[1] - self.span_ns[0]) / 1e9

    def intervals(self) -> list[tuple[int, int]]:
        """The union of the device intervals, clipped to the span, in order."""
        lo, hi = self.span_ns
        spans = sorted((max(d.start_ns, lo), min(d.end_ns, hi)) for d in self.device)
        merged: list[list[int]] = []
        for s, e in spans:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) / 1e9

    def gaps(self) -> list[tuple[int, int]]:
        """The span's intervals with nothing running on the device."""
        out, at = [], self.span_ns[0]
        for s, e in self.intervals():
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if self.span_ns[1] > at:
            out.append((at, self.span_ns[1]))
        return out

    def host_at(self, t: int) -> str:
        """The innermost host operation running at ``t``: the latest-started
        of those that contain it, ``python`` where only the span does."""
        i = bisect.bisect_right(self._host_starts, t)
        for s, e, name in reversed(self.host[max(0, i - 20000):i]):
            if e >= t and name != SPAN:
                return name
        return "python"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations with the most time, and the idle time of the
        span summed by what the host was doing, each as [name, seconds]."""
        by_op: dict[str, float] = {}
        for d in self.device:
            by_op[d.name] = by_op.get(d.name, 0.0) + (d.end_ns - d.start_ns) / 1e9
        idle: dict[str, float] = {}
        for s, e in self.gaps():
            name = self.host_at((s + e) // 2)
            idle[name] = idle.get(name, 0.0) + (e - s) / 1e9
        return {"device_ops": _top(by_op, top), "idle_gaps": _top(idle, top)}


def _top(d: dict[str, float], n: int) -> list:
    return [[k[:200], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def profiled(fn: Callable[[], object]) -> tuple[object, Trace]:
    """Run ``fn`` under the profiler; its result and the trace of it."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        with record_function(SPAN):
            torch.cuda.synchronize()
            result = fn()
            torch.cuda.synchronize()
    return result, read(prof.profiler.kineto_results.events())


def read(events) -> Trace:
    """A ``Trace`` from the profiler's events (``_KinetoEvent``s)."""
    cpu, dev, span = [], [], None
    for ev in events:
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not ev.is_user_annotation():  # the span's mark on the device's timeline
                dev.append(ev)
        elif ev.name() == SPAN:
            span = ev
        else:
            cpu.append(ev)
    if span is None:
        raise RuntimeError("the profiler's events hold no span mark")
    thread = span.start_thread_id()
    lo, hi = span.start_ns(), span.end_ns()
    mine = sorted((e for e in cpu if e.start_thread_id() == thread and e.end_ns() >= lo
                   and e.start_ns() <= hi), key=lambda e: e.start_ns())
    by_id = {e.correlation_id(): e for e in mine if e.linked_correlation_id() == 0}
    ops = [e for e in mine if e.name().startswith(OP_PREFIX)]
    op_starts = [e.start_ns() for e in ops]

    def enclosing_op(e):
        i = bisect.bisect_right(op_starts, e.start_ns()) - 1
        if i >= 0 and ops[i].end_ns() >= e.end_ns():
            return ops[i]
        return None

    device = []
    for d in dev:
        op = None
        launcher = by_id.get(d.linked_correlation_id())
        if launcher is not None:
            op = enclosing_op(launcher)
        device.append(DeviceOp(
            name=d.name(), start_ns=d.start_ns(), end_ns=d.end_ns(),
            op=op.name() if op is not None else None,
            call=op.correlation_id() if op is not None else None,
            shapes=[list(s) for s in op.shapes()] if op is not None else None,
        ))
    host = [(e.start_ns(), e.end_ns(), e.name()) for e in mine]
    host.append((lo, hi, SPAN))
    host.sort()
    return Trace(span_ns=(lo, hi), device=device, host=host)
