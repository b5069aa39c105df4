"""Arithmetic that several metric readers share."""

from __future__ import annotations

import statistics

from gpubench import work


def roofline_pct(r, op: str, count) -> float | None:
    """The least time of ``op``'s launches in the trace over their device
    time, in percent; ``count(shapes)`` gives one launch's (operations,
    bytes) from the op's input shapes.  None where the op did not run."""
    if r.trace is None:
        return None
    calls: dict = {}
    for d in r.trace.device:
        if d.op == op:
            spent, shapes = calls.get(d.call, (0.0, d.shapes))
            calls[d.call] = (spent + (d.end_ns - d.start_ns) / 1e9, shapes)
    spent = sum(s for s, _ in calls.values())
    if not calls or spent <= 0:
        return None
    least = sum(work.least_seconds(*count(shapes)) for _, shapes in calls.values())
    return 100.0 * least / spent


def idle_pct(r) -> float | None:
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)


def mfu_pct(r) -> float | None:
    """Images completed in the window times the model's operations, over
    the window's seconds, as a share of the card's int8 peak."""
    if not r.window.images:
        return None
    rate = work.model_flops(r.cell.config) * r.window.images / r.window.seconds
    return 100.0 * rate / work.PEAK_INT8_OPS


def glue_ms(r) -> float | None:
    """Device ms a request in operations that no ``resnetc::`` op launched."""
    if r.trace is None or not r.span.attempted:
        return None
    ns = sum(d.end_ns - d.start_ns for d in r.trace.device if d.op is None)
    return ns / 1e6 / r.span.attempted


def percentile_ms(latencies_s: list, pct: int) -> float | None:
    if len(latencies_s) < 2:
        return None
    return 1e3 * statistics.quantiles(latencies_s, n=100, method="inclusive")[pct - 1]
