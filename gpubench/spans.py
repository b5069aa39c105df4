"""The program's spans in a trace, and the arithmetic that the span metrics share.

The program marks its serving path with profiler ranges named ``resnetc.*``
(``resnetc_tpu_torch.utils.metrics``): a request is one root span,
``resnetc.classify``, or ``resnetc.logits`` where the client calls ``logits``
itself, and everything on its thread inside the root's interval belongs to
that request.  Inside the root, ``resnetc.forward`` holds the backend's
forward.  Its host time splits three ways, which add up to the span's time:

- launch: inside the top-level ``resnetc::`` ops (the kernels' dispatch, the
  C++ op's checks, the launches);
- torch: inside the other host operations (torch ops, and any CUDA runtime
  call or profiler event made outside one);
- python: covered by no host operation, only by program spans.

A top-level op is a torch op that no other torch op holds; the forward's
torch ops outside ``resnetc::`` are counted so.

A program that records no such span (an older checkout) gives nothing.
"""

from __future__ import annotations

import bisect
import dataclasses

from gpubench import trace

PREFIX = "resnetc."
CLASSIFY = "resnetc.classify"
LOGITS = "resnetc.logits"
FORWARD = "resnetc.forward"


def is_span(name: str) -> bool:
    """A program span or the harness's own mark; ``resnetc::`` ops are not."""
    return name.startswith(PREFIX) or name == trace.SPAN


def named(t: trace.Trace, name: str) -> list[tuple[int, int]]:
    """The intervals of the spans called ``name``, by start."""
    return [(s, e) for s, e, n in t.host if n == name]


def _inside(iv: tuple[int, int], spans: list[tuple[int, int]]) -> bool:
    i = bisect.bisect_right(spans, (iv[0], float("inf"))) - 1
    return i >= 0 and spans[i][1] >= iv[1]


def roots(t: trace.Trace) -> int:
    """Requests in the trace: ``resnetc.classify`` spans, and ``resnetc.logits``
    spans that no ``resnetc.classify`` holds."""
    classify = named(t, CLASSIFY)
    return len(classify) + sum(not _inside(iv, classify) for iv in named(t, LOGITS))


def top_level(t: trace.Trace) -> list[tuple[int, int, str]]:
    """The torch ops (``ns::op``) that no other torch op holds, by start.  Other
    host events hold nothing: a runtime call or the profiler's own buffer
    request may stray past an op's edges on the clock."""
    out, end = [], None
    for s, e, name in sorted((h for h in t.host if "::" in h[2]), key=lambda h: (h[0], -h[1])):
        if end is None or s >= end:
            out.append((s, e, name))
            end = e
    return out


def _starting_in(events: list, starts: list, lo: int, hi: int) -> list:
    return events[bisect.bisect_left(starts, lo):bisect.bisect_left(starts, hi)]


def _union_ns(events: list, hi: int) -> int:
    """The time a list of intervals, by start, covers up to ``hi``."""
    total, end = 0, None
    for s, e, _ in events:
        e = min(e, hi)
        if end is None or s > end:
            total += max(0, e - s)
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


@dataclasses.dataclass
class Split:
    """Sums over every ``resnetc.forward`` span of a trace, in ns, and the
    count of its top-level torch ops outside ``resnetc::``."""

    python_ns: int = 0
    torch_ns: int = 0
    launch_ns: int = 0
    torch_ops: int = 0


def forward_split(t: trace.Trace) -> Split | None:
    """The host time inside ``resnetc.forward``, split as the module says, over
    the host operations that start inside it; None where the trace holds no
    such span."""
    forwards = named(t, FORWARD)
    if not forwards:
        return None
    ops = top_level(t)
    held = sorted(h for h in t.host if not is_span(h[2]))
    op_starts, held_starts = [h[0] for h in ops], [h[0] for h in held]
    out = Split()
    for lo, hi in forwards:
        launch = 0
        for s, e, name in _starting_in(ops, op_starts, lo, hi):
            if name.startswith(trace.OP_PREFIX):
                launch += min(e, hi) - s
            else:
                out.torch_ops += 1
        covered = _union_ns(_starting_in(held, held_starts, lo, hi), hi)
        out.python_ns += hi - lo - covered
        out.torch_ns += covered - launch
        out.launch_ns += launch
    return out


def per_request(t: trace.Trace | None) -> tuple[Split, int] | None:
    """``forward_split`` and the number of requests, or None where either is
    missing."""
    if t is None:
        return None
    split, n = forward_split(t), roots(t)
    if split is None or not n:
        return None
    return split, n


def overlap_ns(a: list[tuple[int, int]], b: list[tuple[int, int]]) -> int:
    """The time two lists of disjoint intervals, each by start, share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
