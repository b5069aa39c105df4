"""The clients that drive the program, one module a loop kind, found by the
``loop`` of a traffic file.  Each has ``warm(engine, pool, order, traffic)``
and ``window(engine, pool, order, traffic, seconds=, requests=)``, which
runs for ``seconds`` on the host's clock or for ``requests`` requests and
returns a ``Window``."""

from __future__ import annotations

import dataclasses
import itertools
import time


@dataclasses.dataclass
class Window:
    #: The window's length on the host's clock.
    seconds: float = 0.0
    #: Requests issued, and those whose answers reached the host in the window.
    attempted: int = 0
    completed: int = 0
    #: Images of the completed requests.
    images: int = 0
    #: Each completed request's latency, from its call to its answer in hand.
    latencies_s: list = dataclasses.field(default_factory=list)
    #: Every answer received, in the window or while it drained:
    #: (pool index, the classes on the host).
    answers: list = dataclasses.field(default_factory=list)


def schedule(order: list[int]):
    """The pool indices of successive requests: ``order`` over and over."""
    return itertools.cycle(order)


def deadline(seconds: float | None) -> float:
    return time.perf_counter() + seconds if seconds is not None else float("inf")
