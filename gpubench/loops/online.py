"""A client of ``classify``: one client in a closed loop, each request
``engine.classify`` on a batch of the pool, the classes on the host before
the next request.  A request's latency runs from the call to its return."""

from __future__ import annotations

import time

from gpubench.loops import Window, deadline, schedule


def window(engine, pool, order, traffic, *, seconds=None, requests=None) -> Window:
    w, nxt = Window(), schedule(order)
    limit = requests if requests is not None else float("inf")
    t0 = time.perf_counter()
    end = deadline(seconds)
    while w.attempted < limit and time.perf_counter() < end:
        i = next(nxt)
        t_call = time.perf_counter()
        classes = engine.classify(pool[i])
        t_done = time.perf_counter()
        w.attempted += 1
        w.answers.append((i, classes))
        if t_done <= end:
            w.completed += 1
            w.images += len(classes)
            w.latencies_s.append(t_done - t_call)
    w.seconds = seconds if seconds is not None else time.perf_counter() - t0
    return w


def warm(engine, pool, order, traffic) -> None:
    window(engine, pool, order, traffic, requests=traffic["warmup_requests"])
