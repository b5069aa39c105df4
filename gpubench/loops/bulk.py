"""Offline scoring: one client in a closed loop over batches of the pool, with
``in_flight`` batches dispatched ahead.  A batch is ``engine.logits``, the
argmax on the device and a copy of the classes into pinned host memory;
batch i + 1 is issued before batch i's classes are waited on.  A batch
completes when its classes are on the host."""

from __future__ import annotations

import collections
import time

import torch

from gpubench.loops import Window, deadline, schedule


def _issue(engine, x: torch.Tensor, host: torch.Tensor) -> torch.cuda.Event | None:
    classes = engine.logits(x).argmax(dim=-1)
    host.copy_(classes, non_blocking=True)
    if not x.is_cuda:
        return None
    done = torch.cuda.Event()
    done.record()
    return done


def window(engine, pool, order, traffic, *, seconds=None, requests=None) -> Window:
    depth = traffic["in_flight"]
    bufs = [torch.empty(pool[0].shape[0], dtype=torch.int64, pin_memory=pool[0].is_cuda)
            for _ in range(depth + 1)]
    w, nxt, pending = Window(), schedule(order), collections.deque()
    limit = requests if requests is not None else float("inf")
    t0 = time.perf_counter()
    end = deadline(seconds)
    while True:
        while (len(pending) < depth and w.attempted < limit
               and time.perf_counter() < end):
            i = next(nxt)
            buf = bufs[w.attempted % len(bufs)]
            pending.append((i, buf, time.perf_counter(), _issue(engine, pool[i], buf)))
            w.attempted += 1
        if not pending:
            break
        i, buf, t_issue, done = pending.popleft()
        if done is not None:
            done.synchronize()
        t_done = time.perf_counter()
        w.answers.append((i, buf.numpy().copy()))
        if t_done <= end:
            w.completed += 1
            w.images += buf.shape[0]
            w.latencies_s.append(t_done - t_issue)
    w.seconds = seconds if seconds is not None else time.perf_counter() - t0
    return w


def warm(engine, pool, order, traffic) -> None:
    window(engine, pool, order, traffic, requests=traffic["warmup_requests"])
