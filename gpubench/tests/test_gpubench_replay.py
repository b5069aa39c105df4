"""``replay_pct.online`` on synthetic profiler events: the share of the
requests whose root span holds a ``resnetc.replay`` span, 100 where every
request replays, 50 where half do, and nothing where no request does (a
program that captures no graph records no such span)."""

from __future__ import annotations

import pytest
from test_gpubench_trace import CUDA, Ev

from gpubench import run, trace
from gpubench.loops import Window


def _request(t0: int, replay: bool) -> list[Ev]:
    """One ``classify`` at ``t0`` (ns); its forward replays a graph, or runs
    one kernel op eagerly."""
    inner = ([Ev("resnetc.replay", t0 + 200, t0 + 300, ua=True),
              Ev("cudaGraphLaunch", t0 + 210, t0 + 290)]
             if replay else [Ev("resnetc::chain_block_int8", t0 + 200, t0 + 300)])
    return [
        Ev("resnetc.classify", t0, t0 + 1000, ua=True),
        Ev("resnetc.logits", t0 + 10, t0 + 900, ua=True),
        Ev("resnetc.forward", t0 + 100, t0 + 800, ua=True),
        *inner,
        Ev("k", t0 + 300, t0 + 700, dev=CUDA),
        Ev("resnetc.readout", t0 + 910, t0 + 1000, ua=True),
    ]


def _read(events, span):
    evs = [Ev(trace.SPAN, span[0], span[1], ua=True), *events]
    r = run.Reading(cell=None, setup_s=0, window=Window(), trace=trace.read(evs))
    return run.reader("replay_pct.online")(r)


@pytest.mark.parametrize("pattern,want", [((True,) * 4, 100.0), ((False, True) * 2, 50.0),
                                          ((False,) * 4, None)], ids=["100", "50", "absent"])
def test_replay_pct(pattern, want):
    events = [ev for i, rep in enumerate(pattern) for ev in _request(1000 * i, rep)]
    got = _read(events, (0, 1000 * len(pattern)))
    assert got == (pytest.approx(want) if want is not None else None)


def test_a_bare_logits_call_is_a_request_of_its_own():
    """A ``resnetc.logits`` root outside any ``classify`` counts as one request."""
    bare = [Ev("resnetc.logits", 2010, 2900, ua=True),
            Ev("resnetc.forward", 2100, 2800, ua=True)]
    got = _read(_request(0, True) + _request(1000, True) + bare, (0, 3000))
    assert got == pytest.approx(200 / 3)


def test_no_trace_gives_nothing():
    assert run.reader("replay_pct.online")(
        run.Reading(cell=None, setup_s=0, window=Window())) is None
