"""The span metrics on synthetic profiler events: requests counted by their
root spans, the host time inside ``resnetc.forward`` split into Python, torch
ops and ``resnetc::`` ops, the forward's torch ops counted at the top level,
and the device's idle time inside the forward by interval overlap.  A trace
with no program span (an older checkout) gives nothing."""

from __future__ import annotations

import pytest
from test_gpubench_trace import CUDA, Ev

from gpubench import run, spans, trace
from gpubench.loops import Window

READERS = ("forward_ops.online", "forward_python_ms.online", "forward_torch_ms.online",
           "launch_ms.online", "idle_forward_pct.online")


def _request(t0: int, corr: int) -> list[Ev]:
    """One ``classify`` at ``t0`` (ns): the forward 100..900 after it holds a
    stem with two torch ops (one with a child), a stage with a ``resnetc::`` op
    that launches a kernel, and a head with one torch op; the readout waits."""
    def ev(name, s, e, **kw):
        return Ev(name, t0 + s, t0 + e, **kw)

    return [
        ev("resnetc.classify", 0, 1000, ua=True),
        ev("resnetc.logits", 10, 910, ua=True),
        ev("resnetc.upload", 20, 90, ua=True),
        ev("aten::to", 30, 80),  # outside the forward: not counted
        ev("resnetc.forward", 100, 900, ua=True),
        ev("resnetc.stem", 110, 300, ua=True),
        ev("aten::conv2d", 120, 200),
        ev("aten::convolution", 130, 190),  # a child: not top level
        ev("aten::to", 210, 220),
        ev("resnetc.stage0", 300, 700, ua=True),
        ev("resnetc::chain_block_int8", 400, 500, corr=corr),
        ev("cudaLaunchKernel", 450, 460, corr=corr + 1, linked=corr),
        ev("resnetc.head", 700, 890, ua=True),
        ev("aten::mean", 750, 800),
        ev("resnetc.readout", 920, 1000, ua=True),
        ev("aten::argmax", 930, 940),
        ev("cudaStreamSynchronize", 950, 990),
        ev("chain_tile_kernel", 500, 960, dev=CUDA, corr=corr + 1, linked=corr),
    ]


def _reading(events, span=(0, 2000)) -> run.Reading:
    evs = [Ev(trace.SPAN, span[0], span[1], ua=True), *events]
    return run.Reading(cell=None, setup_s=0, window=Window(), trace=trace.read(evs))


def test_one_request():
    r = _reading(_request(0, 10))
    assert spans.roots(r.trace) == 1
    # top level in the forward: conv2d 80, to 10, the resnetc:: op 100, mean 50
    assert run.reader("forward_ops.online")(r) == 3
    assert run.reader("launch_ms.online")(r) == pytest.approx(100e-6)
    assert run.reader("forward_torch_ms.online")(r) == pytest.approx(140e-6)
    assert run.reader("forward_python_ms.online")(r) == pytest.approx((800 - 240) * 1e-6)
    # idle: 0..500 (the forward holds 100..500) and 960..2000 (none of it)
    assert run.reader("idle_forward_pct.online")(r) == pytest.approx(100 * 400 / (500 + 1040))


def test_several_requests_are_each_one_root():
    r = _reading(_request(0, 10) + _request(1000, 20) + _request(2000, 30), span=(0, 3000))
    assert spans.roots(r.trace) == 3
    assert run.reader("forward_ops.online")(r) == 3
    assert run.reader("forward_python_ms.online")(r) == pytest.approx(560e-6)
    # idle: 0..500, 960..1500, 1960..2500, 2960..3000; inside forwards:
    # 100..500, 1100..1500, 2100..2500
    idle = 500 + 540 + 540 + 40
    assert run.reader("idle_forward_pct.online")(r) == pytest.approx(100 * 1200 / idle)


def test_a_logits_call_outside_classify_is_a_root():
    events = [e for e in _request(0, 10) if not e.n.startswith(("resnetc.classify",
                                                                 "resnetc.readout"))]
    assert spans.roots(_reading(events + _request(1000, 20)).trace) == 2


def test_a_gap_partly_inside_the_forward_counts_only_its_overlap():
    events = [
        Ev("resnetc.logits", 0, 1000, ua=True),
        Ev("resnetc.forward", 200, 600, ua=True),
        Ev("k1", 0, 100, dev=CUDA),
        Ev("k2", 500, 1000, dev=CUDA),
    ]
    r = _reading(events, span=(0, 1000))
    # the one gap, 100..500, overlaps the forward 200..500
    assert run.reader("idle_forward_pct.online")(r) == pytest.approx(75.0)
    assert run.reader("forward_python_ms.online")(r) == pytest.approx(400e-6)
    assert run.reader("forward_ops.online")(r) == 0


def test_a_stray_runtime_event_hides_no_op_from_the_count():
    """A host event that is no torch op (a runtime call or the profiler's
    buffer request) and strays over an op's start: its time is covered, but
    the op still counts."""
    stray = Ev("Activity Buffer Request", 115, 125)  # over aten::conv2d's start at 120
    r = _reading(_request(0, 10) + [stray])
    assert run.reader("forward_ops.online")(r) == 3
    # covered: 115..200 (the stray and conv2d), to 10, the resnetc:: op 100, mean 50
    assert run.reader("launch_ms.online")(r) == pytest.approx(100e-6)
    assert run.reader("forward_torch_ms.online")(r) == pytest.approx(145e-6)
    assert run.reader("forward_python_ms.online")(r) == pytest.approx((800 - 245) * 1e-6)


def test_the_three_times_add_up_to_the_forward():
    r = _reading(_request(0, 10) + _request(1000, 20), span=(0, 2000))
    parts = sum(run.reader(m)(r) for m in READERS[1:4])
    assert parts == pytest.approx(800e-6)


def test_overlap_of_interval_lists():
    assert spans.overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.overlap_ns([(0, 10)], [(10, 20)]) == 0
    assert spans.overlap_ns([], [(0, 5)]) == 0


@pytest.mark.parametrize("name", READERS)
def test_a_trace_without_program_spans_gives_nothing(name):
    events = [Ev("aten::conv2d", 10, 20), Ev("k", 15, 30, dev=CUDA)]
    assert run.reader(name)(_reading(events, span=(0, 100))) is None
    assert run.reader(name)(run.Reading(cell=None, setup_s=0, window=Window())) is None
