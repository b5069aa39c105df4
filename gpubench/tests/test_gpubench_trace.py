"""The reading of the profiler: the idle share over the union of overlapping
device intervals, each device operation attributed to the ``resnetc::`` op
that launched it, idle gaps named by the host's operation, and the readers
that use them."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from gpubench import readers, run, trace
from gpubench.loops import Window

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


@dataclasses.dataclass
class Ev:
    """The parts of a profiler event that ``trace.read`` uses."""

    n: str
    s: int
    e: int
    dev: object = CPU
    corr: int = 0
    linked: int = 0
    thread: int = 1
    shp: tuple = ()
    ua: bool = False

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e

    def device_type(self):
        return self.dev

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked

    def start_thread_id(self):
        return self.thread

    def shapes(self):
        return list(self.shp)

    def is_user_annotation(self):
        return self.ua


def _trace(device: list[tuple[int, int]], span=(0, 100)) -> trace.Trace:
    return trace.Trace(span_ns=span, device=[trace.DeviceOp("k", s, e) for s, e in device],
                       host=[(span[0], span[1], trace.SPAN)])


def test_busy_is_the_union_of_overlapping_intervals():
    t = _trace([(10, 30), (20, 40), (25, 35), (60, 70), (90, 120)])
    assert t.intervals() == [(10, 40), (60, 70), (90, 100)]
    assert t.busy_s == pytest.approx(50e-9)
    assert t.gaps() == [(0, 10), (40, 60), (70, 90)]
    r = run.Reading(cell=None, setup_s=0, window=Window(), trace=t)
    assert readers.idle_pct(r) == pytest.approx(50.0)


def test_nested_interval_and_empty_trace():
    assert _trace([(10, 90), (20, 30)]).busy_s == pytest.approx(80e-9)
    t = _trace([])
    assert t.busy_s == 0 and t.gaps() == [(0, 100)]


def _events():
    sw3 = [(4096,)] + [()] * 7 + [(1024,)]
    return [
        Ev(trace.SPAN, 0, 1000, corr=1, ua=True),
        Ev(trace.SPAN, 0, 1000, dev=CUDA, ua=True),  # its mark on the device's timeline
        Ev("resnetc::chain_block_int8", 100, 200, corr=2, shp=tuple(sw3)),
        Ev("aten::empty", 110, 120, corr=3),
        Ev("cudaLaunchKernel", 150, 160, corr=90, linked=2),
        Ev("resnetc::chain_block_int8", 300, 400, corr=4, shp=tuple(sw3)),
        Ev("aten::fill_", 310, 330, corr=5),
        Ev("aten::argmax", 500, 600, corr=6),
        Ev("cudaStreamSynchronize", 700, 990, corr=7),
        Ev("chain_tile_kernel<1>", 160, 360, dev=CUDA, corr=90, linked=2),
        Ev("chain_tile_kernel<1>", 400, 500, dev=CUDA, corr=91, linked=4),
        Ev("fill_kernel", 360, 380, dev=CUDA, corr=92, linked=5),
        Ev("argmax_kernel", 620, 680, dev=CUDA, corr=93, linked=6),
        Ev("other_thread_op", 0, 1000, corr=8, thread=2),
    ]


def test_read_attributes_kernels_to_their_op():
    t = trace.read(_events())
    ops = {(d.name, d.op, d.call) for d in t.device}
    assert ("chain_tile_kernel<1>", "resnetc::chain_block_int8", 2) in ops
    assert ("chain_tile_kernel<1>", "resnetc::chain_block_int8", 4) in ops
    assert ("fill_kernel", "resnetc::chain_block_int8", 4) in ops  # launched inside the op
    assert ("argmax_kernel", None, None) in ops
    assert all(name != "other_thread_op" for _, _, name in t.host)
    assert t.busy_s == pytest.approx((380 - 160 + 500 - 400 + 680 - 620) * 1e-9)
    gaps = dict(t.breakdown()["idle_gaps"])
    assert set(gaps) == {"python", "resnetc::chain_block_int8", "aten::argmax",
                         "cudaStreamSynchronize"}
    assert gaps["cudaStreamSynchronize"] == pytest.approx(320e-9)  # 680..1000
    assert t.breakdown()["device_ops"][0] == ["chain_tile_kernel<1>", pytest.approx(300e-9)]


def test_roofline_and_glue_readers():
    import json

    cfg = json.loads((run.HERE / "configs" / "resnet152-int8_chain.json").read_text())
    cell = run.Cell("c", 1, cfg, {"batch": 32}, [], [])
    t = trace.read(_events())
    r = run.Reading(cell=cell, setup_s=0, window=Window(), trace=t, span=Window(attempted=2))
    roof = run.reader("roofline_pct.chain_block_int8")(r)
    from gpubench import work

    least = 2 * work.least_seconds(*work.bottleneck_block(cfg, 32, 1024))
    assert roof == pytest.approx(100 * least / ((200 + 100 + 20) * 1e-9))
    assert run.reader("glue_ms.bulk")(r) == pytest.approx(60e-6 / 2)
    assert run.reader("roofline_pct.basic_block_int8")(r) is None  # nothing to read


def test_host_clock_readers():
    w = Window(seconds=2.0, completed=4, images=128, latencies_s=[0.01, 0.02, 0.03, 0.04])
    cell = run.Cell("c", 1, {"block": "basic", "stage_blocks": [3, 4, 6, 3], "stem_width": 64,
                             "num_classes": 1000, "image_size": 224}, {}, [], [])
    r = run.Reading(cell=cell, setup_s=12.5, window=w, host_s=[0.004, 0.006])
    assert run.reader("images_per_s")(r) == 64.0
    assert run.reader("setup_s")(r) == 12.5
    assert run.reader("request_p50_ms")(r) == pytest.approx(25.0)
    assert run.reader("latency_p95_ms")(r) == pytest.approx(38.5)
    assert run.reader("host_ms.online")(r) == pytest.approx(5.0)
    assert run.reader("mfu.bulk")(r) == pytest.approx(100 * 64 * 7.327522816e9 / 1979e12)
    assert run.reader("idle_pct.online")(r) is None
