"""``classify``'s captured forwards (``serve._Graphs``) on the CPU.

The CPU has no CUDA graph, so an engine there keeps no graphs: ``classify``
runs the eager forward and equals ``logits(x).argmax(-1)``.  The cache's
logic runs here with a stand-in for the capture (``_FakeGraph``: its replay
runs the eager forward over the static input into the static output): a
key's first call runs eagerly, its second captures and replays, its third
replays; a shape seen once is never captured; a changed route flag is a new
key, never a stale replay; ``logits`` without ``transient`` runs the forward
it ran before, whatever ``classify`` did.  The card tests
(``tests/test_torch_cuda.py``) hold real graphs to the eager logits bit for
bit.  The file imports no JAX.
"""

from __future__ import annotations

import collections
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from resnetc_tpu_torch import serve
from resnetc_tpu_torch.models import resnet as tresnet
from resnetc_tpu_torch.ops.cuda import _build, fused
from resnetc_tpu_torch.serve import InferenceEngine
from resnetc_tpu_torch.utils import debug
from resnetc_tpu_torch.utils import metrics as tmetrics

BOTTLENECK = tresnet.ResNetConfig(name="tiny", block="bottleneck", stage_blocks=(3, 2, 2, 2),
                                  num_classes=11, stem_width=16)
BASIC = tresnet.ResNetConfig(name="tiny_basic", block="basic", stage_blocks=(2, 2, 2, 2),
                             num_classes=11, stem_width=16)


def _x(batch: int = 2, seed: int = 3, size: int = 32) -> torch.Tensor:
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal((batch, size, size, 3)).astype(np.float32))


def _engine(cfg=BOTTLENECK, backend="int8_chain"):
    variables = tresnet.init(cfg, torch.Generator().manual_seed(7))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return InferenceEngine(cfg, variables, backend=backend, device="cpu",
                               calib_batch=_x(seed=9))


class _FakeGraph:
    """A capture's stand-in: its replay runs the forward eagerly over the
    static input and writes the static output."""

    def __init__(self, forward, static_in, static_out, log):
        self.forward, self.static_in, self.static_out, self.log = (
            forward, static_in, static_out, log)

    def replay(self):
        self.log["replay"] += 1
        self.static_out.copy_(self.forward(self.static_in))


@pytest.fixture()
def faked(monkeypatch):
    """An int8_chain engine on the CPU with a graph cache whose captures are
    ``_FakeGraph``s; the log counts eager forwards, captures and replays."""
    log = collections.Counter()

    def capture(forward, images):
        log["capture"] += 1
        static_in = torch.zeros_like(images)
        static_out = forward(static_in)
        return _FakeGraph(forward, static_in, static_out, log), static_in, static_out

    monkeypatch.setattr(serve, "_capture", capture)
    eng = _engine()
    eng.graphs = serve._Graphs()
    forward = eng._forward

    def counted(images):
        log["forward"] += 1
        return forward(images)

    eng._forward = counted
    return eng, log


@pytest.mark.parametrize("cfg", [BOTTLENECK, BASIC], ids=["bottleneck", "basic"])
def test_on_the_cpu_classify_captures_nothing_and_equals_the_argmax(cfg):
    eng, x = _engine(cfg), _x()
    assert eng.graphs is None
    want = eng.logits(x).argmax(-1).numpy()
    for _ in range(3):
        np.testing.assert_array_equal(eng.classify(x), want)
    assert eng.graphs is None


def test_only_int8_chain_on_the_card_keeps_graphs():
    assert _engine(backend="fp").graphs is None
    assert _engine().graphs is None  # the CPU


def test_first_call_eager_second_captures_third_replays(faked):
    eng, log = faked
    x = _x()
    want = eng.logits(x).argmax(-1).numpy()
    assert log == {"forward": 1}
    got = [eng.classify(x)]
    assert log == {"forward": 2} and not eng.graphs.captured
    got.append(eng.classify(x))
    assert log["capture"] == 1 and log["replay"] == 1 and len(eng.graphs.captured) == 1
    got.append(eng.classify(x))
    assert log["capture"] == 1 and log["replay"] == 2
    for g in got:
        np.testing.assert_array_equal(g, want)


def test_the_spans_say_eager_capture_replay(faked):
    """Under the profiler: call 1 holds neither span, call 2 a capture and a
    replay, call 3 a replay, each inside ``resnetc.forward``."""
    eng, _ = faked
    x = _x()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            eng.classify(x)
    evs = [e for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    roots = sorted((e for e in evs if e.name() == tmetrics.CLASSIFY), key=lambda e: e.start_ns())
    forwards = [e for e in evs if e.name() == tmetrics.FORWARD]

    def names_in(root):
        return sorted(e.name() for e in evs if e.name() in (tmetrics.CAPTURE, tmetrics.REPLAY)
                      and root.start_ns() <= e.start_ns() and e.end_ns() <= root.end_ns()
                      and any(f.start_ns() <= e.start_ns() and e.end_ns() <= f.end_ns()
                              for f in forwards))

    assert [names_in(r) for r in roots] == [[], [tmetrics.CAPTURE, tmetrics.REPLAY],
                                            [tmetrics.REPLAY]]


def test_distinct_inputs_each_replay_to_their_own_classes(faked):
    eng, log = faked
    xs = [_x(seed=s) for s in range(8)]
    want = [eng.logits(x).argmax(-1).numpy() for x in xs]
    for _ in range(2):
        for x, w in zip(xs, want):
            np.testing.assert_array_equal(eng.classify(x), w)
    assert log["capture"] == 1 and len(eng.graphs.captured) == 1


def test_a_shape_seen_once_is_never_captured(faked):
    eng, log = faked
    for batch in (1, 2, 3):
        eng.classify(_x(batch=batch))
    assert log["capture"] == 0 and not eng.graphs.captured
    assert len(eng.graphs.seen) == 3


def _flipped(name):
    v = getattr(fused, name)
    if isinstance(v, bool):
        return not v
    return () if v else (0,)


@pytest.mark.parametrize("name", fused.ROUTE_FLAGS)
def test_a_route_flag_changed_between_calls_is_a_new_key(faked, monkeypatch, name):
    """After a capture, a flag flipped: the next call runs eagerly on the new
    route (a new key, seen once), the one after captures it; the classes are
    the eager forward's under the flag each call ran with."""
    eng, log = faked
    x = _x()
    before = fused.route_flags()
    for _ in range(2):
        eng.classify(x)
    assert log["capture"] == 1
    monkeypatch.setattr(fused, name, _flipped(name))
    assert fused.route_flags() != before
    assert fused.route_flags()[fused.ROUTE_FLAGS.index(name)] == getattr(fused, name)
    want = eng.logits(x).argmax(-1).numpy()
    forwards = log["forward"]
    np.testing.assert_array_equal(eng.classify(x), want)
    assert log["capture"] == 1 and log["forward"] == forwards + 1
    np.testing.assert_array_equal(eng.classify(x), want)
    assert log["capture"] == 2 and len(eng.graphs.captured) == 2


def test_the_debugging_contexts_run_eagerly(faked):
    eng, log = faked
    x = _x()
    for _ in range(3):
        eng.classify(x)
    replays = log["replay"]
    with debug.plain_kernels():
        eng.classify(x)
    assert log["replay"] == replays


def test_replay_and_capture_are_program_spans_and_null_when_off():
    for name in (tmetrics.REPLAY, tmetrics.CAPTURE):
        assert name.startswith("resnetc.") and not name.startswith("resnetc::")
    assert not torch.autograd.profiler._is_profiler_enabled
    assert tmetrics.annotate(tmetrics.REPLAY) is tmetrics.annotate(tmetrics.CAPTURE)
    assert tmetrics.annotate(tmetrics.REPLAY) is tmetrics.annotate(tmetrics.FORWARD)


def _op_counts(eng, x) -> tuple:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = eng.logits(x)
    return out, collections.Counter(e.name for e in prof.events()
                                    if e.name.startswith("resnetc::"))


def test_logits_after_classify_runs_what_it_ran_before(faked):
    """``logits`` without ``transient``: the same ``resnetc::`` ops (and
    ``_build.LAUNCHES``) and the same logits, in a tensor of its own, before
    and after ``classify`` captured and replayed."""
    eng, _ = faked
    x = _x()
    _build.reset_launches()
    first, ops = _op_counts(eng, x)
    launches = dict(_build.LAUNCHES)
    for _ in range(3):
        eng.classify(x)
    (_, static_in, static_out), = eng.graphs.captured.values()
    _build.reset_launches()
    again, ops_again = _op_counts(eng, x)
    assert ops and ops_again == ops
    assert dict(_build.LAUNCHES) == launches
    assert torch.equal(again, first)
    assert again.data_ptr() != static_out.data_ptr()
