"""The serving path's spans (``utils.metrics.annotate``) on the CPU.

Small ``int8_chain`` engines of both families serve ``classify`` under
``torch.profiler``: each request is one ``resnetc.classify`` root around
``resnetc.logits`` (``resnetc.upload``, ``resnetc.forward``) and
``resnetc.readout``; the forward holds ``resnetc.stem``, four stage spans and
``resnetc.head``.  No span takes the kernels' ``resnetc::`` prefix.  With no
profiler ``annotate`` hands back one shared null context and the logits are
the same bit for bit.  ``gpubench``'s span metrics over such a profile agree
with the profiler's own parent links.  The card test holds the shared clock:
a kernel launched inside ``resnetc.stage1`` starts on the device after the
span starts.  The file imports no JAX, so it also runs on the card
(``python -m pytest tests/test_torch_spans.py -q --noconftest``).
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from gpubench import run, spans, trace
from gpubench.loops import Window
from resnetc_tpu_torch import export as texport
from resnetc_tpu_torch.models import resnet as tresnet
from resnetc_tpu_torch.serve import InferenceEngine
from resnetc_tpu_torch.utils import metrics as tmetrics

BOTTLENECK = tresnet.ResNetConfig(name="tiny", block="bottleneck", stage_blocks=(3, 2, 2, 2),
                                  num_classes=11, stem_width=16)
BASIC = tresnet.ResNetConfig(name="tiny_basic", block="basic", stage_blocks=(2, 2, 2, 2),
                             num_classes=11, stem_width=16)
#: A tiny ResNeXt (4 groups of 8 channels at stage 0): the grouped route.
GROUPED = tresnet.ResNetConfig(name="tiny_grouped", block="bottleneck",
                               stage_blocks=(2, 1, 1, 1), num_classes=11, groups=4,
                               width_per_group=8)
NAMES = (tmetrics.CLASSIFY, tmetrics.LOGITS, tmetrics.UPLOAD, tmetrics.FORWARD,
         tmetrics.READOUT, tmetrics.STEM, *tmetrics.STAGES, tmetrics.HEAD)
REQUESTS = 2


def _x(size: int = 64, batch: int = 2, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((batch, size, size, 3)).astype(np.float32)


def _engine(cfg, device="cpu", size=64):
    variables = tresnet.init(cfg, torch.Generator().manual_seed(7))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return InferenceEngine(cfg, variables, backend="int8_chain", device=device,
                               calib_batch=_x(size, seed=9))


@pytest.fixture(scope="module", params=[BOTTLENECK, BASIC, GROUPED],
                ids=["bottleneck", "basic", "grouped"])
def served(request):
    """An engine, its input, the logits with no profiler, and a profile of
    ``REQUESTS`` ``classify`` calls inside the harness's span mark."""
    eng, x = _engine(request.param), _x()
    off = eng.logits(x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.SPAN):
            on = eng.logits(x)
            for _ in range(REQUESTS):
                eng.classify(x)
    return eng, off, on, prof


def _user_spans(prof) -> list:
    return [e for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.name() != trace.SPAN]


def _children(parent, events) -> list:
    return [e for e in events if parent.start_ns() <= e.start_ns()
            and e.end_ns() <= parent.end_ns() and e is not parent]


def test_span_names_are_the_programs_and_never_an_op_prefix():
    assert len(set(NAMES)) == 11
    assert all(n.startswith("resnetc.") and not n.startswith(trace.OP_PREFIX) for n in NAMES)


def test_annotate_is_one_shared_null_context_when_no_profiler_runs():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert tmetrics.annotate(tmetrics.STEM) is tmetrics.annotate(tmetrics.HEAD)
    with tmetrics.annotate(tmetrics.FORWARD) as got:
        assert got is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled
        assert isinstance(tmetrics.annotate(tmetrics.STEM), record_function)
    assert tmetrics.annotate(tmetrics.STEM) is tmetrics.annotate(tmetrics.HEAD)


def test_logits_are_the_same_with_the_profiler_on_and_off(served):
    _, off, on, _ = served
    assert torch.equal(off, on)


def test_spans_nest_as_the_layers_do(served):
    _, _, _, prof = served
    evs = _user_spans(prof)
    assert {e.name() for e in evs} == set(NAMES)
    assert not any(e.name().startswith(trace.OP_PREFIX) for e in evs)
    roots = [e for e in evs if e.name() == tmetrics.CLASSIFY]
    assert len(roots) == REQUESTS
    bare = [e for e in evs if e.name() == tmetrics.LOGITS
            and not any(r.start_ns() <= e.start_ns() <= r.end_ns() for r in roots)]
    assert len(bare) == 1  # the direct ``logits`` call is a root of its own
    for root in roots:
        inside = _children(root, evs)
        assert sorted(e.name() for e in inside) == sorted(set(NAMES) - {tmetrics.CLASSIFY})
        by = {e.name(): e for e in inside}
        logits, forward = by[tmetrics.LOGITS], by[tmetrics.FORWARD]
        assert {e.name() for e in _children(logits, inside)} == set(NAMES) - {
            tmetrics.CLASSIFY, tmetrics.LOGITS, tmetrics.READOUT}
        assert by[tmetrics.UPLOAD].end_ns() <= forward.start_ns()
        assert by[tmetrics.READOUT].start_ns() >= logits.end_ns()
        layers = sorted(_children(forward, inside), key=lambda e: e.start_ns())
        assert [e.name() for e in layers] == [tmetrics.STEM, *tmetrics.STAGES, tmetrics.HEAD]


def test_the_grouped_route_launches_only_the_grouped_blocks_in_its_stages():
    """Each stage span of the grouped route holds its blocks' ops and no
    other kernel op: ``grouped_ds_block_s2_int8`` first in stages 1-3,
    ``grouped_block_int8`` for the rest; the stem pool in the stem span."""
    eng, x = _engine(GROUPED), _x()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.logits(x)
    evs = list(prof.profiler.kineto_results.events())
    ops = sorted((e for e in evs if e.name().startswith(trace.OP_PREFIX)
                  and not e.is_user_annotation()), key=lambda e: e.start_ns())

    def inside(span):
        s = next(e for e in evs if e.name() == span and e.is_user_annotation())
        return [e.name()[len(trace.OP_PREFIX):] for e in ops
                if s.start_ns() <= e.start_ns() and e.end_ns() <= s.end_ns()]

    assert inside(tmetrics.STEM) == ["stem_pool_int8"]
    assert inside(tmetrics.STAGES[0]) == ["grouped_block_int8"] * 2
    for stage in (1, 2, 3):
        assert inside(tmetrics.STAGES[stage]) == ["grouped_ds_block_s2_int8"]
    assert inside(tmetrics.HEAD) == ["gemm_f32acc"]


def _reading(prof) -> run.Reading:
    return run.Reading(cell=None, setup_s=0, window=Window(),
                       trace=trace.read(prof.profiler.kineto_results.events()))


def test_forward_ops_equal_a_count_from_the_profilers_own_tree(served):
    """The profiler's parent links: a top-level op of the forward is one whose
    parent is a program span, with ``resnetc.forward`` among its ancestors."""
    _, _, _, prof = served
    count = 0
    for e in prof.events():
        parent = e.cpu_parent
        if parent is None or not parent.name.startswith("resnetc.") or "::" not in e.name:
            continue
        names = []
        while parent is not None:
            names.append(parent.name)
            parent = parent.cpu_parent
        if tmetrics.FORWARD in names and not e.name.startswith(trace.OP_PREFIX):
            count += 1
    r = _reading(prof)
    assert spans.roots(r.trace) == REQUESTS + 1
    assert count > 0
    assert run.reader("forward_ops.online")(r) == pytest.approx(count / (REQUESTS + 1))


def test_the_three_host_ms_add_up_to_the_forward(served):
    _, _, _, prof = served
    r = _reading(prof)
    parts = [run.reader(m)(r) for m in ("forward_python_ms.online", "forward_torch_ms.online",
                                         "launch_ms.online")]
    forward_ns = sum(e - s for s, e in spans.named(r.trace, spans.FORWARD))
    forward_ms = forward_ns / 1e6 / (REQUESTS + 1)
    assert all(p > 0 for p in parts)
    assert sum(parts) == pytest.approx(forward_ms, rel=0.01)


def test_the_exported_program_holds_no_span():
    """The int8_chain program's graph has no profiler node, exported with the
    spans off or under a running profiler (which records them while
    tracing)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        eng = texport.build_engine("resnet18", "int8_chain", device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        programs = [texport.export_program(eng, 1, 32)]
    assert {tmetrics.STEM, tmetrics.HEAD} <= {e.name for e in prof.events()}
    programs.append(texport.export_program(eng, 1, 32))
    for program in programs:
        targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
        assert targets and not any("profiler" in t for t in targets)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_kernel_launched_in_a_stage_span_starts_after_it_on_the_device(cuda):
    """On the eager forward (``logits``; ``classify`` on the card replays a
    graph captured with the stage spans, and launches nothing inside them)."""
    eng, x = _engine(tresnet.get_config("resnet18", num_classes=10), cuda, 224), _x(224)
    eng.logits(x)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.logits(x)
        torch.cuda.synchronize()
    evs = list(prof.profiler.kineto_results.events())
    stage = next(e for e in evs if e.name() == tmetrics.STAGES[1])
    # A kernel links to the innermost torch op that launched it (as in
    # ``gpubench.trace.read``); keep those whose op ran inside the span.
    ops = {e.correlation_id(): e for e in evs
           if e.device_type() != torch.autograd.DeviceType.CUDA and not e.is_user_annotation()
           and e.linked_correlation_id() == 0}
    kernels = [e for e in evs if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation() and e.linked_correlation_id() in ops
               and stage.start_ns() <= ops[e.linked_correlation_id()].start_ns() <= stage.end_ns()]
    assert any(ops[k.linked_correlation_id()].name().startswith(trace.OP_PREFIX) for k in kernels)
    assert all(k.start_ns() >= stage.start_ns() for k in kernels)
