"""The equalizer path's hot spans (`repro_torch.obs.trace.span`), on the CPU.

  * With no profiler a span is the shared no-op, allocates nothing, and
    `partitioned_apply` and a rows call leave the ring empty.
  * Under `torch.profiler` one stream batch (int8 and bf16 engines)
    records `eq.partition` with the children `eq.partition.split`,
    `eq.engine` and `eq.partition.merge`, in that order, under one batch
    id, each inside its parent's interval, no `eq.cnn_eq.launch` (the CPU
    runs the plain versions), and the same names among the profiler's
    events; a rows call records the root `eq.engine`.
  * Outputs are bitwise equal with the spans on and off.
  * The ring drops its oldest spans past its capacity and counts them;
    spans on two threads never parent each other.
"""
import threading
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import equalizer as teq
from repro_torch.core import stream_partition as sp
from repro_torch.core.engine import EqualizerEngine
from repro_torch.obs import trace

CFG = teq.CNNEqConfig()
FORMATS = {"fused_int8": ((2, 5, 3, 4),) * 3,
           "fused_bf16": ((3, 8, 3, 8),) * 3}
N_INST = 4
STREAM = ("eq.partition.split", "eq.engine", "eq.partition.merge")


def _engine(backend):
    gen = torch.Generator().manual_seed(5)
    folded = teq.fold_bn(teq.init(gen, CFG, device="cpu"),
                         teq.init_bn_state(CFG, device="cpu"), CFG)
    eng = EqualizerEngine.from_folded(folded, CFG, backend=backend,
                                      formats=FORMATS[backend], device="cpu")
    assert eng.backend == backend
    return eng


def _wave(n_syms, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(n_syms * CFG.n_os, generator=gen)


@pytest.fixture(autouse=True)
def empty_ring():
    trace.clear_spans()
    yield
    trace.clear_spans()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, {e.name for e in prof.events()}


def test_off_without_profiler_is_the_shared_noop_and_allocates_nothing():
    assert trace.span("eq.engine") is trace.OFF
    assert trace.span("eq.partition.split", torch.zeros(1)) is trace.OFF
    with trace.span("eq.engine") as s:
        assert s is None
    for _ in range(10):                       # warm the interpreter's caches
        with trace.span("eq.partition"):
            pass
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with trace.span("eq.partition"):
                with trace.span("eq.partition.merge", None):
                    pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == trace.__file__ and d.size_diff > 0]
    assert grown == []


def test_no_profiler_leaves_the_ring_empty():
    eng = _engine("fused_int8")
    sp.partitioned_apply(eng, _wave(4096), N_INST, CFG)
    eng(_wave(1024).reshape(2, -1))
    assert trace.span_records() == [] and trace.SPANS.dropped == 0


@pytest.mark.parametrize("backend", ["fused_int8", "fused_bf16"])
def test_stream_batch_records_the_partition_tree(backend):
    eng = _engine(backend)
    x = _wave(4096, seed=1)
    y_off = sp.partitioned_apply(eng, x, N_INST, CFG)
    y_on, names = _profiled(lambda: sp.partitioned_apply(eng, x, N_INST,
                                                         CFG))
    assert torch.equal(y_on, y_off)
    recs = trace.span_records()
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["eq.partition"]
    root = roots[0]
    kids = sorted((r for r in recs if r.parent == root.sid),
                  key=lambda r: r.sid)
    assert tuple(r.name for r in kids) == STREAM
    assert len(recs) == 4 and {r.batch for r in recs} == {root.sid}
    for a, b in zip(kids, kids[1:]):
        assert a.t1 <= b.t0
    for r in kids:
        assert root.t0 <= r.t0 <= r.t1 <= root.t1
        assert r.device_ms is None          # no CUDA device to time
    assert all(r.name != "eq.cnn_eq.launch" for r in recs)
    assert {"eq.partition", *STREAM} <= names
    assert "eq.cnn_eq.launch" not in names


def test_rows_call_records_the_root_engine_span():
    eng = _engine("fused_int8")
    x = _wave(2048, seed=2).reshape(4, -1)
    y_off = eng(x)
    y_on, names = _profiled(lambda: eng(x))
    assert torch.equal(y_on, y_off)
    recs = trace.span_records()
    assert [(r.name, r.parent, r.batch) for r in recs] == [
        ("eq.engine", None, recs[0].sid)]
    assert recs[0].host_ms > 0 and "eq.engine" in names


def test_each_root_opens_a_batch():
    eng = _engine("fused_int8")
    x = _wave(4096, seed=3)
    _profiled(lambda: [sp.partitioned_apply(eng, x, N_INST, CFG)
                       for _ in range(3)])
    recs = trace.span_records()
    roots = [r.sid for r in recs if r.parent is None]
    assert len(roots) == 3
    assert sorted(r.batch for r in recs) == sorted(roots * 4)


def test_ring_drops_oldest_past_capacity_and_counts():
    ring = trace.SpanRing(capacity=3)
    spans = [trace.HotSpan(f"eq.s{i}") for i in range(5)]
    for s in spans:
        ring.append(s)
    assert ring.records() == spans[2:] and ring.dropped == 2
    ring.clear()
    assert ring.records() == [] and ring.dropped == 0
    with pytest.raises(ValueError):
        trace.SpanRing(capacity=0)


def test_spans_on_two_threads_never_parent_each_other():
    # the profiler records on the thread that started it only, so the
    # spans are opened directly here
    both_open = threading.Barrier(2, timeout=10)
    outer = {}

    def work(tag):
        with trace.HotSpan(f"eq.outer.{tag}") as o:
            outer[tag] = o
            both_open.wait()
            with trace.HotSpan(f"eq.inner.{tag}"):
                both_open.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    recs = {r.name: r for r in trace.span_records()}
    assert len(recs) == 4
    for tag in "ab":
        inner = recs[f"eq.inner.{tag}"]
        assert inner.parent == outer[tag].sid
        assert inner.batch == outer[tag].sid
        assert recs[f"eq.outer.{tag}"].parent is None
