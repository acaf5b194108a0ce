"""The readers of the program's hot-path spans (`program_span` metrics):
on a ring filled by a profiled CPU run of each cell, shrunk, and on
hand-built spans. Each drops the warm root, takes self times and means
over the batches, and reads None without spans or device stamps."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chipbench import harness
from chipbench.systems.cnn_eq import System
from chipbench.tests.conftest import TINY
from repro_torch.obs import trace

CPU = torch.device("cpu")
READERS = ("partition_split_ms", "partition_merge_ms", "partition_host_ms",
           "engine_host_ms", "launch_host_ms")


@pytest.fixture(autouse=True)
def empty_ring():
    trace.clear_spans()
    yield
    trace.clear_spans()


def read_all():
    return {n: harness.reader(n)(None) for n in READERS}


def rec(name, t0, t1, parent=None, device_ms=None):
    r = trace.HotSpan(name)
    if parent is not None:
        r.parent, r.batch = parent.sid, parent.batch
    r.t0, r.t1, r.device_ms = t0, t1, device_ms
    trace.SPANS.append(r)
    return r


def stream_batch(t, host, engine, launch, split_dev, merge_dev):
    """One stream batch at host time t (seconds): the root's host time,
    the engine's, the launch's, and the split's and merge's device ms."""
    root = rec("eq.partition", t, t + host)
    rec("eq.partition.split", t, t + 0.1 * host, root, split_dev)
    eng = rec("eq.engine", t + 0.2 * host, t + 0.2 * host + engine, root)
    rec("eq.cnn_eq.launch", eng.t0, eng.t0 + launch, eng)
    rec("eq.partition.merge", eng.t1, eng.t1 + 0.1 * host, root, merge_dev)


def test_hand_built_stream_batches():
    stream_batch(0.0, 9.0, 5.0, 4.0, 70.0, 80.0)     # the warm batch
    stream_batch(10.0, 4e-3, 2e-3, 5e-4, 0.2, 0.1)
    stream_batch(20.0, 6e-3, 3e-3, 1.5e-3, 0.4, 0.3)
    got = read_all()
    want = {"partition_split_ms": 0.3, "partition_merge_ms": 0.2,
            "partition_host_ms": 2.5, "engine_host_ms": 1.5,
            "launch_host_ms": 1.0}
    assert got == pytest.approx(want, rel=1e-9)


def test_hand_built_rows_batches_and_missing_stamps():
    for t, host, launch in ((0.0, 1.0, 0.5), (2.0, 2e-3, 1e-3),
                            (3.0, 4e-3, 1e-3)):
        eng = rec("eq.engine", t, t + host)
        rec("eq.cnn_eq.launch", t, t + launch, eng)
    got = read_all()
    assert got["engine_host_ms"] == pytest.approx(2.0, rel=1e-9)
    assert got["launch_host_ms"] == pytest.approx(1.0, rel=1e-9)
    assert [got[n] for n in READERS[:3]] == [None] * 3
    # a device span without its events reads None, not a partial mean
    trace.clear_spans()
    stream_batch(0.0, 1.0, 0.5, 0.1, 1.0, 1.0)
    stream_batch(2.0, 1.0, 0.5, 0.1, None, 1.0)
    assert read_all()["partition_split_ms"] is None
    assert read_all()["partition_merge_ms"] == pytest.approx(1.0)


def test_no_spans_read_none(monkeypatch):
    assert read_all() == {n: None for n in READERS}
    stream_batch(0.0, 1.0, 0.5, 0.1, 1.0, 1.0)       # the warm root alone
    assert read_all() == {n: None for n in READERS}
    # a program whose trace module has no hot-path spans
    stream_batch(2.0, 1.0, 0.5, 0.1, 1.0, 1.0)
    monkeypatch.delattr(trace, "span_records")
    assert read_all() == {n: None for n in READERS}


@pytest.mark.parametrize("name", sorted(TINY))
def test_readers_on_a_profiled_cpu_run(name):
    spec = harness.cell(name)
    spec.traffic.update(TINY[name])
    system = System(spec.config, spec.traffic, 2 ** 31 + 17, CPU)
    system.probe()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(4):
            system.call(i)
    got = read_all()
    recs = trace.span_records()
    roots = [r for r in recs if r.parent is None][1:]
    engine = {r.sid: r for r in recs if r.name == "eq.engine"}
    assert len(roots) == 3 and len(engine) == 4
    # on the CPU: no launch and no device stamps
    assert got["launch_host_ms"] is None
    assert got["partition_split_ms"] is got["partition_merge_ms"] is None
    kept = [e for e in engine.values() if e.batch in {r.sid for r in roots}]
    assert got["engine_host_ms"] == pytest.approx(
        sum(e.host_ms for e in kept) / 3, rel=1e-9)
    if spec.traffic["entry"] == "stream":
        want = sum(r.host_ms - engine[next(
            s for s in engine if engine[s].parent == r.sid)].host_ms
            for r in roots) / 3
        assert got["partition_host_ms"] == pytest.approx(want, rel=1e-9)
        assert 0 < got["partition_host_ms"]
    else:
        assert [r.name for r in roots] == ["eq.engine"] * 3
        assert got["partition_host_ms"] is None
