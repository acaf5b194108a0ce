"""Tracing: chunk-lifecycle spans of the serve pipeline, and spans on the
equalizer's hot path on the profiler's clock.

Chunk spans. Every `ChunkPlan` admitted while tracing is on carries a
`ChunkSpan` stamped at each phase boundary:

    submit -> assemble -> launch -> execute -> descatter -> emit

Retries, replays, requeues, and device-loss migrations are appended as
child *events* on the span (the phase marks are latest-wins, so the final
chain always describes the attempt that actually emitted), which means a
chunk that survives a worker death shows its full recovery path in one
span.  Sealed spans land in a bounded ring (oldest dropped first) and
export as Chrome `trace_event` JSON viewable in Perfetto / chrome://tracing.

When tracing is disabled `begin()` returns None and every hook in the
serving stack is a no-op — observation must never change launch order or
numerics (the chaos parity tests run with tracing ON to prove it).

Hot-path spans. `span(name)` brackets one layer of the equalizer's path
(`eq.partition` and its `eq.partition.split` / `eq.partition.merge` in
`core.stream_partition`, `eq.engine` in `core.engine`, `eq.cnn_eq.launch`
around the ctypes launch in `kernels.cnn_eq.cnn_eq`). A span is on
exactly while a `torch.profiler` session records on the calling thread
(`torch.autograd._profiler_enabled()`); there is no other switch. To
turn them on, profile:

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        partitioned_apply(engine, x, n_inst, cfg)
    prof.export_chrome_trace("eq.json")   # the spans beside the kernels
    spans = span_records()                # or read the ring

On, a span opens a host range under its name in the profiler's trace (a
function-scope range: the profiler does not mirror it onto the device
timeline, so kernel-named device time stays the kernels' own), stamps
its host start and end with `time.perf_counter`, records its parent from
a per-thread stack and the batch id of its root, and, given a CUDA
device, records a pair of timing events on its current stream. Sealed
spans land in `SPANS`, a bounded ring; `span_records()` reads them (the
device times after a synchronize) and `clear_spans()` empties it. Off,
`span` costs one check of the profiler's state and returns a shared
no-op context manager: no clock, no allocation, no CUDA call.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import torch

#: the canonical phase order of one chunk through the micro-batcher.
PHASES: Tuple[str, ...] = (
    "submit", "assemble", "launch", "execute", "descatter", "emit")

_PHASE_INDEX = {p: i for i, p in enumerate(PHASES)}

DEFAULT_CAPACITY = 65536


class ChunkSpan:
    """One chunk's lifecycle.  Phase marks are latest-wins timestamps
    (seconds on the owning runtime's clock); `events` is an append-only
    list of (name, t, args) children recording retries/replays/migrations.

    A span is stamped by exactly one thread at a time (the request that
    owns it moves through the batcher sequentially; migration hands the
    whole request over under the fleet locks), so marks/events need no
    lock of their own — only `seal` synchronises through the tracer.
    """

    __slots__ = ("tenant", "seq", "marks", "attempts", "events",
                 "status", "sealed", "n_emit", "width")

    def __init__(self, tenant: str, seq: int) -> None:
        self.tenant = tenant
        self.seq = seq
        self.marks: Dict[str, float] = {}
        self.attempts: Dict[str, int] = {}
        self.events: List[Tuple[str, float, Dict[str, Any]]] = []
        self.status = "open"
        self.sealed = False
        self.n_emit = 0
        self.width = 0

    def stamp(self, phase: str, t: float) -> None:
        if phase not in _PHASE_INDEX:
            raise ValueError(f"unknown phase {phase!r}")
        self.marks[phase] = t
        self.attempts[phase] = self.attempts.get(phase, 0) + 1

    def event(self, name: str, t: float, **args: Any) -> None:
        self.events.append((name, t, args))

    def complete(self) -> bool:
        """All six phases stamped, in non-decreasing time order."""
        try:
            ts = [self.marks[p] for p in PHASES]
        except KeyError:
            return False
        return all(a <= b for a, b in zip(ts, ts[1:]))

    def as_dict(self) -> Dict[str, Any]:
        return {
            "tenant": self.tenant,
            "seq": self.seq,
            "status": self.status,
            "marks": dict(self.marks),
            "attempts": dict(self.attempts),
            "events": [{"name": n, "t": t, "args": a}
                       for n, t, a in self.events],
            "n_emit": self.n_emit,
            "width": self.width,
        }


class Tracer:
    """Span factory + bounded ring of sealed spans and runtime instants."""

    def __init__(self, enabled: bool = False,
                 capacity: int = DEFAULT_CAPACITY,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        if capacity < 1:
            raise ValueError("Tracer capacity must be >= 1")
        self.enabled = enabled
        self.clock = clock
        self.capacity = capacity
        self._lock = threading.Lock()
        self._seqs: Dict[str, int] = {}
        self.spans: Deque[ChunkSpan] = deque(maxlen=capacity)
        self.instants: Deque[Tuple[str, float, Dict[str, Any]]] = deque(
            maxlen=capacity)
        self.spans_started = 0
        self.spans_sealed = 0
        self.instants_total = 0
        self._t0 = clock()

    # -- span lifecycle ---------------------------------------------------
    def begin(self, tenant: str) -> Optional[ChunkSpan]:
        """Open a span for the next chunk of `tenant`; None when tracing
        is off (all downstream hooks guard on span truthiness)."""
        if not self.enabled:
            return None
        with self._lock:
            seq = self._seqs.get(tenant, 0)
            self._seqs[tenant] = seq + 1
            self.spans_started += 1
        return ChunkSpan(tenant, seq)

    def seal(self, span: Optional[ChunkSpan], status: str = "ok") -> None:
        """Land a finished span in the ring.  Idempotent: the first seal
        wins, so a late failure path cannot double-count an emitted chunk."""
        if span is None:
            return
        with self._lock:
            if span.sealed:
                return
            span.sealed = True
            span.status = status
            self.spans.append(span)
            self.spans_sealed += 1

    def instant(self, name: str, **args: Any) -> None:
        """Record a runtime-level marker (hot-swap, rollback, autotune,
        engine build, migration) outside any one chunk's span."""
        if not self.enabled:
            return
        t = self.clock()
        with self._lock:
            self.instants.append((name, t, args))
            self.instants_total += 1

    # -- introspection ----------------------------------------------------
    def sealed_spans(self, tenant: Optional[str] = None) -> List[ChunkSpan]:
        with self._lock:
            spans = list(self.spans)
        if tenant is not None:
            spans = [s for s in spans if s.tenant == tenant]
        return spans

    @property
    def spans_dropped(self) -> int:
        with self._lock:
            return self.spans_sealed - len(self.spans)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "capacity": self.capacity,
                "spans_started": self.spans_started,
                "spans_sealed": self.spans_sealed,
                "spans_dropped": self.spans_sealed - len(self.spans),
                "spans_buffered": len(self.spans),
                "instants": self.instants_total,
            }

    # -- Chrome trace_event export ---------------------------------------
    def export_chrome(self, tenant: Optional[str] = None) -> Dict[str, Any]:
        """Chrome `trace_event` JSON (the dict form with "traceEvents").

        Layout: one process (pid 0); each tenant gets a thread lane with a
        metadata name record; every sealed span renders as a top-level "X"
        complete event (submit->emit) stacked over per-phase "X" children,
        span child events and runtime instants render as "i" instants.
        A span carrying cross-wire context (`client_send` events from the
        v2 frame extension) additionally renders a "wire" slice from the
        earliest client send to submit, so the lane reads
        client -> ingress -> launch -> emit end to end.
        Timestamps are microseconds relative to tracer construction.
        """
        spans = self.sealed_spans(tenant)
        with self._lock:
            instants = list(self.instants)
        t0 = self._t0

        def us(t: float) -> float:
            return max(0.0, (t - t0) * 1e6)

        tenants = sorted({s.tenant for s in spans})
        tid_of = {t: i + 1 for i, t in enumerate(tenants)}
        events: List[Dict[str, Any]] = [
            {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
             "args": {"name": "repro_torch.serve"}},
            {"name": "thread_name", "ph": "M", "pid": 0, "tid": 0,
             "args": {"name": "runtime"}},
        ]
        for t, tid in tid_of.items():
            events.append({"name": "thread_name", "ph": "M", "pid": 0,
                           "tid": tid, "args": {"name": f"tenant {t}"}})
        for s in spans:
            tid = tid_of[s.tenant]
            if s.complete():
                start, end = s.marks["submit"], s.marks["emit"]
                events.append({
                    "name": f"chunk {s.tenant}#{s.seq}", "ph": "X",
                    "pid": 0, "tid": tid, "ts": us(start),
                    "dur": max(0.0, (end - start) * 1e6),
                    "args": {"status": s.status, "n_emit": s.n_emit,
                             "width": s.width,
                             "attempts": dict(s.attempts)},
                })
                sends = [t for name, t, _ in s.events
                         if name == "client_send"]
                if sends and min(sends) < start:
                    events.append({
                        "name": "wire", "ph": "X", "pid": 0, "tid": tid,
                        "ts": us(min(sends)),
                        "dur": max(0.0, (start - min(sends)) * 1e6),
                        "args": {"frames": len(sends)},
                    })
                for a, b in zip(PHASES[:-1], PHASES[1:]):
                    events.append({
                        "name": a, "ph": "X", "pid": 0, "tid": tid,
                        "ts": us(s.marks[a]),
                        "dur": max(0.0, (s.marks[b] - s.marks[a]) * 1e6),
                        "args": {},
                    })
            for name, t, args in s.events:
                events.append({
                    "name": f"{name} {s.tenant}#{s.seq}", "ph": "i",
                    "pid": 0, "tid": tid, "ts": us(t), "s": "t",
                    "args": dict(args),
                })
        for name, t, args in instants:
            events.append({"name": name, "ph": "i", "pid": 0, "tid": 0,
                           "ts": us(t), "s": "p", "args": dict(args)})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome(self, path: str, tenant: Optional[str] = None) -> None:
        with open(path, "w") as f:
            json.dump(self.export_chrome(tenant), f)


# ---------------------------------------------------------------------------
# hot-path spans on the profiler's clock
# ---------------------------------------------------------------------------

_profiling = torch.autograd._profiler_enabled
# A function-scope range. `torch.profiler.record_function` opens a user
# range, which the profiler also lays onto the device timeline over the
# kernels launched inside it, as device activity under the span's name.
_HostRange = torch._C._profiler._RecordFunctionFast
_ids = itertools.count(1)


class _Open(threading.local):
    """Each thread's stack of open spans."""

    def __init__(self) -> None:
        self.stack: List["HotSpan"] = []


_open = _Open()


class _Off:
    """The span of a run that no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


class HotSpan:
    """One span of the equalizer's hot path: a context manager while
    open, a record once sealed in the ring.

    ``sid`` is unique in the process; ``parent`` is the enclosing span's
    ``sid`` on the same thread (None for a root); ``batch`` is the root's
    ``sid``; ``t0``/``t1`` are `time.perf_counter` seconds at the start of
    its entry and the end of its exit, so that a span's own cost is
    inside it and not in its parent's self time; ``device_ms``
    is the time between the span's two CUDA events, set by
    `SpanRing.records` (None without a CUDA device)."""

    __slots__ = ("name", "sid", "parent", "batch", "t0", "t1", "device_ms",
                 "_on", "_range", "_events")

    def __init__(self, name: str, on=None) -> None:
        self.name, self._on = name, on
        self.sid = next(_ids)
        self.parent: Optional[int] = None
        self.batch = self.sid
        self.t0 = self.t1 = 0.0
        self.device_ms: Optional[float] = None
        self._range = self._events = None

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3

    def __enter__(self) -> "HotSpan":
        self.t0 = time.perf_counter()
        stack = _open.stack
        if stack:
            self.parent, self.batch = stack[-1].sid, stack[-1].batch
        self._range = _HostRange(self.name)
        self._range.__enter__()
        dev = getattr(self._on, "device", self._on)
        if dev is not None and torch.device(dev).type == "cuda":
            stream = torch.cuda.current_stream(dev)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            self._events = (start, torch.cuda.Event(enable_timing=True),
                            stream)
        stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            _, end, stream = self._events
            end.record(stream)
        self._range.__exit__(None, None, None)
        self._range = self._on = None
        _open.stack.pop()
        self.t1 = time.perf_counter()
        SPANS.append(self)
        return False


class SpanRing:
    """Bounded ring of sealed `HotSpan`s, oldest dropped first."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        if capacity < 1:
            raise ValueError("SpanRing capacity must be >= 1")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: Deque[HotSpan] = deque(maxlen=capacity)
        self.sealed = 0

    def append(self, rec: HotSpan) -> None:
        with self._lock:
            self._ring.append(rec)
            self.sealed += 1

    @property
    def dropped(self) -> int:
        with self._lock:
            return self.sealed - len(self._ring)

    def records(self) -> List[HotSpan]:
        """The sealed spans, oldest first. A span's device time is read
        here, once its end event has completed."""
        with self._lock:
            recs = list(self._ring)
        for r in recs:
            if r._events is not None:
                start, end, _ = r._events
                end.synchronize()
                r.device_ms = start.elapsed_time(end)
                r._events = None
        return recs

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.sealed = 0


SPANS = SpanRing()


def span(name: str, on=None):
    """A span named ``name`` while a profiler records, else `OFF`.

    ``on``: a tensor or device; on a CUDA one the span also times the
    device work enqueued inside it with a pair of CUDA events on the
    current stream."""
    if not _profiling():
        return OFF
    return HotSpan(name, on)


def span_records() -> List[HotSpan]:
    """`SPANS.records()`: the sealed hot-path spans, oldest first."""
    return SPANS.records()


def clear_spans() -> None:
    """Empty `SPANS` and zero its counts."""
    SPANS.clear()
