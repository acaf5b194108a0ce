"""NetIngress / NetEgress — the packetized data plane over a runtime.

Port of `repro.net.gateway` onto the port's runtimes. `NetGateway` is one
wire endpoint serving one runtime (`ServeRuntime` or `AsyncServeRuntime`;
a fleet runtime with ``workers`` is taken duck-typed — the handle shapes
are adapted uniformly):

  ingress  datagram → decode (`frame.py`) → per-tenant `Reassembler`
           (bounded reorder window, dedup, seq-gap detection) → in-order
           sample chunks → `runtime.submit`, under per-tenant
           CREDIT-based backpressure (frames beyond the granted window
           park in a bounded queue; overflow drops + NACKs — a rude or
           slow tenant cannot grow the queue or stall the others).
  egress   resolved chunk handles (the sync runtime's `Request`, whose
           `symbols` are numpy, or the async runtime's
           `concurrent.futures.Future`) → symbol DATA frames back out with
           the same per-tenant seq discipline, plus cumulative CREDIT
           grants (idempotent under wire duplication — each frame carries
           the grant TOTAL, not an increment) and an EOS trailer.

A seq gap (a frame displaced beyond the reorder window, i.e. lost) is a
surfaced per-tenant ``stream_gap`` error + NACK frame, never a silent
hole: the tenant stops emitting and `NetIngress.error()` reports it.

A DATA frame carrying the v2 trace extension queues its (trace id, client
send time, ingress time) on the tenant's `Session.trace_ctx`, which the
micro-batcher drains into the chunk span it opens at enqueue.

Everything is counted in the runtime's obs registry under ``net.*``
(frames in/out/dropped/crc_errors/reordered/duplicates/gaps/nacks,
credits granted, parked frames) and each emitted chunk's ingress→emit
latency lands in the ``net.ingress_to_emit_s`` histogram.
"""
from __future__ import annotations

import concurrent.futures
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from .frame import (Frame, FrameError, FrameType, WireDtype, decode_frame,
                    encode_frame, encode_samples, wire_grid)

DEFAULT_REORDER_WINDOW = 64
DEFAULT_CREDITS = 64
DEFAULT_PARK_MAX = 256


def handle_done(h) -> bool:
    """True once a runtime chunk handle has landed (sync `Request` or
    async/fleet `concurrent.futures.Future`)."""
    if isinstance(h, concurrent.futures.Future):
        return h.done()
    return bool(h.done)


def handle_result(h) -> np.ndarray:
    """The landed handle's emitted symbols (host numpy in both runtimes);
    raises the terminal launch error for a failed future."""
    if isinstance(h, concurrent.futures.Future):
        return h.result()
    return h.symbols


class Reassembler:
    """Seq → in-order delivery with a bounded reorder window.

    `offer` returns the items that just became deliverable in order.
    Duplicates (seq already delivered or buffered) are absorbed; a seq
    displaced beyond the window means an earlier frame can no longer
    arrive in-window — that's a permanent `gap`, latched until reset."""

    def __init__(self, window: int = DEFAULT_REORDER_WINDOW):
        self.window = int(window)
        self.expected = 0
        self.buffer: Dict[int, object] = {}
        self.gap: Optional[int] = None      # first missing seq, once latched
        self.duplicates = 0
        self.reordered = 0

    def offer(self, seq: int, item) -> List:
        if self.gap is not None:
            return []
        if seq < self.expected or seq in self.buffer:
            self.duplicates += 1
            return []
        if seq > self.expected and seq - self.expected > self.window:
            self.gap = self.expected
            return []
        if seq != self.expected:
            self.reordered += 1
            self.buffer[seq] = item
            return []
        out = [item]
        self.expected += 1
        while self.expected in self.buffer:
            out.append(self.buffer.pop(self.expected))
            self.expected += 1
        return out


class _TenantWire:
    """Per-tenant ingress state: reassembly, credits, parked backlog."""

    def __init__(self, window: int, credits: int, park_max: int):
        self.reasm = Reassembler(window)
        self.granted_total = credits    # cumulative credit grant (monotone)
        self.consumed = 0               # DATA frames submitted to the runtime
        self.parked: deque = deque()    # in-order items awaiting credit
        self.park_max = park_max
        self.t_oldest: Optional[float] = None
        self.error: Optional[str] = None
        self.eos_done = False


class NetIngress:
    """Datagram → in-order per-tenant sample chunks → `runtime.submit`."""

    def __init__(self, runtime, transport, egress: "NetEgress",
                 control=None, *, reorder_window: int = DEFAULT_REORDER_WINDOW,
                 initial_credits: int = DEFAULT_CREDITS,
                 park_max: int = DEFAULT_PARK_MAX):
        self.runtime = runtime
        self.transport = transport
        self.egress = egress
        self.control = control          # ControlPlane (or None: data-only)
        self.window = int(reorder_window)
        self.initial_credits = int(initial_credits)
        self.park_max = int(park_max)
        self.tenants: Dict[str, _TenantWire] = {}
        obs = runtime.obs
        self._clock = obs.clock
        scope = obs.scope("net")
        self.c_in = scope.counter("frames_in")
        self.c_crc = scope.counter("crc_errors")
        self.c_drop = scope.counter("frames_dropped")
        self.c_dup = scope.counter("duplicates")
        self.c_reord = scope.counter("reordered")
        self.c_gap = scope.counter("gaps")
        self.c_nack = scope.counter("nacks_sent")
        self.c_park = scope.counter("frames_parked")
        self._tracer = obs.tracer

    # -- registration ---------------------------------------------------------

    def register(self, tenant: str, credits: Optional[int] = None,
                 send_credit: bool = True) -> _TenantWire:
        """Start a tenant's wire stream (idempotent); grants its initial
        credit window. Call after `runtime.open` — the control plane's
        OPEN does this for wire-opened tenants."""
        state = self.tenants.get(tenant)
        if state is None:
            state = _TenantWire(self.window,
                                credits or self.initial_credits,
                                self.park_max)
            self.tenants[tenant] = state
            if send_credit:
                self.egress.send_credit(tenant, state.granted_total)
        return state

    def release(self, tenant: str) -> None:
        """Forget a tenant's wire state (after close)."""
        self.tenants.pop(tenant, None)
        self.egress.release(tenant)

    def error(self, tenant: str) -> Optional[str]:
        """The tenant's latched wire error ('stream_gap: ...'), if any."""
        state = self.tenants.get(tenant)
        return state.error if state else None

    # -- polling --------------------------------------------------------------

    def poll(self, max_datagrams: int = 64, timeout: float = 0.0) -> int:
        """Drain up to `max_datagrams` from the transport. Adversarial
        input never raises — malformed datagrams are counted and dropped."""
        n = 0
        for _ in range(max_datagrams):
            data = self.transport.recv(timeout=timeout)
            if data is None:
                break
            n += 1
            self.c_in.inc()
            try:
                frame = decode_frame(data)
            except FrameError as e:
                self.c_crc.inc()
                self.c_drop.inc()
                self._tracer.instant("net_bad_frame", error=repr(e))
                continue
            self._dispatch(frame)
        return n

    def _dispatch(self, frame: Frame) -> None:
        if frame.ftype in (FrameType.DATA, FrameType.EOS):
            self._on_data(frame)
        elif frame.ftype == FrameType.CTRL:
            if self.control is not None:
                self.control.handle(frame)
            else:
                self.c_drop.inc()
        else:                           # CREDIT/NACK/ACK are egress-bound
            self.c_drop.inc()

    def _on_data(self, frame: Frame) -> None:
        state = self.tenants.get(frame.tenant)
        if state is None:
            self.c_drop.inc()
            self._nack(frame.tenant, frame.seq, "unknown_tenant")
            return
        if state.error is not None:
            self.c_drop.inc()
            return
        before = (state.reasm.duplicates, state.reasm.reordered)
        ready = state.reasm.offer(frame.seq, frame)
        self.c_dup.inc(state.reasm.duplicates - before[0])
        self.c_reord.inc(state.reasm.reordered - before[1])
        if state.reasm.gap is not None:
            missing = state.reasm.gap
            state.error = f"stream_gap: seq {missing} lost (window " \
                          f"{state.reasm.window})"
            self.c_gap.inc()
            self._tracer.instant("net_gap", tenant=frame.tenant, seq=missing)
            self._nack(frame.tenant, missing, "stream_gap")
            return
        for f in ready:
            if len(state.parked) >= state.park_max:
                # sender ignoring its credit window: bounded, never grows
                self.c_drop.inc()
                self._nack(frame.tenant, f.seq, "credit_overflow")
                continue
            state.parked.append(f)
            if len(state.parked) > 1:
                self.c_park.inc()
        self._drain_parked(frame.tenant, state)

    def _drain_parked(self, tenant: str, state: _TenantWire) -> None:
        while state.parked:
            head: Frame = state.parked[0]
            if head.ftype == FrameType.EOS:
                state.parked.popleft()
                self._finish(tenant, state)
                continue
            if state.consumed >= state.granted_total:
                break                   # out of credit: parked, not dropped
            state.parked.popleft()
            self._submit(tenant, state, head)

    def _submit(self, tenant: str, state: _TenantWire, frame: Frame) -> None:
        samples = frame.samples()
        if state.t_oldest is None:
            state.t_oldest = self._clock()
        state.consumed += 1
        if frame.trace_id is not None and self._tracer.enabled:
            # v2 trace extension → session context, BEFORE submit so the
            # chunk span this submit opens picks it up at enqueue. With
            # tracing off nothing is queued (the deque would never drain)
            sessions = getattr(self.runtime, "sessions", None)
            try:
                sess = (sessions.get(tenant)
                        if sessions is not None else None)
            except KeyError:           # raced a close; context just drops
                sess = None
            if sess is not None:
                sess.trace_ctx.append(
                    (frame.trace_id, frame.t_client, self._clock()))
        handle = self.runtime.submit(tenant, samples)
        if handle is not None:
            self.egress.track(tenant, handle, 1, state.t_oldest)
            state.t_oldest = None
        else:
            # Sub-tile chunk absorbed into the chunker's carry with no
            # launchable plan: it no longer occupies wire-side memory, so
            # its credit returns NOW — otherwise a window smaller than
            # one tile's worth of frames would deadlock the stream.
            # Frames that DO yield a handle return their credit at emit.
            self.egress.grant(tenant, 1)

    def _finish(self, tenant: str, state: _TenantWire) -> None:
        if state.eos_done:
            return
        state.eos_done = True
        handle = self.runtime.finish(tenant)
        if handle is not None:           # EOS consumed no credit: n_frames=0
            self.egress.track(tenant, handle, 0,
                              state.t_oldest or self._clock())
            state.t_oldest = None
        self.egress.finish(tenant)

    def grant_pending(self, tenant: str, n_frames: int = 0) -> None:
        """Credit granted (egress callback): grow this side's ledger —
        the same total the CREDIT frame announces to the client — and
        retry the parked backlog against it."""
        state = self.tenants.get(tenant)
        if state is not None:
            state.granted_total += int(n_frames)
            if state.error is None:
                self._drain_parked(tenant, state)

    def _nack(self, tenant: str, seq: int, reason: str) -> None:
        self.c_nack.inc()
        payload = reason.encode("utf-8")
        try:
            self.transport.send(encode_frame(FrameType.NACK, tenant, seq,
                                             payload))
        except (OSError, ValueError):
            pass

    def flush_gaps(self) -> List[str]:
        """End-of-run sweep: any tenant still holding reordered frames
        with no way to progress (stream went quiet mid-gap) latches a
        `stream_gap` error. Call only once the wire is known drained."""
        flagged = []
        for tenant, state in self.tenants.items():
            if state.error is None and state.reasm.buffer:
                missing = state.reasm.expected
                state.error = f"stream_gap: seq {missing} lost (stream idle)"
                self.c_gap.inc()
                self._nack(tenant, missing, "stream_gap")
                flagged.append(tenant)
        return flagged


class _EgressStream:
    def __init__(self):
        self.fifo: deque = deque()      # (handle, n_frames, t_ingress)
        self.out_seq = 0
        self.eos_pending = False
        self.eos_sent = False
        self.granted_total = 0          # mirrors ingress grants (cumulative)


class NetEgress:
    """Resolved chunk handles → symbol DATA frames + credit grants out."""

    def __init__(self, runtime, transport,
                 symbol_dtype: WireDtype = WireDtype.FP32):
        self.runtime = runtime
        self.transport = transport
        self.symbol_dtype = symbol_dtype
        self.streams: Dict[str, _EgressStream] = {}
        self.on_credit = None           # ingress.grant_pending, via gateway
        obs = runtime.obs
        self._clock = obs.clock
        scope = obs.scope("net")
        self.c_out = scope.counter("frames_out")
        self.c_credits = scope.counter("credits_granted")
        self.h_latency = scope.histogram(
            "ingress_to_emit_s", window=obs.retention.latency_window)

    def _stream(self, tenant: str) -> _EgressStream:
        s = self.streams.get(tenant)
        if s is None:
            s = self.streams[tenant] = _EgressStream()
        return s

    def release(self, tenant: str) -> None:
        self.streams.pop(tenant, None)

    def track(self, tenant: str, handle, n_frames: int,
              t_ingress: float) -> None:
        self._stream(tenant).fifo.append((handle, n_frames, t_ingress))

    def finish(self, tenant: str) -> None:
        self._stream(tenant).eos_pending = True

    def send_credit(self, tenant: str, granted_total: int) -> None:
        """Announce the cumulative grant (safe to repeat/duplicate)."""
        s = self._stream(tenant)
        s.granted_total = max(s.granted_total, granted_total)
        payload = int(s.granted_total).to_bytes(4, "little")
        self.transport.send(encode_frame(FrameType.CREDIT, tenant, 0,
                                         payload))

    def grant(self, tenant: str, n_frames: int) -> None:
        s = self._stream(tenant)
        self.c_credits.inc(n_frames)
        self.send_credit(tenant, s.granted_total + n_frames)
        if self.on_credit is not None:   # grow the ingress ledger in step
            self.on_credit(tenant, n_frames)

    def pump(self) -> int:
        """Emit every landed head-of-line chunk; returns frames sent."""
        sent = 0
        for tenant, s in list(self.streams.items()):
            while s.fifo and handle_done(s.fifo[0][0]):
                handle, n_frames, t_ingress = s.fifo.popleft()
                syms = handle_result(handle)   # raises on terminal failure
                payload = encode_samples(np.asarray(syms, np.float32),
                                         self.symbol_dtype)
                self.transport.send(encode_frame(
                    FrameType.DATA, tenant, s.out_seq, payload,
                    dtype=self.symbol_dtype))
                s.out_seq += 1
                sent += 1
                self.c_out.inc()
                self.h_latency.observe(self._clock() - t_ingress)
                if n_frames:
                    self.grant(tenant, n_frames)
            if s.eos_pending and not s.fifo and not s.eos_sent:
                self.transport.send(encode_frame(FrameType.EOS, tenant,
                                                 s.out_seq))
                s.out_seq += 1
                s.eos_sent = True
                sent += 1
                self.c_out.inc()
        return sent


class NetGateway:
    """One wire endpoint serving one runtime: ingress + egress (+ control).

        gw = NetGateway(runtime, server_transport)
        gw.open_wire("t0")            # after runtime.open(spec) — or let
                                      # the control plane OPEN do both
        while driving: gw.step()      # poll wire, pump policy, emit
        gw.settle()                   # drain to quiescence at end-of-run
    """

    def __init__(self, runtime, transport, *,
                 reorder_window: int = DEFAULT_REORDER_WINDOW,
                 initial_credits: int = DEFAULT_CREDITS,
                 park_max: int = DEFAULT_PARK_MAX,
                 enable_control: bool = True):
        self.runtime = runtime
        self.transport = transport
        self.egress = NetEgress(runtime, transport)
        control = None
        if enable_control:
            from .control import ControlPlane
            control = ControlPlane(runtime, self)
        self.control = control
        self.ingress = NetIngress(runtime, transport, self.egress, control,
                                  reorder_window=reorder_window,
                                  initial_credits=initial_credits,
                                  park_max=park_max)
        self.egress.on_credit = self.ingress.grant_pending

    def open_wire(self, tenant: str, credits: Optional[int] = None) -> None:
        """Attach an already-`runtime.open`ed tenant to the wire."""
        self.ingress.register(tenant, credits=credits)

    def step(self, max_datagrams: int = 64) -> int:
        """One cooperative scheduling pass; returns an activity count."""
        n = self.ingress.poll(max_datagrams=max_datagrams)
        self.runtime.pump()
        return n + self.egress.pump()

    def settle(self, max_rounds: int = 10_000) -> None:
        """Drive to quiescence: poll the wire dry, force-launch whatever
        is pending (`drain` — batching composition never changes bits,
        contract #4), emit. Loops until a full round does nothing."""
        for _ in range(max_rounds):
            n = self.ingress.poll(max_datagrams=256)
            self.runtime.drain()
            n += self.egress.pump()
            if n == 0:
                return
        raise RuntimeError("NetGateway.settle did not quiesce")
