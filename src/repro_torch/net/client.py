"""NetClient — the sender/receiver half of the wire (tester, loadgen, or
a real application front-end).

Port of `repro.net.client` (numpy and the standard library; its frames
are byte for byte the reference's, so either package's client can drive
either package's gateway).

Per tenant it keeps the transmit discipline the gateway's ingress
expects (monotone DATA seqs, EOS trailer, a credit-bounded in-flight
window fed by the server's cumulative CREDIT grants) and reassembles the
egress symbol stream through its own bounded `Reassembler` — the wire
back from the server crosses the same impaired transport, so symbol
frames can arrive reordered or duplicated too.

    client = NetClient(transport)
    client.attach("t0", wire_dtype=WireDtype.INT8, grid=(3, 4))
    client.send_samples("t0", wave_chunk)     # queues + flushes on credit
    client.finish("t0")
    while not client.done("t0"):
        client.poll(); gateway.step()
    syms = client.symbols("t0")               # bitwise vs offline

Control commands (`open`/`close`/`swap_weights`/... or raw `command`)
post a CTRL frame and poll until the matching ACK (the ack's seq echoes
the command's) — `ControlAckError` carries the server's typed error for
a rejected command.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from .control import (Reg, pack_control, unpack_control, weights_to_arrays)
from .frame import (FrameError, FrameType, WireDtype, decode_frame,
                    encode_frame, encode_samples)
from .gateway import DEFAULT_REORDER_WINDOW, Reassembler


class ControlAckError(RuntimeError):
    """The server rejected a control command (the error ack's message)."""


class _ClientStream:
    def __init__(self, wire_dtype: WireDtype, grid):
        self.wire_dtype = wire_dtype
        self.grid = tuple(grid)
        self.tx_seq = 0
        self.sent = 0                   # DATA frames on the wire
        self.granted_total = 0          # max cumulative CREDIT seen
        self.backlog: deque = deque()   # encoded frames awaiting credit
        self.reasm = Reassembler(DEFAULT_REORDER_WINDOW)
        self.chunks: List[np.ndarray] = []
        self.eos_rx = False
        self.eos_tx = False
        self.nacks: List[str] = []


class NetClient:
    def __init__(self, transport, reorder_window: int =
                 DEFAULT_REORDER_WINDOW, tracing: bool = False,
                 clock: Callable[[], float] = time.perf_counter):
        self.transport = transport
        self.window = int(reorder_window)
        self.streams: Dict[str, _ClientStream] = {}
        self._acks: Dict[int, dict] = {}
        self._cmd_seq = 0
        self.decode_errors = 0
        # cross-wire trace propagation: with tracing on, every DATA frame
        # goes out as wire version 2 carrying (trace_id, clock()) so the
        # server's chunk spans can start at the CLIENT's send instant.
        # The clock must share the server tracer's base for the Chrome
        # lane to line up (both default to time.perf_counter in-process).
        self.tracing = bool(tracing)
        self.clock = clock
        self._trace_seq = 0

    # -- tenant attach / data path -------------------------------------------

    def attach(self, tenant: str, wire_dtype: WireDtype = WireDtype.FP32,
               grid=(0, 0), granted: int = 0) -> None:
        """Start a tenant's wire stream client-side (for tenants opened
        out-of-band; `open()` does this from the server's ack)."""
        if tenant not in self.streams:
            s = _ClientStream(wire_dtype, grid)
            s.reasm = Reassembler(self.window)
            s.granted_total = granted
            self.streams[tenant] = s

    def send_samples(self, tenant: str, samples: np.ndarray) -> None:
        """Queue one chunk as one DATA frame; flushes while credit lasts."""
        s = self.streams[tenant]
        if s.eos_tx:
            raise RuntimeError(f"tenant {tenant!r}: stream already finished")
        a_int, a_frac = s.grid
        payload = encode_samples(np.asarray(samples, np.float32),
                                 s.wire_dtype, a_int, a_frac)
        trace_id = None
        t_client = 0.0
        if self.tracing:
            self._trace_seq += 1
            trace_id = self._trace_seq
            t_client = self.clock()
        s.backlog.append(encode_frame(FrameType.DATA, tenant, s.tx_seq,
                                      payload, dtype=s.wire_dtype,
                                      a_int=a_int, a_frac=a_frac,
                                      trace_id=trace_id, t_client=t_client))
        s.tx_seq += 1
        self._flush(tenant, s)

    def finish(self, tenant: str) -> None:
        """Queue the EOS trailer (rides the data seq space, needs no
        credit — see the gateway's flow-control notes)."""
        s = self.streams[tenant]
        if not s.eos_tx:
            s.eos_tx = True
            s.backlog.append(encode_frame(FrameType.EOS, tenant, s.tx_seq))
            s.tx_seq += 1
            self._flush(tenant, s)

    def _flush(self, tenant: str, s: _ClientStream) -> None:
        while s.backlog:
            # The EOS frame is always the backlog tail (finish() is final)
            # and needs no credit: flush DATA while credit lasts, then the
            # trailing EOS unconditionally.
            if len(s.backlog) == 1 and s.eos_tx:
                self.transport.send(s.backlog.popleft())
                s.sent += 1
                continue
            if s.sent >= s.granted_total:
                break
            self.transport.send(s.backlog.popleft())
            s.sent += 1

    def credits(self, tenant: str) -> int:
        """DATA frames this tenant may still put on the wire right now."""
        s = self.streams[tenant]
        return max(0, s.granted_total - s.sent)

    def backlog(self, tenant: str) -> int:
        return len(self.streams[tenant].backlog)

    # -- receive path ---------------------------------------------------------

    def poll(self, max_datagrams: int = 64, timeout: float = 0.0) -> int:
        n = 0
        for _ in range(max_datagrams):
            data = self.transport.recv(timeout=timeout)
            if data is None:
                break
            n += 1
            try:
                f = decode_frame(data)
            except FrameError:
                self.decode_errors += 1
                continue
            s = self.streams.get(f.tenant)
            if f.ftype == FrameType.ACK:
                self._acks[f.seq] = unpack_control(f.payload)[0]
            elif s is None:
                continue
            elif f.ftype == FrameType.CREDIT:
                total = int.from_bytes(f.payload[:4], "little")
                s.granted_total = max(s.granted_total, total)
                self._flush(f.tenant, s)
            elif f.ftype == FrameType.NACK:
                s.nacks.append(f.payload.decode("utf-8", "replace"))
            elif f.ftype in (FrameType.DATA, FrameType.EOS):
                for g in s.reasm.offer(f.seq, f):
                    if g.ftype == FrameType.EOS:
                        s.eos_rx = True
                    else:
                        s.chunks.append(g.samples())
        return n

    def symbols(self, tenant: str) -> np.ndarray:
        """The reassembled egress symbol stream so far."""
        s = self.streams[tenant]
        if not s.chunks:
            return np.zeros((0,), np.float32)
        return np.concatenate(s.chunks)

    def done(self, tenant: str) -> bool:
        s = self.streams[tenant]
        return s.eos_rx and not s.backlog

    def errors(self, tenant: str) -> List[str]:
        return list(self.streams[tenant].nacks)

    # -- control commands -----------------------------------------------------

    def command(self, tenant: str, fields: dict, arrays=None, *,
                pump=None, max_rounds: int = 10_000) -> dict:
        """Post one CTRL frame and poll to its ACK. `pump` (optional
        callable) is invoked each round to advance an in-process server —
        pass `gateway.step` in single-threaded tests."""
        self._cmd_seq += 1
        cmd = self._cmd_seq
        self.transport.send(encode_frame(
            FrameType.CTRL, tenant, cmd, pack_control(fields, arrays)))
        for _ in range(max_rounds):
            if pump is not None:
                pump()
            self.poll(timeout=0.001)
            if cmd in self._acks:
                ack = self._acks.pop(cmd)
                if not ack.get("ok"):
                    raise ControlAckError(ack.get("error", "rejected"))
                return ack
        raise TimeoutError(f"no ack for control command {cmd}")

    def open(self, tenant: str, cfg, weights, *, formats=None,
             backend: str = "auto", tile_m="auto", per_channel: bool = False,
             priority: int = 0, credits: Optional[int] = None,
             wire_dtype: Optional[WireDtype] = None, pump=None) -> dict:
        """OPEN the tenant over the wire and attach its client stream on
        the granted credit window + int8 grid from the ack."""
        import dataclasses
        fields = {"reg": Reg.OPEN, "cfg": dataclasses.asdict(cfg),
                  "backend": backend, "tile_m": tile_m,
                  "per_channel": per_channel, "priority": priority}
        if formats is not None:
            fields["formats"] = [list(f) for f in formats]
        if credits is not None:
            fields["credits"] = credits
        ack = self.command(tenant, fields, weights_to_arrays(weights),
                           pump=pump)
        self.attach(tenant,
                    wire_dtype or WireDtype(ack["wire_dtype"]),
                    grid=(ack["a_int"], ack["a_frac"]),
                    granted=ack["granted"])
        return ack

    def close(self, tenant: str, pump=None) -> dict:
        ack = self.command(tenant, {"reg": Reg.CLOSE}, pump=pump)
        self.streams.pop(tenant, None)
        return ack

    def swap_weights(self, tenant: str, weights, pump=None) -> dict:
        return self.command(tenant, {"reg": Reg.SWAP_WEIGHTS},
                            weights_to_arrays(weights), pump=pump)

    def rollback_weights(self, tenant: str, pump=None) -> dict:
        return self.command(tenant, {"reg": Reg.ROLLBACK}, pump=pump)

    def set_policy(self, pump=None, **knobs) -> dict:
        return self.command("_", {"reg": Reg.SET_POLICY, **knobs}, pump=pump)

    def read_stats(self, pump=None) -> dict:
        return self.command("_", {"reg": Reg.READ_STATS}, pump=pump)
