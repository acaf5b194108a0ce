"""Pluggable datagram transports for the net layer.

Port of `repro.net.transport` (numpy and the standard library): the
schedule draws from numpy's `default_rng` in the reference's order, so a
seed gives the same reorder, duplicate and drop pattern in both packages.

Two implementations behind one duck-typed interface (``send(bytes)``,
``recv(timeout=0.0) -> Optional[bytes]``, ``close()``):

  * `loopback_pair` — an in-memory datagram pair whose two directions
    each run a deterministic seeded `WireSchedule` of impairments
    (bounded reordering, duplication, explicit drops). Every adversarial
    wire test and `chip_smoke.py` [13] run on this: the same seed
    always yields the same delivery order, so "bitwise under reordering"
    is a reproducible claim, not a flake.
  * `UdpTransport` — a real UDP socket (one peer per endpoint), so the
    same gateway/client code that passes the deterministic suite can be
    driven by actual datagrams.

The loopback reordering model: datagram i is assigned a delay
d ∈ [0, reorder_window] and released once `i + d` sends have happened
(or on demand when the receiver drains an otherwise-empty wire), which
bounds displacement by the window — the property `NetIngress` sizes its
reassembly buffer against.
"""
from __future__ import annotations

import heapq
import socket
import threading
from collections import deque
from typing import Optional

import numpy as np


class WireSchedule:
    """Deterministic seeded impairment plan for one loopback direction.

    reorder_window — max positions a datagram may be displaced (0: FIFO).
    dup_prob       — probability a datagram is delivered twice.
    drop_idx       — send indices (0-based, pre-duplication) to drop.
    drop_prob      — additional random drop probability.
    """

    def __init__(self, seed: int = 0, reorder_window: int = 0,
                 dup_prob: float = 0.0, drop_idx=(),
                 drop_prob: float = 0.0):
        self.seed = int(seed)
        self.reorder_window = int(reorder_window)
        self.dup_prob = float(dup_prob)
        self.drop_idx = frozenset(int(i) for i in drop_idx)
        self.drop_prob = float(drop_prob)

    def spawn_rng(self) -> np.random.Generator:
        return np.random.default_rng(self.seed)


class _Pipe:
    """One impaired direction: a release-ordered heap + a ready queue."""

    def __init__(self, schedule: Optional[WireSchedule]):
        self.schedule = schedule or WireSchedule()
        self.rng = self.schedule.spawn_rng()
        self.ready: deque = deque()
        self.held: list = []            # (release_at, tiebreak, datagram)
        self.sent = 0                   # send index (pre-duplication)
        self.tiebreak = 0
        self.dropped = 0
        self.duplicated = 0
        self.lock = threading.Lock()
        self.closed = False

    def put(self, data: bytes) -> None:
        with self.lock:
            if self.closed:
                raise OSError("transport closed")
            sch, idx = self.schedule, self.sent
            self.sent += 1
            copies = 1
            if idx in sch.drop_idx or (
                    sch.drop_prob and self.rng.random() < sch.drop_prob):
                self.dropped += 1
                copies = 0
            elif sch.dup_prob and self.rng.random() < sch.dup_prob:
                self.duplicated += 1
                copies = 2
            for _ in range(copies):
                delay = (int(self.rng.integers(0, sch.reorder_window + 1))
                         if sch.reorder_window else 0)
                heapq.heappush(self.held,
                               (idx + delay, self.tiebreak, bytes(data)))
                self.tiebreak += 1
            while self.held and self.held[0][0] <= idx:
                self.ready.append(heapq.heappop(self.held)[2])

    def get(self) -> Optional[bytes]:
        with self.lock:
            if self.ready:
                return self.ready.popleft()
            if self.held:           # wire idle: deliver the earliest held
                return heapq.heappop(self.held)[2]
            return None


class LoopbackTransport:
    """One endpoint of an in-memory datagram pair (see `loopback_pair`)."""

    def __init__(self, tx: _Pipe, rx: _Pipe):
        self._tx = tx
        self._rx = rx

    def send(self, data: bytes) -> None:
        self._tx.put(data)

    def recv(self, timeout: float = 0.0) -> Optional[bytes]:
        return self._rx.get()

    def close(self) -> None:
        self._tx.closed = True

    @property
    def stats(self) -> dict:
        """Impairment accounting for THIS endpoint's transmit direction."""
        return {"sent": self._tx.sent, "dropped": self._tx.dropped,
                "duplicated": self._tx.duplicated}


def loopback_pair(schedule_ab: Optional[WireSchedule] = None,
                  schedule_ba: Optional[WireSchedule] = None):
    """Two connected `LoopbackTransport` endpoints (a, b); datagrams a→b
    run `schedule_ab`, b→a run `schedule_ba` (None: a clean FIFO wire)."""
    ab, ba = _Pipe(schedule_ab), _Pipe(schedule_ba)
    return LoopbackTransport(ab, ba), LoopbackTransport(ba, ab)


class UdpTransport:
    """Real UDP datagram endpoint with the loopback's interface.

    One peer per endpoint: a client passes ``remote=`` at construction;
    a server learns its peer from the first datagram it receives (the
    net layer's NACK/credit/ack traffic then flows back to it). Sends
    before the peer is known are buffered (bounded) and flushed on the
    first receive — a server gateway can `open_wire` (initial CREDIT
    grant) before its client has said anything.
    """

    PRE_PEER_BUFFER = 256

    def __init__(self, bind=("127.0.0.1", 0), remote=None):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(bind)
        self.remote = tuple(remote) if remote else None
        self._pre_peer: list = []

    @property
    def address(self):
        return self.sock.getsockname()

    def send(self, data: bytes) -> None:
        if self.remote is None:
            if len(self._pre_peer) >= self.PRE_PEER_BUFFER:
                raise OSError("no peer yet and pre-peer buffer full")
            self._pre_peer.append(data)
            return
        self.sock.sendto(data, self.remote)

    def recv(self, timeout: float = 0.0) -> Optional[bytes]:
        self.sock.settimeout(timeout if timeout > 0 else 0.000_1)
        try:
            data, addr = self.sock.recvfrom(65535)
        except (socket.timeout, BlockingIOError):
            return None
        if self.remote is None:
            self.remote = addr
            for d in self._pre_peer:
                self.sock.sendto(d, self.remote)
            self._pre_peer.clear()
        return data

    def close(self) -> None:
        self.sock.close()
