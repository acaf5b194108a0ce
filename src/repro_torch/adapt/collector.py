"""Per-tenant sample collection from served traffic.

Port of `repro.adapt.collector`: host numpy and `threading`, as the
reference's. The port's descatter hands the tap host numpy (the plan row
and the symbols copied back from the card), so nothing here touches a
device.

The online-adaptation loop needs (rx, target) pairs to fine-tune on, and
the serving runtime already has both halves in its hands: the descatter
phase sees each chunk's REAL input samples (the plan row, context sliced
off) and the symbols the active equalizer produced for them. The
`SampleCollector` is the `Session.tap` callback that buffers those pairs —
no second pass over the stream, no extra launches.

Labels come in two flavours, mirroring the unsupervised-FPGA-equalizer
line of work (Ney et al. 2023):

  * PILOT labels — the true transmitted symbols, supplied by the
    application in stream order (`add_pilots`). Links periodically send
    known pilot sequences exactly so receivers can retrain; the drift
    load generator (`repro_torch.serve.loadgen` `drift_streams`) knows
    the tx symbols and plays this role in benches/tests.
  * DECISION-DIRECTED labels — hard decisions on the equalizer's own
    output, used wherever no pilot is buffered. At moderate degradation
    most decisions are still correct, which is what makes
    decision-directed adaptation work in practice (and why adaptation
    should kick in BEFORE the channel has fully drifted away).

The buffer is a bounded ring over SEGMENTS (one per served chunk, stream
order): old traffic expires, so under drift the trainer sees the channel
as it is now, not as it was an hour ago. A deterministic 1-in-`eval_every`
slice of segment BLOCKS (runs of `EVAL_BLOCK` consecutive segments) is
held out for the shadow evaluator — interleaved in time, so train and
eval sets cover the same drift states, and never seen by the fine-tuner.
Holding out contiguous runs (rather than single segments) keeps splice
points rare: concatenating non-adjacent segments creates boundaries where
the equalizer's receptive field mixes samples from different moments (see
`training_view`).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Deque, Tuple

import numpy as np


# eval holdout granularity: runs of this many CONSECUTIVE segments are
# held out together, so eval (and train) boundaries are more often true
# stream neighbours and splice points get rarer (one per block, not one
# per segment). Kept small enough that held-out data still arrives within
# the first few served bursts — a large block would starve the shadow
# evaluator early in a stream's life.
EVAL_BLOCK = 2


def pam_amplitudes(levels: int) -> np.ndarray:
    """Unit-power PAM constellation (numpy twin of channels.common)."""
    pts = 2.0 * np.arange(levels, dtype=np.float32) - (levels - 1)
    return pts / np.sqrt(np.mean(pts**2))


def hard_decide(soft: np.ndarray, levels: int) -> np.ndarray:
    """Nearest-constellation-point decision → symbol indices."""
    const = pam_amplitudes(levels)
    return np.argmin(np.abs(soft[:, None] - const[None, :]), axis=1)


@dataclasses.dataclass
class _Segment:
    rx: np.ndarray          # (n·n_os,) fp32 waveform samples, copied
    syms: np.ndarray        # (n,) int label symbols (pilot or decision)
    piloted: int            # how many leading labels came from pilots
    is_eval: bool           # held out for the shadow evaluator


class SampleCollector:
    """Bounded ring of served (rx, label) segments for one tenant.

    n_os / levels:   the tenant's oversampling and PAM order.
    capacity_syms:   ring bound (symbols; default 32768). Oldest segments
                     drop first — under drift, stale data is worse than
                     less data.
    eval_every:      every `eval_every`-th BLOCK of `EVAL_BLOCK`
                     consecutive segments is held out for shadow
                     evaluation (default 4 → 25% holdout),
                     deterministically by arrival index so train/eval
                     interleave in time.

    Thread-safety: `on_segment` runs on the serving descatter path (the
    async runtime's launcher thread) while the trainer reads views from
    the adaptation thread; a lock guards the ring.
    """

    def __init__(self, n_os: int, levels: int,
                 capacity_syms: int = 1 << 15, eval_every: int = 4):
        if eval_every < 2:
            raise ValueError("eval_every must be ≥ 2 (need both sets)")
        self.n_os = n_os
        self.levels = levels
        self.capacity_syms = capacity_syms
        self.eval_every = eval_every
        self._lock = threading.Lock()
        self._segments: Deque[_Segment] = deque()
        self._pilots: Deque[np.ndarray] = deque()
        self._pilot_syms = 0
        self._seg_count = 0          # lifetime arrival index (eval split)
        self.total_syms = 0          # lifetime labelled symbols
        self.buffered_syms = 0
        self.pilot_labelled = 0      # lifetime pilot-labelled symbols

    # -- inputs ------------------------------------------------------------

    def add_pilots(self, syms: np.ndarray) -> None:
        """Queue true transmitted symbols, in stream order. They label the
        NEXT unlabelled served symbols (the pilot FIFO is consumed in
        lockstep with emission), so feed them as their waveform chunks are
        submitted."""
        s = np.asarray(syms).reshape(-1).astype(np.int32)
        if s.size == 0:
            return
        with self._lock:
            self._pilots.append(s)
            self._pilot_syms += int(s.size)

    def on_segment(self, rx: np.ndarray, soft_syms: np.ndarray) -> None:
        """The `Session.tap` callback: one emitted chunk's input samples +
        the soft symbols the active equalizer produced for them. Copies
        both (the rx view aliases the launch input buffer)."""
        n = int(soft_syms.shape[0])
        if n == 0:
            return
        rx = np.array(rx[: n * self.n_os], np.float32)
        labels = np.empty((n,), np.int32)
        with self._lock:
            take = 0
            while take < n and self._pilots:
                head = self._pilots[0]
                use = min(n - take, int(head.size))
                labels[take:take + use] = head[:use]
                take += use
                if use == int(head.size):
                    self._pilots.popleft()
                else:
                    self._pilots[0] = head[use:]
                self._pilot_syms -= use
            if take < n:
                labels[take:] = hard_decide(
                    np.asarray(soft_syms[take:], np.float32), self.levels)
            seg = _Segment(
                rx=rx, syms=labels, piloted=take,
                is_eval=((self._seg_count // EVAL_BLOCK)
                         % self.eval_every == self.eval_every - 1))
            self._seg_count += 1
            self._segments.append(seg)
            self.total_syms += n
            self.buffered_syms += n
            self.pilot_labelled += take
            while self.buffered_syms > self.capacity_syms:
                old = self._segments.popleft()
                self.buffered_syms -= int(old.syms.shape[0])

    # -- views -------------------------------------------------------------

    def _concat(self, segs) -> Tuple[np.ndarray, np.ndarray]:
        if not segs:
            return (np.zeros((0,), np.float32), np.zeros((0,), np.int32))
        return (np.concatenate([s.rx for s in segs]),
                np.concatenate([s.syms for s in segs]))

    def training_view(self):
        """Snapshot → (train_rx, train_syms, eval_rx, eval_syms), each pair
        concatenated in stream order. Within a holdout block (and within a
        train run between blocks) neighbours are true stream neighbours;
        at BLOCK boundaries the concatenation splices traffic from
        different moments, so a receptive field spanning a splice sees
        incoherent ISI context for a few symbols. Those splices are rare
        (one per `EVAL_BLOCK` segments) and affect the active and
        candidate engines identically — the shadow comparison scores both
        on the same labels at the same splices — so they add a small
        shared BER offset, not a bias between the two."""
        with self._lock:
            segs = list(self._segments)
        train = [s for s in segs if not s.is_eval]
        heldout = [s for s in segs if s.is_eval]
        return self._concat(train) + self._concat(heldout)

    def stats(self) -> dict:
        with self._lock:
            return {"total_syms": self.total_syms,
                    "buffered_syms": self.buffered_syms,
                    "segments": len(self._segments),
                    "pilot_labelled": self.pilot_labelled,
                    "pilots_queued": self._pilot_syms}
