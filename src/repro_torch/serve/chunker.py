"""Stateful overlap-save chunking — streaming ⇒ offline equivalence.

A tenant streams waveform samples in ARBITRARY chunk sizes (including chunks
smaller than the receptive field); the serving runtime must emit exactly the
symbols the offline engine would produce on the concatenated stream —
bitwise for the fp32/bf16 datapaths, ≤1 LSB (observed: bitwise) for int8.

This is the paper's OGM/ORM overlap machinery turned stateful: instead of
splitting one long recorded stream into overlapped chunks (stream_partition),
the chunker carries the receptive-field tail of an UNBOUNDED stream between
arrivals.

How bitwise equivalence is achieved
-----------------------------------
The fused kernel computes output position p (one network pass = V_p symbols)
from the input window  x[p·ts − halo, p·ts + halo]  (ts = V_p·N_os samples
per pass, halo = half a receptive field in samples), processing positions in
tiles of `tile_m` with identical per-tile shapes everywhere in the stream.
Each output element is an independent chain of tap dots over its own window
— no cross-position reduction — so an element's value depends ONLY on

  (a) its window's sample values, and
  (b) its position WITHIN a tile (which fixes the op shapes around it).

The chunker therefore keeps its carry aligned to TILE boundaries: the buffer
always starts at a sample offset  o = o_pos·ts  with  o_pos ≡ 0 (mod
tile_m), so every position lands in the same tile column as in the offline
call, and its window content is identical ⇒ bitwise-equal output. The
positions recomputed for alignment/context (≤ tile_m + ⌈halo/ts⌉ per launch)
are sliced off before emission.

`StreamChunker` is pure bookkeeping (numpy, host-side) — it never runs the
engine. It hands out `ChunkPlan`s: (engine input row, positions to skip,
positions to emit); the micro-batcher pads plans from many tenants to a
common width bucket and runs them as ONE stacked fused launch.

The contract is UNCONDITIONAL on stream length: `_fused_call` never
shrinks the requested `tile_m` (a stream shorter than one tile pads the
tile out exactly like serve's full-tile buckets do), so the offline call
tiles identically to the serve launches even for micro-streams — it once
clamped `tile_m` to the stream's positions, which changed the tile-column
op shapes and cost micro-streams 1–2 ULP vs serve
(`tests/test_net.py::test_wire_micro_stream_lengths_bitwise` regresses
the fix).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class CarrySnapshot:
    """An immutable copy of a `StreamChunker`'s full stream state.

    Taken by `StreamChunker.snapshot` and reinstalled by `restore` — the
    failover primitive: a session whose engine died mid-stream rebuilds
    the engine from its `TenantSpec` and re-equalizes from the saved
    carry, emitting exactly the symbols the uninterrupted stream would
    have (the chunker is pure bookkeeping, so state capture IS stream
    capture). The arrays are copied on both capture and restore, so a
    snapshot stays valid however the live chunker advances afterwards.
    """
    buf: np.ndarray
    o_pos: int
    next_pos: int
    total_samples: int
    finished: bool


@dataclasses.dataclass
class ChunkPlan:
    """One pending engine launch for one tenant stream.

    data:    (W,) fp32 engine input — carry + new samples (+ flush padding).
    skip:    leading output positions to DROP (alignment/context recompute).
    n_emit:  output positions to emit after `skip` (V_p symbols each).
    span:    optional `repro_torch.obs.ChunkSpan` lifecycle trace attached at
             enqueue when tracing is on (None otherwise). It rides the plan
             through retries, failover replays, and fleet migrations so the
             chunk's full recovery path lands in one span.
    """
    data: np.ndarray
    skip: int
    n_emit: int
    span: Optional[object] = None

    @property
    def width(self) -> int:
        return int(self.data.shape[0])


class StreamChunker:
    """Carries the receptive-field tail of one tenant's sample stream.

    halo:         half receptive field, in SAMPLES (engine.halo_samples;
                  ≥ 0 or __init__ raises ValueError).
    total_stride: samples consumed per output position, V_p · N_os
                  (engine.total_stride; ≥ 1 or ValueError).
    tile_m:       the engine's resolved tile width, in POSITIONS (≥ 1 or
                  ValueError) — carry stays tile-aligned so chunked output
                  is bitwise-equal to offline (see module docstring). Must
                  be the tile the launches actually use; fixed for the
                  stream's lifetime.

    Failure modes: `push()` after `finish()` raises RuntimeError (the
    stream contract is append-then-seal); everything else is total —
    `plan()` returns None rather than raising when nothing is emittable.
    """

    def __init__(self, halo: int, total_stride: int, tile_m: int):
        if total_stride <= 0 or tile_m <= 0 or halo < 0:
            raise ValueError("halo ≥ 0, total_stride ≥ 1, tile_m ≥ 1")
        self.halo = halo
        self.ts = total_stride
        self.tile_m = tile_m
        # positions needed as left context before the next unemitted one
        self._ctx_pos = -(-halo // total_stride)           # ceil
        self._buf = np.zeros((0,), np.float32)
        self._o_pos = 0          # global position index of buf sample 0
        self._next_pos = 0       # next global position to emit
        self._total_samples = 0  # total samples pushed so far
        self.finished = False

    # -- stream input ------------------------------------------------------

    def push(self, samples: np.ndarray) -> None:
        """Append a chunk of waveform samples (any length ≥ 0)."""
        if self.finished:
            raise RuntimeError("stream already finished")
        s = np.asarray(samples, np.float32).reshape(-1)
        self._buf = np.concatenate([self._buf, s])
        self._total_samples += s.shape[0]

    def finish(self) -> None:
        """Mark end-of-stream: remaining positions flush with zero right-
        padding, exactly like the offline engine pads its stream tail."""
        self.finished = True

    # -- launch planning ---------------------------------------------------

    def pending_positions(self) -> int:
        """Positions ready to emit right now (full real-sample windows; at
        end-of-stream, everything up to ⌊total/ts⌋ — the offline count)."""
        if self.finished:
            total = self._total_samples // self.ts
            return max(0, total - self._next_pos)
        n = self._buf.shape[0]
        if n <= self.halo:
            return 0
        avail = (n - 1 - self.halo) // self.ts + 1         # windows complete
        avail = min(avail, n // self.ts)                   # engine computes
        return max(0, avail - (self._next_pos - self._o_pos))

    def plan(self) -> Optional[ChunkPlan]:
        """Build the next launch plan, or None if nothing is emittable."""
        n_emit = self.pending_positions()
        if n_emit == 0:
            return None
        skip = self._next_pos - self._o_pos
        data = self._buf
        need = (skip + n_emit) * self.ts                   # engine n_pos cover
        if data.shape[0] < need:                           # flush tail pad
            data = np.concatenate(
                [data, np.zeros((need - data.shape[0],), np.float32)])
        return ChunkPlan(data=data, skip=skip, n_emit=n_emit)

    def commit(self, plan: ChunkPlan) -> None:
        """Advance the stream past `plan` and trim the carry tile-aligned."""
        self._next_pos += plan.n_emit
        # keep ≥ ctx_pos positions of context, rounded DOWN to a tile edge
        new_o = max(0, ((self._next_pos - self._ctx_pos)
                        // self.tile_m) * self.tile_m)
        new_o = max(new_o, self._o_pos)                    # monotonic
        drop = (new_o - self._o_pos) * self.ts
        if drop:
            self._buf = self._buf[drop:]
            self._o_pos = new_o

    # -- failover: carry snapshot / restore --------------------------------

    def snapshot(self) -> CarrySnapshot:
        """Capture the complete stream state (deep copy). Bitwise-exact:
        a chunker restored from this snapshot plans and emits the same
        positions, with the same tile alignment, as one that never
        detoured — regardless of any pushes/commits in between."""
        return CarrySnapshot(buf=self._buf.copy(), o_pos=self._o_pos,
                             next_pos=self._next_pos,
                             total_samples=self._total_samples,
                             finished=self.finished)

    def restore(self, snap: CarrySnapshot) -> None:
        """Reinstall a snapshot taken from THIS stream (or a stream with
        the same halo/stride/tile geometry — restoring across geometries
        would break the tile-alignment invariant, and is the caller's
        bug). Everything pushed or committed since the snapshot is
        discarded."""
        self._buf = snap.buf.copy()
        self._o_pos = snap.o_pos
        self._next_pos = snap.next_pos
        self._total_samples = snap.total_samples
        self.finished = snap.finished

    # -- introspection -----------------------------------------------------

    @property
    def carry_samples(self) -> int:
        return int(self._buf.shape[0])

    @property
    def emitted_positions(self) -> int:
        return self._next_pos
