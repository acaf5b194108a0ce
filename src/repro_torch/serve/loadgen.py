"""Load generation for the serving runtime — reproducible tenant traffic.

Port of `repro.serve.loadgen`'s `chop`, `random_waveforms` and `replay`
(numpy and the standard library; the same seeds give bitwise the same
chunks and waveforms as the reference). Builds per-tenant waveform chunk
schedules and replays them against a `ServeRuntime` or `AsyncServeRuntime`
round-robin, which is the worst case for a batcher: every tenant's chunks
arrive interleaved, so coalescing only happens if the scheduler actually
does its job.

The reference's drift traffic (`drift_streams`, `replay_adaptive`) comes
with the port's drifting channels and adaptation, and `replay_wire` with
its network layer.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence, Union

import numpy as np

from .runtime import AsyncServeRuntime, ServeRuntime


def chop(waveform: np.ndarray, chunk_samples: int, seed: int = 0,
         jitter: float = 0.5) -> List[np.ndarray]:
    """Split one stream into chunks of ~chunk_samples (±jitter fraction),
    modelling bursty arrivals. jitter=0 → fixed-size chunks."""
    rng = np.random.default_rng(seed)
    out: List[np.ndarray] = []
    pos = 0
    total = int(waveform.shape[0])
    while pos < total:
        c = chunk_samples
        if jitter > 0:
            c = int(round(c * rng.uniform(1.0 - jitter, 1.0 + jitter)))
        c = max(1, min(c, total - pos))
        out.append(np.asarray(waveform[pos:pos + c], np.float32))
        pos += c
    return out


def random_waveforms(n_tenants: int, n_syms: int, n_os: int = 2,
                     seed: int = 0) -> List[np.ndarray]:
    """Unit-power random waveforms, one per tenant (throughput runs don't
    need channel realism; examples use the channel sims instead)."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n_syms * n_os).astype(np.float32)
            for _ in range(n_tenants)]


def replay(runtime: Union[ServeRuntime, AsyncServeRuntime],
           streams: Dict[str, Sequence[np.ndarray]],
           pump_between: bool = True) -> Dict[str, float]:
    """Round-robin replay: submit one chunk per tenant per round until all
    streams are exhausted, then flush tails and drain. Returns wall-clock
    accounting. Tenants must already be open on `runtime`. Works unchanged
    against both runtimes — the async runtime's `drain()` blocks until every
    launch has landed, so `total_syms` is complete either way."""
    ids = list(streams)
    iters = {t: iter(streams[t]) for t in ids}
    live = set(ids)
    t0 = time.perf_counter()
    while live:
        for t in list(live):
            chunk = next(iters[t], None)
            if chunk is None:
                live.discard(t)
                runtime.finish(t)
                continue
            runtime.submit(t, chunk)
        if pump_between:
            runtime.pump()
    runtime.drain()
    elapsed = time.perf_counter() - t0
    total_syms = sum(runtime.sessions.get(t).syms_emitted for t in ids
                     if t in runtime.sessions)
    return {"elapsed_s": elapsed, "total_syms": total_syms,
            "agg_syms_per_s": total_syms / elapsed if elapsed else 0.0}
