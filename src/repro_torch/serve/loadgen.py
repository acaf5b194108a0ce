"""Load generation for the serving runtime — reproducible tenant traffic.

Port of `repro.serve.loadgen` (numpy and the standard library, plus the
port's drifting channels for `drift_streams`). `chop`, `random_waveforms`
and `replay` give bitwise the reference's chunks, waveforms and totals
for the same seeds. Builds per-tenant waveform chunk schedules and
replays them against a `ServeRuntime` or `AsyncServeRuntime` round-robin,
which is the worst case for a batcher: every tenant's chunks arrive
interleaved, so coalescing only happens if the scheduler actually does its
job.

Wire mode: `replay_wire` sends the same round-robin traffic through a
`repro_torch.net.NetClient` over a transport to a `NetGateway` serving the
runtime, and reads the symbols back out of the egress frames.

Drift mode: `drift_streams` walks a time-varying channel
(`repro_torch.channels.drift`) through a `DriftSchedule`, advancing the
channel state once per BURST, and returns both the waveform chunks and the
true tx symbols per chunk — the pilot labels an adaptation loop trains
against. Each (burst, tenant) draw comes from its own `torch.Generator`
seeded by `np.random.SeedSequence([seed, burst, tenant index])` on the
given device (the reference's `fold_in` keys have no torch counterpart,
so the draws differ from the reference's; the structure does not).
`replay_adaptive` replays such traffic while feeding pilots to a
duck-typed adapter (``tenants``, ``feed_pilots``, ``step``) between
rounds; with ``adapter=None`` it is the frozen control arm.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
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


def _burst_generator(seed: int, burst: int, i: int,
                     device: torch.device) -> torch.Generator:
    """The generator of tenant i's draw in one burst, on ``device``."""
    state = np.random.SeedSequence([seed, burst, i]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def drift_streams(channel, schedule, tenant_ids: Sequence[str],
                  n_bursts: int, syms_per_burst: int, seed: int = 0,
                  device: DeviceLike = "cuda"
                  ) -> Tuple[Dict[str, List[np.ndarray]],
                             Dict[str, List[np.ndarray]]]:
    """Piecewise-stationary tenant traffic over a drifting channel.

    channel:   a `repro_torch.channels.drift` wrapper (`DriftingProakis` /
               `DriftingIMDD`) — anything with `.at(t, device=…) →
               channel_fn(generator, n_syms)`.
    schedule:  a `DriftSchedule` mapping burst index → drift coordinate.
    Each tenant gets its own generator per burst (same channel STATE,
    independent noise/data), drawn on ``device``, and the channel state
    advances once per burst for all tenants — the physical picture of
    links sharing a drifting medium.

    Returns (streams, pilots): per tenant, the list of float32 waveform
    chunks and the matching list of int32 true tx symbol arrays (host
    numpy; the labels a pilot-driven adaptation loop uses; ignore them to
    model blind operation).
    """
    dev = resolve_device(device)
    streams: Dict[str, List[np.ndarray]] = {t: [] for t in tenant_ids}
    pilots: Dict[str, List[np.ndarray]] = {t: [] for t in tenant_ids}
    for burst in range(n_bursts):
        fn = channel.at(schedule.t_at(burst), device=dev)
        for i, tid in enumerate(tenant_ids):
            rx, syms = fn(_burst_generator(seed, burst, i, dev),
                          syms_per_burst)
            streams[tid].append(rx.cpu().numpy().astype(np.float32))
            pilots[tid].append(syms.cpu().numpy().astype(np.int32))
    return streams, pilots


def replay_adaptive(runtime: Union[ServeRuntime, AsyncServeRuntime],
                    streams: Dict[str, Sequence[np.ndarray]],
                    pilots: Optional[Dict[str, Sequence[np.ndarray]]] = None,
                    adapter=None, step_every: int = 1,
                    pump_between: bool = True) -> Dict[str, float]:
    """Round-robin replay with pilot feeding + adaptation cycles.

    Like `replay`, but: tenants present in `pilots` AND attached to
    `adapter` get their true tx symbols fed as labels right before each
    chunk is submitted (stream-order lockstep, as the adapt package's
    collector expects), and every `step_every` rounds the adapter runs one synchronous adaptation cycle over its tenants.
    Pass adapter=None to replay the same traffic with adaptation off (the
    frozen-tenant control arm benches compare against).
    """
    ids = list(streams)
    iters = {t: iter(streams[t]) for t in ids}
    piter = {t: iter(pilots[t]) for t in pilots or {}}
    adapted = set() if adapter is None else set(adapter.tenants)
    live = set(ids)
    rounds = 0
    t0 = time.perf_counter()
    while live:
        for t in list(live):
            chunk = next(iters[t], None)
            labels = next(piter[t], None) if t in piter else None
            if chunk is None:
                live.discard(t)
                runtime.finish(t)
                continue
            if adapter is not None and t in adapted and labels is not None:
                adapter.feed_pilots(t, labels)
            runtime.submit(t, chunk)
        if pump_between:
            runtime.pump()
        rounds += 1
        if adapter is not None and step_every > 0 \
                and rounds % step_every == 0:
            adapter.step()
    runtime.drain()
    if adapter is not None:
        adapter.step()                 # final cycle over the full buffer
    elapsed = time.perf_counter() - t0
    total_syms = sum(runtime.sessions.get(t).syms_emitted for t in ids
                     if t in runtime.sessions)
    return {"elapsed_s": elapsed, "total_syms": total_syms,
            "agg_syms_per_s": total_syms / elapsed if elapsed else 0.0,
            "rounds": rounds}


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


def replay_wire(gateway, client, streams: Dict[str, Sequence[np.ndarray]],
                burst: int = 1, max_rounds: int = 100_000
                ) -> Dict[str, object]:
    """Round-robin replay THROUGH THE WIRE (the frame-emitting mode).

    Like `replay`, but every chunk crosses a transport as a DATA frame:
    `client` is a `repro_torch.net.NetClient` whose tenants are attached (or
    wire-opened), `gateway` the `repro_torch.net.NetGateway` serving the
    runtime on the other end. Single-threaded cooperative driving —
    client sends ride the credit window, the gateway polls/pumps/emits,
    and a stalled round (client credit-blocked while launches wait on
    policy) forces a `settle()` so progress is deadlock-free. Tenants
    whose wire errors (NACK / ingress `stream_gap`) surface stop being
    waited on — the error is in the returned `errors` map, never a hang.

    `burst` chunks per tenant go out between polls (burst>1 keeps several
    datagrams in flight so an impaired wire actually gets to reorder).

    Returns wall-clock accounting plus per-tenant received symbol counts
    and surfaced wire errors."""
    ids = list(streams)
    iters = {t: iter(streams[t]) for t in ids}
    live = list(ids)          # ordered: send order must be deterministic
    waiting = list(ids)       # (impairment schedules index datagrams)
    errors: Dict[str, str] = {}
    t0 = time.perf_counter()
    rounds = 0
    while waiting:
        rounds += 1
        if rounds > max_rounds:
            raise RuntimeError(f"replay_wire stalled: {sorted(waiting)} "
                               f"never finished")
        activity = 0
        for t in list(live):
            for _ in range(max(1, burst)):   # burst>1: frames actually
                chunk = next(iters[t], None)  # share the wire and reorder
                if chunk is None:
                    live.remove(t)
                    client.finish(t)
                    break
                client.send_samples(t, chunk)
            activity += 1
        activity += gateway.step(max_datagrams=256)
        activity += client.poll(max_datagrams=256)
        for t in list(waiting):
            err = (client.errors(t) or [None])[0] or gateway.ingress.error(t)
            if err:
                errors[t] = str(err)
                waiting.remove(t)
            elif client.done(t):
                waiting.remove(t)
        if not activity and waiting:
            gateway.settle()
            if not client.poll(max_datagrams=256):
                gateway.ingress.flush_gaps()
    elapsed = time.perf_counter() - t0
    received = {t: int(client.symbols(t).shape[0]) for t in ids
                if t in client.streams}
    total_syms = sum(received.values())
    return {"elapsed_s": elapsed, "total_syms": total_syms,
            "agg_syms_per_s": total_syms / elapsed if elapsed else 0.0,
            "rounds": rounds, "received": received, "errors": errors}
