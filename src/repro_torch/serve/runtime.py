"""ServeRuntime — the synchronous multi-tenant streaming serving facade.

Port of `repro.serve.runtime` (the synchronous runtime and its helpers; the
threaded `AsyncServeRuntime` comes with a later slice):

    rt = ServeRuntime(BatchPolicy(max_batch=8, max_wait_s=2e-3))
    rt.open(TenantSpec("link-a", cfg, params=params_a))
    rt.submit("link-a", samples)        # arbitrary chunk sizes
    rt.pump()                           # honour max_wait while idle
    syms = rt.close("link-a")           # flush tail, return the stream

Every tenant's engine lives on the runtime's device (``device=``, default
"cuda"): each stacked launch copies its input to the card, runs one fused
kernel over all rows, and copies the symbols back. The streamed output is
bitwise equal to the offline engine on the whole waveform.

Serve-aware autotune lives in `_serve_tile`: tenants opened with
tile_m="auto", whose kernel tiles by it (`EqualizerEngine.tile_is_timed`),
after a tune-key's traffic histograms are warm (≥
`BatchPolicy.retune_after` launches) get `best_tile_m(probe_batch=mode
occupancy, probe_syms=median live width)` instead of the single-stream
default.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np

from ..core import autotune as autotune_lib
from ..core.engine import EqualizerEngine
from ..device import DeviceLike
from ..obs import Observability
from .pool import EnginePool
from .recovery import FaultPlan
from .scheduler import BatchPolicy, MicroBatcher, Request
from .session import Session, SessionManager, TenantSpec

# serve-aware probe floor: below this the sweep can't distinguish tiles
_MIN_PROBE_SYMS = 64


def _serve_tile(batcher: MicroBatcher,
                engine: EqualizerEngine) -> Optional[int]:
    """Serve-aware tile for a NEW session, or None to keep the engine's
    own tile (its single-stream autotune choice, or
    `core.engine.UNTIMED_TILE_M`).

    Returns a tile only where the engine's kernel tiles by it, and only
    once the engine's tune-key has ≥
    `BatchPolicy.retune_after` recorded launches AND steady-state occupancy
    is actually batched (mode > 1). The sweep probes `best_tile_m` with the
    OBSERVED mode batch occupancy and median launch width, and is cached
    under the batched (probe_batch, probe_syms) key.
    """
    pol = batcher.policy
    if pol.retune_after <= 0 or not engine.tile_is_timed():
        return None                    # disabled, or the kernel takes no tile
    stats = batcher.traffic.get(engine.tune_key())
    if stats is None or stats.launches < pol.retune_after:
        return None                    # histogram not warm yet
    occupancy = stats.mode_occupancy()
    if occupancy <= 1:
        return None                    # effectively single-stream traffic
    probe_syms = max(_MIN_PROBE_SYMS,
                     stats.median_width() // engine.cfg.n_os)
    tile = autotune_lib.best_tile_m(
        engine.cfg, engine.backend, engine._make_fn,
        probe_batch=occupancy, probe_syms=probe_syms, device=engine.device)
    batcher.tracer.instant(           # profiling hook: the serve-aware
        "autotune", backend=engine.backend,       # retune DECISION itself
        probe_batch=occupancy, probe_syms=probe_syms, tile_m=tile)
    return tile


def _swap_spec(session: Session, params, bn_state, weights) -> TenantSpec:
    """Build the hot-swap TenantSpec: NEW weights, the ACTIVE deployment's
    static kernel config (backend, formats, tile pinned to what the stream
    serves, so the group key cannot move). The weight epoch bumps by one;
    exactly one of params/weights must be given."""
    engine = session.engine
    return dataclasses.replace(
        session.spec, params=params, bn_state=bn_state, weights=weights,
        formats=engine.formats, backend=engine.backend,
        tile_m=engine.resolved_tile_m(),
        weight_epoch=session.spec.weight_epoch + 1)


def _wire_runtime_obs(rt, obs: Observability) -> None:
    """Register runtime-level telemetry under the "serve" scope: lazy
    snapshot-time callbacks over the existing accounting (pool LRU
    counters, per-session state), plus the engine-pool build hook that
    records builds as a histogram and trace instants."""
    scope = obs.scope("serve")
    pool = rt.sessions.pool
    pool.clock = obs.clock
    h_build = scope.histogram("pool.build_s")

    def _on_build(key, dt: float) -> None:
        h_build.observe(dt)
        obs.tracer.instant("engine_build", tenant=str(key), build_s=dt)

    pool.build_hook = _on_build
    scope.callback("pool", pool.stats)
    scope.callback("tenants", lambda: len(rt.sessions))
    scope.callback("sessions", lambda: {
        tid: {"syms_emitted": s.syms_emitted,
              "weight_epoch": s.weight_epoch,
              "recoveries": s.recoveries,
              "inflight": s.inflight,
              "shed": s.shed,
              "failed": s.failed is not None}
        for tid, s in rt.sessions.sessions.items()})


class ServeRuntime:
    """Synchronous single-threaded serving facade.

    Launches happen inside `submit`/`pump`/`drain` on the caller's thread,
    which keeps results deterministic (bitwise equal to the offline engine)
    while still modelling the real coalescing policy with timestamps.

    policy:       `BatchPolicy` coalescing knobs (default: max_batch=8,
                  max_wait_s=2 ms).
    max_engines:  LRU engine-pool bound (count; default 32). Evicting an
                  engine loses no stream state — it rebuilds from the
                  tenant's spec on next use.
    clock:        timestamp source (seconds; default time.perf_counter).
    fault_plan:   optional `FaultPlan` chaos schedule (launch + build
                  faults). An injected fault surfaces to the caller like any
                  launch error, and the un-executed batches requeue for the
                  next pump.
    sentinel_limit: output-sentinel bound (|y| ≤ limit, finite; default
                  None = disabled). A rejected batch raises `CorruptOutput`
                  with its inputs unconsumed.
    obs:          optional `repro_torch.obs.Observability` hub. Default None
                  builds a private hub with tracing OFF.
    device:       where every tenant's engine runs ("cuda" by default;
                  raises when no card is present; "cpu" runs the kernels'
                  plain versions).
    """

    def __init__(self, policy: Optional[BatchPolicy] = None,
                 max_engines: int = 32,
                 clock: Callable[[], float] = time.perf_counter,
                 fault_plan: Optional[FaultPlan] = None,
                 sentinel_limit: Optional[float] = None,
                 obs: Optional[Observability] = None,
                 device: DeviceLike = "cuda"):
        self.obs = obs if obs is not None else Observability(clock=clock)
        self.sessions = SessionManager(
            max_engines=max_engines,
            swap_log_max=self.obs.retention.swap_log, device=device)
        self.device = self.sessions.device
        self.batcher = MicroBatcher(policy, clock=clock, obs=self.obs)
        self.batcher.fault_plan = fault_plan
        self.batcher.sentinel_limit = sentinel_limit
        self.sessions.pool.fault_plan = fault_plan
        _wire_runtime_obs(self, self.obs)

    # -- tenant lifecycle --------------------------------------------------

    def open(self, spec: TenantSpec) -> Session:
        """Admit a tenant: build (or pool-hit) its engine, start a stream.
        Raises ValueError if the tenant_id is already open. Specs with
        tile_m="auto" may receive a serve-aware tile (see `_serve_tile`)."""
        return self.sessions.open(
            spec, tile_tuner=lambda e: _serve_tile(self.batcher, e))

    def close(self, tenant_id: str) -> np.ndarray:
        """End a tenant's stream: flush the receptive-field tail, launch
        ONLY this tenant's pending requests, release the session; returns
        the full symbol stream (identical to the offline engine on the
        whole waveform)."""
        self.finish(tenant_id)
        self.batcher.flush_session(self.sessions.get(tenant_id))
        return self.sessions.close(tenant_id).output()

    # -- weight hot-swap ---------------------------------------------------

    def swap_weights(self, tenant_id: str, params=None, bn_state=None,
                     weights=None) -> int:
        """Hot-swap a live tenant's weights at a chunk boundary.

        Flushes the tenant's pending requests first, so every position
        planned so far is emitted with the OLD weights and positions planned
        afterwards use the NEW ones; within each weight epoch the stream
        stays bitwise equal to that epoch's offline engine. Backend,
        formats and tile are pinned from the live engine; a swap that would
        change any of them raises ValueError and leaves the stream
        untouched. Returns the new weight epoch."""
        s = self.sessions.get(tenant_id)
        self.batcher.flush_session(s)
        epoch = s.install_spec(_swap_spec(s, params, bn_state, weights))
        self.obs.tracer.instant("hot_swap", tenant=tenant_id, epoch=epoch)
        return epoch

    def rollback_weights(self, tenant_id: str) -> int:
        """Restore the spec active before the last swap under a NEW epoch.
        Raises RuntimeError if there is nothing to roll back to."""
        s = self.sessions.get(tenant_id)
        if s.prev_spec is None:
            raise RuntimeError(f"tenant {tenant_id!r}: no previous weights")
        prev = dataclasses.replace(s.prev_spec,
                                   weight_epoch=s.spec.weight_epoch + 1)
        self.batcher.flush_session(s)
        epoch = s.install_spec(prev)
        self.obs.tracer.instant("rollback", tenant=tenant_id, epoch=epoch)
        return epoch

    # -- streaming ---------------------------------------------------------

    def submit(self, tenant_id: str, samples) -> Optional[Request]:
        """Feed a chunk of waveform samples; may trigger batched launches
        (max_batch reached, or another group's max_wait expired). Returns
        the queued request (symbols populated once launched) or None when
        the chunk is buffered below one emittable position."""
        s = self.sessions.get(tenant_id)
        s.chunker.push(np.asarray(samples))
        req = self.batcher.enqueue(s)
        self.batcher.pump()
        return req

    def finish(self, tenant_id: str) -> Optional[Request]:
        """End-of-stream marker: queue the zero-padded tail flush."""
        s = self.sessions.get(tenant_id)
        if not s.chunker.finished:
            s.chunker.finish()
        return self.batcher.enqueue(s)

    def pump(self) -> int:
        """Time-based flush (call while idle to honour max_wait_s)."""
        return self.batcher.pump()

    def drain(self) -> int:
        """Launch every pending request now."""
        return self.batcher.drain()

    def output(self, tenant_id: str) -> np.ndarray:
        return self.sessions.get(tenant_id).output()

    # -- accounting --------------------------------------------------------

    @property
    def pool(self) -> EnginePool:
        return self.sessions.pool

    def stats(self) -> Dict:
        """Thin summary over the obs providers; `self.obs.snapshot()` is the
        full tree. `errors_total` is always 0 here: the sync driver
        surfaces launch errors to the caller instead of recording them."""
        st = {"tenants": len(self.sessions),
              "pending": self.batcher.pending(),
              "errors_total": 0,
              "pool": self.pool.stats(),
              "traffic": self.batcher.traffic_stats()}
        st.update(self.batcher.latency_stats())
        return st
