"""ServeRuntime / AsyncServeRuntime — multi-tenant streaming serving facades.

Port of `repro.serve.runtime`. Synchronous facade (the deterministic parity
surface):

    rt = ServeRuntime(BatchPolicy(max_batch=8, max_wait_s=2e-3))
    rt.open(TenantSpec("link-a", cfg, params=params_a))
    rt.submit("link-a", samples)        # arbitrary chunk sizes
    rt.pump()                           # honour max_wait while idle
    syms = rt.close("link-a")           # flush tail, return the stream

Threaded front-end (the production shape):

    with AsyncServeRuntime(BatchPolicy(max_batch=8)) as rt:
        rt.open(TenantSpec("link-a", cfg, params=params_a))
        fut = rt.submit("link-a", samples)   # returns a per-chunk future
        ...
        syms = rt.close("link-a")            # waits for in-flight launches

Every tenant's engine lives on the runtime's device (``device=``, default
"cuda"): each stacked launch copies its input to the card, runs one fused
kernel over all rows, and copies the symbols back. The streamed output is
bitwise equal to the offline engine on the whole waveform, in both
runtimes.

Why threads, not asyncio
------------------------
The device phase of a launch ends in a blocking device→host copy with no
awaitable completion hook. Under asyncio it would have to run in an
executor thread anyway, so the async runtime uses two plain daemon threads
and a `concurrent.futures.Future` per chunk:

  * a LAUNCHER thread owns the device: it pops assembled `LaunchBatch`es
    from a bounded queue, runs the fused kernel, and de-scatters results;
  * a TIMER thread fires the `max_wait_s` pump — time-based flushes no
    longer depend on the caller happening to call `pump()`.

`asyncio.wrap_future(rt.submit(...))` turns the per-chunk handle into an
awaitable.

Double buffering
----------------
`submit()` does the HOST half of the pipeline on the caller's thread: push
samples into the chunker, enqueue, check the batch policy, and — when a
group is ready — assemble the padded stacked input and per-row weight fn
(`MicroBatcher.take_ready`). The assembled batch is handed to the launcher
through a depth-bounded queue, so while launch k executes on the card the
caller/timer threads are already assembling launch k+1. The queue bound
(`queue_depth`, default 2 = one executing + one assembled-and-waiting) is
the double-buffer depth and doubles as backpressure: submit blocks rather
than letting assembly run unboundedly ahead of the device. A single FIFO
launcher thread preserves per-session emission order, so the chunked
stream stays bitwise equal to the offline engine.

CUDA streams
------------
PyTorch's current stream is per thread. The launcher thread makes one
`torch.cuda.Stream` on the runtime's device (`AsyncServeRuntime.stream`)
and enters it for its whole loop, so `MicroBatcher.execute`'s host→device
copy, kernel launch (the kernels launch on `torch.cuda.current_stream()`)
and device→host copy all queue there; the deadline watchdog's worker
thread enters the same stream for its attempt. Work the launch reads that
other threads queued on THEIR streams — the per-row weight stacks that
`assemble` builds on the caller's or timer's thread — is covered by the
event `assemble` records on that stream, which `execute` makes the
launcher's stream wait for (`LaunchBatch.ready`). Engine builds (at
`open`, on a pool miss, in failover and at a swap) end in blocking
host→device copies, so their weights are on the card before any launch
can be assembled from them. Tensors the launcher allocates stay on its
stream, and the blocking device→host copy that ends each execute means
no launch is still reading a batch's tensors when the batch is dropped.
With ``device="cpu"`` the same threads run with no CUDA stream.

Launch failures & recovery (serve/recovery.py)
----------------------------------------------
The launcher retries a failed batch in place up to `launch_retries` times,
with exponential backoff + seeded jitter, and — when `launch_deadline_s`
is set — a per-launch watchdog that abandons a hung device call. A failure
that survives the in-place retries enters bounded per-session FAILOVER:
each affected session's engine is dropped from the pool and rebuilt from
its `TenantSpec`, the lost chunks are re-assembled from their retained
`ChunkPlan` input snapshots and re-executed on the same engine path, and
the replayed output is bitwise equal to the uninterrupted stream. Only a
session that exhausts `RecoveryPolicy.max_session_recoveries` (or whose
rebuild keeps failing) is poisoned (`Session.failed`), so
`output()`/`close()` raise rather than return a stream with a hole.
Corrupted outputs (the output sentinel in `MicroBatcher.descatter`) take
the same replay path, optionally rolling the session's weights back to
`prev_spec` first. A `StragglerMonitor` over launch latencies can drive
graceful degradation — shrink `BatchPolicy.max_batch`, shed
lowest-priority tenants, restore when healthy (`degrade_on_slow=True`).

Serve-aware autotune lives in `_serve_tile`: tenants opened with
tile_m="auto", whose kernel tiles by it (`EqualizerEngine.tile_is_timed`),
after a tune-key's traffic histograms are warm (≥
`BatchPolicy.retune_after` launches) get `best_tile_m(probe_batch=mode
occupancy, probe_syms=median live width)` instead of the single-stream
default.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import queue
import random
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from ..core import autotune as autotune_lib
from ..core.engine import EqualizerEngine
from ..device import DeviceLike
from ..obs import Observability
from ..runtime.straggler import StragglerConfig
from .pool import EnginePool
from .recovery import (CorruptOutput, DegradationController, FaultPlan,
                       LaunchTimeout, RecoveryPolicy, RecoveryStats,
                       TenantShedError)
from .scheduler import BatchPolicy, LaunchBatch, MicroBatcher, Request
from .session import Session, SessionManager, TenantSpec

# sentinel that tells the launcher thread to exit (after the queue drains)
_SHUTDOWN = object()

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
    link:         optional `repro_torch.obs.LinkMonitor` — every tenant
                  opened on this runtime is attached for streaming
                  EVM/SNR/SER estimation (``link.<tenant>.*`` in the obs
                  registry).
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
                 link=None,
                 device: DeviceLike = "cuda"):
        self.obs = obs if obs is not None else Observability(clock=clock)
        self.link = link
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
        session = self.sessions.open(
            spec, tile_tuner=lambda e: _serve_tile(self.batcher, e))
        if self.link is not None:
            self.link.attach(session)
        return session

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


class AsyncServeRuntime:
    """Threaded serving front-end: same chunker, same policy, same
    stacked launches as `ServeRuntime` — driven by threads instead of the
    caller (see the module docstring for the design, CUDA streams
    included).

    policy:         `BatchPolicy` coalescing knobs. `max_wait_s` is
                    honoured by the built-in timer thread — no caller
                    pump() needed.
    max_engines:    LRU engine-pool bound (count; default 32).
    clock:          timestamp source (seconds; default time.perf_counter).
    queue_depth:    double-buffer depth — assembled launches allowed ahead
                    of the device (count; default 2 = one executing + one
                    waiting). submit() blocks when full (backpressure).
    launch_retries: in-place retries for a failed device launch before the
                    batch enters failover (count; default 2), with
                    exponential backoff + jitter between attempts
                    (`RecoveryPolicy.backoff_base_s`/`backoff_max_s`).
    launch_deadline_s: per-launch watchdog deadline (seconds; default None
                    = disabled). When set, a device call that exceeds it is
                    ABANDONED (`LaunchTimeout`, counted as a failed
                    attempt) instead of blocking the launcher forever.
                    Build the kernels first (a first launch builds its
                    CUDA source, tens of seconds, inside the call) or
                    warm up with the deadline off.
    recovery:       `RecoveryPolicy` failover bounds (default: the policy
                    defaults — failover ON, 4 rounds/session, output
                    sentinel at 1e4). Terminal failures beyond the bounds
                    fail the chunk futures, record the error in `errors`,
                    and poison the sessions involved.
    fault_plan:     optional `FaultPlan` chaos schedule, wired into the
                    batcher (launch faults) and engine pool (build
                    faults). Testing/benching hook; None in production.
    straggler:      `StragglerConfig` for the launch-latency monitor
                    (default: stock config — 3σ, patience 3, warmup 5).
    degrade_on_slow: opt-in graceful degradation (default False: the
                    monitor observes and reports, but never mutates the
                    batch policy or sheds tenants — silently rejecting
                    traffic is a policy decision). When True, persistent
                    slowness halves `BatchPolicy.max_batch` and sheds the
                    `shed_count` lowest-priority tenants (their submits
                    raise `TenantShedError`); both revert when healthy.
    obs:            optional `repro_torch.obs.Observability` hub (default:
                    a private hub with tracing OFF).
    link:           optional `repro_torch.obs.LinkMonitor`; every tenant
                    opened is attached (see `ServeRuntime`).
    device:         where every tenant's engine runs ("cuda" by default;
                    "cpu" runs the kernels' plain versions on the same
                    threads, with no CUDA stream).

    Thread-safety: `submit`/`finish`/`pump`/`drain`/`open`/`close`/
    `output`/`stats` may be called from any thread; per-TENANT calls must
    not race each other (one producer per stream — chunk order would
    otherwise be ambiguous anyway). Always `shutdown()` (or use as a
    context manager): abandoned runtimes leak two daemon threads until
    process exit.
    """

    ERRORS_MAX = 256                   # bounded error window (see stats())

    def __init__(self, policy: Optional[BatchPolicy] = None,
                 max_engines: int = 32,
                 clock: Callable[[], float] = time.perf_counter,
                 queue_depth: int = 2,
                 launch_retries: int = 2,
                 launch_deadline_s: Optional[float] = None,
                 recovery: Optional[RecoveryPolicy] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 straggler: Optional[StragglerConfig] = None,
                 degrade_on_slow: bool = False,
                 shed_count: int = 1,
                 obs: Optional[Observability] = None,
                 link=None,
                 device: DeviceLike = "cuda"):
        if queue_depth < 1:
            raise ValueError("queue_depth must be ≥ 1")
        self.obs = obs if obs is not None else Observability(clock=clock)
        # optional LinkMonitor — tenants auto-attach at open (see
        # ServeRuntime); the tap runs in descatter under _lock, and
        # LinkMonitor.observe is itself locked, so it is thread-safe here
        self.link = link
        self.sessions = SessionManager(
            max_engines=max_engines,
            swap_log_max=self.obs.retention.swap_log, device=device)
        self.device = self.sessions.device
        # the launcher's CUDA stream (None on the CPU): every launch, and
        # every watchdog attempt, queues its copies and kernel here
        self.stream: Optional[torch.cuda.Stream] = (
            torch.cuda.Stream(device=self.device)
            if self.device.type == "cuda" else None)
        self.batcher = MicroBatcher(policy, clock=clock, obs=self.obs)
        self.batcher.cross_stream = True   # assemble off, execute on stream
        self.launch_retries = launch_retries
        self.launch_deadline_s = launch_deadline_s
        self.recovery = recovery if recovery is not None else RecoveryPolicy()
        self.recovery_stats = RecoveryStats()
        self.fault_plan = fault_plan
        self.batcher.fault_plan = fault_plan
        self.batcher.sentinel_limit = self.recovery.sentinel_limit
        self.sessions.pool.fault_plan = fault_plan
        # seeded: backoff sleep sequences reproduce run-to-run
        self._backoff_rng = random.Random(0)
        self.degradation = DegradationController(
            self.batcher, self.sessions, cfg=straggler,
            shed_count=shed_count, mitigate=degrade_on_slow)
        self._launch_seq = 0           # launches observed by the monitor
        # bounded: a persistently failing stream must not grow host memory
        # without limit; `errors_total` keeps the failure RATE observable
        # after the window wraps. The bound comes from the retention policy
        # (default == ERRORS_MAX)
        self.errors: Deque[BaseException] = deque(
            maxlen=self.obs.retention.errors)
        self.errors_total = 0
        _wire_runtime_obs(self, self.obs)
        scope = self.obs.scope("serve")
        scope.callback("inflight", lambda: self._inflight)
        scope.callback("errors", lambda: {
            "total": self.errors_total,
            "window": len(self.errors),
            "dropped": self.errors_total - len(self.errors)})
        scope.callback("recovery", self.recovery_stats.as_dict)
        scope.callback("degradation", self.degradation.state)
        self._lock = threading.RLock()
        # serializes take→enqueue sequences: without it, thread A could
        # pop batch k under the lock, get preempted before the queue put,
        # and thread B (timer vs producer) could put batch k+1 first —
        # inverting the FIFO the per-session emission order relies on.
        # Ordering: _dispatch_mutex is always taken BEFORE _lock, and the
        # launcher thread never touches it, so a blocking put (queue full)
        # cannot deadlock against descatter.
        self._dispatch_mutex = threading.Lock()
        self._done = threading.Condition(self._lock)
        self._inflight = 0             # requests taken but not yet landed
        self._launch_q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        self._launcher = threading.Thread(
            target=self._launch_loop, name="serve-launcher", daemon=True)
        self._timer = threading.Thread(
            target=self._timer_loop, name="serve-pump-timer", daemon=True)
        self._launcher.start()
        self._timer.start()

    # -- lifecycle ---------------------------------------------------------

    def shutdown(self) -> None:
        """Stop the timer and launcher threads (idempotent). Pending
        batches already queued are still executed; pending requests that
        never assembled stay unlaunched — call `drain()` first for a clean
        flush."""
        if self._stop.is_set():
            return
        self._stop.set()
        self._timer.join()
        self._launch_q.put(_SHUTDOWN)
        self._launcher.join()

    def __enter__(self) -> "AsyncServeRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- tenant lifecycle --------------------------------------------------

    def open(self, spec: TenantSpec) -> Session:
        """Admit a tenant (see `ServeRuntime.open`). A serve-aware autotune
        sweep (cold cache + warm histograms) runs under the runtime lock —
        rare and bounded, but expect the first such open to pause other
        host-side progress for the sweep duration."""
        with self._lock:
            self._check_running()
            session = self.sessions.open(
                spec, tile_tuner=lambda e: _serve_tile(self.batcher, e))
            if self.link is not None:
                self.link.attach(session)
            return session

    def close(self, tenant_id: str) -> np.ndarray:
        """End a tenant's stream: flush the tail, launch ONLY this tenant's
        pending requests, WAIT for its in-flight launches to land, release
        the session, and return the full stream (bitwise-equal to the
        offline engine). Raises RuntimeError if a launch for this stream
        was lost (see `launch_retries`)."""
        with self._dispatch_mutex:
            with self._lock:
                self._check_running()
                s = self.sessions.get(tenant_id)
                if not s.chunker.finished:
                    s.chunker.finish()
                req = self.batcher.enqueue(s)
                if req is not None:
                    req.future = concurrent.futures.Future()
                batches = self._take(self.batcher.take_session(s))
            self._dispatch(batches)
        with self._done:
            while s.inflight > 0 and s.failed is None:
                self._done.wait(0.05)
            return self.sessions.close(tenant_id).output()

    # -- weight hot-swap ---------------------------------------------------

    def _swap_barrier(self, tenant_id: str, make_spec,
                      marker: str = "hot_swap") -> int:
        """Shared swap machinery: build the candidate engine OUTSIDE the
        locks (BN fold + weight quantization — serving must not stall
        behind them), then
        flush the tenant's pending requests, WAIT for its in-flight
        launches to land, and install — the barrier-and-install runs under
        `_dispatch_mutex`, so no producer/timer thread can plan new
        positions between the barrier and the install (the swap boundary
        stays exact). Holding the dispatch mutex while waiting is safe:
        the launcher thread lands batches under `_lock` only, and
        `_done.wait` releases `_lock`. Concurrent swaps of the SAME tenant
        are the caller's bug (one adapter per tenant); the epoch check
        below turns that race into a loud error instead of a corrupted
        swap_log."""
        with self._lock:
            self._check_running()
            s = self.sessions.get(tenant_id)
            new_spec = make_spec(s)            # cheap: dataclass replace
        candidate = new_spec.build_engine(self.device)   # NO locks held
        with self._dispatch_mutex:
            with self._lock:
                self._check_running()
                if s.spec.weight_epoch != new_spec.weight_epoch - 1:
                    raise RuntimeError(
                        f"tenant {tenant_id!r}: concurrent weight swap "
                        f"detected (epoch moved while building)")
                batches = self._take(self.batcher.take_session(s))
            self._dispatch(batches)
            with self._done:
                while s.inflight > 0 and s.failed is None:
                    self._done.wait(0.05)
                if s.failed is not None:
                    raise RuntimeError(
                        f"stream {tenant_id!r} lost a chunk to a failed "
                        f"launch; refusing to swap weights") from s.failed
                epoch = s.install_spec(new_spec, prebuilt=candidate)
                self.obs.tracer.instant(marker, tenant=tenant_id,
                                        epoch=epoch)
                return epoch

    def swap_weights(self, tenant_id: str, params=None, bn_state=None,
                     weights=None) -> int:
        """Hot-swap a live tenant's weights at a chunk boundary (see
        `ServeRuntime.swap_weights`). Thread-safe against concurrent
        submits: the swap holds the dispatch mutex while its barrier
        drains, so the epoch boundary in `Session.swap_log` is exact even
        with a producer racing the swap."""
        return self._swap_barrier(
            tenant_id, lambda s: _swap_spec(s, params, bn_state, weights))

    def rollback_weights(self, tenant_id: str) -> int:
        """Restore the pre-swap weights bit-identically under a new epoch
        (see `ServeRuntime.rollback_weights`)."""
        def mk(s: Session) -> TenantSpec:
            if s.prev_spec is None:
                raise RuntimeError(
                    f"tenant {tenant_id!r}: no previous weights")
            return dataclasses.replace(
                s.prev_spec, weight_epoch=s.spec.weight_epoch + 1)
        return self._swap_barrier(tenant_id, mk, marker="rollback")

    # -- streaming ---------------------------------------------------------

    def submit(self, tenant_id: str,
               samples) -> Optional[concurrent.futures.Future]:
        """Feed a chunk of waveform samples. Returns a per-chunk future
        resolving to this chunk's emitted symbols (np.ndarray) — or None
        when the samples were buffered without reaching an emittable
        position (they will ride in a later chunk's future). The future
        raises the terminal launch error if the chunk's batch was lost.
        Blocks only on backpressure (launch queue full). Raises
        `TenantShedError` while this tenant is load-shed by the
        degradation controller (`degrade_on_slow`) — shed tenants are
        readmitted automatically once launch health returns."""
        with self._dispatch_mutex:
            with self._lock:
                self._check_running()
                s = self.sessions.get(tenant_id)
                if s.shed:
                    raise TenantShedError(
                        f"tenant {tenant_id!r} is load-shed while the "
                        f"runtime is degraded; resubmit after recovery")
                s.chunker.push(np.asarray(samples))
                req = self.batcher.enqueue(s)
                if req is not None:
                    req.future = concurrent.futures.Future()
                batches = self._take(self.batcher.take_ready())
            self._dispatch(batches)
        return req.future if req is not None else None

    def finish(self, tenant_id: str) -> Optional[concurrent.futures.Future]:
        """End-of-stream marker: queue the zero-padded tail flush. Returns
        the tail chunk's future (None if the stream had no residue)."""
        with self._dispatch_mutex:
            with self._lock:
                self._check_running()
                s = self.sessions.get(tenant_id)
                if not s.chunker.finished:
                    s.chunker.finish()
                req = self.batcher.enqueue(s)
                if req is not None:
                    req.future = concurrent.futures.Future()
                batches = self._take(self.batcher.take_ready())
            self._dispatch(batches)
        return req.future if req is not None else None

    def pump(self) -> int:
        """Manual scheduling pass (normally unnecessary — the timer thread
        owns max_wait flushes). Returns launches SCHEDULED, not landed."""
        with self._dispatch_mutex:
            with self._lock:
                batches = self._take(self.batcher.take_ready())
            self._dispatch(batches)
        return len(batches)

    def drain(self) -> int:
        """Schedule every pending request and BLOCK until the pipeline is
        empty (all launches landed or terminally failed). Returns the
        number of launches scheduled by this call."""
        n = 0
        while True:
            with self._dispatch_mutex:
                with self._lock:
                    batches = self._take(
                        self.batcher.take_ready(force=True))
                self._dispatch(batches)
            if batches:
                n += len(batches)
                continue
            with self._done:
                while self._inflight > 0:
                    self._done.wait(0.05)
                if self.batcher.pending() == 0:
                    return n

    def output(self, tenant_id: str) -> np.ndarray:
        """Symbols emitted so far (stream order). NOT a barrier: in-flight
        launches land asynchronously — use the chunk futures, `drain()`, or
        `close()` for completion. Raises if the stream lost a chunk."""
        with self._lock:
            return self.sessions.get(tenant_id).output()

    # -- accounting --------------------------------------------------------

    @property
    def pool(self) -> EnginePool:
        return self.sessions.pool

    def stats(self) -> Dict:
        """Thin summary over the obs providers; `self.obs.snapshot()` is the
        full tree. `errors_total` (the key both runtimes share) and
        `errors` both report the lifetime count, as the reference's do."""
        with self._lock:
            st = {"tenants": len(self.sessions),
                  "pending": self.batcher.pending(),
                  "inflight": self._inflight,
                  "queue_depth": self._launch_q.maxsize,
                  "errors": self.errors_total,
                  "errors_total": self.errors_total,
                  "errors_dropped": self.errors_total - len(self.errors),
                  "pool": self.pool.stats(),
                  "traffic": self.batcher.traffic_stats(),
                  "recovery": self.recovery_stats.as_dict(),
                  "degradation": self.degradation.state()}
            st.update(self.batcher.latency_stats())
            return st

    # -- internals ---------------------------------------------------------

    def _check_running(self) -> None:
        if self._stop.is_set():
            raise RuntimeError("runtime is shut down")

    def _take(self, batches: List[LaunchBatch]) -> List[LaunchBatch]:
        """Account freshly assembled batches as in-flight (lock held)."""
        for b in batches:
            for r in b.reqs:
                r.session.inflight += 1
            self._inflight += len(b.reqs)
        return batches

    def _dispatch(self, batches: List[LaunchBatch]) -> None:
        """Hand assembled batches to the launcher thread. Blocking put on
        the depth-bounded queue = the backpressure/double-buffer bound.
        Always called holding `_dispatch_mutex` but NEVER `_lock` (the
        launcher needs the latter to land batches and free queue slots).
        If a put fails, the un-dispatched batches are un-accounted and
        requeued so drain()/close() cannot wait on work that will never
        execute."""
        for i, b in enumerate(batches):
            try:
                self._launch_q.put(b)
            except BaseException:
                with self._lock:
                    for rb in reversed(batches[i:]):
                        self.batcher.requeue(rb)
                        for r in rb.reqs:
                            r.session.inflight -= 1
                        self._inflight -= len(rb.reqs)
                    self._done.notify_all()
                raise

    def _timer_loop(self) -> None:
        """The event loop's clock: fire a pump pass on a max_wait_s-scaled
        cadence so time-based flushes don't depend on caller activity."""
        while not self._stop.is_set():
            wait = self.batcher.policy.max_wait_s
            self._stop.wait(min(max(wait / 4.0, 1e-3), 0.05))
            if self._stop.is_set():
                return
            try:
                with self._dispatch_mutex:
                    with self._lock:
                        batches = self._take(self.batcher.take_ready())
                    self._dispatch(batches)
            except Exception as e:  # noqa: BLE001 — keep the clock alive
                with self._lock:
                    self._record_error(e)

    def _record_error(self, e: BaseException) -> None:
        self.errors.append(e)          # bounded window (ERRORS_MAX)
        self.errors_total += 1

    def _launch_loop(self) -> None:
        """The device owner: execute each assembled batch (NO lock — this
        is the overlap window), then land it under the lock. A failed
        execute retries in place (backoff between attempts), then enters
        bounded failover (`_failover`); the launcher runs replays inline,
        preserving FIFO order and therefore per-session stream order. The
        whole loop runs on the runtime's CUDA stream."""
        with torch.cuda.stream(self.stream):
            while True:
                batch = self._launch_q.get()
                if batch is _SHUTDOWN:
                    self._launch_q.task_done()
                    return
                self._run_batch(batch)
                self._launch_q.task_done()

    def _run_batch(self, batch: LaunchBatch) -> None:
        """Drive one assembled batch to a terminal state: every request is
        descattered exactly once, or its future fails and its session is
        poisoned. Failover rounds replay the surviving requests through
        rebuilt engines until they land or exhaust their budget."""
        t_fail: Optional[float] = None
        round_idx = 0
        while True:
            y, err = self._try_execute(batch)
            if err is None:
                with self._lock:
                    try:
                        self.batcher.descatter(batch, y)
                        self._land_locked(batch)
                        if t_fail is not None:
                            self.recovery_stats.record_recovery(
                                self.batcher.clock() - t_fail)
                        return
                    except CorruptOutput as e:
                        # sentinel rejected the output BEFORE anything was
                        # emitted: batch state intact → quarantine + replay
                        self.recovery_stats.bump("corrupt_detected")
                        err = e
                    except Exception as e:  # noqa: BLE001 — launcher lives
                        # descatter failed MIDWAY: emission state ambiguous,
                        # replay could double-emit — poison, as before
                        self._record_error(e)
                        self.batcher.fail(batch, e)
                        self._land_locked(batch)
                        return
            if t_fail is None:
                t_fail = self.batcher.clock()
            batch = self._failover(batch, err)
            if batch is None:
                return                 # everything poisoned and landed
            time.sleep(self.recovery.backoff_s(round_idx, self._backoff_rng))
            round_idx += 1

    def _try_execute(self, batch: LaunchBatch):
        """In-place launch attempts: `launch_retries` retries with
        exponential backoff + jitter, each under the watchdog deadline.
        Returns (y, None) on success, (None, last error) when exhausted.
        Every attempt's latency feeds the straggler monitor (timeouts
        count at the deadline — the watchdog saw at least that much).
        Latencies come from the runtime's injectable clock (same source
        as the batcher timestamps), so fake-clock tests see deterministic
        values; failed attempts append a "retry" child event to each
        affected chunk's span."""
        clk = self.batcher.clock
        err: Optional[BaseException] = None
        for attempt in range(self.launch_retries + 1):
            if attempt:
                time.sleep(self.recovery.backoff_s(attempt - 1,
                                                   self._backoff_rng))
            t0 = clk()
            try:
                y = self._execute_deadline(batch)
            except Exception as e:  # noqa: BLE001 — retried/reported
                err = e
                dt = (self.launch_deadline_s
                      if isinstance(e, LaunchTimeout)
                      else clk() - t0)
                self._observe_launch(dt)
                if self.batcher.tracer.enabled:
                    t = clk()
                    for r in batch.reqs:
                        if r.plan.span is not None:
                            r.plan.span.event("retry", t, attempt=attempt,
                                              error=repr(e))
                continue
            self._observe_launch(clk() - t0)
            return y, None
        return None, err

    def _execute_deadline(self, batch: LaunchBatch) -> np.ndarray:
        """One device attempt, watchdog-bounded when `launch_deadline_s`
        is set: the blocking call runs on a daemon worker thread, on the
        runtime's CUDA stream (a new thread starts on the default stream);
        if it misses the deadline the worker is ABANDONED (it cannot be
        killed — a hung device call holds no Python-visible cancellation
        point) and `LaunchTimeout` is raised so the launcher stays live.
        The abandoned attempt's output, if it ever lands, is dropped on
        the floor — only the launcher thread descatters."""
        deadline = self.launch_deadline_s
        if deadline is None:
            return self.batcher.execute(batch)
        result: Dict[str, object] = {}
        done = threading.Event()

        def _worker() -> None:
            try:
                with torch.cuda.stream(self.stream):
                    result["y"] = self.batcher.execute(batch)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                result["e"] = e
            finally:
                done.set()

        t = threading.Thread(target=_worker, name="serve-watchdog-exec",
                             daemon=True)
        t.start()
        if not done.wait(deadline):
            self.recovery_stats.bump("deadline_timeouts")
            raise LaunchTimeout(
                f"launch exceeded deadline {deadline:g}s; "
                f"hung device call abandoned")
        if "e" in result:
            raise result["e"]          # type: ignore[misc]
        return result["y"]             # type: ignore[return-value]

    def _observe_launch(self, dt: float) -> None:
        """Feed one launch-attempt latency to the degradation controller
        (which needs the lock: it may shrink the policy / shed tenants)."""
        with self._lock:
            idx = self._launch_seq
            self._launch_seq += 1
            self.degradation.observe(idx, dt)

    def _land_locked(self, batch: LaunchBatch) -> None:
        """Account a batch's requests as no longer in flight (lock held)."""
        for r in batch.reqs:
            r.session.inflight -= 1
        self._inflight -= len(batch.reqs)
        self._done.notify_all()

    def _failover(self, batch: LaunchBatch,
                  err: BaseException) -> Optional[LaunchBatch]:
        """One bounded failover round for a terminally failed (or
        corrupted) batch. Requests whose session still has recovery budget
        get their engine rebuilt from its `TenantSpec` (pool drop + build:
        engines are disposable) and are re-assembled into a replay batch
        from their retained `ChunkPlan` input snapshots; the rest are
        poisoned. Returns the replay batch, or None when nothing survived
        (all landed).

        Bitwise safety: plans are input snapshots committed at enqueue,
        engine rebuilds are deterministic, and `assemble` recomputes the
        identical width bucket — so a replayed launch is the SAME stacked
        computation the failed one would have produced."""
        corrupt = isinstance(err, CorruptOutput)
        with self._lock:
            self._record_error(err)
            distinct = {id(r.session): r.session for r in batch.reqs}
            for s in distinct.values():
                s.recoveries += 1
            keep: List[Request] = []
            doomed: List[Request] = []
            for r in batch.reqs:
                s = r.session
                over = s.recoveries > self.recovery.max_session_recoveries
                (doomed if over or s.failed is not None else keep).append(r)
            self._poison_locked(doomed, err)
        if not keep:
            return None
        # engine rebuilds run OUTSIDE the lock: builds fold BN + quantize
        # and rebuild backoff sleeps — producers/timer must keep planning
        # meanwhile
        alive: Dict[int, bool] = {}
        build_err: Optional[BaseException] = None
        for s in {id(r.session): r.session for r in keep}.values():
            e = self._recover_session(s, corrupt)
            alive[id(s)] = e is None
            build_err = e or build_err
        good = [r for r in keep if alive[id(r.session)]]
        dead = [r for r in keep if not alive[id(r.session)]]
        with self._lock:
            if dead:
                self._poison_locked(dead, build_err or err)
            if not good:
                return None
            # re-assembly under the lock (fn cache is not thread-safe);
            # rebuilt engines have fresh ids → natural stacked-fn cache
            # miss → the replay binds the NEW engines' weights
            if self.batcher.tracer.enabled:
                t = self.batcher.clock()
                for r in good:
                    if r.plan.span is not None:
                        r.plan.span.event("replay", t,
                                          error=type(err).__name__)
            replay = self.batcher.assemble(batch.key, good)
            self.recovery_stats.bump("recoveries")
            self.recovery_stats.bump("chunks_replayed", len(good))
        return replay

    def _poison_locked(self, reqs: List[Request],
                       err: BaseException) -> None:
        """Terminal path for requests that exhausted (or never had) their
        recovery budget: fail futures, poison sessions, land (lock held).
        No-op on an empty list."""
        if not reqs:
            return
        newly = {id(r.session) for r in reqs if r.session.failed is None}
        self.batcher.fail_requests(reqs, err)
        self.recovery_stats.bump("sessions_poisoned", len(newly))
        for r in reqs:
            r.session.inflight -= 1
        self._inflight -= len(reqs)
        self._done.notify_all()

    def _recover_session(self, s: Session,
                         corrupt: bool) -> Optional[BaseException]:
        """Rebuild one session's engine for replay (no locks held).
        On a corrupt-output failover, first try the quarantine: roll
        the weights back to `prev_spec` bit-identically (at most once per
        session — `rolled_back` latches, so a corruption that survives
        the rollback cannot ping-pong between specs). Otherwise — or when
        there is nothing to roll back to — drop the pool entry and rebuild
        from the active spec, retrying `build_retries` times with backoff
        (an injected/real build failure is itself transient-retryable).
        Returns None on success, the last build error on failure."""
        if (corrupt and self.recovery.rollback_on_corrupt
                and s.prev_spec is not None and not s.rolled_back):
            try:
                prev = dataclasses.replace(
                    s.prev_spec, weight_epoch=s.spec.weight_epoch + 1)
                s.install_spec(prev)   # replaces the pool entry itself
                s.rolled_back = True
                self.recovery_stats.bump("rollbacks")
                self.recovery_stats.bump("engine_rebuilds")
                self.obs.tracer.instant(
                    "rollback", tenant=s.spec.tenant_id,
                    epoch=prev.weight_epoch, reason="corrupt_quarantine")
                return None
            except Exception:  # noqa: BLE001 — fall back to plain rebuild
                pass
        err: Optional[BaseException] = None
        self.pool.drop(s.spec.tenant_id)
        for attempt in range(self.recovery.build_retries + 1):
            if attempt:
                time.sleep(self.recovery.backoff_s(attempt - 1,
                                                   self._backoff_rng))
            try:
                s.engine               # pool miss → spec.build_engine()
                self.recovery_stats.bump("engine_rebuilds")
                return None
            except Exception as e:  # noqa: BLE001 — bounded retries
                err = e
        return err
