"""Fleet serving over a device mesh — device-loss failover with bitwise
stream migration.

The paper's flexibility story ends in deployment: the same equalizer spans
40 GBd optical links and low-power magnetic-recording heads, running as a
long-lived field receiver where a component loss must not kill the stream
(the real-time FPGA demonstrator line, arXiv 2402.15288). PR 6 made one
device survivable (contract #9: failover is bitwise-invisible); this module
extends that contract FLEET-wide — `AsyncServeRuntime`'s blast radius is
one device, a `FleetRuntime`'s is none, as long as one worker survives.

Architecture
------------
One `FleetWorker` per device: an unbounded launch queue, a dedicated
launcher thread, its own `EnginePool` + `MicroBatcher` (so stacked-group
state never crosses devices), a `RecoveryStats` ledger, and a
`StragglerMonitor` heartbeat fed by launch latencies. The `FleetRuntime`
controller owns placement, routing, health, and migration:

  * PLACEMENT — new tenants shard onto the least-loaded healthy worker
    (tenant count, then `TrafficStats` launch counts), with group-key
    affinity as the tie-break so tenants that can share a stacked launch
    land together. `worker_devices` picks the device set (cycling the
    host's cards when it has fewer cards than workers).
  * HEALTH — every launch attempt's latency feeds the worker's
    `StragglerMonitor` (slow workers latch `degraded`, visible in
    `stats()`); a `launch_deadline_s` watchdog turns hangs into failed
    attempts; `RecoveryPolicy.device_lost_after` consecutive TERMINAL
    failures — or an injected/real `DeviceLost` — declare the device gone.
  * MIGRATION — on worker death every resident session is rebuilt on a
    surviving worker from its `TenantSpec` + `StreamChunker.CarrySnapshot`
    (`Session.rebuild_on`), and every un-landed request — stranded
    launches, queued batches, never-assembled pending requests — replays
    there in per-session FIFO order. A `ChunkPlan` is a self-contained
    input snapshot committed at enqueue, engine rebuilds are
    deterministic, and a landed request's plan is consumed atomically
    (under `_state`) — so every chunk is emitted exactly once and the
    migrated stream is BITWISE-equal to offline (contract #10, placement
    invariance: #4 bitwise chunking × #5 batch-composition invariance ⇒
    the output cannot depend on which worker served which chunk). Only a
    session that exhausts `RecoveryPolicy.max_session_recoveries` is
    poisoned — the serving analogue of `repro_torch.runtime.fault`'s
    bounded restart budget (`run_with_restarts`), with migrations and
    same-worker failover rounds drawing from one budget.

Chaos testing is deterministic on the CPU (``devices=["cpu"]``) and on one
card (two workers cycling ``cuda:0``): `FaultPlan`'s `device_lost` /
`device_slow` kinds schedule per WORKER index (`Fault.at` = worker,
`Fault.after` = that worker's execute index), each firing at most once —
`tests/test_torch_fleet.py` and `chip_smoke.py` [15] kill a worker
mid-stream and assert the bitwise/exactly-once contract.

Locking (two levels, strictly ordered):
  * `_mutex` (RLock) — the control plane: serializes public API calls,
    the heartbeat tick, and migration. Never taken by launcher threads,
    so holding it while waiting on `_done` cannot deadlock a landing.
  * `_state` (Lock)  — the data plane, shared with launchers: batcher
    mutations, in-flight accounting, stranding, ledgers. `_done` is a
    Condition on it. Always acquired AFTER `_mutex`, never the reverse.

Worker queues are UNBOUNDED on purpose: a bounded queue whose launcher
died would block dispatch while the controller holds `_mutex` — a
deadlock. Memory stays bounded by the upstream producers (one chunk per
submit) and the heartbeat's migration sweep. A dead worker's launcher
stops taking batches: anything still routed to it stays in its queue,
where the migration sweep collects it under `_state`, so no request is
ever orphaned. (The reference keeps the dead launcher popping, as a
"strander" that appends each late batch to `stranded`; a batch popped
just before the sweep and appended just after it was never migrated, and
`drain()` waited for it forever. The port's sweep sees every un-landed
batch: the failing one in `stranded`, the rest in the queue.)

Port of `repro.serve.fleet`. `best_mesh` returns torch's own
`DeviceMesh` ("data", "model") over the ranks of an initialized
`torch.distributed` world (the port's parallel layer is SPMD, one process
a rank); its sizes come from the pure `mesh_shape`. On a card each
worker's launcher thread owns a `torch.cuda.Stream` on the worker's
device and enters it for its whole loop; the per-launch watchdog's
thread enters the same stream (streams are per thread), and the
device→host copy that ends each execute waits on it before descatter. Batches are assembled on the
controller's (or a producer's) thread, so every worker's batcher records
the assembly event that the launch waits for (`MicroBatcher.cross_stream`).
A migrated session is rebuilt on the TARGET worker's device
(`Session.rebuild_on(pool, device=…)`); its carry snapshot is host numpy,
so nothing else moves.
"""
from __future__ import annotations

import concurrent.futures
import queue
import random
import threading
import time
from collections import Counter, deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device
from ..obs import Observability
from ..runtime.straggler import StragglerConfig, StragglerMonitor
from .pool import EnginePool
from .recovery import (CorruptOutput, DeviceLost, FaultPlan, LaunchTimeout,
                       RecoveryPolicy, RecoveryStats)
from .runtime import _serve_tile
from .scheduler import BatchPolicy, LaunchBatch, MicroBatcher, Request
from .session import Session, TenantSpec

# sentinel telling a worker's launcher thread to exit
_SHUTDOWN = object()


# ---------------------------------------------------------------------------
# device-set selection
# ---------------------------------------------------------------------------

def worker_devices(n_workers: Optional[int] = None,
                   devices: Optional[List[DeviceLike]] = None
                   ) -> List[torch.device]:
    """The device set for an `n_workers`-worker fleet.

    Uses every CUDA card of the host (``torch.device("cuda", i)``; raises
    through `resolve_device` when there is none) or an explicit list
    (``devices=["cpu"]`` for the host's plain versions); when the fleet is
    wider than the set, devices are CYCLED, so every worker still owns a
    valid device handle and the threading/failover topology is exercised
    faithfully on one card (two workers on ``cuda:0``) or on the host."""
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
    else:
        resolve_device("cuda")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if not devs:
        raise RuntimeError("no devices available")
    if n_workers is None:
        n_workers = len(devs)
    if n_workers < 1:
        raise ValueError("n_workers must be ≥ 1")
    return [devs[i % len(devs)] for i in range(n_workers)]


def mesh_shape(n: int, model_parallel: int = 0) -> Tuple[int, int]:
    """(data, model) sizes of the largest mesh on ``n`` ranks: model
    parallelism is pinned by the checkpointed config (weights must still
    divide) and halves until it divides ``n``; the data dim absorbs the
    elasticity."""
    mp = model_parallel or 1
    while mp > 1 and n % mp:
        mp //= 2
    return n // mp, mp


def best_mesh(n_devices: Optional[int] = None, model_parallel: int = 0,
              ranks: Optional[List[int]] = None,
              device_type: Optional[str] = None):
    """Largest ("data", "model") `DeviceMesh` over the surviving ranks.

    Shared by elastic training restores (`repro_torch.runtime.elastic`,
    which re-exports it) and kept with the fleet's other device-set logic
    so there is ONE notion of "which devices do we have". ranks: the
    surviving ranks (default: the initialized world); the mesh takes the
    first dp·mp of them, (dp, mp) = `mesh_shape(n_devices, model_parallel)`.
    Every rank of the world calls it (the mesh's groups are made
    collectively); a rank outside the mesh gets its handle with no
    coordinate. The device type is "cuda" unless the caller asks for
    "cpu". Raises RuntimeError when there are no ranks and ValueError
    when n_devices lies outside [1, len(ranks)]."""
    from torch.distributed.device_mesh import DeviceMesh
    dev_type = resolve_device(device_type or "cuda").type
    if ranks is None:
        ranks = (list(range(dist.get_world_size()))
                 if dist.is_initialized() else [])
    ranks = list(ranks)
    if not ranks:
        raise RuntimeError("no ranks available (torch.distributed is not "
                           "initialized, or the rank list is empty)")
    n = n_devices or len(ranks)
    if not 1 <= n <= len(ranks):
        raise ValueError(f"n_devices={n} outside [1, {len(ranks)}]")
    dp, mp = mesh_shape(n, model_parallel)
    return DeviceMesh(dev_type, torch.tensor(ranks[:dp * mp]).reshape(dp, mp),
                      mesh_dim_names=("data", "model"))


# ---------------------------------------------------------------------------
# one worker = one device, one launcher, one pool, one batcher
# ---------------------------------------------------------------------------

class FleetWorker:
    """One device's serving executor (data plane only — placement, health
    verdicts, and migration live in `FleetRuntime`).

    The launcher thread pops assembled `LaunchBatch`es from the unbounded
    queue and drives each to a terminal state: landed (descattered under
    the fleet's `_state`), poisoned, or — on `DeviceLost` / too many
    consecutive terminal failures — STRANDED for migration. After death
    the thread pops nothing more: late-routed batches wait in the queue,
    and `FleetRuntime._absorb_dead_workers` collects them with the
    stranded one.
    """

    def __init__(self, idx: int, device: torch.device,
                 fleet: "FleetRuntime"):
        self.idx = idx
        self.device = device
        # the launcher's CUDA stream (None on the CPU): every launch, and
        # every watchdog attempt, queues its copies and kernel here
        self.stream: Optional[torch.cuda.Stream] = (
            torch.cuda.Stream(device=device)
            if device.type == "cuda" else None)
        self._fleet = fleet
        self.pool = EnginePool(fleet.max_engines)
        self.pool.fault_plan = fleet.fault_plan
        self.pool.clock = fleet.clock
        # per-worker metrics scope: instruments land under
        # fleet.worker<idx>.* in the shared registry (one hub fleet-wide,
        # so chunk spans survive migration between workers)
        self.batcher = MicroBatcher(fleet.policy, clock=fleet.clock,
                                    obs=fleet.obs,
                                    obs_scope=f"fleet.worker{idx}")
        self.batcher.cross_stream = True   # assemble off, execute on stream
        self.batcher.fault_plan = fleet.fault_plan
        self.batcher.sentinel_limit = fleet.recovery.sentinel_limit
        self.batcher.worker_index = idx
        self.stats = RecoveryStats()           # per-worker failover ledger
        self.monitor = StragglerMonitor(fleet.straggler
                                        or StragglerConfig())
        scope = fleet.obs.scope(f"fleet.worker{idx}")
        h_build = scope.histogram("pool.build_s")

        def _on_build(key, dt: float) -> None:
            h_build.observe(dt)
            fleet.obs.tracer.instant("engine_build", worker=idx,
                                     tenant=str(key), build_s=dt)

        self.pool.build_hook = _on_build
        scope.callback("pool", self.pool.stats)
        scope.callback("alive", lambda: self.device_lost is None)
        scope.callback("recovery", self.stats.as_dict)
        scope.callback("health", self.monitor.summary)
        self.tenants: set = set()
        self.groups: Counter = Counter()       # placement-key → residents
        self.q: "queue.Queue" = queue.Queue()  # unbounded (see module doc)
        self.stranded: List[LaunchBatch] = []  # un-landed work of a dead
        self.device_lost: Optional[BaseException] = None
        self.absorbed = False                  # migration sweep ran
        self.died_at = 0.0
        self.consecutive_failures = 0
        self.launch_seq = 0                    # monitor step counter
        self._rng = random.Random(1000 + idx)  # per-worker backoff jitter
        self._thread = threading.Thread(
            target=self._loop, name=f"fleet-worker-{idx}", daemon=True)
        self._thread.start()

    # -- launcher thread ---------------------------------------------------

    def _loop(self) -> None:
        """The worker's launcher: the whole loop runs on its stream. Only
        this thread sets `device_lost` (`_die`), so once it is set no
        batch is popped again: the dead worker's queue is left whole to
        the migration sweep."""
        fleet = self._fleet
        with torch.cuda.stream(self.stream):
            while self.device_lost is None:
                batch = self.q.get()
                if batch is _SHUTDOWN:
                    return
                try:
                    self._run_batch(batch)
                except Exception as e:  # noqa: BLE001 — launcher survives
                    with fleet._state:
                        fleet._record_error_locked(e)
        fleet._stop.wait()             # dead: idle until shutdown

    def _run_batch(self, batch: LaunchBatch) -> None:
        """Drive one batch to a terminal state (mirrors
        `AsyncServeRuntime._run_batch`, plus the device-death verdicts)."""
        fleet = self._fleet
        t_fail: Optional[float] = None
        round_idx = 0
        while True:
            y, err = self._try_execute(batch)
            if err is None:
                with fleet._state:
                    try:
                        self.batcher.descatter(batch, y)
                        self.consecutive_failures = 0
                        fleet._land_locked(batch)
                        if t_fail is not None:
                            self.stats.record_recovery(
                                self.batcher.clock() - t_fail)
                        return
                    except CorruptOutput as e:
                        # sentinel rejected BEFORE anything was emitted:
                        # batch intact → quarantine + failover replay
                        self.stats.bump("corrupt_detected")
                        err = e
                    except Exception as e:  # noqa: BLE001
                        # descatter failed MIDWAY: emission ambiguous,
                        # replay could double-emit — poison, as in PR 6
                        fleet._record_error_locked(e)
                        self.batcher.fail(batch, e)
                        fleet._land_locked(batch)
                        return
            if isinstance(err, DeviceLost):
                self._die(err, batch)
                return
            if t_fail is None:
                t_fail = self.batcher.clock()
            with fleet._state:
                self.consecutive_failures += 1
                after = self._fleet.recovery.device_lost_after
                lost = (after is not None
                        and self.consecutive_failures >= after)
            if lost:
                self._die(DeviceLost(
                    f"worker {self.idx}: {self.consecutive_failures} "
                    f"consecutive terminal launch failures "
                    f"(last: {err!r})"), batch)
                return
            batch = self._failover(batch, err)
            if batch is None:
                return                 # everything poisoned and landed
            time.sleep(fleet.recovery.backoff_s(round_idx, self._rng))
            round_idx += 1

    def _try_execute(self, batch: LaunchBatch):
        """In-place launch attempts with backoff + watchdog; every
        attempt's latency feeds this worker's health monitor. Returns
        (y, None) on success, (None, last error) when exhausted —
        `DeviceLost` short-circuits (retrying a dead device is pointless
        and would delay migration). Latencies come from the fleet's
        injectable `clock` (NOT wall time), so fleet latency tests can
        freeze or script the timeline; failed attempts append a "retry"
        child event to each affected chunk's span."""
        fleet = self._fleet
        clk = fleet.clock
        err: Optional[BaseException] = None
        for attempt in range(fleet.launch_retries + 1):
            if attempt:
                time.sleep(fleet.recovery.backoff_s(attempt - 1, self._rng))
            t0 = clk()
            try:
                y = self._execute_deadline(batch)
            except DeviceLost as e:
                self._observe(clk() - t0)
                return None, e
            except Exception as e:  # noqa: BLE001 — retried/reported
                err = e
                dt = (fleet.launch_deadline_s
                      if isinstance(e, LaunchTimeout)
                      else clk() - t0)
                self._observe(dt)
                if self.batcher.tracer.enabled:
                    t = clk()
                    for r in batch.reqs:
                        if r.plan.span is not None:
                            r.plan.span.event("retry", t, worker=self.idx,
                                              attempt=attempt,
                                              error=repr(e))
                continue
            self._observe(clk() - t0)
            return y, None
        return None, err

    def _execute_deadline(self, batch: LaunchBatch) -> np.ndarray:
        """One device attempt, watchdog-bounded when the fleet sets
        `launch_deadline_s` (same abandon-the-hung-call semantics as
        `AsyncServeRuntime._execute_deadline`; the watchdog's thread
        enters the worker's stream)."""
        deadline = self._fleet.launch_deadline_s
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

        t = threading.Thread(target=_worker,
                             name=f"fleet-watchdog-{self.idx}", daemon=True)
        t.start()
        if not done.wait(deadline):
            self.stats.bump("deadline_timeouts")
            raise LaunchTimeout(
                f"worker {self.idx}: launch exceeded deadline "
                f"{deadline:g}s; hung device call abandoned")
        if "e" in result:
            raise result["e"]          # type: ignore[misc]
        return result["y"]             # type: ignore[return-value]

    def _observe(self, dt: float) -> None:
        """Feed one launch-attempt latency to this worker's heartbeat
        monitor (under `_state`: `stats()` reads the summary there)."""
        with self._fleet._state:
            self.monitor.observe(self.launch_seq, dt)
            self.launch_seq += 1

    def _failover(self, batch: LaunchBatch,
                  err: BaseException) -> Optional[LaunchBatch]:
        """Same-worker failover round (the device still answers, one
        launch keeps failing): budget-partition the batch, rebuild the
        surviving sessions' engines in THIS worker's pool, re-assemble a
        replay. Port of `AsyncServeRuntime._failover` against the fleet's
        locks and per-worker ledger (no corrupt-rollback here — weight
        hot-swap is an `AsyncServeRuntime` feature)."""
        fleet = self._fleet
        with fleet._state:
            fleet._record_error_locked(err)
            for s in {id(r.session): r.session for r in batch.reqs}.values():
                s.recoveries += 1
            keep: List[Request] = []
            doomed: List[Request] = []
            for r in batch.reqs:
                over = (r.session.recoveries
                        > fleet.recovery.max_session_recoveries)
                (doomed if over or r.session.failed is not None
                 else keep).append(r)
            fleet._poison_locked(self, doomed, err)
        if not keep:
            return None
        alive: Dict[int, bool] = {}
        build_err: Optional[BaseException] = None
        for s in {id(r.session): r.session for r in keep}.values():
            e = self._rebuild_engine(s)
            alive[id(s)] = e is None
            build_err = e or build_err
        good = [r for r in keep if alive[id(r.session)]]
        dead = [r for r in keep if not alive[id(r.session)]]
        with fleet._state:
            if dead:
                fleet._poison_locked(self, dead, build_err or err)
            if not good:
                return None
            if self.batcher.tracer.enabled:
                t = fleet.clock()
                for r in good:
                    if r.plan.span is not None:
                        r.plan.span.event("replay", t, worker=self.idx,
                                          error=type(err).__name__)
            replay = self.batcher.assemble(batch.key, good)
            self.stats.bump("recoveries")
            self.stats.bump("chunks_replayed", len(good))
        return replay

    def _rebuild_engine(self, s: Session) -> Optional[BaseException]:
        """Drop + rebuild one session's engine in this worker's pool
        (bounded by `RecoveryPolicy.build_retries`, no locks held)."""
        err: Optional[BaseException] = None
        self.pool.drop(s.spec.tenant_id)
        for attempt in range(self._fleet.recovery.build_retries + 1):
            if attempt:
                time.sleep(self._fleet.recovery.backoff_s(attempt - 1,
                                                          self._rng))
            try:
                s.engine               # pool miss → spec.build_engine()
                self.stats.bump("engine_rebuilds")
                return None
            except Exception as e:  # noqa: BLE001 — bounded retries
                err = e
        return err

    # -- death -------------------------------------------------------------

    def _die(self, err: BaseException,
             batch: Optional[LaunchBatch]) -> None:
        """Mark this worker's device lost and strand the failing batch
        (called on the launcher thread only). The launcher then pops
        nothing more; the controller's next sweep
        (`_absorb_dead_workers`) migrates everything."""
        fleet = self._fleet
        with fleet._state:
            if self.device_lost is None:
                self.device_lost = err
                self.died_at = self.batcher.clock()
                self.stats.bump("device_losses")
                fleet._record_error_locked(err)
                fleet.obs.tracer.instant("device_lost", worker=self.idx,
                                         error=repr(err))
            if batch is not None:
                self.stranded.append(batch)
            fleet._done.notify_all()


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

class FleetRuntime:
    """Multi-device serving controller: N `FleetWorker`s, shard-by-tenant
    placement, health monitoring, and bitwise device-loss failover (see
    module docstring for the architecture and locking discipline).

    n_workers:      fleet width (count; default 2). Devices come from
                    `worker_devices(n_workers, devices)` — the host's
                    cards are cycled when it has fewer than n_workers.
    policy:         `BatchPolicy` coalescing knobs, applied PER WORKER
                    (each worker owns a `MicroBatcher`).
    max_engines:    LRU engine-pool bound PER WORKER (count; default 32).
    clock:          timestamp source (seconds; default perf_counter).
    launch_retries: in-place retries per failed launch before a terminal
                    verdict (count; default 2).
    launch_deadline_s: per-launch watchdog (seconds; default None =
                    disabled — a first launch builds its CUDA source,
                    tens of seconds: build the kernels first, or leave
                    it None).
    recovery:       `RecoveryPolicy` budgets. Default: the stock policy
                    with `device_lost_after=2` — two consecutive terminal
                    failures on one worker declare its device lost.
                    Migration rounds and same-worker failover rounds draw
                    from the same `max_session_recoveries` budget.
    fault_plan:     optional `FaultPlan` — launch/build kinds hit
                    whichever worker's batcher/pool reaches the scheduled
                    index; `device_lost`/`device_slow` target a worker by
                    index. Testing/benching hook; None in production.
    straggler:      `StragglerConfig` for the per-worker launch-latency
                    heartbeat monitors (default: stock config).
    devices:        explicit device list (default: every CUDA card;
                    ``["cpu"]`` runs the kernels' plain versions).
    obs:            optional `repro_torch.obs.Observability` hub shared
                    fleet-wide (per-worker metrics under
                    `fleet.worker<i>.*`; chunk spans survive migration
                    because every worker stamps into the same tracer).
                    Default None = private hub, tracing off.
    link:           optional `repro_torch.obs.LinkMonitor` — every tenant
                    opened on the fleet is auto-attached for streaming
                    EVM/SNR/SER estimation; pair with `attach_slo` to fold
                    quality breaches into worker health.

    Thread-safety: public methods may be called from any thread; per-
    tenant calls must not race each other (one producer per stream).
    Always `shutdown()` (or use as a context manager).
    """

    ERRORS_MAX = 256        # legacy default; Retention.errors governs now

    def __init__(self, n_workers: int = 2,
                 policy: Optional[BatchPolicy] = None,
                 max_engines: int = 32,
                 clock: Callable[[], float] = time.perf_counter,
                 launch_retries: int = 2,
                 launch_deadline_s: Optional[float] = None,
                 recovery: Optional[RecoveryPolicy] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 straggler: Optional[StragglerConfig] = None,
                 devices: Optional[List[DeviceLike]] = None,
                 obs: Optional[Observability] = None,
                 link=None):
        self.policy = policy or BatchPolicy()
        self.max_engines = max_engines
        self.clock = clock
        self.obs = obs if obs is not None else Observability(clock=clock)
        self.link = link
        self._slo = None               # SloEngine, via attach_slo()
        self.launch_retries = launch_retries
        self.launch_deadline_s = launch_deadline_s
        self.recovery = (recovery if recovery is not None
                         else RecoveryPolicy(device_lost_after=2))
        self.fault_plan = fault_plan
        self.straggler = straggler
        self._mutex = threading.RLock()        # control plane (see module)
        self._state = threading.Lock()         # data plane, launcher-shared
        self._done = threading.Condition(self._state)
        self._sessions: Dict[str, Session] = {}
        self._homes: Dict[str, FleetWorker] = {}
        self._placekeys: Dict[str, Tuple] = {}  # tid → key used at open
        self._inflight = 0
        self._migrations = 0                   # dead workers absorbed
        self.errors: "Deque[BaseException]" = deque(
            maxlen=self.obs.retention.errors)
        self.errors_total = 0
        self._stop = threading.Event()
        self.workers = [FleetWorker(i, d, self)
                        for i, d in enumerate(
                            worker_devices(n_workers, devices))]
        scope = self.obs.scope("fleet")
        scope.callback("tenants", lambda: len(self._sessions))
        scope.callback("inflight", lambda: self._inflight)
        scope.callback("migrations", lambda: self._migrations)
        scope.callback("placement", lambda: {
            tid: w.idx for tid, w in self._homes.items()})
        scope.callback("errors", lambda: {
            "total": self.errors_total,
            "window": len(self.errors),
            "dropped": self.errors_total - len(self.errors)})
        scope.callback("recovery", lambda: {
            f: sum(getattr(w.stats, f) for w in self.workers)
            for f in RecoveryStats.FIELDS})
        self._hb = threading.Thread(target=self._heartbeat_loop,
                                    name="fleet-heartbeat", daemon=True)
        self._hb.start()

    # -- lifecycle ---------------------------------------------------------

    def shutdown(self) -> None:
        """Stop the heartbeat and every worker launcher (idempotent).
        Queued batches still execute; call `drain()` first for a clean
        flush."""
        if self._stop.is_set():
            return
        self._stop.set()
        self._hb.join()
        for w in self.workers:
            w.q.put(_SHUTDOWN)
        for w in self.workers:
            w._thread.join()

    def __enter__(self) -> "FleetRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def _check_running(self) -> None:
        if self._stop.is_set():
            raise RuntimeError("fleet is shut down")

    # -- tenant lifecycle --------------------------------------------------

    def open(self, spec: TenantSpec) -> Session:
        """Admit a tenant: place it on the least-loaded healthy worker
        (group-key affinity as tie-break), build its engine in that
        worker's pool. Raises ValueError on a duplicate tenant_id,
        RuntimeError when no healthy worker remains."""
        with self._mutex:
            self._check_running()
            self._absorb_dead_workers()
            if spec.tenant_id in self._sessions:
                raise ValueError(f"tenant {spec.tenant_id!r} already open")
            key = self._spec_key(spec)
            w = self._place(key)
            s = Session(spec, w.pool,
                        tile_tuner=lambda e: _serve_tile(w.batcher, e),
                        device=w.device)
            with self._state:
                self._sessions[spec.tenant_id] = s
                self._homes[spec.tenant_id] = w
                self._placekeys[spec.tenant_id] = key
                w.tenants.add(spec.tenant_id)
                w.groups[key] += 1
            if self.link is not None:
                self.link.attach(s)
            return s

    def close(self, tenant_id: str) -> np.ndarray:
        """End a tenant's stream: flush the tail, wait for its in-flight
        work (surviving any migration mid-wait — the session object may
        be REPLACED by a rebuild), release it, return the full stream.
        Raises RuntimeError if the stream was poisoned."""
        with self._mutex:
            self._check_running()
            self._absorb_dead_workers()
            if tenant_id not in self._sessions:
                raise KeyError(f"tenant {tenant_id!r} not open")
            with self._state:
                s = self._sessions[tenant_id]
                w = self._homes[tenant_id]
                if not s.chunker.finished:
                    s.chunker.finish()
                req = self.batcher_enqueue(w, s)
                self._dispatch_locked(w, w.batcher.take_session(s))
            while True:
                self._absorb_dead_workers()
                s = self._sessions[tenant_id]   # migration may replace it
                with self._done:
                    if s.failed is not None or s.inflight == 0:
                        break
                    self._done.wait(0.05)
            with self._state:
                s = self._sessions.pop(tenant_id)
                w = self._homes.pop(tenant_id)
                key = self._placekeys.pop(tenant_id)
                w.tenants.discard(tenant_id)
                w.groups[key] -= 1
            w.pool.drop(tenant_id)
            return s.output()

    # -- streaming ---------------------------------------------------------

    def submit(self, tenant_id: str,
               samples) -> Optional[concurrent.futures.Future]:
        """Feed a chunk of waveform samples; routed to the tenant's home
        worker. Returns a per-chunk future (None while buffering below an
        emittable position). Never blocks on a worker — queues are
        unbounded and a dead worker's traffic waits in its queue for
        migration."""
        with self._mutex:
            self._check_running()
            self._absorb_dead_workers()
            if tenant_id not in self._sessions:
                raise KeyError(f"tenant {tenant_id!r} not open")
            with self._state:
                s = self._sessions[tenant_id]
                w = self._homes[tenant_id]
                s.chunker.push(np.asarray(samples))
                req = self.batcher_enqueue(w, s)
                self._dispatch_locked(w, w.batcher.take_ready())
        return req.future if req is not None else None

    def finish(self, tenant_id: str) -> Optional[concurrent.futures.Future]:
        """End-of-stream marker: queue the zero-padded tail flush."""
        with self._mutex:
            self._check_running()
            self._absorb_dead_workers()
            if tenant_id not in self._sessions:
                raise KeyError(f"tenant {tenant_id!r} not open")
            with self._state:
                s = self._sessions[tenant_id]
                w = self._homes[tenant_id]
                if not s.chunker.finished:
                    s.chunker.finish()
                req = self.batcher_enqueue(w, s)
                self._dispatch_locked(w, w.batcher.take_ready())
        return req.future if req is not None else None

    def pump(self) -> int:
        """Manual scheduling pass over every healthy worker (normally the
        heartbeat's job). Returns launches scheduled."""
        with self._mutex:
            self._check_running()
            self._absorb_dead_workers()
            n = 0
            for w in self._healthy():
                with self._state:
                    batches = w.batcher.take_ready()
                    self._dispatch_locked(w, batches)
                n += len(batches)
            return n

    def drain(self) -> int:
        """Schedule every pending request and block until the fleet is
        empty — all launches landed, terminally failed, or migrated and
        landed elsewhere. Returns launches scheduled by this call."""
        n = 0
        while True:
            with self._mutex:
                self._check_running()
                self._absorb_dead_workers()
                sched = 0
                for w in self._healthy():
                    with self._state:
                        batches = w.batcher.take_ready(force=True)
                        self._dispatch_locked(w, batches)
                    sched += len(batches)
                n += sched
                if sched:
                    continue
                with self._done:
                    if (self._inflight == 0
                            and all(w.batcher.pending() == 0
                                    for w in self.workers)
                            and not any(w.device_lost is not None
                                        and not w.absorbed
                                        for w in self.workers)):
                        return n
                    self._done.wait(0.05)

    def output(self, tenant_id: str) -> np.ndarray:
        """Symbols emitted so far (stream order). NOT a barrier — use
        futures, `drain()`, or `close()`. Raises if the stream was
        poisoned."""
        with self._state:
            return self._sessions[tenant_id].output()

    @property
    def sessions(self) -> Dict[str, Session]:
        """Live sessions by tenant id (snapshot) — the same lookup shape
        `ServeRuntime.sessions` offers, so layers that need a session
        (the net ingress trace push, adapters) work against a fleet too."""
        with self._state:
            return dict(self._sessions)

    def attach_slo(self, slo) -> None:
        """Fold an `SloEngine`'s per-tenant quality verdicts into fleet
        health: `stats()` workers gain a `slo_breached` tenant list (next
        to the launch-latency straggler verdict) and the registry a
        `fleet.slo_breached` placement callback, so a worker serving
        quality-degraded tenants is visible fleet-wide."""
        self._slo = slo
        self.obs.scope("fleet").callback(
            "slo_breached", lambda: {
                tid: w.idx for tid, w in self._homes.items()
                if tid in set(self._slo.breached_tenants())})

    # -- accounting --------------------------------------------------------

    def stats(self) -> Dict:
        """Fleet snapshot: a per-worker block (aliveness, tenants, the
        `RecoveryStats` migration/failover ledger, straggler health,
        traffic, pool) plus fleet-wide placement and aggregate ledger.

        Legacy wrapper — the registry snapshot (`self.obs.snapshot()`)
        is the normalized superset; see docs/OBSERVABILITY.md for the
        key map. `errors` counts every error ever recorded (lifetime
        total, NOT the bounded deque length); `errors_total` is the
        schema-normalized alias shared with `AsyncServeRuntime`.
        With an `attach_slo`'d engine, each worker also lists its
        resident tenants holding a latched SLO breach (`slo_breached`) —
        quality degradation sits next to the straggler verdict."""
        breached = (set(self._slo.breached_tenants())
                    if self._slo is not None else set())
        with self._state:
            workers = []
            for w in self.workers:
                workers.append({
                    "worker": w.idx,
                    "device": str(w.device),
                    "alive": w.device_lost is None,
                    "reason": (repr(w.device_lost)
                               if w.device_lost is not None else None),
                    "tenants": sorted(w.tenants),
                    "consecutive_failures": w.consecutive_failures,
                    "recovery": w.stats.as_dict(),
                    "health": w.monitor.summary(),
                    "slo_breached": sorted(w.tenants & breached),
                    "traffic": w.batcher.traffic_stats(),
                    "pool": w.pool.stats(),
                    "pending": w.batcher.pending(),
                })
            agg = {f: sum(getattr(w.stats, f) for w in self.workers)
                   for f in RecoveryStats.FIELDS}
            return {"workers": workers,
                    "recovery": agg,
                    "tenants": len(self._sessions),
                    "placement": {tid: w.idx
                                  for tid, w in self._homes.items()},
                    "inflight": self._inflight,
                    "migrations": self._migrations,
                    "errors": self.errors_total,
                    "errors_total": self.errors_total}

    # -- internals: dispatch -----------------------------------------------

    @staticmethod
    def batcher_enqueue(w: FleetWorker,
                        s: Session) -> Optional[Request]:
        """Enqueue a session's next plan on its home worker, future
        attached (`_state` held by the caller)."""
        req = w.batcher.enqueue(s)
        if req is not None:
            req.future = concurrent.futures.Future()
        return req

    def _dispatch_locked(self, w: FleetWorker,
                         batches: List[LaunchBatch]) -> None:
        """Account batches in-flight and hand them to the worker's
        launcher (`_state` held; unbounded put never blocks)."""
        for b in batches:
            for r in b.reqs:
                r.session.inflight += 1
            self._inflight += len(b.reqs)
            w.q.put(b)

    def _record_error_locked(self, e: BaseException) -> None:
        self.errors.append(e)
        self.errors_total += 1

    def _land_locked(self, batch: LaunchBatch) -> None:
        for r in batch.reqs:
            r.session.inflight -= 1
        self._inflight -= len(batch.reqs)
        self._done.notify_all()

    def _poison_locked(self, w: FleetWorker, reqs: List[Request],
                       err: BaseException) -> None:
        """Terminal path for over-budget requests: fail futures, poison
        sessions, land, ledger on the verdict-issuing worker (`_state`
        held)."""
        if not reqs:
            return
        newly = {id(r.session) for r in reqs if r.session.failed is None}
        w.batcher.fail_requests(reqs, err)
        w.stats.bump("sessions_poisoned", len(newly))
        for r in reqs:
            r.session.inflight -= 1
        self._inflight -= len(reqs)
        self._done.notify_all()

    # -- internals: placement ----------------------------------------------

    @staticmethod
    def _spec_key(spec: TenantSpec) -> Tuple:
        """Spec-derivable placement shard key — the group-key fields known
        BEFORE an engine is built (the true `group_key()` needs the built
        engine's resolved tile). Specs that would share a stacked launch
        share this key, so affinity placement keeps them co-resident."""
        return (spec.cfg, spec.backend, spec.tile_m, spec.formats)

    def _healthy(self) -> List[FleetWorker]:
        return [w for w in self.workers if w.device_lost is None]

    def _place(self, key: Tuple) -> FleetWorker:
        """Least-loaded healthy worker (tenant count, then recorded
        launches — the `TrafficStats`-driven rebalance), preferring a
        worker already hosting this placement key among equals."""
        healthy = self._healthy()
        if not healthy:
            raise RuntimeError("fleet has no healthy workers left")
        with self._state:
            loads = {w.idx: (len(w.tenants),
                             0 if w.groups.get(key, 0) > 0 else 1,
                             sum(ts.launches
                                 for ts in w.batcher.traffic.values()),
                             w.idx)
                     for w in healthy}
        return min(healthy, key=lambda w: loads[w.idx])

    # -- internals: heartbeat + migration ----------------------------------

    def _heartbeat_loop(self) -> None:
        """The fleet's clock: pump time-based flushes on every healthy
        worker and sweep for dead workers needing migration."""
        while not self._stop.is_set():
            wait = self.policy.max_wait_s
            self._stop.wait(min(max(wait / 4.0, 1e-3), 0.05))
            if self._stop.is_set():
                return
            try:
                with self._mutex:
                    if self._stop.is_set():
                        return
                    self._absorb_dead_workers()
                    for w in self._healthy():
                        with self._state:
                            self._dispatch_locked(
                                w, w.batcher.take_ready())
            except Exception as e:  # noqa: BLE001 — keep the clock alive
                with self._state:
                    self._record_error_locked(e)

    def _absorb_dead_workers(self) -> None:
        """Migrate every dead, not-yet-absorbed worker (`_mutex` held)."""
        for w in self.workers:
            if w.device_lost is not None and not w.absorbed:
                self._migrate_worker(w)

    def _migrate_worker(self, dead: FleetWorker) -> None:
        """Rehome a dead worker's sessions and replay its un-landed work.

        Collection (under `_state`) gathers, in per-session FIFO order:
        the stranded batch (the failing launch), still-queued batches
        (the dead launcher pops none after its death), and never-assembled
        pending requests. Each session is rebuilt on a surviving worker
        from spec + carry snapshot (`Session.rebuild_on`), its requests
        re-pointed and adopted into the target's batcher, and re-launched
        via `take_session` — same plans, deterministic rebuild, identical
        width buckets, so the migrated stream is bitwise-equal to offline
        (contract #10) and every chunk lands exactly once. Sessions over
        their `RecoveryPolicy` budget (or unrebuildable, or with no
        healthy worker left) are poisoned."""
        err = dead.device_lost
        with self._state:
            batches = list(dead.stranded)
            dead.stranded.clear()
            while True:
                try:
                    b = dead.q.get_nowait()
                except queue.Empty:
                    break
                batches.append(b)
            stranded_by: Dict[str, List[Request]] = {}
            for b in batches:
                for r in b.reqs:
                    stranded_by.setdefault(
                        r.session.spec.tenant_id, []).append(r)
            pending_by: Dict[str, List[Request]] = {}
            for r in dead.batcher.evict_all():
                pending_by.setdefault(
                    r.session.spec.tenant_id, []).append(r)
            tids = sorted(set(dead.tenants)
                          | set(stranded_by) | set(pending_by))
            dead.absorbed = True
            self._migrations += 1
        dead.pool.clear()              # the dead device's engines are junk
        for tid in tids:
            stranded = stranded_by.get(tid, [])
            pending = pending_by.get(tid, [])
            old = self._sessions[tid]
            if old.failed is not None:
                self._drop_migrating(dead, old, stranded, pending,
                                     old.failed)
                continue
            old.recoveries += 1
            if old.recoveries > self.recovery.max_session_recoveries:
                self._drop_migrating(dead, old, stranded, pending, err)
                continue
            try:
                target = self._place(self._placekeys[tid])
            except RuntimeError as e:   # no healthy workers left
                self._drop_migrating(dead, old, stranded, pending, e)
                continue
            new_s, berr = self._rebuild_on(old, target)
            if new_s is None:
                self._drop_migrating(dead, old, stranded, pending,
                                     berr or err)
                continue
            with self._state:
                key = self._placekeys[tid]
                self._sessions[tid] = new_s
                self._homes[tid] = target
                dead.tenants.discard(tid)
                dead.groups[key] -= 1
                target.tenants.add(tid)
                target.groups[key] += 1
                replay = stranded + pending
                for r in replay:
                    r.session = new_s
                if self.obs.tracer.enabled:
                    t = self.clock()
                    for r in replay:
                        span = getattr(r.plan, "span", None)
                        if span is not None:
                            span.event("migrate", t,
                                       src=dead.idx, dst=target.idx)
                    self.obs.tracer.instant("migrate_session", tenant=tid,
                                            src=dead.idx, dst=target.idx)
                if replay:
                    target.batcher.adopt_requests(replay)
                    # stranded requests kept their in-flight accounting
                    # through the strand (never landed); pending ones were
                    # never accounted — account them now so one landing
                    # discipline covers the whole replay
                    new_s.inflight += len(pending)
                    self._inflight += len(pending)
                    for b in target.batcher.take_session(new_s):
                        target.q.put(b)
                    target.stats.bump("chunks_replayed", len(replay))
                target.stats.bump("recoveries")
                target.stats.bump("sessions_migrated_in")
                target.stats.record_recovery(self.clock() - dead.died_at)
                dead.stats.bump("sessions_migrated_out")
                self._done.notify_all()

    def _drop_migrating(self, dead: FleetWorker, s: Session,
                        stranded: List[Request], pending: List[Request],
                        err: BaseException) -> None:
        """Poison one session during migration (budget exhausted, rebuild
        failed, or nowhere left to go). Only the stranded requests carry
        in-flight accounting; pending ones never did."""
        with self._state:
            reqs = stranded + pending
            if reqs:
                dead.batcher.fail_requests(reqs, err)
            if s.failed is None:
                s.failed = err
            dead.stats.bump("sessions_poisoned")
            s.inflight -= len(stranded)
            self._inflight -= len(stranded)
            self._done.notify_all()

    def _rebuild_on(self, old: Session, target: FleetWorker):
        """Rebuild a session on `target`'s pool and device (bounded build
        retries; no locks held — engine builds are slow). Returns
        (session, None) or (None, last error)."""
        err: Optional[BaseException] = None
        rng = random.Random(7)          # migration is controller-driven
        for attempt in range(self.recovery.build_retries + 1):
            if attempt:
                time.sleep(self.recovery.backoff_s(attempt - 1, rng))
            try:
                s = old.rebuild_on(target.pool, device=target.device)
                target.stats.bump("engine_rebuilds")
                return s, None
            except Exception as e:  # noqa: BLE001 — bounded retries
                err = e
        return None, err
