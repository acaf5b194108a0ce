"""Fault-tolerant serving — deterministic fault injection, session
failover, and straggler-driven graceful degradation.

Port of `repro.serve.recovery` (host-side bookkeeping, no device code; the
sync `ServeRuntime` uses `FaultPlan`, the output sentinel and
`CorruptOutput`; the failover loop and degradation controller serve the
asynchronous runtime, which a later slice ports).

The source paper's receiver sits in a live signal path: an equalizer that
stops emitting symbols because one launch died has failed its contract
even if every bit it DID emit was perfect. This module upgrades the
serving stack's failure semantics from "poison the stream on terminal
failure" to "recover with bitwise-intact streams", exploiting the
invariant that engines are disposable — a session rebuilds
its engine deterministically from `TenantSpec`, and the chunker carry
(plus the self-contained `ChunkPlan` input snapshots of in-flight chunks)
is the complete stream state. Failover is therefore a REBUILD + REPLAY,
not a loss:

  * `FaultPlan` — a deterministic chaos schedule (generalizing the
    training loop's `repro.runtime.fault` `FailureInjector` from "fail at
    step k" to four serving fault kinds): launch exceptions, launch
    delays, engine-build failures, and NaN/saturated output corruption,
    each at scheduled launch/build indices. Wired as an optional hook
    through `MicroBatcher.execute` (injection), `MicroBatcher.descatter`
    (sentinel detection) and `EnginePool.get` builds — both serving
    drivers can inject, so chaos tests and `benchmarks/bench_fault.py`
    share one mechanism.
  * `RecoveryPolicy` + `RecoveryStats` — failover bounds (recoveries per
    session, engine-rebuild retries, backoff shape, output-sentinel
    limit) and the counters/latency histogram `bench_fault` publishes.
  * `output_ok` — the cheap output-sentinel check: every emitted value
    must be finite and inside `sentinel_limit`. PAM soft symbols live in
    O(1) range, so a huge limit still catches NaN/Inf and saturated
    garbage without ever tripping on healthy traffic. A corrupted stacked
    output raises `CorruptOutput` BEFORE any row is emitted; the async
    runtime quarantines it — replays the chunks through a rebuilt engine,
    and (when the session recently hot-swapped weights) rolls the weights
    back via the `prev_spec` path instead of emitting garbage.
  * `DegradationController` — a revived `repro.runtime.straggler`
    `StragglerMonitor` over LAUNCH latencies: under persistent slowness
    it shrinks `BatchPolicy.max_batch` (smaller stacked launches → lower
    per-launch latency) and sheds the lowest-priority tenants
    (`TenantSpec.priority`; their submits raise `TenantShedError` until
    health returns); after `patience` consecutive clean launches both
    mitigations are restored.

Everything here is host-side bookkeeping; the device
only ever sees replayed `ChunkPlan` snapshots, which is why replayed
output is bitwise-identical to the uninterrupted stream (contract #9 in
docs/ARCHITECTURE.md "Failure semantics & recovery").
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..runtime.straggler import StragglerConfig, StragglerMonitor


# ---------------------------------------------------------------------------
# failure taxonomy
# ---------------------------------------------------------------------------

class InjectedFault(RuntimeError):
    """A fault fired by a `FaultPlan` (launch or engine-build)."""


class LaunchTimeout(RuntimeError):
    """The launch watchdog expired: the device call exceeded its deadline
    and was abandoned (the hung worker thread is discarded)."""


class CorruptOutput(RuntimeError):
    """The output sentinel rejected a stacked launch result (NaN/Inf or
    out-of-range values) before anything was emitted."""


class DeviceLost(RuntimeError):
    """A fleet worker's device is gone (injected `device_lost` fault, or
    declared by the fleet health model after consecutive terminal launch
    failures). Not retryable on the same worker — the fleet controller
    migrates the worker's sessions to a surviving device instead
    (`repro.serve.fleet`)."""


class TenantShedError(RuntimeError):
    """Submit refused: the tenant is currently shed by the degradation
    controller. Back off and retry after the runtime reports healthy."""


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------

# fault kinds and the index space their `at` is scheduled in
_LAUNCH_KINDS = ("launch_error", "launch_delay", "corrupt")   # execute index
_BUILD_KINDS = ("build_error",)                               # build index
_DEVICE_KINDS = ("device_lost", "device_slow")                # worker index


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault.

    kind:    "launch_error" (execute raises), "launch_delay" (execute
             sleeps `delay_s` before dispatch — drives the straggler
             monitor and, past the deadline, the watchdog),
             "build_error" (an `EnginePool` miss's build raises — hits
             session opens AND failover rebuilds), "corrupt" (the
             stacked output is overwritten with NaN/saturated values),
             "device_lost" (a fleet worker's execute raises `DeviceLost`
             — the whole worker dies and its sessions migrate), or
             "device_slow" (a fleet worker's execute sleeps `delay_s` —
             drives the worker's straggler-fed health model).
    at:      the scheduled index — the batcher's execute-attempt counter
             for launch kinds, the pool's build counter for build_error,
             and the WORKER index for device kinds (which worker of the
             fleet the fault hits). Each fault fires AT MOST ONCE
             (replays consume fresh indices, so a recovered launch is
             clean by construction).
    after:   device kinds only: the worker's execute-attempt index at or
             beyond which the fault fires (default 0 = the worker's first
             launch). Lets a chaos test kill a worker MID-stream, after
             some launches have already landed.
    delay_s: sleep for "launch_delay" / "device_slow" (seconds).
    mode:    corruption shape for "corrupt": "nan" or "saturate" (±1e9).
    rows:    stacked rows to corrupt (None → every row).
    """
    kind: str
    at: int
    after: int = 0
    delay_s: float = 0.0
    mode: str = "nan"
    rows: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.kind not in _LAUNCH_KINDS + _BUILD_KINDS + _DEVICE_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.mode not in ("nan", "saturate"):
            raise ValueError(f"unknown corrupt mode {self.mode!r}")
        if self.after and self.kind not in _DEVICE_KINDS:
            raise ValueError(
                f"`after` only applies to device fault kinds, not "
                f"{self.kind!r}")


class FaultPlan:
    """Deterministic fault schedule for serving chaos tests and
    `benchmarks/bench_fault.py`.

    Hooks (each fires its fault at most once, under an internal lock —
    pool builds and launches run on different threads):

      on_execute(idx)      — called by `MicroBatcher.execute` before the
                             device dispatch; may sleep (launch_delay) or
                             raise `InjectedFault` (launch_error).
      on_output(idx, y)    — called after the launch lands; returns `y`
                             or a corrupted copy (corrupt).
      on_build(idx)        — called by `EnginePool.get` before a miss's
                             build; may raise `InjectedFault`.
      on_worker(worker, idx) — called by `MicroBatcher.execute` when the
                             batcher belongs to a fleet worker
                             (`worker_index` set), BEFORE on_execute; may
                             sleep (device_slow) or raise `DeviceLost`
                             (device_lost) once the worker's execute
                             index reaches the fault's `after`.

    `fired` lists (kind, at) in fire order — the assertion surface for
    tests ("the chaos really happened") and the bench report.
    """

    def __init__(self, faults: Sequence[Fault] = ()):
        self._faults: Dict[Tuple[str, int], Fault] = {}
        for f in faults:
            key = (f.kind, f.at)
            if key in self._faults:
                raise ValueError(f"duplicate fault {key}")
            self._faults[key] = f
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, int]] = []

    def _take(self, kind: str, idx: int) -> Optional[Fault]:
        with self._lock:
            f = self._faults.get((kind, idx))
            if f is None or (kind, idx) in self.fired:
                return None
            self.fired.append((kind, idx))
            return f

    def _take_after(self, kind: str, worker: int,
                    idx: int) -> Optional[Fault]:
        """Take a device fault scheduled on `worker` once that worker's
        execute index has reached the fault's `after` (at most once,
        thread-safe — fleet workers launch concurrently)."""
        with self._lock:
            f = self._faults.get((kind, worker))
            if (f is None or (kind, worker) in self.fired
                    or idx < f.after):
                return None
            self.fired.append((kind, worker))
            return f

    # -- hooks -------------------------------------------------------------

    def on_execute(self, idx: int) -> None:
        f = self._take("launch_delay", idx)
        if f is not None:
            time.sleep(f.delay_s)
        f = self._take("launch_error", idx)
        if f is not None:
            raise InjectedFault(f"injected launch error at launch {idx}")

    def on_output(self, idx: int, y: np.ndarray) -> np.ndarray:
        f = self._take("corrupt", idx)
        if f is None:
            return y
        y = np.array(y, copy=True)
        rows = range(y.shape[0]) if f.rows is None else f.rows
        bad = np.nan if f.mode == "nan" else 1e9
        for r in rows:
            if 0 <= r < y.shape[0]:
                y[r] = bad
        return y

    def on_build(self, idx: int) -> None:
        f = self._take("build_error", idx)
        if f is not None:
            raise InjectedFault(f"injected engine-build failure "
                                f"at build {idx}")

    def on_worker(self, worker: int, idx: int) -> None:
        """Device-level faults for fleet worker `worker` at its execute
        index `idx` (each fires at most once; see `Fault.after`)."""
        f = self._take_after("device_slow", worker, idx)
        if f is not None:
            time.sleep(f.delay_s)
        f = self._take_after("device_lost", worker, idx)
        if f is not None:
            raise DeviceLost(f"injected device loss on worker {worker} "
                             f"at execute {idx}")

    # -- introspection -----------------------------------------------------

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._faults) - len(self.fired)

    def summary(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for kind, _ in self.fired:
                out[kind] = out.get(kind, 0) + 1
            return out


# ---------------------------------------------------------------------------
# output sentinel
# ---------------------------------------------------------------------------

def output_ok(y: np.ndarray, limit: float) -> bool:
    """Cheap corruption check on a stacked launch output: every value
    finite and |value| ≤ limit. One vectorized pass — O(B·S) adds, noise
    next to the kernel launch it guards."""
    m = float(np.max(np.abs(y))) if y.size else 0.0
    return bool(np.isfinite(m) and m <= limit)


# ---------------------------------------------------------------------------
# recovery policy / accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Failover bounds and backoff shape for `AsyncServeRuntime`.

    max_session_recoveries: failover rounds a single session may consume
                  before its stream is poisoned the old way (count;
                  default 4). The bound that keeps a permanently dead
                  device from looping forever.
    build_retries: engine-rebuild attempts per failover before the
                  session is declared unrecoverable (count; default 2).
    backoff_base_s / backoff_max_s: exponential backoff between in-place
                  launch retries, rebuild attempts, and failover rounds —
                  base·2^attempt, capped (seconds; defaults 0.02 / 1.0).
                  Back-to-back retries against a sick device only pile
                  more work on it.
    jitter:       backoff randomization fraction (default 0.25); the
                  jitter RNG is seeded per runtime, so sleep sequences
                  are reproducible run-to-run.
    sentinel_limit: output-sentinel bound (|value| ≤ limit, finite;
                  default 1e4 — PAM soft symbols are O(1), so this only
                  trips on genuine garbage). None disables the check.
    rollback_on_corrupt: when corrupted output is detected on a session
                  that has hot-swapped weights (`prev_spec` present),
                  roll the weights back bit-identically before replaying
                  (at most once per session; default True).
    device_lost_after: fleet health model only — consecutive TERMINAL
                  launch failures on one worker before the fleet declares
                  its device lost and migrates every resident session
                  (count; default None = never; `FleetRuntime` defaults
                  its own policy to 2). Meaningless for the single-device
                  `AsyncServeRuntime`, which has nowhere to migrate.
    """
    max_session_recoveries: int = 4
    build_retries: int = 2
    backoff_base_s: float = 0.02
    backoff_max_s: float = 1.0
    jitter: float = 0.25
    sentinel_limit: Optional[float] = 1e4
    rollback_on_corrupt: bool = True
    device_lost_after: Optional[int] = None

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        """Backoff before retry `attempt` (0-based): exponential, capped,
        jittered ±`jitter` fraction."""
        base = min(self.backoff_max_s,
                   self.backoff_base_s * (2.0 ** attempt))
        if self.jitter <= 0:
            return base
        return base * (1.0 - self.jitter + 2.0 * self.jitter * rng.random())


class RecoveryStats:
    """Failover counters + a bounded recovery-latency window (the numbers
    `benchmarks/bench_fault.py` publishes and `stats()["recovery"]`
    exposes; a fleet keeps one ledger PER WORKER).

    Thread-safe: every mutation goes through `bump`/`record_recovery`
    under an internal lock and `as_dict` snapshots under the same lock —
    fleet launcher threads and the fleet controller race the counters
    Counter reads stay plain attribute access (ints are consistent under
    the GIL; only read-modify-write needs the lock).
    """

    WINDOW = 256
    FIELDS = ("recoveries",            # failover rounds relaunched
              "chunks_replayed",       # requests re-equalized by failover
              "engine_rebuilds",       # pool entries dropped + rebuilt
              "deadline_timeouts",     # watchdog expirations
              "corrupt_detected",      # sentinel rejections
              "rollbacks",             # corrupt → prev_spec reinstalls
              "sessions_poisoned",     # streams lost despite recovery
              "device_losses",         # this worker's device declared lost
              "sessions_migrated_out",  # sessions this worker lost to peers
              "sessions_migrated_in")   # sessions adopted from dead peers

    def __init__(self):
        self._lock = threading.Lock()
        for f in self.FIELDS:
            setattr(self, f, 0)
        self.recovery_s: Deque[float] = deque(maxlen=self.WINDOW)

    def bump(self, field: str, n: int = 1) -> None:
        """Atomically increment one counter (must be a FIELDS name)."""
        if field not in self.FIELDS:
            raise AttributeError(f"unknown recovery counter {field!r}")
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def record_recovery(self, dt: float) -> None:
        with self._lock:
            self.recovery_s.append(dt)

    def as_dict(self) -> Dict:
        with self._lock:
            lat = sorted(self.recovery_s)
            out = {f: getattr(self, f) for f in self.FIELDS}
        q = lambda f: lat[int(f * (len(lat) - 1))] if lat else 0.0
        out["p50_recovery_s"] = q(0.5)
        out["max_recovery_s"] = q(1.0)
        return out


# ---------------------------------------------------------------------------
# graceful degradation
# ---------------------------------------------------------------------------

class DegradationController:
    """Shrink-and-shed under persistent launch slowness, restore when
    healthy.

    Feeds every launch latency to a `StragglerMonitor`; when the
    monitor's `degraded` latch turns on (persistent slowness: `patience`
    consecutive flagged launches), the controller halves
    `BatchPolicy.max_batch` (floor 1) and sheds the `shed_count`
    lowest-priority open sessions (ties broken by tenant_id, so the shed
    set is deterministic) — their submits raise `TenantShedError`. When
    the latch decays (`patience` consecutive clean launches) the original
    policy is restored and shed tenants are readmitted.

    `mitigate=False` keeps the monitor observing (health visible in
    `stats()`) without ever mutating policy or shedding — the default for
    `AsyncServeRuntime`, which makes load shedding an explicit opt-in
    (`degrade_on_slow=True`): silently rejecting tenant traffic is a
    policy decision, not a default.

    Thread-safety: `observe` must be called under the runtime lock (it
    may mutate the batcher policy and session flags).
    """

    def __init__(self, batcher, sessions,
                 cfg: Optional[StragglerConfig] = None,
                 shed_count: int = 1, mitigate: bool = True):
        self.batcher = batcher
        self.sessions = sessions
        self.shed_count = shed_count
        self.mitigate = mitigate
        self.monitor = StragglerMonitor(cfg or StragglerConfig(),
                                        on_straggler=self._degrade,
                                        on_recovered=self._restore)
        self._orig_policy = None
        self.shed_ids: List[str] = []
        self.events: Deque[tuple] = deque(maxlen=64)

    def observe(self, launch_idx: int, dt: float) -> bool:
        """Record one launch latency (seconds); returns True if flagged.
        Caller holds the runtime lock."""
        return self.monitor.observe(launch_idx, dt)

    @property
    def degraded(self) -> bool:
        return self.monitor.degraded

    # -- mitigation edges (fired by the monitor, under observe's lock) -----

    def _degrade(self, step: int, dt: float) -> None:
        if not self.mitigate:
            self.events.append(("degrade_advisory", step))
            return
        pol = self.batcher.policy
        if self._orig_policy is None:
            self._orig_policy = pol
        self.batcher.policy = dataclasses.replace(
            pol, max_batch=max(1, pol.max_batch // 2))
        for s in sorted(self.sessions.sessions.values(),
                        key=lambda s: (s.spec.priority, s.spec.tenant_id)):
            if len(self.shed_ids) >= self.shed_count:
                break
            if s.spec.tenant_id not in self.shed_ids:
                s.shed = True
                self.shed_ids.append(s.spec.tenant_id)
        self.events.append(("degrade", step, self.batcher.policy.max_batch,
                            tuple(self.shed_ids)))

    def _restore(self, step: int) -> None:
        if not self.mitigate:
            self.events.append(("restore_advisory", step))
            return
        if self._orig_policy is not None:
            self.batcher.policy = self._orig_policy
            self._orig_policy = None
        for tid in self.shed_ids:
            if tid in self.sessions:
                self.sessions.get(tid).shed = False
        self.shed_ids.clear()
        self.events.append(("restore", step))

    def state(self) -> Dict:
        return {"degraded": self.degraded,
                "mitigate": self.mitigate,
                "max_batch": self.batcher.policy.max_batch,
                "shed": list(self.shed_ids),
                "straggler": self.monitor.summary()}
