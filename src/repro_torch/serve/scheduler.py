"""Dynamic micro-batching — many tenant streams, one fused-kernel launch.

Port of `repro.serve.scheduler`. The paper's FPGA hits its throughput
target by instantiating N_i parallel CNN instances and streaming one link
through each; small per-link calls cannot fill a device. The serving answer
is the same shape as the FPGA's: keep the datapath full by running MANY
links per launch — here by
stacking the pending chunks of all tenants that share a `group_key()`
(topology + backend + static kernel config) into one batched fused kernel
with per-row tenant weights (`core.engine.stacked_engine_fn`).

Coalescing policy (the classic dynamic-batching trade-off):
  * max_batch   — launch as soon as this many tenant chunks are pending
                  in a group (throughput knob);
  * max_wait_s  — … or as soon as the OLDEST pending chunk has waited this
                  long (tail-latency knob);
  * `drain()`   — launch everything now (end of stream / shutdown).

A launch is split into three phases so an asynchronous front-end can
pipeline them:

  take_ready()  policy check + pop + ASSEMBLE: build the padded stacked
                input and look up the memoized per-group launch fn (a new
                tenant set stacks its weights on the device once), and on
                a card record an event on the assembling thread's stream;
  execute()     the device phase, on the executing thread's current
                stream: wait for the assembly's event, copy the stacked
                input to the device, launch the fused kernel, copy the
                output back (the copy to the host waits for the kernel);
  descatter()   host work again: slice each tenant's rows out, append to
                its session, resolve its future, record latency/traffic.

The synchronous `pump()`/`drain()`/`flush_session()` drivers run all three
phases inline on the caller's thread (deterministic, single-threaded — the
parity surface); `AsyncServeRuntime` runs execute() on a dedicated
launcher thread and CUDA stream, so the host phases of launch k+1 overlap
the device phase of launch k.

Every request carries submit/launch/done timestamps; `latency_stats()`
reports p50/p99 queueing and total latency plus batch-occupancy history —
the numbers `benchmarks/bench_serve.py` publishes. Per tune-key
`TrafficStats` (batch-occupancy and launch-width histograms) additionally
feed the serve-aware autotune re-tune (`runtime.py`).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time
from collections import Counter, deque
from typing import (Callable, Deque, Dict, List, Optional, Tuple)

import numpy as np
import torch

from ..core.engine import stacked_engine_fn
from ..obs import Observability
from .chunker import ChunkPlan
from .recovery import CorruptOutput, output_ok
from .session import Session

_CONSUMED = np.zeros((0,), np.float32)     # placeholder for launched inputs


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """Micro-batching policy knobs (all per `MicroBatcher`, i.e. runtime-wide).

    max_batch:    maximum tenant chunks coalesced into one stacked launch
                  (count; default 8). A group launches as soon as this many
                  chunks are pending — the throughput knob. Must be ≥ 1;
                  1 disables coalescing (one launch per chunk).
    max_wait_s:   maximum queueing age of the oldest pending chunk before
                  its group launches anyway (seconds; default 2 ms) — the
                  tail-latency knob. Only honoured when something calls
                  `pump()` (the sync runtime pumps inside submit). Set
                  very large (e.g. 1e9) to batch purely on max_batch.
    width_bucket: row-padding quantum for stacked launches (samples;
                  default 0 = auto → one kernel tile, tile_m·V_p·N_os).
                  Bounds the set of compiled launch shapes. Values that are
                  not a multiple of the tile quantum are rounded UP to it —
                  a sub-tile bucket would break the chunker's bitwise
                  contract (see `_bucket_width`), so it cannot be expressed.
    retune_after: serve-aware autotune warm-up threshold (launches per
                  `EqualizerEngine.tune_key()`; default 64; 0 disables).
                  Once a tune-key has this many recorded launches, tenants
                  opened with tile_m="auto" get their tile re-tuned against
                  the OBSERVED batch-occupancy/width histograms instead of
                  the single-stream autotune default. Already-open sessions
                  keep their tile — a mid-stream tile change would break
                  the chunker's tile-alignment (bitwise) invariant.
    """
    max_batch: int = 8
    max_wait_s: float = 2e-3
    width_bucket: int = 0
    retune_after: int = 64


@dataclasses.dataclass
class Request:
    """One tenant chunk queued for a batched launch.

    `future` (a `concurrent.futures.Future`) is set by the async runtime at
    enqueue time and resolved with this request's emitted symbols at
    descatter — the per-chunk awaitable handle. The sync runtime leaves it
    None and callers read `symbols` directly after pump/drain.
    """
    session: Session
    plan: ChunkPlan
    t_submit: float
    t_launch: float = 0.0
    t_done: float = 0.0
    batch_size: int = 0
    symbols: Optional[np.ndarray] = None
    future: Optional[concurrent.futures.Future] = None

    @property
    def done(self) -> bool:
        return self.symbols is not None

    @property
    def wait_s(self) -> float:
        return self.t_launch - self.t_submit

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


@dataclasses.dataclass
class LaunchBatch:
    """One assembled stacked launch: everything execute() needs, no more.

    Assembly snapshots the padded input `x` and the memoized launch fn so
    the device phase touches NO scheduler state.
    """
    key: Tuple                      # the group_key the requests share
    reqs: List[Request]
    x: np.ndarray                   # (B, W) padded stacked input
    fn: Callable[[torch.Tensor], torch.Tensor]
    device: torch.device            # where the group's engines live
    # on a card, when the batcher is `cross_stream`: recorded on the
    # assembling thread's stream after the fn (and any weight stack it
    # made) was queued; execute waits for it
    ready: Optional[torch.cuda.Event] = None


class TrafficStats:
    """Live per-tune-key traffic histograms for serve-aware autotune.

    Counts are per LAUNCH (not per request): `occupancy` histograms the
    stacked batch size B, `widths` the padded launch width W in samples
    (post width-bucket rounding, so the support is small). Bounded by
    construction — distinct (B, W) pairs are few because the bucketing
    quantizes widths.

    Thread-safe: concurrent launchers may record launches while a
    controller reads the histograms for placement/autotune. Mutation and
    snapshotting go through an
    internal lock; the derived statistics (`mode_occupancy`,
    `median_width`, `as_dict`) compute from a locked snapshot so a racing
    `record` can never half-update what they see.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.launches = 0
        self.occupancy: Counter = Counter()
        self.widths: Counter = Counter()

    def record(self, batch_size: int, width_samples: int) -> None:
        with self._lock:
            self.launches += 1
            self.occupancy[int(batch_size)] += 1
            self.widths[int(width_samples)] += 1

    def _snapshot(self) -> Tuple[int, Counter, Counter]:
        with self._lock:
            return self.launches, Counter(self.occupancy), \
                Counter(self.widths)

    def mode_occupancy(self) -> int:
        """The most common stacked batch size (0 if no traffic yet)."""
        _, occupancy, _ = self._snapshot()
        if not occupancy:
            return 0
        return max(sorted(occupancy), key=occupancy.get)

    def median_width(self) -> int:
        """Median padded launch width in samples (0 if no traffic yet)."""
        _, _, widths = self._snapshot()
        if not widths:
            return 0
        flat = sorted(w for w, c in widths.items() for _ in range(c))
        return flat[len(flat) // 2]

    def as_dict(self) -> Dict:
        launches, occupancy, widths = self._snapshot()
        flat = sorted(w for w, c in widths.items() for _ in range(c))
        return {"launches": launches,
                "occupancy": dict(sorted(occupancy.items())),
                "widths": dict(sorted(widths.items())),
                "mode_occupancy": (max(sorted(occupancy),
                                       key=occupancy.get)
                                   if occupancy else 0),
                "median_width": flat[len(flat) // 2] if flat else 0}


class MicroBatcher:
    """Groups pending requests by engine `group_key()` and launches them as
    stacked fused calls under the max-batch / max-wait policy."""

    # stacked-fn cache bound: steady-state traffic cycles through few
    # distinct (ordered) tenant sets; 64 covers many groups without
    # pinning unbounded weight stacks
    FN_CACHE_MAX = 64
    # default latency-window bound; the live bound comes from
    # `Retention.latency_window` (same default) — a bounded window, not the
    # full history (unbounded streams would otherwise leak one Request,
    # with its symbols array, per chunk forever)
    COMPLETED_MAX = 8192

    def __init__(self, policy: Optional[BatchPolicy] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 obs: Optional[Observability] = None,
                 obs_scope: str = "serve"):
        self.policy = policy or BatchPolicy()
        self.clock = clock
        # observability spine: runtimes pass their hub (fleet workers with
        # per-worker scopes like "fleet.worker0"); a standalone batcher
        # gets a private hub with tracing off, so every hook below is a
        # cheap guarded no-op by default
        self.obs = obs if obs is not None else Observability(clock=clock)
        self.tracer = self.obs.tracer
        window = self.obs.retention.latency_window
        scope = self.obs.scope(obs_scope)
        self._m_requests = scope.counter("requests_total")
        self._m_launches = scope.counter("launches_total")
        self._h_latency = scope.histogram("launch.latency_s", window)
        self._h_wait = scope.histogram("launch.wait_s", window)
        self._h_occupancy = scope.histogram("launch.occupancy", window)
        self._h_width = scope.histogram("launch.width_samples", window)
        self._h_device = scope.histogram("launch.device_s", window)
        self._h_descatter = scope.histogram("launch.descatter_s", window)
        scope.callback("pending", self.pending)
        scope.callback("latency", self.latency_stats)
        scope.callback("traffic", self.traffic_stats)
        self._groups: Dict[Tuple, List[Request]] = {}
        # True when execute may run on another CUDA stream than assemble
        # (the async runtime's launcher): assemble then records an event
        # that execute waits for. One thread on one stream needs no fence.
        self.cross_stream = False
        # (id(engine), …) → (engine refs, stacked fn). Holding the refs
        # keeps the ids valid; bounded FIFO so evicted engines can be GC'd.
        self._fn_cache: "Dict[Tuple, Tuple[list, Callable]]" = {}
        self.completed: Deque[Request] = deque(maxlen=window)
        self.batch_sizes: Deque[int] = deque(maxlen=window)
        # tune_key (group_key minus tile) → live width/occupancy histograms
        self.traffic: Dict[Tuple, TrafficStats] = {}
        self.total_requests = 0
        self.launches = 0
        # fault-tolerance hooks (serve/recovery.py): an optional
        # deterministic chaos schedule, and the output-sentinel bound
        # (None = no check). `exec_seq` numbers execute ATTEMPTS — the
        # index space FaultPlan launch faults are scheduled in; it only
        # ever advances on the launching thread (sync caller or the async
        # launcher), so a plain int is race-free.
        self.fault_plan = None
        self.sentinel_limit: Optional[float] = None
        self.exec_seq = 0
        # fleet identity (serve/fleet.py): set by FleetRuntime so device
        # fault kinds (FaultPlan.on_worker) can target THIS worker by
        # index; None outside a fleet. Because every fleet worker owns
        # its own batcher, `exec_seq` doubles as the per-worker execute
        # index the `Fault.after` schedule counts.
        self.worker_index: Optional[int] = None

    # -- queueing ----------------------------------------------------------

    def enqueue(self, session: Session) -> Optional[Request]:
        """Turn the session's pending stream samples into a queued request
        (None if the chunker has nothing emittable yet).

        The chunker commits here — at enqueue, not at launch — so a tenant
        can queue several requests back-to-back without double-planning the
        same positions. That is safe because a plan is a self-contained
        input snapshot: a failed launch re-queues its requests (see pump /
        flush_session) or retries in place (async launcher) and never needs
        the chunker rewound.
        """
        plan = session.chunker.plan()
        if plan is None:
            return None
        session.chunker.commit(plan)
        req = Request(session=session, plan=plan, t_submit=self.clock())
        span = self.tracer.begin(session.spec.tenant_id)
        if span is not None:                       # tracing on: the span
            span.stamp("submit", req.t_submit)     # rides the plan from
            plan.span = span                       # here to emit/seal
            # cross-wire propagation: contexts the net ingress queued for
            # this tenant (v2 DATA frames) become span events, so the
            # Chrome lane starts at the client's send timestamp
            while session.trace_ctx:
                tid_, t_client, t_ingress = session.trace_ctx.popleft()
                span.event("client_send", t_client, trace_id=tid_)
                span.event("net_ingress", t_ingress, trace_id=tid_)
        key = session.engine.group_key()
        self._groups.setdefault(key, []).append(req)
        return req

    def pending(self) -> int:
        return sum(len(v) for v in self._groups.values())

    # -- launch phases (assemble → execute → descatter) --------------------

    def take_ready(self, now: Optional[float] = None,
                   force: bool = False) -> List[LaunchBatch]:
        """Pop and ASSEMBLE every policy-ready batch (all, if force).

        Host-only phase: builds each batch's padded stacked input and
        launch fn, removes its requests from the queues. The caller owns
        the returned batches — it must execute+descatter each, or requeue()
        them (in reverse order) on failure, or no symbols are ever emitted.
        """
        if now is None:
            now = self.clock()
        out: List[LaunchBatch] = []
        for key in list(self._groups):
            reqs = self._groups[key]
            while reqs and (
                    force
                    or len(reqs) >= self.policy.max_batch
                    or now - reqs[0].t_submit >= self.policy.max_wait_s):
                take = reqs[:self.policy.max_batch]
                del reqs[:self.policy.max_batch]
                out.append(self.assemble(key, take))
            if not reqs:
                del self._groups[key]
        return out

    def take_session(self, session: Session) -> List[LaunchBatch]:
        """Pop and assemble ONLY this session's pending requests (tenant
        close/tail flush). Other tenants' partial batches stay queued so
        their max_batch/max_wait policy — and batch occupancy — is
        untouched."""
        out: List[LaunchBatch] = []
        for key in list(self._groups):
            reqs = self._groups[key]
            mine = [r for r in reqs if r.session is session]
            if not mine:
                continue
            rest = [r for r in reqs if r.session is not session]
            if rest:
                self._groups[key] = rest
            else:
                del self._groups[key]
            for i in range(0, len(mine), self.policy.max_batch):
                out.append(self.assemble(key, mine[i:i + self.policy.max_batch]))
        return out

    def requeue(self, batch: LaunchBatch) -> None:
        """Put an un-executed batch's requests back at the head of their
        group (launch failure; plans are self-contained input snapshots so
        this is always safe). When several batches failed, requeue them in
        REVERSE take order so stream order per session is preserved."""
        if self.tracer.enabled:
            t = self.clock()
            for r in batch.reqs:
                if r.plan.span is not None:
                    r.plan.span.event("requeue", t)
        self._groups.setdefault(batch.key, [])[:0] = batch.reqs

    def adopt_requests(self, reqs: List[Request]) -> None:
        """Admit EXISTING Request objects into this batcher's queues (the
        fleet migration path: a dead worker's un-landed requests, plans
        and futures intact, move to a surviving worker's batcher). The
        caller must already have re-pointed each `Request.session` at a
        session rebuilt against THIS worker's pool — the group key is
        recomputed from that session's engine, so adopted requests stack
        with the new worker's traffic. Input order is preserved, which is
        what keeps per-session replay FIFO."""
        for r in reqs:
            key = r.session.engine.group_key()
            self._groups.setdefault(key, []).append(r)

    def evict_all(self) -> List[Request]:
        """Pop EVERY pending request, preserving per-group enqueue order
        (fleet worker death: never-assembled requests migrate too)."""
        out: List[Request] = []
        for key in list(self._groups):
            out.extend(self._groups.pop(key))
        return out

    def assemble(self, key: Tuple, reqs: List[Request]) -> LaunchBatch:
        """Host phase 1: pad the requests' plans to one width bucket, stack
        them into the (B, W) launch input, bind the memoized group fn."""
        if self.tracer.enabled:
            t = self.clock()
            for r in reqs:
                if r.plan.span is not None:
                    r.plan.span.stamp("assemble", t)
        engines = [r.session.engine for r in reqs]
        fn = self._group_fn(engines)
        width = self._bucket_width(reqs)
        x = np.zeros((len(reqs), width), np.float32)
        for i, r in enumerate(reqs):
            x[i, :r.plan.width] = r.plan.data      # right zero-pad = offline
        device = engines[0].device
        ready = None
        if self.cross_stream and device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
        return LaunchBatch(key=key, reqs=reqs, x=x, fn=fn, device=device,
                           ready=ready)

    def execute(self, batch: LaunchBatch) -> np.ndarray:
        """Device phase, on the calling thread's current stream: wait for
        the batch's assembly (`LaunchBatch.ready`), host→device copy of
        the stacked input, ONE stacked fused-kernel launch, device→host
        copy of the (B, S) output (which waits for the kernel). Touches no
        scheduler state beyond
        the attempt counter — safe to run off-thread without the runtime
        lock. Each call consumes one `exec_seq` index; an installed
        `FaultPlan` may raise/delay before the dispatch or corrupt the
        landed output at its scheduled indices (retries and failover
        replays consume FRESH indices, so an injected fault fires once)."""
        idx, self.exec_seq = self.exec_seq, self.exec_seq + 1
        if self.fault_plan is not None:
            if self.worker_index is not None:
                self.fault_plan.on_worker(self.worker_index, idx)
            self.fault_plan.on_execute(idx)
        t_launch = self.clock()
        if self.tracer.enabled:          # stamp AFTER the fault hooks so a
            for r in batch.reqs:         # raised injection never stamps —
                if r.plan.span is not None:   # the retry's stamps describe
                    r.plan.span.stamp("launch", t_launch)  # the real launch
        if batch.ready is not None:
            torch.cuda.current_stream(batch.device).wait_event(batch.ready)
        y = batch.fn(torch.from_numpy(batch.x).to(batch.device))
        y = y.cpu().numpy()
        if self.fault_plan is not None:
            y = self.fault_plan.on_output(idx, y)
        t_landed = self.clock()
        self._h_device.observe(t_landed - t_launch)
        if self.tracer.enabled:
            for r in batch.reqs:
                if r.plan.span is not None:
                    r.plan.span.stamp("execute", t_landed)
        for r in batch.reqs:
            r.t_launch = t_launch
        return y

    def descatter(self, batch: LaunchBatch, y: np.ndarray) -> None:
        """Host phase 2: slice each tenant's emitted rows out of the
        stacked output, append to its session in stream order, resolve its
        future, record latency + traffic stats.

        The output sentinel runs FIRST, before any row is emitted: a
        rejected batch raises `CorruptOutput` with the batch state fully
        intact (inputs unconsumed, futures pending, nothing appended), so
        the caller can requeue or replay it exactly like a failed launch —
        quarantine instead of emitting garbage."""
        if self.sentinel_limit is not None and not output_ok(
                y, self.sentinel_limit):
            raise CorruptOutput(
                f"stacked output rejected by sentinel (|y| ≤ "
                f"{self.sentinel_limit:g} violated or non-finite) for "
                f"batch of {len(batch.reqs)}")
        t_done = self.clock()
        reqs = batch.reqs
        for i, r in enumerate(reqs):
            vp = r.session.v_parallel
            syms = y[i, r.plan.skip * vp:(r.plan.skip + r.plan.n_emit) * vp]
            r.symbols = syms
            r.t_done, r.batch_size = t_done, len(reqs)
            r.session.append_output(syms)
            if r.session.tap is not None:
                # adaptation tap: the REAL input samples behind the emitted
                # positions (skip/context sliced off) + the symbols they
                # produced — the (rx, decision) pairs adaptation collects
                ts = r.session.chunker.ts
                lo = r.plan.skip * ts
                r.session.tap(r.plan.data[lo:lo + r.plan.n_emit * ts], syms)
            span = r.plan.span
            if span is not None:
                span.stamp("descatter", t_done)
                span.n_emit = r.plan.n_emit
                span.width = r.plan.width
            r.plan.data = _CONSUMED        # release the input buffer; the
            self.completed.append(r)       # record keeps only timing+syms
            # a caller may legally cancel() a pending chunk future; the
            # symbols still join the stream (cancel abandons the
            # notification, not the data) — set_result on a cancelled
            # future would raise and poison the whole batch
            if r.future is not None and not r.future.done():
                r.future.set_result(syms)
            if span is not None:           # emitted ⇒ sealed exactly once
                span.stamp("emit", self.clock())
                self.tracer.seal(span)
            self._h_latency.observe(r.latency_s)
            self._h_wait.observe(r.wait_s)
        skey = reqs[0].session.engine.tune_key()
        self.traffic.setdefault(skey, TrafficStats()).record(
            len(reqs), batch.x.shape[1])
        self.total_requests += len(reqs)
        self.batch_sizes.append(len(reqs))
        self.launches += 1
        self._m_requests.inc(len(reqs))
        self._m_launches.inc()
        self._h_occupancy.observe(len(reqs))
        self._h_width.observe(batch.x.shape[1])
        self._h_descatter.observe(self.clock() - t_done)

    def fail(self, batch: LaunchBatch, exc: BaseException) -> None:
        """Terminal launch failure (async path, after retries): fail every
        request's future and poison its session so a later output()/close()
        raises instead of silently returning a stream with a hole.
        Idempotent per request — futures already resolved (e.g. a failure
        mid-descatter) are left alone."""
        self.fail_requests(batch.reqs, exc)

    def fail_requests(self, reqs: List[Request], exc: BaseException) -> None:
        """Poison a SUBSET of a failed batch's requests (the failover path
        partitions a batch into replayable and over-budget requests — only
        the latter die). Same semantics as `fail`, per request."""
        t = self.clock() if self.tracer.enabled else 0.0
        for r in reqs:
            r.session.failed = exc
            if r.future is not None and not r.future.done():
                r.future.set_exception(exc)
            span = r.plan.span
            if span is not None:           # poisoned chunks seal "failed":
                span.event("poisoned", t, error=repr(exc))   # never counted
                self.tracer.seal(span, status="failed")      # as emitted


    # -- synchronous drivers ----------------------------------------------

    def _run(self, batches: List[LaunchBatch]) -> int:
        """Execute+descatter assembled batches inline; on failure requeue
        every un-executed batch (reverse order) and surface the error —
        transient device failures are retryable via the next pump."""
        n = 0
        try:
            for b in batches:
                y = self.execute(b)
                self.descatter(b, y)
                n += 1
        except Exception:
            for b in reversed(batches[n:]):
                self.requeue(b)
            raise
        return n

    def pump(self, force: bool = False) -> int:
        """Launch every group that meets the policy (or all, if force).
        Returns the number of launches performed."""
        return self._run(self.take_ready(self.clock(), force=force))

    def drain(self) -> int:
        return self.pump(force=True)

    def flush_session(self, session: Session) -> int:
        """Synchronously launch ONLY this session's pending requests."""
        return self._run(self.take_session(session))

    # -- assembly helpers --------------------------------------------------

    def _bucket_width(self, reqs: List[Request]) -> int:
        e = reqs[0].session.engine
        tile_q = e.resolved_tile_m() * e.total_stride
        q = self.policy.width_bucket
        # the bucket MUST be a whole number of tiles: a sub-tile-width row
        # would shrink the kernel's effective tile (n_pos < tile_m) and
        # void the chunker's tile-alignment ⇒ bitwise-offline invariant,
        # so a user quantum is rounded up to the tile quantum
        q = tile_q if q <= 0 else (-(-q // tile_q) * tile_q)
        w = max(r.plan.width for r in reqs)
        return -(-w // q) * q                      # ceil to bucket quantum

    def _group_fn(self, engines) -> Callable:
        """Memoized stacked launch fn: steady-state round-robin traffic
        re-batches the SAME engines in the SAME order every round, so the
        per-launch weight re-stack (and its host→device transfer) is paid
        once per tenant set, not once per launch."""
        key = tuple(id(e) for e in engines)
        hit = self._fn_cache.get(key)
        if hit is not None:
            return hit[1]
        fn = stacked_engine_fn(engines)
        self._fn_cache[key] = (list(engines), fn)
        while len(self._fn_cache) > self.FN_CACHE_MAX:
            self._fn_cache.pop(next(iter(self._fn_cache)))
        return fn

    # -- accounting --------------------------------------------------------

    def traffic_stats(self) -> Dict[str, Dict]:
        """Live serve-aware histograms, one entry per tune-key (keys are
        stringified for JSON-ability — `cfg layers/backend` summary)."""
        out = {}
        for key, st in self.traffic.items():
            cfg, backend = key[0], key[1]
            out[f"L{cfg.layers}_K{cfg.kernel}_{backend}"] = st.as_dict()
        return out

    def latency_stats(self) -> Dict[str, float]:
        """Percentiles over the last `Retention.latency_window` requests
        (full history for any run shorter than the window, e.g. the
        benches)."""
        if not self.completed:
            return {"requests": 0}
        lat = np.array([r.latency_s for r in self.completed])
        wait = np.array([r.wait_s for r in self.completed])
        occ = np.array(self.batch_sizes, np.float64)
        return {
            "requests": self.total_requests,
            "launches": self.launches,
            "mean_batch": float(occ.mean()),
            "p50_latency_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_latency_ms": float(np.percentile(lat, 99) * 1e3),
            "p50_wait_ms": float(np.percentile(wait, 50) * 1e3),
            "p99_wait_ms": float(np.percentile(wait, 99) * 1e3),
        }
