"""Tenant sessions — channel config + trained params + QAT formats → engine.

A TENANT is one equalized link (an optical channel, a magnetic-recording
head, …) with its own trained parameters and learned fixed-point formats.
A SESSION is a tenant's live streaming state: the overlap-save chunker
carry, output accumulator, and latency counters. Engines themselves live in
the LRU `EnginePool` (pool.py) and are rebuilt on demand after eviction —
sessions never pin one.

Serve-aware autotune hook: `Session` accepts a `tile_tuner` callback
(provided by the runtime, see `runtime._serve_tile`). For a spec with
tile_m="auto" it may return a tile width tuned against LIVE traffic
histograms instead of the engine's single-stream autotune default. The
chosen tile is frozen into the session's spec copy at open time, so engine
rebuilds after LRU eviction reproduce it deterministically and the chunker's
tile-alignment (bitwise-vs-offline) invariant holds for the stream's whole
lifetime.

Port of `repro.serve.session`. Engines are built on the device the session
manager serves (``device=``, default "cuda"); a spec's params or weights
may be tensors or numpy arrays (`repro_torch.interop`), and BN is folded on
the host before the weights move to the device.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from .. import interop
from ..core.engine import EqualizerEngine
from ..core.equalizer import (CNNEqConfig, fold_bn, folded_weights,
                              init_bn_state)
from ..device import DeviceLike, resolve_device
from .chunker import StreamChunker
from .pool import EnginePool

# a tile_tuner maps a freshly built engine to a tile width (or None to keep
# the engine's own single-stream autotune choice)
TileTuner = Callable[[EqualizerEngine], Optional[int]]


class TapChain:
    """Fan-out for the `Session.tap` seam: several consumers (adaptation
    collector, link-quality monitor, tests) observe the SAME descatter
    callback, in registration order. A plain callable, so every existing
    `session.tap(...)` call site works unchanged; exceptions propagate
    (a broken tap must be loud, exactly like a broken single tap)."""

    __slots__ = ("taps",)

    def __init__(self, taps: Optional[List[Callable]] = None) -> None:
        self.taps: List[Callable] = list(taps or [])

    def __call__(self, rx: np.ndarray, soft_syms: np.ndarray) -> None:
        for fn in self.taps:
            fn(rx, soft_syms)

    def __len__(self) -> int:
        return len(self.taps)


@dataclasses.dataclass
class TenantSpec:
    """Everything needed to (re)build a tenant's engine deterministically.

    tenant_id: unique key (string) — engine-pool identity; opening the same
               id twice on one runtime raises ValueError.
    cfg:       the CNN topology (`CNNEqConfig`).
    params:    trained (unfolded) parameters, as tensors or numpy arrays
               (`repro_torch.interop`); BN is folded and QAT formats
               are picked up automatically at engine build
               (`EqualizerEngine.from_params`). Exactly one of
               params/weights must be given, else build_engine raises
               ValueError.
    bn_state:  running BN statistics to fold (default None → init stats).
    weights:   pre-folded fp32 weights, tensors or numpy (alternative to
               params).
    formats:   per-layer (w_int, w_frac, a_int, a_frac) fixed-point
               formats — required for backend="fused_int8" with explicit
               weights. When given TOGETHER with params they PIN the
               deployment formats: BN is folded but the formats are taken
               as-is instead of being re-derived from the params' QAT
               subtree. This is the weight hot-swap form
               (`serve.runtime` `swap_weights`): new weights, frozen
               static kernel config, so the group key cannot move.
    backend:   "auto" (default; deploys the QAT ladder int8→bf16→fp32),
               or an explicit backend name. Explicit "fused_int8" raises at
               build if the formats don't fit int8 or the BN-folded weights
               overflow the learned grid.
    tile_m:    kernel sequence-tile width. "auto" (default) → autotune
               sweep, possibly serve-aware (live-traffic histograms) when
               opened through a runtime with warm stats; an explicit int is
               NEVER re-tuned. Fixed for the life of the stream.
    per_channel: refine learned per-layer weight formats to per-output-
               channel scales at deployment (`core.qat`
               `per_channel_formats`; params path only). Deterministic
               given the params, so rebuilds after eviction agree.
    weight_epoch: monotone counter of weight hot-swaps (0 = the weights
               the stream opened with). Bumped by `swap_weights`/
               `rollback_weights`; NOT part of the engine's group key —
               epochs ride in the per-row stacked weight operands, so
               tenants on different epochs still share launches.
    priority:  load-shedding rank (int; default 0, higher = more
               important). Under persistent launch slowness the
               degradation controller (`serve.recovery`) sheds the
               LOWEST-priority tenants first (ties broken by tenant_id).
               Not part of the engine identity — purely a serving-policy
               attribute.
    """
    tenant_id: str
    cfg: CNNEqConfig
    params: Optional[Dict[str, Any]] = None
    bn_state: Optional[Dict[str, Any]] = None
    weights: Optional[tuple] = None
    formats: Optional[tuple] = None
    backend: str = "auto"
    tile_m: int | str = "auto"
    per_channel: bool = False
    weight_epoch: int = 0
    priority: int = 0

    def build_engine(self, device: DeviceLike = "cuda") -> EqualizerEngine:
        """Build this tenant's engine on ``device`` (deterministic: the
        same spec always gives the same deployed weights)."""
        if (self.params is None) == (self.weights is None):
            raise ValueError(
                f"tenant {self.tenant_id!r}: exactly one of params/weights")
        if self.params is not None:
            if self.formats is not None:
                # pinned-formats deployment (hot-swap spec): fold BN on the
                # host, keep the frozen static kernel config as served
                params = interop.to_torch(self.params, device="cpu")
                bn = (interop.to_torch(self.bn_state, device="cpu")
                      if self.bn_state else
                      init_bn_state(self.cfg, device="cpu"))
                folded = fold_bn(params, bn, self.cfg)
                return EqualizerEngine(cfg=self.cfg,
                                       weights=folded_weights(folded),
                                       backend=self.backend,
                                       tile_m=self.tile_m,
                                       formats=self.formats, device=device)
            return EqualizerEngine.from_params(
                self.params, self.bn_state, self.cfg,
                backend=self.backend, tile_m=self.tile_m, device=device,
                per_channel=self.per_channel)
        return EqualizerEngine(cfg=self.cfg, weights=self.weights,
                               backend=self.backend, tile_m=self.tile_m,
                               formats=self.formats, device=device)


class Session:
    """One tenant's live stream state (engine NOT held — see pool).

    `failed` is None on the happy path; the async runtime sets it to the
    terminal exception when a launch for this stream exhausted its retries,
    after which `output()` raises instead of returning a stream with a
    silent hole (a lost chunk would otherwise just shorten the output).

    Online-adaptation hooks (the adaptation slice consumes them):

    `tap` — optional callback `(rx_segment, soft_symbols) → None` invoked
    by the micro-batcher's descatter for every emitted chunk, with the REAL
    input samples behind the emitted positions and the symbols they
    produced, both in stream order. This is how the sample collector sees
    served traffic without a second pass over the stream. Must be cheap
    (it runs on the descatter path, under the async runtime's lock) and
    must copy what it keeps (the rx view aliases the launch input buffer).

    `swap_log` — [(weight_epoch, first_position)] history: positions ≥
    first_position were equalized with that epoch's weights. Epoch 0 is the
    weights the stream opened with. `install_spec` appends on every
    successful hot-swap/rollback; `prev_spec` holds the previous spec so a
    bad promotion can be rolled back bit-identically (specs rebuild their
    engines deterministically). The log stays a plain list (callers slice
    it) but is BOUNDED: `swap_log_max` (from `obs.Retention.swap_log`
    when opened through a runtime) trims the oldest entries, so a
    long-running adaptive stream holds steady memory.
    """

    SWAP_LOG_MAX = 256                 # default bound (Retention.swap_log)

    def __init__(self, spec: TenantSpec, pool: EnginePool,
                 tile_tuner: Optional[TileTuner] = None,
                 swap_log_max: Optional[int] = None,
                 device: DeviceLike = "cuda"):
        self._pool = pool
        self.device = resolve_device(device)
        # a NEW stream must never inherit a pool entry built (or tile-
        # mutated) for an earlier session under the same tenant_id — the
        # chunker below must be sized off an engine that this session's
        # spec rebuilds identically after LRU eviction
        pool.drop(spec.tenant_id)
        engine = pool.get(spec.tenant_id,
                          lambda: spec.build_engine(self.device))
        if tile_tuner is not None and spec.tile_m == "auto":
            tuned = tile_tuner(engine)
            if tuned is not None:
                # freeze the serve-aware tile into the session's spec copy:
                # rebuilds after LRU eviction must reproduce it, and the
                # caller's spec object stays untouched
                spec = dataclasses.replace(spec, tile_m=int(tuned))
                engine.tile_m = int(tuned)
        self.spec = spec
        self.chunker = StreamChunker(            # sized off the built engine
            halo=engine.halo_samples,
            total_stride=engine.total_stride,
            tile_m=engine.resolved_tile_m())
        self.v_parallel = engine.cfg.v_parallel
        self._out: List[np.ndarray] = []
        self.syms_emitted = 0
        self.failed: Optional[BaseException] = None
        # requests taken for launch but not yet descattered/failed —
        # maintained (under its lock) by AsyncServeRuntime so close() can
        # wait for a tenant's in-flight work; always 0 on the sync path
        self.inflight = 0
        # fault-tolerance bookkeeping (serve/recovery.py, async runtime):
        # `recoveries` counts failover rounds this stream has consumed
        # (bounded by RecoveryPolicy.max_session_recoveries before the
        # stream is poisoned the old way); `shed` marks the tenant as
        # load-shed by the degradation controller — submits raise
        # TenantShedError until health returns; `rolled_back` latches
        # after a corrupt-output rollback so a session never ping-pongs
        # between spec and prev_spec
        self.recoveries = 0
        self.shed = False
        self.rolled_back = False
        # online-adaptation hooks (see class docstring)
        self.tap: Optional[Callable[[np.ndarray, np.ndarray], None]] = None
        # cross-wire trace context: (trace_id, t_client, t_ingress) tuples
        # pushed by the net ingress when a DATA frame carried the v2 trace
        # extension, drained into the next chunk span at enqueue. Bounded:
        # with tracing off nothing drains, so a rude flood must not grow
        # host memory (oldest context drops — ids are best-effort hints)
        self.trace_ctx: Deque[Tuple[int, float, float]] = deque(maxlen=256)
        self.prev_spec: Optional[TenantSpec] = None
        self.swap_log: List[tuple] = [(spec.weight_epoch, 0)]
        self.swap_log_max = (self.SWAP_LOG_MAX if swap_log_max is None
                             else max(1, int(swap_log_max)))

    @property
    def engine(self) -> EqualizerEngine:
        """Fetch (or rebuild after LRU eviction) this tenant's engine."""
        return self._pool.get(self.spec.tenant_id,
                              lambda: self.spec.build_engine(self.device))

    def rebuild_on(self, pool: EnginePool) -> "Session":
        """Fleet migration primitive: reincarnate this mid-stream session
        against ANOTHER engine pool (the fleet's worker migration).

        The replacement builds a fresh engine from the (frozen) spec —
        deterministic, so it serves bitwise-identically — then reinstalls
        the complete stream state: the chunker carry via
        `snapshot()`/`restore()` (deep copies; the dead session is not
        aliased) plus the output accumulator, recovery/adaptation
        bookkeeping, and in-flight accounting. No `tile_tuner` is passed:
        the spec's tile is already frozen (or "auto" resolves through the
        deterministic autotune cache), and a re-tune mid-stream would
        change the chunker geometry and void the bitwise contract. A
        geometry mismatch between old and new engines means the spec does
        NOT rebuild deterministically — that is corruption, so it raises
        instead of silently emitting misaligned symbols."""
        s = Session(self.spec, pool, swap_log_max=self.swap_log_max,
                    device=self.device)
        old_c, new_c = self.chunker, s.chunker
        if ((new_c.halo, new_c.ts, new_c.tile_m)
                != (old_c.halo, old_c.ts, old_c.tile_m)):
            raise RuntimeError(
                f"tenant {self.spec.tenant_id!r}: rebuilt engine changed "
                f"chunker geometry "
                f"{(old_c.halo, old_c.ts, old_c.tile_m)} -> "
                f"{(new_c.halo, new_c.ts, new_c.tile_m)}; spec is not "
                f"deterministic, refusing to migrate")
        new_c.restore(old_c.snapshot())
        s._out = list(self._out)
        s.syms_emitted = self.syms_emitted
        s.failed = self.failed
        s.inflight = self.inflight
        s.recoveries = self.recoveries
        s.shed = self.shed
        s.rolled_back = self.rolled_back
        s.tap = self.tap
        s.trace_ctx = deque(self.trace_ctx, maxlen=self.trace_ctx.maxlen)
        s.prev_spec = self.prev_spec
        s.swap_log = list(self.swap_log)
        return s

    def add_tap(self, fn: Callable[[np.ndarray, np.ndarray], None]) -> None:
        """Register an additional descatter tap, composing with whatever is
        already installed (the adaptation collector claims the slot first
        when both are wired; taps run in registration order)."""
        if self.tap is None:
            self.tap = fn
        elif isinstance(self.tap, TapChain):
            self.tap.taps.append(fn)
        else:
            self.tap = TapChain([self.tap, fn])

    @property
    def weight_epoch(self) -> int:
        return self.spec.weight_epoch

    def install_spec(self, new_spec: TenantSpec,
                     prebuilt: Optional[EqualizerEngine] = None) -> int:
        """Install a hot-swap spec as the stream's active identity.

        The CALLER must have landed all of this session's planned work
        first (sync: `flush_session`; async: take_session + in-flight
        wait) — the swap boundary is `chunker.emitted_positions` at install
        time, and positions planned-but-not-landed would otherwise execute
        with the wrong epoch's weights.

        The candidate engine (built here, or passed as `prebuilt` when the
        caller already constructed it OUTSIDE its locks — engine builds
        fold BN and quantize weights) must share the active engine's
        `group_key()` — same
        topology, backend, static kernel config (formats), and tile. A
        weight swap that would change any of those is NOT a weight swap
        (it would re-tile the chunker or move the stream between batch
        groups mid-flight) and raises ValueError, leaving the active
        weights untouched. On success the previous spec is kept in
        `prev_spec` for bit-identical rollback, the engine pool entry is
        replaced, and the (epoch, first_position) pair is appended to
        `swap_log`. Returns the new weight epoch.
        """
        candidate = prebuilt if prebuilt is not None \
            else new_spec.build_engine(self.device)
        active_key = self.engine.group_key()
        if candidate.group_key() != active_key:
            raise ValueError(
                f"tenant {new_spec.tenant_id!r}: hot-swap would change the "
                f"serving identity {active_key} -> {candidate.group_key()} "
                f"(backend/formats/tile must stay fixed mid-stream)")
        self.prev_spec = self.spec
        self.spec = new_spec
        self._pool.drop(new_spec.tenant_id)
        self._pool.get(new_spec.tenant_id, lambda: candidate)
        self.swap_log.append((new_spec.weight_epoch,
                              self.chunker.emitted_positions))
        if len(self.swap_log) > self.swap_log_max:   # retention bound —
            del self.swap_log[:len(self.swap_log)    # oldest epochs out,
                              - self.swap_log_max]   # list semantics kept
        return new_spec.weight_epoch

    def append_output(self, syms: np.ndarray) -> None:
        self._out.append(syms)
        self.syms_emitted += int(syms.shape[0])

    def output(self) -> np.ndarray:
        """All symbols emitted so far, in stream order. Raises the stream's
        terminal launch error (if any) rather than returning a stream with
        missing chunks."""
        if self.failed is not None:
            raise RuntimeError(
                f"stream {self.spec.tenant_id!r} lost a chunk to a failed "
                f"launch") from self.failed
        if not self._out:
            return np.zeros((0,), np.float32)
        return np.concatenate(self._out)


class SessionManager:
    """tenant_id → Session registry over a shared LRU engine pool."""

    def __init__(self, pool: Optional[EnginePool] = None,
                 max_engines: int = 32,
                 swap_log_max: Optional[int] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.pool = pool if pool is not None else EnginePool(max_engines)
        self.swap_log_max = swap_log_max
        self._sessions: Dict[str, Session] = {}

    def open(self, spec: TenantSpec,
             tile_tuner: Optional[TileTuner] = None) -> Session:
        if spec.tenant_id in self._sessions:
            raise ValueError(f"tenant {spec.tenant_id!r} already open")
        s = Session(spec, self.pool, tile_tuner=tile_tuner,
                    swap_log_max=self.swap_log_max, device=self.device)
        self._sessions[spec.tenant_id] = s
        return s

    def get(self, tenant_id: str) -> Session:
        return self._sessions[tenant_id]

    def close(self, tenant_id: str) -> Session:
        s = self._sessions.pop(tenant_id)
        self.pool.drop(tenant_id)
        return s

    def __contains__(self, tenant_id: str) -> bool:
        return tenant_id in self._sessions

    def __len__(self) -> int:
        return len(self._sessions)

    @property
    def sessions(self) -> Dict[str, Session]:
        return dict(self._sessions)
