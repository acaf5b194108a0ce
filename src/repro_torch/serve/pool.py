"""Keyed, LRU-bounded engine pool — the session manager's memory bound.

Millions of tenants cannot all keep a live `EqualizerEngine` (folded fp32
weights + backend-specific quantized copies) resident. The pool holds at
most `max_engines` built engines, keyed by tenant identity; a hit refreshes
recency, a miss builds via the caller-supplied factory and evicts the least
recently used entry. Evicting an engine loses NO stream state — chunker
carries live in the `Session`, and the factory rebuilds the engine
deterministically from the tenant's spec (BN folding and weight
quantization are pure functions of the trained params).
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, Optional


class EnginePool:
    """LRU cache of built engines: key → engine.

    max_engines: resident-engine bound (count; default 32; must be ≥ 1 or
                 __init__ raises ValueError). Sizing note: one engine holds
                 folded fp32 weights plus a backend-specific quantized copy
                 (int8/bf16), so the bound is effectively a host-memory
                 knob. A bound smaller than the number of concurrently
                 ACTIVE tenants still works — engines rebuild on demand —
                 but turns steady-state traffic into rebuild churn
                 (`stats()["evictions"]` is the tell).

    Thread-safety: every operation is atomic under an internal lock — the
    async serving threads touch the pool under the runtime lock, but the
    online-adaptation thread (a later slice) reads engines outside it, so
    the pool must not rely on its callers for consistency. `get` builds on
    a miss OUTSIDE the lock (engine construction is pure but slow —
    BN fold, weight quantization, possibly an autotune sweep); two racing
    misses may both build, and the second build wins the slot — benign,
    deterministic engines are interchangeable.
    """

    def __init__(self, max_engines: int = 32):
        if max_engines < 1:
            raise ValueError("max_engines must be ≥ 1")
        self.max_engines = max_engines
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # optional chaos hook (serve/recovery.py FaultPlan): `build_error`
        # faults are scheduled against the miss/build counter, so they hit
        # both session opens AND failover rebuilds deterministically
        self.fault_plan = None
        # optional observability hook (repro_torch.obs): called as
        # build_hook(key, build_seconds) after every successful miss-build,
        # outside the pool lock — runtimes use it to record engine
        # build/compile events as trace instants + a build-time histogram
        self.build_hook: Optional[Callable[[Hashable, float], None]] = None
        self.clock: Callable[[], float] = time.perf_counter

    def get(self, key: Hashable, build: Callable[[], Any]) -> Any:
        """Return the cached engine for `key`, building (and possibly
        evicting the LRU entry) on a miss. An installed `fault_plan` may
        fail the build at its scheduled build index — the exception
        propagates to the caller exactly like a real build failure."""
        with self._lock:
            if key in self._entries:
                self.hits += 1
                self._entries.move_to_end(key)
                return self._entries[key]
            idx = self.misses
            self.misses += 1
        if self.fault_plan is not None:
            self.fault_plan.on_build(idx)
        t0 = self.clock()
        engine = build()                   # slow: outside the lock
        if self.build_hook is not None:
            self.build_hook(key, self.clock() - t0)
        with self._lock:
            self._entries[key] = engine
            if len(self._entries) > self.max_engines:
                self._entries.popitem(last=False)      # evict LRU
                self.evictions += 1
        return engine

    def __contains__(self, key: Hashable) -> bool:     # no recency touch
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def drop(self, key: Hashable) -> None:
        with self._lock:
            self._entries.pop(key, None)

    def clear(self) -> None:
        """Drop every entry (fleet worker death: the dead device's built
        engines are garbage; sessions rebuild on their new worker's pool).
        Hit/miss/eviction counters are preserved — they describe history,
        not contents."""
        with self._lock:
            self._entries.clear()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"size": len(self._entries),
                    "max_engines": self.max_engines,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}
