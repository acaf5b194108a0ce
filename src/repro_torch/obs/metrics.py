"""Metrics registry: Counter/Gauge/Histogram under hierarchical dotted names.

Design constraints (see docs/OBSERVABILITY.md):

  * every instrument carries its own lock — hot paths never contend on a
    registry-wide mutex (the registry lock is taken only at get-or-create
    and snapshot time);
  * histograms keep a *bounded* sliding-window reservoir (a deque of the
    last `window` observations) plus lifetime count/sum/min/max, so memory
    is constant no matter how long a session runs;
  * the clock is injectable for deterministic tests (`snapshot()` stamps
    uptime from it);
  * `callback(name, fn)` registers a lazy provider evaluated only at
    snapshot time — runtimes use this to expose existing state (pool LRU
    counters, placement maps, recovery ledgers) without double-accounting.

Names are dot-separated segments of ``[A-Za-z0-9_-]``; the snapshot is the
nested dict tree obtained by splitting on dots.
"""
from __future__ import annotations

import json
import math
import re
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

_NAME_RE = re.compile(r"^[A-Za-z0-9_\-]+(\.[A-Za-z0-9_\-]+)*$")

DEFAULT_WINDOW = 1024


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"bad metric name {name!r}: want dotted "
                         "[A-Za-z0-9_-] segments")
    return name


def safe_segment(raw: str) -> str:
    """Map an arbitrary string (tenant ids are user-chosen) to one valid
    metric-name segment — the one sanitization every layer that keys
    metrics by tenant must share (`adapt`, `link`, `slo`), or their
    subtrees land under different names for the same tenant."""
    return re.sub(r"[^A-Za-z0-9_\-]", "_", raw) or "_"


class Counter:
    """Monotonic counter. `inc` only; negative increments are rejected."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError("Counter.inc requires n >= 0")
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value; last write wins."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, dv: float) -> None:
        with self._lock:
            self._value += float(dv)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Sliding-window reservoir: the last `window` observations, plus
    lifetime count/sum/min/max.  Quantiles are computed over the window
    (recency-weighted by construction); memory is O(window) forever."""

    __slots__ = ("_lock", "_window", "_count", "_sum", "_min", "_max")

    def __init__(self, window: int = DEFAULT_WINDOW) -> None:
        if window < 1:
            raise ValueError("Histogram window must be >= 1")
        self._lock = threading.Lock()
        self._window: Deque[float] = deque(maxlen=window)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._window.append(v)
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def observe_many(self, vs) -> None:
        """Record a batch of observations under ONE lock acquisition — the
        shape hot callers like the link-quality tap need (one served chunk
        is hundreds of per-symbol confidences)."""
        xs = [float(v) for v in vs]
        if not xs:
            return
        with self._lock:
            self._window.extend(xs)
            self._count += len(xs)
            self._sum += sum(xs)
            mn, mx = min(xs), max(xs)
            if mn < self._min:
                self._min = mn
            if mx > self._max:
                self._max = mx

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def window_mean(self) -> float:
        """Mean over the current window (NaN when empty) — the value SLO
        rules evaluate for histogram-valued metrics (`summary()`'s mean is
        lifetime, which would never recover after a long degradation)."""
        with self._lock:
            if not self._window:
                return math.nan
            return sum(self._window) / len(self._window)

    def quantile(self, q: float) -> float:
        """Linear-interpolated quantile over the current window (NaN when
        empty); q in [0, 1]."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile q must be in [0, 1]")
        with self._lock:
            xs = sorted(self._window)
        if not xs:
            return math.nan
        pos = q * (len(xs) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(xs) - 1)
        frac = pos - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def summary(self) -> Dict[str, float]:
        with self._lock:
            xs = sorted(self._window)
            count, total = self._count, self._sum
            mn, mx = self._min, self._max
        if not xs:
            return {"count": 0, "sum": 0.0}

        def q(p: float) -> float:
            pos = p * (len(xs) - 1)
            lo = int(math.floor(pos))
            hi = min(lo + 1, len(xs) - 1)
            frac = pos - lo
            return xs[lo] * (1.0 - frac) + xs[hi] * frac

        return {
            "count": count,
            "sum": total,
            "min": mn,
            "max": mx,
            "mean": total / count,
            "p50": q(0.50),
            "p90": q(0.90),
            "p99": q(0.99),
            "window": len(xs),
        }


class MetricsRegistry:
    """Get-or-create registry of named instruments + lazy callbacks.

    `snapshot()` returns the nested tree: counters as ints, gauges as
    floats, histograms as summary dicts, callbacks as whatever they
    return (scalars or dict subtrees)."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}
        self._callbacks: Dict[str, Callable[[], Any]] = {}
        self.clock = clock
        self._t0 = clock()

    # -- get-or-create ----------------------------------------------------
    def _get(self, name: str, kind: type, factory: Callable[[], Any]):
        _check_name(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                if name in self._callbacks:
                    raise ValueError(
                        f"metric {name!r} already registered as a callback")
                m = self._metrics[name] = factory()
            elif not isinstance(m, kind):
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{type(m).__name__}, not {kind.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, Gauge)

    def histogram(self, name: str, window: int = DEFAULT_WINDOW) -> Histogram:
        return self._get(name, Histogram, lambda: Histogram(window))

    def callback(self, name: str, fn: Callable[[], Any]) -> None:
        """Register (or replace) a lazy provider evaluated at snapshot
        time; may return a scalar or a dict subtree."""
        _check_name(name)
        with self._lock:
            if name in self._metrics:
                raise ValueError(
                    f"metric {name!r} already registered as an instrument")
            self._callbacks[name] = fn

    def instrument(self, name: str) -> Optional[Any]:
        """The live instrument registered under `name`, or None — the
        read-only lookup SLO rule evaluation uses (callbacks are not
        instruments and resolve to None: a rule cannot breach on a lazy
        provider whose evaluation might itself throw)."""
        with self._lock:
            return self._metrics.get(name)

    def scope(self, prefix: str) -> "Scope":
        return Scope(self, _check_name(prefix))

    def names(self) -> List[str]:
        with self._lock:
            return sorted(set(self._metrics) | set(self._callbacks))

    # -- export -----------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            metrics = dict(self._metrics)
            callbacks = dict(self._callbacks)
            uptime = self.clock() - self._t0
        tree: Dict[str, Any] = {}
        for name, m in metrics.items():
            if isinstance(m, Counter):
                val: Any = m.value
            elif isinstance(m, Gauge):
                val = m.value
            else:
                val = m.summary()
            _insert(tree, name, val)
        for name, fn in callbacks.items():
            try:
                val = fn()
            except Exception as exc:  # snapshots must never throw
                val = {"error": repr(exc)}
            _insert(tree, name, val)
        tree["meta"] = {"uptime_s": uptime, "metric_names": len(metrics),
                        "callback_names": len(callbacks)}
        return tree

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True,
                          default=_json_default)

    def to_prometheus(self) -> str:
        """Prometheus text exposition: flattened names with dots mapped to
        underscores; histograms emit _count/_sum plus quantile gauges."""
        lines: List[str] = []
        for name, value in sorted(_flatten(self.snapshot())):
            flat = re.sub(r"[^A-Za-z0-9_]", "_", name)
            if isinstance(value, bool):
                lines.append(f"{flat} {int(value)}")
            elif isinstance(value, (int, float)):
                if isinstance(value, float) and not math.isfinite(value):
                    continue
                lines.append(f"{flat} {value}")
            elif isinstance(value, str):
                lines.append(f'{flat}{{value="{value}"}} 1')
        return "\n".join(lines) + "\n"


class Scope:
    """A registry view that prefixes every name — layers hold a Scope and
    stay ignorant of where they sit in the hierarchy."""

    __slots__ = ("_registry", "_prefix")

    def __init__(self, registry: MetricsRegistry, prefix: str) -> None:
        self._registry = registry
        self._prefix = prefix

    @property
    def prefix(self) -> str:
        return self._prefix

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry

    def _name(self, name: str) -> str:
        return f"{self._prefix}.{name}"

    def counter(self, name: str) -> Counter:
        return self._registry.counter(self._name(name))

    def gauge(self, name: str) -> Gauge:
        return self._registry.gauge(self._name(name))

    def histogram(self, name: str, window: int = DEFAULT_WINDOW) -> Histogram:
        return self._registry.histogram(self._name(name), window)

    def callback(self, name: str, fn: Callable[[], Any]) -> None:
        self._registry.callback(self._name(name), fn)

    def scope(self, sub: str) -> "Scope":
        return Scope(self._registry, self._name(_check_name(sub)))


# ---------------------------------------------------------------------------
# tree helpers
# ---------------------------------------------------------------------------

def _insert(tree: Dict[str, Any], dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = tree
    for p in parts[:-1]:
        nxt = node.get(p)
        if not isinstance(nxt, dict):
            nxt = node[p] = {}
        node = nxt
    leaf = parts[-1]
    if isinstance(node.get(leaf), dict) and isinstance(value, dict):
        node[leaf].update(value)
    else:
        node[leaf] = value


def _flatten(tree: Dict[str, Any], prefix: str = "") -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.extend(_flatten(v, name))
        elif isinstance(v, (list, tuple)):
            out.append((name, json.dumps(v, default=_json_default)))
        else:
            out.append((name, v))
    return out


def _json_default(o: Any) -> Any:
    try:
        return float(o)
    except Exception:
        return repr(o)
