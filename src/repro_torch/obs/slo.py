"""Declarative per-tenant SLOs over the metrics registry, with hysteresis.

Port of `repro.obs.slo` (host-side numpy and the standard library only).

A deployment states its service-level objectives as `SloRule`s — "tenant
snr_db must stay above 14 dB", "p99 launch latency must stay under 5 ms" —
and the `SloEngine` evaluates them against live `MetricsRegistry`
instruments, latching breach/clear EDGES with the same patience discipline
as `repro_torch.runtime.straggler.StragglerMonitor`: a rule must breach (or
recover) for `patience` CONSECUTIVE evaluations before its state flips, so
an oscillating metric near the threshold never thrashes alerts.

Rules are declarative and tenant-generic: a metric path may contain the
literal placeholder ``{tenant}``, which is substituted (metric-name
sanitized) for every tenant registered via `watch()` — one rule covers the
whole fleet of streams. Paths without the placeholder evaluate once,
globally.

Edges are loud in three places, and bounded in all of them:

  * a tracer instant (``slo_breach`` / ``slo_clear`` / ``slo_resolved``)
    when tracing is on — breaches land in the same Chrome export as the
    chunk spans they explain;
  * the ALERT LEDGER — a bounded deque of edge records surfaced in
    ``snapshot()`` under ``slo.alerts`` (plus latch states under
    ``slo.state``), so an exported snapshot carries the alert history;
  * the `on_breach` / `on_clear` callbacks — the closed-loop seam, plain
    callables: an online adapter can hang off `on_breach` to fine-tune ON
    DEMAND instead of on a fixed cadence, and call `resolve()` when its
    promotion retires the alert (the port's adaptation package comes
    later).

Evaluation (`step()`) is read-only over the registry and runs wherever the
caller wants — typically from `LinkMonitor` after each served segment, or
from a test/bench loop. It never throws on missing metrics (a rule over a
tenant that has not emitted yet simply waits) and honours each rule's
`min_samples` guard so cold streams are not judged on noise.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from .hub import Observability
from .metrics import (DEFAULT_WINDOW, Counter, Gauge, Histogram,
                      safe_segment)

# edge callback signature: (tenant or None, rule, observed value)
EdgeHook = Callable[[Optional[str], "SloRule", float], None]


@dataclasses.dataclass(frozen=True)
class SloRule:
    """One service-level objective.

    name:        rule identifier (metric-name-safe; keys alerts and state).
    metric:      dotted registry path to evaluate; may contain ``{tenant}``
                 (substituted, sanitized, for every watched tenant).
    threshold:   the objective boundary.
    direction:   "below" (default) breaches when value < threshold — the
                 shape for quality floors like SNR; "above" breaches when
                 value > threshold — for ceilings like EVM or latency.
    window:      the observation window (samples) the metric is expected
                 to be computed over; purely declarative for gauges (the
                 estimator owns its window) but histogram-valued metrics
                 are evaluated over their windowed mean, and the rule
                 documents that width.
    min_samples: evaluation guard — the rule is SKIPPED (streaks frozen)
                 until this many samples back the metric. Samples come
                 from the `samples` path when given, else from a
                 histogram metric's lifetime count; a gauge metric with
                 no `samples` path is assumed always warm.
    samples:     optional dotted path (``{tenant}`` allowed) of a Counter/
                 Gauge holding the metric's sample count.
    patience:    consecutive breaching (resp. clean) evaluations required
                 to latch (resp. clear) — the hysteresis width.
    """
    name: str
    metric: str
    threshold: float
    direction: str = "below"
    window: int = DEFAULT_WINDOW
    min_samples: int = 1
    samples: Optional[str] = None
    patience: int = 3

    def __post_init__(self) -> None:
        if self.direction not in ("below", "above"):
            raise ValueError(f"SloRule.direction must be 'below' or "
                             f"'above', got {self.direction!r}")
        if self.patience < 1:
            raise ValueError("SloRule.patience must be >= 1")
        if self.min_samples < 0:
            raise ValueError("SloRule.min_samples must be >= 0")
        if self.window < 1:
            raise ValueError("SloRule.window must be >= 1")

    def breaches(self, value: float) -> bool:
        return (value < self.threshold if self.direction == "below"
                else value > self.threshold)


@dataclasses.dataclass
class _Latch:
    """Per-(rule, tenant) hysteresis state — the StragglerMonitor latch."""
    breached: bool = False
    breach_streak: int = 0
    clear_streak: int = 0
    value: float = float("nan")
    evaluations: int = 0


class SloEngine:
    """Evaluates `SloRule`s against an `Observability` hub's registry.

    Construction wires the ``slo.*`` snapshot surface (breached/watched
    gauges, the alert ledger and latch states as callbacks); `watch()`
    registers tenants; `step()` evaluates. `on_breach`/`on_clear` are
    plain mutable attributes so closed loops with construction cycles
    (engine ↔ adapter) can late-bind them.
    """

    def __init__(self, obs: Observability,
                 rules: Tuple[SloRule, ...] = (),
                 on_breach: Optional[EdgeHook] = None,
                 on_clear: Optional[EdgeHook] = None,
                 ledger_max: Optional[int] = None) -> None:
        self.obs = obs
        self.rules: List[SloRule] = []
        self.on_breach = on_breach
        self.on_clear = on_clear
        self._lock = threading.Lock()
        self._tenants: List[str] = []
        self._latches: Dict[Tuple[str, Optional[str]], _Latch] = {}
        self.alerts: Deque[Dict[str, Any]] = deque(
            maxlen=ledger_max if ledger_max is not None
            else obs.retention.errors)
        self.alerts_total = 0
        scope = obs.scope("slo")
        self._g_rules = scope.gauge("rules")
        self._g_watched = scope.gauge("watched")
        self._g_breached = scope.gauge("breached")
        scope.callback("alerts", self._alerts_view)
        scope.callback("state", self._state_view)
        for r in rules:
            self.add_rule(r)

    # -- configuration -------------------------------------------------------

    def add_rule(self, rule: SloRule) -> SloRule:
        with self._lock:
            if any(r.name == rule.name for r in self.rules):
                raise ValueError(f"SLO rule {rule.name!r} already added")
            self.rules.append(rule)
            self._g_rules.set(len(self.rules))
        return rule

    def watch(self, tenant_id: str) -> None:
        """Register a tenant for ``{tenant}`` rule substitution (idempotent)."""
        with self._lock:
            if tenant_id not in self._tenants:
                self._tenants.append(tenant_id)
                self._g_watched.set(len(self._tenants))

    # -- evaluation ----------------------------------------------------------

    def step(self, tenant_id: Optional[str] = None) -> List[Dict[str, Any]]:
        """Evaluate every rule (for one tenant, or all watched tenants plus
        the global rules). Returns the edge records produced by THIS call.
        Read-only over the registry; never raises on missing metrics."""
        edges: List[Dict[str, Any]] = []
        with self._lock:
            rules = list(self.rules)
            tenants = list(self._tenants)
        for rule in rules:
            if "{tenant}" in rule.metric:
                targets = ([tenant_id] if tenant_id is not None
                           else tenants)
                targets = [t for t in targets if t in tenants]
            else:
                targets = [None] if tenant_id is None else []
            for t in targets:
                edge = self._evaluate(rule, t)
                if edge is not None:
                    edges.append(edge)
        for edge in edges:          # callbacks OUTSIDE the latch lock
            hook = (self.on_breach if edge["state"] == "breach"
                    else self.on_clear)
            if hook is not None:
                hook(edge["tenant"], edge["rule_obj"], edge["value"])
        return [
            {k: v for k, v in e.items() if k != "rule_obj"} for e in edges]

    def _paths(self, rule: SloRule, tenant: Optional[str]):
        seg = safe_segment(tenant) if tenant is not None else ""
        metric = rule.metric.replace("{tenant}", seg)
        samples = (rule.samples.replace("{tenant}", seg)
                   if rule.samples else None)
        return metric, samples

    def _read(self, path: str):
        inst = self.obs.registry.instrument(path)
        if isinstance(inst, (Counter, Gauge)):
            return float(inst.value), None
        if isinstance(inst, Histogram):
            return inst.window_mean(), inst.count
        return None, None

    def _evaluate(self, rule: SloRule,
                  tenant: Optional[str]) -> Optional[Dict[str, Any]]:
        metric, samples_path = self._paths(rule, tenant)
        value, hist_count = self._read(metric)
        if value is None or value != value:            # missing or NaN
            return None
        n = hist_count
        if samples_path is not None:
            sv, _ = self._read(samples_path)
            n = None if sv is None else int(sv)
            if n is None:                              # guard path missing:
                return None                           # not warm yet
        if n is not None and n < rule.min_samples:
            return None                               # min-samples guard
        breach_now = rule.breaches(value)
        with self._lock:
            st = self._latches.setdefault((rule.name, tenant), _Latch())
            st.value = value
            st.evaluations += 1
            edge: Optional[str] = None
            if breach_now:
                st.clear_streak = 0
                st.breach_streak += 1
                if not st.breached and st.breach_streak >= rule.patience:
                    st.breached = True
                    st.breach_streak = 0
                    edge = "breach"
            else:
                st.breach_streak = 0
                st.clear_streak += 1
                if st.breached and st.clear_streak >= rule.patience:
                    st.breached = False
                    st.clear_streak = 0
                    edge = "clear"
            if edge is None:
                return None
            record = self._record_edge_locked(rule, tenant, metric, value,
                                              edge)
        self.obs.tracer.instant(f"slo_{edge}", rule=rule.name,
                                tenant=tenant or "", metric=metric,
                                value=value, threshold=rule.threshold)
        record = dict(record)
        record["rule_obj"] = rule
        return record

    def _record_edge_locked(self, rule: SloRule, tenant: Optional[str],
                            metric: str, value: float,
                            state: str) -> Dict[str, Any]:
        record = {"rule": rule.name, "tenant": tenant, "metric": metric,
                  "value": float(value), "threshold": rule.threshold,
                  "state": state, "t": self.obs.clock()}
        self.alerts.append(record)
        self.alerts_total += 1
        self._g_breached.set(sum(1 for s in self._latches.values()
                                 if s.breached))
        return record

    # -- closed-loop resolution ----------------------------------------------

    def resolve(self, tenant_id: str, reason: str = "promoted") -> int:
        """Clear every latched breach for `tenant_id` NOW — the promotion
        path: a successful adaptation retires the alert without waiting
        for `patience` clean evaluations. Returns the number of latches
        cleared; ledger records carry state "resolved" and the reason."""
        cleared: List[Tuple[SloRule, str, float]] = []
        with self._lock:
            rules = {r.name: r for r in self.rules}
            for (rname, tenant), st in self._latches.items():
                if tenant == tenant_id and st.breached:
                    st.breached = False
                    st.breach_streak = 0
                    st.clear_streak = 0
                    rule = rules.get(rname)
                    if rule is None:
                        continue
                    metric, _ = self._paths(rule, tenant)
                    rec = self._record_edge_locked(rule, tenant, metric,
                                                   st.value, "resolved")
                    rec["reason"] = reason
                    cleared.append((rule, metric, st.value))
        for rule, metric, value in cleared:
            self.obs.tracer.instant("slo_resolved", rule=rule.name,
                                    tenant=tenant_id, metric=metric,
                                    reason=reason)
            if self.on_clear is not None:
                self.on_clear(tenant_id, rule, value)
        return len(cleared)

    # -- introspection ---------------------------------------------------------

    def breached(self, tenant_id: Optional[str] = None) -> List[str]:
        """Names of currently latched rules (optionally for one tenant)."""
        with self._lock:
            return sorted(rname for (rname, t), st in self._latches.items()
                          if st.breached
                          and (tenant_id is None or t == tenant_id))

    def breached_tenants(self) -> List[str]:
        """Tenants with at least one latched breach (fleet health input)."""
        with self._lock:
            return sorted({t for (_, t), st in self._latches.items()
                           if st.breached and t is not None})

    def _alerts_view(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(a) for a in self.alerts]

    def _state_view(self) -> Dict[str, Any]:
        with self._lock:
            states = {}
            for (rname, tenant), st in self._latches.items():
                key = f"{rname}[{tenant}]" if tenant is not None else rname
                states[key] = {"breached": st.breached,
                               "value": st.value,
                               "evaluations": st.evaluations}
            return {"alerts_total": self.alerts_total,
                    "alerts_dropped": self.alerts_total - len(self.alerts),
                    "latches": states}
