"""Straggler detection & mitigation.

At 1000+ nodes the slowest worker sets the step time (synchronous SGD), so
the controller needs (a) detection — a robust running estimate of the step
time distribution — and (b) mitigation hooks. This module implements the
detection machinery and three mitigations, exercised in tests with injected
delays:

  * `deadline-skip`: if a step exceeds μ + k·σ (or an absolute deadline),
    flag it; after `patience` consecutive flags, fire the mitigation
    callback (production: preempt + reschedule the slow host; here: the
    callback is pluggable — the fault loop uses a controlled restart);
  * `microbatch rebalance`: shrink the accum factor for flagged workers
    (returned as a recommendation — the data pipeline consumes it);
  * bookkeeping for EXPERIMENTS.md (flag counts, step-time quantiles).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class StragglerConfig:
    ema_alpha: float = 0.1
    sigma_factor: float = 3.0        # flag threshold: μ + k·σ
    abs_deadline_s: Optional[float] = None
    patience: int = 3                # consecutive flags before mitigation
    warmup_steps: int = 5            # ignore compile/first-touch steps


class StragglerMonitor:
    """`degraded` is the mitigation latch: it turns on after `patience`
    CONSECUTIVE flagged steps (when `on_straggler` also fires, and — new —
    `on_recovered` fires on the way back) and decays after `patience`
    consecutive clean steps, so a transient slow phase stops costing
    anything once it has passed. `recommend_accum` keys off the latch,
    not off the cumulative flag count (which could never recover)."""

    def __init__(self, cfg: StragglerConfig = StragglerConfig(),
                 on_straggler: Optional[Callable[[int, float], None]] = None,
                 on_recovered: Optional[Callable[[int], None]] = None):
        self.cfg = cfg
        self.on_straggler = on_straggler
        self.on_recovered = on_recovered
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.consecutive = 0
        self.clean_streak = 0
        self.degraded = False
        self.flags: List[int] = []
        self.times: List[float] = []
        self._t0: Optional[float] = None

    # -- timing interface ---------------------------------------------------

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> bool:
        assert self._t0 is not None, "stop() without start()"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe(step, dt)

    def observe(self, step: int, dt: float) -> bool:
        """Record a step time; returns True if the step is flagged."""
        self.times.append(dt)
        self.n += 1
        if self.n <= self.cfg.warmup_steps:
            # prime the estimate but never flag during warmup
            a = 0.5
            self.mean = (1 - a) * self.mean + a * dt if self.n > 1 else dt
            return False
        flagged = False
        sd = self.var ** 0.5
        thresh = self.mean + self.cfg.sigma_factor * max(sd, 1e-9)
        if self.cfg.abs_deadline_s is not None:
            thresh = min(thresh, self.cfg.abs_deadline_s)
        if dt > thresh:
            flagged = True
            self.flags.append(step)
            self.consecutive += 1
            self.clean_streak = 0
            if self.consecutive >= self.cfg.patience:
                if not self.degraded and self.on_straggler is not None:
                    self.on_straggler(step, dt)
                self.degraded = True
                self.consecutive = 0
        else:
            self.consecutive = 0
            self.clean_streak += 1
            if self.degraded and self.clean_streak >= self.cfg.patience:
                # transient slow phase has passed: lift the mitigation
                self.degraded = False
                if self.on_recovered is not None:
                    self.on_recovered(step)
            # update stats from non-straggler steps only (robustness)
            a = self.cfg.ema_alpha
            delta = dt - self.mean
            self.mean += a * delta
            self.var = (1 - a) * (self.var + a * delta * delta)
        return flagged

    # -- mitigation recommendations ------------------------------------------

    def recommend_accum(self, base_accum: int) -> int:
        """Shrink per-worker accumulation while persistently slow (the
        microbatch-rebalance mitigation): slow worker does less local work,
        the optimizer sees the same global batch via gradient reweighting.
        Keys off the `degraded` latch — NOT the cumulative flag count — so
        the recommendation returns to `base_accum` after `patience`
        consecutive clean steps."""
        if self.degraded:
            return max(1, base_accum // 2)
        return base_accum

    def summary(self) -> dict:
        # warmup steps carry compile/first-touch time, not steady-state
        # step time — including them would skew every quantile of a short
        # run, so they are excluded (flag bookkeeping never saw them either)
        ts = sorted(self.times[self.cfg.warmup_steps:])
        q = lambda f: ts[int(f * (len(ts) - 1))] if ts else 0.0
        return {"steps": self.n, "flagged": len(self.flags),
                "degraded": self.degraded,
                "p50_s": q(0.5), "p95_s": q(0.95), "p99_s": q(0.99),
                "mean_s": self.mean}
