"""repro_torch.obs — the observability core of the serving stack.

Port of `repro.obs` (these modules are host-side and framework-free):

  * `metrics`  — Counter/Gauge/Histogram with bounded reservoirs behind a
    `MetricsRegistry` of dotted names, exported as one nested
    `snapshot()` tree, JSON, or Prometheus text;
  * `trace`    — per-chunk lifecycle spans (submit -> assemble -> launch ->
    execute -> descatter -> emit) in a bounded ring, exportable as Chrome
    `trace_event` JSON;
  * `hub`      — the `Observability` facade (registry + tracer +
    `Retention`) that runtimes accept via their `obs=` parameter.

The link-quality estimators, the SLO engine and the console report come
with a later slice.
"""
from .hub import Observability, Retention
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, Scope,
                      safe_segment)
from .trace import PHASES, ChunkSpan, Tracer

__all__ = ["ChunkSpan", "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "Observability", "PHASES", "Retention", "Scope", "Tracer",
           "safe_segment"]
